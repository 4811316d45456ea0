#!/usr/bin/env python3
"""Does ``utils.profiling.trace`` keep every kernel of the block it wraps?

    python3 scripts/torch_trace_check.py [--seconds 240] [--settle-ms MS] [--ways W]
                                         [--gap-s G] [--out FILE]

On one card: builds the kernels, then traces one ViT-B/16 evaluation batch
(b=64, 37 classes, random weights) again and again for ``--seconds``, in
turn with these ways of opening and closing the profiler:

- ``bare``: ``start``, the block, ``torch.cuda.synchronize``, ``stop``;
- ``sync``: ``trace`` idling 0 s (a synchronize after ``start`` as well);
- ``settle``: ``trace`` idling ``--settle-ms`` inside each edge (by default
  ``SETTLE_S``);
- ``long``: ten times as long;
- ``warm``: as ``settle``, with 64 tiny kernels and a synchronize at the
  start of the block;
- ``shipped``: ``trace`` as it ships (``WARM_KERNELS`` tiny kernels, then
  ``SETTLE_S``); the other ``trace`` ways launch no kernel of its own.

``--ways`` picks which (``bare,sync,settle`` by default); ``--gap-s G``
runs 5 untraced batches and idles G seconds before each trace.

For each trace it matches every kernel launch (a runtime or driver
``*LaunchKernel*`` event) to its kernel event by correlation id, and
records the launches without a kernel, where they stand in launch order and
how long after the window's start the last of them was launched,
the rows' kernel events (LayerNorm / GEMM / attention core), the least and
median of kernel start minus its launch, and the room between the capture
window's edges and the first kernel's start and the last kernel's end, and
whether ``trace`` warned.
Writes one JSON line per trace to ``--out`` (``trace_check.jsonl`` by
default) and prints a ``[TRACE-CHECK]`` summary per way.
"""

import argparse
import contextlib
import io
import json
import os
import statistics
import sys
import tempfile
import time
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

KINDS = ("layer_norm_kernel", "gemm_kernel", "core_kernel")


def read_trace(path: str) -> dict:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    launches, kernels, window = {}, {}, None
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and "LaunchKernel" in e.get("name", ""):
            launches[corr] = e
        elif e.get("cat") == "kernel":
            kernels[corr] = e
        elif e.get("cat") == "Trace" and e.get("name", "").startswith("PyTorch Profiler"):
            window = (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
    order = sorted(launches, key=lambda c: float(launches[c]["ts"]))
    missing = [i for i, c in enumerate(order) if c not in kernels]
    skew = [float(kernels[c]["ts"]) - float(launches[c]["ts"]) for c in order if c in kernels]
    row = {"launches": len(order), "kernel_events": len(kernels), "missing": len(missing),
           "missing_positions": missing,
           "rows": {k: sum(1 for e in kernels.values() if "ssp::" in e["name"] and k in e["name"])
                    for k in KINDS},
           "skew_min_us": min(skew) if skew else None,
           "skew_median_us": statistics.median(skew) if skew else None}
    if window and missing:
        row["lost_launches_until_us"] = float(launches[order[missing[-1]]]["ts"]) - window[0]
    if window and kernels:
        row["room_start_us"] = min(float(e["ts"]) for e in kernels.values()) - window[0]
        row["room_end_us"] = window[1] - max(float(e["ts"]) + float(e.get("dur", 0.0))
                                             for e in kernels.values())
    return row


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=240.0)
    ap.add_argument("--settle-ms", type=float, default=None)
    ap.add_argument("--ways", default="bare,sync,settle",
                    help="comma-separated, of bare, sync, settle, long, warm, shipped")
    ap.add_argument("--out", default="trace_check.jsonl", help="one JSON line per trace")
    ap.add_argument("--gap-s", type=float, default=0.0,
                    help="before each trace: 5 untraced batches, then this many idle seconds")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from ssp_x_vit_tpu_torch.evaluation.classify import evaluate_top1
    from ssp_x_vit_tpu_torch.models.vit import ViTConfig, init_vit_params
    from ssp_x_vit_tpu_torch.ops.kernels import build
    from ssp_x_vit_tpu_torch.utils import profiling

    smi = cs.nvidia_smi_line()
    cs.log(f"[DEVICE] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    device = torch.device("cuda", 0)
    cfg = ViTConfig(image_size=224, patch_size=16, hidden_size=768, num_layers=12, num_heads=12,
                    intermediate_size=3072, num_classes=37)
    params = init_vit_params(cfg, seed=0, device=device)
    gen = torch.Generator().manual_seed(1)
    batch = {"pixel_values": torch.randn(64, 224, 224, 3, generator=gen).to(device),
             "labels": torch.randint(0, 37, (64,), generator=gen).to(device)}

    def block():
        with torch.inference_mode():
            evaluate_top1(params, cfg, [batch])

    block()
    torch.cuda.synchronize()

    def bare(log_dir):
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                  torch.profiler.ProfilerActivity.CUDA])
        prof.start()
        block()
        torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "bare.json"))

    warm_x = torch.zeros(16, device=device)

    def warm_block():
        for _ in range(64):
            warm_x.add_(1)
        torch.cuda.synchronize()
        block()

    def tool(settle_s, body=block, warm_kernels=0):
        def run(log_dir):
            profiling.SETTLE_S, profiling.WARM_KERNELS = settle_s, warm_kernels
            try:
                with warnings.catch_warnings(record=True) as caught, \
                        contextlib.redirect_stdout(io.StringIO()):
                    warnings.simplefilter("always")
                    with profiling.trace(log_dir):
                        body()
            finally:
                profiling.SETTLE_S, profiling.WARM_KERNELS = shipped, shipped_warm
            return sum("have no kernel event" in str(w.message) for w in caught)
        return run

    shipped, shipped_warm = profiling.SETTLE_S, profiling.WARM_KERNELS
    settle_s = shipped if args.settle_ms is None else args.settle_ms / 1e3
    cs.log(f"[TRACE-CHECK] settle way: SETTLE_S = {settle_s * 1e3:g} ms")
    every = {"bare": bare, "sync": tool(0.0), "settle": tool(settle_s),
             "long": tool(10 * settle_s), "warm": tool(settle_s, warm_block),
             "shipped": tool(shipped, warm_kernels=shipped_warm)}
    ways = {name: every[name] for name in args.ways.split(",")}
    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    rows = []
    t_start = time.perf_counter()
    with open(args.out, "w") as out:
        i = 0
        while time.perf_counter() - t_start < args.seconds:
            name = list(ways)[i % len(ways)]
            if args.gap_s:
                for _ in range(5):
                    block()
                torch.cuda.synchronize()
                time.sleep(args.gap_s)
            with tempfile.TemporaryDirectory() as d:
                warned = ways[name](d)
                (path,) = [os.path.join(d, f) for f in os.listdir(d)]
                row = read_trace(path)
            row.update(way=name, session=i, t_s=round(time.perf_counter() - t_start, 3),
                       warned=warned)
            rows.append(row)
            out.write(json.dumps(row) + "\n")
            i += 1
    for name in ways:
        mine = [r for r in rows if r["way"] == name]
        short = [r for r in mine if r["missing"]]
        first = [p for r in short for p in r["missing_positions"]]
        summary = {
            "traces": len(mine), "traces_missing_kernels": len(short),
            "traces_warned": sum(1 for r in mine if r["warned"]),
            "kernels_missing": sum(r["missing"] for r in mine),
            "missing_positions_seen": sorted(set(first))[:40],
            "launches_per_trace": sorted({r["launches"] for r in mine}),
            "rows_per_trace": sorted({json.dumps(r["rows"]) for r in mine}),
            "skew_min_us": min((r["skew_min_us"] for r in mine if r["skew_min_us"] is not None),
                               default=None),
            "room_start_us_min": min((r["room_start_us"] for r in mine if "room_start_us" in r),
                                     default=None),
            "room_end_us_min": min((r["room_end_us"] for r in mine if "room_end_us" in r),
                                   default=None),
            "lost_launches_until_us": [round(r["lost_launches_until_us"]) for r in short
                                       if "lost_launches_until_us" in r][:20]}
        cs.log(f"[TRACE-CHECK] {name}: {json.dumps(summary)}; {smi}")
    for r in rows[:3]:
        cs.log(f"[TRACE-CHECK] first traces of the process: {json.dumps(r)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
