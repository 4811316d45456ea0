#!/usr/bin/env python3
"""The MLA decode layer's kernels on one card: correctness and timings.

    python3 scripts/torch_mla_hopper_timing.py [check] [sweep] [l2] [ab]

``check`` runs ``chip_smoke.py``'s ``phase_mla_write_kernels`` (the one
write-and-attend launch, Hopper and mma.sync kernels, against the plain
version, timed at DeepSeek-V3 decode and the served shape) and
``drive_mla_standalone``. ``sweep`` times the Hopper kernel's own choices at
both V3 shapes by device time (CUDA events over 200 calls): every run count
the plan could pick, beside the plan's own.
``l2`` times 64 heads against 128 at V3 decode (the second head group's read
of each tile from L2). ``ab`` times, at the same shapes and in turns (A, B,
B, A), the decode layer's former two launches (``paged_pool_write`` then
the standalone ``paged_mla_attention``) against the one write-and-attend
launch. No argument runs all four. Prints the card's name and power limit first and
the ptxas report of the MLA sources.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _events_ms(fn, iters: int = 200) -> float:
    import torch

    for _ in range(5):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


SHAPES = [("V3 decode, 2047 cached keys", [2047] * 8, None),
          ("served shape, ~520 ragged keys", [519 + 3 * i for i in range(8)], 10)]


def sweep(cs, device) -> None:
    import torch

    from ssp_x_vit_tpu_torch.ops.kernels import build
    from ssp_x_vit_tpu_torch.ops.kernels import paged_mla as tpm

    gen = torch.Generator(device=device)
    gen.manual_seed(5)
    for label, positions, mp in SHAPES:
        for kind in ("bfloat16", "int8"):
            q, new, pool, table, pos = cs._mla_write_setup(gen, device, kind, 8, 128, 576, 64,
                                                           positions, mp)
            codes = pool["q"] if kind == "int8" else pool
            scales = pool["s"] if kind == "int8" else None
            mpt = table.shape[1]
            clusters = tpm.cluster_capacity(device, codes.dtype)
            plan = tpm.mla_hopper_plan(8, 128, 64, mpt, codes.dtype, clusters)
            ref = tpm.paged_mla_attention_write_plain(q, new, cs._clone_pool(pool), table, pos,
                                                      layer_idx=1, v_cols=512)
            out = torch.empty((8, 128, 512), dtype=torch.bfloat16, device=device)
            line = []
            for pps in sorted({-(-mpt // s) for s in range(1, tpm.HOPPER_MAX_SPLITS + 1)},
                              reverse=True):
                splits = -(-mpt // pps)

                def call():
                    build.paged_mla_hopper_write(
                        q, new, codes, scales, table, pos, out, layer=1, scale=1 / 24.0,
                        pages_per_split=pps, splits=splits,
                        stream=torch.cuda.current_stream().cuda_stream)

                call()
                err = cs.scaled_err(out, ref)[1]
                if err > 3e-2:
                    raise AssertionError(f"{label} {kind} splits {splits}: scaled err {err}")
                ms = _events_ms(call)
                mark = " (plan)" if splits == plan.splits else ""
                line.append(f"runs {splits}: {ms * 1e3:.1f} us{mark}")
            cs.log(f"[SWEEP] {label}, {kind} pool, b=8 nq=128 ps=64 mp={mpt} (clusters of 1-8 "
                   f"CTAs the card holds: {clusters}): " + "; ".join(line))


def l2_reread(cs, device) -> None:
    """What the second head group's read of each tile costs: 64 heads (one
    CTA per run) against 128 (two CTAs per run reading the same pages, the
    second mostly from L2), at the V3 decode shape with the plan's runs, in
    turns (64, 128, 128, 64). Equal times: the re-read is free, and a cluster
    multicast of the tile to both groups would save nothing."""
    import torch

    from ssp_x_vit_tpu_torch.ops.kernels import build
    from ssp_x_vit_tpu_torch.ops.kernels import paged_mla as tpm

    gen = torch.Generator(device=device)
    gen.manual_seed(7)
    for kind in ("bfloat16", "int8"):
        q, new, pool, table, pos = cs._mla_write_setup(gen, device, kind, 8, 128, 576, 64, [2047] * 8)
        codes = pool["q"] if kind == "int8" else pool
        scales = pool["s"] if kind == "int8" else None
        mpt = table.shape[1]
        plan = tpm.mla_hopper_plan(8, 128, 64, mpt, codes.dtype, tpm.cluster_capacity(device, codes.dtype))
        times = {64: [], 128: []}
        for nq in (64, 128, 128, 64):
            qn = q[:, :nq].contiguous()
            out = torch.empty((8, nq, 512), dtype=torch.bfloat16, device=device)
            times[nq].append(_events_ms(lambda: build.paged_mla_hopper_write(
                qn, new, codes, scales, table, pos, out, layer=1, scale=1 / 24.0,
                pages_per_split=plan.pages_per_split, splits=plan.splits,
                stream=torch.cuda.current_stream().cuda_stream)))
        cs.log(f"[L2] V3 decode, {kind} pool, {plan.splits} runs: 64 heads (one CTA a run) "
               f"{', '.join(f'{x * 1e3:.1f}' for x in times[64])} us; 128 heads (two CTAs a run, "
               f"the same pages) {', '.join(f'{x * 1e3:.1f}' for x in times[128])} us")


def ab(cs, device) -> None:
    """The former two launches (standalone write, standalone attention) against
    the one write-and-attend launch, in turns, by device time."""
    import torch

    from ssp_x_vit_tpu_torch.ops.kernels import paged_attention as tpa
    from ssp_x_vit_tpu_torch.ops.kernels import paged_mla as tpm

    gen = torch.Generator(device=device)
    gen.manual_seed(6)
    for label, positions, mp in SHAPES:
        for kind in ("bfloat16", "int8"):
            q, new, pool, table, pos = cs._mla_write_setup(gen, device, kind, 8, 128, 576, 64,
                                                           positions, mp)
            lens1 = pos + 1

            def two():
                tpa.paged_pool_write(pool, new, table, pos, layer_idx=1)
                return tpm.paged_mla_attention(q, pool, table, lens1, layer_idx=1)

            def one():
                return tpm.paged_mla_attention_write(q, new, pool, table, pos, layer_idx=1,
                                                     v_cols=512)

            times = {"two launches": [], "one launch": []}
            for name, fn in (("two launches", two), ("one launch", one),
                             ("one launch", one), ("two launches", two)):
                times[name].append(_events_ms(fn))
            cs.log(f"[AB] {label}, {kind} pool: " + "; ".join(
                f"{k} {', '.join(f'{x * 1e3:.1f}' for x in v)} us" for k, v in times.items()))


def main() -> int:
    ap = argparse.ArgumentParser()
    parts = ("check", "sweep", "l2", "ab")
    ap.add_argument("what", nargs="*", help=f"{', '.join(parts)} (default: all)")
    args = ap.parse_args()
    args.what = args.what or list(parts)
    if set(args.what) - set(parts):
        ap.error(f"unknown parts {sorted(set(args.what) - set(parts))}")
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from ssp_x_vit_tpu_torch.ops.kernels import build

    if not torch.cuda.is_available():
        print("torch_mla_hopper_timing: no CUDA device is available", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    cs.log(f"[DEVICE] {cs.nvidia_smi_line()}")
    t0 = time.perf_counter()
    build.build_all()
    cs.log(f"[BUILD] {time.perf_counter() - t0:.1f} s")
    for name in ("paged_mla", "paged_mla_hopper"):
        for line in build.build_log.get(name, "").splitlines():
            if any(w in line for w in ("registers", "spill", "error", "warning", "wgmma",
                                       "Compiling entry")):
                cs.log(f"[BUILD] {name}: {line.strip()}")
    if "check" in args.what:
        t0 = time.perf_counter()
        cs.phase_mla_write_kernels(device)
        cs.drive_mla_standalone(device)
        cs.log(f"[PHASE] check: {time.perf_counter() - t0:.1f} s")
    if "sweep" in args.what:
        sweep(cs, device)
    if "l2" in args.what:
        l2_reread(cs, device)
    if "ab" in args.what:
        ab(cs, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
