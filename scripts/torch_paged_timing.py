#!/usr/bin/env python3
"""Time the PyTorch port's paged decode attention on one card, bf16 queries,
beside its bound, the plain version and PyTorch's page gather + SDPA:

- ``paged_attention`` (row 7, bf16 pools) and ``paged_attention_q8`` (row 8,
  int8 pools with fp32 scales) at the served Llama-2-7B decode shape: b=8
  sequences, 32 query and 32 KV heads, head_dim 128, pages of 64, 2048 keys
  each (a 32-page table);
- the same kernels at the decode step of the served measurement: 8 live
  slots of ~520 keys in a 32-page table.

    python3 scripts/torch_paged_timing.py [--root CHECKOUT] [--reps 3]

Imports ``ssp_x_vit_tpu_torch`` from ``--root`` (default: this checkout) and
builds only the sources it times, so two checkouts can be timed in turns
within one machine (A, B, B, A). Prints one JSON line: the card's name and
power limit, the shapes with their bounds (the K and V rows, scales, queries
and outputs each moved once at 3.35 TB/s), the plain and library times, and
per repetition the ms of each kernel (CUDA events over 50 launches after 10
warm-up launches), the host's microseconds per call to enqueue 50 calls, and
the device milliseconds per call from a profiler trace of 20 calls (where the
host takes longer to issue a call than the card to run it, the events time
the host; the trace does not).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

PEAK_BYTES = 3.35e12
B, NQ, NKV, HD, PS, MP = 8, 32, 32, 128, 64, 32


def _host_us(fn, iters: int = 50) -> float:
    """Microseconds of the host's clock per call to enqueue ``iters`` calls
    (the card finishes them afterwards): what a host-bound loop pays."""
    import time

    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds * 1e6 / iters


def _device_ms(fn, iters: int = 20) -> float:
    """Device milliseconds per call from a ``torch.profiler`` trace of ``iters``
    calls: the kernels' own time, which a host-bound timing loop cannot show."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            total_us += getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
    return total_us / iters / 1e3


def _ms(fn, iters: int = 50, warmup: int = 10) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--reps", type=int, default=3)
    args = parser.parse_args()

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("torch_paged_timing: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from ssp_x_vit_tpu_torch.ops.kernels import build
    from ssp_x_vit_tpu_torch.ops.kernels import paged_attention as tpa

    build.SOURCES = ("gemm", "paged_attention")
    build.build_all()
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)

    def operands(kind, keys):
        """Pools of a shuffled page table with ``keys[i]`` live keys per sequence."""
        need = [-(-n // PS) for n in keys]
        pages = 1 + sum(need)
        order = (1 + torch.randperm(pages - 1, generator=gen, device=device)).to(torch.int32)
        table = torch.zeros(B, MP, dtype=torch.int32, device=device)
        at = 0
        for i, n in enumerate(need):
            table[i, :n] = order[at:at + n]
            at += n

        def pool():
            rows = torch.randn(NKV, pages, PS, HD, generator=gen, device=device)
            if kind == "int8":
                codes, scales = tpa.quantize_token_kv(rows)
                return {"q": codes, "s": scales}
            return rows.bfloat16()

        lens = torch.tensor(keys, dtype=torch.int32, device=device)
        q = torch.randn(B, NQ, HD, generator=gen, device=device).bfloat16()
        return pool(), pool(), table, lens, q

    def gathered(pool, table, q8):
        t = table.long()
        if q8:
            out = pool["q"][:, t].bfloat16() * pool["s"][:, t][..., None].bfloat16()
        else:
            out = pool[:, t]
        return out.movedim(0, 1).reshape(B, NKV, MP * PS, HD)

    cases, shapes = {}, {}
    for label, keys in (("2048 keys each", [2048] * B),
                        ("8 live slots, ~520 keys each", [520 + 3 * i for i in range(B)])):
        for kind, name in (("bf16", "paged_attention"), ("int8", "paged_attention_q8")):
            k, v, table, lens, q = operands(kind, keys)
            key = f"{name} b={B} nq={NQ} nkv={NKV} hd={HD} ps={PS}, {label}"
            row_bytes = HD + 4 if kind == "int8" else 2 * HD
            nbytes = 2 * NKV * row_bytes * sum(keys) + 2 * B * NQ * HD * 2 + table.numel() * 4 + 4 * B
            mask = (torch.arange(MP * PS, device=device)[None] < lens[:, None])[:, None, None]

            def library():
                return F.scaled_dot_product_attention(q[:, :, None], gathered(k, table, kind == "int8"),
                                                      gathered(v, table, kind == "int8"),
                                                      attn_mask=mask)

            shapes[key] = {"bound_ms": nbytes / PEAK_BYTES * 1e3, "bytes": nbytes,
                           "library_ms": _ms(library, iters=20, warmup=3),
                           "plain_ms": _ms(lambda: tpa.paged_attention_plain(q, k, v, table, lens),
                                           iters=5, warmup=1)}
            cases[key] = (q, k, v, table, lens)
    reps = []
    for _ in range(args.reps):
        rec = {}
        for key, (q, k, v, table, lens) in cases.items():
            rec[key] = _ms(lambda: tpa.paged_attention(q, k, v, table, lens))
            rec[key + ", host us per call"] = _host_us(
                lambda: tpa.paged_attention(q, k, v, table, lens))
            rec[key + ", device ms per call"] = _device_ms(
                lambda: tpa.paged_attention(q, k, v, table, lens))
        reps.append(rec)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(json.dumps({"root": os.path.abspath(args.root), "card": smi.splitlines()[0],
                      "shapes": shapes, "reps": reps}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
