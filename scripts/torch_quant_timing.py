#!/usr/bin/env python3
"""Time the PyTorch port's dequant-GEMM kernels on one card, bf16, beside
their bounds and PyTorch's ``torch.mm`` on dequantised copies:

- ``quant_matmul`` (int8) and ``quant4_matmul`` at M = 1, 8, 2048 with K=4096,
  N=11008 (the Llama-2-7B gate projection) and at M=16384, K=1024, N=384;
- ``fused_mlp_int8`` at the Llama-2-7B MLP (d=4096, f=11008) with m = 1, 8
  and 16 (decode: the skinny path, and, where the checkout has it, the
  tensor-core tiles forced at the same rows), 300 and 4096 (prefill).

    python3 scripts/torch_quant_timing.py [--root CHECKOUT] [--reps 3]

Imports ``ssp_x_vit_tpu_torch`` from ``--root`` (default: this checkout) and
builds only the sources it times, so two checkouts can be timed in turns
within one machine (A, B, B, A). Prints one JSON line: the card's name and
power limit, the shapes with their bounds (max of FLOPs at 989 TFLOP/s and
bytes at 3.35 TB/s) and library times, and per repetition the ms of each
kernel (CUDA events over 50 launches after 10 warm-up launches) and, for
``fused_mlp_int8``, the host's microseconds per call to enqueue 50 calls.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12
QUANT_SHAPES = [(1, 4096, 11008), (8, 4096, 11008), (2048, 4096, 11008), (16384, 1024, 384)]
MLP_ROWS = (1, 8, 16, 300, 4096)


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


def _bound_ms(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES) * 1e3


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--reps", type=int, default=3)
    args = parser.parse_args()

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("torch_quant_timing: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from ssp_x_vit_tpu_torch.ops.kernels import build
    from ssp_x_vit_tpu_torch.ops.kernels import quant_fused_mlp as tfm
    from ssp_x_vit_tpu_torch.ops.kernels import quant_matmul as tqm

    build.SOURCES = ("gemm", "quant_gemm", "quant_fused_mlp")
    build.build_all()
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)

    def codes(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=device, dtype=torch.int8)

    def scales(n):
        return torch.rand(n, generator=gen, device=device) * 0.02

    quant, shapes = {}, {}
    for m, k, n in QUANT_SHAPES:
        x = torch.randn(m, k, generator=gen, device=device).bfloat16()
        w8, s = codes(k, n), scales(n)
        w4, s4 = tqm.quantize_weight_int4(torch.randn(k, n, generator=gen, device=device))
        quant[(m, k, n)] = (x, w8, s, w4, s4)
        for bits, w in ((8, w8), (4, w4)):
            deq = (w if bits == 8 else tqm.unpack_int4(w)).bfloat16()
            sb = s.bfloat16()
            shapes[f"quant{bits} M={m} K={k} N={n}"] = {
                "bound_ms": _bound_ms(2 * m * n * k, 2 * (m * k + m * n) + k * n * bits // 8 + 4 * n),
                "library_ms": _ms(lambda: torch.mm(x, deq) * sb)}
            del deq
    d, f = 4096, 11008
    mlp = (codes(d, f), scales(f), codes(d, f), scales(f), codes(f, d), scales(d))
    rows = {m: torch.randn(m, d, generator=gen, device=device).bfloat16() for m in MLP_ROWS}
    deq = [w.bfloat16() for w in mlp[0::2]]
    sc = [s.bfloat16() for s in mlp[1::2]]
    for m, xm in rows.items():
        def dequantised():
            g = torch.mm(xm, deq[0]) * sc[0]
            u = torch.mm(xm, deq[1]) * sc[1]
            return torch.mm(F.silu(g) * u, deq[2]) * sc[2]

        shapes[f"fused_mlp_int8 m={m} d={d} f={f}"] = {
            "bound_ms": _bound_ms(6 * m * d * f, 3 * d * f + 4 * (2 * f + d) + 4 * m * d),
            "library_ms": _ms(dequantised)}
    del deq
    wide = getattr(tfm, "fused_mlp_int8_cuda", None)
    reps = []
    for _ in range(args.reps):
        rec = {}
        for (m, k, n), (x, w8, s, w4, s4) in quant.items():
            rec[f"quant8 M={m} K={k} N={n}"] = _ms(lambda: tqm.quant_matmul(x, w8, s))
            rec[f"quant4 M={m} K={k} N={n}"] = _ms(lambda: tqm.quant4_matmul(x, w4, s4))
        for m, xm in rows.items():
            rec[f"fused_mlp_int8 m={m} d={d} f={f}"] = _ms(lambda: tfm.fused_mlp_int8(xm, *mlp))
            rec[f"fused_mlp_int8 m={m} d={d} f={f}, host us per call"] = _host_us(
                lambda: tfm.fused_mlp_int8(xm, *mlp))
            if m <= 16 and wide is not None:
                rec[f"fused_mlp_int8 m={m} d={d} f={f}, tensor-core tiles"] = _ms(
                    lambda: wide(xm, *mlp, wide=True))
        reps.append(rec)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(json.dumps({"root": os.path.abspath(args.root), "card": smi.splitlines()[0],
                      "shapes": shapes, "reps": reps}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
