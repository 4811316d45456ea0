#!/usr/bin/env python3
"""Time the PyTorch port's dequant-GEMM kernels on one card: ``quant_matmul``
(int8) and ``quant4_matmul`` at the Llama-2-7B gate projection (M=2048,
K=4096, N=11008, bf16) and, when the checkout has it, ``fused_mlp_int8`` at
the Llama-2-7B MLP (d=4096, f=11008, bf16) with m=8 (decode) and m=4096
(prefill).

    python3 scripts/torch_quant_timing.py [--root CHECKOUT] [--reps 3]

Imports ``ssp_x_vit_tpu_torch`` from ``--root`` (default: this checkout), so
two checkouts can be timed in turns within one machine (A, B, B, A). Prints
one JSON line: the card's name and power limit, and per repetition the ms of
each kernel (CUDA events over 50 launches after 10 warm-up launches).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


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

    if not torch.cuda.is_available():
        print("torch_quant_timing: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from ssp_x_vit_tpu_torch.ops.kernels import build
    from ssp_x_vit_tpu_torch.ops.kernels import quant_matmul as tqm

    try:
        from ssp_x_vit_tpu_torch.ops.kernels import quant_fused_mlp as tfm
    except ImportError:
        tfm = None
    build.build_all()
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)

    def codes(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=device, dtype=torch.int8)

    def scales(n):
        return torch.rand(n, generator=gen, device=device) * 0.02

    d, f = 4096, 11008
    x = torch.randn(2048, d, generator=gen, device=device).bfloat16()
    w8, s = codes(d, f), scales(f)
    w4, s4 = tqm.quantize_weight_int4(torch.randn(d, f, generator=gen, device=device))
    mlp = (codes(d, f), scales(f), codes(d, f), scales(f), codes(f, d), scales(d))
    rows = {m: torch.randn(m, d, generator=gen, device=device).bfloat16() for m in (8, 4096)}
    reps = []
    for _ in range(args.reps):
        rec = {"quant_matmul_ms": _ms(lambda: tqm.quant_matmul(x, w8, s)),
               "quant4_matmul_ms": _ms(lambda: tqm.quant4_matmul(x, w4, s4))}
        if tfm is not None:
            for m, xm in rows.items():
                rec[f"fused_mlp_int8_m{m}_ms"] = _ms(lambda: tfm.fused_mlp_int8(xm, *mlp))
        reps.append(rec)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(json.dumps({"root": os.path.abspath(args.root), "card": smi.splitlines()[0],
                      "shapes": "quant: M=2048 K=4096 N=11008; fused: d=4096 f=11008; bf16",
                      "reps": reps}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
