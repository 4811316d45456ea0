#!/usr/bin/env python3
"""Time the PyTorch port's flash-attention kernels on one card at the
Llama-2-7B layer shape (b=1, h=32, s=2048, hd=128, causal, bf16).

    python3 scripts/torch_flash_timing.py [--root CHECKOUT] [--reps 3]

Imports ``ssp_x_vit_tpu_torch`` from ``--root`` (default: this checkout), so
two checkouts can be timed in turns within one machine (A, B, B, A). Prints
one JSON line: the card's name and power limit, and per repetition the ms of
the no-grad forward (CUDA events over 50 launches after 10 warm-up launches)
and, when the checkout has them, of the forward that also writes the row
log-sum-exp and of the backward (dq and dk/dv kernels).
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
        print("torch_flash_timing: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from ssp_x_vit_tpu_torch.ops.attention import flash_attention
    from ssp_x_vit_tpu_torch.ops.kernels import build
    from ssp_x_vit_tpu_torch.ops.kernels import flash_attention as tfa

    build.build_all()
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    q, k, v, g = (torch.randn(1, 32, 2048, 128, generator=gen, device=device).bfloat16()
                  for _ in range(4))
    has_bwd = hasattr(tfa, "flash_attention_backward")
    if has_bwd:
        out, lse = tfa.flash_attention_forward(q, k, v, causal=True, with_lse=True)
    reps = []
    for _ in range(args.reps):
        rec = {"forward_ms": _ms(lambda: flash_attention(q, k, v, causal=True))}
        if has_bwd:
            rec["forward_lse_ms"] = _ms(
                lambda: tfa.flash_attention_forward(q, k, v, causal=True, with_lse=True))
            rec["backward_ms"] = _ms(
                lambda: tfa.flash_attention_backward(q, k, v, out, lse, g, causal=True))
        reps.append(rec)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(json.dumps({"root": os.path.abspath(args.root), "card": smi.splitlines()[0],
                      "shape": "b=1 h=32 s=2048 hd=128 causal bf16", "reps": reps}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
