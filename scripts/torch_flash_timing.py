#!/usr/bin/env python3
"""Time the PyTorch port's flash-attention kernels on one card at the main
path's shapes, bf16: Llama-2-7B (h=32, s=2048, hd=128, causal) at b=1 and at
b=8 (the 2SSP candidate search's batch), Mistral-7B (h=32, hkv=8, s=4096,
hd=128, causal, window 1024), and the ViT-B/16 unfused attention (b=64,
h=12, s=197, hd=64, not causal).

    python3 scripts/torch_flash_timing.py [--root CHECKOUT] [--reps 3]

Imports ``ssp_x_vit_tpu_torch`` from ``--root`` (default: this checkout), so
two checkouts can be timed in turns within one machine (A, B, B, A). Prints
one JSON line: the card's name and power limit, and per shape and repetition
the ms of the no-grad forward (CUDA events over 50 launches after 10 warm-up
launches) and, when the checkout has them, of the forward that also writes
the row log-sum-exp, of the backward (dq and dk/dv kernels) and of each
backward kernel alone.
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
    has_bwd = hasattr(tfa, "flash_attention_backward")
    shapes = {}
    for label, b, h, hkv, s, hd, causal, window in (
            ("Llama-2-7B b=1", 1, 32, 32, 2048, 128, True, None),
            ("Llama-2-7B b=8", 8, 32, 32, 2048, 128, True, None),
            ("Mistral-7B", 1, 32, 8, 4096, 128, True, 1024),
            ("ViT-B/16 unfused attention", 64, 12, 12, 197, 64, False, None)):
        kw = dict(causal=causal, window=window)
        q, g = (torch.randn(b, h, s, hd, generator=gen, device=device).bfloat16() for _ in range(2))
        k, v = (torch.randn(b, hkv, s, hd, generator=gen, device=device).bfloat16() for _ in range(2))
        if has_bwd:
            out, lse = tfa.flash_attention_forward(q, k, v, with_lse=True, **kw)
            delta = torch.empty(b, h, s, dtype=torch.float32, device=device)
            dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
            bkw = dict(scale=hd ** -0.5, causal=causal, window=window or 0, softcap=0.0)
        reps = []
        for _ in range(args.reps):
            rec = {"forward_ms": _ms(lambda: flash_attention(q, k, v, **kw))}
            if has_bwd:
                rec["forward_lse_ms"] = _ms(
                    lambda: tfa.flash_attention_forward(q, k, v, with_lse=True, **kw))
                rec["backward_ms"] = _ms(
                    lambda: tfa.flash_attention_backward(q, k, v, out, lse, g, **kw))
                rec["dq_ms"] = _ms(lambda: build.flash_attention_bwd_dq(
                    q, k, v, out, g, lse, delta, dq, **bkw))
                rec["dkv_ms"] = _ms(lambda: build.flash_attention_bwd_dkv(
                    q, k, v, g, lse, delta, dk, dv, **bkw))
            reps.append(rec)
        shapes[f"{label}: b={b} h={h} hkv={hkv} s={s} hd={hd}" + (" causal" if causal else "") +
               (f" window={window}" if window else "") + " bf16"] = reps
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(json.dumps({"root": os.path.abspath(args.root), "card": smi.splitlines()[0],
                      "shapes": shapes}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
