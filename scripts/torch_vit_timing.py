#!/usr/bin/env python3
"""Time the PyTorch port's ViT block kernels on one card, bf16: each C entry
point that the block wrappers launch (the LayerNorm, the QKV GEMM with its
bias, the attention core, the projection GEMM with the gated residual, fc1
with GELU and mask, with and without the stats, fc2 with the gated
residual) beside ``torch.mm`` at each GEMM's shape and SDPA for the core; and
the four wrappers (rows 1-4 of the kernel table in PERF.md) beside their
library composition (``layer_norm`` + ``F.linear`` + SDPA / ``F.gelu``).
Shapes: ViT-B/16 at b=64 and b=1, ViT-Ti/16 at b=64 (s=197). With --cli it
also runs the ViT-B/16 2SSP CLI twice as ``chip_smoke.py`` phase 4 runs it
(random weights, synthetic data, 25%) and records each run's seconds by phase.

    python3 scripts/torch_vit_timing.py [--root CHECKOUT] [--reps 3] [--cli]

Imports ``ssp_x_vit_tpu_torch`` from ``--root`` (default: this checkout) and
builds only its csrc/gemm.cu and csrc/attention.cu, so two checkouts can be
timed in turns within one machine (A, B, B, A). Prints one JSON line: the
card's name and power limit, and per shape, part and repetition the ms of one
call (CUDA events over 50 launches after 10 warm-up launches).
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


def _parts(b: int, s: int, d: int, heads: int, f: int, gen, device) -> dict:
    """label -> zero-argument callable, at one model's shapes."""
    import torch
    import torch.nn.functional as F

    from ssp_x_vit_tpu_torch.ops.kernels import build
    from ssp_x_vit_tpu_torch.ops.kernels import fused_attn_block as fab
    from ssp_x_vit_tpu_torch.ops.kernels import fused_ffn as ffk

    m, hd, dt = b * s, d // heads, torch.bfloat16

    def rn(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen, device=device) * std).to(dt)

    x = rn(b, s, d)
    lns, lnb = (1 + rn(d, std=0.1).float()).to(dt), rn(d, std=0.1)
    wqkv, bqkv, wproj, bproj = rn(d, 3 * d, std=d ** -0.5), rn(3 * d, std=0.1), rn(d, d, std=d ** -0.5), rn(d, std=0.1)
    w1, b1, w2, b2 = rn(d, f, std=d ** -0.5), rn(f, std=0.1), rn(f, d, std=f ** -0.5), rn(d, std=0.1)
    mask = (torch.rand(f, generator=gen, device=device) > 0.3).float()
    gate = torch.ones((), device=device)
    y = build.layer_norm(x, lns, lnb, 1e-12)
    qkv = torch.empty(m, 3 * d, device=device, dtype=dt)
    o, out = torch.empty(m, d, device=device, dtype=dt), torch.empty_like(x)
    h = torch.empty(m, f, device=device, dtype=dt)
    stats = torch.empty(b, f, device=device)
    build.gemm(y, wqkv, qkv, build.EPI_BIAS, bias=bqkv)
    build.gemm(y, w1, h, build.EPI_GELU, bias=b1, mask=mask)
    wqkv_t, wproj_t, w1_t, w2_t = (w.t().contiguous() for w in (wqkv, wproj, w1, w2))
    mask_t = mask.to(dt)
    attn = "fused_attn_block_v2" if heads % 2 == 0 else "fused_attn_block"

    def attn_library():
        z = F.layer_norm(x, (d,), lns, lnb, 1e-12)
        q, k, v = F.linear(z, wqkv_t, bqkv).split(d, dim=-1)
        q, k, v = (t.reshape(b, s, heads, hd).transpose(1, 2) for t in (q, k, v))
        a = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(b, s, d)
        return x + gate.to(dt) * F.linear(a, wproj_t, bproj)

    def ffn_library(block):
        z = F.layer_norm(x, (d,), lns, lnb, 1e-12) if block else x
        r = F.linear(F.gelu(F.linear(z, w1_t, b1)) * mask_t, w2_t, b2)
        return x + r if block else r

    return {
        "layer_norm": lambda: build.layer_norm(x, lns, lnb, 1e-12),
        "qkv gemm (+bias)": lambda: build.gemm(y, wqkv, qkv, build.EPI_BIAS, bias=bqkv),
        "torch.mm qkv": lambda: torch.mm(y.view(m, d), wqkv),
        "attention core": lambda: build.attention(qkv, o, b, s, heads, hd, hd ** -0.5),
        "sdpa core": lambda: F.scaled_dot_product_attention(
            *qkv.view(b, s, 3, heads, hd).permute(2, 0, 3, 1, 4)),
        "proj gemm (+gated residual)": lambda: build.gemm(
            o, wproj, out, build.EPI_RESIDUAL, bias=bproj, resid=x, gate=gate),
        "torch.mm proj": lambda: torch.mm(o, wproj),
        "fc1 gemm (+gelu, mask, stats)": lambda: build.gemm(
            y, w1, h, build.EPI_GELU, bias=b1, mask=mask, stats=stats, seq=s),
        "fc1 gemm (+gelu, mask)": lambda: build.gemm(y, w1, h, build.EPI_GELU, bias=b1, mask=mask),
        "torch.mm fc1": lambda: torch.mm(y.view(m, d), w1),
        "fc2 gemm (+gated residual)": lambda: build.gemm(
            h, w2, out, build.EPI_RESIDUAL, bias=b2, resid=x, gate=gate),
        "torch.mm fc2": lambda: torch.mm(h, w2),
        f"row {1 if attn.endswith('v2') else 2} {attn}": lambda: getattr(fab, attn)(
            x, lns, lnb, wqkv, bqkv, wproj, bproj, heads, gate=gate),
        "library attention block": attn_library,
        "row 3 fused_ffn_block (mask, stats)": lambda: ffk.fused_ffn_block(
            x, lns, lnb, w1, b1, w2, b2, neuron_mask=mask, gate=gate, collect_stats=True),
        "library ffn block": lambda: ffn_library(True),
        "row 4 fused_ffn (mask, stats)": lambda: ffk.fused_ffn(
            x, w1, b1, w2, b2, neuron_mask=mask, collect_stats=True),
        "library ffn": lambda: ffn_library(False),
    }


def _cli_seconds(out_root: str) -> dict:
    """Seconds by phase of one ViT-B/16 ``auto_2ssp`` run on the card."""
    import time

    from ssp_x_vit_tpu_torch.cli import auto_2ssp

    argv = ["--model", "vit-b16", "--dataset", "synthetic", "--target", "0.25", "--stage", "both",
            "--eval-batches", "2", "--min-remaining", "512", "--backend", "cuda",
            "--out-root", out_root]
    t0 = time.perf_counter()
    report = auto_2ssp.run(auto_2ssp.build_argparser().parse_args(argv))
    return dict(report["phase_seconds"], wall=time.perf_counter() - t0)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--cli", action="store_true", help="also time the ViT-B/16 2SSP CLI")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_vit_timing: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from ssp_x_vit_tpu_torch.ops.kernels import build

    build.SOURCES = ("gemm", "attention")
    build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    shapes = {}
    with torch.no_grad():
        for label, b, d, heads, f in (("ViT-B/16", 64, 768, 12, 3072), ("ViT-B/16", 1, 768, 12, 3072),
                                      ("ViT-Ti/16", 64, 192, 3, 768)):
            parts = _parts(b, 197, d, heads, f, gen, device)
            shapes[f"{label} b={b} s=197 d={d} heads={heads} f={f} bf16"] = {
                name: [_ms(fn) for _ in range(args.reps)] for name, fn in parts.items()}
    result = {"root": os.path.abspath(args.root), "shapes": shapes}
    if args.cli:
        import tempfile

        with tempfile.TemporaryDirectory() as out_root:
            result["cli_phase_seconds"] = [_cli_seconds(os.path.join(out_root, str(i)))
                                           for i in range(2)]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    result["card"] = smi.splitlines()[0]
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
