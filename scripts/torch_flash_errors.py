#!/usr/bin/env python3
"""Measure the PyTorch port's flash-attention kernels' errors against their
plain versions on one card, under three criteria, for any checkout.

    python3 scripts/torch_flash_errors.py [--root CHECKOUT]

Imports ``ssp_x_vit_tpu_torch`` from ``--root`` (default: this checkout), so a
parent commit that predates ``flash_errors`` is measured the same way; the
criteria are computed here, not imported. For each case (the shapes of
``chip_smoke.py`` phase 3 and ragged ones: head_dim 20-256, s 1-4096, GQA,
windows, softcap) and dtype (fp32, bf16), the forward's out and the
backward's dq, dk, dv are held against ``flash_attention_plain`` and
``flash_attention_backward_plain``:

- scaled: max |diff| / max(1, max |plain|), the limit ``chip_smoke.py``'s TOL
  applies to every kernel;
- whole / tile: rms(diff) / (rms(plain) + atol / rtol) of the whole tensor and
  of its worst 64-row tile, as ``ops/kernels/flash_attention.py``
  ``flash_errors`` computes them with its limits;
- row: the worst row's max |diff| / max(its max |plain|, 1e-3), a per-row
  criterion considered for the flash checks.

Prints one JSON line: the card's name and power limit, every case's numbers
and the largest value of each criterion per dtype.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# (rtol whole, rtol tile, atol) per dtype name, as FLASH_LIMITS in the package.
LIMITS = {"float32": (1e-5, 1e-4, 3e-6), "bfloat16": (1e-2, 3e-2, 1e-4)}
CASES = [  # label, b, h, hkv, s, hd, causal, window, softcap
    ("Llama-2-7B", 1, 32, 32, 2048, 128, True, None, None),
    ("Mistral-7B", 1, 32, 8, 4096, 128, True, 1024, None),
    ("code_llm_small", 2, 6, 2, 1024, 64, True, None, None),
    ("ViT", 2, 4, 4, 197, 64, False, None, None),
    ("ragged hd 32", 1, 2, 2, 160, 32, True, None, None),
    ("phi hd 80", 1, 8, 4, 300, 80, True, None, None),
    ("gemma hd 256", 1, 4, 2, 257, 256, True, None, 50.0),
    ("hd 20 window 1", 1, 2, 2, 65, 20, True, 1, None),
    ("hd 40", 2, 2, 1, 150, 40, True, 64, 30.0),
    ("s 1", 1, 4, 1, 1, 64, True, None, None),
    ("s 63", 1, 8, 1, 63, 128, True, None, None),
    ("s 129", 1, 4, 4, 129, 128, False, None, None),
    ("s 257 window 16", 1, 4, 2, 257, 128, True, 16, 50.0),
    ("hd 80 window 16", 1, 4, 2, 197, 80, True, 16, 50.0),
    ("hd 256 window 40", 1, 4, 2, 300, 256, True, 40, 50.0),
]


def criteria(got, plain, dtype_name) -> dict:
    import torch

    rtol, tile_rtol, atol = LIMITS[dtype_name]
    ref = plain.float()
    diff = got.float() - ref
    out = {"scaled": diff.abs().max().item() / max(1.0, ref.abs().max().item())}
    out["whole"] = (diff.pow(2).mean().sqrt() / (ref.pow(2).mean().sqrt() + atol / rtol)).item()
    s, hd = ref.shape[-2], ref.shape[-1]
    pad = (-s) % 64
    count = torch.nn.functional.pad(torch.ones(s, device=ref.device), (0, pad)).view(-1, 64).sum(-1) * hd

    def tile_rms(x):
        sq = torch.nn.functional.pad(x.pow(2), (0, 0, 0, pad))
        return (sq.reshape(ref.shape[:-2] + ((s + pad) // 64, 64 * hd)).sum(-1) / count).sqrt()

    out["tile"] = (tile_rms(diff) / (tile_rms(ref) + atol / tile_rtol)).max().item()
    out["row"] = (diff.abs().amax(-1) / ref.abs().amax(-1).clamp_min(1e-3)).max().item()
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_flash_errors: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from ssp_x_vit_tpu_torch.ops.kernels import build
    from ssp_x_vit_tpu_torch.ops.kernels import flash_attention as tfa

    build.build_all()
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    cases, worst = {}, {}
    for label, b, h, hkv, s, hd, causal, window, softcap in CASES:
        kw = dict(causal=causal, window=window, softcap=softcap)
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[1]

            def rn(*shape):
                return torch.randn(*shape, generator=gen, device=device).to(dtype)

            q, k, v, g = rn(b, h, s, hd), rn(b, hkv, s, hd), rn(b, hkv, s, hd), rn(b, h, s, hd)
            out, lse = tfa.flash_attention_forward(q, k, v, with_lse=True, **kw)
            got = [out, *tfa.flash_attention_backward(q, k, v, out, lse, g, **kw)]
            ref = [tfa.flash_attention_plain(q, k, v, **kw),
                   *tfa.flash_attention_backward_plain(q, k, v, g, **kw)]
            torch.cuda.synchronize()
            rec = {}
            for name, a, r in zip(("out", "dq", "dk", "dv"), got, ref):
                rec[name] = criteria(a, r, dn)
                for crit, value in rec[name].items():
                    key = f"{dn} {crit}"
                    if value > worst.get(key, (-1.0, ""))[0]:
                        worst[key] = (value, f"{label} {name}")
            cases[f"{label} {dn}"] = rec
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(json.dumps({"root": os.path.abspath(args.root), "card": smi.splitlines()[0],
                      "worst": worst, "cases": cases}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
