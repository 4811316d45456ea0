#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s mixture-of-experts and MoE-training phases alone on
one card: Mixtral-8x7B widths through ``cli.main_llm.run`` (dense, int4),
served over HTTP (bf16 and int8 pools), ``generate_kv_scan`` at b=8, trained
through ``cli.train_llm``, and DeepSeek-V3 widths trained through ``Trainer``
(``phase_moe``); the tiny MoE and DeepSeek models trained and served, card
against host CPU (``phase_anchor_moe``).

    python3 scripts/torch_moe_phases.py [moe] [anchor]

No argument runs both. Builds the kernels first; prints the card's name and
power limit, the phases' lines and seconds; any failed check raises.
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    which = sys.argv[1:] or ["moe", "anchor"]
    unknown = set(which) - {"moe", "anchor"}
    if unknown:
        print(f"usage: {sys.argv[0]} [moe] [anchor]; got {sorted(unknown)}", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from ssp_x_vit_tpu_torch.ops.kernels import build

    if not torch.cuda.is_available():
        print("torch_moe_phases: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    cs.log(f"[DEVICE] {cs.nvidia_smi_line()}")
    t0 = time.perf_counter()
    build.build_all()
    cs.log(f"[BUILD] {time.perf_counter() - t0:.1f} s")
    if "moe" in which:
        t0 = time.perf_counter()
        cs.log(json.dumps({k: v for k, v in cs.phase_moe(device).items() if v}))
        cs.log(f"[PHASE] Mixtral widths, MoE and DeepSeek training: "
               f"{time.perf_counter() - t0:.1f} s")
    if "anchor" in which:
        t0 = time.perf_counter()
        cs.phase_anchor_moe(device)
        cs.log(f"[PHASE] tiny MoE and DeepSeek anchors: {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
