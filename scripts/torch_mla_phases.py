#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s DeepSeek-V3 phases alone on one card: the MLA
decode kernels against their plain versions with their timings
(``phase_mla_kernels``: the standalone attention; ``phase_mla_write_kernels``
and ``drive_mla_standalone``: the decode layer's write-and-attend launch on
both kernels), the DeepSeek-V3-width runs through
``cli.main_llm.run``, ``deepseek_generate`` and the ``MLAPagedServer`` served
through ``ServingEngine`` (``phase_deepseek``), and the tiny DeepSeek models,
card against host CPU (``phase_anchor_deepseek``).

    python3 scripts/torch_mla_phases.py [kernels] [deepseek] [anchor]

No argument runs all three. Builds the kernels first; prints the card's name
and power limit, the phases' lines and seconds; any failed check raises.
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    which = sys.argv[1:] or ["kernels", "deepseek", "anchor"]
    unknown = set(which) - {"kernels", "deepseek", "anchor"}
    if unknown:
        print(f"usage: {sys.argv[0]} [kernels] [deepseek] [anchor]; got {sorted(unknown)}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from ssp_x_vit_tpu_torch.ops.kernels import build

    if not torch.cuda.is_available():
        print("torch_mla_phases: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    cs.log(f"[DEVICE] {cs.nvidia_smi_line()}")
    t0 = time.perf_counter()
    build.build_all()
    cs.log(f"[BUILD] {time.perf_counter() - t0:.1f} s")
    if "kernels" in which:
        t0 = time.perf_counter()
        cs.log(json.dumps(cs.phase_mla_kernels(device)))
        cs.log(json.dumps(cs.phase_mla_write_kernels(device)))
        cs.log(json.dumps(cs.drive_mla_standalone(device)))
        cs.log(f"[PHASE] MLA kernels: {time.perf_counter() - t0:.1f} s")
    if "deepseek" in which:
        t0 = time.perf_counter()
        cs.log(json.dumps({k: v for k, v in cs.phase_deepseek(device).items() if v}))
        cs.log(f"[PHASE] DeepSeek-V3 widths: {time.perf_counter() - t0:.1f} s")
    if "anchor" in which:
        t0 = time.perf_counter()
        cs.phase_anchor_deepseek(device)
        cs.log(f"[PHASE] tiny DeepSeek anchors: {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
