#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s LLM-method phases alone on one card: SliceGPT,
EvoPress, the ablation suite and an offline task pack through
``cli.main_llm.run`` at Llama-2-7B widths (``phase_llm_methods``), then the
same methods on ``ckpts/code_llm_small``, card against host CPU
(``phase_anchor_llm_methods``).

    python3 scripts/torch_llm_methods_phases.py [--anchor-only | --main-only]

Builds the kernels first. Prints their ``[METHODS]`` and ``[ANCHOR]`` lines
and the launches of the driven runs; any failed check raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    which = p.add_mutually_exclusive_group()
    which.add_argument("--anchor-only", action="store_true")
    which.add_argument("--main-only", action="store_true")
    args = p.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from ssp_x_vit_tpu_torch.ops.kernels import build

    if not torch.cuda.is_available():
        print("torch_llm_methods_phases: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.log(f"[DEVICE] {cs.nvidia_smi_line()}")
    t0 = time.perf_counter()
    build.build_all()
    cs.log(f"[BUILD] {time.perf_counter() - t0:.1f} s")
    device = torch.device("cuda", 0)
    if not args.anchor_only:
        t0 = time.perf_counter()
        launches = cs.phase_llm_methods(device)
        cs.log(f"[METHODS] launches of the driven runs "
               f"{json.dumps({k: n for k, n in launches.items() if n})}; "
               f"{time.perf_counter() - t0:.1f} s")
    if not args.main_only:
        t0 = time.perf_counter()
        cs.phase_anchor_llm_methods(device)
        cs.log(f"[ANCHOR] {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
