#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s ViT mask-ensembling, SRP and token-pruning phases
alone on one card, without the rest of the script.

    python3 scripts/torch_a7c_phases.py               # SRP, grids, token pruning, resize
    python3 scripts/torch_a7c_phases.py --token-only  # token pruning with its profile

Builds the kernels, runs one ViT-B/16 ``auto_2ssp`` (random weights,
synthetic data, 25%) for the grids' first score file, then calls
``make_srp_work``, ``phase_srp``, ``phase_mask_grid``, ``phase_token_pruning``
and ``check_resize`` from ``chip_smoke.py`` in a temporary work directory
(the CLIs look for CIFAR under ``./data``). Prints their ``[SRP]``,
``[MASK]``, ``[TOKEN]``, ``[PROFILE]`` and ``[RESIZE]`` lines; any failed
check raises.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--token-only", action="store_true")
    args = p.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from ssp_x_vit_tpu_torch.cli import auto_2ssp
    from ssp_x_vit_tpu_torch.ops.kernels import build

    if not torch.cuda.is_available():
        print("torch_a7c_phases: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.log(f"[DEVICE] {cs.nvidia_smi_line()}")
    t0 = time.perf_counter()
    build.build_all()
    cs.log(f"[BUILD] {time.perf_counter() - t0:.1f} s")
    device = torch.device("cuda", 0)
    if not args.token_only:
        with tempfile.TemporaryDirectory() as work:
            report = auto_2ssp.run(auto_2ssp.build_argparser().parse_args(
                ["--model", "vit-b16", "--dataset", "synthetic", "--target", "0.25",
                 "--eval-batches", "2", "--backend", "cuda",
                 "--out-root", os.path.join(work, "phase4")]))
            first_scores = report["artifacts"]["ffn_importances_path"]
            cwd = os.getcwd()
            os.chdir(work)
            try:
                t0 = time.perf_counter()
                models = cs.make_srp_work(work)
                _, srp_scores = cs.phase_srp(work, models, device)
                cs.log(f"[SRP] phase: {time.perf_counter() - t0:.1f} s")
                t0 = time.perf_counter()
                cs.phase_mask_grid(work, models, (first_scores, srp_scores), device)
                cs.log(f"[MASK] phase: {time.perf_counter() - t0:.1f} s")
            finally:
                os.chdir(cwd)
    t0 = time.perf_counter()
    cs.phase_token_pruning(device)
    if not args.token_only:
        cs.check_resize(device)
    cs.log(f"[TOKEN] phase: {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
