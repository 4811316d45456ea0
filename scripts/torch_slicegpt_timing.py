#!/usr/bin/env python3
"""Where SliceGPT's eigendecompositions run: time the float64 covariance and
``eigh`` of one PCA at Llama-2-7B width (d = 4096) on the card and on the
host, as ``ssp_x_vit_tpu_torch/llm/slicegpt.py`` would do them.

    python3 scripts/torch_slicegpt_timing.py [--windows 16] [--reps 3]

Signals: ``--windows`` windows of [1, 2048, 4096] fp32 made on the card from
a seed, with a decaying spectrum (the covariance of a layer's hidden states
is far from white). Per repetition: the covariance (``covariance``: X^T X
summed in fp64 on the card), ``eigh_descending`` on the card (cuSOLVER), the
same on the host in torch (LAPACK) after a copy of H, ``numpy.linalg.eigh``
on the host (the JAX package's choice), and ``random_orthogonal_upper_left``
at (4096, 3072), the host-side numpy draw and QR that
``final_orientation="random"`` adds to each PCA at 25% sparsity, each on the
host's clock around work that ends in a synchronize; the eigenvalues of the
card and the host within 1e-10 relative. Prints one JSON line with the card's
name and power limit. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--windows", type=int, default=16)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import numpy as np
    import torch

    from ssp_x_vit_tpu_torch.llm.slicegpt import (
        covariance, eigh_descending, random_orthogonal_upper_left,
    )

    if not torch.cuda.is_available():
        print("torch_slicegpt_timing: no CUDA device is available", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    d, s = 4096, 2048
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    scale = torch.logspace(0, -3, d, device=device)
    signals = [torch.randn(1, s, d, generator=gen, device=device) * scale
               for _ in range(args.windows)]

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    reps = []
    eigh_descending(covariance(signals[:1]))   # cuSOLVER / cuBLAS warm-up
    for _ in range(args.reps):
        H, cov_s = timed(lambda: covariance(signals))
        H_host = H.cpu()
        (val, _), card_s = timed(lambda: eigh_descending(H.clone()))
        (val_host, _), host_s = timed(lambda: eigh_descending(H_host.clone()))
        H_np = H_host.numpy().copy()
        H_np[np.arange(d), np.arange(d)] += 0.01 * np.mean(np.diag(H_np))
        t0 = time.perf_counter()
        np.linalg.eigh(H_np)
        numpy_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        random_orthogonal_upper_left(d, d * 3 // 4, 0)
        orient_s = time.perf_counter() - t0
        err = float(((val.cpu() - val_host).abs() / val_host.abs()).max())
        if not err <= 1e-10:
            raise AssertionError(f"eigenvalues card vs host differ by {err}")
        reps.append({"covariance_s": cov_s, "eigh_card_s": card_s, "eigh_host_torch_s": host_s,
                     "eigh_host_numpy_s": numpy_s, "random_orientation_host_s": orient_s,
                     "eigenvalues_rel_err": err})
    print(json.dumps({"card": smi, "d": d, "windows": args.windows, "tokens": args.windows * s,
                      "host_threads": torch.get_num_threads(), "reps": reps}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
