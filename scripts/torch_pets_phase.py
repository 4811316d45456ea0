#!/usr/bin/env python3
"""``chip_smoke.py``'s Oxford-IIIT-Pet phase (``[PET]``) alone on one card.

    python3 scripts/torch_pets_phase.py

Builds every kernel (and, beside nvcc, the image reader with g++), then runs
``phase_pets``: the committed fixtures
decoded on the host against ``expected.json``, ``load_srp_dataset`` on a
Pets directory at the dataset's counts for both splits, the B/16 2SSP run
with its launch counts, and one evaluation batch under
``utils.profiling.trace``. Prints the phase's seconds. Then, on a fresh
full-count directory, where a split's host time goes (``[PET-PARTS]``): the
test split's JPEG files alone through ``load_resized`` on every CPU of the
process and on one, and its PNG files alone.
"""

import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from ssp_x_vit_tpu_torch.ops.kernels import build

    device = torch.device("cuda", 0)
    cs.log(f"[DEVICE] {cs.nvidia_smi_line()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    with cs.build_host_library() as host_build:
        build.build_all()
    cs.log(f"[BUILD] {time.perf_counter() - t0:.1f} s (g++ native/image_decode.cc "
           f"{host_build['seconds']:.1f} s beside nvcc)")
    t0 = time.perf_counter()
    launches = cs.phase_pets(device)
    cs.log(f"[PET] launches {dict((k, v) for k, v in launches.items() if v)}; "
           f"{time.perf_counter() - t0:.1f} s")

    from ssp_x_vit_tpu_torch.data import image_decode
    from ssp_x_vit_tpu_torch.data.pets import pets_split

    with tempfile.TemporaryDirectory() as root:
        cs.write_pets_full_count(root)
        paths, _ = pets_split(root, "test")
        kinds = []
        for p in paths:
            with open(p, "rb") as f:
                kinds.append(image_decode.image_format(p, f.read(8)))
        for label, subset, threads in (
                ("JPEG", [p for p, k in zip(paths, kinds) if k == "jpeg"], None),
                ("JPEG", [p for p, k in zip(paths, kinds) if k == "jpeg"], 1),
                ("PNG", [p for p, k in zip(paths, kinds) if k == "png"], None)):
            t0 = time.perf_counter()
            image_decode._load_resized(subset, 224, threads or image_decode.affinity_threads())
            dt = time.perf_counter() - t0
            cs.log(f"[PET-PARTS] test split, {len(subset)} {label} files to 224: {dt:.2f} s, "
                   f"{len(subset) / dt:.1f} images/s, "
                   f"{threads or image_decode.affinity_threads()} thread(s); "
                   f"{cs.nvidia_smi_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
