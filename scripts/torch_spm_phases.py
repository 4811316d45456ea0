#!/usr/bin/env python3
"""``chip_smoke.py``'s tokenizer phase (``[SPM]``) alone on one card.

    python3 scripts/torch_spm_phases.py

Builds every kernel, then runs ``phase_corpus`` (the committed
``corpus_slice`` decoded and written as ``save_to_disk`` directories),
``phase_local`` (which saves the Llama-2-7B-width, 4-layer directory that
``[SPM]`` reuses) and ``phase_spm``: the committed tokenizer fixtures on the
host, then ``main_llm --local_datasets``, ``serve_http`` text prompts and
``train_llm --data`` with the Llama-2-style tokenizer and
``qualitative_results`` with the Qwen-style one. Seconds per phase.
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
    build.build_all()
    cs.log(f"[BUILD] {time.perf_counter() - t0:.1f} s")
    seconds = {}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as work:
        os.chdir(work)
        try:
            t0 = time.perf_counter()
            corpora = cs.phase_corpus(work)
            seconds["corpus"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            cs.phase_local(device, work)
            seconds["local"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            launches = cs.phase_spm(device, work, corpora)
            seconds["spm"] = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
    cs.log(f"[SPM] launches {dict((k, v) for k, v in launches.items() if v)}")
    cs.log("[PHASES] " + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
