#!/usr/bin/env python3
"""Profile one checkout's decode steps on one card at the full width and
depth of Llama-2-7B (random bf16 weights made on the card from a seed):

- the paged server's decode at 8 live slots of ~520 cached tokens, bf16
  pools (``chip_smoke.measure_decode``: ms per step on the host clock for
  each of 4 blocks of 8 steps, hand-written kernel launches per step, and a
  ``torch.profiler`` split of one more block: device kernels and device ms
  per step);
- the contiguous ``decode_step`` of the model quantized to int8 at b=8 with
  a bf16 cache after a prefill of prompts of 64-512 tokens
  (``chip_smoke._profile_decode``: prefill seconds, ms per step, and a
  profiler split of 4 steps).

    python3 scripts/torch_decode_profile.py [--root CHECKOUT]

Imports ``ssp_x_vit_tpu_torch`` from ``--root`` (default: this checkout) and
the measuring functions from this checkout's ``chip_smoke.py``, so two
checkouts are measured by the same code, in turns within one machine.
Prints the ``[SERVE]`` / ``[PROFILE]`` lines of those functions and one JSON
line with the card's name and power limit and the measured numbers.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=HERE)
    args = parser.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_decode_profile: no CUDA device is available", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from ssp_x_vit_tpu_torch.llm.datasets import synthetic_token_stream
    from ssp_x_vit_tpu_torch.llm.quant import quantize_llm_params_int8
    from ssp_x_vit_tpu_torch.ops.kernels import build

    if not build.__file__.startswith(root):
        raise RuntimeError(f"ssp_x_vit_tpu_torch came from {build.__file__}, not {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    device = torch.device("cuda", 0)
    params, cfg = cs.make_llama_7b(device)
    paged = cs.measure_decode(params, cfg, device)
    q8 = quantize_llm_params_int8(params, cfg)
    del params
    torch.cuda.empty_cache()
    rng = np.random.default_rng(31)  # the prompts of chip_smoke.phase_contiguous
    lo, hi = cs.GEN_PROMPTS
    lens = [lo, hi] + sorted(rng.integers(lo + 1, hi, 6).tolist())
    stream = synthetic_token_stream(sum(lens), cfg.vocab_size, seed=33).reshape(-1)
    cuts = np.cumsum([0] + lens)
    prompts = [stream[cuts[i]:cuts[i + 1]].astype(np.int64) for i in range(len(lens))]
    part = cs._profile_decode(q8, cfg, device, torch.bfloat16, prompts)
    print(f"[PROFILE] contiguous decode step, int8 tree, bf16 cache: {part['n_launch']:.0f} device "
          f"kernels and {part['busy_ms']:.2f} ms of device activity per step against "
          f"{part['step_ms']:.2f} ms on the host clock; prefill {part['prefill_s']:.3f} s", flush=True)
    for key, ms, count in part["top"]:
        print(f"[PROFILE]   {ms:8.3f} ms {100 * ms / max(part['busy_ms'], 1e-9):5.1f}%  x{count:<4d} {key}",
              flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(json.dumps({"root": root, "card": smi.splitlines()[0], "paged": paged, "contiguous": {
        k: part[k] for k in ("prefill_s", "step_ms", "busy_ms", "n_launch")},
        "contiguous_top": part["top"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
