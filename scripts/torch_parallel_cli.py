#!/usr/bin/env python3
"""``auto_2ssp --data-parallel`` through the CLI's own launcher, against the
same command in one process.

    python3 scripts/torch_parallel_cli.py [--out-root DIR]

Runs ``python -m ssp_x_vit_tpu_torch.cli.auto_2ssp`` at ViT-B/16 on synthetic
data twice: once in one process, once with ``--data-parallel``, which on
more than one visible card builds the kernel libraries and becomes
``torch.distributed.run`` with one worker per card. Then it holds the
data-parallel report to the single one: the same plan, pruned blocks and
kept widths, kept neurons that differ in at most 1% (importances summed in
another order may swap neurons at the cut) and top-1 within 2 of the 128 test
images. Prints one line per check and the seconds of each run, and exits
non-zero on a failed check or run. With one card the second run is one
process too (``--data-parallel`` is then a no-op).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGV = ["--model", "vit-b16", "--dataset", "synthetic", "--target", "0.25", "--stage", "both",
        "--eval-batches", "2", "--min-remaining", "512", "--backend", "cuda"]
EVAL_IMAGES = 2 * 64          # two synthetic test batches of 64 images (cli/common.py)
TOP1_LIMIT = 2 / EVAL_IMAGES
NEURON_SHARE = 1e-2
TIMEOUT_S = 600


def cli(out_root: str, extra) -> float:
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "ssp_x_vit_tpu_torch.cli.auto_2ssp", *ARGV, *extra,
                    "--out-root", out_root], cwd=ROOT, check=True, timeout=TIMEOUT_S)
    return time.perf_counter() - t0


def load(out_root: str, pattern: str):
    (path,) = glob.glob(os.path.join(out_root, pattern))
    with open(path) as f:
        return json.load(f)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out-root", default=None, help="where both runs write (default: a temp dir)")
    args = p.parse_args()

    import torch

    cards = torch.cuda.device_count()
    with tempfile.TemporaryDirectory() as tmp:
        root = args.out_root or tmp
        single, dp = os.path.join(root, "single"), os.path.join(root, "dp")
        s_single = cli(single, [])
        s_dp = cli(dp, ["--data-parallel"])
        rs, rd = (load(r, "reports/*.json") for r in (single, dp))
        ms, md = (load(r, "artifacts/*/ffn_prune_masks.json") for r in (single, dp))
    swapped = sum(len(set(a) - set(b)) for a, b in zip(md["indices"], ms["indices"]))
    kept = sum(md["block_inter_sizes"])
    checks = [
        ("plan equal", rd["plan"] == rs["plan"]),
        ("pruned blocks equal",
         rd["artifacts"]["pruned_block_indices"] == rs["artifacts"]["pruned_block_indices"]),
        ("kept widths equal", md["block_inter_sizes"] == ms["block_inter_sizes"]),
        (f"kept neurons differing {swapped} of {kept} (<= {NEURON_SHARE:g})",
         swapped / kept <= NEURON_SHARE),
    ]
    for k in ("acc_baseline", "acc_stage1", "acc_stage2"):
        a, b = rd["metrics"][k], rs["metrics"][k]
        checks.append((f"{k} data-parallel {a!r}, single {b!r} (|delta| <= {TOP1_LIMIT:g})",
                       abs(a - b) <= TOP1_LIMIT))
    print(f"[PARALLEL-CLI] {cards} card(s): single process {s_single:.1f} s, --data-parallel "
          f"{s_dp:.1f} s (launch included); pruned blocks "
          f"{rd['artifacts']['pruned_block_indices']}, kept widths {md['block_inter_sizes']}",
          flush=True)
    for name, ok in checks:
        print(f"[PARALLEL-CLI] {name}: {'ok' if ok else 'FAILED'}", flush=True)
    return 0 if all(ok for _, ok in checks) else 1


if __name__ == "__main__":
    sys.exit(main())
