"""Consensus mask CLI — counterpart of reference
manual-experiments/consensus_mask.py (same flags, >=2-files requirement,
[consensus]/[ok] logging contract).

The port's copy of ``ssp_x_vit_tpu/cli/consensus_mask.py``: the same flags, log lines
and output bytes; host code, no device.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict

from ssp_x_vit_tpu_torch.masks.codec import (
    PathTuple, dump_json_atomic, find_leaf_ij_dicts, load_json,
    parse_fraction, reconstruct_tree,
)
from ssp_x_vit_tpu_torch.masks.consensus import consensus_for_path
from ssp_x_vit_tpu_torch.cli.aggregate_and_mask_summation import collect_files


def build_argparser():
    p = argparse.ArgumentParser(
        description="Build consensus-based pruning mask (equal-per-block) from multiple normalized JSON files.")
    p.add_argument("files", nargs="*")
    p.add_argument("--pattern", action="append", default=[])
    p.add_argument("--prune", type=float, required=True)
    p.add_argument("--rounding", type=str, choices=["floor", "round", "ceil"], default="round")
    p.add_argument("--mask-out", type=str, default="runs/masks/mask_consensus.json")
    p.add_argument("--default-dir", type=str, default="runs/masks/normalized")
    p.add_argument("--dry-run", action="store_true")
    return p


def main():
    args = build_argparser().parse_args()
    inputs = collect_files(Path(args.default_dir), args.pattern, args.files)
    if not inputs:
        print("[error] no input JSON files")
        return
    print(f"[info] using {len(inputs)} file(s)")

    bag: Dict[PathTuple, list] = {}
    for src in inputs:
        try:
            data = load_json(src)
        except Exception as e:
            print(f"[warn] skip {src}: {e}")
            continue
        leaves = find_leaf_ij_dicts(data)
        if not leaves:
            print(f"[info] {src}: no ij-leaves")
            continue
        for pth, leaf in leaves:
            bag.setdefault(pth, []).append(leaf)

    common = {p: ls for p, ls in bag.items() if len(ls) >= 2}
    if not common:
        print("[error] no common paths with >=2 files having ij-leaves")
        return

    frac = parse_fraction(args.prune)
    masks: Dict[PathTuple, Dict[str, int]] = {}
    total_ones = 0
    for pth, leaves in common.items():
        m = consensus_for_path(leaves, prune_fraction=frac, rounding=args.rounding, verbose=True)
        masks[pth] = m
        total_ones += sum(m.values())

    if args.dry_run:
        print("[dry] consensus mask would be saved to:", args.mask_out)
        print(f"[dry] total ones (global) = {total_ones}")
    else:
        dump_json_atomic(reconstruct_tree(masks), Path(args.mask_out))
        print(f"[ok] consensus mask saved to: {args.mask_out}")
        print(f"[ok] total ones (global) = {total_ones}")


if __name__ == "__main__":
    main()
