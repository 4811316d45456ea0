"""Summation aggregation + equal-per-block mask CLI — counterpart of
reference manual-experiments/aggregate_and_mask-summation.py (same flags,
outputs and [ok]/[info]/[dry] logging contract).

The port's copy of ``ssp_x_vit_tpu/cli/aggregate_and_mask_summation.py``: the same flags, log lines
and output bytes; host code, no device.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, List

from ssp_x_vit_tpu_torch.masks.codec import (
    PathTuple, dump_json_atomic, find_leaf_ij_dicts, leaf_to_arrays,
    load_json, parse_fraction, reconstruct_tree,
)
from ssp_x_vit_tpu_torch.masks.summation import aggregate_leaves, make_mask_for_leaf


def collect_files(default_dir: Path, patterns: List[str], files: List[str]) -> List[Path]:
    collected: List[Path] = []
    for p in files:
        path = Path(p)
        if path.exists() and path.suffix.lower() == ".json":
            collected.append(path)
    for pat in patterns:
        collected.extend(p for p in Path(".").glob(pat) if p.suffix.lower() == ".json")
    if not collected:
        collected = sorted(default_dir.glob("*.json"))
    seen, unique = set(), []
    for p in collected:
        rp = p.resolve()
        if rp not in seen:
            seen.add(rp)
            unique.append(p)
    return unique


def build_argparser():
    p = argparse.ArgumentParser(
        description="Aggregate normalized JSON scores and build equal-per-block pruning masks.")
    p.add_argument("files", nargs="*")
    p.add_argument("--pattern", action="append", default=[])
    p.add_argument("--aggregated", type=str, default=None, help="Use precomputed sums file")
    p.add_argument("--aggregate-out", type=str, default="runs/masks/aggregated_sums.json")
    p.add_argument("--mask-out", type=str, default="runs/masks/mask.json")
    p.add_argument("--prune", type=float, default=None, help="Percent or fraction to prune")
    p.add_argument("--rounding", type=str, choices=["floor", "round", "ceil"], default="round")
    p.add_argument("--per-block-k", type=int, default=None)
    p.add_argument("--default-dir", type=str, default="runs/masks/normalized")
    p.add_argument("--dry-run", action="store_true")
    return p


def main():
    args = build_argparser().parse_args()

    if args.aggregated:
        agg_path = Path(args.aggregated)
        if not agg_path.exists():
            print(f"[error] aggregated file not found: {agg_path}")
            return
        data = load_json(agg_path)
        aggregated = dict(find_leaf_ij_dicts(data))
        print(f"[info] loaded aggregated from: {agg_path} (leaf groups: {len(aggregated)})")
    else:
        inputs = collect_files(Path(args.default_dir), args.pattern, args.files)
        if not inputs:
            print("[error] no input JSON files to aggregate.")
            return
        print(f"[info] aggregating {len(inputs)} file(s)...")
        aggregated = aggregate_leaves(inputs)
        print(f"[info] found {len(aggregated)} leaf group(s) with ij-keys.")
        if not args.dry_run:
            dump_json_atomic(reconstruct_tree(aggregated), Path(args.aggregate_out))
            print(f"[ok] aggregated sums saved to: {args.aggregate_out}")

    if args.prune is not None or args.per_block_k is not None:
        if not aggregated:
            print("[error] no ij-leaf groups found in aggregated data; cannot build mask.")
            return
        frac = 0.0 if (args.per_block_k is not None and args.prune is None) else parse_fraction(args.prune or 0.0)
        masks: Dict[PathTuple, Dict[str, int]] = {}
        stats = []
        for path, leaf in aggregated.items():
            m = make_mask_for_leaf(leaf, prune_fraction=frac, rounding=args.rounding,
                                   per_block_k=args.per_block_k)
            masks[path] = m
            blocks = leaf_to_arrays(leaf)
            any_block = next(iter(sorted(blocks)))
            k_block = sum(m[f"{any_block}:{int(j)}"] for j in blocks[any_block][0])
            stats.append(f"path={'/'.join(path) or '<root>'} blocks={len(blocks)} "
                         f"total={sum(len(v[0]) for v in blocks.values())} K_per_block~{k_block}")
        if args.dry_run:
            print("[dry] mask would be saved to:", args.mask_out)
            for s in stats:
                print("[dry]", s)
        else:
            dump_json_atomic(reconstruct_tree(masks), Path(args.mask_out))
            print(f"[ok] mask saved to: {args.mask_out}")
            for s in stats:
                print("[info]", s)


if __name__ == "__main__":
    main()
