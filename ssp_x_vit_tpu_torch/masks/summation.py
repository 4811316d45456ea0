"""Summation score ensembling + equal-per-block bottom-K masking
(reference manual-experiments/aggregate_and_mask-summation.py:138-379).

- aggregate: element-wise sum of matching 'i:j' leaves across files (missing
  keys contribute 0);
- mask: common K = min_i round(p * N_i) (or explicit per-block K); in each
  block the K smallest aggregated values are marked 1 (prune).

Selection is vectorized over dense per-block arrays (argsort), replacing the
reference's per-key python sorts; tie-breaking matches (ascending value,
then ascending neuron id via stable sort over id-sorted arrays).

The port's copy of ``ssp_x_vit_tpu/masks/summation.py`` (host code, numpy only):
the same results and, where it writes JSON, the same bytes.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from ssp_x_vit_tpu_torch.masks.codec import (
    PathTuple,
    find_leaf_ij_dicts,
    leaf_to_arrays,
    arrays_to_leaf,
    load_json,
    rounding_fn,
)


def aggregate_leaves(files) -> Dict[PathTuple, Dict[str, float]]:
    """Sum all 'i:j' leaves by tree path across files."""
    sums: Dict[PathTuple, Dict[str, float]] = {}
    for src in files:
        try:
            data = load_json(src)
        except Exception as e:
            print(f"[warn] skip {src}: {e}")
            continue
        leaves = find_leaf_ij_dicts(data)
        if not leaves:
            print(f"[info] no leaf ij-dicts in {src}")
        for path, leaf in leaves:
            target = sums.setdefault(path, {})
            for k, v in leaf.items():
                target[k] = target.get(k, 0.0) + float(v)
    return sums


def make_mask_for_leaf(
    leaf: Dict[str, float],
    prune_fraction: float,
    rounding: str = "round",
    per_block_k: Optional[int] = None,
) -> Dict[str, int]:
    """Equal-per-block bottom-K mask over one aggregated leaf."""
    blocks = leaf_to_arrays(leaf)
    if not blocks:
        return {k: 0 for k in sorted(leaf.keys())}

    unique_blocks = sorted(blocks.keys())
    if len(unique_blocks) != 12:
        print(f"[warn] leaf has {len(unique_blocks)} block(s), expected 12. "
              f"Proceeding anyway: {unique_blocks}")

    if per_block_k is None:
        rfun = rounding_fn(rounding)
        k_candidates = [
            max(0, min(len(ids), rfun(prune_fraction * len(ids))))
            for ids, _ in blocks.values()
        ]
        common_k = min(k_candidates) if k_candidates else 0
    else:
        common_k = max(0, per_block_k)

    mask_blocks: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    for i, (ids, vals) in blocks.items():
        k_i = min(common_k, len(ids))
        m = np.zeros(len(ids), np.int64)
        if k_i > 0:
            order = np.argsort(vals, kind="stable")  # ids pre-sorted -> value, then id
            m[order[:k_i]] = 1
        mask_blocks[i] = (ids, m)
    return arrays_to_leaf(mask_blocks, as_int=True)
