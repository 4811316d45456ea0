"""Consensus (intersection) mask ensembling
(reference manual-experiments/consensus_mask.py:175-297).

Per block: intersect every file's bottom-k proposal set; grow the internal
fraction t multiplicatively (x1.2, <=100 iterations) until every block's
intersection reaches the common target K = min_i round(p * N_i); overshoot is
resolved by the K smallest mean scores.

Vectorized: all membership tests are rank comparisons on dense [n_files, N_i]
arrays — one argsort per (file, block) replaces the reference's per-candidate
python set machinery.

The port's copy of ``ssp_x_vit_tpu/masks/consensus.py`` (host code, numpy only):
the same results and, where it writes JSON, the same bytes.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ssp_x_vit_tpu_torch.masks.codec import arrays_to_leaf, leaf_to_arrays, rounding_fn


def consensus_for_path(
    leaves_for_files: List[Dict[str, float]],
    prune_fraction: float,
    rounding: str = "round",
    verbose: bool = True,
) -> Dict[str, int]:
    rfun = rounding_fn(rounding)
    per_file = [leaf_to_arrays(leaf) for leaf in leaves_for_files]
    if not per_file:
        return {}

    all_blocks = sorted(set().union(*[set(b.keys()) for b in per_file]))

    # keys common to ALL files per block, and per-file values aligned to them
    common_ids: Dict[int, np.ndarray] = {}
    values: Dict[int, np.ndarray] = {}  # [n_files, N_i]
    ranks: Dict[int, np.ndarray] = {}   # [n_files, N_i] rank of each key in each file
    for i in all_blocks:
        id_sets = [set(fb[i][0].tolist()) if i in fb else set() for fb in per_file]
        common = sorted(set.intersection(*id_sets)) if id_sets else []
        ids = np.asarray(common, np.int64)
        common_ids[i] = ids
        if len(ids) == 0:
            values[i] = np.zeros((len(per_file), 0))
            ranks[i] = np.zeros((len(per_file), 0), np.int64)
            continue
        vmat = np.zeros((len(per_file), len(ids)))
        for fi, fb in enumerate(per_file):
            fids, fvals = fb[i]
            lookup = dict(zip(fids.tolist(), fvals.tolist()))
            vmat[fi] = [lookup[j] for j in ids.tolist()]
        values[i] = vmat
        # rank of each key per file: position in (value asc, id asc) order
        r = np.empty_like(vmat, dtype=np.int64)
        for fi in range(len(per_file)):
            order = np.argsort(vmat[fi], kind="stable")  # ids ascending pre-sorted
            r[fi, order] = np.arange(len(ids))
        ranks[i] = r

    N_per_block = {i: len(common_ids[i]) for i in all_blocks}
    if not N_per_block:
        return {}
    K_targets = {i: max(0, min(N_per_block[i], rfun(prune_fraction * N_per_block[i])))
                 for i in all_blocks}
    K_common = min(K_targets.values()) if K_targets else 0

    if verbose:
        print(f"[consensus] blocks={len(all_blocks)}; "
              f"N_per_block[0]={N_per_block.get(all_blocks[0], 0) if all_blocks else 0}; "
              f"K_target_common={K_common}")

    if K_common <= 0:
        return arrays_to_leaf(
            {i: (common_ids[i], np.zeros(len(common_ids[i]), np.int64)) for i in all_blocks},
            as_int=True,
        )

    def intersection_for_t(t: float) -> Dict[int, np.ndarray]:
        """block -> bool membership over common_ids[i] (in all files' bottom-k)."""
        inter: Dict[int, np.ndarray] = {}
        for i in all_blocks:
            n = N_per_block[i]
            if n == 0:
                inter[i] = np.zeros(0, bool)
                continue
            k = max(0, min(n, rfun(t * n)))
            inter[i] = (ranks[i] < k).all(axis=0) if k > 0 else np.zeros(n, bool)
        return inter

    t = max(0.0, prune_fraction)
    inter = intersection_for_t(t)
    min_inter = min((int(m.sum()) for m in inter.values()), default=0)
    iters = 0
    while min_inter < K_common and t < 1.0 and iters < 100:
        t = min(1.0, t * 1.2 if t > 0 else 0.02)
        inter = intersection_for_t(t)
        min_inter = min((int(m.sum()) for m in inter.values()), default=0)
        iters += 1

    if verbose:
        print(f"[consensus] t_final={t:.4f}, min_intersection={min_inter}, "
              f"K_common={K_common}, iters={iters}")

    mask_blocks: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    for i in all_blocks:
        member = inter.get(i, np.zeros(0, bool))
        m = np.zeros(N_per_block[i], np.int64)
        n_members = int(member.sum())
        if n_members <= K_common:
            m[member] = 1
        else:
            # overshoot: exactly K_common smallest mean scores (tie: id asc)
            means = values[i].mean(axis=0)
            cand = np.nonzero(member)[0]
            order = cand[np.argsort(means[cand], kind="stable")]
            m[order[:K_common]] = 1
        mask_blocks[i] = (common_ids[i], m)
    return arrays_to_leaf(mask_blocks, as_int=True)
