"""Stage-2 attention depth pruning: importance, selection, materialization
(counterpart of ``ssp_x_vit_tpu/pruning/depth.py``).

- importance: the position heuristic ``i if i < B/2 else B - i`` (lowest
  pruned first), or "copy" mode — the top-1 drop from bypassing each block's
  attention; the K blocks with the smallest importance are pruned;
- pruning replaces attention with a zero bypass (the residual passes through);
- at least one block keeps its attention (num_to_prune <= B-1).

"Copy" mode makes no copies: the L+1 gate rows (baseline, then one skipped
block each) are one device tensor, and each candidate is the same forward
reading its row (evaluation.evaluate_top1_candidates).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ssp_x_vit_tpu_torch.evaluation.classify import evaluate_top1_candidates
from ssp_x_vit_tpu_torch.models.vit import Params, ViTConfig


def heuristic_attention_importance(num_layers: int) -> np.ndarray:
    """Position heuristic: centre blocks most important, edges least."""
    return np.asarray(
        [(i if i < num_layers / 2 else num_layers - i) for i in range(num_layers)],
        np.float32,
    )


def copy_replace_attention_importance(
    params: Params,
    cfg: ViTConfig,
    batches,
    *,
    batch_limit: int = 5,
    neuron_mask=None,
    verbose: bool = True,
    data_group=None,
    tp_group=None,
) -> Tuple[np.ndarray, float]:
    """Impact of bypassing each block's attention, measured as top-1 drop.

    Returns (impacts [num_layers], baseline_accuracy). ``batches`` must be
    re-iterable (a list): the baseline and all candidates share them.
    ``data_group``: each rank holds its rows of the batches; the candidates'
    counts are summed over the group, so every rank ranks the same scores;
    ``tp_group``: ``params`` is a tensor-parallel shard (``vit_sharding``).
    """
    L = cfg.num_layers
    batches = list(batches)[: batch_limit if batch_limit is not None else None]
    # Row 0 = baseline (no skip), rows 1..L = skip block i-1.
    gates = np.ones((L + 1, L), np.float32)
    for i in range(L):
        gates[i + 1, i] = 0.0
    accs = evaluate_top1_candidates(params, cfg, batches, gates, neuron_mask=neuron_mask,
                                    max_batches=batch_limit, data_group=data_group,
                                    tp_group=tp_group)
    baseline = float(accs[0])
    impacts = np.maximum(0.0, baseline - accs[1:]).astype(np.float32)
    if verbose:
        print(f"Baseline accuracy: {baseline:.4f}")
        for i in range(L):
            print(f"[Attn] Block {i} impact: {impacts[i]:.4f}", flush=True)
    return impacts, baseline


def select_attention_blocks_to_prune(importance: np.ndarray, num_to_prune: int) -> List[int]:
    """K blocks with the smallest importance, capped at B-1."""
    L = len(importance)
    num_to_prune = max(0, min(L - 1, int(num_to_prune)))
    order = sorted(range(L), key=lambda i: importance[i])
    return sorted(order[:num_to_prune])


def materialize_depth_pruning(
    params: Params,
    cfg: ViTConfig,
    blocks_to_prune: Sequence[int],
) -> Tuple[Params, ViTConfig]:
    """Drop the attention weights (and ln1) of the pruned blocks from the
    stacked arrays; ``cfg.pruned_attention_blocks`` records the removal and
    ``vit_forward_materialized`` skips those branches. ln1 still counts in the
    logical parameter total, as the reference bypass keeps it."""
    pruned = tuple(sorted(set(int(i) for i in blocks_to_prune)))
    for i in pruned:
        if not (0 <= i < cfg.num_layers):
            raise ValueError(f"block index {i} out of range")
    if len(pruned) >= cfg.num_layers:
        raise ValueError("cannot prune attention in every block")
    if cfg.pruned_attention_blocks:
        raise ValueError("depth pruning already materialized for this config")

    blocks = dict(params["blocks"])
    keep = torch.tensor([i for i in range(cfg.num_layers) if i not in pruned],
                        dtype=torch.int64, device=blocks["qkv_kernel"].device)
    for name in ("qkv_kernel", "qkv_bias", "proj_kernel", "proj_bias", "ln1_scale", "ln1_bias"):
        if name in blocks:
            blocks[name] = blocks[name].index_select(0, keep)

    new_params = dict(params)
    new_params["blocks"] = blocks
    return new_params, dataclasses.replace(cfg, pruned_attention_blocks=pruned)
