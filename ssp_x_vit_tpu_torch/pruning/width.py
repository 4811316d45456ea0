"""Stage-1 FFN width pruning: importance, selection, materialization
(counterpart of ``ssp_x_vit_tpu/pruning/width.py``).

- importance of neuron j in block b = mean over calibration images of the L2
  norm over tokens of its intermediate activation, taken from the stats
  side-output of the forward (the ``fused_ffn_block`` kernel on the card);
- keep the top (d_int - n_prune) neurons by a stable descending argsort,
  respecting a ``min_remaining`` floor;
- materialize by gathering fc1 columns (+bias) and fc2 rows on the weights'
  device, zero-padding blocks to a common width so they stay stacked.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ssp_x_vit_tpu_torch.models.vit import Params, ViTConfig, cast_params, vit_forward
from ssp_x_vit_tpu_torch.parallel.collectives import all_reduce_sum


def compute_ffn_activation_importance(
    params: Params,
    cfg: ViTConfig,
    batches: Iterable[dict],
    *,
    batch_limit: Optional[int] = None,
    data_group=None,
    tp_group=None,
) -> np.ndarray:
    """Per-neuron importance [num_layers, d_int] fp32: mean over images of
    sqrt(sum over tokens of activation^2). Forwards run in fp32; the sums stay
    on the device and cross to the host once. ``data_group``: each rank holds
    its rows of every batch, and the sums and the image count are summed over
    the group; ``tp_group``: a tensor-parallel shard, whose statistics come
    back gathered to the full width."""
    params = cast_params(params, torch.float32)
    sums: Optional[torch.Tensor] = None
    count = 0
    for i, batch in enumerate(batches):
        if batch_limit is not None and i >= batch_limit:
            break
        px = batch["pixel_values"]
        _, aux = vit_forward(params, px, cfg, collect_ffn_stats=True, tp_group=tp_group)
        acc = aux["ffn_stats"].sqrt().sum(dim=1)  # [L, F]
        sums = acc if sums is None else sums + acc
        count += int(px.shape[0])
    if sums is None:
        return np.zeros((cfg.num_layers, cfg.intermediate_size), np.float32)
    if data_group is not None:
        all_reduce_sum(sums, data_group)
        count = int(all_reduce_sum(torch.tensor([count], device=sums.device), data_group))
    return (sums.cpu().numpy() / max(1, count)).astype(np.float32)


def weight_l1_importance(params: Params) -> np.ndarray:
    """Fallback importance: per-neuron L1 of the fc1 weights, [L, F]."""
    fc1 = params["blocks"]["fc1_kernel"].float().cpu().numpy()  # [L, d, F]
    return np.abs(fc1).sum(axis=1)


@dataclasses.dataclass
class WidthPruneResult:
    keep_indices: List[np.ndarray]       # per block, sorted ascending kept neuron ids
    pruned_indices: List[List[int]]      # per block, pruned neuron ids
    prune_masks: List[List[int]]         # per block, 0/1 list (1 = pruned), len d_int
    n_pruned_per_block: List[int]


def select_keep_indices(
    importance: np.ndarray,
    *,
    sparsity: Optional[float] = None,
    n_to_prune_per_block: Optional[Sequence[int]] = None,
    min_remaining: int = 256,
    verbose: bool = True,
) -> WidthPruneResult:
    """Choose kept neurons per block; ``importance`` is [num_layers, d_int].
    Provide ``sparsity`` or ``n_to_prune_per_block`` (the latter wins)."""
    L, F = importance.shape
    if n_to_prune_per_block is not None and len(n_to_prune_per_block) != L:
        raise ValueError("n_to_prune_per_block length must match number of blocks")
    if n_to_prune_per_block is None:
        if sparsity is None:
            raise ValueError("Provide either sparsity or n_to_prune_per_block")
        if not (0.0 <= sparsity < 1.0):
            raise AssertionError("sparsity must be in [0,1)")

    keep_indices, pruned_indices, prune_masks, n_pruned = [], [], [], []
    for b in range(L):
        n_channels = F
        n_prune = (int(n_to_prune_per_block[b]) if n_to_prune_per_block is not None
                   else int(n_channels * sparsity))
        if n_channels - n_prune < min_remaining:
            n_prune = max(0, n_channels - min_remaining)
        if verbose:
            print(f"[S1-LOG] block={b}, inter={n_channels}, n_prune={n_prune}, strategy=act_l2")
        if n_prune <= 0:
            keep = np.arange(n_channels)
        else:
            # descending argsort, keep top (n - n_prune), then ascending order
            order = np.argsort(-importance[b], kind="stable")
            keep = np.sort(order[: n_channels - n_prune])
        mask = np.ones((n_channels,), np.int16)
        mask[keep] = 0
        keep_indices.append(keep)
        pruned_indices.append(np.nonzero(mask == 1)[0].tolist())
        prune_masks.append(mask.tolist())
        n_pruned.append(int(n_prune) if n_prune > 0 else 0)
    return WidthPruneResult(keep_indices, pruned_indices, prune_masks, n_pruned)


def materialize_width_pruning(
    params: Params,
    cfg: ViTConfig,
    keep_indices: Sequence[np.ndarray],
) -> Tuple[Params, ViTConfig]:
    """Gather kept fc1 columns / fc2 rows into new stacked arrays on the
    weights' device; every block is zero-padded to the widest block's width
    rounded up to a multiple of 8 (zero fc1 column and bias give GELU(0) = 0,
    and the zero fc2 row adds nothing). Logical widths go to
    ``cfg.block_intermediate_sizes``."""
    L = cfg.num_layers
    if len(keep_indices) != L:
        raise ValueError("keep_indices length must match number of blocks")
    logical = tuple(int(len(k)) for k in keep_indices)
    # Physical width: the widest block rounded up to a multiple of 8, so the
    # bf16 GEMMs keep 16-byte rows (the JAX package pads to the widest block).
    fmax = -(-max(logical) // 8) * 8

    idx = np.zeros((L, fmax), np.int64)
    mask = np.zeros((L, fmax), np.float32)
    for b, keep in enumerate(keep_indices):
        k = len(keep)
        idx[b, :k] = np.asarray(keep)
        mask[b, :k] = 1.0

    blocks = params["blocks"]
    dev = blocks["fc1_kernel"].device
    idx_t = torch.from_numpy(idx).to(dev)
    mask_t = torch.from_numpy(mask).to(dev)
    fc1_k, fc2_k = blocks["fc1_kernel"], blocks["fc2_kernel"]
    d = fc1_k.shape[1]

    new_blocks = dict(blocks)
    new_blocks["fc1_kernel"] = (torch.gather(fc1_k, 2, idx_t[:, None, :].expand(L, d, fmax))
                                * mask_t[:, None, :].to(fc1_k.dtype)).contiguous()
    if blocks.get("fc1_bias") is not None:
        fc1_b = blocks["fc1_bias"]
        new_blocks["fc1_bias"] = (torch.gather(fc1_b, 1, idx_t) * mask_t.to(fc1_b.dtype)).contiguous()
    new_blocks["fc2_kernel"] = (torch.gather(fc2_k, 1, idx_t[:, :, None].expand(L, fmax, d))
                                * mask_t[:, :, None].to(fc2_k.dtype)).contiguous()

    new_params = dict(params)
    new_params["blocks"] = new_blocks
    return new_params, dataclasses.replace(cfg, block_intermediate_sizes=logical)
