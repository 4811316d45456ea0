"""Top-1 accuracy evaluation for ViT classifiers (counterpart of
``ssp_x_vit_tpu/evaluation/classify.py``).

- :func:`evaluate_top1` — accuracy of one model (dense/masked or materialized).
- :func:`evaluate_top1_candidates` — accuracy of C skip-gate candidates over
  the same batches, with no copy of the model: each candidate is the same
  forward with a different gate row. The gate rows live on the device and
  the block kernels read them there, and the correct counts accumulate on the
  device, so nothing syncs with the host until the end. The block kernels run
  here too: the JAX package turned them off in its ``vmap`` over candidates
  only because a vmapped SMEM scalar was slow on the TPU.

Batches are dicts with "pixel_values" [b, H, W, C] float and "labels" [b] int.

Data parallelism (``data_group``): each rank evaluates its own rows of every
batch (``parallel.mesh.shard_batch``) and the correct and total counts are
summed over the group once at the end, so every rank returns the same
accuracy. ``tp_group``: a tensor-parallel shard (``parallel/vit_sharding.py``)
of a dense model, evaluated with the block kernels at the rank's width.
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np
import torch

from ssp_x_vit_tpu_torch.models.token_pruning import vit_forward_token_pruned
from ssp_x_vit_tpu_torch.models.vit import (
    ViTConfig, cast_params, params_device, vit_forward, vit_forward_materialized,
)
from ssp_x_vit_tpu_torch.parallel.collectives import all_reduce_sum


def _eval_dtype(device: torch.device) -> torch.dtype:
    """bf16 on the card (the JAX package's accelerator choice, and the
    reference's autocast), fp32 on the CPU for test determinism."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32


@torch.inference_mode()
def evaluate_top1(
    params,
    cfg: ViTConfig,
    batches: Iterable[dict],
    *,
    max_batches: Optional[int] = None,
    token_keep_schedule: tuple = (),
    data_group=None,
    tp_group=None,
) -> float:
    """Top-1 accuracy over (up to max_batches of) a batch iterator.

    ``token_keep_schedule``: optional EViT-style static token-pruning schedule
    (``models/token_pruning.py``), ((layer, kept_seq_len), ...), for the
    token-pruned accuracy. ``data_group`` / ``tp_group``: see the module
    docstring (tensor parallelism takes dense, unpruned trees)."""
    sched = tuple(tuple(p) for p in token_keep_schedule)
    if tp_group is not None and (sched or cfg.pruned_attention_blocks):
        raise ValueError("tensor-parallel evaluation takes the dense forward only")
    dtype = _eval_dtype(params_device(params))
    params = cast_params(params, dtype)
    correct = None
    total = 0
    for i, batch in enumerate(batches):
        if max_batches is not None and i >= max_batches:
            break
        px, labels = batch["pixel_values"], batch["labels"]
        if sched:
            logits = vit_forward_token_pruned(params, px, cfg, sched, compute_dtype=dtype)
        elif cfg.pruned_attention_blocks:
            logits = vit_forward_materialized(params, px, cfg, compute_dtype=dtype)
        else:
            logits, _ = vit_forward(params, px, cfg, compute_dtype=dtype, tp_group=tp_group)
        hits = (logits.argmax(dim=-1) == labels).sum()
        correct = hits if correct is None else correct + hits
        total += int(labels.shape[0])
    if data_group is not None:
        counts = torch.tensor([0 if correct is None else int(correct), total], dtype=torch.int64,
                              device=params_device(params))
        correct, total = all_reduce_sum(counts, data_group).tolist()
    return (0 if correct is None else int(correct)) / max(1, total)


@torch.inference_mode()
def evaluate_top1_candidates(
    params,
    cfg: ViTConfig,
    batches: Iterable[dict],
    attn_gates: np.ndarray,
    *,
    neuron_mask: Optional[torch.Tensor] = None,
    max_batches: Optional[int] = None,
    data_group=None,
    tp_group=None,
) -> np.ndarray:
    """Accuracy of each row of ``attn_gates`` ([C, num_layers]) -> [C]
    (``data_group`` / ``tp_group``: see the module docstring)."""
    device = params_device(params)
    dtype = _eval_dtype(device)
    params = cast_params(params, dtype)
    gates = torch.as_tensor(np.asarray(attn_gates, np.float32)).to(device)
    correct = torch.zeros(gates.shape[0], dtype=torch.int64, device=device)
    total = 0
    for i, batch in enumerate(batches):
        if max_batches is not None and i >= max_batches:
            break
        px, labels = batch["pixel_values"], batch["labels"]
        for c in range(gates.shape[0]):
            logits, _ = vit_forward(params, px, cfg, attn_gate=gates[c],
                                    neuron_mask=neuron_mask, compute_dtype=dtype,
                                    tp_group=tp_group)
            correct[c] += (logits.argmax(dim=-1) == labels).sum()
        total += int(labels.shape[0])
    if data_group is not None:
        summed = all_reduce_sum(torch.cat([correct, correct.new_tensor([total])]), data_group)
        correct, total = summed[:-1], int(summed[-1])
    return correct.cpu().numpy() / max(1, total)
