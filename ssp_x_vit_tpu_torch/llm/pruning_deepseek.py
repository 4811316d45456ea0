"""Pruning surgery for the DeepSeek/MLA family (counterpart of
``ssp_x_vit_tpu/llm/pruning_deepseek.py``): the MLA analogues of the
llama-family materializations in ``llm/pruning.py``.

- 2SSP stage 1 (FFN neuron width) applies to the dense GLU MLPs, i.e. every
  layer of an ``n_routed_experts == 0`` config.
- 2SSP stage 2, blockpruner, window_based, shortGPT and EvoPress work on
  per-block gates and block outputs, which the MLA forward takes as the llama
  one does.

Removing an MLA attention submodule drops ln1, the query path (``q`` or
``q_a`` / ``q_a_norm`` / ``q_b``), ``kv_a`` (and its norm), ``kv_b`` and ``o``.
Every gather runs on the parameters' device.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from ssp_x_vit_tpu_torch.llm.deepseek import DeepseekConfig, Params

_ATTN_KEYS = ("ln1", "q_kernel", "q_a_kernel", "q_a_norm", "q_b_kernel",
              "kv_a_kernel", "kv_a_norm", "kv_b_kernel", "o_kernel")
_VARIANT_SUFFIXES = ("", "_q", "_q4", "_scale")


def count_main_params_deepseek(cfg: DeepseekConfig) -> Tuple[int, int, int]:
    """(main_layers_total, attn_per_block, mlp_per_block) of a dense config,
    the 2SSP budget arithmetic; attention counts the whole MLA factorization
    with its inner RMSNorms."""
    if cfg.n_routed_experts:
        raise ValueError("2SSP accounting targets dense-GLU configs; MoE "
                         "blocks have no single FFN width to prune")
    d, nq = cfg.hidden_size, cfg.num_heads
    kvr, rd = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    if cfg.q_lora_rank is None:
        q = d * nq * cfg.qk_head_dim
    else:
        q = d * cfg.q_lora_rank + cfg.q_lora_rank + cfg.q_lora_rank * nq * cfg.qk_head_dim
    attn = (q + d * (kvr + rd) + kvr
            + kvr * nq * (cfg.qk_nope_head_dim + cfg.v_head_dim)
            + nq * cfg.v_head_dim * d)
    mlp = 3 * d * cfg.effective_intermediate
    per_block_other = 2 * d  # ln1 + ln2
    main = cfg.num_layers * (attn + mlp + per_block_other)
    main -= len(cfg.pruned_attention_blocks) * attn
    return main, attn, mlp


def materialize_deepseek_width_pruning(
    params: Params, cfg: DeepseekConfig, keep_indices: Sequence[np.ndarray]
) -> Tuple[Params, DeepseekConfig]:
    """Slice gate/up columns and down rows to the kept FFN neurons of each
    block (2SSP stage 1). Dense-GLU configs only; a uniform keep count."""
    if cfg.n_moe_layers:
        raise ValueError("stage-1 width pruning targets dense GLU MLPs; "
                         "this config has MoE layers")
    keeps = [np.asarray(k) for k in keep_indices]
    n_keep = len(keeps[0])
    if any(len(k) != n_keep for k in keeps):
        raise ValueError("2SSP stage-1 keeps a uniform width")
    blocks = dict(params["dense_blocks"])
    idx = torch.from_numpy(np.stack(keeps).astype(np.int64)).to(params["embed"].device)
    blocks["gate_kernel"] = torch.stack([w.index_select(1, i) for w, i in
                                         zip(blocks["gate_kernel"], idx)])
    blocks["up_kernel"] = torch.stack([w.index_select(1, i) for w, i in
                                       zip(blocks["up_kernel"], idx)])
    blocks["down_kernel"] = torch.stack([w.index_select(0, i) for w, i in
                                         zip(blocks["down_kernel"], idx)])
    new_params = dict(params)
    new_params["dense_blocks"] = blocks
    return new_params, dataclasses.replace(cfg, pruned_intermediate_size=n_keep)


def _take_layers(blocks: dict, keys: Sequence[str], keep_local) -> dict:
    out = dict(blocks)
    idx = torch.tensor(list(keep_local), dtype=torch.int64,
                       device=next(iter(blocks.values())).device)
    for base in keys:
        for suf in _VARIANT_SUFFIXES:
            k = base + suf
            if k in out:
                out[k] = out[k].index_select(0, idx)
    return out


def materialize_deepseek_attention_pruning(
    params: Params, cfg: DeepseekConfig, blocks_to_prune: Sequence[int]
) -> Tuple[Params, DeepseekConfig]:
    """Drop the pruned blocks' MLA attention weights, each group's stacks
    compacted on their own; the result runs through
    ``deepseek_forward_materialized`` and ``deepseek_generate``."""
    pruned = tuple(sorted(set(int(i) for i in blocks_to_prune)))
    if not pruned:
        return params, cfg
    if cfg.pruned_attention_blocks:
        raise ValueError("attention pruning already materialized")
    if max(pruned) >= cfg.num_layers or min(pruned) < 0:
        raise ValueError(f"block index out of range in {pruned}")
    nk = cfg.n_dense_layers
    new_params = dict(params)
    if "dense_blocks" in params:
        keep = [i for i in range(nk) if i not in pruned]
        new_params["dense_blocks"] = _take_layers(params["dense_blocks"], _ATTN_KEYS, keep)
    if "moe_blocks" in params:
        keep = [i - nk for i in range(nk, cfg.num_layers) if i not in pruned]
        new_params["moe_blocks"] = _take_layers(params["moe_blocks"], _ATTN_KEYS, keep)
    return new_params, dataclasses.replace(cfg, pruned_attention_blocks=pruned)


def materialize_deepseek_block_removal(
    params: Params, cfg: DeepseekConfig, blocks_to_remove: Sequence[int]
) -> Tuple[Params, DeepseekConfig]:
    """Drop entire blocks (attention + MLP), the depth baselines' deployment
    artifact. Surviving dense-prefix layers stay the dense prefix
    (``first_k_dense_replace`` shrinks to their count)."""
    removed = tuple(sorted(set(int(i) for i in blocks_to_remove)))
    if not removed:
        return params, cfg
    if cfg.pruned_attention_blocks:
        raise ValueError("materialize block removal BEFORE attention-only "
                         "materialization (stacks are uniform only while "
                         "every block still has attention)")
    if max(removed) >= cfg.num_layers or min(removed) < 0:
        raise ValueError(f"block index out of range in {removed}")
    if len(removed) == cfg.num_layers:
        raise ValueError("cannot remove every block")
    nk = cfg.n_dense_layers
    new_params = dict(params)

    def compact(group_key, local_keep):
        if not local_keep:
            new_params.pop(group_key, None)
            return
        blocks = params[group_key]
        idx = torch.tensor(local_keep, dtype=torch.int64, device=params["embed"].device)
        new_params[group_key] = {k: v.index_select(0, idx) for k, v in blocks.items()}

    dense_keep = [i for i in range(nk) if i not in removed]
    moe_keep = [i - nk for i in range(nk, cfg.num_layers) if i not in removed]
    if "dense_blocks" in params:
        compact("dense_blocks", dense_keep)
    if "moe_blocks" in params:
        compact("moe_blocks", moe_keep)

    new_cfg = dataclasses.replace(
        cfg, num_layers=len(dense_keep) + len(moe_keep),
        first_k_dense_replace=len(dense_keep) if cfg.n_routed_experts else 0)
    return new_params, new_cfg
