"""Whole-sequence logits for any served config (counterpart of ``full_logits``
in ``ssp_x_vit_tpu/llm/generate.py``). The generation loops of that module
come with the contiguous-KV serving slice (ROADMAP.md A.9)."""

from __future__ import annotations

import torch

from ssp_x_vit_tpu_torch.llm.model import (
    llama_forward, llama_forward_materialized, require_llama_config,
)


def full_logits(params, tokens: torch.Tensor, cfg, compute_dtype, *,
                remat: bool = False) -> torch.Tensor:
    """[b, s] -> [b, s, V] fp32 logits, picking the gated or the materialized
    forward from the config. ``remat=True`` checkpoints each layer (training
    under autograd); the materialized (pruned) forward ignores it, as in the
    JAX package. DeepSeek/MLA configs raise (ROADMAP.md A.11)."""
    require_llama_config(cfg)
    if cfg.pruned_attention_blocks:
        return llama_forward_materialized(params, tokens, cfg, compute_dtype=compute_dtype)
    logits, _ = llama_forward(params, tokens, cfg, compute_dtype=compute_dtype, remat=remat)
    return logits
