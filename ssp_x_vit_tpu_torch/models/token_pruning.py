"""Token pruning for ViT inference, EViT style (counterpart of
``ssp_x_vit_tpu/models/token_pruning.py``).

Before each layer of a static keep schedule, patch tokens are ranked by the
attention the [CLS] query of that layer would pay them (its own q/k projection
on the layer-normed input), the top ones kept, and the rest merged into one
fusion token weighted by their renormalized scores. Every block still runs
through ``models.vit._block_apply``, so on the card the block kernels (row 1,
or row 2 for an odd head count, and row 3) carry the shortened sequences, and
width-materialized and int8 trees work as in :func:`vit_forward`.

Ties: ``jax.lax.top_k`` keeps the lower index among equal scores, and
``torch.topk`` on the card promises no order. The kept set comes from a
stable descending sort, which keeps the lower index first, as ``top_k`` does.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from ssp_x_vit_tpu_torch.models.vit import (
    Params, ViTConfig, _block_apply, _unbind_blocks, apply_head, cast_params, embed,
)
from ssp_x_vit_tpu_torch.ops.common import layer_norm


def cls_attention_scores(x: torch.Tensor, bp: Params, cfg: ViTConfig) -> torch.Tensor:
    """[b, s, d] -> [b, s] fp32: mean over heads of the CLS query's attention
    row under ``bp``'s qkv projection (one q row and the keys; no [s, s] logits)."""
    h = layer_norm(x, bp["ln1_scale"], bp["ln1_bias"], cfg.layernorm_eps)
    d = cfg.hidden_size
    if "qkv_kernel" in bp:
        qkv_k = bp["qkv_kernel"].to(x.dtype)
    else:  # int8 tree (models/quant.py): dequantize the q/k halves for this side product
        qkv_k = bp["qkv_kernel_q"].to(x.dtype) * bp["qkv_kernel_scale"].to(x.dtype)[None, :]
    q_cls = h[:, 0] @ qkv_k[:, :d]               # [b, d]
    k = h @ qkv_k[:, d:2 * d]                    # [b, s, d]
    if bp.get("qkv_bias") is not None:
        qkv_b = bp["qkv_bias"].to(x.dtype)
        q_cls = q_cls + qkv_b[:d]
        k = k + qkv_b[d:2 * d]
    nh, hd = cfg.num_heads, cfg.head_dim
    b, s, _ = k.shape
    logits = torch.einsum("bhd,bshd->bhs", q_cls.reshape(b, nh, hd),
                          k.reshape(b, s, nh, hd)) / (hd ** 0.5)
    return torch.softmax(logits.float(), dim=-1).mean(dim=1)


def top_k_indices(scores: torch.Tensor, k: int) -> torch.Tensor:
    """[b, n] -> [b, k] int64: the k largest per row, largest first, the lower
    index first among equal scores (``jax.lax.top_k``'s order)."""
    return torch.sort(scores, dim=1, descending=True, stable=True).indices[:, :k]


def prune_tokens(x: torch.Tensor, scores: torch.Tensor, keep: int) -> torch.Tensor:
    """[b, s, d] -> [b, keep, d]: [CLS] + the top-(keep-2) patch tokens by
    score + ONE fusion token merging the pruned tokens (score-weighted mean)."""
    b, s, d = x.shape
    if not 2 <= keep < s:
        raise ValueError(f"keep={keep} must be in [2, {s - 1}]")
    patch_scores = scores[:, 1:]                                  # [b, s-1]
    patches = x[:, 1:]
    top = top_k_indices(patch_scores, keep - 2)                   # [b, keep-2]
    kept = torch.gather(patches, 1, top[:, :, None].expand(b, keep - 2, d))

    # fusion token over the complement, weighted by renormalized scores
    mask = torch.ones((b, s - 1), dtype=x.dtype, device=x.device).scatter_(1, top, 0.0)
    w = patch_scores.to(x.dtype) * mask
    w = w / (w.sum(dim=1, keepdim=True) + 1e-9)
    fused = torch.einsum("bs,bsd->bd", w, patches)[:, None]       # [b, 1, d]
    return torch.cat([x[:, :1], kept, fused], dim=1)


def vit_forward_token_pruned(
    params: Params,
    pixel_values: torch.Tensor,
    cfg: ViTConfig,
    keep_schedule: Sequence[Tuple[int, int]] = (),
    *,
    compute_dtype=torch.float32,
    allow_fused_attn: bool = True,
) -> torch.Tensor:
    """ViT forward with static token pruning: before each layer listed in
    ``keep_schedule`` (pairs of (layer index, kept sequence length)) the tokens
    are ranked by that layer's CLS-attention row and pruned to the given
    length. An empty schedule gives ``vit_forward``'s logits. Depth-materialized
    configs raise, as in the JAX package."""
    if cfg.pruned_attention_blocks:
        raise ValueError("token pruning + depth-materialized configs: prune "
                         "tokens on the gate-parameterized model instead")
    sched: Dict[int, int] = dict(keep_schedule)
    if len(sched) != len(tuple(keep_schedule)):
        raise ValueError(f"duplicate layer indices in keep_schedule "
                         f"{tuple(keep_schedule)}")
    params = cast_params(params, compute_dtype)
    x = embed(params, cfg, pixel_values, compute_dtype)
    blocks = _unbind_blocks(params["blocks"])
    for i in range(cfg.num_layers):
        bp = {k: v[i] for k, v in blocks.items()}
        if i in sched:
            x = prune_tokens(x, cls_attention_scores(x, bp, cfg), sched[i])
        x, _ = _block_apply(x, bp, cfg, attn_gate=None, mlp_gate=None, neuron_mask=None,
                            collect_ffn_stats=False, allow_fused_attn=allow_fused_attn)
    x = layer_norm(x, params["ln_final_scale"], params["ln_final_bias"], cfg.layernorm_eps)
    return apply_head(params["head"], cfg, x[:, 0])
