"""Functional PyTorch Vision Transformer with pruning-native forward passes
(counterpart of ``ssp_x_vit_tpu/models/vit.py``).

- Parameters are a nested dict in the JAX layout: encoder blocks stacked on a
  leading ``[num_layers, ...]`` axis, fused QKV ``[d, 3d]``, ``[in, out]``
  kernels. The same ``.npz`` loads into both packages.
- Search-phase pruning is runtime arguments of :func:`vit_forward`
  (``attn_gate``, ``mlp_gate``, ``neuron_mask``): any skip pattern or neuron
  subset runs the same code with no copies of the model. The gates stay on the
  device and the block kernels read them there.
- Final pruned models are materialized once (gathered FFN widths, attention
  weights of depth-pruned blocks dropped) and run by
  :func:`vit_forward_materialized`, which skips those attention branches.
- A Python loop over the blocks replaces ``lax.scan``; the stacked tensors
  are unbound once per forward, so under autograd each stacked leaf gets one
  stacked gradient. Every block runs the ``fused_attn_block_v2`` (even head
  count) or ``fused_attn_block`` kernel and the ``fused_ffn_block`` kernel on
  a CUDA tensor, their plain versions on a CPU tensor.
  ``allow_fused_attn=False`` turns both fused blocks off, as in the JAX
  package: the attention branch runs the block's plain version (plain
  ``sdpa_reference``, no kernel) and the FFN goes through
  ``ops.ffn.ffn_forward`` (the ``fused_ffn`` kernel on the card, inside its
  autograd Function when a gradient is wanted); both differentiate on any
  device (the fused attention kernels have no backward). This is the path of
  the finetune steps (``pruning/finetune.py``).
- Tensor parallelism (``tp_group``, shards from
  ``parallel/vit_sharding.py``): each rank holds whole heads of the fused QKV
  and the projection's matching rows, and a slice of the FFN's columns. Its
  block kernels run at its own head count and width with ``residual=False``
  on every rank but the group's first, which adds the residual and the
  biases; one all-reduce sums each branch, and the FFN statistics of the
  ranks' columns are gathered back in column order.
- Weight-only int8 trees (``models/quant.py``: ``<k>_q`` + ``<k>_scale``)
  run every projection through ``ops.common.mm_quant``, the block as plain
  PyTorch (:func:`_block_apply_quantized`), as the JAX package does.

Model semantics match HF ``ViTForImageClassification``: patch embedding as
patchify + matmul, CLS token, learned position embeddings, pre-LN blocks with
exact GELU, final LayerNorm, classifier on the CLS token: a linear head, or
the adapter head ``Linear(d -> m, no bias) -> GELU -> Linear(m -> c)``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ssp_x_vit_tpu_torch.device import DeviceLike, resolve_device
from ssp_x_vit_tpu_torch.ops import dispatch
from ssp_x_vit_tpu_torch.ops.attention import sdpa_reference
from ssp_x_vit_tpu_torch.ops.common import gelu, layer_norm, mm_quant, patchify, pick_param_variants
from ssp_x_vit_tpu_torch.ops.ffn import ffn_forward
from ssp_x_vit_tpu_torch.ops.kernels.fused_attn_block import (
    fused_attn_block, fused_attn_block_plain, fused_attn_block_v2,
)
from ssp_x_vit_tpu_torch.ops.kernels.fused_ffn import fused_ffn_block
from ssp_x_vit_tpu_torch.parallel.collectives import all_reduce_sum, gather_along

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """Static model configuration (same fields as the JAX package's)."""

    image_size: int = 224
    patch_size: int = 16
    num_channels: int = 3
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    num_classes: int = 10
    layernorm_eps: float = 1e-12
    head_type: str = "linear"
    adapter_bottleneck: int = 0
    # Logical kept FFN width per block after stage-1; None = dense. Physical
    # arrays are zero-padded to max(block_intermediate_sizes) rounded up to a
    # multiple of 8 (pruning/width.py).
    block_intermediate_sizes: Optional[Tuple[int, ...]] = None
    # Blocks whose attention was removed in stage 2 (weights absent).
    pruned_attention_blocks: Tuple[int, ...] = ()

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        return self.num_patches + 1  # + CLS

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def padded_intermediate_size(self) -> int:
        if self.block_intermediate_sizes is None:
            return self.intermediate_size
        return -(-max(self.block_intermediate_sizes) // 8) * 8

    def logical_block_intermediate(self, i: int) -> int:
        if self.block_intermediate_sizes is None:
            return self.intermediate_size
        return self.block_intermediate_sizes[i]

    @property
    def attn_store_index(self) -> Tuple[Optional[int], ...]:
        """Block index -> row in the stacked attention arrays (None = removed)."""
        idx, j = [], 0
        for i in range(self.num_layers):
            if i in self.pruned_attention_blocks:
                idx.append(None)
            else:
                idx.append(j)
                j += 1
        return tuple(idx)

    @property
    def is_materialized_pruned(self) -> bool:
        return bool(self.pruned_attention_blocks) or self.block_intermediate_sizes is not None


def _trunc_normal(gen: torch.Generator, shape, device, std=0.02) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(t, mean=0.0, std=1.0, a=-2.0, b=2.0, generator=gen)
    return (t * std).to(device)


def init_vit_params(cfg: ViTConfig, *, seed: int = 0, device: DeviceLike = None,
                    dtype=torch.float32) -> Params:
    """Dense ViT parameters: truncated normal (std 0.02, cut at 2 std), zero biases.

    Drawn from a ``torch.Generator`` seeded with ``seed`` on the CPU, then
    moved to ``device`` (``cuda`` by default). The numbers differ from
    ``jax.random``'s; tests carry JAX weights across with ``params_from_jax``.
    """
    if cfg.is_materialized_pruned:
        raise ValueError("init_vit_params expects a dense (unpruned) config")
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    d, f, n = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    patch_dim = cfg.num_channels * cfg.patch_size ** 2

    def tn(*shape):
        return _trunc_normal(gen, shape, dev).to(dtype)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=dev)

    params: Params = {
        "patch_embed": {"kernel": tn(patch_dim, d), "bias": zeros(d)},
        "cls_token": tn(1, 1, d),
        "pos_embed": tn(1, cfg.seq_len, d),
        "blocks": {
            "ln1_scale": ones(n, d), "ln1_bias": zeros(n, d),
            "qkv_kernel": tn(n, d, 3 * d), "qkv_bias": zeros(n, 3 * d),
            "proj_kernel": tn(n, d, d), "proj_bias": zeros(n, d),
            "ln2_scale": ones(n, d), "ln2_bias": zeros(n, d),
            "fc1_kernel": tn(n, d, f), "fc1_bias": zeros(n, f),
            "fc2_kernel": tn(n, f, d), "fc2_bias": zeros(n, d),
        },
        "ln_final_scale": ones(d),
        "ln_final_bias": zeros(d),
    }
    params["head"] = init_head_params(cfg, gen=gen, device=dev, dtype=dtype)
    return params


def init_head_params(cfg: ViTConfig, *, gen: Optional[torch.Generator] = None, seed: int = 0,
                     device: DeviceLike = None, dtype=torch.float32) -> Params:
    """Classifier head: linear ``{"kernel": [d, c], "bias": [c]}``, or the adapter
    ``{"w0": [d, m], "w2": [m, c], "b2": [c]}`` (``Linear(d -> m, no bias) ->
    GELU -> Linear(m -> c)``, m = ``cfg.adapter_bottleneck``); truncated
    normal (std 0.02) kernels and zero biases from ``gen`` (or ``seed``)."""
    dev = resolve_device(device)
    gen = gen if gen is not None else torch.Generator().manual_seed(seed)
    d, c = cfg.hidden_size, cfg.num_classes
    if cfg.head_type == "linear":
        return {"kernel": _trunc_normal(gen, (d, c), dev).to(dtype),
                "bias": torch.zeros(c, dtype=dtype, device=dev)}
    if cfg.head_type == "adapter":
        m = cfg.adapter_bottleneck
        if m <= 0:
            raise ValueError("adapter head requires adapter_bottleneck > 0")
        return {"w0": _trunc_normal(gen, (d, m), dev).to(dtype),
                "w2": _trunc_normal(gen, (m, c), dev).to(dtype),
                "b2": torch.zeros(c, dtype=dtype, device=dev)}
    raise ValueError(f"unknown head_type {cfg.head_type}")


def params_device(params: Params) -> torch.device:
    """The device of a ViT tree (dense, pruned or quantized)."""
    return params["pos_embed"].device


def cast_params(params: Params, dtype: torch.dtype) -> Params:
    """Every floating leaf cast to ``dtype`` (leaves already in it are shared;
    int8 codes stay, their fp32 scales are cast as ``mm_quant`` casts them in
    the JAX package). Differentiable, so a loss in bf16 reaches fp32 masters.

    Callers that run many forwards cast once per model and pass the result,
    so the kernels never cast weights per launch."""
    out: Params = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out[k] = cast_params(v, dtype)
        elif isinstance(v, torch.Tensor) and v.is_floating_point():
            out[k] = v.to(dtype)
        else:
            out[k] = v
    return out


def apply_head(head: Params, cfg: ViTConfig, cls_repr: torch.Tensor) -> torch.Tensor:
    dt = cls_repr.dtype
    if cfg.head_type == "linear":
        return mm_quant(cls_repr, head, "kernel", dt) + head["bias"].to(dt)
    h = gelu(mm_quant(cls_repr, head, "w0", dt))
    return mm_quant(h, head, "w2", dt) + head["b2"].to(dt)


def embed(params: Params, cfg: ViTConfig, pixel_values: torch.Tensor, dtype) -> torch.Tensor:
    """pixel_values [batch, H, W, C] -> embedded tokens [batch, seq, hidden]."""
    x = patchify(pixel_values.to(dtype), cfg.patch_size)
    x = mm_quant(x, params["patch_embed"], "kernel", dtype) + \
        params["patch_embed"]["bias"].to(dtype)
    cls = params["cls_token"].to(dtype).expand(x.shape[0], 1, cfg.hidden_size)
    x = torch.cat([cls, x], dim=1)
    return (x + params["pos_embed"].to(dtype)).contiguous()


def _block_apply_quantized(x, bp, cfg: ViTConfig, *, attn_gate, mlp_gate, neuron_mask,
                           collect_ffn_stats, skip_attention_statically=False):
    """int8-weight block (``models/quant.py`` trees): the plain block with every
    projection through ``mm_quant``, as the JAX package's
    ``_block_apply_quantized``; no kernel of this package (the block kernels
    take float weights)."""
    dt = x.dtype
    eps = cfg.layernorm_eps
    if not skip_attention_statically:
        h = layer_norm(x, bp["ln1_scale"], bp["ln1_bias"], eps)
        qkv = mm_quant(h, bp, "qkv_kernel", dt)
        if bp.get("qkv_bias") is not None:
            qkv = qkv + bp["qkv_bias"].to(dt)
        b, s, d = x.shape
        q, k, v = (t.reshape(b, s, cfg.num_heads, -1).permute(0, 2, 1, 3)
                   for t in qkv.split(d, dim=-1))
        attn = sdpa_reference(q, k, v).permute(0, 2, 1, 3).reshape(b, s, d)
        attn = mm_quant(attn, bp, "proj_kernel", dt)
        if bp.get("proj_bias") is not None:
            attn = attn + bp["proj_bias"].to(dt)
        x = x + dispatch.apply_gate(attn, attn_gate)

    hm = mm_quant(layer_norm(x, bp["ln2_scale"], bp["ln2_bias"], eps), bp, "fc1_kernel", dt)
    if bp.get("fc1_bias") is not None:
        hm = hm + bp["fc1_bias"].to(dt)
    hm = gelu(hm)
    stats = hm.float().square().sum(dim=1) if collect_ffn_stats else None
    if neuron_mask is not None:
        hm = hm * neuron_mask.to(dt)
    mlp = mm_quant(hm, bp, "fc2_kernel", dt)
    if bp.get("fc2_bias") is not None:
        mlp = mlp + bp["fc2_bias"].to(dt)
    return x + dispatch.apply_gate(mlp, mlp_gate), stats


def _block_apply(
    x: torch.Tensor,
    bp: Params,
    cfg: ViTConfig,
    *,
    attn_gate: Optional[torch.Tensor],
    mlp_gate: Optional[torch.Tensor],
    neuron_mask: Optional[torch.Tensor],
    collect_ffn_stats: bool,
    skip_attention_statically: bool = False,
    allow_fused_attn: bool = True,
    group=None,
):
    """One pre-LN encoder block; gates are scalars (None = dense).
    ``allow_fused_attn=False``: both branches without the fused block kernels.
    ``group``: a tensor-parallel rank's block (see the module docstring): the
    head count comes from the shard's weights, the first rank alone adds the
    residual and the biases, and each branch's row-parallel partial is
    all-reduced over the group, so the residual stream stays the same on
    every rank (None: one process, no collective)."""
    if "fc1_kernel" not in bp:  # quantized tree (models/quant.py)
        if group is not None:
            raise ValueError("tensor-parallel ViT blocks take float weights, not int8 trees")
        return _block_apply_quantized(
            x, bp, cfg, attn_gate=attn_gate, mlp_gate=mlp_gate, neuron_mask=neuron_mask,
            collect_ffn_stats=collect_ffn_stats,
            skip_attention_statically=skip_attention_statically)
    eps = cfg.layernorm_eps
    if not allow_fused_attn:
        if group is not None:
            raise ValueError("tensor-parallel ViT blocks run the fused block kernels")
        if not skip_attention_statically:
            x = fused_attn_block_plain(x, bp["ln1_scale"], bp["ln1_bias"], bp["qkv_kernel"],
                                       bp.get("qkv_bias"), bp["proj_kernel"], bp.get("proj_bias"),
                                       cfg.num_heads, eps=eps, gate=attn_gate)
        mlp, stats = ffn_forward(layer_norm(x, bp["ln2_scale"], bp["ln2_bias"], eps),
                                 bp["fc1_kernel"], bp.get("fc1_bias"), bp["fc2_kernel"],
                                 bp.get("fc2_bias"), neuron_mask=neuron_mask,
                                 collect_stats=collect_ffn_stats)
        return x + dispatch.apply_gate(mlp, mlp_gate), stats
    rank, n = (0, 1) if group is None else (dist.get_rank(group), dist.get_world_size(group))
    lead = rank == 0
    if not skip_attention_statically:
        heads = bp["qkv_kernel"].shape[-1] // 3 // cfg.head_dim
        attn = fused_attn_block_v2 if heads % 2 == 0 else fused_attn_block
        x = all_reduce_sum(attn(
            x, bp["ln1_scale"], bp["ln1_bias"], bp["qkv_kernel"], bp.get("qkv_bias"),
            bp["proj_kernel"], bp.get("proj_bias") if lead else None, heads, eps=eps,
            gate=attn_gate, residual=lead), group)
    f = bp["fc1_kernel"].shape[-1]
    if n > 1 and neuron_mask is not None and neuron_mask.shape[-1] == f * n:
        neuron_mask = neuron_mask[..., rank * f:(rank + 1) * f]
    x, stats = fused_ffn_block(x, bp["ln2_scale"], bp["ln2_bias"], bp["fc1_kernel"],
                               bp.get("fc1_bias"), bp["fc2_kernel"],
                               bp.get("fc2_bias") if lead else None, neuron_mask=neuron_mask,
                               gate=mlp_gate, collect_stats=collect_ffn_stats, eps=eps,
                               residual=lead)
    x = all_reduce_sum(x, group)
    if group is not None and stats is not None:
        stats = gather_along(stats, -1, group)
    return x, stats


def _unbind_blocks(blocks: Params) -> Dict[str, Tuple[torch.Tensor, ...]]:
    """The stacked [L, ...] block tensors as per-layer views, unbound once per
    forward: under autograd each stacked leaf then gets its gradient as one
    stack, not as L full-size scatters of a per-layer index."""
    return {k: v.unbind(0) for k, v in blocks.items()}


def vit_forward(
    params: Params,
    pixel_values: torch.Tensor,
    cfg: ViTConfig,
    *,
    attn_gate: Optional[torch.Tensor] = None,
    mlp_gate: Optional[torch.Tensor] = None,
    neuron_mask: Optional[torch.Tensor] = None,
    collect_ffn_stats: bool = False,
    return_block_outputs: bool = False,
    compute_dtype=torch.float32,
    allow_fused_attn: bool = True,
    tp_group=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Masked (search-phase) forward over the stacked dense parameters.

    Args:
        attn_gate: [num_layers] float32, 1 = attention active, 0 = skipped.
        mlp_gate: [num_layers] float32, the same for the FFN branch.
        neuron_mask: [num_layers, intermediate] per-neuron keep mask.
        collect_ffn_stats: also return per-block, per-sample token-sum of the
            squared FFN activation, "ffn_stats" [num_layers, batch, intermediate] fp32.
        return_block_outputs: also return "block_outputs" [num_layers, batch, seq, hidden].
        allow_fused_attn: False runs every block without the fused block
            kernels (the path to differentiate on the card).
        tp_group: the tensor-parallel group of a ``shard_vit_params`` shard
            (None: one process); ``neuron_mask`` stays full width.

    Returns:
        (logits [batch, num_classes], aux dict with "cls_repr" and the optional outputs)
    """
    if cfg.pruned_attention_blocks:
        raise ValueError("use vit_forward_materialized for depth-materialized configs")
    params = cast_params(params, compute_dtype)
    x = embed(params, cfg, pixel_values, compute_dtype)
    blocks = _unbind_blocks(params["blocks"])
    stats, outs = [], []
    for i in range(cfg.num_layers):
        x, st = _block_apply(
            x, {k: v[i] for k, v in blocks.items()}, cfg,
            attn_gate=None if attn_gate is None else attn_gate[i],
            mlp_gate=None if mlp_gate is None else mlp_gate[i],
            neuron_mask=None if neuron_mask is None else neuron_mask[i],
            collect_ffn_stats=collect_ffn_stats, allow_fused_attn=allow_fused_attn,
            group=tp_group)
        if collect_ffn_stats:
            stats.append(st)
        if return_block_outputs:
            outs.append(x)

    x = layer_norm(x, params["ln_final_scale"], params["ln_final_bias"], cfg.layernorm_eps)
    cls_repr = x[:, 0]
    logits = apply_head(params["head"], cfg, cls_repr)
    aux: Dict[str, torch.Tensor] = {"cls_repr": cls_repr}
    if collect_ffn_stats:
        aux["ffn_stats"] = torch.stack(stats)
    if return_block_outputs:
        aux["block_outputs"] = torch.stack(outs)
    return logits, aux


def vit_forward_materialized(
    params: Params,
    pixel_values: torch.Tensor,
    cfg: ViTConfig,
    *,
    compute_dtype=torch.float32,
    allow_fused_attn: bool = True,
) -> torch.Tensor:
    """Forward for a materialized-pruned model: skips the attention of
    depth-pruned blocks and runs each FFN at the padded kept width
    (``allow_fused_attn`` as in :func:`vit_forward`)."""
    params = cast_params(params, compute_dtype)
    x = embed(params, cfg, pixel_values, compute_dtype)
    blocks = _unbind_blocks(params["blocks"])
    store = cfg.attn_store_index
    for i in range(cfg.num_layers):
        j = store[i]
        bp = {"ln2_scale": blocks["ln2_scale"][i], "ln2_bias": blocks["ln2_bias"][i],
              "fc1_bias": blocks["fc1_bias"][i] if "fc1_bias" in blocks else None,
              "fc2_bias": blocks["fc2_bias"][i] if "fc2_bias" in blocks else None}
        bp.update(pick_param_variants(blocks, ("fc1_kernel", "fc2_kernel"), i))
        if j is not None:
            bp.update(ln1_scale=blocks["ln1_scale"][j], ln1_bias=blocks["ln1_bias"][j],
                      qkv_bias=blocks["qkv_bias"][j] if "qkv_bias" in blocks else None,
                      proj_bias=blocks["proj_bias"][j] if "proj_bias" in blocks else None)
            bp.update(pick_param_variants(blocks, ("qkv_kernel", "proj_kernel"), j))
        x, _ = _block_apply(x, bp, cfg, attn_gate=None, mlp_gate=None, neuron_mask=None,
                            collect_ffn_stats=False, skip_attention_statically=(j is None),
                            allow_fused_attn=allow_fused_attn)
    x = layer_norm(x, params["ln_final_scale"], params["ln_final_bias"], cfg.layernorm_eps)
    return apply_head(params["head"], cfg, x[:, 0])
