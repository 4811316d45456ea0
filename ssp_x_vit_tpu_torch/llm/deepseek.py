"""DeepSeek-V3 family: Multi-head Latent Attention (MLA) and the sigmoid-routed
MoE (counterpart of ``ssp_x_vit_tpu/llm/deepseek.py``).

- **MLA**: ``kv_a`` compresses the hidden state to ``kv_lora_rank`` plus one
  rope key of ``qk_rope_head_dim`` shared by every head; ``kv_b`` expands it
  per head. The serving cache keeps only the normalized compressed vector and
  the roped key: ``kv_lora_rank + qk_rope_head_dim`` values per token and
  layer, whatever the head count.
- **Absorbed decode**: at decode time ``kv_b``'s key half is folded into the
  query and its value half into the output, so attention runs against the
  compressed cache directly (exact by linearity).
- **MoE**: sigmoid router scores, selection on ``scores + e_bias`` with the
  group-limited top-k, weights from the un-biased scores (optionally
  renormalized) times ``routed_scaling_factor``, plus the shared experts; the
  first ``first_k_dense_replace`` layers are dense GLU MLPs. Dropless: every
  expert runs on every token, weighted by the dense ``[T, E]`` combine matrix,
  as the JAX package computes it; the experts are taken in chunks so neither
  the ``[T, E, d]`` products nor an fp32 copy of the expert stack exist whole
  (``parallel/moe.py`` ``dropless_experts``, shared with the llama-family MoE).
- **Training**: both forwards run under autograd (the router's top-k indices
  carry no gradient, its weights do); ``remat=True`` checkpoints each layer
  (``torch.utils.checkpoint``, non-reentrant). Inference callers take
  ``torch.no_grad()`` themselves.

Parameters keep the JAX tree: ``dense_blocks`` and ``moe_blocks`` groups of
stacked ``[L, ...]`` leaves (plain, ``_q`` int8, ``_q4`` packed int4 with
``_scale``). Everything here is plain PyTorch (the JAX package computes MLA
with ``einsum`` outside any Pallas kernel); the projections go through
``ops.common.mm_quant``, so packed-int4 projections launch the dequant GEMM on
the card. The paged MLA server is ``llm/paged_mla.py``.

Tensor parallelism (``tp_group`` of ``deepseek_forward`` /
``deepseek_generate``; shards from ``parallel/llm_sharding.py``
``shard_deepseek_params``) is Megatron for MLA: ``q`` / ``q_b`` / ``kv_b``
column-parallel over whole heads (a rank's head count comes from the widths),
``o`` and the dense / shared ``down`` row-parallel (summed over the group; an
int4 row layer stays whole and gathers its input), ``q_a`` / ``kv_a`` and the
norms replicated, so the compressed latent is the same on every rank and the
decode cache is not cut; the routed experts ``[E, d, f]`` cut on E, each rank
running its range and the combine summed over the group; the lm_head cut on
the vocabulary and gathered. Replicated activations enter the rank's own
products through ``copy_to_tp``, so a replicated weight's gradient is whole on
every rank. ``gather_layer`` (fully sharded training) maps a layer's shards to
its full weights inside the layer body.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ssp_x_vit_tpu_torch.device import DeviceLike, resolve_device
from ssp_x_vit_tpu_torch.llm.rope import (
    RopeScaling, export_rope_scaling, parse_rope_scaling, rope_freqs, yarn_get_mscale,
)
from ssp_x_vit_tpu_torch.ops.common import mm_quant, pick_param_variants
from ssp_x_vit_tpu_torch.parallel.collectives import copy_to_tp, gather_from_tp, reduce_from_tp
from ssp_x_vit_tpu_torch.parallel.moe import grouped_dropless, top_k_indices

Params = Dict[str, Any]

@dataclasses.dataclass(frozen=True)
class DeepseekConfig:
    vocab_size: int = 129280
    hidden_size: int = 7168
    num_layers: int = 4
    num_heads: int = 16
    # MLA dims (HF DeepseekV3Config names)
    q_lora_rank: Optional[int] = None     # None = direct q_proj
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rope_interleave: bool = True
    # MLPs
    intermediate_size: int = 18432        # dense layers
    moe_intermediate_size: int = 2048     # per routed / shared expert
    n_routed_experts: int = 0             # 0 = every layer dense
    n_shared_experts: int = 1
    num_experts_per_tok: int = 8
    n_group: int = 1
    topk_group: int = 1
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 1.0
    first_k_dense_replace: int = 0
    hidden_act: str = "silu"
    rope_theta: float = 10000.0
    rope_scaling: Optional[RopeScaling] = None
    rms_eps: float = 1e-6
    tie_embeddings: bool = False
    # pruning surgery state: the uniform stage-1 FFN width of the dense
    # blocks, and the global indices of attention submodules removed by
    # materialize_deepseek_attention_pruning
    pruned_intermediate_size: Optional[int] = None
    pruned_attention_blocks: Tuple[int, ...] = ()

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def effective_intermediate(self) -> int:
        return (self.pruned_intermediate_size if self.pruned_intermediate_size is not None
                else self.intermediate_size)

    @property
    def attn_store_index(self):
        """Global layer index -> index into its group's attention stacks
        (compacted past removed attention submodules, each group on its own),
        or None where the block's attention was pruned."""
        out, nk = [], self.n_dense_layers
        counts = {False: 0, True: 0}
        for i in range(self.num_layers):
            grp = i >= nk
            if i in self.pruned_attention_blocks:
                out.append(None)
            else:
                out.append(counts[grp])
                counts[grp] += 1
        return out

    @property
    def n_dense_layers(self) -> int:
        if self.n_routed_experts == 0:
            return self.num_layers
        return min(self.first_k_dense_replace, self.num_layers)

    @property
    def n_moe_layers(self) -> int:
        return self.num_layers - self.n_dense_layers

    def __post_init__(self):
        if self.hidden_act != "silu":
            raise ValueError("deepseek engine supports silu GLU only")
        if not isinstance(self.pruned_attention_blocks, tuple):
            object.__setattr__(self, "pruned_attention_blocks",
                               tuple(int(i) for i in self.pruned_attention_blocks))
        if self.n_routed_experts and self.topk_group > self.n_group:
            raise ValueError("topk_group must be <= n_group")
        if self.n_routed_experts and self.n_routed_experts % max(self.n_group, 1):
            raise ValueError("n_routed_experts must divide into n_group groups")


def is_deepseek(cfg) -> bool:
    return isinstance(cfg, DeepseekConfig)


def mla_cache_bytes_per_token(cfg: DeepseekConfig, dtype_bytes: int = 2) -> int:
    """Serving-cache bytes per token and layer: the compressed vector and the
    shared rope key, independent of the head count."""
    return (cfg.kv_lora_rank + cfg.qk_rope_head_dim) * dtype_bytes


# --------------------------------------------------------------------------
# params
# --------------------------------------------------------------------------

def _attn_param_shapes(cfg: DeepseekConfig):
    d, nq = cfg.hidden_size, cfg.num_heads
    shapes = {
        "ln1": (d,),
        "kv_a_kernel": (d, cfg.kv_lora_rank + cfg.qk_rope_head_dim),
        "kv_a_norm": (cfg.kv_lora_rank,),
        "kv_b_kernel": (cfg.kv_lora_rank, nq * (cfg.qk_nope_head_dim + cfg.v_head_dim)),
        "o_kernel": (nq * cfg.v_head_dim, d),
        "ln2": (d,),
    }
    if cfg.q_lora_rank is None:
        shapes["q_kernel"] = (d, nq * cfg.qk_head_dim)
    else:
        shapes["q_a_kernel"] = (d, cfg.q_lora_rank)
        shapes["q_a_norm"] = (cfg.q_lora_rank,)
        shapes["q_b_kernel"] = (cfg.q_lora_rank, nq * cfg.qk_head_dim)
    return shapes


def init_deepseek_params(gen: Optional[torch.Generator], cfg: DeepseekConfig,
                         dtype=torch.float32, device: DeviceLike = None) -> Params:
    """Random parameters in the JAX tree layout (normal, std 0.02; norms at
    one, ``e_bias`` at zero) made on ``device`` (``cuda`` by default) from
    ``gen``, a generator on that device (None: a fresh one seeded with 0).
    Each ``[d_in, d_out]`` slice is drawn in float32 and cast, so a full-size
    expert stack never exists in float32."""
    if cfg.pruned_attention_blocks:
        raise ValueError("init builds uniform stacks; materialize attention "
                         "pruning from an unpruned model instead")
    dev = resolve_device(device)
    if gen is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
    d, fm, E = cfg.hidden_size, cfg.moe_intermediate_size, cfg.n_routed_experts

    def nrm(shape, std=0.02):
        out = torch.empty(shape, dtype=dtype, device=dev)
        flat = out.reshape(-1, *shape[-2:]) if len(shape) > 2 else out.reshape(1, *shape)
        for i in range(flat.shape[0]):
            flat[i].copy_(torch.randn(flat.shape[1:], generator=gen, device=dev) * std)
        return out

    def stack_group(n, moe: bool):
        blocks = {}
        for k, shp in _attn_param_shapes(cfg).items():
            if k.endswith("norm") or k.startswith("ln"):
                blocks[k] = torch.ones((n,) + shp, dtype=dtype, device=dev)
            else:
                blocks[k] = nrm((n,) + shp)
        if moe:
            blocks["router"] = nrm((n, d, E))
            blocks["e_bias"] = torch.zeros((n, E), dtype=dtype, device=dev)
            blocks["gate_kernel"] = nrm((n, E, d, fm))
            blocks["up_kernel"] = nrm((n, E, d, fm))
            blocks["down_kernel"] = nrm((n, E, fm, d))
            if cfg.n_shared_experts:
                fs = fm * cfg.n_shared_experts
                blocks["shared_gate"] = nrm((n, d, fs))
                blocks["shared_up"] = nrm((n, d, fs))
                blocks["shared_down"] = nrm((n, fs, d))
        else:
            f = cfg.effective_intermediate
            blocks["gate_kernel"] = nrm((n, d, f))
            blocks["up_kernel"] = nrm((n, d, f))
            blocks["down_kernel"] = nrm((n, f, d))
        return blocks

    params: Params = {"embed": nrm((cfg.vocab_size, d)),
                      "ln_final": torch.ones((d,), dtype=dtype, device=dev)}
    if cfg.n_dense_layers:
        params["dense_blocks"] = stack_group(cfg.n_dense_layers, moe=False)
    if cfg.n_moe_layers:
        params["moe_blocks"] = stack_group(cfg.n_moe_layers, moe=True)
    if not cfg.tie_embeddings:
        params["lm_head"] = nrm((d, cfg.vocab_size))
    return params


# --------------------------------------------------------------------------
# norms / rope
# --------------------------------------------------------------------------

def _rms(x, scale, eps):
    x32 = x.float()
    y = x32 * torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


def _rope_tables(cfg: DeepseekConfig, positions: torch.Tensor):
    """cos/sin ``[*positions.shape, rope_dim]`` in fp32 at integer positions
    (HF non-interleaved table layout; under yarn the tables carry the
    attention factor)."""
    inv_freq_np, attn_scale = rope_freqs(cfg.rope_theta, cfg.qk_rope_head_dim, cfg.rope_scaling)
    inv_freq = torch.from_numpy(inv_freq_np).to(positions.device)
    freqs = positions.float()[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb) * attn_scale, torch.sin(emb) * attn_scale


def mla_softmax_scale(cfg: DeepseekConfig) -> float:
    """HF ``DeepseekV3Attention``: ``qk_head_dim ** -0.5``, times
    ``yarn_get_mscale(factor, mscale_all_dim) ** 2`` when rope_scaling
    carries a truthy ``mscale_all_dim``."""
    scale = cfg.qk_head_dim ** -0.5
    sc = cfg.rope_scaling
    if sc is not None and sc.mscale_all_dim:
        m = yarn_get_mscale(sc.factor, sc.mscale_all_dim)
        scale *= m * m
    return scale


def _deinterleave(x):
    """HF rope_interleave: even lanes first, odd lanes second."""
    return torch.cat([x[..., 0::2], x[..., 1::2]], dim=-1)


def _apply_rope(x, cos, sin, interleave: bool):
    """x [..., rd]; cos/sin broadcastable to it."""
    if interleave:
        x = _deinterleave(x)
    x32 = x.float()
    half = x.shape[-1] // 2
    rot = torch.cat([-x32[..., half:], x32[..., :half]], dim=-1)
    return (x32 * cos + rot * sin).to(x.dtype)


def _f32mm(a, b):
    """A product of compute-dtype operands accumulated and returned in fp32
    (the JAX package's ``preferred_element_type=float32``)."""
    return torch.matmul(a.float(), b.float())


# --------------------------------------------------------------------------
# attention (full-sequence path)
# --------------------------------------------------------------------------

def _mm(x, bp, name, dt):
    """Quantization-aware projection matmul (``ops.common.mm_quant``)."""
    return mm_quant(x, bp, name, dt)


def _kv_b_matrix(bp, dt):
    """kv_b's ``[kvr, nq * (nope + vd)]`` weight as a matrix (int8 and packed
    int4 entries dequantized here; the absorbed paths fold it per head)."""
    if "kv_b_kernel_q" in bp:
        return (bp["kv_b_kernel_q"].float() * bp["kv_b_kernel_scale"].float()[None]).to(dt)
    if "kv_b_kernel_q4" in bp:
        from ssp_x_vit_tpu_torch.ops.kernels.quant_matmul import unpack_int4

        return (unpack_int4(bp["kv_b_kernel_q4"]).float()
                * bp["kv_b_kernel_scale"].float()[None]).to(dt)
    return bp["kv_b_kernel"].to(dt)


def _row(h, bp, name, dt, tp=None):
    """A row-parallel projection summed over ``tp`` (an int4 one stays whole
    and gathers its input instead, as the llama family's ``_row_parallel``)."""
    if tp is None:
        return _mm(h, bp, name, dt)
    if name + "_q4" in bp:
        return _mm(gather_from_tp(h, tp), bp, name, dt)
    return reduce_from_tp(_mm(h, bp, name, dt), tp)


def _head_logits(x, params, dt, tp=None):
    """lm_head -> fp32 logits (tied-embedding fallback, int8 head via _mm);
    under ``tp`` an untied head is vocab-sharded and gathered."""
    if "lm_head" in params or "lm_head_q" in params:
        logits = _mm(copy_to_tp(x, tp), params, "lm_head", dt).float()
        return logits if tp is None else gather_from_tp(logits, tp)
    return (x @ params["embed"].t().to(dt)).float()


def _mla_q(x, bp, cfg: DeepseekConfig, dt, tp=None):
    """[b, s, d] -> q [b, nq, s, qk_head_dim] (before rope); nq is this rank's
    head count under ``tp``."""
    b, s, _ = x.shape
    if cfg.q_lora_rank is None:
        q = _mm(copy_to_tp(x, tp), bp, "q_kernel", dt)
    else:
        qa = _rms(_mm(x, bp, "q_a_kernel", dt), bp["q_a_norm"], cfg.rms_eps)
        q = _mm(copy_to_tp(qa, tp), bp, "q_b_kernel", dt)
    return q.reshape(b, s, -1, cfg.qk_head_dim).transpose(1, 2)


def _mla_compressed(x, bp, cfg: DeepseekConfig, dt):
    """[b, s, d] -> (c_norm [b, s, kvr], k_rot_raw [b, s, rd]): the
    normalized compressed vector, what the serving cache stores."""
    ckv = _mm(x, bp, "kv_a_kernel", dt)
    c, k_rot = ckv[..., :cfg.kv_lora_rank], ckv[..., cfg.kv_lora_rank:]
    return _rms(c, bp["kv_a_norm"], cfg.rms_eps), k_rot


def _mla_expand_kv(c_norm, bp, cfg: DeepseekConfig, dt, tp=None):
    """[b, s, kvr] -> (k_nope [b, nq, s, nope], v [b, nq, s, vd]), nq this
    rank's heads under ``tp``."""
    b, s, _ = c_norm.shape
    kv = _mm(copy_to_tp(c_norm, tp), bp, "kv_b_kernel", dt).reshape(
        b, s, -1, cfg.qk_nope_head_dim + cfg.v_head_dim).transpose(1, 2)
    return kv[..., :cfg.qk_nope_head_dim], kv[..., cfg.qk_nope_head_dim:]


def _mla_attention(x, bp, cfg: DeepseekConfig, dt, tp=None):
    """Full-sequence causal MLA attention of the post-ln1 ``x``. Returns
    (out [b, s, d], c_norm [b, s, kvr], k_rot_roped [b, s, rd]); under ``tp``
    the rank's heads, ``out`` summed over the group."""
    b, s, _ = x.shape
    q = _mla_q(x, bp, cfg, dt, tp)
    q_nope, q_rot = q[..., :cfg.qk_nope_head_dim], q[..., cfg.qk_nope_head_dim:]
    c_norm, k_rot_raw = _mla_compressed(x, bp, cfg, dt)
    k_nope, v = _mla_expand_kv(c_norm, bp, cfg, dt, tp)

    pos = torch.arange(s, device=x.device)
    cos, sin = _rope_tables(cfg, pos)                        # [s, rd]
    q_rot = _apply_rope(q_rot, cos, sin, cfg.rope_interleave)            # [b, nq, s, rd]
    k_rot = _apply_rope(k_rot_raw, cos, sin, cfg.rope_interleave)        # [b, s, rd]

    scores = (_f32mm(q_nope, k_nope.transpose(-1, -2))
              + _f32mm(q_rot, copy_to_tp(k_rot, tp)[:, None].transpose(-1, -2))
              ) * mla_softmax_scale(cfg)
    causal = pos[None, :] <= pos[:, None]
    scores = torch.where(causal, scores, torch.full_like(scores, float("-inf")))
    probs = torch.softmax(scores, dim=-1)
    ctx = _f32mm(probs.to(dt), v).to(dt)                     # [b, nq, s, vd]
    out = ctx.transpose(1, 2).reshape(b, s, -1)
    return _row(out, bp, "o_kernel", dt, tp), c_norm, k_rot


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------

def _glu(x, bp, dt, names=("gate_kernel", "up_kernel", "down_kernel"), tp=None):
    """SwiGLU over named block params (quantization-aware via _mm); under
    ``tp`` gate / up column- and down row-parallel."""
    x = copy_to_tp(x, tp)
    g = _mm(x, bp, names[0], dt)
    u = _mm(x, bp, names[1], dt)
    return _row(F.silu(g) * u, bp, names[2], dt, tp)


def _deepseek_route(xt, bp, cfg: DeepseekConfig):
    """HF DeepseekV3TopkRouter: fp32 sigmoid scores; selection on scores +
    e_bias with the group-limited top-k (groups scored by their top-2 sum;
    masked groups set to 0.0); weights gathered from the un-biased scores,
    optionally renormalized, times routed_scaling_factor. Returns the dense
    [T, E] combine weights."""
    E, k = cfg.n_routed_experts, cfg.num_experts_per_tok
    logits = xt.float() @ bp["router"].float()
    scores = torch.sigmoid(logits)                           # [T, E]
    choice = scores + bp["e_bias"].float()[None]
    if cfg.n_group > 1:
        T = choice.shape[0]
        per = E // cfg.n_group
        grouped = choice.reshape(T, cfg.n_group, per)
        top2 = torch.sort(grouped, dim=-1, descending=True).values[..., :min(2, per)]
        group_scores = top2.sum(dim=-1)                      # [T, G]
        gidx = top_k_indices(group_scores, cfg.topk_group)
        gmask = torch.zeros_like(group_scores).scatter_(1, gidx, 1.0)
        choice = torch.where(gmask.repeat_interleave(per, dim=-1) > 0, choice,
                             torch.zeros_like(choice))
    top_e = top_k_indices(choice, k)                        # [T, k]
    w = torch.gather(scores, 1, top_e)                       # un-biased
    if cfg.norm_topk_prob:
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
    w = w * cfg.routed_scaling_factor
    return torch.zeros_like(scores).scatter_(1, top_e, w)    # [T, E]


def _deepseek_moe(x, bp, cfg: DeepseekConfig, dt, tp=None):
    """Dropless routed experts (every expert on every token, weighted by the
    dense combine matrix) plus the always-on shared experts. Under ``tp`` the
    routing is computed on every rank, each runs its expert range and its
    shared-expert columns, and both are summed over the group."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    sel = _deepseek_route(xt, bp, cfg).to(dt)                # [T, E]
    routed = grouped_dropless(xt, sel, bp, dt, tp).reshape(b, s, d)
    if cfg.n_shared_experts:
        routed = routed + _glu(x, bp, dt, ("shared_gate", "shared_up", "shared_down"), tp)
    return routed


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

_ATTN_BASES = ("ln1", "q_kernel", "q_a_kernel", "q_a_norm", "q_b_kernel",
               "kv_a_kernel", "kv_a_norm", "kv_b_kernel", "o_kernel")
_MLP_BASES = ("ln2", "gate_kernel", "up_kernel", "down_kernel",
              "router", "e_bias", "shared_gate", "shared_up", "shared_down")


def _layer_params(blocks, bases, idx):
    """Per-layer param dict of whichever storage variant each base key has
    (``ops.common.pick_param_variants``)."""
    return pick_param_variants(blocks, bases, idx)


def deepseek_layers(params: Params, cfg: DeepseekConfig):
    """[(moe, attention params or None, MLP params)] per global layer, each a
    dict of per-layer views of the group stacks; attention submodules removed
    by materialization are None."""
    nk = cfg.n_dense_layers
    store = cfg.attn_store_index
    out = []
    for i in range(cfg.num_layers):
        moe = i >= nk
        blocks = params["moe_blocks" if moe else "dense_blocks"]
        li = i - nk if moe else i
        ap = None if store[i] is None else _layer_params(blocks, _ATTN_BASES, store[i])
        out.append((moe, ap, _layer_params(blocks, _MLP_BASES, li)))
    return out


def _gate(t, g, dtype):
    """Branch times a scalar (or per-row ``[b, 1, 1]``) gate in the branch dtype."""
    return t if g is None else t * g.to(dtype)


def _embed(params, input_ids, dt):
    return F.embedding(input_ids, params["embed"]).to(dt)


def _layer(x, moe, ap, mp, cfg: DeepseekConfig, dt, ga, gm, collect_mlp_stats, tp=None,
           gather_layer=None):
    """One block: (x out, c and k_rot of its attention or None, MLP stats or None).
    ``gather_layer(params, group_key)`` maps the layer's shards to its weights."""
    if gather_layer is not None:
        key = "moe_blocks" if moe else "dense_blocks"
        ap = None if ap is None else gather_layer(ap, key)
        mp = gather_layer(mp, key)
    c = kr = stats = None
    if ap is not None:
        attn_out, c, kr = _mla_attention(_rms(x, ap["ln1"], cfg.rms_eps), ap, cfg, dt, tp)
        x = x + _gate(attn_out, ga, x.dtype)
    h = _rms(x, mp["ln2"], cfg.rms_eps)
    if moe:
        mlp_out = _deepseek_moe(h, mp, cfg, dt, tp)
    elif tp is not None:
        mlp_out = _glu(h, mp, dt, tp=tp)
    else:
        g = _mm(h, mp, "gate_kernel", dt)
        u = _mm(h, mp, "up_kernel", dt)
        hidden = F.silu(g) * u
        if collect_mlp_stats:
            stats = hidden.float().square().sum(dim=1)
        mlp_out = _mm(hidden, mp, "down_kernel", dt)
    return x + _gate(mlp_out, gm, x.dtype), c, kr, stats


def _run_forward(params, input_ids, cfg: DeepseekConfig, dt, *, attn_gate=None,
                 mlp_gate=None, collect_mlp_stats=False, return_block_outputs=False,
                 logit_position=None, remat=False, tp=None, gather_layer=None):
    """The per-layer loop shared by both forwards: (logits, c [La, b, s, kvr],
    kr [La, b, s, rd] of the layers with attention, aux). ``remat``
    checkpoints each layer (non-reentrant): the backward recomputes it."""
    x = _embed(params, input_ids, dt)
    cs, krs, stats, outs = [], [], [], []
    for i, (moe, ap, mp) in enumerate(deepseek_layers(params, cfg)):
        ga = None if attn_gate is None else attn_gate[i]
        gm = None if mlp_gate is None else mlp_gate[i]
        args = (moe, ap, mp, cfg, dt, ga, gm, collect_mlp_stats and not moe, tp, gather_layer)
        if remat:
            x, c, kr, st = checkpoint(_layer, x, *args, use_reentrant=False,
                                      preserve_rng_state=False)
        else:
            x, c, kr, st = _layer(x, *args)
        if ap is not None:
            cs.append(c)
            krs.append(kr)
        if st is not None:
            stats.append(st)
        if return_block_outputs:
            outs.append(x)
    x = _rms(x, params["ln_final"], cfg.rms_eps)
    if logit_position is not None:
        x = x[:, int(logit_position):int(logit_position) + 1]
    aux = {}
    if collect_mlp_stats:
        aux["mlp_stats"] = torch.stack(stats)
    if return_block_outputs:
        aux["block_outputs"] = torch.stack(outs)
    return _head_logits(x, params, dt, tp), cs, krs, aux


def _as_gates(g, device):
    if g is None or isinstance(g, torch.Tensor):
        return None if g is None else g.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(g, np.float32), device=device)


def deepseek_forward(params: Params, input_ids: torch.Tensor, cfg: DeepseekConfig, *,
                     compute_dtype=torch.bfloat16, return_caches: bool = False,
                     logit_position: Optional[int] = None, attn_gate=None, mlp_gate=None,
                     collect_mlp_stats: bool = False, return_block_outputs: bool = False,
                     remat: bool = False, tp_group=None, gather_layer=None):
    """input_ids [b, s] -> logits [b, s, V] fp32. ``return_caches`` also
    returns the serving-cache tensors (c [L, b, s, kvr], k_rot [L, b, s, rd],
    rope applied); ``logit_position`` computes logits at that position only
    ([b, 1, V]). ``attn_gate`` / ``mlp_gate`` are [L] gates (or ``[L, b, 1, 1]``:
    one per batch row, a batch of skip-pattern candidates over the same
    tokens); ``collect_mlp_stats`` / ``return_block_outputs`` add an aux dict
    as a second output: ``mlp_stats`` [L, b, f] (dense-GLU configs only) and
    ``block_outputs`` [L, b, s, d]. ``remat=True`` (training under autograd)
    checkpoints each layer; the backward recomputes its forward. ``tp_group``:
    the tensor-parallel group of a ``shard_deepseek_params`` shard (no MLP
    statistics; the full logits on every rank). ``gather_layer(params,
    group_key)``: fully sharded training's per-layer all-gather."""
    if tp_group is not None and collect_mlp_stats:
        raise ValueError("tensor parallelism takes no MLP statistics")
    if cfg.pruned_attention_blocks:
        raise ValueError("use deepseek_forward_materialized for "
                         "attention-materialized configs")
    if collect_mlp_stats and cfg.n_moe_layers:
        raise ValueError(
            "2SSP width instrumentation targets dense GLU MLPs; MoE blocks "
            "route tokens per-expert and have no single down_proj input")
    dev = input_ids.device
    logits, cs, krs, aux = _run_forward(
        params, input_ids, cfg, compute_dtype, attn_gate=_as_gates(attn_gate, dev),
        mlp_gate=_as_gates(mlp_gate, dev), collect_mlp_stats=collect_mlp_stats,
        return_block_outputs=return_block_outputs, logit_position=logit_position, remat=remat,
        tp=tp_group, gather_layer=gather_layer)
    want_aux = collect_mlp_stats or return_block_outputs
    if not return_caches:
        return (logits, aux) if want_aux else logits
    caches = (torch.stack(cs), torch.stack(krs))
    return (logits, caches, aux) if want_aux else (logits, caches)


def deepseek_forward_materialized(params: Params, input_ids: torch.Tensor,
                                  cfg: DeepseekConfig, *, compute_dtype=torch.bfloat16,
                                  return_caches: bool = False,
                                  logit_position: Optional[int] = None):
    """The forward of attention-materialized models (the MLA weights of
    ``cfg.pruned_attention_blocks`` are absent from the group stacks);
    ``return_caches`` emits the compressed cache of the surviving attention
    layers only, in layer order ([L_attn, b, s, ...])."""
    logits, cs, krs, _ = _run_forward(params, input_ids, cfg, compute_dtype,
                                      logit_position=logit_position)
    if not return_caches:
        return logits
    return logits, (torch.stack(cs), torch.stack(krs))


# --------------------------------------------------------------------------
# serving: compressed cache + absorbed decode
# --------------------------------------------------------------------------

def _absorbed_kv_b(bp, cfg: DeepseekConfig, dt):
    """kv_b folded per head for weight absorption: [kvr, nq, nope + vd] (nq
    this rank's heads of a tensor-parallel shard)."""
    return _kv_b_matrix(bp, dt).reshape(cfg.kv_lora_rank, -1,
                                        cfg.qk_nope_head_dim + cfg.v_head_dim)


def _absorbed_q(h, bp, cfg: DeepseekConfig, dt, cos, sin, wkv, tp=None):
    """The absorbed query of one position per row: h [b, d] post-ln1, cos/sin
    broadcastable to [b, nq, rd] -> (q_c [b, nq, kvr] in dt, q_rot [b, nq, rd])."""
    nope = cfg.qk_nope_head_dim
    q = _mla_q(h[:, None], bp, cfg, dt, tp)[:, :, 0]         # [b, nq, qk]
    q_nope, q_rot = q[..., :nope], q[..., nope:]
    q_rot = _apply_rope(q_rot, cos, sin, cfg.rope_interleave)
    # [b, nq, nope] x [nq, nope, kvr] per head
    q_c = _f32mm(q_nope.transpose(0, 1), wkv[:, :, :nope].permute(1, 2, 0)).transpose(0, 1)
    return q_c.to(dt), q_rot


def _absorbed_out(ctx_c, bp, cfg: DeepseekConfig, dt, wkv, tp=None):
    """Context in compressed space [b, nq, kvr] -> o_proj output [b, d]."""
    b = ctx_c.shape[0]
    nope = cfg.qk_nope_head_dim
    out = _f32mm(ctx_c.to(dt).transpose(0, 1), wkv[:, :, nope:].transpose(0, 1)).transpose(0, 1)
    return _row(out.to(dt).reshape(b, -1), bp, "o_kernel", dt, tp)


def _absorbed_decode_attention(x, bp, cfg: DeepseekConfig, dt, c_cache, kr_cache, t: int,
                               tp=None):
    """One decode position against the compressed cache (weight absorption).
    x [b, d] is the post-ln1 hidden state; c_cache [b, S, kvr] / kr_cache
    [b, S, rd] hold positions < t; this step's compressed vector is written at
    position t, in place, and attended to. Returns attn_out [b, d]."""
    cos, sin = _rope_tables(cfg, torch.full((1,), t, device=x.device))  # [1, rd]
    wkv = _absorbed_kv_b(bp, cfg, dt)
    q_c, q_rot = _absorbed_q(x, bp, cfg, dt, cos, sin, wkv, tp)

    c_new, k_rot_raw = _mla_compressed(x[:, None], bp, cfg, dt)
    k_rot_new = _apply_rope(k_rot_raw, cos, sin, cfg.rope_interleave)   # [b, 1, rd]
    c_cache[:, t:t + 1] = c_new.to(c_cache.dtype)
    kr_cache[:, t:t + 1] = k_rot_new.to(kr_cache.dtype)

    # positions > t are masked out in the JAX package: attend [0, t] only
    c = c_cache[:, :t + 1].to(dt)
    kr = kr_cache[:, :t + 1].to(dt)
    scores = (_f32mm(q_c, c.transpose(1, 2)) + _f32mm(q_rot, kr.transpose(1, 2)))
    probs = torch.softmax(scores * mla_softmax_scale(cfg), dim=-1)
    ctx_c = _f32mm(probs.to(dt), c).to(dt)                   # [b, nq, kvr]
    return _absorbed_out(ctx_c, bp, cfg, dt, wkv, tp)


def _decode_step(params: Params, token: torch.Tensor, cfg: DeepseekConfig, dt,
                 c_caches, kr_caches, t: int, layers=None, tp=None):
    """token [b] at position t -> logits [b, V]; the caches ([La, b, S, ...],
    one row per layer with attention) are written in place."""
    x = _embed(params, token, dt)                             # [b, d]
    a = 0
    for moe, ap, mp in (layers if layers is not None else deepseek_layers(params, cfg)):
        if ap is not None:
            h = _rms(x, ap["ln1"], cfg.rms_eps)
            x = x + _absorbed_decode_attention(h, ap, cfg, dt, c_caches[a], kr_caches[a], t,
                                               tp)
            a += 1
        h2 = _rms(x, mp["ln2"], cfg.rms_eps)
        mlp = (_deepseek_moe(h2[:, None], mp, cfg, dt, tp)[:, 0] if moe
               else _glu(h2, mp, dt, tp=tp))
        x = x + mlp
    x = _rms(x, params["ln_final"], cfg.rms_eps)
    return _head_logits(x, params, dt, tp)



@torch.no_grad()
def deepseek_generate(params: Params, cfg: DeepseekConfig, prompt, *, max_new_tokens: int = 32,
                      eos_token_id: Optional[int] = None, compute_dtype=torch.bfloat16,
                      tp_group=None):
    """Greedy generation over the compressed MLA cache (absorbed decode) on
    the device of ``params``: one prefill through the full forward (which
    emits the cache), then a decode step per token.

    ``prompt`` is one id sequence [s] (returns one array: prompt + generation,
    trimmed at eos) or a same-length batch [b, s] (returns a list of such
    arrays). The tokens stay on the device until the end. ``tp_group``: the
    tensor-parallel group of a ``shard_deepseek_params`` shard (the latent
    cache is whole on every rank; every rank returns the same tokens)."""
    arr = np.asarray(prompt, np.int64)
    single = arr.ndim == 1
    batch = arr.reshape(1, -1) if single else arr
    b, s0 = batch.shape
    S = s0 + max_new_tokens
    dt = compute_dtype
    device = params["embed"].device

    if cfg.pruned_attention_blocks:
        if tp_group is not None:
            raise ValueError("tensor parallelism takes unpruned DeepSeek trees")
        logits, (c, kr) = deepseek_forward_materialized(
            params, torch.as_tensor(batch, device=device), cfg, compute_dtype=dt,
            return_caches=True)
    else:
        logits, (c, kr) = deepseek_forward(params, torch.as_tensor(batch, device=device), cfg,
                                           compute_dtype=dt, return_caches=True,
                                           tp_group=tp_group)
    first = logits[:, -1].argmax(dim=-1)                      # [b]

    c_caches = torch.zeros((c.shape[0], b, S, c.shape[-1]), dtype=dt, device=device)
    kr_caches = torch.zeros((kr.shape[0], b, S, kr.shape[-1]), dtype=dt, device=device)
    c_caches[:, :, :s0] = c.to(dt)
    kr_caches[:, :, :s0] = kr.to(dt)

    toks = [first]
    if max_new_tokens > 1:
        layers = deepseek_layers(params, cfg)
        token = first
        # the JAX scan emits each step's input token, so its last step's
        # output is never used: max_new_tokens - 1 steps give the same tokens
        for t in range(s0, s0 + max_new_tokens - 1):
            token = _decode_step(params, token, cfg, dt, c_caches, kr_caches, t,
                                 layers, tp_group).argmax(dim=-1)
            toks.append(token)
    gen = torch.stack(toks).cpu().numpy()                     # [n, b]

    outs = []
    for i in range(b):
        seq = gen[:, i].tolist()
        if eos_token_id is not None and eos_token_id in seq:
            seq = seq[: seq.index(eos_token_id) + 1]
        outs.append(np.asarray(batch[i].tolist() + seq, np.int32))
    return outs[0] if single else outs


# --------------------------------------------------------------------------
# HF checkpoints
# --------------------------------------------------------------------------

def config_from_hf_deepseek(d: Dict[str, Any]) -> DeepseekConfig:
    if d.get("model_type") != "deepseek_v3":
        # deepseek_v2 scores its router with softmax and a per-group greedy
        # top-k; refused rather than mis-routed
        raise ValueError(f"not a deepseek_v3 config: {d.get('model_type')}")
    n_routed = d.get("n_routed_experts") or 0
    return DeepseekConfig(
        vocab_size=d["vocab_size"],
        hidden_size=d["hidden_size"],
        num_layers=d["num_hidden_layers"],
        num_heads=d["num_attention_heads"],
        q_lora_rank=d.get("q_lora_rank"),
        kv_lora_rank=d["kv_lora_rank"],
        qk_nope_head_dim=d["qk_nope_head_dim"],
        qk_rope_head_dim=d["qk_rope_head_dim"],
        v_head_dim=d["v_head_dim"],
        rope_interleave=d.get("rope_interleave", True),
        intermediate_size=d["intermediate_size"],
        moe_intermediate_size=d.get("moe_intermediate_size", d["intermediate_size"]),
        n_routed_experts=n_routed,
        n_shared_experts=d.get("n_shared_experts", 0) if n_routed else 0,
        num_experts_per_tok=d.get("num_experts_per_tok", 8),
        n_group=d.get("n_group", 1) or 1,
        topk_group=d.get("topk_group", 1) or 1,
        norm_topk_prob=d.get("norm_topk_prob", True),
        routed_scaling_factor=d.get("routed_scaling_factor", 1.0),
        first_k_dense_replace=d.get("first_k_dense_replace", 0),
        rope_theta=d.get("rope_theta", 10000.0),
        rope_scaling=parse_rope_scaling(d.get("rope_scaling")),
        rms_eps=d.get("rms_norm_eps", 1e-6),
        tie_embeddings=d.get("tie_word_embeddings", False),
    )


def load_hf_deepseek(model_dir: str, *, device: DeviceLike = None,
                     dtype=torch.float32) -> Tuple[Params, DeepseekConfig]:
    """A local DeepseekV3ForCausalLM directory (``config.json`` +
    ``*.safetensors``) -> the two-group stacked layout on ``device``
    (``cuda`` by default). Each tensor is read alone, moved to the device in
    its file dtype and converted there (transposed to ``[in, out]``)."""
    from ssp_x_vit_tpu_torch.models.checkpoints import SafetensorsFiles, _fp32

    dev = resolve_device(device)
    with open(os.path.join(model_dir, "config.json")) as f:
        cfg = config_from_hf_deepseek(json.load(f))
    shards = sorted(glob.glob(os.path.join(model_dir, "*.safetensors")))
    if not shards:
        raise FileNotFoundError(f"no safetensors shards in {model_dir}")
    sd = SafetensorsFiles(shards)

    def g(key):
        return _fp32(sd, key, dev)

    def t(key):
        return g(key).t()

    def layer_names(i, moe):
        pre = f"model.layers.{i}"
        names = {"ln1": (pre + ".input_layernorm.weight", False),
                 "ln2": (pre + ".post_attention_layernorm.weight", False),
                 "kv_a_kernel": (pre + ".self_attn.kv_a_proj_with_mqa.weight", True),
                 "kv_a_norm": (pre + ".self_attn.kv_a_layernorm.weight", False),
                 "kv_b_kernel": (pre + ".self_attn.kv_b_proj.weight", True),
                 "o_kernel": (pre + ".self_attn.o_proj.weight", True)}
        if cfg.q_lora_rank is None:
            names["q_kernel"] = (pre + ".self_attn.q_proj.weight", True)
        else:
            names["q_a_kernel"] = (pre + ".self_attn.q_a_proj.weight", True)
            names["q_a_norm"] = (pre + ".self_attn.q_a_layernorm.weight", False)
            names["q_b_kernel"] = (pre + ".self_attn.q_b_proj.weight", True)
        mp = pre + ".mlp"
        if not moe:
            for ours, theirs in (("gate_kernel", "gate_proj"), ("up_kernel", "up_proj"),
                                 ("down_kernel", "down_proj")):
                names[ours] = (f"{mp}.{theirs}.weight", True)
        else:
            names["router"] = (mp + ".gate.weight", True)
            names["e_bias"] = (mp + ".gate.e_score_correction_bias", False)
            if cfg.n_shared_experts:
                for ours, theirs in (("shared_gate", "gate_proj"), ("shared_up", "up_proj"),
                                     ("shared_down", "down_proj")):
                    names[ours] = (f"{mp}.shared_experts.{theirs}.weight", True)
        return names

    def stack_group(layers, moe):
        blocks = {}
        n = len(layers)
        for ours, (_, transpose) in layer_names(layers[0], moe).items():
            out = None
            for j, i in enumerate(layers):
                key = layer_names(i, moe)[ours][0]
                v = t(key) if transpose else g(key)
                if out is None:
                    out = torch.empty((n, *v.shape), dtype=dtype, device=dev)
                out[j].copy_(v)
            blocks[ours] = out
        if moe:
            mp = "model.layers.{i}.mlp.experts.{e}.{w}.weight"
            for ours, theirs in (("gate_kernel", "gate_proj"), ("up_kernel", "up_proj"),
                                 ("down_kernel", "down_proj")):
                out = None
                for j, i in enumerate(layers):
                    for e in range(cfg.n_routed_experts):
                        v = t(mp.format(i=i, e=e, w=theirs))
                        if out is None:
                            out = torch.empty((n, cfg.n_routed_experts, *v.shape),
                                              dtype=dtype, device=dev)
                        out[j, e].copy_(v)
                blocks[ours] = out
        return blocks

    nk = cfg.n_dense_layers
    params: Params = {"embed": g("model.embed_tokens.weight").to(dtype),
                      "ln_final": g("model.norm.weight").to(dtype)}
    if nk:
        params["dense_blocks"] = stack_group(list(range(nk)), False)
    if cfg.n_moe_layers:
        params["moe_blocks"] = stack_group(list(range(nk, cfg.num_layers)), True)
    if not cfg.tie_embeddings:
        params["lm_head"] = t("lm_head.weight").to(dtype).contiguous()
    return params, cfg


def hf_dict_from_deepseek(cfg: DeepseekConfig) -> Dict[str, Any]:
    """Inverse of :func:`config_from_hf_deepseek`, as the JAX package writes
    it (dense-only configs export with ``first_k_dense_replace ==
    num_layers``; width-pruned ones with the pruned intermediate size)."""
    dense_only = cfg.n_routed_experts == 0
    return {
        "architectures": ["DeepseekV3ForCausalLM"],
        "model_type": "deepseek_v3",
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_heads,
        "q_lora_rank": cfg.q_lora_rank,
        "kv_lora_rank": cfg.kv_lora_rank,
        "qk_nope_head_dim": cfg.qk_nope_head_dim,
        "qk_rope_head_dim": cfg.qk_rope_head_dim,
        "head_dim": cfg.qk_rope_head_dim,
        "v_head_dim": cfg.v_head_dim,
        "rope_interleave": cfg.rope_interleave,
        "intermediate_size": cfg.effective_intermediate,
        "moe_intermediate_size": cfg.moe_intermediate_size,
        "n_routed_experts": cfg.n_routed_experts,
        "n_shared_experts": cfg.n_shared_experts if not dense_only else 0,
        "num_experts_per_tok": cfg.num_experts_per_tok,
        "n_group": cfg.n_group,
        "topk_group": cfg.topk_group,
        "norm_topk_prob": cfg.norm_topk_prob,
        "routed_scaling_factor": cfg.routed_scaling_factor,
        "first_k_dense_replace": cfg.num_layers if dense_only else cfg.first_k_dense_replace,
        "hidden_act": cfg.hidden_act,
        "rope_theta": cfg.rope_theta,
        "rope_scaling": export_rope_scaling(cfg.rope_scaling),
        "rms_norm_eps": cfg.rms_eps,
        "tie_word_embeddings": cfg.tie_embeddings,
        "attention_bias": False,
    }


def export_hf_deepseek(out_dir: str, params: Params, cfg: DeepseekConfig) -> str:
    """Export a DeepSeek tree as an HF checkpoint (``config.json`` +
    ``model.safetensors`` in F32), the inverse of :func:`load_hf_deepseek`
    and byte for byte the JAX exporter's file for the same parameters.
    Quantized trees and attention-materialized models raise ValueError
    before anything is written."""
    from ssp_x_vit_tpu_torch.models.checkpoints import _write_safetensors

    for grp in ("dense_blocks", "moe_blocks"):
        if grp in params and any(k.endswith(("_q", "_q4", "_scale")) for k in params[grp]):
            raise ValueError("quantized pytrees have no HF encoding — "
                             "export the dense params and quantize after "
                             "from_pretrained")
    if "lm_head_q" in params:
        raise ValueError("quantized lm_head has no HF encoding")
    if cfg.pruned_attention_blocks:
        raise ValueError("attention-materialized models have no HF encoding "
                         "(DeepseekV3 layers always carry self_attn) — use "
                         "save_deepseek_model for the native artifact")

    hf_cfg = hf_dict_from_deepseek(cfg)
    tensors: Dict[str, torch.Tensor] = {}

    def put(name, t, transpose=False):
        tensors[name] = t.t() if transpose else t

    nk = cfg.n_dense_layers
    for i in range(cfg.num_layers):
        moe = i >= nk
        blocks = params["moe_blocks" if moe else "dense_blocks"]
        li = i - nk if moe else i
        pre = f"model.layers.{i}"
        put(pre + ".input_layernorm.weight", blocks["ln1"][li])
        put(pre + ".post_attention_layernorm.weight", blocks["ln2"][li])
        put(pre + ".self_attn.kv_a_proj_with_mqa.weight", blocks["kv_a_kernel"][li], True)
        put(pre + ".self_attn.kv_a_layernorm.weight", blocks["kv_a_norm"][li])
        put(pre + ".self_attn.kv_b_proj.weight", blocks["kv_b_kernel"][li], True)
        put(pre + ".self_attn.o_proj.weight", blocks["o_kernel"][li], True)
        if cfg.q_lora_rank is None:
            put(pre + ".self_attn.q_proj.weight", blocks["q_kernel"][li], True)
        else:
            put(pre + ".self_attn.q_a_proj.weight", blocks["q_a_kernel"][li], True)
            put(pre + ".self_attn.q_a_layernorm.weight", blocks["q_a_norm"][li])
            put(pre + ".self_attn.q_b_proj.weight", blocks["q_b_kernel"][li], True)
        mp = pre + ".mlp"
        if not moe:
            put(mp + ".gate_proj.weight", blocks["gate_kernel"][li], True)
            put(mp + ".up_proj.weight", blocks["up_kernel"][li], True)
            put(mp + ".down_proj.weight", blocks["down_kernel"][li], True)
        else:
            put(mp + ".gate.weight", blocks["router"][li], True)
            put(mp + ".gate.e_score_correction_bias", blocks["e_bias"][li])
            for ours, theirs in (("gate_kernel", "gate_proj"), ("up_kernel", "up_proj"),
                                 ("down_kernel", "down_proj")):
                for e in range(cfg.n_routed_experts):
                    put(f"{mp}.experts.{e}.{theirs}.weight", blocks[ours][li][e], True)
            if cfg.n_shared_experts:
                put(mp + ".shared_experts.gate_proj.weight", blocks["shared_gate"][li], True)
                put(mp + ".shared_experts.up_proj.weight", blocks["shared_up"][li], True)
                put(mp + ".shared_experts.down_proj.weight", blocks["shared_down"][li], True)

    put("model.embed_tokens.weight", params["embed"])
    put("model.norm.weight", params["ln_final"])
    if not cfg.tie_embeddings and "lm_head" in params:
        put("lm_head.weight", params["lm_head"], True)

    os.makedirs(out_dir, exist_ok=True)
    _write_safetensors(os.path.join(out_dir, "model.safetensors"), tensors,
                       metadata={"format": "pt"})
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(hf_cfg, f, indent=2)
    return out_dir


def save_deepseek_model(out_dir: str, params: Params, cfg: DeepseekConfig) -> str:
    """Persist a DeepSeek model (dense or quantized tree) as ``model.npz`` +
    ``config.json``, the files the JAX package writes."""
    from ssp_x_vit_tpu_torch.models.checkpoints import save_params_npz

    os.makedirs(out_dir, exist_ok=True)
    save_params_npz(os.path.join(out_dir, "model.npz"), params)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2)
    return out_dir


def load_deepseek_model(model_dir: str, *, device: DeviceLike = None,
                        dtype=torch.bfloat16) -> Tuple[Params, DeepseekConfig]:
    """Inverse of :func:`save_deepseek_model` onto ``device`` (``cuda`` by
    default); integer codes keep their dtype, float leaves become ``dtype``."""
    from ssp_x_vit_tpu_torch.models.checkpoints import load_params_npz

    with open(os.path.join(model_dir, "config.json")) as f:
        d = json.load(f)
    if isinstance(d.get("rope_scaling"), dict):
        d["rope_scaling"] = RopeScaling(**d["rope_scaling"])
    cfg = DeepseekConfig(**d)
    return load_params_npz(os.path.join(model_dir, "model.npz"), device=device, dtype=dtype), cfg
