"""Functional PyTorch causal LM, llama family (counterpart of
``ssp_x_vit_tpu/llm/model.py``).

Same pruning-native design as the ViT (``models/vit.py``): stacked ``[L, ...]``
block parameters in a plain dict, a Python loop over layers, and runtime
``attn_gate`` / ``mlp_gate`` / ``neuron_mask`` arguments so the stage-2 greedy
search and blockpruner evaluate every candidate on the same forward; width
pruning materializes once by gather.

Architectures: llama / mistral (sliding window) / qwen2 (``qkv_bias``) / qwen3
(``qk_norm``) / gemma (``gelu_tanh``, scaled embeddings, explicit head_dim) /
gemma2 (post-norms, softcaps, mixed per-layer windows) share the pre-RMSNorm
GLU block; ``phi`` is the parallel-residual LayerNorm + GELU block with partial
rotary; ``opt`` the sequential LayerNorm block with learned positions and a
ReLU MLP. ``num_experts > 0`` (mixtral, qwen3_moe) replaces the llama-layout
MLP with the dropless mixture of experts of ``parallel/moe.py``: a router
``[L, d, E]`` and expert stacks ``[L, E, d, f]`` / ``[L, E, f, d]``, each
layer's switch load-balance loss returned as ``moe_aux_loss``. The
DeepSeek/MLA family is ``llm/deepseek.py``.

The large projections are ``torch.matmul`` (quantized ones go through
``ops.common.mm_quant``); attention goes to the hand-written flash kernel for
a CUDA tensor and to ``sdpa_reference`` for a CPU tensor, decided by the
tensor alone. The layer loop is a Python loop, so gemma-2's per-layer windows
are static and take the kernel too.

Tensor parallelism (``tp_group``; shards from ``parallel/llm_sharding.py``)
is Megatron's split with the collectives written here, where the math needs
them (``parallel/collectives.py``): the normalized activation enters the
column-parallel q/k/v and gate/up (and the vocab-sharded lm_head) through
``copy_to_tp``; the row-parallel o and down/fc2 products are summed over the
group before their bias and before gemma-2's post-norms; a rank's head counts
come from its weights' widths, not from ``cfg``. ``gather_layer`` (fully
sharded training) maps a layer's local shards to its full weights inside the
layer body, so a checkpointed layer gathers again in its backward.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ssp_x_vit_tpu_torch.device import DeviceLike, resolve_device
from ssp_x_vit_tpu_torch.llm.rope import RopeScaling, rope_freqs
from ssp_x_vit_tpu_torch.ops.attention import flash_attention
from ssp_x_vit_tpu_torch.ops.common import gelu, mm_quant, pick_param_variants
from ssp_x_vit_tpu_torch.parallel.collectives import copy_to_tp, gather_from_tp, reduce_from_tp

Params = Dict[str, Any]

@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    intermediate_size: int = 11008
    rms_eps: float = 1e-5
    rope_theta: float = 10000.0
    # HF rope_scaling (llama-3.1 "llama3", YaRN, linear) as a frozen
    # RopeScaling (llm/rope.py). None = vanilla RoPE.
    rope_scaling: Optional[RopeScaling] = None
    tie_embeddings: bool = False
    # llama | mistral | qwen2 | qwen3 | gemma | gemma2 share the pre-RMSNorm
    # GLU block; "phi" selects the parallel-residual LayerNorm+GELU block;
    # "opt" the sequential LayerNorm block with learned positions + ReLU MLP.
    model_type: str = "llama"
    # Sliding-window attention (mistral): each position attends the most
    # recent `sliding_window` keys including itself. None = full causal.
    sliding_window: Optional[int] = None
    qkv_bias: bool = False     # qwen2/phi/opt use attention biases
    # phi-2 specifics
    rotary_dim: Optional[int] = None   # partial rotary (e.g. 32 of head_dim 80)
    layer_norm_eps: float = 1e-5       # phi/opt use LayerNorm (with bias)
    # opt specifics
    max_position_embeddings: int = 2048  # learned positional table size
    # MoE (mixtral-style FFN; llama layout only). 0 = dense MLP.
    num_experts: int = 0
    expert_capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    moe_top_k: int = 1
    # gemma specifics (usable by any llama-layout config)
    explicit_head_dim: Optional[int] = None  # gemma-7b: 256 != hidden/heads
    hidden_act: str = "silu"                 # "gelu_tanh" for gemma GLU
    scale_embeddings: bool = False           # x *= sqrt(hidden_size)
    # Mixed attention: indices of layers the sliding window applies to
    # (None = all layers when sliding_window is set). gemma-2: even layers.
    window_layers: Optional[Tuple[int, ...]] = None
    # gemma-2 softcaps: logits <- cap * tanh(logits / cap)
    attn_softcap: Optional[float] = None     # attention logits (50.0)
    final_softcap: Optional[float] = None    # lm_head logits (30.0)
    # qwen3: per-head RMSNorm on q/k (over head_dim, rms_eps) after the
    # projections, before rope. Params q_norm/k_norm [L, head_dim].
    qk_norm: bool = False
    # --- materialized-pruning state ---
    # Uniform kept intermediate size after 2SSP stage-1.
    pruned_intermediate_size: Optional[int] = None
    pruned_attention_blocks: Tuple[int, ...] = ()

    @property
    def is_phi(self) -> bool:
        return self.model_type == "phi"

    @property
    def is_opt(self) -> bool:
        return self.model_type == "opt"

    @property
    def is_gemma2(self) -> bool:
        return self.model_type == "gemma2"

    @property
    def uniform_window(self) -> bool:
        """True when every layer shares one (possibly absent) window."""
        return self.sliding_window is None or self.window_layers is None

    def layer_window(self, i: int) -> Optional[int]:
        """The sliding window of layer ``i`` (None = full causal)."""
        if self.uniform_window:
            return self.sliding_window
        return self.sliding_window if i in self.window_layers else None

    @property
    def head_dim(self) -> int:
        if self.explicit_head_dim is not None:
            return self.explicit_head_dim
        return self.hidden_size // self.num_heads

    @property
    def effective_intermediate(self) -> int:
        return self.pruned_intermediate_size or self.intermediate_size

    @property
    def attn_store_index(self) -> Tuple[Optional[int], ...]:
        idx, j = [], 0
        for i in range(self.num_layers):
            if i in self.pruned_attention_blocks:
                idx.append(None)
            else:
                idx.append(j)
                j += 1
        return tuple(idx)


def require_llama_config(cfg) -> None:
    """The llama-family entry points take a ``LlamaConfig``. DeepSeek/MLA
    models run through ``llm/deepseek.py``, ``llm/paged_mla.py`` and the
    family-generic entry points (evaluation, pruning, generation, training)."""
    if not isinstance(cfg, LlamaConfig):
        raise TypeError(
            f"this entry point takes a LlamaConfig, got {type(cfg).__name__}: DeepSeek/MLA "
            "models run through llm/deepseek.py, llm/paged_mla.py and the family-generic "
            "entry points")


def _glu_act(cfg: LlamaConfig):
    """GLU gate activation: silu (llama/mistral/qwen) or tanh-approx gelu (gemma)."""
    if cfg.hidden_act == "silu":
        return F.silu
    if cfg.hidden_act == "gelu_tanh":
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(f"unsupported hidden_act {cfg.hidden_act}")


def _embed_tokens(params: Params, input_ids: torch.Tensor, cfg: LlamaConfig, compute_dtype):
    """Token embedding lookup; gemma scales by sqrt(hidden_size) with the
    normalizer rounded to the compute dtype (as HF GemmaModel does)."""
    # F.embedding: its backward on the card sums rows deterministically
    x = F.embedding(input_ids, params["embed"]).to(compute_dtype)
    if cfg.scale_embeddings:
        x = x * torch.tensor(cfg.hidden_size ** 0.5, dtype=compute_dtype, device=x.device)
    return x


def init_llama_params(gen: Optional[torch.Generator], cfg: LlamaConfig,
                      dtype=torch.float32, device: DeviceLike = None) -> Params:
    """Random parameters (normal, std 0.02; norms at one, biases at zero) made
    on ``device`` (``cuda`` by default) from ``gen``, a generator on that
    device (None: a fresh one seeded with 0). Each leaf is drawn in float32
    and cast, one leaf at a time, so a full-size model never exists on the
    host."""
    dev = resolve_device(device)
    if gen is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
    d, f, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    hq = cfg.num_heads * cfg.head_dim
    hkv = cfg.num_kv_heads * cfg.head_dim

    def nrm(*shape, std=0.02):
        if len(shape) >= 3:  # stacked kernels: one layer at a time bounds the fp32 temporary
            out = torch.empty(shape, dtype=dtype, device=dev)
            for i in range(shape[0]):
                out[i] = torch.randn(shape[1:], generator=gen, device=dev) * std
            return out
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    if cfg.is_opt or cfg.is_phi:
        params: Params = {"embed": nrm(cfg.vocab_size, d)}
        if cfg.is_opt:
            params["pos_embed"] = nrm(cfg.max_position_embeddings + 2, d)
        blocks = {
            "ln1": ones(L, d), "ln1_bias": zeros(L, d),
            "q_kernel": nrm(L, d, hq), "q_bias": zeros(L, hq),
            "k_kernel": nrm(L, d, hkv), "k_bias": zeros(L, hkv),
            "v_kernel": nrm(L, d, hkv), "v_bias": zeros(L, hkv),
            "o_kernel": nrm(L, hq, d), "o_bias": zeros(L, d),
        }
        if cfg.is_opt:
            blocks.update({"ln2": ones(L, d), "ln2_bias": zeros(L, d)})
        blocks.update({
            "fc1_kernel": nrm(L, d, f), "fc1_bias": zeros(L, f),
            "fc2_kernel": nrm(L, f, d), "fc2_bias": zeros(L, d),
        })
        params["blocks"] = blocks
        params["ln_final"] = ones(d)
        params["ln_final_bias"] = zeros(d)
        if cfg.is_phi:
            params["lm_head"] = nrm(d, cfg.vocab_size)
            params["lm_head_bias"] = zeros(cfg.vocab_size)
        elif not cfg.tie_embeddings:
            params["lm_head"] = nrm(d, cfg.vocab_size)
        return params

    params = {
        "embed": nrm(cfg.vocab_size, d),
        "blocks": {
            "ln1": ones(L, d),
            "q_kernel": nrm(L, d, hq),
            "k_kernel": nrm(L, d, hkv),
            "v_kernel": nrm(L, d, hkv),
            "o_kernel": nrm(L, hq, d),
            "ln2": ones(L, d),
        },
        "ln_final": ones(d),
    }
    blocks = params["blocks"]
    if cfg.num_experts:
        # the per-layer slices are parallel/moe.py's parameters
        E = cfg.num_experts
        blocks.update({"router": nrm(L, d, E), "gate_kernel": nrm(L, E, d, f),
                       "up_kernel": nrm(L, E, d, f), "down_kernel": nrm(L, E, f, d)})
    else:
        blocks.update({"gate_kernel": nrm(L, d, f), "up_kernel": nrm(L, d, f),
                       "down_kernel": nrm(L, f, d)})
    if cfg.is_gemma2:
        blocks["ln1_post"] = ones(L, d)
        blocks["ln2_post"] = ones(L, d)
    if cfg.qkv_bias:
        blocks["q_bias"] = zeros(L, hq)
        blocks["k_bias"] = zeros(L, hkv)
        blocks["v_bias"] = zeros(L, hkv)
    if cfg.qk_norm:
        blocks["q_norm"] = ones(L, cfg.head_dim)
        blocks["k_norm"] = ones(L, cfg.head_dim)
    if not cfg.tie_embeddings:
        params["lm_head"] = nrm(d, cfg.vocab_size)
    return params


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def rope_tables(s: int, cfg: LlamaConfig, device: torch.device, start: int = 0
                ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """cos/sin ``[1, 1, s, rd]`` in fp32 for positions ``start .. start + s - 1``
    (``rd`` = the rotary dims: ``rotary_dim`` under partial rotary, else
    head_dim), with any ``rope_scaling`` correction (llm/rope.py). None for
    OPT, which has no rope. A forward makes them once and hands them to every
    layer; a sequence-parallel rank makes them at its chunk's global positions."""
    if cfg.is_opt:
        return None
    hd = cfg.head_dim
    rd = cfg.rotary_dim if cfg.rotary_dim is not None and cfg.rotary_dim < hd else hd
    inv_freq_np, attn_scale = rope_freqs(cfg.rope_theta, rd, cfg.rope_scaling)
    inv_freq = torch.from_numpy(inv_freq_np).to(device)
    pos = torch.arange(start, start + s, dtype=torch.float32, device=device)
    freqs = torch.outer(pos, inv_freq)                 # [s, rd/2]
    emb = torch.cat([freqs, freqs], dim=-1)            # [s, rd]
    return ((torch.cos(emb) * attn_scale)[None, None], (torch.sin(emb) * attn_scale)[None, None])


def _rope(q: torch.Tensor, k: torch.Tensor,
          tables: Tuple[torch.Tensor, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotary embeddings, HF half-rotation layout. q/k: [b, h, s, rd] (already
    sliced to the rotary dims for partial rotary); ``tables`` from :func:`rope_tables`."""
    cos, sin = tables

    def rotate_half(x):
        x1, x2 = x.chunk(2, dim=-1)
        return torch.cat([-x2, x1], dim=-1)

    q32, k32 = q.float(), k.float()
    q_out = q32 * cos + rotate_half(q32) * sin
    k_out = k32 * cos + rotate_half(k32) * sin
    return q_out.to(q.dtype), k_out.to(k.dtype)


def _mm(x, bp, name, compute_dtype):
    """Quantization-aware projection matmul (``ops.common.mm_quant``)."""
    return mm_quant(x, bp, name, compute_dtype)


def _row_parallel(h, bp, name, compute_dtype, tp=None):
    """A row-parallel projection: this rank's columns of ``h`` times its rows of
    the kernel, summed over the group here, BEFORE any bias is added (a bias
    added on every rank would count tp times). An int4 row layer stays
    replicated (its split-half nibble packing interleaves K rows, so its rows
    cannot be split): it all-gathers its input and reduces nothing."""
    if tp is None:
        return _mm(h, bp, name, compute_dtype)
    if name + "_q4" in bp:
        return _mm(gather_from_tp(h, tp), bp, name, compute_dtype)
    return reduce_from_tp(_mm(h, bp, name, compute_dtype), tp)


def _attention(x, bp, cfg: LlamaConfig, compute_dtype, window: Optional[int], rope, tp=None,
               attn_core=None):
    """Causal self attention of one layer; ``window`` is that layer's static
    sliding window (None = full causal), ``rope`` the forward's cos/sin tables,
    ``tp`` the tensor-parallel group of a sharded layer. ``attn_core(q, k, v,
    window)`` replaces the flash call on roped q / k / v (the sequence-parallel
    ring)."""
    b, s, d = x.shape
    hd = cfg.head_dim
    x = copy_to_tp(x, tp)

    q = _mm(x, bp, "q_kernel", compute_dtype)
    k = _mm(x, bp, "k_kernel", compute_dtype)
    v = _mm(x, bp, "v_kernel", compute_dtype)
    if "q_bias" in bp:
        q = q + bp["q_bias"].to(compute_dtype)
        k = k + bp["k_bias"].to(compute_dtype)
        v = v + bp["v_bias"].to(compute_dtype)

    # this rank's heads, from the weights' widths (cfg's counts without tp)
    nq, nkv = q.shape[-1] // hd, k.shape[-1] // hd
    q = q.reshape(b, s, nq, hd).permute(0, 2, 1, 3)
    k = k.reshape(b, s, nkv, hd).permute(0, 2, 1, 3)
    v = v.reshape(b, s, nkv, hd).permute(0, 2, 1, 3)
    if cfg.qk_norm:
        # qwen3: per-head RMSNorm over head_dim before rope
        q = rms_norm(q, bp["q_norm"], cfg.rms_eps)
        k = rms_norm(k, bp["k_norm"], cfg.rms_eps)
    if rope is not None:  # OPT uses learned absolute positions at the embedding instead
        rd = rope[0].shape[-1]
        if rd < hd:
            # phi partial rotary: rotate the first rotary_dim dims, pass the rest
            q_rot, k_rot = _rope(q[..., :rd], k[..., :rd], rope)
            q = torch.cat([q_rot, q[..., rd:]], dim=-1)
            k = torch.cat([k_rot, k[..., rd:]], dim=-1)
        else:
            q, k = _rope(q, k, rope)

    # GQA-native: K/V stay at nkv heads (the plain version repeats them itself)
    if attn_core is not None:
        out = attn_core(q.contiguous(), k.contiguous(), v.contiguous(), window)
    else:
        out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=True,
                              window=window, softcap=cfg.attn_softcap)
    out = out.permute(0, 2, 1, 3).reshape(b, s, nq * hd)
    out = _row_parallel(out, bp, "o_kernel", compute_dtype, tp)
    if "o_bias" in bp:
        out = out + bp["o_bias"].to(compute_dtype)
    return out


def _token_stats(h: torch.Tensor, stats_kind: str) -> torch.Tensor:
    h32 = h.float()
    return (h32.square() if stats_kind == "sumsq" else h32.abs()).sum(dim=1)


def _phi_mlp(x, bp, compute_dtype, neuron_mask, collect_stats, stats_kind="sumsq", act="gelu",
             tp=None):
    """fc1 -> activation -> fc2 MLP (phi-2: exact GELU; OPT: ReLU); the stats
    observe the fc2 input."""
    h = _mm(copy_to_tp(x, tp), bp, "fc1_kernel", compute_dtype) + bp["fc1_bias"].to(compute_dtype)
    h = torch.relu(h) if act == "relu" else gelu(h)
    stats = _token_stats(h, stats_kind) if collect_stats else None
    if neuron_mask is not None:
        h = h * neuron_mask.to(h.dtype)
    out = _row_parallel(h, bp, "fc2_kernel", compute_dtype, tp)
    return out + bp["fc2_bias"].to(compute_dtype), stats


def _layer_norm(x, scale, bias, eps):
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def _moe_mlp(x, bp, cfg: LlamaConfig, compute_dtype, group=None):
    """The mixture-of-experts block MLP: the dropless formulation of
    ``parallel/moe.py`` (every token through its routed experts, no capacity
    overflow), so a cached decode equals the full forward. The layer's slice
    holds the router and the expert stacks (float, ``_q`` or ``_q4`` with
    ``_scale``). ``group``: the tensor-parallel group of a ``model`` shard (the
    experts' f axis cut) or the expert group of an ``expert`` shard (whole
    experts); each rank's share is summed over it. Returns (output, the
    layer's switch load-balance loss)."""
    from ssp_x_vit_tpu_torch.parallel.moe import MoEConfig, moe_ffn_dropless

    mcfg = MoEConfig(cfg.hidden_size, cfg.intermediate_size, cfg.num_experts,
                     cfg.expert_capacity_factor, top_k=cfg.moe_top_k)
    p = {k: v for k, v in bp.items() if k == "router" or k.startswith(
        ("gate_kernel", "up_kernel", "down_kernel"))}
    y, aux = moe_ffn_dropless(p, x.to(compute_dtype), mcfg, group=group)
    return y.to(compute_dtype), aux["aux_loss"]


def _mlp(x, bp, compute_dtype, neuron_mask, collect_stats, stats_kind="sumsq", act=F.silu,
         tp=None):
    x = copy_to_tp(x, tp)
    g = _mm(x, bp, "gate_kernel", compute_dtype)
    u = _mm(x, bp, "up_kernel", compute_dtype)
    h = act(g) * u  # the down_proj input the 2SSP stage-1 statistic observes
    # "sumsq" feeds the token-L2 importance (2SSP); "sumabs" the L1 variant
    stats = _token_stats(h, stats_kind) if collect_stats else None
    if neuron_mask is not None:
        h = h * neuron_mask.to(h.dtype)
    return _row_parallel(h, bp, "down_kernel", compute_dtype, tp), stats


def _head_logits(params, x, compute_dtype, final_softcap=None, tp=None):
    """Final lm_head projection -> fp32 logits: tied-embedding fallback,
    int8/int4 heads via ``_mm``, optional bias, gemma-2 final soft-capping.
    Under ``tp`` an untied head is vocab-sharded: every rank gathers the full
    logits before the softcap, so the group holds the same bytes (a tied head
    is the replicated embedding and needs nothing)."""
    untied = any(k in params for k in ("lm_head", "lm_head_q", "lm_head_q4"))
    sharded = tp is not None and untied
    if untied:
        logits = _mm(copy_to_tp(x, tp) if sharded else x, params, "lm_head", compute_dtype).float()
    else:
        logits = (x @ params["embed"].t().to(compute_dtype)).float()
    if "lm_head_bias" in params:
        logits = logits + params["lm_head_bias"].float()
    if sharded:
        logits = gather_from_tp(logits, tp)
    if final_softcap is not None:
        logits = final_softcap * torch.tanh(logits / final_softcap)
    return logits


def _final_norm(params, x, cfg):
    if cfg.is_phi or cfg.is_opt:
        return _layer_norm(x, params["ln_final"], params["ln_final_bias"], cfg.layer_norm_eps)
    return rms_norm(x, params["ln_final"], cfg.rms_eps)


def _embed(params, input_ids, cfg, compute_dtype):
    x = _embed_tokens(params, input_ids, cfg, compute_dtype)
    if cfg.is_opt:
        # learned absolute positions, HF offset of 2 (OPTLearnedPositionalEmbedding)
        pos = 2 + torch.arange(input_ids.shape[1], device=input_ids.device)
        x = x + F.embedding(pos, params["pos_embed"]).to(compute_dtype)[None]
    return x


def _gate(gates: Optional[torch.Tensor], i: int, x: torch.Tensor):
    """Gate of layer ``i`` in x's dtype: a scalar, or [C, 1, 1] for a batch of
    candidates; None when every gate is 1."""
    return None if gates is None else gates[i].to(x.dtype)


def _gated(branch: torch.Tensor, gate: Optional[torch.Tensor]) -> torch.Tensor:
    return branch if gate is None else branch * gate


def _llama_layer(x, bp, i, cfg: LlamaConfig, compute_dtype, rope, ga, gm, nm,
                 collect_mlp_stats: bool, mlp_stats_kind: str, tp=None, gather_layer=None,
                 attn_core=None, expert_group=None):
    """One block of ``llama_forward``: (x out, MLP stats or None, MLP input, MLP
    output before gemma-2's post-norm, the MoE load-balance loss or None).
    ``i`` is the global layer index (its window); ``attn_core`` replaces the
    flash call (``_attention``); ``expert_group`` sums an expert shard's MoE."""
    if gather_layer is not None:
        bp = gather_layer(bp)
    if cfg.is_phi:
        # phi-2 parallel residual: one LayerNorm feeds both branches; under tp
        # each branch's row-parallel sum is reduced before its bias
        h = _layer_norm(x, bp["ln1"], bp["ln1_bias"], cfg.layer_norm_eps)
        attn_out = _attention(h, bp, cfg, compute_dtype, cfg.layer_window(i), rope, tp,
                              attn_core)
        mlp_out, stats = _phi_mlp(h, bp, compute_dtype, nm, collect_mlp_stats, mlp_stats_kind,
                                  tp=tp)
        return x + _gated(attn_out, ga) + _gated(mlp_out, gm), stats, h, mlp_out, None
    if cfg.is_opt:
        h = _layer_norm(x, bp["ln1"], bp["ln1_bias"], cfg.layer_norm_eps)
    else:
        h = rms_norm(x, bp["ln1"], cfg.rms_eps)
    attn_out = _attention(h, bp, cfg, compute_dtype, cfg.layer_window(i), rope, tp, attn_core)
    if cfg.is_gemma2:
        # gemma-2 post-norms: the residual deltas are RMS-normalized before the adds
        # (under tp on the reduced sums)
        attn_out = rms_norm(attn_out, bp["ln1_post"], cfg.rms_eps)
    x = x + _gated(attn_out, ga)
    moe_loss = None
    if cfg.is_opt:
        mlp_in = _layer_norm(x, bp["ln2"], bp["ln2_bias"], cfg.layer_norm_eps)
        mlp_out, stats = _phi_mlp(mlp_in, bp, compute_dtype, nm, collect_mlp_stats,
                                  mlp_stats_kind, act="relu", tp=tp)
    elif cfg.num_experts:
        mlp_in = rms_norm(x, bp["ln2"], cfg.rms_eps)
        mlp_out, moe_loss = _moe_mlp(mlp_in, bp, cfg, compute_dtype,
                                     tp if tp is not None else expert_group)
        stats = None
    else:
        mlp_in = rms_norm(x, bp["ln2"], cfg.rms_eps)
        mlp_out, stats = _mlp(mlp_in, bp, compute_dtype, nm, collect_mlp_stats,
                              mlp_stats_kind, act=_glu_act(cfg), tp=tp)
    post = rms_norm(mlp_out, bp["ln2_post"], cfg.rms_eps) if cfg.is_gemma2 else mlp_out
    return x + _gated(post, gm), stats, mlp_in, mlp_out, moe_loss


def llama_forward(
    params: Params,
    input_ids: torch.Tensor,
    cfg: LlamaConfig,
    *,
    attn_gate: Optional[torch.Tensor] = None,
    mlp_gate: Optional[torch.Tensor] = None,
    neuron_mask: Optional[torch.Tensor] = None,
    collect_mlp_stats: bool = False,
    mlp_stats_kind: str = "sumsq",
    collect_mlp_io_stats: bool = False,
    return_block_outputs: bool = False,
    compute_dtype=torch.bfloat16,
    remat: bool = False,
    tp_group=None,
    gather_layer=None,
    expert_group=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """input_ids [b, s] -> (logits [b, s, V] fp32, aux).

    ``attn_gate`` / ``mlp_gate`` are ``[L]`` (one gate per layer) or
    ``[L, b, 1, 1]`` (one per layer and batch row: a batch of skip-pattern
    candidates over the same tokens); ``neuron_mask`` is ``[L, f]`` or
    ``[L, 1]``. ``collect_mlp_stats`` returns the per-block, per-sample token
    sum of squares (``"sumabs"``: of magnitudes) of the down_proj input,
    ``[L, b, f]`` fp32: the 2SSP stage-1 statistic. ``collect_mlp_io_stats``
    adds the sums of squares of the MLP's input and output hidden dims;
    ``return_block_outputs`` each block's output hidden states ``[L, b, s, d]``.
    MoE configs add each layer's switch load-balance loss, ``moe_aux_loss``
    ``[L]`` fp32, and take no neuron mask or MLP statistics (ValueError).

    ``params["blocks"]`` leaves are stacked ``[L, ...]`` tensors or lists of
    per-layer tensors (the train step's per-layer leaves). ``remat=True``
    (training under autograd) checkpoints each layer
    (``torch.utils.checkpoint``, non-reentrant): the backward recomputes the
    layer's forward, flash kernel included, instead of keeping its
    activations; it takes no MLP statistics or block outputs (an MoE layer's
    load-balance loss comes out of the checkpointed layer beside its output).

    ``tp_group``: the tensor-parallel group of a ``shard_llama_params`` shard
    (dense float, int8 or int4 trees, and MoE trees with float or int8 experts
    cut on their f axis; the full logits come back on every rank); it takes no
    neuron mask or MLP statistics. ``expert_group``: the expert group of a
    ``shard_moe_llama_params`` shard (whole experts per rank, summed over the
    group). ``gather_layer``:
    a function from a layer's parameter dict to the one the layer runs
    (fully sharded training's all-gather), called inside the layer body.
    """
    if cfg.pruned_attention_blocks:
        raise ValueError("use llama_forward_materialized for depth-materialized configs")
    if cfg.num_experts:
        if cfg.is_phi or cfg.is_opt:
            raise ValueError("MoE is supported on the llama block layout only")
        if collect_mlp_stats or collect_mlp_io_stats or neuron_mask is not None:
            raise ValueError(
                "2SSP width instrumentation targets dense MLPs; MoE configs "
                "route tokens per-expert and do not support neuron masks/stats")
    if remat and (collect_mlp_stats or collect_mlp_io_stats or return_block_outputs):
        raise ValueError("remat=True takes no aux outputs")
    if tp_group is not None and (collect_mlp_stats or collect_mlp_io_stats
                                 or neuron_mask is not None):
        raise ValueError("tensor parallelism takes no neuron mask or MLP statistics")
    if tp_group is not None and expert_group is not None:
        raise ValueError("a tree is sharded over model or over expert, not both")
    x = _embed(params, input_ids, cfg, compute_dtype)
    rope = rope_tables(input_ids.shape[1], cfg, x.device)
    blocks = params["blocks"]
    aux: Dict[str, list] = {}

    def record(key, value):
        aux.setdefault(key, []).append(value)

    for i in range(cfg.num_layers):
        bp = {k: v[i] for k, v in blocks.items()}
        ga, gm = _gate(attn_gate, i, x), _gate(mlp_gate, i, x)
        nm = None if neuron_mask is None else neuron_mask[i]
        if remat:
            x, moe_loss = checkpoint(
                lambda x_, bp=bp, i=i, ga=ga, gm=gm, nm=nm: _llama_layer(
                    x_, bp, i, cfg, compute_dtype, rope, ga, gm, nm, False,
                    mlp_stats_kind, tp_group, gather_layer, expert_group=expert_group)[::4],
                x, use_reentrant=False, preserve_rng_state=False)
            if moe_loss is not None:
                record("moe_aux_loss", moe_loss)
            continue
        x, stats, mlp_in, mlp_out, moe_loss = _llama_layer(
            x, bp, i, cfg, compute_dtype, rope, ga, gm, nm, collect_mlp_stats, mlp_stats_kind,
            tp_group, gather_layer, expert_group=expert_group)
        if moe_loss is not None:
            record("moe_aux_loss", moe_loss)
        if collect_mlp_stats:
            record("mlp_stats", stats)
        if collect_mlp_io_stats:
            # taken before gemma-2's post-norm, as the JAX package takes them
            record("mlp_in_stats", mlp_in.float().square().sum(dim=1))
            record("mlp_out_stats", mlp_out.float().square().sum(dim=1))
        if return_block_outputs:
            record("block_outputs", x)

    x = _final_norm(params, x, cfg)
    logits = _head_logits(params, x, compute_dtype, cfg.final_softcap, tp_group)
    return logits, {k: torch.stack(v) for k, v in aux.items()}


def llama_forward_materialized(
    params: Params,
    input_ids: torch.Tensor,
    cfg: LlamaConfig,
    *,
    compute_dtype=torch.bfloat16,
) -> torch.Tensor:
    """Forward for depth-materialized models: the attention weights of pruned
    blocks are physically absent and the stacked attention leaves are indexed
    by the compacted attention index (cf. ``vit_forward_materialized``)."""
    if cfg.num_experts:
        raise ValueError(
            "MoE configs do not support depth materialization (2SSP depth "
            "pruning targets the dense block layout); this guard prevents "
            "the 4-D expert kernels from silently broadcasting through the "
            "dense _mlp contraction")
    x = _embed(params, input_ids, cfg, compute_dtype)
    rope = rope_tables(input_ids.shape[1], cfg, x.device)
    blocks = params["blocks"]
    store = cfg.attn_store_index
    attn_bases = ("q_kernel", "k_kernel", "v_kernel", "o_kernel")

    for i in range(cfg.num_layers):
        j = store[i]
        if cfg.is_opt or cfg.is_phi:
            mp = pick_param_variants(blocks, ("fc1_kernel", "fc2_kernel"), i)
            mp["fc1_bias"], mp["fc2_bias"] = blocks["fc1_bias"][i], blocks["fc2_bias"][i]
            bp = None
            if j is not None:
                bp = pick_param_variants(blocks, attn_bases, j)
                for k in ("q_bias", "k_bias", "v_bias", "o_bias"):
                    if k in blocks:
                        bp[k] = blocks[k][j]
            if cfg.is_opt:
                # attention (incl. its pre-LN) removable; the MLP block always present
                if j is not None:
                    h = _layer_norm(x, blocks["ln1"][j], blocks["ln1_bias"][j],
                                    cfg.layer_norm_eps)
                    x = x + _attention(h, bp, cfg, compute_dtype, cfg.layer_window(i), rope)
                mlp_in = _layer_norm(x, blocks["ln2"][i], blocks["ln2_bias"][i],
                                     cfg.layer_norm_eps)
                mlp_out, _ = _phi_mlp(mlp_in, mp, compute_dtype, None, False, act="relu")
                x = x + mlp_out
            else:
                # phi's ln1 feeds both branches, so it is indexed by the full
                # layer index and never removed with the attention
                h = _layer_norm(x, blocks["ln1"][i], blocks["ln1_bias"][i], cfg.layer_norm_eps)
                mlp_out, _ = _phi_mlp(h, mp, compute_dtype, None, False)
                if j is not None:
                    x = x + _attention(h, bp, cfg, compute_dtype, cfg.layer_window(i), rope) + mlp_out
                else:
                    x = x + mlp_out
            continue
        if j is not None:
            bp = pick_param_variants(blocks, attn_bases, j)
            for k in ("q_bias", "k_bias", "v_bias", "q_norm", "k_norm"):
                if k in blocks:
                    bp[k] = blocks[k][j]
            attn_out = _attention(rms_norm(x, blocks["ln1"][j], cfg.rms_eps), bp, cfg,
                                  compute_dtype, cfg.layer_window(i), rope)
            if cfg.is_gemma2:
                attn_out = rms_norm(attn_out, blocks["ln1_post"][j], cfg.rms_eps)
            x = x + attn_out
        mp = pick_param_variants(blocks, ("gate_kernel", "up_kernel", "down_kernel"), i)
        mlp_out, _ = _mlp(rms_norm(x, blocks["ln2"][i], cfg.rms_eps), mp, compute_dtype,
                          None, False, act=_glu_act(cfg))
        if cfg.is_gemma2:
            mlp_out = rms_norm(mlp_out, blocks["ln2_post"][i], cfg.rms_eps)
        x = x + mlp_out

    x = _final_norm(params, x, cfg)
    return _head_logits(params, x, compute_dtype, cfg.final_softcap)
