"""KV-cached autoregressive decoding over a contiguous cache (counterpart of
``ssp_x_vit_tpu/llm/serve.py``).

The cache is ``[A, b, max_len, nkv, hd]`` per K and V (``A`` = surviving
attention layers; ``torch.int8`` makes the quantized cache ``{"q": int8 codes,
"s": fp32 per-token-per-head scales}``). Prompts are LEFT-padded to a shared
length: every row writes at one global position, per-row rotary positions
subtract the pad length, and the attention mask drops the pad slots. The
rolling cache of sliding-window models keeps ``sliding_window`` slots (slot =
position mod window).

Differences from the JAX package, by design: the layer loop is a Python loop
with host-integer layer indices (gemma-2's mixed windows are static per
layer); caches are written in place (a slice ``copy_`` into the layer's rows at a
host-integer offset, ``index_copy_`` at a decode step's tensor position) and every
function that takes caches returns the objects it was given; the decode loops
are Python loops whose tokens stay on the device and are copied to the host
once at the end (``decode_while`` reads one flag back every
``DECODE_WHILE_SYNC_EVERY`` steps); a decode step's position becomes a 0-d
tensor on the device and is read there only, so ``decode_step`` also takes
one (the decode artifact of ``llm/aot.py`` takes it as an input). The int8 SwiGLU MLP
of unpacked int8 llama trees goes through the hand-written ``fused_mlp_int8``
kernel (its plain version for CPU tensors); everything else here is plain
PyTorch ops, as the JAX package leaves it to XLA. Everything runs under ``torch.no_grad()``.
MoE configs take the dropless expert MLP of ``llm/model.py`` (``_moe_mlp``):
it holds no cache state, so a cached decode equals the full forward; their
4-D expert stacks stay out of ``fused_mlp_int8`` and out of the packed
``gateup_kernel``, as in the JAX package.

Also kept here for the paged path: the prompt buckets, rotary embedding at
per-sequence positions, the QKV projection of one block, the final norm + lm
head, ``split_layers`` and ``pack_llm_params_for_serving``. Multi-LoRA: a
tree with a bank attached (``llm/multilora.py``) serves one adapter per row,
chosen by ``lora_ids [b]`` (0 = the base model), on every cache kind; the
deltas ride the attention projections as plain ops, as in the JAX package, and
the generation entry points gather each row's bank slices once
(``multilora.gather_lora_rows``) instead of at every step. The paged servers
take no ``lora_ids``, as in the JAX package. DeepSeek/MLA generation is
``llm/deepseek.py`` (``deepseek_generate``).
Ahead-of-time artifacts of ``prefill`` and ``decode_step`` (``torch.export``)
are ``llm/aot.py``.

Tensor-parallel serving (``tp_group``, ``parallel/llm_sharding.py``): each
rank holds its heads of q/k/v (a packed ``qkv_kernel`` holds
``[q_r | k_r | v_r]``), its KV-cache heads and its columns of gate/up; the
o and down products are summed over the group before their bias (an int4
down projection is replicated and gathers its input instead), the
unpacked int8 MLP runs ``fused_mlp_int8`` on the rank's columns and is summed
after, and the vocab-sharded logits are gathered before sampling, so every
rank picks the same token.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ssp_x_vit_tpu_torch.device import DeviceLike, resolve_device
from ssp_x_vit_tpu_torch.llm.model import (
    LlamaConfig, Params, _embed_tokens, _glu_act, _layer_norm, _mm, _moe_mlp, _row_parallel,
    require_llama_config, rms_norm,
)
from ssp_x_vit_tpu_torch.llm.multilora import LORA_SUFFIX_A, gather_lora_rows, lora_delta
from ssp_x_vit_tpu_torch.llm.rope import rope_freqs
from ssp_x_vit_tpu_torch.llm.sampling import (
    SamplerState, SamplingParams, init_sampler_state, slot_state_row, vectorized_sample,
)
from ssp_x_vit_tpu_torch.ops import dispatch
from ssp_x_vit_tpu_torch.ops.common import gelu
from ssp_x_vit_tpu_torch.ops.kernels.paged_attention import quantize_token_kv
from ssp_x_vit_tpu_torch.ops.kernels.quant_fused_mlp import fused_mlp_int8
from ssp_x_vit_tpu_torch.parallel.collectives import gather_from_tp, reduce_from_tp

PROMPT_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048)

# Band bound of the full-attention layers of a mixed-window config: farther
# than any position distance (the JAX package's LlamaConfig._FULL_BOUND role).
_FULL_BOUND = 1 << 30
_NEG_INF = torch.finfo(torch.float32).min
# decode_while reads its all-done flag back to the host every this many steps
DECODE_WHILE_SYNC_EVERY = 8

# One layer's parameters and the cache row its attention owns (None: the
# attention of this block was pruned away).
Layer = Tuple[Params, Optional[int]]
# A decode position: a host integer, or a 0-d int64 tensor on the device
# (``llm/aot.py``'s decode artifact takes it as an input).
Position = Union[int, torch.Tensor]


def bucket_prompt_pad(n: int, buckets: Sequence[int] = PROMPT_BUCKETS) -> int:
    """Smallest bucket >= n (rounding up to a multiple of 128 past the table).
    Eager PyTorch compiles nothing per shape, so the paged servers do not pad
    prompts; the contiguous path pads batched prompts to a bucket as the JAX
    package does, so both run the same shapes."""
    for b in buckets:
        if n <= b:
            return b
    return -(-n // 128) * 128


@functools.lru_cache(maxsize=32)
def _inv_freq_cached(theta: float, rd: int, scaling, device: torch.device
                     ) -> Tuple[torch.Tensor, float]:
    inv_freq_np, attn_scale = rope_freqs(theta, rd, scaling)
    return torch.from_numpy(inv_freq_np).to(device), attn_scale


def _inv_freq(theta: float, rd: int, scaling, device: torch.device) -> Tuple[torch.Tensor, float]:
    """The rotary frequencies on ``device``, made once per device; under a
    ``torch.export`` trace they are made anew (a small constant of the
    program), so the cache never keeps a traced tensor."""
    if torch.compiler.is_compiling():
        inv_freq_np, attn_scale = rope_freqs(theta, rd, scaling)
        return torch.from_numpy(inv_freq_np).to(device), attn_scale
    return _inv_freq_cached(theta, rd, scaling, device)


def rope_tables_at(positions: torch.Tensor, cfg: LlamaConfig
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin ``[b, s, 1, rd]`` in fp32 at per-sequence ``positions [b, s]``
    (``rd`` = the rotary dims); one forward makes them once for every layer."""
    hd = cfg.head_dim
    rd = cfg.rotary_dim if cfg.rotary_dim is not None and cfg.rotary_dim < hd else hd
    inv_freq, attn_scale = _inv_freq(cfg.rope_theta, rd, cfg.rope_scaling, positions.device)
    freqs = positions.float()[..., None] * inv_freq            # [b, s, rd/2]
    emb = torch.cat([freqs, freqs], dim=-1)                    # [b, s, rd]
    return ((torch.cos(emb) * attn_scale)[:, :, None, :],
            (torch.sin(emb) * attn_scale)[:, :, None, :])


def _rope_at(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor, cfg: LlamaConfig,
             tables: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """Rotary embedding at per-sequence positions. q/k: [b, s, h, hd];
    positions [b, s]. ``cfg.rotary_dim`` rotates only the first dims (phi-2);
    ``cfg.rope_scaling`` corrects the frequencies (llm/rope.py). ``tables``:
    the result of :func:`rope_tables_at` for these positions, if already made."""
    cos, sin = tables if tables is not None else rope_tables_at(positions, cfg)
    hd, rd = q.shape[-1], cos.shape[-1]

    def rot(x):
        x1, x2 = x.chunk(2, dim=-1)
        return torch.cat([-x2, x1], dim=-1)

    def apply(x):
        xr = x[..., :rd].float()
        out = (xr * cos + rot(xr) * sin).to(x.dtype)
        return out if rd == hd else torch.cat([out, x[..., rd:]], dim=-1)

    return apply(q), apply(k)


def num_attn_layers(cfg: LlamaConfig) -> int:
    return cfg.num_layers - len(cfg.pruned_attention_blocks)


def cache_compute_dtype(ck) -> torch.dtype:
    """Activation dtype implied by a cache leaf (int8 caches compute bf16)."""
    return torch.bfloat16 if isinstance(ck, dict) else ck.dtype


def _block_qkv(x: torch.Tensor, bp: Params, cfg: LlamaConfig, positions: torch.Tensor,
               compute_dtype, rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
               lora_ids: Optional[torch.Tensor] = None):
    """q [b, s, nq, hd], k and v [b, s, nkv, hd] of one block at per-sequence
    rotary ``positions [b, s]``; takes the fused ``qkv_kernel`` of
    :func:`pack_llm_params_for_serving` or the three separate projections.
    ``lora_ids [b]``: each row's adapter delta is added per target after the
    packed split (``multilora.lora_delta``; None: the base projections)."""
    b, s, _ = x.shape
    if any(k.startswith("qkv_kernel") for k in bp):
        qkv = _mm(x, bp, "qkv_kernel", compute_dtype)
        # a tensor-parallel rank's [q_r | k_r | v_r] is the same fraction of each
        full = (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim
        hq = cfg.num_heads * cfg.head_dim * qkv.shape[-1] // full
        hkv = cfg.num_kv_heads * cfg.head_dim * qkv.shape[-1] // full
        q, k, v = qkv.split((hq, hkv, hkv), dim=-1)
    else:
        q = _mm(x, bp, "q_kernel", compute_dtype)
        k = _mm(x, bp, "k_kernel", compute_dtype)
        v = _mm(x, bp, "v_kernel", compute_dtype)
    if lora_ids is not None:
        dq, dk, dv = (lora_delta(x, bp, t, lora_ids, compute_dtype)
                      for t in ("q_kernel", "k_kernel", "v_kernel"))
        q = q if dq is None else q + dq
        k = k if dk is None else k + dk
        v = v if dv is None else v + dv
    if "q_bias" in bp:
        q = q + bp["q_bias"].to(compute_dtype)
        k = k + bp["k_bias"].to(compute_dtype)
        v = v + bp["v_bias"].to(compute_dtype)
    q = q.reshape(b, s, -1, cfg.head_dim)
    k = k.reshape(b, s, -1, cfg.head_dim)
    v = v.reshape(b, s, -1, cfg.head_dim)
    if cfg.qk_norm:  # qwen3: per-head RMSNorm over head_dim before rope
        q = rms_norm(q, bp["q_norm"], cfg.rms_eps)
        k = rms_norm(k, bp["k_norm"], cfg.rms_eps)
    if not cfg.is_opt:  # OPT: learned absolute positions at the embedding
        q, k = _rope_at(q, k, positions, cfg, rope)
    return q, k, v


_LLAMA_ATTN_KEYS = ("ln1", "ln1_bias", "q_kernel", "k_kernel", "v_kernel",
                    "o_kernel", "qkv_kernel", "q_bias", "k_bias", "v_bias",
                    "o_bias", "ln1_post", "q_norm", "k_norm")


def pack_llm_params_for_serving(params: Params, cfg: LlamaConfig) -> Params:
    """Fuse per-layer q/k/v -> ``qkv_kernel`` [.., d, hq+2hkv] and gate/up ->
    ``gateup_kernel`` [.., d, 2f] so each decode step runs one matmul where it
    ran three or two. Mathematically identical (concatenating columns commutes
    with the contraction). Works on float and int8-quantized trees (codes and
    per-output-channel scales concatenate the same way); int4 packed layouts
    are left unfused; biases stay separate."""
    blocks = dict(params["blocks"])

    def cat(names, suffix):
        return torch.cat([blocks.pop(n + suffix) for n in names], dim=-1)

    qkv = ("q_kernel", "k_kernel", "v_kernel")
    if "q_kernel" in blocks:
        blocks["qkv_kernel"] = cat(qkv, "")
    elif "q_kernel_q" in blocks:
        blocks["qkv_kernel_q"] = cat(qkv, "_q")
        blocks["qkv_kernel_scale"] = cat(qkv, "_scale")
    if "gate_kernel" in blocks and blocks["gate_kernel"].dim() == 3:
        blocks["gateup_kernel"] = cat(("gate_kernel", "up_kernel"), "")
    elif "gate_kernel_q" in blocks and blocks["gate_kernel_q"].dim() == 3:
        blocks["gateup_kernel_q"] = cat(("gate_kernel", "up_kernel"), "_q")
        blocks["gateup_kernel_scale"] = cat(("gate_kernel", "up_kernel"), "_scale")
    out = {k: v for k, v in params.items() if k != "blocks"}
    out["blocks"] = blocks
    return out


def _base_key(k: str) -> str:
    """Strip the quantization suffixes so quantized trees route through the
    same attention/MLP key split (``q_kernel_q`` -> ``q_kernel``)."""
    for suf in ("_lora_a", "_lora_b", "_q4", "_q", "_scale"):
        if k.endswith(suf):
            return k[: -len(suf)]
    return k


def _final_logits(params: Params, x: torch.Tensor, cfg: LlamaConfig, compute_dtype, tp=None):
    """Final norm + lm_head -> fp32 logits (tied-embedding fallback, int8 head
    with its scale applied in fp32, optional bias, gemma-2 final soft-capping;
    a vocab-sharded head's logits gathered before the softcap under ``tp``)."""
    if cfg.is_phi or cfg.is_opt:
        x = _layer_norm(x, params["ln_final"], params["ln_final_bias"], cfg.layer_norm_eps)
    else:
        x = rms_norm(x, params["ln_final"], cfg.rms_eps)
    if "lm_head_q" in params:
        logits = (x @ params["lm_head_q"].to(compute_dtype)).float() * params["lm_head_scale"]
    else:
        head = params.get("lm_head")
        if head is None:
            head = params["embed"].t()
        logits = (x @ head.to(compute_dtype)).float()
    if "lm_head_bias" in params:
        logits = logits + params["lm_head_bias"].float()
    if tp is not None and ("lm_head" in params or "lm_head_q" in params):
        logits = gather_from_tp(logits, tp)
    if cfg.final_softcap is not None:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits




def split_layers(params: Params, cfg: LlamaConfig) -> List[Layer]:
    """Per-layer views of the stacked block parameters, made once per model:
    attention leaves are indexed by the compacted attention index
    (``attn_store_index``), the rest by the layer index. phi's ``ln1`` feeds
    both branches and stays with the layer."""
    attn_keys = set(_LLAMA_ATTN_KEYS) - ({"ln1", "ln1_bias"} if cfg.is_phi else set())
    store = cfg.attn_store_index
    layers: List[Layer] = []
    for i in range(cfg.num_layers):
        j = store[i]
        bp = {}
        for name, val in params["blocks"].items():
            if _base_key(name) in attn_keys:
                if j is not None:
                    bp[name] = val[j]
            else:
                bp[name] = val[i]
        layers.append((bp, j))
    return layers


def _lora_ids(params: Params, lora_ids, b: int, device) -> Optional[torch.Tensor]:
    """``lora_ids`` (a sequence, array or tensor of ``b`` adapter slots) as an
    int64 tensor on ``device``, checked on the host against the attached
    bank's slot count (an index past the bank would fault on the card);
    None stays None."""
    if lora_ids is None:
        return None
    ids = np.asarray(lora_ids.cpu() if isinstance(lora_ids, torch.Tensor) else lora_ids,
                     np.int64).reshape(-1)
    if ids.size != b:
        raise ValueError(f"{ids.size} lora_ids for a batch of {b}")
    slots = [v.shape[1] for k, v in params["blocks"].items() if k.endswith(LORA_SUFFIX_A)]
    if slots and (ids.min() < 0 or ids.max() >= slots[0]):
        raise ValueError(f"lora_ids {ids.tolist()} outside the bank's slots [0, {slots[0]})")
    return torch.as_tensor(ids, device=device)


def _gathered_layers(layers: List[Layer], ids: Optional[torch.Tensor], compute_dtype
                     ) -> List[Layer]:
    """``layers`` with each bank slice's rows for ``ids`` gathered once for a
    whole generation (the ids do not change in it); unchanged for None."""
    if ids is None:
        return layers
    return [(gather_lora_rows(bp, ids, compute_dtype), j) for bp, j in layers]


# ------------------------------------------------------------------ cache ---

def init_cache(cfg: LlamaConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device: DeviceLike = None):
    """KV cache ``[A, b, max_len, nkv, hd]`` x2 on ``device`` (``cuda`` by
    default). ``dtype=torch.int8`` makes the quantized cache: each becomes
    ``{"q": int8 codes, "s": fp32 per-token-per-head scales [A, b, max_len,
    nkv]}``; compute stays bf16, only the cache bytes halve."""
    require_llama_config(cfg)
    dev = resolve_device(device)
    shape = (num_attn_layers(cfg), batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    if dtype == torch.int8:
        def mk():
            return {"q": torch.zeros(shape, dtype=torch.int8, device=dev),
                    "s": torch.ones(shape[:-1], dtype=torch.float32, device=dev)}
        return mk(), mk()
    return (torch.zeros(shape, dtype=dtype, device=dev),
            torch.zeros(shape, dtype=dtype, device=dev))


def init_rolling_cache(cfg: LlamaConfig, batch: int, dtype=torch.bfloat16,
                       device: DeviceLike = None):
    """ROLLING cache for sliding-window models: exactly ``sliding_window``
    slots per layer (slot = global position mod window), so the cache is
    bounded by the window however long the generation runs. Requires a
    uniform ``cfg.sliding_window``; llama-layout and phi only."""
    if cfg.sliding_window is None:
        raise ValueError("rolling cache requires cfg.sliding_window")
    if not cfg.uniform_window:
        raise ValueError("rolling cache requires a UNIFORM window: mixed configs have "
                         "full-attention layers whose keys never expire")
    if cfg.is_opt:
        raise ValueError("rolling cache covers llama-layout/phi models")
    return init_cache(cfg, batch, cfg.sliding_window, dtype, device)


# [b, s, nkv, hd] -> (int8 codes, fp32 per-(token, head) scales): the paged
# pools' quantizer, so the contiguous and paged int8 caches cannot diverge.
_quantize_kv = quantize_token_kv


def _take_layer(cache, layer_idx: Optional[int]):
    """The 4D cache of one layer (a view), or the cache itself for None."""
    if layer_idx is None:
        return cache
    if isinstance(cache, dict):
        return {k: v[layer_idx] for k, v in cache.items()}
    return cache[layer_idx]


def _write_rows(rows: torch.Tensor, at, new: torch.Tensor) -> None:
    """``rows[:, at] = new`` in place: ``at`` a slice, or an index tensor."""
    if isinstance(at, slice):
        rows[:, at].copy_(new)
    else:
        rows.index_copy_(1, at, new)


def _write_cache(ck_l, cv_l, k: torch.Tensor, v: torch.Tensor, write_pos: Position,
                 layer_idx: Optional[int] = None):
    """In place: rows ``[write_pos, write_pos + s)`` of the layer's cache take
    k / v ``[b, s, nkv, hd]`` (int8 caches quantize per token and head).
    ``write_pos``: a host integer (prefill, the speculative extend), written
    by a slice copy, or a 0-d int64 tensor on the cache's device (every
    decode step), written by ``index_copy_`` at ``write_pos + arange(s)`` and
    never read on the host, so a ``torch.export`` trace keeps it an input.
    The slice stays for the prefill: ``index_copy_`` of a 512-token prompt's
    rows made a 16-layer int8 prefill at Llama-2-7B widths and b=8 0.8%
    slower on an H100 (``scripts/torch_operator_ab.py``, PERF.md).
    The rows must lie in the cache (an index past its end raises on the CPU
    and is a device-side assert on the card). ``layer_idx`` addresses a row
    of the full 5D caches, None a 4D cache. Returns the objects it was given."""
    s = k.shape[1]
    at = (write_pos + torch.arange(s, device=k.device) if isinstance(write_pos, torch.Tensor)
          else slice(write_pos, write_pos + s))
    for cache, new in ((ck_l, k), (cv_l, v)):
        rows = _take_layer(cache, layer_idx)
        if isinstance(rows, dict):
            codes, scales = _quantize_kv(new)
            _write_rows(rows["q"], at, codes)
            _write_rows(rows["s"], at, scales)
        else:
            _write_rows(rows, at, new)
    return ck_l, cv_l


def _rolling_prefill_write(ck_l, cv_l, k: torch.Tensor, v: torch.Tensor, W: int):
    """The W-slot rolling buffers filled from prefill k/v ``[b, p_pad, nkv,
    hd]``: slot s takes the newest prompt key whose global index is s mod W,
    j(s) = p_pad-1 - ((p_pad-1-s) mod W); slots without one (short prompts)
    take a key the attention mask drops (key_global < 0). Returns new 4D
    buffers (codes and scales for an int8 cache)."""
    p_pad = k.shape[1]
    j = (p_pad - 1) - np.mod(p_pad - 1 - np.arange(W), W)
    jidx = torch.as_tensor(np.maximum(j, 0), dtype=torch.int64, device=k.device)
    kj, vj = k[:, jidx], v[:, jidx]
    if isinstance(ck_l, dict):
        kq, ks = _quantize_kv(kj)
        vq, vs = _quantize_kv(vj)
        return {"q": kq, "s": ks}, {"q": vq, "s": vs}
    return kj.to(ck_l.dtype), vj.to(cv_l.dtype)


# -------------------------------------------------------------- attention ---

def _attend_cached(q: torch.Tensor, ck, cv, query_positions: torch.Tensor,
                   pad_lens: torch.Tensor, cfg: LlamaConfig, rolling: Optional[int] = None,
                   window_bound: Optional[int] = None) -> torch.Tensor:
    """q ``[b, s_q, h, hd]`` over one layer's cached k/v ``[b, max_len, nkv,
    hd]``: the query at global index g attends keys with pad_len <= key <= g.

    ``rolling`` = slot count W of a rolling cache: slot s holds the key with
    global index g - ((g - s) mod W); only left-pad / unwritten validity is
    masked. ``window_bound``: this layer's band (None: ``cfg.sliding_window``).

    GQA contracts each KV head against its query group through a group axis
    on q; the cache is never repeated. int8 caches fold the key scales into
    the logits and the value scales into the softmax weights; the products
    take the codes converted to q's dtype."""
    b, s_q, h, hd = q.shape
    quant = isinstance(ck, dict)
    k_raw, v_raw = (ck["q"], cv["q"]) if quant else (ck, cv)
    nkv = k_raw.shape[2]     # the cache's heads (a tensor-parallel rank's share)
    rep = h // nkv
    key_idx = torch.arange(k_raw.shape[1], device=q.device)
    g = query_positions[:, :, None]
    if rolling is not None:
        age = torch.remainder(g - key_idx[None, None, :], rolling)    # [b, s_q, W]
        causal = age < cfg.sliding_window
        valid = (g - age) >= pad_lens[:, None, None]                   # also kills unwritten
    else:
        causal = key_idx[None, None, :] <= g                           # [b, s_q, max_len]
        band = window_bound if window_bound is not None else cfg.sliding_window
        if band is not None:
            causal = causal & (g - key_idx[None, None, :] < band)
        valid = key_idx[None, None, :] >= pad_lens[:, None, None]
    qg = q.reshape(b, s_q, nkv, rep, hd)
    logits = torch.einsum("bqhrd,bkhd->bhrqk", qg, k_raw.to(q.dtype)).float()
    if quant:
        logits = logits * ck["s"].permute(0, 2, 1)[:, :, None, None, :]
    logits = logits / (hd ** 0.5)
    if cfg.attn_softcap is not None:
        logits = cfg.attn_softcap * torch.tanh(logits / cfg.attn_softcap)
    mask = (causal & valid)[:, None, None]                             # [b, 1, 1, s_q, keys]
    logits = torch.where(mask, logits, torch.full_like(logits, _NEG_INF))
    w = torch.softmax(logits, dim=-1)
    if quant:
        w = w * cv["s"].permute(0, 2, 1)[:, :, None, None, :]
    w = w.to(q.dtype)
    return torch.einsum("bhrqk,bkhd->bqhrd", w, v_raw.to(q.dtype)).reshape(b, s_q, h * hd)


def _attend_direct(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, positions: torch.Tensor,
                   pad_lens: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    """Full-sequence attention on the layer's own k/v (rolling-cache prefill:
    the W-slot buffer cannot hold the early keys early queries need); causal,
    sliding-window band and left-pad mask. q ``[b, s, h, hd]``, k/v ``[b, s,
    nkv, hd]`` -> ``[b, s, h*hd]``."""
    b, s, h, hd = q.shape
    rep = h // k.shape[2]
    kf = k.repeat_interleave(rep, dim=2) if rep > 1 else k
    vf = v.repeat_interleave(rep, dim=2) if rep > 1 else v
    logits = torch.einsum("bqhd,bkhd->bhqk", q, kf).float() / (hd ** 0.5)
    if cfg.attn_softcap is not None:
        logits = cfg.attn_softcap * torch.tanh(logits / cfg.attn_softcap)
    g = positions[:, :, None]
    j = positions[:, None, :]
    mask = (j <= g) & (j >= pad_lens[:, None, None])
    if cfg.sliding_window is not None:
        mask = mask & (g - j < cfg.sliding_window)
    logits = torch.where(mask[:, None], logits, torch.full_like(logits, _NEG_INF))
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, vf).reshape(b, s, h * hd)


def _proj_o(attn: torch.Tensor, bp: Params, compute_dtype, lora_ids=None, tp=None
            ) -> torch.Tensor:
    """o-projection plus the rows' adapter delta under ``lora_ids`` (no bias:
    callers add the architecture's biases; summed over ``tp`` here)."""
    out = _row_parallel(attn, bp, "o_kernel", compute_dtype, tp)
    d = lora_delta(attn, bp, "o_kernel", lora_ids, compute_dtype)
    return out if d is None else out + d


def _attn_branch(h, bp, ck_l, cv_l, cfg: LlamaConfig, *, global_positions, rope_positions,
                 pad_lens, write_pos, compute_dtype, rolling, lora_ids=None,
                 window_bound=None, layer_idx=None, rope=None):
    """qkv + cache write + cached attention, shared by the three block
    layouts. Rolling-cache PREFILL (s > 1) attends on the in-layer k/v, then
    fills the W-slot buffer with the newest W keys. ``layer_idx``: ck_l/cv_l
    are the full 5D caches and this layer's row is written in place; ``rope``:
    the forward's cos/sin tables at ``rope_positions``; ``lora_ids``: the
    rows' adapters (see :func:`_block_qkv`)."""
    q, k, v = _block_qkv(h, bp, cfg, rope_positions, compute_dtype, rope, lora_ids)
    if rolling is not None and q.shape[1] > 1:
        attn = _attend_direct(q, k, v, global_positions, pad_lens, cfg)
        nk, nv = _rolling_prefill_write(_take_layer(ck_l, layer_idx), _take_layer(cv_l, layer_idx),
                                        k, v, rolling)
        for cache, new in ((ck_l, nk), (cv_l, nv)):
            rows = _take_layer(cache, layer_idx)
            if isinstance(rows, dict):
                for key in rows:
                    rows[key].copy_(new[key])
            else:
                rows.copy_(new)
        return attn, ck_l, cv_l
    ck_l, cv_l = _write_cache(ck_l, cv_l, k, v, write_pos, layer_idx)
    attn = _attend_cached(q, _take_layer(ck_l, layer_idx), _take_layer(cv_l, layer_idx),
                          global_positions, pad_lens, cfg, rolling, window_bound)
    return attn, ck_l, cv_l


# ----------------------------------------------------------------- layers ---

def _fused_int8_route(bp: Params, cfg: LlamaConfig) -> bool:
    """Unpacked int8 SwiGLU MLPs go through ``fused_mlp_int8``; packed
    ``gateup_kernel_q``, bf16 and int4 trees, gemma's gelu_tanh, gemma-2, MoE
    and W8A8 keep the ``_mm`` composition."""
    return (all(k in bp for k in ("gate_kernel_q", "up_kernel_q", "down_kernel_q"))
            and cfg.hidden_act == "silu" and not cfg.num_experts and not cfg.is_gemma2
            and not dispatch.use_w8a8())


def _swiglu_mlp(h2: torch.Tensor, bp: Params, cfg: LlamaConfig, compute_dtype, tp=None
                ) -> torch.Tensor:
    if _fused_int8_route(bp, cfg):
        # a rank's f/tp columns; down's per-column scale distributes over the sum
        return reduce_from_tp(fused_mlp_int8(
            h2.contiguous(), bp["gate_kernel_q"], bp["gate_kernel_scale"], bp["up_kernel_q"],
            bp["up_kernel_scale"], bp["down_kernel_q"], bp["down_kernel_scale"]), tp)
    if any(k.startswith("gateup_kernel") for k in bp):
        g, u = _mm(h2, bp, "gateup_kernel", compute_dtype).chunk(2, dim=-1)
    else:
        g = _mm(h2, bp, "gate_kernel", compute_dtype)
        u = _mm(h2, bp, "up_kernel", compute_dtype)
    return _row_parallel(_glu_act(cfg)(g) * u, bp, "down_kernel", compute_dtype, tp)


def _layer_step(x, bp, ck_l, cv_l, cfg: LlamaConfig, *, global_positions, rope_positions,
                pad_lens, write_pos, compute_dtype, has_attn=True, rolling: Optional[int] = None,
                lora_ids=None, window_bound=None, layer_idx=None, rope=None, tp=None):
    """One transformer layer over cached attention: OPT's sequential
    LayerNorm block, phi's parallel residual, or the llama layout (gemma-2
    post-norms included).

    global_positions ``[b, s]``: cache indices for the mask; rope_positions
    ``[b, s]``: pad-corrected rotary (OPT: learned) positions; write_pos: the
    cache write offset, a host integer or a 0-d device tensor (rolling callers
    pass pos mod W);
    rolling: the slot count of a rolling cache; layer_idx: the host-integer
    row of the full 5D caches this layer's attention owns; lora_ids ``[b]``:
    each row's adapter on the attention projections (None: the base model);
    tp: the tensor-parallel group of a sharded layer."""
    attn_kw = dict(global_positions=global_positions, rope_positions=rope_positions,
                   pad_lens=pad_lens, write_pos=write_pos, compute_dtype=compute_dtype,
                   rolling=rolling, lora_ids=lora_ids, window_bound=window_bound,
                   layer_idx=layer_idx, rope=rope)
    if cfg.is_opt:
        if has_attn:
            h = _layer_norm(x, bp["ln1"], bp["ln1_bias"], cfg.layer_norm_eps)
            attn, ck_l, cv_l = _attn_branch(h, bp, ck_l, cv_l, cfg, **attn_kw)
            x = x + _proj_o(attn, bp, compute_dtype, lora_ids, tp) + \
                bp["o_bias"].to(compute_dtype)
        h2 = _layer_norm(x, bp["ln2"], bp["ln2_bias"], cfg.layer_norm_eps)
        hm = _mm(h2, bp, "fc1_kernel", compute_dtype) + bp["fc1_bias"].to(compute_dtype)
        mlp = _row_parallel(torch.relu(hm), bp, "fc2_kernel", compute_dtype, tp) + \
            bp["fc2_bias"].to(compute_dtype)
        return x + mlp, ck_l, cv_l

    if cfg.is_phi:
        h = _layer_norm(x, bp["ln1"], bp["ln1_bias"], cfg.layer_norm_eps)
        delta = torch.zeros_like(x)
        if has_attn:
            attn, ck_l, cv_l = _attn_branch(h, bp, ck_l, cv_l, cfg, **attn_kw)
            delta = _proj_o(attn, bp, compute_dtype, lora_ids, tp) + \
                bp["o_bias"].to(compute_dtype)
        hm = _mm(h, bp, "fc1_kernel", compute_dtype) + bp["fc1_bias"].to(compute_dtype)
        mlp = _row_parallel(gelu(hm), bp, "fc2_kernel", compute_dtype, tp) + \
            bp["fc2_bias"].to(compute_dtype)
        return x + delta + mlp, ck_l, cv_l

    if has_attn:
        h = rms_norm(x, bp["ln1"], cfg.rms_eps)
        attn, ck_l, cv_l = _attn_branch(h, bp, ck_l, cv_l, cfg, **attn_kw)
        attn = _proj_o(attn, bp, compute_dtype, lora_ids, tp)
        if "o_bias" in bp:
            attn = attn + bp["o_bias"].to(compute_dtype)
        if cfg.is_gemma2:
            attn = rms_norm(attn, bp["ln1_post"], cfg.rms_eps)
        x = x + attn
    h2 = rms_norm(x, bp["ln2"], cfg.rms_eps)
    if cfg.num_experts:
        # the dropless expert MLP (float, int8 or int4 expert stacks)
        return x + _moe_mlp(h2, bp, cfg, compute_dtype)[0], ck_l, cv_l
    mlp = _swiglu_mlp(h2, bp, cfg, compute_dtype, tp)
    if cfg.is_gemma2:
        mlp = rms_norm(mlp, bp["ln2_post"], cfg.rms_eps)
    return x + mlp, ck_l, cv_l


def _run_layers(params: Params, x, cache_k, cache_v, cfg: LlamaConfig, *, global_positions,
                rope_positions, pad_lens, write_pos, compute_dtype, rolling: Optional[int] = None,
                lora_ids=None, layers: Optional[List[Layer]] = None, tp=None):
    """Every layer in turn. Caches are addressed in place by the host-integer
    layer index (the compacted attention index of depth-materialized trees,
    ``cfg.attn_store_index``); gemma-2's mixed windows are static per layer;
    the rotary tables are made once for all layers."""
    rope = None if cfg.is_opt else rope_tables_at(rope_positions, cfg)
    kw = dict(global_positions=global_positions, rope_positions=rope_positions,
              pad_lens=pad_lens, write_pos=write_pos, compute_dtype=compute_dtype,
              rolling=rolling, lora_ids=lora_ids, rope=rope, tp=tp)
    for i, (bp, j) in enumerate(layers if layers is not None else split_layers(params, cfg)):
        wb = None if cfg.uniform_window else (cfg.layer_window(i) or _FULL_BOUND)
        if j is None:
            x, _, _ = _layer_step(x, bp, None, None, cfg, has_attn=False, window_bound=wb, **kw)
        else:
            x, cache_k, cache_v = _layer_step(x, bp, cache_k, cache_v, cfg, window_bound=wb,
                                              layer_idx=j, **kw)
    return x, cache_k, cache_v


# ------------------------------------------------------------ entry points ---

def _opt_positions(params: Params, x, rope_positions, compute_dtype):
    """OPT's learned absolute positions at pad-corrected indices, HF offset 2
    (pad slots are masked out of attention, so their embedding never reaches
    a real token)."""
    return x + F.embedding(2 + rope_positions, params["pos_embed"]).to(compute_dtype)


@torch.no_grad()
def prefill(params: Params, tokens: torch.Tensor, cache_k, cache_v, cfg: LlamaConfig,
            pad_lens: torch.Tensor, rolling: Optional[int] = None, lora_ids=None,
            layers: Optional[List[Layer]] = None, tp_group=None):
    """Run LEFT-padded prompts ``[b, p_pad]`` through the model, filling the
    cache; ``pad_lens [b]`` = p_pad - prompt_len per row. ``rolling`` = W slot
    count of a rolling cache. ``lora_ids [b]``: each row's adapter slot of an
    attached bank (0 = base). ``layers``: :func:`split_layers` of ``params``,
    if already made; ``tp_group``: the tensor-parallel group of a sharded tree
    and cache. Returns (logits at the last position [b, V] fp32, cache_k,
    cache_v)."""
    require_llama_config(cfg)
    compute_dtype = cache_compute_dtype(cache_k)
    b, p_pad = tokens.shape
    lora_ids = _lora_ids(params, lora_ids, b, tokens.device)
    x = _embed_tokens(params, tokens, cfg, compute_dtype)
    idx = torch.arange(p_pad, device=tokens.device)
    global_positions = idx[None].expand(b, p_pad)
    rope_positions = (idx[None] - pad_lens[:, None]).clamp_min(0)
    if cfg.is_opt:
        x = _opt_positions(params, x, rope_positions, compute_dtype)
    x, cache_k, cache_v = _run_layers(
        params, x, cache_k, cache_v, cfg, global_positions=global_positions,
        rope_positions=rope_positions, pad_lens=pad_lens, write_pos=0,
        compute_dtype=compute_dtype, rolling=rolling, lora_ids=lora_ids, layers=layers,
        tp=tp_group)
    return _final_logits(params, x[:, -1:], cfg, compute_dtype, tp_group)[:, 0], cache_k, cache_v


def _decode_body(params: Params, token: torch.Tensor, cache_k, cache_v, cfg: LlamaConfig,
                 pos: Position, pad_lens: torch.Tensor, rolling: Optional[int] = None,
                 lora_ids=None, layers: Optional[List[Layer]] = None, tp_group=None):
    compute_dtype = cache_compute_dtype(cache_k)
    b = token.shape[0]
    x = _embed_tokens(params, token, cfg, compute_dtype)[:, None, :]       # [b, 1, d]
    if not isinstance(pos, torch.Tensor):
        pos = torch.full((), pos, dtype=torch.int64, device=token.device)
    # read on the device only (llm/aot.py's decode artifact takes pos as an input)
    global_positions = pos.reshape(1, 1).expand(b, 1)
    write_pos = pos if rolling is None else torch.remainder(pos, rolling)
    rope_positions = pos - pad_lens[:, None]
    if cfg.is_opt:
        x = _opt_positions(params, x, rope_positions, compute_dtype)
    x, cache_k, cache_v = _run_layers(
        params, x, cache_k, cache_v, cfg, global_positions=global_positions,
        rope_positions=rope_positions, pad_lens=pad_lens, write_pos=write_pos,
        compute_dtype=compute_dtype, rolling=rolling, lora_ids=lora_ids, layers=layers,
        tp=tp_group)
    return _final_logits(params, x, cfg, compute_dtype, tp_group)[:, 0], cache_k, cache_v


@torch.no_grad()
def decode_step(params: Params, token: torch.Tensor, cache_k, cache_v, cfg: LlamaConfig,
                pos: Position, pad_lens: torch.Tensor, rolling: Optional[int] = None,
                lora_ids=None, layers: Optional[List[Layer]] = None, tp_group=None):
    """One token per row (``[b]``) at the shared global position ``pos`` (a
    host integer, or a 0-d int64 tensor on the device, which the step reads
    there and never on the host: the same rows and logits); returns (logits
    [b, V] fp32, caches). A contiguous cache of ``max_len`` slots takes
    ``pos < max_len``: a row past its end raises on the CPU and is a
    device-side assert on the card, which ends the process's CUDA context
    (a rolling cache writes at ``pos % W``)."""
    require_llama_config(cfg)
    lora_ids = _lora_ids(params, lora_ids, token.shape[0], token.device)
    if isinstance(pos, torch.Tensor) and (pos.dim() != 0 or pos.dtype != torch.int64
                                          or pos.device != token.device):
        raise ValueError(f"a tensor position is a 0-d int64 tensor on {token.device}, got "
                         f"{pos.dtype} {tuple(pos.shape)} on {pos.device}")
    return _decode_body(params, token, cache_k, cache_v, cfg, pos, pad_lens, rolling, lora_ids,
                        layers, tp_group)


def _sampler(sp: SamplingParams, prompts: Sequence[Sequence[int]], vocab_size: int,
             device, seed: Optional[int]) -> SamplerState:
    """The port's sampler state with every row set to ``sp``: the penalty
    buffers from each row's (unpadded) prompt, and row i's generator seeded
    with ``seed + i`` (the JAX package splits one PRNG key instead)."""
    state = init_sampler_state(len(prompts), vocab_size, device)
    for i, prompt in enumerate(prompts):
        slot_state_row(state, i, sp, prompt, vocab_size, (seed or 0) + i)
    return state


def _sampling(sampling, temperature, top_k, top_p) -> SamplingParams:
    return sampling if sampling is not None else SamplingParams(
        temperature=temperature, top_k=top_k, top_p=top_p)


def _next_token(logits: torch.Tensor, state: Optional[SamplerState]):
    """Greedy argmax, or the sampler's token (penalties, filters, the row's
    generator) when a state is carried; counts include the token."""
    if state is None:
        return logits.argmax(dim=-1), None
    return vectorized_sample(logits, state)


def _default_state(sp: SamplingParams, penalty_state, rng, b: int, vocab_size: int, device):
    if sp.needs_counts and penalty_state is None:
        raise ValueError("penalty sampling needs penalty_state (use generate_kv_scan, which "
                         "initializes it)")
    if penalty_state is None and not sp.greedy:
        return _sampler(sp, [[]] * b, vocab_size, device, rng)
    return penalty_state


@torch.no_grad()
def decode_scan(params: Params, first_token: torch.Tensor, cache_k, cache_v, cfg: LlamaConfig,
                start_pos: int, pad_lens: torch.Tensor, num_steps: int, rng: Optional[int] = None,
                temperature: float = 0.0, top_k: Optional[int] = None,
                rolling: Optional[int] = None, top_p: Optional[float] = None, lora_ids=None,
                sampling: Optional[SamplingParams] = None,
                penalty_state: Optional[SamplerState] = None,
                layers: Optional[List[Layer]] = None, tp_group=None):
    """``num_steps`` decode steps with the token fed back on the device: a
    Python loop that reads nothing back, the tokens stacked on the device at
    the end. Greedy when temperature == 0, else temperature / top-k / top-p /
    min-p sampling; ``sampling`` supersedes the loose knobs and adds the
    penalties, whose state (a ``SamplerState`` with the prompt mask and the
    counts INCLUDING first_token) comes in ``penalty_state``. ``rng``: an int
    seed for sampled rows. Returns (tokens [num_steps, b] on the device,
    caches)."""
    require_llama_config(cfg)
    sp = _sampling(sampling, temperature, top_k, top_p)
    b = first_token.shape[0]
    state = _default_state(sp, penalty_state, rng, b, cfg.vocab_size, first_token.device)
    layers = layers if layers is not None else split_layers(params, cfg)
    lora_ids = _lora_ids(params, lora_ids, b, first_token.device)
    token, pos, out = first_token, int(start_pos), []
    for _ in range(num_steps):
        logits, cache_k, cache_v = _decode_body(params, token, cache_k, cache_v, cfg, pos,
                                                pad_lens, rolling, lora_ids, layers, tp_group)
        token, state = _next_token(logits, state)
        out.append(token)
        pos += 1
    toks = torch.stack(out) if out else first_token.new_zeros((0, b))
    return toks, cache_k, cache_v


def greedy_decode_scan(params, first_token, cache_k, cache_v, cfg, start_pos, pad_lens,
                       num_steps: int):
    """Greedy-only entry (see :func:`decode_scan`)."""
    return decode_scan(params, first_token, cache_k, cache_v, cfg, start_pos, pad_lens, num_steps)


@torch.no_grad()
def decode_while(params: Params, first_token: torch.Tensor, cache_k, cache_v, cfg: LlamaConfig,
                 start_pos: int, pad_lens: torch.Tensor, num_steps: int, eos_token_id: int,
                 rng: Optional[int] = None, rolling: Optional[int] = None, lora_ids=None,
                 sampling: Optional[SamplingParams] = None,
                 penalty_state: Optional[SamplerState] = None,
                 layers: Optional[List[Layer]] = None, tp_group=None):
    """:func:`decode_scan` with an eos early exit: the loop stops once every
    row has emitted ``eos_token_id``. The check reads one flag back to the
    host every ``DECODE_WHILE_SYNC_EVERY`` (8) steps, the only sync of the
    loop, so up to 7 steps may run after the last row finished; a finished
    row keeps emitting eos, so the output (``[num_steps, b]``, eos past the
    stop) and the trimmed sequences are the same whatever the interval."""
    require_llama_config(cfg)
    sp = _sampling(sampling, 0.0, None, None)
    b = first_token.shape[0]
    state = _default_state(sp, penalty_state, rng, b, cfg.vocab_size, first_token.device)
    layers = layers if layers is not None else split_layers(params, cfg)
    lora_ids = _lora_ids(params, lora_ids, b, first_token.device)
    out = torch.full((num_steps, b), eos_token_id, dtype=torch.int64, device=first_token.device)
    done = first_token == eos_token_id
    eos = torch.full_like(first_token, eos_token_id)
    token, pos = first_token, int(start_pos)
    for step in range(num_steps):
        if step % DECODE_WHILE_SYNC_EVERY == 0 and bool(done.all()):
            break
        logits, cache_k, cache_v = _decode_body(params, token, cache_k, cache_v, cfg, pos,
                                                pad_lens, rolling, lora_ids, layers, tp_group)
        nxt, state = _next_token(logits, state)
        nxt = torch.where(done, eos, nxt)
        out[step] = nxt
        done = done | (nxt == eos_token_id)
        token = nxt
        pos += 1
    return out, cache_k, cache_v


def _prepare_prompts(input_ids, max_length: int):
    """list/array of prompts -> (tokens [b, p_pad] left-padded, pad_lens [b],
    prompt_lens [b], p_pad), numpy."""
    if isinstance(input_ids, np.ndarray) and input_ids.ndim == 1:
        prompts = [input_ids.tolist()]
    elif isinstance(input_ids, np.ndarray):
        prompts = [row.tolist() for row in input_ids]
    elif input_ids and isinstance(input_ids[0], (int, np.integer)):
        prompts = [list(input_ids)]
    else:
        prompts = [list(p) for p in input_ids]
    lens = np.asarray([len(p) for p in prompts], np.int32)
    if lens.max() >= max_length:
        raise ValueError(f"prompt length {lens.max()} >= max_length {max_length}")
    p_pad = min(bucket_prompt_pad(int(lens.max())), max_length)
    p_pad = max(p_pad, int(lens.max()))
    tokens = np.zeros((len(prompts), p_pad), np.int32)
    for i, p in enumerate(prompts):
        tokens[i, p_pad - len(p):] = p
    return tokens, (p_pad - lens).astype(np.int32), lens, p_pad


def _trim_outputs(prompts_lens, pad_lens, p_pad, prompt_tokens, gen, max_length, eos_token_id):
    """Per-sequence outputs: prompt + generated, cut at eos / the length cap."""
    outs = []
    for i in range(len(prompts_lens)):
        prompt = prompt_tokens[i, pad_lens[i]:].tolist()
        budget = max_length - prompts_lens[i]
        seq = gen[: max(0, budget), i].tolist()
        if eos_token_id is not None and eos_token_id in seq:
            seq = seq[: seq.index(eos_token_id) + 1]
        outs.append(np.asarray(prompt + seq, np.int32))
    return outs


def _is_single(input_ids) -> bool:
    return bool((isinstance(input_ids, np.ndarray) and input_ids.ndim == 1) or (
        not isinstance(input_ids, np.ndarray) and input_ids
        and isinstance(input_ids[0], (int, np.integer))))


def _rolling_slots(cfg: LlamaConfig, rolling: bool) -> Optional[int]:
    if not rolling:
        return None
    if cfg.sliding_window is None or not cfg.uniform_window:
        raise ValueError("rolling=True requires a uniform cfg.sliding_window")
    return cfg.sliding_window


@torch.no_grad()
def generate_kv_scan(params: Params, cfg: LlamaConfig, input_ids, *, max_length: int = 64,
                     eos_token_id: Optional[int] = None, cache_dtype=torch.bfloat16,
                     temperature: float = 0.0, top_k: Optional[int] = None,
                     top_p: Optional[float] = None, rng: Optional[int] = None,
                     cache_factory=None, rolling: bool = False, lora_ids=None,
                     sampling: Optional[SamplingParams] = None, early_stop: bool = True,
                     tp_group=None):
    """Prefill + one decode loop on the device that holds ``params``, the
    tokens copied to the host once at the end. ``input_ids``: one prompt or a
    list of prompts of different lengths (left-padded to a shared bucket).
    Returns per-sequence token arrays (prompt + generation, trimmed at eos);
    a single 1-D prompt returns one array.

    ``cache_factory(cfg, b, max_len, dtype)`` places the cache (default
    :func:`init_cache` on the parameters' device); ``rolling=True`` bounds the
    cache to ``cfg.sliding_window`` slots (exact: the window already hides
    everything older); ``rng``: an int seed for sampled rows; with
    ``eos_token_id`` and ``early_stop`` the loop is :func:`decode_while`.
    ``lora_ids [b]``: each row's adapter slot of the bank attached to
    ``params`` (``multilora.attach_lora_bank``; 0 = the base model); the rows'
    bank slices are gathered once for the generation. ``tp_group``: the
    tensor-parallel group of a ``shard_llama_params`` shard, with the cache
    from ``llm_sharding.tp_cache_factory`` (``tp_generate_kv_scan``)."""
    require_llama_config(cfg)
    if tp_group is not None and lora_ids is not None:
        raise ValueError("tensor-parallel generation takes no lora_ids")
    device = params["embed"].device
    single = _is_single(input_ids)
    tokens, pad_lens, lens, p_pad = _prepare_prompts(input_ids, max_length)
    b = tokens.shape[0]
    num_steps = max_length - int(lens.min()) - 1
    W = _rolling_slots(cfg, rolling)
    cache_len = W if W is not None else p_pad + max(num_steps, 0) + 1
    if cache_factory is None:
        cache_k, cache_v = init_cache(cfg, b, cache_len, cache_dtype, device)
    else:
        cache_k, cache_v = cache_factory(cfg, b, cache_len, cache_dtype)
    lora_ids = _lora_ids(params, lora_ids, b, device)
    layers = _gathered_layers(split_layers(params, cfg), lora_ids,
                              cache_compute_dtype(cache_k))
    tok = torch.as_tensor(tokens.astype(np.int64), device=device)
    pads = torch.as_tensor(pad_lens.astype(np.int64), device=device)
    logits, cache_k, cache_v = prefill(params, tok, cache_k, cache_v, cfg, pads, rolling=W,
                                       lora_ids=lora_ids, layers=layers, tp_group=tp_group)
    sp = _sampling(sampling, temperature, top_k, top_p)
    state = None
    if sp.needs_counts or not sp.greedy:
        prompts = [tokens[i, pad_lens[i]:].tolist() for i in range(b)]
        state = _sampler(sp, prompts, cfg.vocab_size, device, rng)
    first, state = _next_token(logits, state)
    kw = dict(rng=rng, sampling=sp, penalty_state=state, rolling=W, lora_ids=lora_ids,
              layers=layers, tp_group=tp_group)
    if num_steps <= 0:
        gen = first[None]
    elif eos_token_id is not None and early_stop:
        toks, _, _ = decode_while(params, first, cache_k, cache_v, cfg, p_pad, pads, num_steps,
                                  int(eos_token_id), **kw)
        gen = torch.cat([first[None], toks], dim=0)
    else:
        toks, _, _ = decode_scan(params, first, cache_k, cache_v, cfg, p_pad, pads, num_steps,
                                 **kw)
        gen = torch.cat([first[None], toks], dim=0)
    outs = _trim_outputs(lens, pad_lens, p_pad, tokens, gen.cpu().numpy(), max_length,
                         eos_token_id)
    return outs[0] if single else outs


def greedy_generate_kv_scan(params, cfg, input_ids, *, max_length: int = 64,
                            cache_dtype=torch.bfloat16):
    """Greedy decoding on the device (see :func:`generate_kv_scan`)."""
    return generate_kv_scan(params, cfg, input_ids, max_length=max_length, cache_dtype=cache_dtype)


@torch.no_grad()
def greedy_generate_kv(params: Params, cfg: LlamaConfig, input_ids, *, max_length: int = 64,
                       eos_token_id: Optional[int] = None, cache_dtype=torch.bfloat16,
                       rolling: bool = False, lora_ids=None):
    """KV-cached greedy decoding with a host round trip per token (early eos
    stop). Rows that hit eos keep decoding but their outputs are trimmed.
    ``rolling=True``: window-bounded cache, ``lora_ids``: per-row adapters
    (see :func:`generate_kv_scan`)."""
    require_llama_config(cfg)
    device = params["embed"].device
    single = _is_single(input_ids)
    tokens, pad_lens, lens, p_pad = _prepare_prompts(input_ids, max_length)
    b = tokens.shape[0]
    max_steps = max_length - int(lens.min())
    W = _rolling_slots(cfg, rolling)
    if W is not None:
        cache_k, cache_v = init_rolling_cache(cfg, b, cache_dtype, device)
    else:
        cache_k, cache_v = init_cache(cfg, b, p_pad + max_steps, cache_dtype, device)
    lora_ids = _lora_ids(params, lora_ids, b, device)
    layers = _gathered_layers(split_layers(params, cfg), lora_ids, cache_compute_dtype(cache_k))
    pads = torch.as_tensor(pad_lens.astype(np.int64), device=device)
    logits, cache_k, cache_v = prefill(params, torch.as_tensor(tokens.astype(np.int64),
                                                               device=device),
                                       cache_k, cache_v, cfg, pads, rolling=W,
                                       lora_ids=lora_ids, layers=layers)
    generated = [[] for _ in range(b)]
    done = np.zeros(b, bool)
    pos = p_pad
    while True:
        nxt = logits.argmax(dim=-1)
        host = nxt.cpu().numpy()
        for i in range(b):
            if not done[i] and len(generated[i]) < max_length - lens[i]:
                generated[i].append(int(host[i]))
                if eos_token_id is not None and host[i] == eos_token_id:
                    done[i] = True
                if len(generated[i]) >= max_length - lens[i]:
                    done[i] = True
        if done.all():
            break
        logits, cache_k, cache_v = decode_step(params, nxt, cache_k, cache_v, cfg, pos, pads,
                                               rolling=W, lora_ids=lora_ids, layers=layers)
        pos += 1
    outs = [np.asarray(tokens[i, pad_lens[i]:].tolist() + generated[i], np.int32)
            for i in range(b)]
    return outs[0] if single else outs
