"""Serving helpers shared by the KV-cached decoding paths (counterpart of
``ssp_x_vit_tpu/llm/serve.py``, the part the paged path imports).

Ported: the prompt buckets, rotary embedding at per-sequence positions, the
fused/unfused QKV projection of one block (biases, qwen3 ``qk_norm``, partial
rotary), the final norm + lm_head, and ``pack_llm_params_for_serving`` (fused
``qkv_kernel`` / ``gateup_kernel``). The contiguous KV cache itself
(``init_cache``, ``prefill``, ``decode_step``, ``generate_kv_scan``, the
rolling cache) and OPT serving are the next slice and raise
``NotImplementedError`` naming ROADMAP.md A.9; paged serving lives in
``llm/paged.py``.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import torch

from ssp_x_vit_tpu_torch.llm.model import (
    LlamaConfig, Params, _layer_norm, _mm, rms_norm,
)
from ssp_x_vit_tpu_torch.llm.rope import rope_freqs

PROMPT_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048)

_CONTIGUOUS_NOT_PORTED = ("the contiguous KV cache (init_cache, prefill, decode_step, "
                          "generate_kv_scan, rolling cache, OPT serving) is not ported yet: "
                          "ROADMAP.md A.9, contiguous KV serving; use llm/paged.py")


def bucket_prompt_pad(n: int, buckets: Sequence[int] = PROMPT_BUCKETS) -> int:
    """Smallest bucket >= n (rounding up to a multiple of 128 past the table).
    Eager PyTorch compiles nothing per shape, so the port's servers do not pad
    prompts; the function is kept for callers that want the JAX package's shapes."""
    for b in buckets:
        if n <= b:
            return b
    return -(-n // 128) * 128


@functools.lru_cache(maxsize=32)
def _inv_freq(theta: float, rd: int, scaling, device: torch.device) -> Tuple[torch.Tensor, float]:
    inv_freq_np, attn_scale = rope_freqs(theta, rd, scaling)
    return torch.from_numpy(inv_freq_np).to(device), attn_scale


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
               compute_dtype, rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """q [b, s, nq, hd], k and v [b, s, nkv, hd] of one block at per-sequence
    rotary ``positions [b, s]``; takes the fused ``qkv_kernel`` of
    :func:`pack_llm_params_for_serving` or the three separate projections."""
    b, s, _ = x.shape
    if any(k.startswith("qkv_kernel") for k in bp):
        qkv = _mm(x, bp, "qkv_kernel", compute_dtype)
        hq = cfg.num_heads * cfg.head_dim
        hkv = cfg.num_kv_heads * cfg.head_dim
        q, k, v = qkv.split((hq, hkv, hkv), dim=-1)
    else:
        q = _mm(x, bp, "q_kernel", compute_dtype)
        k = _mm(x, bp, "k_kernel", compute_dtype)
        v = _mm(x, bp, "v_kernel", compute_dtype)
    if "q_bias" in bp:
        q = q + bp["q_bias"].to(compute_dtype)
        k = k + bp["k_bias"].to(compute_dtype)
        v = v + bp["v_bias"].to(compute_dtype)
    q = q.reshape(b, s, cfg.num_heads, cfg.head_dim)
    k = k.reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
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


def _final_logits(params: Params, x: torch.Tensor, cfg: LlamaConfig, compute_dtype):
    """Final norm + lm_head -> fp32 logits (tied-embedding fallback, int8 head
    with its scale applied in fp32, optional bias, gemma-2 final soft-capping)."""
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
    if cfg.final_softcap is not None:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


def _contiguous_not_ported(*args, **kwargs):
    raise NotImplementedError(_CONTIGUOUS_NOT_PORTED)


init_cache = init_rolling_cache = prefill = decode_step = decode_scan = _contiguous_not_ported
greedy_decode_scan = decode_while = generate_kv_scan = _contiguous_not_ported
greedy_generate_kv_scan = greedy_generate_kv = _contiguous_not_ported
