"""Multi-head attention for the ViT and LLM forward passes (counterpart of
``ssp_x_vit_tpu/ops/attention.py``).

``sdpa_reference`` is the plain PyTorch attention (the whole [s, s] logits in
fp32). ``flash_attention`` is the public entry to the hand-written flash
kernel (``ops/kernels/flash_attention.py``): it launches the kernel on a CUDA
tensor and runs the plain version on a CPU tensor. The ViT block's fused
attention runs through ``ops/kernels/fused_attn_block.py``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def multi_head_attention(
    x: torch.Tensor,
    qkv_kernel: torch.Tensor,
    qkv_bias: Optional[torch.Tensor],
    proj_kernel: torch.Tensor,
    proj_bias: Optional[torch.Tensor],
    num_heads: int,
    *,
    causal: bool = False,
    use_flash: Optional[bool] = None,
) -> torch.Tensor:
    """Fused-QKV multi-head self attention, x [batch, seq, hidden] -> same.

    ``qkv_kernel`` is [hidden, 3*hidden] with q|k|v concatenated on the output
    axis; ``proj_kernel`` is [hidden, hidden]. A tensor-parallel shard has
    [hidden, 3*d_r] and [d_r, hidden] with ``num_heads`` of its own. ``use_flash``
    None decides by the tensor: the flash kernel on a CUDA tensor,
    ``sdpa_reference`` on a CPU tensor (there is no sequence-length crossover
    in this package).
    """
    b, s, _ = x.shape
    d = qkv_kernel.shape[-1] // 3
    head_dim = d // num_heads
    qkv = x @ qkv_kernel.to(x.dtype)
    if qkv_bias is not None:
        qkv = qkv + qkv_bias.to(x.dtype)
    q, k, v = qkv.split(d, dim=-1)

    def split_heads(t):
        return t.reshape(b, s, num_heads, head_dim).permute(0, 2, 1, 3)

    q, k, v = split_heads(q), split_heads(k), split_heads(v)
    if use_flash is None:
        use_flash = x.device.type == "cuda"
    if use_flash:
        out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=causal)
    else:
        out = sdpa_reference(q, k, v, causal=causal)
    out = out.permute(0, 2, 1, 3).reshape(b, s, d)
    out = out @ proj_kernel.to(x.dtype)
    if proj_bias is not None:
        out = out + proj_bias.to(x.dtype)
    return out


def sdpa_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = False,
                   window: Optional[int] = None, softcap: Optional[float] = None) -> torch.Tensor:
    """Scaled dot-product attention with an fp32 softmax ([b, h, s, hd] layout).

    ``window`` adds sliding-window attention (HF convention: query position q
    attends keys k with ``k <= q`` and ``q - k < window``) and requires
    ``causal``. ``softcap`` applies ``cap * tanh(logits / cap)`` to the scaled
    logits before the mask. Masked logits take ``finfo(float32).min``; the
    weights are cast to ``v``'s dtype before the second product."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    if causal:
        s = q.shape[2]
        qi = torch.arange(s, device=q.device)[:, None]
        ki = torch.arange(s, device=q.device)[None, :]
        mask = ki <= qi
        if window is not None:
            mask = mask & (qi - ki < window)
        logits = torch.where(mask, logits, torch.finfo(torch.float32).min)
    elif window is not None:
        raise ValueError("sliding window requires causal attention")
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", weights, v)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """q [b, h, s, hd], k/v [b, hkv, s, hd] -> [b, h, s, hd].

    GQA-native: with hkv < h (h % hkv == 0) each query group shares its KV
    head inside the kernel; callers must not repeat K/V. Numerics match
    ``sdpa_reference`` on repeated K/V. ``window`` (HF convention,
    ``row - col < window``) requires ``causal``; a window of at least the
    sequence length is full causal attention.
    """
    from ssp_x_vit_tpu_torch.ops.kernels import flash_attention as kernel

    if q.shape[1] % k.shape[1]:
        raise ValueError(
            f"num_heads {q.shape[1]} not a multiple of num_kv_heads {k.shape[1]}")
    if window is not None:
        if not causal:
            raise ValueError("sliding window requires causal attention")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if window >= q.shape[2]:
            window = None
    return kernel.flash_attention(q, k, v, causal=causal, window=window, softcap=softcap)
