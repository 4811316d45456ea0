"""Flash attention forward (replaces ``ssp_x_vit_tpu/ops/pallas/
flash_attention.py:flash_attention``: ``_flash_forward``,
``_flash_forward_multihead`` and ``_flash_forward_streaming``).

    out = softmax(mask(softcap(q k^T / sqrt(hd)))) v

for q ``[b, h, s, hd]`` and k, v ``[b, hkv, s, hd]``. GQA-native: query head
``h`` reads KV head ``h // (h / hkv)`` and K/V are never repeated in device
memory. ``causal`` masks ``col > row``; ``window`` (needs ``causal``) keeps
``row - col < window``; ``softcap`` applies ``cap * tanh(logits / cap)`` to
the scaled logits before the mask. fp32 logits and softmax, ``p`` rounded to
``v``'s dtype before the second product.

On the card the wrapper launches ``csrc/flash_attention.cu`` (one kernel
walking 64-key tiles with an online softmax; bf16 on the tensor cores, fp32
in exact fp32). What bounds it: ``4 * hd`` operations per unmasked (query,
key) pair against q, k, v and o moved once, so it is operations-bound at
every LLM shape. The kernel has no backward: a tensor that requires grad
raises (the backward kernels, row 6 of the kernel table in PERF.md, come with
the training slice).

On a CPU tensor the wrapper runs ``flash_attention_plain`` (``sdpa_reference``
on repeated K/V); a CUDA tensor always launches the kernel or raises.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ssp_x_vit_tpu_torch.ops import dispatch
from ssp_x_vit_tpu_torch.ops.kernels import build, launch_counts

MAX_HEAD_DIM = 256  # the largest head_dim tile the kernel is built for


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = False, window: Optional[int] = None,
                          softcap: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version: repeat K/V over the query group, then
    ``sdpa_reference`` (the whole [s, s] logits in fp32)."""
    from ssp_x_vit_tpu_torch.ops.attention import sdpa_reference

    rep = q.shape[1] // k.shape[1]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    return sdpa_reference(q, k, v, causal=causal, window=window, softcap=softcap)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """q [b, h, s, hd], k/v [b, hkv, s, hd] -> [b, h, s, hd] (arguments already
    validated by ``ops.attention.flash_attention``, the public entry)."""
    if not dispatch.use_kernel(q):
        return flash_attention_plain(q, k, v, causal=causal, window=window, softcap=softcap)
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise RuntimeError(
            "flash_attention has no backward kernel yet (row 6 of the kernel table in "
            "PERF.md, ROADMAP.md B.3 backward): call it under torch.no_grad() or detach")
    b, h, s, hd = q.shape
    hkv = k.shape[1]
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention takes head_dim <= {MAX_HEAD_DIM}, got {hd}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention takes float32 or bfloat16, got {q.dtype}")
    for name, t, shape in (("q", q, (b, h, s, hd)), ("k", k, (b, hkv, s, hd)),
                           ("v", v, (b, hkv, s, hd))):
        if t.device != q.device or t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype} on {t.device}, q is {q.dtype} on {q.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous in the [b, h, s, hd] layout")
    if h > 65535 or b > 65535:
        raise ValueError(f"flash_attention takes at most 65535 heads and batch rows, got {h}, {b}")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        build.flash_attention(q, k, v, out, scale=1.0 / math.sqrt(hd), causal=causal,
                              window=0 if window is None else int(window),
                              softcap=0.0 if softcap is None else float(softcap))
    launch_counts["flash_attention"] += 1
    return out
