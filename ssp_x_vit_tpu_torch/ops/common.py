"""Shared primitive ops: GELU, LayerNorm, patch extraction and the
quantization-aware projection matmul (counterpart of
``ssp_x_vit_tpu/ops/common.py``).

Plain PyTorch: on the card these run as PyTorch's own elementwise and
reduction kernels around the hand-written kernels, as the JAX package left
them to XLA. ``mm_quant`` sends packed-int4 weights to the hand-written
dequant GEMM (``ops/kernels/quant_matmul.py``).
"""

from __future__ import annotations

from typing import Dict, Iterable

import torch
import torch.nn.functional as F


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf-based) GELU, matching HF ViT's default activation."""
    return F.gelu(x, approximate="none")


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-12) -> torch.Tensor:
    """LayerNorm over the last axis with fp32 statistics; output in x's dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * scale.float() + bias.float()
    return y.to(x.dtype)


def patchify(pixel_values: torch.Tensor, patch_size: int) -> torch.Tensor:
    """[batch, H, W, C] -> [batch, num_patches, C*P*P].

    The flattened patch is ordered (C, P, P), as a torch Conv2d weight
    ``(out, C, P, P)`` flattens, so the patch-embedding kernel ``[C*P*P, d]``
    is shared with the JAX package unchanged.
    """
    b, h, w, c = pixel_values.shape
    p = patch_size
    if h % p or w % p:
        raise ValueError(f"image size {(h, w)} not divisible by patch size {p}")
    gh, gw = h // p, w // p
    x = pixel_values.reshape(b, gh, p, gw, p, c)
    x = x.permute(0, 1, 3, 5, 2, 4)  # [b, gh, gw, C, p, p]
    return x.reshape(b, gh * gw, c * p * p)


def pick_param_variants(blocks: Dict[str, torch.Tensor], bases: Iterable[str],
                        idx: int) -> Dict[str, torch.Tensor]:
    """Per-layer param dict copying whichever storage variant each base key has
    (plain, ``_q`` int8, ``_q4`` packed int4, ``_scale``): the one suffix walk
    of the materialized forwards, so quantized trees flow through unchanged."""
    bp = {}
    for base in bases:
        for suf in ("", "_q", "_q4", "_scale"):
            if base + suf in blocks:
                bp[base + suf] = blocks[base + suf][idx]
    return bp


def mm_quant(x: torch.Tensor, bp: Dict[str, torch.Tensor], name: str, compute_dtype) -> torch.Tensor:
    """Projection matmul over a param dict, handling weight-only quantized
    entries: ``<name>_q`` int8 with the per-output-channel ``<name>_scale``
    applied to the output (a plain product with a convert, as in the JAX
    package; W8A8 when enabled); ``<name>_q4`` packed int4 through the
    dequant GEMM kernel; else the plain ``x @ bp[name]``."""
    from ssp_x_vit_tpu_torch.ops.dispatch import use_w8a8

    w_q = bp.get(name + "_q")
    if w_q is not None:
        if use_w8a8():
            return w8a8_matmul(x, w_q, bp[name + "_scale"], compute_dtype)
        return (x @ w_q.to(compute_dtype)) * bp[name + "_scale"].to(compute_dtype)
    w_p = bp.get(name + "_q4")
    if w_p is not None:
        from ssp_x_vit_tpu_torch.ops.kernels.quant_matmul import quant4_matmul

        return quant4_matmul(x.contiguous(), w_p, bp[name + "_scale"])
    return x @ bp[name].to(compute_dtype)


def _int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 [m, k] @ int8 [k, n] -> int32 [m, n], on the operands' device:
    an int32 ``matmul`` for CPU tensors, ``torch._int_mm`` for CUDA tensors.
    ``_int_mm`` takes more than 16 rows and K, N multiples of 8, so the
    operands are zero-padded on the card up to that (a 2SSP-pruned down
    projection has any K); zeros add nothing to the integer sums."""
    m, (k, n) = a.shape[0], b.shape
    if a.device.type == "cpu":
        return torch.matmul(a.to(torch.int32), b.to(torch.int32))
    pad_m, pad_k, pad_n = max(17 - m, 0), -k % 8, -n % 8
    if pad_m or pad_k:
        a = F.pad(a, (0, pad_k, 0, pad_m))
    if pad_k or pad_n:
        b = F.pad(b, (0, pad_n, 0, pad_k))
    return torch._int_mm(a.contiguous(), b.contiguous())[:m, :n]


def w8a8_matmul(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                compute_dtype) -> torch.Tensor:
    """int8 x int8 matmul with dynamic per-token activation quantization:
    ``y = (round(x / sx) @ w_q) * sx * sw`` with ``sx = absmax(x, -1) / 127``.
    The integer product is a plain product outside any kernel of this
    package. Lossy (unlike the weight-only path); opt-in via
    ``dispatch.set_w8a8_enabled``."""
    x32 = x.float()
    ax = x32.abs().amax(dim=-1, keepdim=True)
    sx = torch.where(ax > 0, ax / 127.0, torch.ones_like(ax))
    x_q = torch.clamp(torch.round(x32 / sx), -127, 127).to(torch.int8)
    k, n = w_q.shape
    acc = _int8_matmul(x_q.reshape(-1, k), w_q).reshape(*x.shape[:-1], n).float()
    return (acc * sx * w_scale.float()).to(compute_dtype)
