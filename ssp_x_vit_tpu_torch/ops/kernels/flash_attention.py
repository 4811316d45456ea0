"""Flash attention forward and backward (replaces ``ssp_x_vit_tpu/ops/pallas/
flash_attention.py``: the forwards ``_flash_forward``,
``_flash_forward_multihead``, ``_flash_forward_streaming`` and the backwards
``_flash_backward_pallas`` and ``_flash_backward_streaming``).

    out = softmax(mask(softcap(q k^T / sqrt(hd)))) v

for q ``[b, h, s, hd]`` and k, v ``[b, hkv, s, hd]``. GQA-native: query head
``h`` reads KV head ``h // (h / hkv)`` and K/V are never repeated in device
memory. ``causal`` masks ``col > row``; ``window`` (needs ``causal``) keeps
``row - col < window``; ``softcap`` applies ``cap * tanh(logits / cap)`` to
the scaled logits before the mask. fp32 logits and softmax, ``p`` rounded to
``v``'s dtype before the second product.

On the card the forward launches ``csrc/flash_attention.cu`` (one kernel
walking 64-key tiles with an online softmax; bf16 on Hopper's wgmma with TMA
loads and the softmax in registers, fp32 in exact fp32 on SIMT). What bounds
it: ``4 * hd`` operations per unmasked (query, key) pair against q, k, v and
o moved once, so it is operations-bound at every LLM shape. Under autograd
(a tensor that requires grad, grad mode on) the call goes through
``_FlashAttention``: the forward also stores each row's fp32 log-sum-exp, and
the backward launches the two kernels of ``csrc/flash_attention_bwd.cu`` (dq
with delta = rowsum(dout * out), then dk and dv summed over each query group
in-kernel; ``10 * hd`` operations per pair). Without grad the forward passes
no lse pointer and runs as before.

On a CPU tensor the forward runs ``flash_attention_plain`` (``sdpa_reference``
on repeated K/V) and the backward ``flash_attention_backward_plain``; a CUDA
tensor always launches the kernels or raises.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ssp_x_vit_tpu_torch.ops import dispatch
from ssp_x_vit_tpu_torch.ops.kernels import build, launch_counts

MAX_HEAD_DIM = 256  # the largest head_dim tile the kernels are built for

# Limits of ``flash_errors`` per dtype: relative RMS error of the whole
# tensor, of the worst 64-row tile, and the absolute RMS error allowed beside
# both (values that cancel to about 0, such as early rows of dq, or all of dq
# under a window of 1). Set 3.4x or more above the largest errors that the
# bf16 kernels on wgmma and the WMMA ones before them reach
# (scripts/torch_flash_errors.py; PERF.md, flash findings).
FLASH_LIMITS = {torch.float32: (1e-5, 1e-4, 3e-6), torch.bfloat16: (1e-2, 3e-2, 1e-4)}
FLASH_TILE = 64  # rows of a tile: a query tile of q, out and dq, a key tile of dk and dv


def flash_errors(got: torch.Tensor, plain: torch.Tensor) -> Tuple[float, float]:
    """(whole-tensor, worst-tile) error of a flash kernel's output or gradient
    [..., s, hd] against its plain version: rms(got - plain) over
    rms(plain) + atol / rtol (``FLASH_LIMITS`` of got's dtype), for the whole
    tensor and for every tile of ``FLASH_TILE`` rows of every leading index.
    Each passes at <= its rtol, which is allclose(rms(diff), rms(plain)).

    The scaled error every kernel check uses, max |diff| / max(1, max |plain|),
    is blind here: with random q, k, v at head_dim 128 a causal row i's outputs
    are about sqrt(e / (i + 1)) while row 0 (= v[0]) sets the scale, so a late
    query tile written as zeros, or another head's rows, would pass it. The
    tile error sees every tile."""
    rtol, tile_rtol, atol = FLASH_LIMITS[got.dtype]
    ref = plain.float()
    diff = got.float() - ref
    rel = (diff.pow(2).mean().sqrt() / (ref.pow(2).mean().sqrt() + atol / rtol)).item()
    s = ref.shape[-2]
    pad = (-s) % FLASH_TILE
    tiles = ref.shape[:-2] + ((s + pad) // FLASH_TILE, FLASH_TILE * ref.shape[-1])
    rows = torch.nn.functional.pad(torch.ones(s, device=ref.device), (0, pad))
    count = rows.view(-1, FLASH_TILE).sum(-1) * ref.shape[-1]

    def tile_ms(x):  # mean square of each tile's real rows
        return torch.nn.functional.pad(x.pow(2), (0, 0, 0, pad)).reshape(tiles).sum(-1) / count

    tile = (tile_ms(diff).sqrt() / (tile_ms(ref).sqrt() + atol / tile_rtol)).max().item()
    return rel, tile


def flash_agrees(got: torch.Tensor, plain: torch.Tensor) -> bool:
    """Both ``flash_errors`` within their ``FLASH_LIMITS``."""
    rtol, tile_rtol, _ = FLASH_LIMITS[got.dtype]
    rel, tile = flash_errors(got, plain)
    return rel <= rtol and tile <= tile_rtol


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = False, window: Optional[int] = None,
                          softcap: Optional[float] = None, q_offset: int = 0,
                          with_lse: bool = False):
    """Plain PyTorch version: repeat K/V over the query group, then
    ``sdpa_reference`` (the whole [s, s] logits in fp32). ``q_offset`` puts
    query row r at key position r + q_offset in the causal and window masks;
    ``with_lse`` returns (out, fp32 [b, h, s] row log-sum-exp). Under either, a
    row whose keys are all masked gets an output of 0 and an lse of -inf, as
    the kernel does."""
    from ssp_x_vit_tpu_torch.ops.attention import sdpa_reference

    rep = q.shape[1] // k.shape[1]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    if q_offset == 0 and not with_lse:
        return sdpa_reference(q, k, v, causal=causal, window=window, softcap=softcap)
    if window is not None and not causal:
        raise ValueError("sliding window requires causal attention")
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(q.shape[-1])
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    if causal:
        qi = torch.arange(q.shape[2], device=q.device)[:, None] + q_offset
        ki = torch.arange(k.shape[2], device=q.device)[None, :]
        mask = ki <= qi
        if window is not None:
            mask = mask & (qi - ki < window)
        logits = logits.masked_fill(~mask, float("-inf"))
    lse = torch.logsumexp(logits, dim=-1)
    weights = torch.exp(logits - torch.where(torch.isfinite(lse), lse, 0.0)[..., None])
    out = torch.einsum("bhqk,bhkd->bhqd", weights.to(v.dtype), v)
    return (out, lse) if with_lse else out


def flash_attention_backward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                   dout: torch.Tensor, *, causal: bool = False,
                                   window: Optional[int] = None, softcap: Optional[float] = None
                                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch backward: the explicit formula in fp32 over the whole
    [s, s] logits, dk and dv summed over each query group. A row that no key
    reaches gets p = 0 (the Pallas kernel's denominator guard). Returns
    (dq, dk, dv) in the dtypes of q, k, v."""
    b, h, s, hd = q.shape
    hkv = k.shape[1]
    rep = h // hkv
    scale = 1.0 / math.sqrt(hd)
    qf, gf = q.float(), dout.float()
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    if softcap is not None:
        tcap = torch.tanh(logits / softcap)
        logits = softcap * tcap
    if causal:
        i = torch.arange(s, device=q.device)
        mask = i[None, :] <= i[:, None]
        if window is not None:
            mask = mask & (i[:, None] - i[None, :] < window)
        logits = logits.masked_fill(~mask, float("-inf"))
    m = logits.amax(dim=-1, keepdim=True)
    e = torch.exp(logits - torch.where(torch.isfinite(m), m, torch.zeros_like(m)))
    p = e / e.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    dp = torch.einsum("bhqd,bhkd->bhqk", gf, vf)
    delta = (p * dp).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    if softcap is not None:
        ds = ds * (1.0 - tcap * tcap)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = (torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale).reshape(b, hkv, rep, s, hd).sum(2)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, gf).reshape(b, hkv, rep, s, hd).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
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


def _options(window: Optional[int], softcap: Optional[float]) -> dict:
    return dict(window=0 if window is None else int(window),
                softcap=0.0 if softcap is None else float(softcap))


def flash_attention_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                            causal: bool = False, window: Optional[int] = None,
                            softcap: Optional[float] = None, with_lse: bool = False,
                            q_offset: int = 0
                            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One launch of the forward kernel on CUDA tensors: (out, lse), lse the
    fp32 [b, h, s] row log-sum-exp when ``with_lse``, else None. ``q_offset``
    (>= 0) puts query row r at key position r + q_offset in the masks (a ring
    hop over an earlier key chunk); a row with no key gets 0 and lse -inf."""
    _check(q, k, v)
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    b, h, s, hd = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(b, h, s, dtype=torch.float32, device=q.device) if with_lse else None
    with torch.cuda.device(q.device):
        build.flash_attention(q, k, v, out, scale=1.0 / math.sqrt(hd), causal=causal, lse=lse,
                              q_offset=q_offset, **_options(window, softcap))
    launch_counts["flash_attention"] += 1
    return out, lse


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor, *,
                             causal: bool = False, window: Optional[int] = None,
                             softcap: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The two backward kernels on CUDA tensors: (dq, dk, dv) from the forward's
    ``out`` and ``lse``; ``dout`` like ``out``."""
    _check(q, k, v)
    b, h, s, hd = q.shape
    for name, t, dtype in (("out", out, q.dtype), ("dout", dout, q.dtype),
                           ("lse", lse, torch.float32)):
        shape = (b, h, s) if name == "lse" else (b, h, s, hd)
        if t.device != q.device or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {shape} on {q.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty(b, h, s, dtype=torch.float32, device=q.device)
    kw = dict(scale=1.0 / math.sqrt(hd), causal=causal, **_options(window, softcap))
    with torch.cuda.device(q.device):
        build.flash_attention_bwd_dq(q, k, v, out, dout, lse, delta, dq, **kw)
        launch_counts["flash_attention_bwd_dq"] += 1
        build.flash_attention_bwd_dkv(q, k, v, dout, lse, delta, dk, dv, **kw)
        launch_counts["flash_attention_bwd_dkv"] += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Flash attention under autograd: the forward saves (q, k, v, out, lse),
    the backward runs the kernels (CUDA) or the plain backward (CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        if dispatch.use_kernel(q):
            out, lse = flash_attention_forward(q, k, v, causal=causal, window=window,
                                               softcap=softcap, with_lse=True)
        else:
            out, lse = flash_attention_plain(q, k, v, causal=causal, window=window,
                                             softcap=softcap), None
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.options = dict(causal=causal, window=window, softcap=softcap)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if dispatch.use_kernel(q):
            grads = flash_attention_backward(q, k, v, out, lse, dout.contiguous(), **ctx.options)
        else:
            grads = flash_attention_backward_plain(q, k, v, dout, **ctx.options)
        return (*grads, None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """q [b, h, s, hd], k/v [b, hkv, s, hd] -> [b, h, s, hd] (arguments already
    validated by ``ops.attention.flash_attention``, the public entry)."""
    use_kernel = dispatch.use_kernel(q)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window, softcap)
    if not use_kernel:
        return flash_attention_plain(q, k, v, causal=causal, window=window, softcap=softcap)
    return flash_attention_forward(q, k, v, causal=causal, window=window, softcap=softcap)[0]
