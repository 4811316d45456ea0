"""Weight-only quantized matmuls (replace ``ssp_x_vit_tpu/ops/pallas/
quant_matmul.py``: ``quant_matmul`` and ``quant4_matmul``).

    quant_matmul (x [.., K], w_q [K, N] int8,     scale [N]) -> [.., N]
    quant4_matmul(x [.., K], w_p [K/2, N] packed, scale [N]) -> [.., N]
        == (x @ w.to(x.dtype)) * scale, accumulated in fp32, stored in x.dtype

int4 packing (``pack_int4``): one int8 byte holds logical rows ``k`` (low
nibble, biased by +8 into [0, 15]) and ``k + K/2`` (high nibble, two's
complement), so the byte value is ``16*hi + (lo + 8)`` and K must be even.

On the card both wrappers launch ``csrc/quant_gemm.cu`` (tiles:
``csrc/qgemm_tile.cuh``, wgmma with TMA loads in bf16): the weight bytes go to
shared memory as stored and become bf16 in registers, so no dequantised copy
of the weight exists in device memory; the scale is applied per output column
in the epilogue. What bounds it: ``2*M*N*K`` operations against the
activations plus ``K*N`` (int8) or ``K*N/2`` (int4) stored weight bytes, so
operations at the perplexity path's thousands of rows and weight bytes at a
handful of rows. bf16 int4 walks stored rows, so each packed byte is fetched
once and feeds both of its logical rows.

On a CPU tensor each wrapper runs its plain version (unpack, cast, matmul,
scale); a CUDA tensor calls the custom operator ``torch.ops.ssp.quant_matmul`` /
``quant4_matmul`` (``ops/kernels/library.py``), whose CUDA body launches the
kernel or raises, so a ``torch.export`` trace records the operator.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ssp_x_vit_tpu_torch.ops import dispatch
from ssp_x_vit_tpu_torch.ops.kernels import library


def pack_int4(w_q4: torch.Tensor) -> torch.Tensor:
    """[..., K, N] int8 values in [-8, 7] -> [..., K//2, N] packed int8
    (split-half: low nibble = row k biased by +8, high nibble = row k + K/2)."""
    k = w_q4.shape[-2]
    if k % 2:
        raise ValueError(f"int4 packing needs even K, got {k}")
    lo = (w_q4[..., : k // 2, :].to(torch.int32) + 8) & 0xF
    hi = w_q4[..., k // 2:, :].to(torch.int32) & 0xF
    # values above 127 wrap to the negative int8 of the same byte
    return ((hi << 4) | lo).to(torch.uint8).view(torch.int8)


def unpack_int4(w_p: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4` -> [..., K, N] int8 in [-8, 7]."""
    p = w_p.to(torch.int32)
    lo = (p & 15) - 8
    hi = p >> 4  # arithmetic shift of the signed byte
    return torch.cat([lo, hi], dim=-2).to(torch.int8)


def quantize_weight_int4(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int4: (packed [..., K//2, N] int8, scale
    [..., N] fp32), per (leading dims, output channel)."""
    w = w.float()
    absmax = w.abs().amax(dim=-2)
    scale = torch.where(absmax > 0, absmax / 7.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(w / scale[..., None, :]), -8, 7).to(torch.int8)
    return pack_int4(q), scale


def quant_matmul_plain(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`quant_matmul`."""
    acc = torch.matmul(x.float(), w_q.to(x.dtype).float())
    return (acc * scale.float()).to(x.dtype)


def quant4_matmul_plain(x: torch.Tensor, w_p: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`quant4_matmul`."""
    return quant_matmul_plain(x, unpack_int4(w_p), scale)


def quant_matmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``(x @ w_q.to(x.dtype)) * scale`` for int8 ``w_q`` [K, N]."""
    if not dispatch.use_kernel(x):
        return quant_matmul_plain(x, w_q, scale)
    library.check_quant(x, w_q, scale, 8)
    return torch.ops.ssp.quant_matmul(x, w_q, scale)


def quant4_matmul(x: torch.Tensor, w_p: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``(x @ unpack_int4(w_p).to(x.dtype)) * scale`` for packed ``w_p`` [K/2, N]."""
    if not dispatch.use_kernel(x):
        return quant4_matmul_plain(x, w_p, scale)
    library.check_quant(x, w_p, scale, 4)
    return torch.ops.ssp.quant4_matmul(x, w_p, scale)
