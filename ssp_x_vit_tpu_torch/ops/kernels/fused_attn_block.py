"""Fused ViT attention-branch kernels.

Both wrappers compute

    out = x + gate * (proj(MHA(LN1(x))) + b_proj)

with one fused QKV projection ``[d, 3d]`` (q|k|v on the output axis), a
full-row fp32 softmax per head, P cast to the operand dtype before P @ V, and
an fp32 projection accumulator.

- ``fused_attn_block_v2`` replaces ``ssp_x_vit_tpu/ops/pallas/
  fused_attn_block.py:fused_attn_block_v2`` (``_kernel_v2``, even head counts).
- ``fused_attn_block`` replaces ``fused_attn_block.py:fused_attn_block``
  (``_kernel``, any head count; ViT-Ti/16 has 3 heads).

The two Pallas kernels differ only in how Mosaic's 128-lane rule let them
slice heads; the function is the same, so one CUDA path serves both. On the
card each wrapper launches, on the current stream: the LayerNorm, the QKV
GEMM with the bias epilogue (``csrc/gemm.cu``), the attention core
(``csrc/attention.cu``), then the projection GEMM with the gated-residual
epilogue, the gate read from a device scalar. The launches sit in the CUDA
body of the custom operators ``torch.ops.ssp.fused_attn_block_v2`` /
``fused_attn_block`` (``ops/kernels/library.py``), which the wrappers call on a
CUDA tensor, so a ``torch.export`` trace records one operator node per block
and the kernels launch (and are counted) when the exported program runs.

What bounds it: at ViT-B (b=64, s=197, d=768, 12 heads) the block is ~67 GFLOP
(QKV and projection 89%, attention core 11%) over ~40 MB of activations,
compute-bound on the tensor cores in bf16 (~68 us at 989 TFLOP/s). The design
keeps weights and activations in the operand dtype, runs the two projections
as wgmma GEMMs fed by TMA, and the core with wgmma QK^T and PV, each head's
K and V read from device memory once and the softmax in registers. The LN
output, q/k/v and the attention output each make one HBM round trip (~155 MB
at that shape in bf16), which a later fused kernel can remove.

On a CPU tensor each wrapper runs its plain version below (the XLA-branch math
of ``models/vit.py:_block_apply``, with the plain core ``sdpa_reference`` on
every device, so the plain version launches no kernel); a CUDA tensor always
launches or raises.
``residual=False`` leaves ``x`` out: ``gate * (proj(MHA(LN1(x))) +
b_proj)``, the partial sum of a tensor-parallel rank (``models/vit.py``
sums the ranks' partials, one of them with the residual and the bias). The
shard's ``qkv_kernel`` is ``[d, 3 d_r]`` (this rank's heads of q, k and v),
``proj_kernel`` ``[d_r, d]`` and ``num_heads`` its own head count; on the
card the projection's epilogue is then the bias one with the gate, ``gate *
(acc + b_proj)``, rounded once.

The kernels have no backward, as the Pallas kernels have no JVP rule: on a
CUDA tensor under autograd (grad mode on and an input that requires a
gradient) the wrappers raise; differentiate through
``vit_forward(..., allow_fused_attn=False)``, as the JAX package's finetune
steps do.
"""

from __future__ import annotations

from typing import Union

import torch

from ssp_x_vit_tpu_torch.ops import dispatch
from ssp_x_vit_tpu_torch.ops.attention import multi_head_attention, sdpa_reference
from ssp_x_vit_tpu_torch.ops.common import layer_norm
from ssp_x_vit_tpu_torch.ops.kernels import library
from ssp_x_vit_tpu_torch.ops.kernels.library import SMEM_LIMIT_BYTES  # noqa: F401

Gate = Union[None, float, torch.Tensor]


def _attn_block_plain(x, ln_scale, ln_bias, qkv_kernel, qkv_bias, proj_kernel, proj_bias,
                      num_heads, eps, gate, residual=True):
    # The plain core on every device (``sdpa_reference``: fp32 logits and
    # softmax, P rounded to the operand dtype before P @ V, as the Pallas
    # kernels round it), so the plain version launches no kernel of this
    # package and a card check holds the kernels against plain PyTorch.
    attn = multi_head_attention(layer_norm(x, ln_scale, ln_bias, eps), qkv_kernel, qkv_bias,
                                proj_kernel, proj_bias, num_heads, use_flash=False)
    attn = dispatch.apply_gate(attn, gate)
    return x + attn if residual else attn


def head_view(t: torch.Tensor, b: int, s: int, num_heads: int) -> torch.Tensor:
    """[b*s, d] (heads side by side on the last axis) -> the [b, h, s, hd] view."""
    return t.reshape(b, s, num_heads, -1).permute(0, 2, 1, 3)


def attention_core_plain(qkv: torch.Tensor, b: int, s: int, num_heads: int) -> torch.Tensor:
    """Plain PyTorch version of the attention core (``build.attention``) on the
    fused QKV buffer [b*s, 3d]: ``sdpa_reference`` per head (fp32 logits and
    full-row softmax, P rounded to the operand dtype before P @ V); [b*s, d]."""
    d = qkv.shape[-1] // 3
    q, k, v = (head_view(t, b, s, num_heads) for t in qkv.split(d, dim=-1))
    return sdpa_reference(q, k, v).permute(0, 2, 1, 3).reshape(b * s, d)


def fused_attn_block_v2_plain(x, ln_scale, ln_bias, qkv_kernel, qkv_bias, proj_kernel,
                              proj_bias, num_heads, *, eps=1e-12, gate: Gate = None,
                              residual: bool = True):
    """Plain PyTorch version of :func:`fused_attn_block_v2`."""
    return _attn_block_plain(x, ln_scale, ln_bias, qkv_kernel, qkv_bias, proj_kernel,
                             proj_bias, num_heads, eps, gate, residual)


def fused_attn_block_plain(x, ln_scale, ln_bias, qkv_kernel, qkv_bias, proj_kernel,
                           proj_bias, num_heads, *, eps=1e-12, gate: Gate = None,
                           residual: bool = True):
    """Plain PyTorch version of :func:`fused_attn_block`."""
    return _attn_block_plain(x, ln_scale, ln_bias, qkv_kernel, qkv_bias, proj_kernel,
                             proj_bias, num_heads, eps, gate, residual)


def _check_no_grad(*tensors) -> None:
    if torch.is_grad_enabled() and any(isinstance(t, torch.Tensor) and t.requires_grad
                                       for t in tensors):
        raise RuntimeError("the fused attention block kernels have no backward (as in the JAX "
                           "package); differentiate through vit_forward(..., "
                           "allow_fused_attn=False)")


def fused_attn_block_v2(x, ln_scale, ln_bias, qkv_kernel, qkv_bias, proj_kernel, proj_bias,
                        num_heads: int, *, eps: float = 1e-12, gate: Gate = None,
                        residual: bool = True):
    """x [b, s, d] -> x + gate * proj(attention(LN(x))); even head counts."""
    if num_heads % 2:
        raise ValueError("fused_attn_block_v2 needs an even head count")
    if not dispatch.use_kernel(x):
        return fused_attn_block_v2_plain(x, ln_scale, ln_bias, qkv_kernel, qkv_bias,
                                         proj_kernel, proj_bias, num_heads, eps=eps, gate=gate,
                                         residual=residual)
    _check_no_grad(x, ln_scale, ln_bias, qkv_kernel, qkv_bias, proj_kernel, proj_bias, gate)
    library.check_attn_block(x, ln_scale, ln_bias, qkv_kernel, qkv_bias, proj_kernel, proj_bias,
                             num_heads, residual)
    return torch.ops.ssp.fused_attn_block_v2(
        x, ln_scale, ln_bias, qkv_kernel, qkv_bias, proj_kernel, proj_bias,
        dispatch.gate_tensor(gate, x.device), num_heads, eps, residual)


def fused_attn_block(x, ln_scale, ln_bias, qkv_kernel, qkv_bias, proj_kernel, proj_bias,
                     num_heads: int, *, eps: float = 1e-12, gate: Gate = None,
                     residual: bool = True):
    """x [b, s, d] -> x + gate * proj(attention(LN(x))); any head count."""
    if not dispatch.use_kernel(x):
        return fused_attn_block_plain(x, ln_scale, ln_bias, qkv_kernel, qkv_bias,
                                      proj_kernel, proj_bias, num_heads, eps=eps, gate=gate,
                                      residual=residual)
    _check_no_grad(x, ln_scale, ln_bias, qkv_kernel, qkv_bias, proj_kernel, proj_bias, gate)
    library.check_attn_block(x, ln_scale, ln_bias, qkv_kernel, qkv_bias, proj_kernel, proj_bias,
                             num_heads, residual)
    return torch.ops.ssp.fused_attn_block(
        x, ln_scale, ln_bias, qkv_kernel, qkv_bias, proj_kernel, proj_bias,
        dispatch.gate_tensor(gate, x.device), num_heads, eps, residual)
