"""Fused ViT FFN kernels with the 2SSP stage-1 importance side-output.

``fused_ffn_block`` replaces ``ssp_x_vit_tpu/ops/pallas/fused_ffn.py:
fused_ffn_block`` (``_ffn_block_kernel``):

    out   = x + gate * (fc2(mask * GELU(fc1(LN2(x)) + b1)) + b2)
    stats = sum over the s tokens of each image of GELU(...)^2   [b, f] fp32

``fused_ffn`` replaces ``fused_ffn.py:fused_ffn`` (``_ffn_kernel``): the same
without the LayerNorm and the residual, ``fc2(mask * GELU(fc1 x + b1)) + b2``.

Stats are taken after GELU and before the mask, in fp32, over all s tokens
including CLS; the kernel never pads rows, so no padded row can enter them.

On the card each wrapper launches, on the current stream: the LayerNorm
(block only), the fc1 GEMM with the GELU/stats/mask epilogue
(``csrc/gemm.cu``), then the fc2 GEMM with the bias (and gated residual)
epilogue. What bounds it: at ViT-B (b=64, s=197, d=768, f=3072) the two
products are ~119 GFLOP against ~80 MB of activations, compute-bound on the
tensor cores in bf16; the [b*s, f] activation is written once and read once
in the operand dtype between the two GEMMs (the Pallas kernel kept it in VMEM),
an extra ~155 MB of traffic at that shape that a fused fc1->fc2 kernel would
remove. The gate is a device scalar, so the candidate search runs without a
host sync per block.

On a CPU tensor each wrapper runs its plain version below (the jnp reference
math of ``ops/ffn.py``); a CUDA tensor always launches the kernel or raises.

Gradients, as the JAX ``custom_vjp`` of both kernels: under autograd (grad
mode on and an input that requires a gradient) a wrapper runs as a
``torch.autograd.Function`` whose forward is the kernel (the plain version on
a CPU tensor) and whose backward recomputes the plain version from the saved
inputs and takes its autodiff. No gradient flows through the stats side
output or to ``neuron_mask``; a gate given as a tensor gets its gradient, as
the JAX block's does. Otherwise the wrapper launches as before and saves
nothing.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from ssp_x_vit_tpu_torch.ops import dispatch
from ssp_x_vit_tpu_torch.ops.common import gelu, layer_norm
from ssp_x_vit_tpu_torch.ops.kernels import build, launch_counts

Gate = Union[None, float, torch.Tensor]


def gemm_plain(a, w, epi, *, bias=None, resid=None, gate=None, mask=None, seq=1,
               collect_stats=False):
    """Plain PyTorch version of one ``build.gemm`` launch: ``epilogue(a[m, k] @
    w[k, n])`` in fp32, rounded to a's dtype once, as the kernel stores it.
    ``epi`` is ``build.EPI_BIAS`` (+ bias), ``EPI_GELU`` (GELU of the biased sum,
    stats = the sum of its squares over each image's ``seq`` rows in fp32
    [m / seq, n] when ``collect_stats``, then times ``mask``) or ``EPI_RESIDUAL``
    (``resid + gate * (sum + bias)``). Returns (out, stats or None)."""
    v = a.float() @ w.float()
    if bias is not None:
        v = v + bias.float()
    stats = None
    if epi == build.EPI_GELU:
        v = gelu(v)
        if collect_stats:
            stats = v.square().reshape(-1, seq, v.shape[-1]).sum(dim=1)
        if mask is not None:
            v = v * mask.float()
    elif epi == build.EPI_RESIDUAL:
        v = resid.float() + (1.0 if gate is None else gate.float()) * v
    return v.to(a.dtype), stats


def fused_ffn_plain(x, fc1_kernel, fc1_bias, fc2_kernel, fc2_bias, *,
                    neuron_mask=None, collect_stats=False):
    """Plain PyTorch version of :func:`fused_ffn` (the jnp ``ffn_forward`` math)."""
    h = x @ fc1_kernel.to(x.dtype)
    if fc1_bias is not None:
        h = h + fc1_bias.to(x.dtype)
    h = gelu(h)
    stats = h.float().square().sum(dim=1) if collect_stats else None
    if neuron_mask is not None:
        h = h * neuron_mask.to(h.dtype)
    out = h @ fc2_kernel.to(x.dtype)
    if fc2_bias is not None:
        out = out + fc2_bias.to(x.dtype)
    return out, stats


def fused_ffn_block_plain(x, ln_scale, ln_bias, fc1_kernel, fc1_bias, fc2_kernel,
                          fc2_bias, *, neuron_mask=None, gate: Gate = None,
                          collect_stats=False, eps=1e-12):
    """Plain PyTorch version of :func:`fused_ffn_block`."""
    y = layer_norm(x, ln_scale, ln_bias, eps)
    out, stats = fused_ffn_plain(y, fc1_kernel, fc1_bias, fc2_kernel, fc2_bias,
                                 neuron_mask=neuron_mask, collect_stats=collect_stats)
    return x + dispatch.apply_gate(out, gate), stats


def _mask_tensor(neuron_mask, f, device):
    if neuron_mask is None:
        return None
    if neuron_mask.device != device:
        raise ValueError(f"neuron_mask is on {neuron_mask.device}, x on {device}")
    return torch.broadcast_to(neuron_mask, (f,)).to(torch.float32).contiguous()


def _ffn_cuda(x, ln, fc1_kernel, fc1_bias, fc2_kernel, fc2_bias, neuron_mask,
              gate, collect_stats, eps):
    """Launch the LayerNorm (if ``ln``), fc1 and fc2 kernels; ``ln`` is
    (scale, bias) or None, ``gate`` None means the plain ``+ b2`` epilogue."""
    b, s, d = x.shape
    f = fc1_kernel.shape[-1]
    dispatch.check_operands(x, [
        ("ln_scale", ln[0] if ln else None, (d,)), ("ln_bias", ln[1] if ln else None, (d,)),
        ("fc1_kernel", fc1_kernel, (d, f)), ("fc1_bias", fc1_bias, (f,)),
        ("fc2_kernel", fc2_kernel, (f, d)), ("fc2_bias", fc2_bias, (d,)),
    ])
    mask = _mask_tensor(neuron_mask, f, x.device)
    with torch.cuda.device(x.device):
        y = x if ln is None else build.layer_norm(x, ln[0], ln[1], eps)
        h = torch.empty((b * s, f), dtype=x.dtype, device=x.device)
        stats = torch.empty((b, f), dtype=torch.float32, device=x.device) if collect_stats else None
        build.gemm(y, fc1_kernel, h, build.EPI_GELU, bias=fc1_bias, mask=mask, stats=stats, seq=s)
        out = torch.empty_like(x)
        if gate is None:
            build.gemm(h, fc2_kernel, out, build.EPI_BIAS, bias=fc2_bias)
        else:
            build.gemm(h, fc2_kernel, out, build.EPI_RESIDUAL, bias=fc2_bias, resid=x, gate=gate)
    return out, stats


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def _plain_vjp(ctx, plain, g_out):
    """Gradients of ``plain(*saved)[0]`` for the inputs that need them, by
    autodiff of the plain version recomputed from the saved inputs."""
    saved = ctx.saved_tensors
    with torch.enable_grad():
        leaves = [None if t is None else t.detach().requires_grad_(need)
                  for t, need in zip(saved, ctx.needs_input_grad)]
        out, _ = plain(*leaves)
        wrt = [t for t, need in zip(leaves, ctx.needs_input_grad) if t is not None and need]
        grads = iter(torch.autograd.grad(out, wrt, g_out))
    return tuple(next(grads) if t is not None and need else None
                 for t, need in zip(saved, ctx.needs_input_grad))


def _ffn_forward(x, fc1_kernel, fc1_bias, fc2_kernel, fc2_bias, neuron_mask, collect_stats):
    if not dispatch.use_kernel(x):
        return fused_ffn_plain(x, fc1_kernel, fc1_bias, fc2_kernel, fc2_bias,
                               neuron_mask=neuron_mask, collect_stats=collect_stats)
    out = _ffn_cuda(x, None, fc1_kernel, fc1_bias, fc2_kernel, fc2_bias, neuron_mask,
                    None, collect_stats, 0.0)
    launch_counts["fused_ffn"] += 1
    return out


def _ffn_block_forward(x, ln_scale, ln_bias, fc1_kernel, fc1_bias, fc2_kernel, fc2_bias,
                       neuron_mask, gate, collect_stats, eps):
    if not dispatch.use_kernel(x):
        return fused_ffn_block_plain(x, ln_scale, ln_bias, fc1_kernel, fc1_bias, fc2_kernel,
                                     fc2_bias, neuron_mask=neuron_mask, gate=gate,
                                     collect_stats=collect_stats, eps=eps)
    out = _ffn_cuda(x, (ln_scale, ln_bias), fc1_kernel, fc1_bias, fc2_kernel, fc2_bias,
                    neuron_mask, dispatch.gate_tensor(gate, x.device), collect_stats, eps)
    launch_counts["fused_ffn_block"] += 1
    return out


class _FusedFFN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fc1_kernel, fc1_bias, fc2_kernel, fc2_bias, neuron_mask, collect_stats):
        out, stats = _ffn_forward(x, fc1_kernel, fc1_bias, fc2_kernel, fc2_bias, neuron_mask,
                                  collect_stats)
        ctx.save_for_backward(x, fc1_kernel, fc1_bias, fc2_kernel, fc2_bias, neuron_mask)
        if stats is not None:
            ctx.mark_non_differentiable(stats)
        return out, stats

    @staticmethod
    def backward(ctx, g_out, g_stats):
        def plain(x, w1, b1, w2, b2, mask):
            return fused_ffn_plain(x, w1, b1, w2, b2, neuron_mask=mask)

        *grads, _ = _plain_vjp(ctx, plain, g_out)
        return (*grads, None, None)  # neuron_mask, collect_stats


class _FusedFFNBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, fc1_kernel, fc1_bias, fc2_kernel, fc2_bias,
                neuron_mask, gate, collect_stats, eps):
        out, stats = _ffn_block_forward(x, ln_scale, ln_bias, fc1_kernel, fc1_bias, fc2_kernel,
                                        fc2_bias, neuron_mask, gate, collect_stats, eps)
        ctx.save_for_backward(x, ln_scale, ln_bias, fc1_kernel, fc1_bias, fc2_kernel, fc2_bias,
                              neuron_mask, gate if isinstance(gate, torch.Tensor) else None)
        ctx.gate_value = None if isinstance(gate, torch.Tensor) else gate
        ctx.eps = eps
        if stats is not None:
            ctx.mark_non_differentiable(stats)
        return out, stats

    @staticmethod
    def backward(ctx, g_out, g_stats):
        def plain(x, lns, lnb, w1, b1, w2, b2, mask, gate):
            return fused_ffn_block_plain(x, lns, lnb, w1, b1, w2, b2, neuron_mask=mask,
                                         gate=ctx.gate_value if gate is None else gate,
                                         eps=ctx.eps)

        *grads, g_mask, g_gate = _plain_vjp(ctx, plain, g_out)
        return (*grads, None, g_gate, None, None)  # neuron_mask, gate, collect_stats, eps


def fused_ffn(
    x: torch.Tensor,
    fc1_kernel: torch.Tensor,
    fc1_bias: Optional[torch.Tensor],
    fc2_kernel: torch.Tensor,
    fc2_bias: Optional[torch.Tensor],
    *,
    neuron_mask: Optional[torch.Tensor] = None,
    collect_stats: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``fc2(mask * GELU(fc1 x + b1)) + b2`` and optional stats [b, f] fp32."""
    if _needs_grad(x, fc1_kernel, fc1_bias, fc2_kernel, fc2_bias):
        return _FusedFFN.apply(x, fc1_kernel, fc1_bias, fc2_kernel, fc2_bias, neuron_mask,
                               collect_stats)
    return _ffn_forward(x, fc1_kernel, fc1_bias, fc2_kernel, fc2_bias, neuron_mask,
                        collect_stats)


def fused_ffn_block(
    x: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    fc1_kernel: torch.Tensor,
    fc1_bias: Optional[torch.Tensor],
    fc2_kernel: torch.Tensor,
    fc2_bias: Optional[torch.Tensor],
    *,
    neuron_mask: Optional[torch.Tensor] = None,
    gate: Gate = None,
    collect_stats: bool = False,
    eps: float = 1e-12,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``x + gate * fc2(mask * GELU(fc1(LN(x))))`` and optional stats [b, f] fp32."""
    if _needs_grad(x, ln_scale, ln_bias, fc1_kernel, fc1_bias, fc2_kernel, fc2_bias, gate):
        return _FusedFFNBlock.apply(x, ln_scale, ln_bias, fc1_kernel, fc1_bias, fc2_kernel,
                                    fc2_bias, neuron_mask, gate, collect_stats, eps)
    return _ffn_block_forward(x, ln_scale, ln_bias, fc1_kernel, fc1_bias, fc2_kernel, fc2_bias,
                              neuron_mask, gate, collect_stats, eps)
