"""The hand-written kernels of rows 1-4, 10 and 11 (PERF.md) as ``torch.library``
custom operators, namespace ``ssp``.

    torch.ops.ssp.fused_attn_block_v2   row 1   x-shaped
    torch.ops.ssp.fused_attn_block      row 2   x-shaped
    torch.ops.ssp.fused_ffn_block       row 3   (x-shaped, stats [b, f] fp32 or [0])
    torch.ops.ssp.fused_ffn             row 4   (x-shaped, stats [b, f] fp32 or [0])
    torch.ops.ssp.quant_matmul          row 10  [.., N]    (int8 weights)
    torch.ops.ssp.quant4_matmul         row 10  [.., N]    (packed int4 weights)
    torch.ops.ssp.fused_mlp_int8        row 11  x-shaped

Each operator is registered for CUDA only. Its CUDA body holds everything that
touches the device: the ctypes call on ``data_ptr()``, the split-K workspace,
the ticket counters and the ``launch_counts`` increment. Under ``torch.export`` (or any fake-tensor trace) the operator's
fake implementation runs instead; it only makes empty outputs of the plain
version's shapes and dtypes, so a traced program holds one ``ssp`` node per
call, the kernel launches (and is counted) when the program runs, and no
trace fills a device cache. The wrappers in ``fused_attn_block.py``,
``fused_ffn.py``, ``quant_matmul.py`` and ``quant_fused_mlp.py`` keep their
names and dispatch rule (``ops/dispatch.py``: a CUDA tensor calls the operator,
a CPU tensor the plain version, which never reaches it), and check the operands
(``check_*`` below: shapes, dtypes, devices, contiguity) before the call, so a
fake tensor is refused at trace time as a real one is. Optional arguments are
normalized before the call (``dispatch.gate_tensor``): a float gate becomes
a float32 scalar tensor, ``None`` stays ``None`` (the GEMM epilogue reads a
null gate as 1); the stats come back as a tensor always, empty
when not asked for. Nothing falls back: a library that fails to build or to
launch raises from inside the operator.

This module alone defines the operators (``torch.library`` refuses a name
defined twice in one process); every wrapper imports it.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch

from ssp_x_vit_tpu_torch.ops import dispatch
from ssp_x_vit_tpu_torch.ops.kernels import build, launch_counts

NAMESPACE = "ssp"

SMEM_LIMIT_BYTES = 232_448  # per-block dynamic shared memory on the H100 (227 KB)

Tensor = torch.Tensor


# ---------------------------------------------------- checks and launches ---
# ``check_*``: the wrappers' checks, on real or fake tensors. ``*_launch``:
# plain functions on real CUDA tensors; only the operators' CUDA bodies and
# the card's measurement hooks call them, never a trace.

def check_attn_block(x, ln_scale, ln_bias, qkv_kernel, qkv_bias, proj_kernel, proj_bias,
                     num_heads, residual=True) -> None:
    """Raise for what rows 1-2 do not take (the wrappers' check before the
    operator; shapes, dtypes, devices and contiguity, so fake tensors pass it
    as real ones do)."""
    d = x.shape[-1]
    dh = qkv_kernel.shape[-1] // 3   # the heads' width: d, or a tensor-parallel rank's share
    if dh % num_heads:
        raise ValueError(f"attention width {dh} is not divisible by {num_heads} heads")
    dispatch.check_operands(x, [
        ("ln_scale", ln_scale, (d,)), ("ln_bias", ln_bias, (d,)),
        ("qkv_kernel", qkv_kernel, (d, 3 * dh)), ("qkv_bias", qkv_bias, (3 * dh,)),
        ("proj_kernel", proj_kernel, (dh, d)), ("proj_bias", proj_bias, (d,)),
    ])
    if qkv_bias is None or (residual and proj_bias is None):
        raise ValueError("the attention kernel takes qkv and projection biases")


def attn_block_launch(x, ln_scale, ln_bias, qkv_kernel, qkv_bias, proj_kernel, proj_bias,
                      num_heads, eps, gate, residual=True):
    """Rows 1-2 on the card (operands as ``check_attn_block`` passes them): the
    LayerNorm, the QKV GEMM with the bias epilogue, the attention core, then
    the projection GEMM with the gated residual epilogue (``residual=False``:
    the bias one with the gate)."""
    b, s, d = x.shape
    dh = qkv_kernel.shape[-1] // 3
    hd = dh // num_heads
    with torch.cuda.device(x.device):
        smem = build.attention_smem_bytes(x.dtype, s, hd)
        if hd > 128 or smem > SMEM_LIMIT_BYTES:
            raise ValueError(f"attention kernel takes head_dim <= 128 and K/V of one head in "
                             f"shared memory; s={s}, head_dim={hd} needs {smem} bytes")
        y = build.layer_norm(x, ln_scale, ln_bias, eps)
        qkv = build.gemm(y, qkv_kernel,
                         torch.empty((b * s, 3 * dh), dtype=x.dtype, device=x.device),
                         build.EPI_BIAS, bias=qkv_bias)
        o = build.attention(qkv, torch.empty((b * s, dh), dtype=x.dtype, device=x.device),
                            b, s, num_heads, hd, 1.0 / math.sqrt(hd))
        if residual:
            return build.gemm(o, proj_kernel, torch.empty_like(x), build.EPI_RESIDUAL,
                              bias=proj_bias, resid=x, gate=gate)
        return build.gemm(o, proj_kernel, torch.empty_like(x), build.EPI_BIAS, bias=proj_bias,
                          gate=gate)


def check_ffn(x, ln, fc1_kernel, fc1_bias, fc2_kernel, fc2_bias, neuron_mask) -> None:
    """Raise for what rows 3-4 do not take (``ln``: (scale, bias) or None)."""
    d = x.shape[-1]
    f = fc1_kernel.shape[-1]
    dispatch.check_operands(x, [
        ("ln_scale", ln[0] if ln else None, (d,)), ("ln_bias", ln[1] if ln else None, (d,)),
        ("fc1_kernel", fc1_kernel, (d, f)), ("fc1_bias", fc1_bias, (f,)),
        ("fc2_kernel", fc2_kernel, (f, d)), ("fc2_bias", fc2_bias, (d,)),
    ])
    if neuron_mask is not None and neuron_mask.device != x.device:
        raise ValueError(f"neuron_mask is on {neuron_mask.device}, x on {x.device}")


def ffn_launch(x, ln, fc1_kernel, fc1_bias, fc2_kernel, fc2_bias, neuron_mask, gate,
               collect_stats, eps, residual=True):
    """Rows 3-4 on the card (operands as ``check_ffn`` passes them): the
    LayerNorm (if ``ln``, (scale, bias)), fc1 with the GELU / stats / mask
    epilogue, fc2 with the block's ``x + gate * (. + b2)`` where ``ln`` is
    given and ``residual``, else ``gate * (. + b2)`` (``gate`` None = 1).
    Returns (out, stats [b, f] fp32 or None)."""
    b, s, d = x.shape
    f = fc1_kernel.shape[-1]
    mask = None if neuron_mask is None else \
        torch.broadcast_to(neuron_mask, (f,)).to(torch.float32).contiguous()
    with torch.cuda.device(x.device):
        y = x if ln is None else build.layer_norm(x, ln[0], ln[1], eps)
        h = torch.empty((b * s, f), dtype=x.dtype, device=x.device)
        stats = torch.empty((b, f), dtype=torch.float32, device=x.device) if collect_stats else None
        build.gemm(y, fc1_kernel, h, build.EPI_GELU, bias=fc1_bias, mask=mask, stats=stats, seq=s)
        out = torch.empty_like(x)
        if ln is not None and residual:
            build.gemm(h, fc2_kernel, out, build.EPI_RESIDUAL, bias=fc2_bias, resid=x, gate=gate)
        else:
            build.gemm(h, fc2_kernel, out, build.EPI_BIAS, bias=fc2_bias, gate=gate)
    return out, stats


def check_quant(x: Tensor, w: Tensor, scale: Tensor, bits: int) -> None:
    """Raise for what row 10 does not take: int8 (bits 8) or packed int4
    (bits 4) weights."""
    k = x.shape[-1]
    n = w.shape[-1]
    k_rows = k if bits == 8 else k // 2
    if bits == 4 and k % 2:
        raise ValueError(f"int4 weights need even K, got {k}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"kernels take float32 or bfloat16 activations, got {x.dtype}")
    if w.dtype != torch.int8 or tuple(w.shape) != (k_rows, n):
        raise ValueError(f"weight must be int8 {(k_rows, n)}, got {w.dtype} {tuple(w.shape)}")
    if scale.dtype != torch.float32 or tuple(scale.shape) != (n,):
        raise ValueError(f"scale must be float32 {(n,)}, got {scale.dtype} {tuple(scale.shape)}")
    for name, t in (("weight", w), ("scale", scale)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.numel() == 0:
        raise ValueError("x is empty")


def quant_launch(x: Tensor, w: Tensor, scale: Tensor, bits: int) -> Tensor:
    """Row 10 on the card: ``(x @ dequant(w)) * scale`` (operands as
    ``check_quant`` passes them)."""
    out = torch.empty((*x.shape[:-1], w.shape[-1]), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        build.quant_gemm(x, w, scale, out, bits)
    return out


def check_fused_mlp(x, gq, gs, uq, us, dq, ds) -> None:
    """Raise for what row 11 does not take."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_mlp_int8 takes float32 or bfloat16 activations, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.numel() == 0:
        raise ValueError("x is empty")
    d = x.shape[-1]
    if x.numel() // d > dispatch.MAX_ROWS:
        raise ValueError(f"fused_mlp_int8 takes at most {dispatch.MAX_ROWS} rows")
    f = gq.shape[-1] if gq.dim() == 2 else -1
    for name, t, shape in (("gate_q", gq, (d, f)), ("up_q", uq, (d, f)), ("down_q", dq, (f, d))):
        if t.dtype != torch.int8 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be int8 {shape}, got {t.dtype} {tuple(t.shape)}")
    for name, t, n in (("gate_scale", gs, f), ("up_scale", us, f), ("down_scale", ds, d)):
        if t.dtype != torch.float32 or tuple(t.shape) != (n,):
            raise ValueError(f"{name} must be float32 {(n,)}, got {t.dtype} {tuple(t.shape)}")
    for name, t in (("gate_q", gq), ("gate_scale", gs), ("up_q", uq), ("up_scale", us),
                    ("down_q", dq), ("down_scale", ds)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


@functools.lru_cache(maxsize=None)
def _fused_mlp_scratch_sizes(device_index: int, dtype_code: int, m: int, d: int, f: int,
                             wide: bool) -> Tuple[int, int]:
    """(fp32 workspace floats, int32 ticket counters) of one call at these shapes."""
    with torch.cuda.device(device_index):
        lib = build.library("quant_fused_mlp")
        return (lib.ssp_fused_mlp_int8_workspace_floats(dtype_code, m, d, f, int(wide)),
                lib.ssp_fused_mlp_int8_tickets(dtype_code, m, d, f, int(wide)))


def fused_mlp_int8_launch(x, gq, gs, uq, us, dq, ds, *, wide: bool = False) -> Tensor:
    """Row 11 on the card: one call of ``csrc/quant_fused_mlp.cu`` (no count;
    operands as ``check_fused_mlp`` passes them). ``wide=True`` takes the
    tensor-core tiles at any row count; it is a measurement hook only, the
    yardstick of the weight stream at m <= 16; the serving path never sets it."""
    d, f = x.shape[-1], gq.shape[-1]
    m = x.numel() // d
    dt = build.DTYPE_CODES[x.dtype]
    h = torch.empty((m, f), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    ws_floats, n_tickets = _fused_mlp_scratch_sizes(x.device.index, dt, m, d, f, wide)
    ws = torch.empty(ws_floats, dtype=torch.float32, device=x.device) if ws_floats else None
    tickets = build.tickets(x.device, n_tickets) if n_tickets else None
    with torch.cuda.device(x.device):
        build.check(build.library("quant_fused_mlp").ssp_fused_mlp_int8(
            dt, x.data_ptr(), gq.data_ptr(), gs.data_ptr(), uq.data_ptr(), us.data_ptr(),
            dq.data_ptr(), ds.data_ptr(), h.data_ptr(), out.data_ptr(), m, d, f, int(wide),
            build._ptr(ws), build._ptr(tickets), build._stream()), "ssp_fused_mlp_int8")
    return out


# ------------------------------------------------------------ operators ---
# Defined with ``torch.library.Library`` (``define`` + a CUDA ``impl`` +
# ``register_fake``), not ``torch.library.custom_op``: the latter wraps each
# kernel in ``torch._disable_dynamo``, whose first call imports
# ``torch._dynamo`` (~840 modules; ~10 s in a fresh process on the card's
# host), a cost every process of the port would pay at its first launch.

_LIB = torch.library.Library(NAMESPACE, "DEF")   # kept alive: it holds the registrations

_ATTN = ("(Tensor x, Tensor ln_scale, Tensor ln_bias, Tensor qkv_kernel, Tensor? qkv_bias, "
         "Tensor proj_kernel, Tensor? proj_bias, Tensor? gate, int num_heads, float eps, "
         "bool residual) -> Tensor")
SCHEMAS = {
    "fused_attn_block_v2": _ATTN,
    "fused_attn_block": _ATTN,
    "fused_ffn_block": ("(Tensor x, Tensor ln_scale, Tensor ln_bias, Tensor fc1_kernel, "
                        "Tensor? fc1_bias, Tensor fc2_kernel, Tensor? fc2_bias, "
                        "Tensor? neuron_mask, Tensor? gate, bool collect_stats, float eps, "
                        "bool residual) -> (Tensor, Tensor)"),
    "fused_ffn": ("(Tensor x, Tensor fc1_kernel, Tensor? fc1_bias, Tensor fc2_kernel, "
                  "Tensor? fc2_bias, Tensor? neuron_mask, bool collect_stats) -> (Tensor, Tensor)"),
    "quant_matmul": "(Tensor x, Tensor w_q, Tensor scale) -> Tensor",
    "quant4_matmul": "(Tensor x, Tensor w_p, Tensor scale) -> Tensor",
    "fused_mlp_int8": ("(Tensor x, Tensor gq, Tensor gs, Tensor uq, Tensor us, Tensor dq, "
                       "Tensor ds) -> Tensor"),
}
OPERATOR_NAMES = tuple(SCHEMAS)


def _register(name: str, cuda, fake) -> None:
    _LIB.define(name + SCHEMAS[name])
    _LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)


def _stats_or_empty(stats: Optional[Tensor], x: Tensor) -> Tensor:
    return stats if stats is not None else x.new_empty((0,), dtype=torch.float32)


def _attn_block_cuda(name):
    def run(x, ln_scale, ln_bias, qkv_kernel, qkv_bias, proj_kernel, proj_bias, gate, num_heads,
            eps, residual):
        out = attn_block_launch(x, ln_scale, ln_bias, qkv_kernel, qkv_bias, proj_kernel,
                                proj_bias, num_heads, eps, gate, residual)
        launch_counts[name] += 1
        return out
    return run


def _attn_block_fake(x, ln_scale, ln_bias, qkv_kernel, qkv_bias, proj_kernel, proj_bias, gate,
                     num_heads, eps, residual):
    return torch.empty_like(x)


def _ffn_block_cuda(x, ln_scale, ln_bias, fc1_kernel, fc1_bias, fc2_kernel, fc2_bias,
                    neuron_mask, gate, collect_stats, eps, residual):
    out, stats = ffn_launch(x, (ln_scale, ln_bias), fc1_kernel, fc1_bias, fc2_kernel, fc2_bias,
                            neuron_mask, gate, collect_stats, eps, residual)
    launch_counts["fused_ffn_block"] += 1
    return out, _stats_or_empty(stats, x)


def _ffn_fake(x, fc1_kernel, fc1_bias, fc2_kernel, fc2_bias, neuron_mask, collect_stats):
    shape = (x.shape[0], fc1_kernel.shape[-1]) if collect_stats else (0,)
    return torch.empty_like(x), x.new_empty(shape, dtype=torch.float32)


def _ffn_block_fake(x, ln_scale, ln_bias, fc1_kernel, fc1_bias, fc2_kernel, fc2_bias,
                    neuron_mask, gate, collect_stats, eps, residual):
    return _ffn_fake(x, fc1_kernel, fc1_bias, fc2_kernel, fc2_bias, neuron_mask, collect_stats)


def _ffn_cuda(x, fc1_kernel, fc1_bias, fc2_kernel, fc2_bias, neuron_mask, collect_stats):
    out, stats = ffn_launch(x, None, fc1_kernel, fc1_bias, fc2_kernel, fc2_bias, neuron_mask,
                            None, collect_stats, 0.0)
    launch_counts["fused_ffn"] += 1
    return out, _stats_or_empty(stats, x)


def _quant_cuda(name, bits):
    def run(x, w, scale):
        out = quant_launch(x, w, scale, bits)
        launch_counts[name] += 1
        return out
    return run


def _quant_fake(x, w, scale):
    return x.new_empty((*x.shape[:-1], w.shape[-1]))


def _fused_mlp_int8_cuda(x, gq, gs, uq, us, dq, ds):
    out = fused_mlp_int8_launch(x, gq, gs, uq, us, dq, ds)
    launch_counts["fused_mlp_int8"] += 1
    return out


def _fused_mlp_int8_fake(x, gq, gs, uq, us, dq, ds):
    return torch.empty_like(x)


_register("fused_attn_block_v2", _attn_block_cuda("fused_attn_block_v2"), _attn_block_fake)
_register("fused_attn_block", _attn_block_cuda("fused_attn_block"), _attn_block_fake)
_register("fused_ffn_block", _ffn_block_cuda, _ffn_block_fake)
_register("fused_ffn", _ffn_cuda, _ffn_fake)
_register("quant_matmul", _quant_cuda("quant_matmul", 8), _quant_fake)
_register("quant4_matmul", _quant_cuda("quant4_matmul", 4), _quant_fake)
_register("fused_mlp_int8", _fused_mlp_int8_cuda, _fused_mlp_int8_fake)
