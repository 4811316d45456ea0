"""Fused int8 SwiGLU MLP (replaces ``ssp_x_vit_tpu/ops/pallas/
quant_fused_mlp.py``: ``fused_mlp_int8``).

    fused_mlp_int8(x [.., d], gq [d, f] int8, gs [f], uq [d, f] int8, us [f],
                   dq [f, d] int8, ds [d]) -> [.., d] in x.dtype

    g = (x @ gq) * gs, u = (x @ uq) * us     fp32 accumulators and scales
    h = silu(g) * u                          rounded once to x's dtype
    out = (h @ dq) * ds                      fp32 accumulator, stored in x's dtype

The contract is the int8 SwiGLU epilogue of the contiguous serving path
(``llm/serve.py`` ``_layer_step``), which routes unpacked int8 llama trees here.

On the card the wrapper launches ``csrc/quant_fused_mlp.cu`` (for at most 16
bf16 rows a persistent TMA weight stream on warp-level tensor-core products
that sums its K splits inside its two launches; for at most 16 fp32 rows a
SIMT skinny product; above 16 rows the wgmma tiles of ``csrc/qgemm_tile.cuh``;
the source note says what bounds it); on a CPU tensor it runs the plain
version.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from ssp_x_vit_tpu_torch.ops import dispatch
from ssp_x_vit_tpu_torch.ops.kernels import build, launch_counts


def fused_mlp_int8_plain(x: torch.Tensor, gq: torch.Tensor, gs: torch.Tensor, uq: torch.Tensor,
                         us: torch.Tensor, dq: torch.Tensor, ds: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_mlp_int8`."""
    x32 = x.float()
    g = (x32 @ gq.float()) * gs.float()
    u = (x32 @ uq.float()) * us.float()
    h = (F.silu(g) * u).to(x.dtype)
    return ((h.float() @ dq.float()) * ds.float()).to(x.dtype)


def _check(x, gq, gs, uq, us, dq, ds) -> None:
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
def _scratch_sizes(device_index: int, dtype_code: int, m: int, d: int, f: int,
                   wide: bool) -> Tuple[int, int]:
    """(fp32 workspace floats, int32 ticket counters) of one call at these shapes."""
    with torch.cuda.device(device_index):
        lib = build.library("quant_fused_mlp")
        return (lib.ssp_fused_mlp_int8_workspace_floats(dtype_code, m, d, f, int(wide)),
                lib.ssp_fused_mlp_int8_tickets(dtype_code, m, d, f, int(wide)))


def fused_mlp_int8_cuda(x, gq, gs, uq, us, dq, ds, *, wide: bool = False) -> torch.Tensor:
    """One call of ``csrc/quant_fused_mlp.cu`` on CUDA tensors (no count).
    ``wide=True`` takes the tensor-core tiles at any row count. It is a
    measurement hook only, the yardstick of the weight stream at m <= 16;
    the serving path never sets it."""
    _check(x, gq, gs, uq, us, dq, ds)
    d, f = x.shape[-1], gq.shape[-1]
    m = x.numel() // d
    dt = build.DTYPE_CODES[x.dtype]
    h = torch.empty((m, f), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    ws_floats, n_tickets = _scratch_sizes(x.device.index, dt, m, d, f, wide)
    ws = torch.empty(ws_floats, dtype=torch.float32, device=x.device) if ws_floats else None
    tickets = build.tickets(x.device, n_tickets) if n_tickets else None
    with torch.cuda.device(x.device):
        build.check(build.library("quant_fused_mlp").ssp_fused_mlp_int8(
            dt, x.data_ptr(), gq.data_ptr(), gs.data_ptr(), uq.data_ptr(), us.data_ptr(),
            dq.data_ptr(), ds.data_ptr(), h.data_ptr(), out.data_ptr(), m, d, f, int(wide),
            build._ptr(ws), build._ptr(tickets), build._stream()), "ssp_fused_mlp_int8")
    return out


def fused_mlp_int8(x: torch.Tensor, gq: torch.Tensor, gs: torch.Tensor, uq: torch.Tensor,
                   us: torch.Tensor, dq: torch.Tensor, ds: torch.Tensor) -> torch.Tensor:
    """``(silu(x @ gq * gs) * (x @ uq * us)) @ dq * ds`` with h rounded to x's dtype."""
    if not dispatch.use_kernel(x):
        return fused_mlp_int8_plain(x, gq, gs, uq, us, dq, ds)
    out = fused_mlp_int8_cuda(x, gq, gs, uq, us, dq, ds)
    launch_counts["fused_mlp_int8"] += 1
    return out
