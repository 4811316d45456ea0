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
the source note says what bounds it) through the custom operator
``torch.ops.ssp.fused_mlp_int8`` (``ops/kernels/library.py``), so a
``torch.export`` trace records the operator; on a CPU tensor it runs the
plain version.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ssp_x_vit_tpu_torch.ops import dispatch
from ssp_x_vit_tpu_torch.ops.kernels import library


def fused_mlp_int8_plain(x: torch.Tensor, gq: torch.Tensor, gs: torch.Tensor, uq: torch.Tensor,
                         us: torch.Tensor, dq: torch.Tensor, ds: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_mlp_int8`."""
    x32 = x.float()
    g = (x32 @ gq.float()) * gs.float()
    u = (x32 @ uq.float()) * us.float()
    h = (F.silu(g) * u).to(x.dtype)
    return ((h.float() @ dq.float()) * ds.float()).to(x.dtype)


def fused_mlp_int8_cuda(x, gq, gs, uq, us, dq, ds, *, wide: bool = False) -> torch.Tensor:
    """One call of ``csrc/quant_fused_mlp.cu`` on CUDA tensors (no count;
    ``library.fused_mlp_int8_launch``). ``wide=True`` takes the tensor-core
    tiles at any row count. It is a measurement hook only, the yardstick of
    the weight stream at m <= 16; the serving path never sets it."""
    library.check_fused_mlp(x, gq, gs, uq, us, dq, ds)
    return library.fused_mlp_int8_launch(x, gq, gs, uq, us, dq, ds, wide=wide)


def fused_mlp_int8(x: torch.Tensor, gq: torch.Tensor, gs: torch.Tensor, uq: torch.Tensor,
                   us: torch.Tensor, dq: torch.Tensor, ds: torch.Tensor) -> torch.Tensor:
    """``(silu(x @ gq * gs) * (x @ uq * us)) @ dq * ds`` with h rounded to x's dtype."""
    if not dispatch.use_kernel(x):
        return fused_mlp_int8_plain(x, gq, gs, uq, us, dq, ds)
    library.check_fused_mlp(x, gq, gs, uq, us, dq, ds)
    return torch.ops.ssp.fused_mlp_int8(x, gq, gs, uq, us, dq, ds)
