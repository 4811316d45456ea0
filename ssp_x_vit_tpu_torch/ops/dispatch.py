"""Kernel dispatch (counterpart of ``ssp_x_vit_tpu/ops/dispatch.py``).

One rule, decided by the tensor alone: a CUDA tensor goes through the
hand-written kernel, a CPU tensor through the kernel's plain PyTorch version,
anything else raises. There is no shape crossover: the TPU's crossovers
(``FFN_PALLAS_MIN_WIDTH``, ``FUSED_ATTN_MIN_BATCH``, the ``d % 128`` and
``hd % 64`` guards) were TPU measurements and do not carry over. A shape the
kernel cannot take raises in the kernel's wrapper; nothing falls back.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch

MAX_ROWS = 65535 * 64  # GEMM grid: one 64-row tile per blockIdx.y
_W8A8 = False


def set_w8a8_enabled(enabled: bool) -> None:
    """Route int8-quantized projections (``mm_quant``'s ``_q`` branch) through
    ``w8a8_matmul`` (dynamic per-token activation quantization; lossy)."""
    global _W8A8
    _W8A8 = bool(enabled)


def use_w8a8() -> bool:
    return _W8A8


def use_kernel(x: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU tensor, raise otherwise."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for a tensor on {x.device}")


def check_operands(x: torch.Tensor, operands: Sequence[Tuple[str, Optional[torch.Tensor],
                                                             Tuple[int, ...]]]) -> None:
    """Raise unless x and every named operand share x's device and dtype
    (fp32 or bf16), are contiguous and have the expected shapes. ``None``
    operands are skipped (optional biases)."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"kernels take float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.numel() // x.shape[-1] > MAX_ROWS:
        raise ValueError(f"kernels take at most {MAX_ROWS} token rows (grid y limit)")
    for name, t, shape in operands:
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != x.dtype:
            raise TypeError(f"{name} is {t.dtype}, x is {x.dtype}: cast the weights to "
                            "the compute dtype once per model (models.vit.cast_params)")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def gate_tensor(gate: Union[None, float, torch.Tensor], device: torch.device
                ) -> Optional[torch.Tensor]:
    """The residual gate as a kernel operator takes it (``ops/kernels/library.py``).

    ``None`` stays ``None`` (the GEMM epilogue reads a null gate as 1); a float
    is filled on the device as a float32 scalar; a tensor must already be a
    one-element float32 tensor there (e.g. a row of the candidate-gate
    matrix), so no host sync happens per block."""
    if gate is None:
        return None
    if not isinstance(gate, torch.Tensor):
        return torch.full((), float(gate), dtype=torch.float32, device=device)
    if gate.dtype != torch.float32 or gate.numel() != 1 or gate.device != device:
        raise ValueError(f"gate must be one float32 element on {device}, got "
                         f"{gate.dtype} {tuple(gate.shape)} on {gate.device}")
    return gate.contiguous()


def apply_gate(branch: torch.Tensor, gate: Union[None, float, torch.Tensor]) -> torch.Tensor:
    """Plain-version gating: ``branch * gate`` in the branch dtype (None = 1)."""
    if gate is None:
        return branch
    if isinstance(gate, torch.Tensor):
        return branch * gate.to(branch.dtype)
    return branch * torch.tensor(gate, dtype=branch.dtype)
