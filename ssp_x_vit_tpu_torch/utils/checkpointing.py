"""Training-state checkpoint and resume (counterpart of
``ssp_x_vit_tpu/utils/checkpointing.py``, which uses orbax).

A checkpoint is one ``torch.save`` file ``<dir>/step_<update>.pt`` holding
{"params", "opt_state", "update"}; it is written to a temporary name and
renamed, so a run killed while saving leaves the previous checkpoint as the
newest. The JAX package's orbax directories are not read here.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import torch


def save_train_state(ckpt_dir: str, step: int, params: Dict, opt_state: Dict) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.abspath(os.path.join(ckpt_dir, f"step_{step}.pt"))
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({"params": params, "opt_state": opt_state, "update": int(step)}, tmp)
    os.replace(tmp, path)
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The ``step_<n>.pt`` file with the largest n in ``ckpt_dir``, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and name.endswith(".pt"):
            try:
                steps.append((int(name[len("step_"):-len(".pt")]), name))
            except ValueError:
                continue
    if not steps:
        return None
    return os.path.join(ckpt_dir, max(steps)[1])


def _copy_into(dst: Any, src: Any) -> Any:
    """Copy a loaded tree into the live one in place (tensors keep their device
    and storage); other leaves (counters) are taken from the checkpoint."""
    if isinstance(dst, dict):
        if set(dst) != set(src):
            raise ValueError(f"checkpoint keys {sorted(src)} do not match {sorted(dst)}")
        for k in dst:
            dst[k] = _copy_into(dst[k], src[k])
        return dst
    if isinstance(dst, torch.Tensor):
        if dst.shape != src.shape or dst.dtype != src.dtype:
            raise ValueError(f"checkpoint leaf {src.dtype} {tuple(src.shape)} does not match "
                             f"{dst.dtype} {tuple(dst.shape)}")
        with torch.no_grad():
            dst.copy_(src)
        return dst
    return src


def restore_train_state(path: str, params_like: Dict, opt_state_like: Dict
                        ) -> Tuple[Dict, Dict, int]:
    """Load ``path`` into ``params_like`` and ``opt_state_like`` in place (the
    file is memory-mapped on the host and copied leaf by leaf, so a model
    never exists twice on the card); returns (params, opt_state, update)."""
    state = torch.load(path, map_location="cpu", mmap=True, weights_only=True)
    params = _copy_into(params_like, state["params"])
    opt_state = _copy_into(opt_state_like, state["opt_state"])
    return params, opt_state, int(state["update"])
