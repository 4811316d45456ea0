"""Framework-native ``.npz`` checkpoints (counterpart of the npz part of
``ssp_x_vit_tpu/models/checkpoints.py``) and the JAX -> torch carry-across.

Flat ``a/b/c`` keys, one array per leaf, the JAX parameter layout. HF,
AugReg and safetensors loaders are not ported yet (ROADMAP.md A.7).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ssp_x_vit_tpu_torch.device import DeviceLike, resolve_device
from ssp_x_vit_tpu_torch.models.vit import Params


def to_tensor(arr: np.ndarray, device: torch.device, dtype) -> torch.Tensor:
    """numpy leaf -> tensor; ``dtype`` applies to float leaves only.

    ``np.savez`` stores bf16 leaves (an ml_dtypes extension type) with a raw
    ``|V2`` descr: the bytes are intact, so they are read as uint16 and viewed
    as bfloat16 (no ml_dtypes needed)."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16).copy()).view(torch.bfloat16)
    elif arr.dtype.name == "bfloat16":  # an ml_dtypes array handed over in memory
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    if t.is_floating_point() and dtype is not None:
        t = t.to(dtype)
    return t.to(device)


def params_from_jax(tree: Dict[str, Any], *, device: DeviceLike = None,
                    dtype=torch.float32) -> Params:
    """A JAX parameter pytree (nested dict of arrays, e.g. ``jax.device_get``
    of ``init_vit_params``) -> the same nested dict of tensors."""
    dev = resolve_device(device)
    out: Params = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = params_from_jax(v, device=dev, dtype=dtype)
        elif v is None:
            out[k] = None
        else:
            out[k] = to_tensor(np.asarray(v), dev, dtype)
    return out


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A leaf as numpy for ``np.savez``: bf16 as raw 2-byte words, which
    ``to_tensor`` (and the JAX package's loader) read back as bf16."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().view(np.dtype("V2"))
    return t.numpy()


def save_params_npz(path: str, params: Params) -> None:
    """Flatten the dict to 'a/b/c' keys and save as npz (bf16 leaves as raw
    2-byte words, which ``load_params_npz`` in either package reads back)."""
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}/{k}" if prefix else k, v)
        else:
            flat[prefix] = to_numpy(node)

    walk("", params)
    np.savez(path, **flat)


def load_params_npz(path: str, *, device: DeviceLike = None, dtype=torch.float32) -> Params:
    """Load a framework npz onto ``device`` (``cuda`` by default); ``dtype``
    applies to float leaves, integer leaves keep their stored dtype."""
    dev = resolve_device(device)
    out: Params = {}
    with np.load(path) as npz:
        for key in npz.files:
            node = out
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = to_tensor(npz[key], dev, dtype)
    return out
