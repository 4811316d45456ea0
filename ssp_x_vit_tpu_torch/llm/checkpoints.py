"""LLM model persistence (counterpart of the native part of
``ssp_x_vit_tpu/llm/checkpoints.py``) and the JAX -> torch carry-across.

``save_llm_model`` / ``load_llm_model`` read and write the framework's own
``model.npz`` + ``config.json`` (dense, 2SSP-materialized or int8/int4
quantized trees; bf16 leaves as raw 2-byte words), the same files the JAX
package writes, so a model saved by either package loads in the other.
HF checkpoint directories (``load_hf_llama`` / ``export_hf_llama``) are not
ported yet (ROADMAP.md A.10).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ssp_x_vit_tpu_torch.device import DeviceLike, resolve_device
from ssp_x_vit_tpu_torch.llm.model import LlamaConfig, Params
from ssp_x_vit_tpu_torch.llm.rope import RopeScaling
from ssp_x_vit_tpu_torch.models.checkpoints import (
    to_tensor, load_params_npz, save_params_npz,
)

_HF_NOT_PORTED = "HF checkpoint directories are not ported yet (ROADMAP.md A.10)"


def llm_params_from_jax(tree: Dict[str, Any], *, device: DeviceLike = None,
                        dtype=torch.float32) -> Params:
    """The JAX package's LLM parameter tree (nested dict of numpy arrays, any
    of the family layouts; plain, ``_q`` int8, ``_q4`` packed int4 and
    ``_scale`` leaves) -> the same nested dict of tensors on ``device``.
    ``dtype`` applies to the float weights; integer codes keep their dtype and
    the per-channel ``_scale`` leaves stay float32, as the quantizers make them."""
    dev = resolve_device(device)

    def convert(node):
        out: Params = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = convert(v)
            else:
                leaf_dtype = torch.float32 if k.endswith("_scale") else dtype
                out[k] = to_tensor(np.asarray(v), dev, leaf_dtype)
        return out

    return convert(tree)


def pools_from_jax(pool, *, device: DeviceLike = None):
    """A paged KV pool of the JAX package (an array, or the int8 pool
    ``{"q": int8 codes, "s": fp32 scales}``) -> the port's pool on ``device``,
    every leaf in its own dtype (fp32, bf16, int8)."""
    dev = resolve_device(device)
    if isinstance(pool, dict):
        return {k: to_tensor(np.asarray(v), dev, None) for k, v in pool.items()}
    return to_tensor(np.asarray(pool), dev, None)


def caches_from_jax(cache_k, cache_v, *, device: DeviceLike = None):
    """A contiguous KV cache pair of the JAX package (``serve.init_cache``:
    arrays ``[A, b, max_len, nkv, hd]``, or the int8 caches ``{"q": int8
    codes, "s": fp32 scales}``) -> the port's caches on ``device``, every leaf
    in its own dtype."""
    return pools_from_jax(cache_k, device=device), pools_from_jax(cache_v, device=device)


def config_to_dict(cfg: LlamaConfig) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


def config_from_dict(d: Dict[str, Any]) -> LlamaConfig:
    """Inverse of :func:`config_to_dict` after a JSON round trip: lists back
    to tuples (the config is frozen and hashable), the nested ``rope_scaling``
    dict back to a ``RopeScaling``."""
    d = dict(d)
    for k, v in d.items():
        if isinstance(v, list):
            d[k] = tuple(v)
    if isinstance(d.get("rope_scaling"), dict):
        d["rope_scaling"] = RopeScaling(**d["rope_scaling"])
    return LlamaConfig(**d)


def save_llm_model(out_dir: str, params: Params, cfg: LlamaConfig) -> str:
    """Persist an LLM (dense, 2SSP-materialized or quantized tree) as
    ``model.npz`` + ``config.json``."""
    os.makedirs(out_dir, exist_ok=True)
    save_params_npz(os.path.join(out_dir, "model.npz"), params)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(config_to_dict(cfg), f, indent=2)
    return out_dir


def load_llm_model(model_dir: str, *, device: DeviceLike = None,
                   dtype=torch.bfloat16) -> Tuple[Params, LlamaConfig]:
    """Inverse of :func:`save_llm_model`, onto ``device`` (``cuda`` by
    default). ``dtype`` applies to float leaves only: int8 codes keep their
    dtype, so quantized models round-trip losslessly."""
    with open(os.path.join(model_dir, "config.json")) as f:
        cfg = config_from_dict(json.load(f))
    params = load_params_npz(os.path.join(model_dir, "model.npz"), device=device, dtype=dtype)
    return params, cfg


def load_hf_llama(model_dir: str, **kwargs):
    raise NotImplementedError(f"load_hf_llama: {_HF_NOT_PORTED}")


def export_hf_llama(out_dir: str, params: Params, cfg: LlamaConfig):
    raise NotImplementedError(f"export_hf_llama: {_HF_NOT_PORTED}")
