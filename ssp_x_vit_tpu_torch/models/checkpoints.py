"""Checkpoints (counterpart of ``ssp_x_vit_tpu/models/checkpoints.py``):
framework-native ``.npz`` files, HF ViT directories (``config.json`` +
``model.safetensors`` or ``pytorch_model.bin``) both ways, HF state-dict files,
AugReg ``.npz`` files, and the JAX -> torch carry-across.

Every source converges on the JAX package's parameter layout: stacked blocks,
fused QKV, ``[in, out]`` kernels. The safetensors reader reads one tensor at a
time from the file and turns it into the target dtype on the target device,
so a load holds one tensor on the host, never the whole model; the writer
emits F32, as the JAX one does, byte for byte the same file for the same
parameters.

Weight layouts handled here:
- torch ``nn.Linear.weight`` is [out, in]  -> transposed to [in, out]
- torch conv patch-proj [d, C, P, P]       -> [C*P*P, d] (ops.common.patchify order)
- AugReg npz conv kernel [P, P, C, d]      -> [C*P*P, d]
- AugReg npz attention kernels [d, h, hd]  -> fused [d, 3d]
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Callable, Dict, Iterator, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ssp_x_vit_tpu_torch.device import DeviceLike, resolve_device
from ssp_x_vit_tpu_torch.models.vit import Params, ViTConfig

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


# ------------------------------------------------------------- safetensors ---

_ST_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
              "F64": torch.float64, "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
              "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}
# The dtypes the writer emits (floating tensors as F32).
_ST_CODES = {torch.float32: "F32", torch.int64: "I64",
             torch.int32: "I32", torch.int8: "I8", torch.uint8: "U8", torch.bool: "BOOL"}


class SafetensorsFiles(Mapping):
    """The tensors of one or more ``.safetensors`` files by name (a later file
    wins a duplicate name). Only the headers are read up front: each lookup
    reads that tensor's bytes from disk into a new CPU tensor in the file's
    dtype, so host memory holds one tensor at a time."""

    def __init__(self, paths: Sequence[str]):
        self._index: Dict[str, Tuple[str, int, int, str, Tuple[int, ...]]] = {}
        for path in paths:
            with open(path, "rb") as f:
                (n,) = struct.unpack("<Q", f.read(8))
                header = json.loads(f.read(n))
            for name, meta in header.items():
                if name == "__metadata__":
                    continue
                start, end = meta["data_offsets"]
                self._index[name] = (path, 8 + n + start, end - start, meta["dtype"],
                                     tuple(meta["shape"]))

    def __getitem__(self, name: str) -> torch.Tensor:
        path, offset, nbytes, dtype, shape = self._index[name]
        raw = torch.empty(nbytes, dtype=torch.uint8)
        if nbytes:
            with open(path, "rb") as f:
                f.seek(offset)
                if f.readinto(raw.numpy()) != nbytes:
                    raise ValueError(f"{path}: tensor {name} is cut short")
        return raw.view(_ST_DTYPES[dtype]).reshape(shape)

    def __iter__(self) -> Iterator[str]:
        return iter(self._index)

    def __len__(self) -> int:
        return len(self._index)


def _read_safetensors(path: str) -> SafetensorsFiles:
    """The tensors of one ``.safetensors`` file, read on access (see SafetensorsFiles)."""
    return SafetensorsFiles([path])


def _out_dtype(t: torch.Tensor) -> torch.dtype:
    """Floating tensors are written as F32, as the JAX exporters write them."""
    return torch.float32 if t.is_floating_point() else t.dtype


def _write_safetensors(path: str, tensors: Dict[str, torch.Tensor],
                       metadata: Optional[Dict[str, str]] = None) -> None:
    """Write ``tensors`` (any device, any strides) as a safetensors file, one
    tensor at a time, floating ones converted to F32. The header and the bytes
    are those of the JAX package's writer for the same values."""
    header: Dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = metadata
    offset = 0
    for name, t in tensors.items():
        out_dtype = _out_dtype(t)
        if out_dtype not in _ST_CODES:
            raise ValueError(f"unsupported export dtype {out_dtype} for {name}")
        nbytes = t.numel() * torch.empty((), dtype=out_dtype).element_size()
        header[name] = {"dtype": _ST_CODES[out_dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    hjson = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hjson)))
        f.write(hjson)
        for t in tensors.values():
            t = t.detach().to(_out_dtype(t)).contiguous().cpu()
            f.write(memoryview(t.reshape(-1).view(torch.uint8).numpy()))


def _fp32(sd: Mapping, key: str, device: torch.device) -> torch.Tensor:
    """One entry of a state dict (tensor or numpy array) as fp32 on ``device``,
    converted there."""
    v = sd[key]
    t = v if isinstance(v, torch.Tensor) else to_tensor(np.asarray(v), torch.device("cpu"), None)
    return t.to(device).float()


def _t(w: torch.Tensor) -> torch.Tensor:
    """torch Linear weight [out, in] -> kernel [in, out] (a view)."""
    return w.t()


def _stack(n: int, get: Callable[[int], torch.Tensor], device: torch.device,
           dtype) -> torch.Tensor:
    """``[n, ...]`` in ``dtype`` on ``device`` from ``get(i)`` (fp32), filled one
    entry at a time."""
    out = None
    for i in range(n):
        t = get(i)
        if out is None:
            out = torch.empty((n, *t.shape), dtype=dtype, device=device)
        out[i].copy_(t)
    return out


def load_state_dict_file(path: str) -> Mapping:
    """A checkpoint file's tensors by name: ``.safetensors`` read on access,
    torch ``.bin`` / ``.pt`` through ``torch.load(weights_only=True)`` (a
    nested ``state_dict`` is unwrapped)."""
    if path.endswith(".safetensors"):
        return _read_safetensors(path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd and isinstance(sd["state_dict"], dict):
        sd = sd["state_dict"]
    return sd


# --------------------------------------------------------------- HF ViT ---

def config_from_hf_dict(d: Dict[str, Any], num_classes: Optional[int] = None) -> ViTConfig:
    return ViTConfig(
        image_size=d.get("image_size", 224),
        patch_size=d.get("patch_size", 16),
        num_channels=d.get("num_channels", 3),
        hidden_size=d.get("hidden_size", 768),
        num_layers=d.get("num_hidden_layers", 12),
        num_heads=d.get("num_attention_heads", 12),
        intermediate_size=d.get("intermediate_size", 3072),
        num_classes=(num_classes if num_classes is not None
                     else d.get("num_labels", len(d.get("id2label", {})) or 1000)),
        layernorm_eps=d.get("layer_norm_eps", 1e-12),
    )


def params_from_hf_state_dict(sd: Mapping, cfg: ViTConfig, *, device: DeviceLike = None,
                              dtype=torch.float32) -> Params:
    """HF ViTForImageClassification / ViTModel state dict (tensors or numpy
    arrays, or a SafetensorsFiles) -> the stacked tree on ``device``."""
    dev = resolve_device(device)
    pre = "vit." if any(k.startswith("vit.") for k in sd) else ""
    d, L = cfg.hidden_size, cfg.num_layers

    def g(key):
        return _fp32(sd, pre + key, dev)

    def stack(fmt, transform=lambda x: x):
        return _stack(L, lambda i: transform(g(fmt.format(i=i))), dev, dtype)

    attn = "encoder.layer.{i}.attention.attention."
    blocks = {
        "ln1_scale": stack("encoder.layer.{i}.layernorm_before.weight"),
        "ln1_bias": stack("encoder.layer.{i}.layernorm_before.bias"),
        "qkv_kernel": _stack(L, lambda i: torch.cat(
            [_t(g(attn.format(i=i) + f"{n}.weight")) for n in ("query", "key", "value")], 1),
            dev, dtype),
        "qkv_bias": _stack(L, lambda i: torch.cat(
            [g(attn.format(i=i) + f"{n}.bias") for n in ("query", "key", "value")]), dev, dtype),
        "proj_kernel": stack("encoder.layer.{i}.attention.output.dense.weight", _t),
        "proj_bias": stack("encoder.layer.{i}.attention.output.dense.bias"),
        "ln2_scale": stack("encoder.layer.{i}.layernorm_after.weight"),
        "ln2_bias": stack("encoder.layer.{i}.layernorm_after.bias"),
        "fc1_kernel": stack("encoder.layer.{i}.intermediate.dense.weight", _t),
        "fc1_bias": stack("encoder.layer.{i}.intermediate.dense.bias"),
        "fc2_kernel": stack("encoder.layer.{i}.output.dense.weight", _t),
        "fc2_bias": stack("encoder.layer.{i}.output.dense.bias"),
    }
    patch = g("embeddings.patch_embeddings.projection.weight")      # [d, C, P, P]
    params: Params = {
        "patch_embed": {"kernel": patch.reshape(d, -1).t().to(dtype).contiguous(),
                        "bias": g("embeddings.patch_embeddings.projection.bias").to(dtype)},
        "cls_token": g("embeddings.cls_token").to(dtype),
        "pos_embed": g("embeddings.position_embeddings").to(dtype),
        "blocks": blocks,
        "ln_final_scale": g("layernorm.weight").to(dtype),
        "ln_final_bias": g("layernorm.bias").to(dtype),
    }
    if "classifier.weight" in sd:
        params["head"] = {"kernel": _t(_fp32(sd, "classifier.weight", dev)).to(dtype).contiguous(),
                          "bias": _fp32(sd, "classifier.bias", dev).to(dtype)}
    else:  # a headless backbone: a zero head of the configured width
        params["head"] = {"kernel": torch.zeros((d, cfg.num_classes), dtype=dtype, device=dev),
                          "bias": torch.zeros((cfg.num_classes,), dtype=dtype, device=dev)}
    return params


def load_hf_vit(model_dir: str, *, num_classes: Optional[int] = None, device: DeviceLike = None,
                dtype=torch.float32) -> Tuple[Params, ViTConfig]:
    """Load a locally saved HF ViT directory (config.json + weights) onto
    ``device`` (``cuda`` by default)."""
    with open(os.path.join(model_dir, "config.json")) as f:
        cfg = config_from_hf_dict(json.load(f), num_classes=num_classes)
    for fname in ("model.safetensors", "pytorch_model.bin"):
        path = os.path.join(model_dir, fname)
        if os.path.exists(path):
            sd = load_state_dict_file(path)
            return params_from_hf_state_dict(sd, cfg, device=device, dtype=dtype), cfg
    raise FileNotFoundError(f"no weights file in {model_dir}")


def export_hf_vit(out_dir: str, params: Params, cfg: ViTConfig) -> str:
    """Export a dense or stage-1-width-pruned ViT tree as an HF
    ViTForImageClassification checkpoint (config.json + model.safetensors in
    F32), the inverse of ``params_from_hf_state_dict``. A width-pruned tree is
    written at its padded width (the padded neurons have zero fc2 rows, so the
    logits are the same). Adapter heads and stage-2 attention removal have no
    HF ViT encoding and raise ValueError before anything is written."""
    if cfg.head_type != "linear":
        raise ValueError("adapter heads have no HF ViT encoding; use "
                         "save_pruned_model (models/persistence.py)")
    if cfg.pruned_attention_blocks:
        raise ValueError("stage-2 attention removal is not representable in "
                         "vanilla HF ViT blocks; use save_pruned_model")
    d, L, C, P_ = cfg.hidden_size, cfg.num_layers, cfg.num_channels, cfg.patch_size
    blocks = params["blocks"]
    pre = "vit."
    tensors: Dict[str, torch.Tensor] = {
        pre + "embeddings.patch_embeddings.projection.weight":
            params["patch_embed"]["kernel"].t().reshape(d, C, P_, P_),
        pre + "embeddings.patch_embeddings.projection.bias": params["patch_embed"]["bias"],
        pre + "embeddings.cls_token": params["cls_token"].reshape(1, 1, d),
        pre + "embeddings.position_embeddings": params["pos_embed"].reshape(1, -1, d),
    }
    for i in range(L):
        lp = pre + f"encoder.layer.{i}."
        for j, name in enumerate(("query", "key", "value")):
            tensors[lp + f"attention.attention.{name}.weight"] = \
                _t(blocks["qkv_kernel"][i][:, j * d:(j + 1) * d])
            tensors[lp + f"attention.attention.{name}.bias"] = \
                blocks["qkv_bias"][i][j * d:(j + 1) * d]
        for hf, ours, tr in (("attention.output.dense.weight", "proj_kernel", True),
                             ("attention.output.dense.bias", "proj_bias", False),
                             ("layernorm_before.weight", "ln1_scale", False),
                             ("layernorm_before.bias", "ln1_bias", False),
                             ("layernorm_after.weight", "ln2_scale", False),
                             ("layernorm_after.bias", "ln2_bias", False),
                             ("intermediate.dense.weight", "fc1_kernel", True),
                             ("intermediate.dense.bias", "fc1_bias", False),
                             ("output.dense.weight", "fc2_kernel", True),
                             ("output.dense.bias", "fc2_bias", False)):
            tensors[lp + hf] = _t(blocks[ours][i]) if tr else blocks[ours][i]
    tensors[pre + "layernorm.weight"] = params["ln_final_scale"]
    tensors[pre + "layernorm.bias"] = params["ln_final_bias"]
    tensors["classifier.weight"] = _t(params["head"]["kernel"])
    tensors["classifier.bias"] = params["head"]["bias"]

    os.makedirs(out_dir, exist_ok=True)
    _write_safetensors(os.path.join(out_dir, "model.safetensors"), tensors,
                       metadata={"format": "pt"})
    hf_cfg = {
        "model_type": "vit",
        "architectures": ["ViTForImageClassification"],
        "image_size": cfg.image_size, "patch_size": cfg.patch_size,
        "num_channels": cfg.num_channels, "hidden_size": d,
        "num_hidden_layers": L, "num_attention_heads": cfg.num_heads,
        "intermediate_size": cfg.padded_intermediate_size,
        "layer_norm_eps": cfg.layernorm_eps,
        "num_labels": cfg.num_classes,
        "id2label": {str(i): f"LABEL_{i}" for i in range(cfg.num_classes)},
        "label2id": {f"LABEL_{i}": i for i in range(cfg.num_classes)},
    }
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(hf_cfg, f, indent=2)
    return out_dir


# ----------------------------------------------------------------- AugReg ---

def params_from_augreg_npz(npz: Mapping, cfg: ViTConfig, *, device: DeviceLike = None,
                           dtype=torch.float32) -> Params:
    """AugReg ``.npz`` checkpoint (big_vision layout) -> the stacked tree: the
    per-head q/k/v kernels [d, h, hd] fused into the [d, 3d] qkv kernel."""
    dev = resolve_device(device)
    d, L = cfg.hidden_size, cfg.num_layers

    def g(key):
        return _fp32(npz, key, dev)

    def blk(i, key):
        return g(f"Transformer/encoderblock_{i}/{key}")

    def stack(key, transform=lambda x: x):
        return _stack(L, lambda i: transform(blk(i, key)), dev, dtype)

    mha = "MultiHeadDotProductAttention_1/"
    blocks = {
        "ln1_scale": stack("LayerNorm_0/scale"),
        "ln1_bias": stack("LayerNorm_0/bias"),
        "qkv_kernel": _stack(L, lambda i: torch.cat(
            [blk(i, f"{mha}{n}/kernel").reshape(d, -1) for n in ("query", "key", "value")], 1),
            dev, dtype),
        "qkv_bias": _stack(L, lambda i: torch.cat(
            [blk(i, f"{mha}{n}/bias").reshape(-1) for n in ("query", "key", "value")]),
            dev, dtype),
        "proj_kernel": stack(f"{mha}out/kernel", lambda x: x.reshape(-1, d)),
        "proj_bias": stack(f"{mha}out/bias"),
        "ln2_scale": stack("LayerNorm_2/scale"),
        "ln2_bias": stack("LayerNorm_2/bias"),
        "fc1_kernel": stack("MlpBlock_3/Dense_0/kernel"),
        "fc1_bias": stack("MlpBlock_3/Dense_0/bias"),
        "fc2_kernel": stack("MlpBlock_3/Dense_1/kernel"),
        "fc2_bias": stack("MlpBlock_3/Dense_1/bias"),
    }
    patch = g("embedding/kernel")                                     # [P, P, C, d]
    params: Params = {
        "patch_embed": {"kernel": patch.permute(2, 0, 1, 3).reshape(-1, d).to(dtype),
                        "bias": g("embedding/bias").to(dtype)},
        "cls_token": g("cls").to(dtype),
        "pos_embed": g("Transformer/posembed_input/pos_embedding").to(dtype),
        "blocks": blocks,
        "ln_final_scale": g("Transformer/encoder_norm/scale").to(dtype),
        "ln_final_bias": g("Transformer/encoder_norm/bias").to(dtype),
    }
    if "head/kernel" in npz:
        params["head"] = {"kernel": g("head/kernel").to(dtype), "bias": g("head/bias").to(dtype)}
    else:
        params["head"] = {"kernel": torch.zeros((d, cfg.num_classes), dtype=dtype, device=dev),
                          "bias": torch.zeros((cfg.num_classes,), dtype=dtype, device=dev)}
    return params


def load_augreg_npz(path: str, cfg: ViTConfig, *, device: DeviceLike = None,
                    dtype=torch.float32) -> Params:
    """An AugReg ``.npz`` file onto ``device``, one array at a time."""
    with np.load(path) as npz:
        return params_from_augreg_npz(npz, cfg, device=device, dtype=dtype)
