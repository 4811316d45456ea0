"""Classifier / adapter head artifacts (counterpart of
``ssp_x_vit_tpu/models/adapter.py``; reference ``save_cifar_adapter`` /
``load_cifar_adapter``).

The format is the JAX package's: ``adapter.npz`` (the head's arrays) and
``adapter.npz.json`` (metadata), so either package reads the other's save. A
reference torch ``adapter.pt`` / ``.pth`` payload (``{"state_dict": ...}`` of
a ``Linear``, or of ``Sequential(Linear, GELU, Linear)``) loads too.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ssp_x_vit_tpu_torch.models.checkpoints import to_numpy, to_tensor
from ssp_x_vit_tpu_torch.models.vit import Params, ViTConfig, params_device


def save_cifar_adapter(params: Params, cfg: ViTConfig, out_dir: str,
                       filename: str = "adapter.npz",
                       extra: Optional[Dict[str, Any]] = None) -> str:
    """Write ``params["head"]`` to ``out_dir/filename`` and its metadata beside
    it; returns the npz path."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, filename)
    np.savez(path, **{k: to_numpy(v) for k, v in params["head"].items()})
    meta = {
        "classifier_type": "Linear" if cfg.head_type == "linear" else "Sequential",
        "num_labels": cfg.num_classes,
        "hidden_size": cfg.hidden_size,
        "adapter_bottleneck": cfg.adapter_bottleneck,
        "timestamp": time.strftime("%Y-%m-%d %H:%M:%S"),
        "extra": extra or {},
    }
    with open(path + ".json", "w", encoding="utf-8") as f:
        json.dump(meta, f, indent=2)
    return path


def load_cifar_adapter(path: str, params: Params, cfg: ViTConfig) -> Tuple[Params, ViTConfig]:
    """(params with the saved head, cfg with its type and sizes); the head goes
    to the device of ``params``. Reads the npz format or a torch payload."""
    dev = params_device(params)
    if path.endswith(".pt") or path.endswith(".pth"):
        payload = torch.load(path, map_location="cpu", weights_only=False)
        sd = {k: v.float() for k, v in payload.get("state_dict", {}).items()}
        if "weight" in sd:  # torch Linear [out, in]
            head = {"kernel": sd["weight"].t(), "bias": sd["bias"]}
            new_cfg = dataclasses.replace(cfg, head_type="linear",
                                          num_classes=sd["weight"].shape[0])
        elif "0.weight" in sd and "2.weight" in sd:  # Sequential(Linear, GELU, Linear)
            head = {"w0": sd["0.weight"].t(), "w2": sd["2.weight"].t(), "b2": sd["2.bias"]}
            new_cfg = dataclasses.replace(cfg, head_type="adapter",
                                          adapter_bottleneck=sd["0.weight"].shape[0],
                                          num_classes=sd["2.weight"].shape[0])
        else:
            raise RuntimeError("Cannot reconstruct adapter architecture from torch payload.")
        head = {k: v.contiguous().to(dev) for k, v in head.items()}
    else:
        with np.load(path) as npz:
            head = {k: to_tensor(npz[k], dev, None) for k in npz.files}
        if "kernel" in head:
            new_cfg = dataclasses.replace(cfg, head_type="linear",
                                          num_classes=int(head["kernel"].shape[1]))
        elif "w0" in head:
            new_cfg = dataclasses.replace(cfg, head_type="adapter",
                                          adapter_bottleneck=int(head["w0"].shape[1]),
                                          num_classes=int(head["w2"].shape[1]))
        else:
            raise RuntimeError(f"Unrecognized adapter file contents: {sorted(head)}")
    new_params = dict(params)
    new_params["head"] = head
    return new_params, new_cfg
