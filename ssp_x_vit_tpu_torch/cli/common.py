"""Shared CLI helpers: model and dataset resolution (counterpart of
``ssp_x_vit_tpu/cli/common.py``). Offline only: named architectures with
random weights, framework model directories, local HF ViT directories, and
``--checkpoint`` files (framework ``.npz``, AugReg ``.npz``, HF state dicts as
``.safetensors`` / ``.bin`` / ``.pt``); CIFAR-10/100 from their on-disk batch
files (the synthetic stand-in without them) and the synthetic dataset."""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from ssp_x_vit_tpu_torch.device import DeviceLike, resolve_device
from ssp_x_vit_tpu_torch.models.vit import Params, ViTConfig, init_vit_params

# Named architectures (AugReg family used by the reference SRP stack).
NAMED_CONFIGS = {
    "vit-b16": dict(hidden_size=768, num_layers=12, num_heads=12, intermediate_size=3072),
    "vit-s16": dict(hidden_size=384, num_layers=12, num_heads=6, intermediate_size=1536),
    "vit-ti16": dict(hidden_size=192, num_layers=12, num_heads=3, intermediate_size=768),
    "google/vit-base-patch16-224": dict(hidden_size=768, num_layers=12, num_heads=12,
                                        intermediate_size=3072),
    # tiny test config (offline smoke / CI)
    "tiny": dict(image_size=32, patch_size=8, hidden_size=64, num_layers=4,
                 num_heads=4, intermediate_size=128),
}


def resolve_model(
    model: str,
    *,
    num_classes: int = 10,
    checkpoint: Optional[str] = None,
    seed: int = 0,
    device: DeviceLike = None,
    dtype=torch.float32,
) -> Tuple[Params, ViTConfig]:
    """--model -> (params, cfg) on ``device`` (``cuda`` by default).

    Accepts a framework model directory (``model.npz`` + ``config.json``), a
    local HF ViT directory (``config.json`` + weights), or a named
    architecture from NAMED_CONFIGS with random weights unless ``checkpoint``
    names a weights file: a framework ``.npz``, an AugReg ``.npz`` (any ``.npz``
    without the framework's ``blocks``) or an HF state dict.
    """
    from ssp_x_vit_tpu_torch.models import checkpoints as ckpt

    dev = resolve_device(device)
    if os.path.isdir(model):
        if os.path.exists(os.path.join(model, "model.npz")):
            from ssp_x_vit_tpu_torch.models.persistence import load_pruned_model

            params, cfg = load_pruned_model(model, device=dev, dtype=dtype)
            print(f"[INFO] Loaded framework (possibly pruned) model: {model}")
            return params, cfg
        params, cfg = ckpt.load_hf_vit(model, num_classes=num_classes, device=dev, dtype=dtype)
        print(f"[INFO] Loaded HF model from directory: {model}")
        return params, cfg

    key = model.lower()
    if key not in NAMED_CONFIGS:
        print(f"[WARN] '{model}' is not a local directory or known architecture; "
              f"known: {sorted(NAMED_CONFIGS)}. Using vit-b16 architecture.")
        key = "vit-b16"
    cfg = ViTConfig(num_classes=num_classes, **NAMED_CONFIGS[key])

    if checkpoint:
        if checkpoint.endswith(".npz"):
            with np.load(checkpoint) as npz:
                framework = any(k.startswith("blocks/") for k in npz.files)
            if framework:
                params = ckpt.load_params_npz(checkpoint, device=dev, dtype=dtype)
                print(f"[INFO] Loaded framework npz checkpoint: {checkpoint}")
            else:
                params = ckpt.load_augreg_npz(checkpoint, cfg, device=dev, dtype=dtype)
                print(f"[INFO] Loaded AugReg npz checkpoint: {checkpoint}")
            return params, cfg
        sd = ckpt.load_state_dict_file(checkpoint)
        params = ckpt.params_from_hf_state_dict(sd, cfg, device=dev, dtype=dtype)
        print(f"[INFO] Loaded state dict: {checkpoint}")
        return params, cfg

    print(f"[INFO] No checkpoint available; initializing {key} randomly "
          f"(offline mode — metrics are pipeline-valid, accuracy is chance)")
    return init_vit_params(cfg, seed=seed, device=dev, dtype=dtype), cfg


def resolve_dataset(
    dataset: str,
    cfg: ViTConfig,
    *,
    train_pct: float = 0.25,
    test_pct: float = 0.25,
    calib_per_class: int = 2,
    seed: int = 0,
    device: DeviceLike = None,
):
    """--dataset cifar10|cifar100|synthetic -> (train, test, calib) pipelines on
    ``device``."""
    from ssp_x_vit_tpu_torch.data.pipeline import DataPipeline, load_cifar, synthetic_dataset

    ds = dataset.lower()
    if ds in ("cifar10", "cifar100"):
        return load_cifar(ds, train_pct=train_pct, test_pct=test_pct,
                          calib_per_class=calib_per_class, img_size=cfg.image_size, seed=seed,
                          device=device)
    if ds != "synthetic":
        raise ValueError(f"unknown dataset {dataset}")
    dev = resolve_device(device)
    n_cls = cfg.num_classes
    tr_x, tr_y = synthetic_dataset(1024, n_cls, image_size=cfg.image_size, seed=seed)
    te_x, te_y = synthetic_dataset(512, n_cls, image_size=cfg.image_size, seed=seed + 1)
    train = DataPipeline(tr_x, tr_y, img_size=cfg.image_size, batch_size=32, shuffle=True,
                         seed=seed, device=dev)
    test = DataPipeline(te_x, te_y, img_size=cfg.image_size, batch_size=64, device=dev)
    calib = DataPipeline(tr_x[: calib_per_class * n_cls], tr_y[: calib_per_class * n_cls],
                         img_size=cfg.image_size, batch_size=64, device=dev)
    return train, test, calib
