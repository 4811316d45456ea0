"""SRP checkpoint selection and dataset loaders (counterpart of
``ssp_x_vit_tpu/data/srp.py``; reference pruning_srp-main/process_models.py,
load_models.py, process_datasets.py).

Checkpoint selection is the JAX package's ``index.csv`` logic (stdlib ``csv``):
  1. among i21k pretrains, keep each architecture's best final_val filename;
  2. among finetunes of those pretrains, filter (name==model_type,
     adapt_ds==dataset) and sort by adapt_final_val ascending;
  3. take the ``top10_idx``-th from the end of that list.

Oxford-IIIT-Pet is read as torchvision's ``OxfordIIITPet`` reads it
(``data/pets.py``) and every image is ``Image.open(p).convert("RGB").resize((res,
res))`` bit for bit, through the repository's own JPEG / PNG reader and
Pillow's bicubic resize (``data/image_decode.py``).

Differences from the JAX package, both on purpose:
- Nothing is downloaded. The JAX package tries urllib, curl and unverified
  SSL for a checkpoint missing from ``models_dir``; the port raises
  ``FileNotFoundError`` naming the AugReg URL and the local path to put it at.
- A Pets file on disk that the reader cannot take (another format, a
  truncated file, a malformed annotation line) raises ``ValueError`` naming
  it. The JAX package's ``except Exception`` would quietly swap the whole
  split for the synthetic stand-in. Without the dataset (no ``images`` or no
  ``annotations`` directory) both use the synthetic stand-in.
"""

from __future__ import annotations

import csv
import os
from typing import Optional

import numpy as np
import torch

from ssp_x_vit_tpu_torch.device import DeviceLike, resolve_device

AUGREG_URL = "https://storage.googleapis.com/vit_models/augreg/{}.npz"

ARCH = {
    "Ti/16": dict(hidden_size=192, num_layers=12, num_heads=3, intermediate_size=768),
    "S/16": dict(hidden_size=384, num_layers=12, num_heads=6, intermediate_size=1536),
    "B/16": dict(hidden_size=768, num_layers=12, num_heads=12, intermediate_size=3072),
}


def select_srp_checkpoint(index_csv: str, model_type: str, dataset_name: str,
                          top10_idx: int = 1) -> str:
    """Pick the finetuned AugReg checkpoint filename from index.csv."""
    with open(index_csv, newline="", encoding="utf-8") as f:
        rows = list(csv.DictReader(f))

    # best i21k pretrain per architecture name by final_val
    best_pretrain = {}
    for r in rows:
        if r.get("ds") != "i21k":
            continue
        name = r["name"]
        fv = float(r.get("final_val") or 0.0)
        if name not in best_pretrain or fv >= best_pretrain[name][0]:
            best_pretrain[name] = (fv, r["filename"])
    pretrains = {fn for _, fn in best_pretrain.values()}

    finetunes = [
        r for r in rows
        if r.get("filename") in pretrains
        and r.get("name") == model_type
        and r.get("adapt_ds") == dataset_name
    ]
    if not finetunes:
        raise ValueError(f"no finetunes for {model_type} on {dataset_name} in {index_csv}")
    finetunes.sort(key=lambda r: float(r.get("adapt_final_val") or 0.0))
    candidates = [r["adapt_filename"] for r in finetunes]
    if top10_idx < 1 or top10_idx > len(candidates):
        raise ValueError(f"top10_idx {top10_idx} out of range (1..{len(candidates)})")
    return candidates[-top10_idx]


def local_checkpoint(checkpoint: str, models_dir: str) -> str:
    """``models_dir/<checkpoint>.npz``; raises if it is not there (no download)."""
    path = os.path.join(models_dir, f"{checkpoint}.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} not found. Nothing is downloaded: fetch {AUGREG_URL.format(checkpoint)} "
            f"on a machine with network access and place the file at {path}")
    return path


def load_srp_model(
    model_type: str = "B/16",
    dataset_name: str = "cifar100",
    *,
    top10_idx: int = 1,
    index_csv: Optional[str] = None,
    models_dir: str = "models",
    checkpoint_npz: Optional[str] = None,
    num_classes: Optional[int] = None,
    verbose: bool = False,
    device: DeviceLike = None,
    dtype=torch.float32,
):
    """(params, cfg) of the selected SRP AugReg checkpoint on ``device``.

    ``checkpoint_npz`` bypasses index.csv selection (reference
    --srp-checkpoint-npz)."""
    from ssp_x_vit_tpu_torch.models.checkpoints import load_augreg_npz
    from ssp_x_vit_tpu_torch.models.vit import ViTConfig

    dev = resolve_device(device)
    if num_classes is None:
        num_classes = 100 if dataset_name == "cifar100" else 37

    if checkpoint_npz is None:
        if index_csv is None:
            index_csv = os.path.join(models_dir, "index.csv")
        checkpoint = select_srp_checkpoint(index_csv, model_type, dataset_name, top10_idx)
        if verbose:
            print(f"Loaded checkpoint: {checkpoint}")
        res = int(checkpoint.split("_")[-1])
        checkpoint_npz = local_checkpoint(checkpoint, models_dir)
    else:
        res = 224

    cfg = ViTConfig(image_size=res, patch_size=16, num_classes=num_classes, **ARCH[model_type])
    params = load_augreg_npz(checkpoint_npz, cfg, device=dev, dtype=dtype)
    return params, cfg


def load_srp_dataset(
    dataset: str = "cifar100",
    *,
    batch_size: int = 64,
    subset_size: float = 1.0,
    res: int = 224,
    split: str = "test",  # "trainval" | "test"
    root: Optional[str] = None,
    seed: int = 42,
    device: DeviceLike = None,
):
    """SRP dataset loaders (reference process_datasets.py): CIFAR-100 from its
    on-disk batches or Oxford-IIIT-Pet from its images (decoded and resized to
    ``res`` on the host), 0.5-normalized, resized; trainval gets a seeded 90/10
    split. Returns DataPipeline(s) on ``device``; the synthetic stand-in when
    the dataset is not on disk."""
    from ssp_x_vit_tpu_torch.data.image_decode import load_resized
    from ssp_x_vit_tpu_torch.data.pets import pets_split
    from ssp_x_vit_tpu_torch.data.pipeline import (
        DataPipeline, _load_cifar_arrays, synthetic_dataset,
    )

    dev = resolve_device(device)
    num_classes = 100 if dataset == "cifar100" else 37
    train = split == "trainval"

    images = labels = None
    if dataset == "cifar100":
        arrays = _load_cifar_arrays("cifar100", root)
        if arrays is not None:
            tr_x, tr_y, te_x, te_y = arrays
            images, labels = (tr_x, tr_y) if train else (te_x, te_y)
    else:
        found = pets_split(root or "data/", "trainval" if train else "test")
        if found is not None:
            paths, ys = found
            images = load_resized(paths, res)
            labels = np.asarray(ys, np.int32)

    if images is None:
        print(f"[INFO] {dataset} not on disk; using deterministic synthetic stand-in")
        images, labels = synthetic_dataset(1024 if train else 512, num_classes, seed=seed)

    rng = np.random.default_rng(seed)
    n = len(images)
    order = rng.permutation(n)
    if subset_size < 1.0:
        order = order[: int(n * subset_size)]
    images, labels = images[order], labels[order]

    if train:
        n_train = int(len(images) * 0.9)
        return (
            DataPipeline(images[:n_train], labels[:n_train], img_size=res,
                         batch_size=batch_size, shuffle=True, seed=seed, device=dev),
            DataPipeline(images[n_train:], labels[n_train:], img_size=res,
                         batch_size=batch_size, device=dev),
        )
    return DataPipeline(images, labels, img_size=res, batch_size=batch_size, device=dev)
