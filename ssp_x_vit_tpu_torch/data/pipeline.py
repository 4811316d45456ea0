"""Input pipeline: array-backed batches, CIFAR-10/100 from disk, the
deterministic synthetic dataset and the committed procgen slice (counterpart of
``ssp_x_vit_tpu/data/pipeline.py``).

- Batches are assembled by the native gather (``data/native_loader.py``: the
  sampled images and their horizontal flips in one multithreaded pass), moved
  to the device as uint8, and normalized there: ``(x / 255 - 0.5) / 0.5``,
  channels-last [b, H, W, C].
- Images of another size than the model's are resized as
  ``jax.image.resize(..., "cubic")`` resizes them: Keys cubic (a = -0.5), taps
  outside the image dropped and the rest renormalized, antialiased when
  shrinking. ``F.interpolate(mode="bicubic")`` (a = -0.75, clamped edges) would
  not match, so each axis gets its ``[out, in]`` weight matrix from JAX's
  formula (``cubic_resize_weights``, once per size pair and device) and the
  batch is resized by two fp32 products with TF32 off.
- CIFAR is read from its on-disk python-pickle batches (the format torchvision
  downloads), without torchvision: ``cifar-10-batches-py/data_batch_1..5`` and
  ``test_batch``, ``cifar-100-python/train`` and ``test``. The md5 sums are not
  checked, and the format is pickle, which can run code when loaded: read only
  CIFAR files from a trusted source (as torchvision does). Nothing is
  downloaded; without the files ``load_cifar`` prints the JAX package's notice
  and uses the synthetic stand-in.
- ``synthetic_dataset`` is the JAX package's generator with the 8x8 -> HxW
  bilinear upsampling done by ``torch.nn.functional.interpolate``
  (``align_corners=False``, no antialias), which agrees with
  ``jax.image.resize(..., "linear")`` when upsampling.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import pickle
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ssp_x_vit_tpu_torch.data.native_loader import gather_batch
from ssp_x_vit_tpu_torch.device import DeviceLike, resolve_device

IMAGENET_VIT_MEAN = (0.5, 0.5, 0.5)
IMAGENET_VIT_STD = (0.5, 0.5, 0.5)

PROCGEN_SLICE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "procgen_slice.npz")


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic kernel with a = -0.5, as ``jax.image``'s ``_fill_keys_cubic_kernel``."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out).astype(np.float32)


def cubic_resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """[out_size, in_size] float32 weights of ``jax.image.resize(..., "cubic")``
    along one axis (``compute_weight_mat`` with scale out/in, no translation,
    antialias on), computed in float32 as JAX computes them."""
    f32 = np.float32
    inv_scale = f32(1.0) / f32(out_size / in_size)
    kernel_scale = max(inv_scale, f32(1.0))        # > 1 only when shrinking
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = _keys_cubic(x)                                             # [in, out]
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= f32(in_size) - f32(0.5))
    return np.ascontiguousarray(np.where(inside[None, :], w, f32(0.0)).T.astype(f32))


_RESIZE_WEIGHTS: Dict[Tuple[int, int, torch.device], torch.Tensor] = {}


def _resize_weights(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    key = (in_size, out_size, device)
    if key not in _RESIZE_WEIGHTS:
        _RESIZE_WEIGHTS[key] = torch.from_numpy(cubic_resize_weights(in_size, out_size)).to(device)
    return _RESIZE_WEIGHTS[key]


@contextlib.contextmanager
def _no_tf32():
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


def resize_cubic(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """[b, h, w, c] float32 -> [b, height, width, c]: ``jax.image.resize(x,
    (b, height, width, c), "cubic")``, as two fp32 products on x's device."""
    b, h, w, c = x.shape
    with _no_tf32():
        if h != height:
            x = torch.matmul(_resize_weights(h, height, x.device), x.reshape(b, h, w * c))
            x = x.reshape(b, height, w, c)
        if w != width:
            x = torch.matmul(_resize_weights(w, width, x.device),
                             x.reshape(b * height, w, c)).reshape(b, height, width, c)
    return x


def preprocess_batch(images_u8: torch.Tensor, img_size: int) -> torch.Tensor:
    """[b, h, w, 3] uint8 -> [b, img_size, img_size, 3] float32 normalized
    (bicubic resize as the JAX package's, then ``(x/255 - 0.5)/0.5``)."""
    b, h, w, c = images_u8.shape
    x = images_u8.to(torch.float32) / 255.0
    if (h, w) != (img_size, img_size):
        x = resize_cubic(x, img_size, img_size)
    mean = torch.tensor(IMAGENET_VIT_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_VIT_STD, dtype=torch.float32, device=x.device)
    return (x - mean) / std


@dataclasses.dataclass
class DataPipeline:
    """Array-backed dataset -> preprocessed batch iterator on ``device``
    (``cuda`` by default)."""

    images: np.ndarray  # [N, h, w, 3] uint8
    labels: np.ndarray  # [N] int32
    img_size: int = 224
    batch_size: int = 64
    shuffle: bool = False
    seed: int = 0
    flip: bool = False  # random horizontal flip (train augmentation)
    drop_remainder: bool = False
    device: DeviceLike = None

    def __post_init__(self):
        if self.images.shape[0] != self.labels.shape[0]:
            raise ValueError("images and labels differ in length")
        self.device = resolve_device(self.device)

    def __len__(self) -> int:
        n = self.images.shape[0]
        return n // self.batch_size if self.drop_remainder else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[dict]:
        n = self.images.shape[0]
        order = np.arange(n)
        rng = np.random.default_rng(self.seed)
        if self.shuffle:
            rng.shuffle(order)
        end = (n // self.batch_size) * self.batch_size if self.drop_remainder else n
        for start in range(0, end, self.batch_size):
            idx = order[start: start + self.batch_size]
            flips = (rng.random(len(idx)) < 0.5).astype(np.uint8) if self.flip else None
            imgs = gather_batch(self.images, idx, flips)
            px = preprocess_batch(torch.from_numpy(imgs).to(self.device), self.img_size)
            labels = torch.from_numpy(self.labels[idx].astype(np.int64)).to(self.device)
            yield {"pixel_values": px, "labels": labels}

    def batches(self, max_batches: Optional[int] = None) -> List[dict]:
        out = []
        for i, b in enumerate(self):
            if max_batches is not None and i >= max_batches:
                break
            out.append(b)
        return out


def synthetic_dataset(
    num_samples: int,
    num_classes: int,
    *,
    image_size: int = 32,
    seed: int = 0,
    noise: float = 0.25,
) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic class-structured images: per-class low-frequency pattern
    + Gaussian noise (same numbers as the JAX package's, within 1 uint8 step)."""
    rng = np.random.default_rng(seed)
    base = rng.normal(0.0, 1.0, (num_classes, 8, 8, 3))
    labels = (np.arange(num_samples) % num_classes).astype(np.int32)
    rng.shuffle(labels)
    patterns = torch.from_numpy(base[labels].astype(np.float32)).permute(0, 3, 1, 2)
    up = F.interpolate(patterns, size=(image_size, image_size), mode="bilinear",
                       align_corners=False, antialias=False)
    imgs = up.permute(0, 2, 3, 1).numpy()
    imgs = imgs + rng.normal(0.0, noise, imgs.shape)
    imgs = (imgs - imgs.min()) / max(1e-9, imgs.max() - imgs.min())
    return (imgs * 255).astype(np.uint8), labels


# name -> (directory under a root, train files, test files, label key)
CIFAR_FILES = {
    "cifar10": ("cifar-10-batches-py", tuple(f"data_batch_{i}" for i in range(1, 6)),
                ("test_batch",), "labels"),
    "cifar100": ("cifar-100-python", ("train",), ("test",), "fine_labels"),
}
CIFAR_ROOTS = ("./data", "/root/data", "/data")


def read_cifar_batches(directory: str, files, label_key: str) -> Tuple[np.ndarray, np.ndarray]:
    """The pickled CIFAR batch files (dicts with ``data`` [N, 3072] uint8 in
    CHW order and a label list) -> ([N, 32, 32, 3] uint8, [N] int32)."""
    images, labels = [], []
    for name in files:
        with open(os.path.join(directory, name), "rb") as f:
            entry = pickle.load(f, encoding="latin1")
        images.append(np.asarray(entry["data"], np.uint8).reshape(-1, 3, 32, 32))
        labels.extend(entry[label_key])
    return (np.ascontiguousarray(np.concatenate(images).transpose(0, 2, 3, 1)),
            np.asarray(labels, np.int32))


def _load_cifar_arrays(name: str, root: Optional[str]):
    """(train images, train labels, test images, test labels) from the first of
    ``root``, ./data, /root/data, /data that holds the dataset's batch files,
    else None (the JAX package's candidate roots; no download)."""
    sub, train_files, test_files, label_key = CIFAR_FILES[name]
    for candidate in filter(None, (root,) + CIFAR_ROOTS):
        directory = os.path.join(candidate, sub)
        if all(os.path.isfile(os.path.join(directory, f)) for f in train_files + test_files):
            return (*read_cifar_batches(directory, train_files, label_key),
                    *read_cifar_batches(directory, test_files, label_key))
    return None


def load_cifar(
    dataset: str = "cifar10",
    *,
    root: Optional[str] = None,
    train_pct: float = 0.25,
    test_pct: float = 0.25,
    calib_per_class: int = 2,
    img_size: int = 224,
    batch_size_train: int = 32,
    batch_size_eval: int = 64,
    seed: int = 0,
    allow_synthetic: bool = True,
    device: DeviceLike = None,
) -> Tuple[DataPipeline, DataPipeline, DataPipeline]:
    """(train, test, calibration) pipelines on ``device``, the JAX package's
    split and calibration rules: the first ``train_pct`` / ``test_pct`` of each
    split, and the first ``calib_per_class`` images of each class from the full
    train split. Falls back to the synthetic dataset when CIFAR is not on disk
    unless ``allow_synthetic=False``."""
    ds_name = dataset.lower()
    if ds_name not in CIFAR_FILES:
        raise ValueError(f"Unsupported dataset: {dataset}")
    num_classes = 10 if ds_name == "cifar10" else 100
    dev = resolve_device(device)

    arrays = _load_cifar_arrays(ds_name, root)
    if arrays is None:
        if not allow_synthetic:
            raise FileNotFoundError(f"{ds_name} not found on disk and downloads are disabled")
        print(f"[INFO] {ds_name} not found on disk; using deterministic synthetic stand-in")
        tr_x, tr_y = synthetic_dataset(2048, num_classes, seed=seed)
        te_x, te_y = synthetic_dataset(1024, num_classes, seed=seed + 1)
    else:
        tr_x, tr_y, te_x, te_y = arrays

    n_train = int(len(tr_x) * train_pct) if train_pct is not None else len(tr_x)
    n_test = int(len(te_x) * test_pct) if test_pct is not None else len(te_x)

    counts = np.zeros((num_classes,), np.int64)
    calib_idx = []
    for i, y in enumerate(tr_y):
        if counts[y] < calib_per_class:
            calib_idx.append(i)
            counts[y] += 1
            if counts.min() >= calib_per_class:
                break
    calib_idx = np.asarray(calib_idx, np.int64)

    train = DataPipeline(tr_x[:n_train], tr_y[:n_train], img_size=img_size,
                         batch_size=batch_size_train, shuffle=True, seed=seed, flip=True,
                         device=dev)
    test = DataPipeline(te_x[:n_test], te_y[:n_test], img_size=img_size,
                        batch_size=batch_size_eval, shuffle=False, seed=seed, device=dev)
    calib = DataPipeline(tr_x[calib_idx], tr_y[calib_idx], img_size=img_size,
                         batch_size=batch_size_eval, shuffle=True, seed=seed, flip=True,
                         device=dev)
    return train, test, calib


def load_procgen_slice(path: str = PROCGEN_SLICE) -> Dict[str, np.ndarray]:
    """The committed slice of the procedural corpus that ``ckpts/vit_procgen``
    was trained on: 128 held-out images (seed 10_000_019) and 64 calibration
    images (seed 77), 64x64 uint8, as ``ssp_x_vit_tpu.data.procgen.
    procgen_dataset`` renders them. Keys: test_images, test_labels,
    calib_images, calib_labels, test_seed, calib_seed."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
