"""The native batch-assembly library (``native/dataloader.cc``) through ctypes
(counterpart of ``ssp_x_vit_tpu/data/native_loader.py``).

``gather_batch`` assembles ``images[indices]`` with per-sample horizontal
flips into one contiguous uint8 batch in a single multithreaded pass (the
library's ``normalize_batch_f32`` has no caller: ``DataPipeline`` normalizes
on the device). The library is compiled with g++ into ``build/native/<hash>/`` at first use
(the hash covers the source and the flags; ``build_library`` also builds
``native/image_decode.cc`` and the tokenizers' ``native/bpe*.cc``);
``native/*.so`` is never used. A failed build raises: the JAX package falls
back to numpy in silence, the port does not.
``gather_batch_plain`` is the numpy version the tests hold it against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
LOADER_SOURCE = _ROOT / "native" / "dataloader.cc"
BUILD_ROOT = _ROOT / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared")

_lock = threading.Lock()
_lib = None


def build_library(source: Path, lib_name: str, flags=CXX_FLAGS) -> Path:
    """Compile ``source`` with g++ unless its library for this source and
    these flags exists; return the library's path (under ``BUILD_ROOT/<hash>``,
    written under a temporary name and renamed, so a concurrent build never
    loads a half-written file). A failed build raises ``RuntimeError``."""
    h = hashlib.sha256(" ".join(flags).encode())
    h.update(source.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    so = out_dir / lib_name
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"{lib_name}.{os.getpid()}.{threading.get_ident()}.tmp"
        proc = subprocess.run([os.environ.get("CXX", "g++"), *flags, "-o", str(tmp),
                               str(source)], capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"native {source.name} build failed (exit {proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
    return so


def native_library() -> ctypes.CDLL:
    """The loaded library with its C signatures declared; built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library(LOADER_SOURCE, "libssp_dataloader.so")))
            lib.gather_batch_u8.restype = None
            lib.gather_batch_u8.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int]
            _lib = lib
        return _lib


def gather_batch(images: np.ndarray, indices, flips=None,
                 num_threads: Optional[int] = None) -> np.ndarray:
    """``images[indices]`` ([N, h, w, c] uint8), row i reversed along w where
    ``flips[i]`` is set, as one contiguous ``[n, h, w, c]`` uint8 batch."""
    if images.dtype != np.uint8 or images.ndim != 4:
        raise ValueError(f"images must be [N, h, w, c] uint8, got {images.dtype} "
                         f"{images.shape}")
    idx = np.ascontiguousarray(np.asarray(indices, np.int64).reshape(-1))
    n = idx.size
    if n and (idx.min() < 0 or idx.max() >= images.shape[0]):
        raise IndexError(f"indices outside [0, {images.shape[0]})")
    fl = None
    if flips is not None:
        fl = np.ascontiguousarray(np.asarray(flips).astype(np.uint8).reshape(-1))
        if fl.size != n:
            raise ValueError(f"{fl.size} flips for {n} indices")
    images = np.ascontiguousarray(images)
    h, w, c = images.shape[1:]
    out = np.empty((n, h, w, c), np.uint8)
    native_library().gather_batch_u8(
        images.ctypes.data, idx.ctypes.data, None if fl is None else fl.ctypes.data,
        n, h, w, c, out.ctypes.data,
        num_threads if num_threads is not None else min(8, os.cpu_count() or 1))
    return out


def gather_batch_plain(images: np.ndarray, indices, flips=None) -> np.ndarray:
    """The numpy version of :func:`gather_batch`."""
    out = images[np.asarray(indices, np.int64)].copy()
    if flips is not None:
        sel = np.asarray(flips).astype(bool)
        out[sel] = out[sel, :, ::-1]
    return np.ascontiguousarray(out)
