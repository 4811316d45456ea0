"""Image files as Pillow reads them, without Pillow: the JPEG decoder and
Pillow's bicubic resize of ``native/image_decode.cc`` through ctypes, and
PNG through ``data/png.py``.

``decode_rgb(path)`` is ``np.asarray(Image.open(path).convert("RGB"))`` and
``load_resized(paths, res)`` stacks ``Image.open(p).convert("RGB").resize((res,
res))`` (BICUBIC, Pillow's default) for every path, as the JAX package's
Oxford-IIIT-Pet loader does through torchvision; both bit for bit against
Pillow 12.1.0 on libjpeg-turbo 3.1.3. The format is sniffed from the first
bytes, as Pillow does (a ``.jpg`` name does not promise JPEG data); a format
other than JPEG and PNG, or a file the reader cannot take, raises
``ValueError`` naming the file.

The library is compiled with g++ into ``build/native/<hash>/`` at first use
(``native_loader.build_library``); a failed build raises. ``load_resized``
decodes the JPEGs straight into the output array with one thread per CPU of
the process's affinity mask, while the calling thread reads the PNGs.
``resize_plain`` is Pillow's fixed-point resize in numpy, the version the C++
resize is held against.
"""

from __future__ import annotations

import ctypes
import math
import os
import threading
from pathlib import Path
from typing import Sequence

import numpy as np

from ssp_x_vit_tpu_torch.data import native_loader, png

SOURCE = Path(__file__).resolve().parents[2] / "native" / "image_decode.cc"
CXX_FLAGS = native_loader.CXX_FLAGS + ("-ffp-contract=off",)
JPEG_MAGIC = b"\xff\xd8\xff"
PRECISION_BITS = 32 - 8 - 2

_lock = threading.Lock()
_lib = None


def native_library() -> ctypes.CDLL:
    """The loaded library with its C signatures declared; built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(native_loader.build_library(SOURCE, "libssp_image.so",
                                                              CXX_FLAGS)))
            lib.ssp_jpeg_decode_rgb.restype = ctypes.c_int
            lib.ssp_jpeg_decode_rgb.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int), ctypes.c_char_p,
                ctypes.c_int]
            lib.ssp_image_free.restype = None
            lib.ssp_image_free.argtypes = [ctypes.c_void_p]
            lib.ssp_resize_rgb.restype = None
            lib.ssp_resize_rgb.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
            lib.ssp_decode_resize_many.restype = ctypes.c_int64
            lib.ssp_decode_resize_many.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
            _lib = lib
        return _lib


def affinity_threads() -> int:
    """The number of CPUs this process may run on."""
    return len(os.sched_getaffinity(0))


def image_format(path, head: bytes) -> str:
    """``"jpeg"`` or ``"png"`` from a file's first bytes, as Pillow sniffs;
    anything else raises ``ValueError`` naming the file and what it starts with."""
    if head[:3] == JPEG_MAGIC:
        return "jpeg"
    if head[:8] == png.SIGNATURE:
        return "png"
    raise ValueError(f"{path}: neither JPEG nor PNG data (the file starts with {head[:8]!r})")


def _decode_jpeg(data: bytes, path) -> np.ndarray:
    lib = native_library()
    buf, w, h = ctypes.c_void_p(), ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(512)
    if lib.ssp_jpeg_decode_rgb(data, len(data), ctypes.byref(buf), ctypes.byref(w),
                               ctypes.byref(h), err, len(err)):
        raise ValueError(f"{path}: {err.value.decode(errors='replace')}")
    try:
        n = w.value * h.value * 3
        out = np.ctypeslib.as_array(ctypes.cast(buf, ctypes.POINTER(ctypes.c_uint8)), (n,)).copy()
    finally:
        lib.ssp_image_free(buf)
    return out.reshape(h.value, w.value, 3)


def decode_rgb(path) -> np.ndarray:
    """[h, w, 3] uint8: ``Image.open(path).convert("RGB")``."""
    data = Path(path).read_bytes()
    if image_format(path, data[:8]) == "png":
        return png.read_rgb(data, str(path))
    return _decode_jpeg(data, path)


def resize(rgb: np.ndarray, res: int) -> np.ndarray:
    """[res, res, 3] uint8: ``Image.fromarray(rgb).resize((res, res))`` (BICUBIC)."""
    rgb = np.ascontiguousarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"rgb must be [h, w, 3] uint8, got {rgb.dtype} {rgb.shape}")
    out = np.empty((res, res, 3), np.uint8)
    native_library().ssp_resize_rgb(rgb.ctypes.data, rgb.shape[1], rgb.shape[0],
                                    out.ctypes.data, res, res)
    return out


def _coefficients(in_size: int, out_size: int):
    """Resample.c ``precompute_coeffs`` + ``normalize_coeffs_8bpc`` for
    BICUBIC over the whole axis: per output, the first input and the int32
    weights (the same double arithmetic, in the same order, as Pillow)."""
    scale = in_size / out_size  # Pillow's (double)(float)in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale

    def bicubic(x):
        a = -0.5
        x = abs(x)
        if x < 1.0:
            return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
        if x < 2.0:
            return (((x - 5) * x + 8) * x - 4) * a
        return 0.0

    out = []
    for xx in range(out_size):
        center = 0.0 + (xx + 0.5) * scale
        ss = 1.0 / filterscale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [bicubic((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for v in w:
            ww += v
        if ww != 0.0:
            w = [v / ww for v in w]
        k = [math.trunc(-0.5 + v * (1 << PRECISION_BITS)) if v < 0
             else math.trunc(0.5 + v * (1 << PRECISION_BITS)) for v in w]
        out.append((xmin, np.asarray(k, np.int64)))
    return out


def _clip8(acc: np.ndarray) -> np.ndarray:
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_plain(rgb: np.ndarray, res: int) -> np.ndarray:
    """The numpy version of :func:`resize`: Pillow's horizontal pass into
    uint8, then its vertical pass, each rounding with 2**21 and clipping."""
    img = np.asarray(rgb, np.uint8)
    h, w = img.shape[:2]
    if (h, w) == (res, res):
        return img.copy()
    if w != res:
        taps = _coefficients(w, res)
        tmp = np.empty((h, res, 3), np.uint8)
        for xx, (xmin, k) in enumerate(taps):
            acc = img[:, xmin:xmin + len(k)].astype(np.int64) * k[None, :, None]
            tmp[:, xx] = _clip8(acc.sum(axis=1) + (1 << (PRECISION_BITS - 1)))
        img = tmp
    if h != res:
        taps = _coefficients(h, res)
        tmp = np.empty((res, img.shape[1], 3), np.uint8)
        for yy, (ymin, k) in enumerate(taps):
            acc = img[ymin:ymin + len(k)].astype(np.int64) * k[:, None, None]
            tmp[yy] = _clip8(acc.sum(axis=0) + (1 << (PRECISION_BITS - 1)))
        img = tmp
    return img


def load_resized(paths: Sequence, res: int) -> np.ndarray:
    """[n, res, res, 3] uint8: every file decoded to RGB and resized as
    ``Image.open(p).convert("RGB").resize((res, res))``. The JPEGs are decoded
    by the library straight into the output array with one thread per CPU of
    the process's affinity, on a thread of their own while this one reads the
    PNGs through ``data/png.py``. A file the reader cannot take raises
    ``ValueError`` naming it."""
    return _load_resized(paths, res, affinity_threads())


def _load_resized(paths: Sequence, res: int, threads: int) -> np.ndarray:
    """:func:`load_resized` with the library's thread count given."""
    paths = [str(p) for p in paths]
    out = np.empty((len(paths), res, res, 3), np.uint8)
    kinds = []
    for p in paths:
        with open(p, "rb") as f:
            kinds.append(image_format(p, f.read(8)))
    jpegs = [i for i, k in enumerate(kinds) if k == "jpeg"]
    names = (ctypes.c_char_p * len(jpegs))(*[os.fsencode(paths[i]) for i in jpegs])
    slots = np.asarray(jpegs, np.int64)
    err = ctypes.create_string_buffer(512)
    lib = native_library()
    result = []

    def decode_jpegs():  # ctypes releases the GIL for the call
        try:
            result.append(lib.ssp_decode_resize_many(names, slots.ctypes.data, len(jpegs), res,
                                                     out.ctypes.data, threads, err, len(err)))
        except BaseException as e:  # handed to the caller below
            result.append(e)

    worker = threading.Thread(target=decode_jpegs, name="jpeg-decode")
    worker.start()
    try:
        for i, k in enumerate(kinds):
            if k == "png":
                out[i] = resize(decode_rgb(paths[i]), res)
    finally:
        worker.join()
    (bad,) = result
    if isinstance(bad, BaseException):
        raise bad
    if bad >= 0:
        raise ValueError(f"{paths[jpegs[bad]]}: {err.value.decode(errors='replace')}")
    return out
