"""Procedurally generated offline image-classification corpus (counterpart of
``ssp_x_vit_tpu/data/procgen.py``), in numpy.

The JAX package renders the corpus that ``ckpts/vit_procgen`` was trained on
with ``jax.random`` keys. The card's machine has no JAX, so this module
carries JAX's default PRNG over to numpy: threefry-2x32 with
``jax_threefry_partitionable`` on (JAX 0.9's default), ``PRNGKey``, ``split``,
``fold_in`` and the ``uniform`` / ``normal`` / ``randint`` maps from bits to
values. The draws are JAX's bit for bit; ``normal`` goes through float32
``erfinv`` (Giles' polynomial, as XLA's), whose last ulp may differ. The
renderer follows ``_render_one`` in float32; the images agree with JAX's
within one uint8 step.

Classes (16): shape {circle, square, triangle, cross} x texture {solid,
stripes, checker, dots}; label = shape_id * 4 + texture_id. Position, scale,
rotation, colors, texture frequency and phase, and pixel noise are drawn per
sample.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

NUM_SHAPES = 4
NUM_TEXTURES = 4
NUM_CLASSES = NUM_SHAPES * NUM_TEXTURES

CLASS_NAMES = tuple(
    f"{s}_{t}"
    for s in ("circle", "square", "triangle", "cross")
    for t in ("solid", "stripes", "checker", "dots")
)

_M32 = np.uint64(0xFFFFFFFF)
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k1, k2, x1, x2) -> Tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash (20 rounds) of the counter pairs (x1, x2) under
    the key (k1, k2); uint32 in and out, broadcast together."""
    k1, k2, x1, x2 = (np.asarray(a, np.uint64) for a in (k1, k2, x1, x2))
    ks = (k1, k2, k1 ^ k2 ^ np.uint64(0x1BD11BDA))
    a = (x1 + ks[0]) & _M32
    b = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & _M32
            b = ((b << np.uint64(r)) | (b >> np.uint64(32 - r))) & _M32
            b = a ^ b
        a = (a + ks[(i + 1) % 3]) & _M32
        b = (b + ks[(i + 2) % 3] + np.uint64(i + 1)) & _M32
    return a.astype(np.uint32), b.astype(np.uint32)


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``: [2] uint32 (high and low 32 bits)."""
    seed = int(seed)
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], np.uint32)


def _iota_bits(key: np.ndarray, shape) -> Tuple[np.ndarray, np.ndarray]:
    """threefry of the 64-bit iota over ``shape`` (partitionable layout)."""
    n = int(np.prod(shape, dtype=np.int64))
    lo = np.arange(n, dtype=np.uint64)
    b1, b2 = threefry2x32(key[0], key[1], lo >> np.uint64(32), lo & _M32)
    return b1.reshape(shape), b2.reshape(shape)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split``: [num, 2] uint32 keys."""
    b1, b2 = _iota_bits(key, (num,))
    return np.stack([b1, b2], axis=1)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in``: a new key from ``key`` and a uint32 ``data``."""
    b1, b2 = threefry2x32(key[0], key[1], 0, np.uint32(int(data) & 0xFFFFFFFF))
    return np.array([b1, b2], np.uint32)


def random_bits(key: np.ndarray, shape) -> np.ndarray:
    """32 random bits per element (``jax.random.bits``, uint32)."""
    b1, b2 = _iota_bits(key, tuple(shape))
    return b1 ^ b2


def uniform(key: np.ndarray, shape=(), minval=0.0, maxval=1.0) -> np.ndarray:
    """``jax.random.uniform`` in float32: 23 random mantissa bits -> [1, 2) - 1,
    scaled to [minval, maxval). XLA fuses the scale and shift into one fused
    multiply-add; the product of two float32 values is exact in float64, so
    the sum there rounds once to float64 and once to float32."""
    lo, hi = np.float32(minval), np.float32(maxval)
    bits = (random_bits(key, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    floats = bits.view(np.float32) - np.float32(1.0)
    scaled = (floats.astype(np.float64) * np.float64(hi - lo) + np.float64(lo)).astype(np.float32)
    return np.maximum(lo, scaled)


def erfinv_f32(x: np.ndarray) -> np.ndarray:
    """Inverse error function in float32, Giles' single-precision polynomial
    (XLA's ``ErfInv`` for f32); +-inf at +-1."""
    x = np.asarray(x, np.float32)
    w = -np.log1p(-x * x)
    small = w < np.float32(5.0)
    ws = np.where(small, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0))
    coef_small = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                  0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
    coef_large = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                  0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)
    p = np.where(small, np.float32(coef_small[0]), np.float32(coef_large[0]))
    for cs, cl in zip(coef_small[1:], coef_large[1:]):
        p = np.where(small, np.float32(cs), np.float32(cl)) + p * ws
    out = p * x
    return np.where(np.abs(x) == np.float32(1.0), x * np.float32(np.inf), out).astype(np.float32)


def normal(key: np.ndarray, shape=()) -> np.ndarray:
    """``jax.random.normal`` in float32: sqrt(2) * erfinv(u), u uniform on
    (-1, 1)."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0), dtype=np.float32)
    u = uniform(key, shape, lo, np.float32(1.0))
    return (np.float32(np.sqrt(2)) * erfinv_f32(u)).astype(np.float32)


def randint(key: np.ndarray, shape, minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint`` for int32: two 32-bit draws reduced modulo the
    span with JAX's multiplier (the same bias)."""
    k1, k2 = split(key)
    higher = random_bits(k1, shape).astype(np.uint64)
    lower = random_bits(k2, shape).astype(np.uint64)
    span = np.uint64(max(1, maxval - minval) if maxval > minval else 1)
    mult = ((np.uint64(2 ** 16) % span) ** np.uint64(2) & _M32) % span
    offset = (((higher % span) * mult & _M32) + lower % span) & _M32
    return (np.int64(minval) + (offset % span).astype(np.int64)).astype(np.int32)


def _render(keys: np.ndarray, labels: np.ndarray, image_size: int) -> np.ndarray:
    """``_render_one`` for every (key, label): [n, H, W, 3] float32 in [0, 1]."""
    f32 = np.float32
    n = len(labels)
    draws = {name: [] for name in ("theta", "scale", "cx", "cy", "freq", "phase",
                                   "fg", "fg2", "bg", "noise")}
    for key in keys:
        ks = split(key, 12)
        draws["theta"].append(uniform(ks[0], (), 0.0, 2.0 * np.pi))
        draws["scale"].append(uniform(ks[1], (), 0.40, 0.70))
        draws["cx"].append(uniform(ks[2], (), -0.18, 0.18))
        draws["cy"].append(uniform(ks[3], (), -0.18, 0.18))
        draws["freq"].append(uniform(ks[4], (), 3.0, 6.0))
        draws["phase"].append(uniform(ks[5], (), 0.0, 2.0 * np.pi))
        draws["fg"].append(uniform(ks[6], (3,), 0.55, 1.0))
        draws["fg2"].append(uniform(ks[7], (3,), 0.0, 0.35))
        draws["bg"].append(uniform(ks[8], (3,), 0.25, 0.50))
        draws["noise"].append(f32(0.04) * normal(ks[9], (image_size, image_size, 3)))
    p = {k: np.stack(v).astype(f32) for k, v in draws.items()}
    theta, scale, cx, cy, freq, phase = (p[k].reshape(n, 1, 1) for k in
                                         ("theta", "scale", "cx", "cy", "freq", "phase"))
    fg, fg2, bg = (p[k].reshape(n, 1, 1, 3) for k in ("fg", "fg2", "bg"))
    shape_id = (labels // NUM_TEXTURES).reshape(n, 1, 1)
    tex_id = (labels % NUM_TEXTURES).reshape(n, 1, 1)

    ax = np.linspace(-1.0, 1.0, image_size, dtype=f32)
    yy, xx = np.meshgrid(ax, ax, indexing="ij")
    c, s = np.cos(theta), np.sin(theta)
    u = ((xx - cx) * c + (yy - cy) * s) / scale
    v = (-(xx - cx) * s + (yy - cy) * c) / scale

    r = np.sqrt(u * u + v * v + f32(1e-9))
    d_circle = r - f32(1.0)
    d_square = np.maximum(np.abs(u), np.abs(v)) - f32(0.9)
    d_triangle = np.maximum(f32(0.55) * np.abs(u) * f32(2.0) - (f32(0.8) - v), v - f32(0.8)) - f32(0.0)
    d_triangle = np.maximum(d_triangle, f32(-0.9) - v)
    d_cross = np.minimum(np.maximum(np.abs(u) - f32(0.32), np.abs(v) - f32(1.0)),
                         np.maximum(np.abs(v) - f32(0.32), np.abs(u) - f32(1.0)))
    sdf = np.select([shape_id == 0, shape_id == 1, shape_id == 2],
                    [d_circle, d_square, d_triangle], d_cross)
    aa = f32(1.5 * 2.0 / image_size) / scale
    inside = np.clip(f32(0.5) - sdf / aa, f32(0.0), f32(1.0))

    su = np.sin(freq * f32(np.pi) * u + phase)
    sv = np.sin(freq * f32(np.pi) * v + phase)
    stripes = f32(0.5) + f32(0.5) * np.tanh(f32(4.0) * su)
    checker = f32(0.5) + f32(0.5) * np.tanh(f32(4.0) * su * sv)
    dots = np.clip(f32(0.5) - f32(8.0) * (su ** 2 + sv ** 2 - f32(1.55)), f32(0.0), f32(1.0))
    tex = np.select([tex_id == 0, tex_id == 1, tex_id == 2],
                    [np.ones_like(u), stripes, checker], dots)

    obj = tex[..., None] * fg + (f32(1.0) - tex[..., None]) * fg2
    img = inside[..., None] * obj + (f32(1.0) - inside[..., None]) * bg
    return np.clip(img + p["noise"], f32(0.0), f32(1.0)).astype(f32)


def render_batch(key: np.ndarray, labels: np.ndarray, image_size: int = 64) -> np.ndarray:
    """[N] labels -> [N, H, W, 3] float32 images, one split key per sample."""
    labels = np.asarray(labels, np.int32)
    return _render(split(key, labels.shape[0]), labels, image_size)


def sample_batch(key: np.ndarray, batch: int, image_size: int = 64,
                 num_classes: int = NUM_CLASSES) -> Tuple[np.ndarray, np.ndarray]:
    """Random (images, labels) batch, the training stream; deterministic in key."""
    kl, ki = split(key)
    labels = randint(kl, (batch,), 0, num_classes)
    return render_batch(ki, labels, image_size=image_size), labels


def procgen_dataset(n: int, image_size: int = 64, seed: int = 0,
                    num_classes: int = NUM_CLASSES) -> Tuple[np.ndarray, np.ndarray]:
    """(images [n, h, w, 3] uint8, labels [n] int32): class-balanced and
    deterministic in seed, rendered in chunks of 512 as the JAX package does."""
    labels = np.arange(n, dtype=np.int32) % num_classes
    rng = np.random.default_rng(seed)
    rng.shuffle(labels)
    imgs = np.empty((n, image_size, image_size, 3), np.uint8)
    chunk = 512
    for i in range(0, n, chunk):
        lab = labels[i:i + chunk]
        key = fold_in(prng_key(seed), i)
        imgs[i:i + len(lab)] = np.round(
            render_batch(key, lab, image_size=image_size) * np.float32(255.0)).astype(np.uint8)
    return imgs, labels
