"""RoPE frequency computation, including HF ``rope_scaling`` variants (own
copy of ``ssp_x_vit_tpu/llm/rope.py``; numpy only).

Llama-3.1-class checkpoints need the ``llama3`` wavelength-banded frequency
correction, and YaRN-extended checkpoints the interpolation/extrapolation ramp
plus an attention-temperature scale on cos/sin. The formulas mirror
transformers ``modeling_rope_utils.py`` and are computed in float64 numpy, so
every path derives the same per-dim inverse frequencies from the config.

``dynamic`` NTK scaling is refused: its frequencies depend on the observed
sequence length, which would make cached decode disagree with full recompute.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class RopeScaling:
    """Frozen (hashable) rope_scaling params.

    Field names follow the HF config dict. ``factor`` is the context
    extension ratio; llama3 additionally bands by wavelength, yarn ramps
    between interpolated and extrapolated dims and scales attention
    temperature.
    """

    rope_type: str = "llama3"            # "linear" | "llama3" | "yarn"
    factor: float = 8.0
    # llama3
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position_embeddings: int = 8192
    # yarn
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    attention_factor: Optional[float] = None
    truncate: bool = True
    # deepseek-style yarn: when attention_factor is None and BOTH are set,
    # attention_factor = get_mscale(factor, mscale)/get_mscale(factor,
    # mscale_all_dim) (transformers _compute_yarn_parameters)
    mscale: Optional[float] = None
    mscale_all_dim: Optional[float] = None

    def __post_init__(self):
        if self.rope_type not in ("linear", "llama3", "yarn"):
            raise ValueError(
                f"rope_scaling type {self.rope_type!r} is unsupported: "
                "'dynamic' NTK frequencies depend on observed sequence "
                "length, which breaks the cached-decode == full-recompute "
                "exactness contract; others are unknown. Supported: "
                "linear, llama3, yarn.")


def _default_inv_freq(theta: float, rd: int) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, rd, 2, dtype=np.float64) / rd))


def yarn_get_mscale(scale: float, mscale: float = 1.0) -> float:
    """transformers ``get_mscale``: the yarn attention temperature."""
    if scale <= 1.0:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def _llama3_inv_freq(theta: float, rd: int, sc: RopeScaling) -> np.ndarray:
    """transformers ``_compute_llama3_parameters``: frequencies whose
    wavelength exceeds the low-freq band are divided by ``factor``; the
    medium band interpolates smoothly; high-freq (short-wavelength) dims are
    kept verbatim."""
    inv_freq = _default_inv_freq(theta, rd)
    old_ctx = float(sc.original_max_position_embeddings)
    low_freq_wavelen = old_ctx / sc.low_freq_factor
    high_freq_wavelen = old_ctx / sc.high_freq_factor
    wavelen = 2.0 * math.pi / inv_freq
    out = np.where(wavelen > low_freq_wavelen, inv_freq / sc.factor, inv_freq)
    smooth = ((old_ctx / wavelen - sc.low_freq_factor)
              / (sc.high_freq_factor - sc.low_freq_factor))
    smoothed = (1.0 - smooth) * out / sc.factor + smooth * out
    is_medium = ~(wavelen < high_freq_wavelen) & ~(wavelen > low_freq_wavelen)
    return np.where(is_medium, smoothed, out)


def _yarn_inv_freq(theta: float, rd: int,
                   sc: RopeScaling) -> Tuple[np.ndarray, float]:
    """transformers ``_compute_yarn_parameters``: NTK-by-parts — dims whose
    rotations at the original context exceed ``beta_fast`` extrapolate
    (original freqs), those below ``beta_slow`` interpolate (freqs / factor),
    with a linear ramp between; cos/sin are scaled by the mscale attention
    temperature."""
    old_ctx = float(sc.original_max_position_embeddings)

    if sc.attention_factor is not None:
        attn_scale = float(sc.attention_factor)
    elif sc.mscale and sc.mscale_all_dim:
        # deepseek-style: ratio of the two mscale temperatures
        attn_scale = (yarn_get_mscale(sc.factor, sc.mscale)
                      / yarn_get_mscale(sc.factor, sc.mscale_all_dim))
    else:
        attn_scale = yarn_get_mscale(sc.factor)

    def correction_dim(num_rotations: float) -> float:
        return (rd * math.log(old_ctx / (num_rotations * 2.0 * math.pi))
                / (2.0 * math.log(theta)))

    low = correction_dim(sc.beta_fast)
    high = correction_dim(sc.beta_slow)
    if sc.truncate:
        low, high = math.floor(low), math.ceil(high)
    low, high = max(low, 0.0), min(high, rd - 1.0)
    if low == high:
        high += 0.001  # avoid 0/0 in the ramp

    pos_freqs = theta ** (np.arange(0, rd, 2, dtype=np.float64) / rd)
    inv_extrapolation = 1.0 / pos_freqs
    inv_interpolation = 1.0 / (sc.factor * pos_freqs)
    ramp = np.clip((np.arange(rd // 2, dtype=np.float64) - low)
                   / (high - low), 0.0, 1.0)
    extrapolation_factor = 1.0 - ramp
    inv_freq = (inv_interpolation * (1.0 - extrapolation_factor)
                + inv_extrapolation * extrapolation_factor)
    return inv_freq, attn_scale


def rope_freqs(theta: float, rd: int,
               scaling: Optional[RopeScaling]) -> Tuple[np.ndarray, float]:
    """Per-dim inverse frequencies [rd//2] (float32 numpy) plus the attention
    scale multiplying cos/sin (1.0 except under yarn)."""
    if scaling is None:
        inv_freq, scale = _default_inv_freq(theta, rd), 1.0
    elif scaling.rope_type == "linear":
        inv_freq, scale = _default_inv_freq(theta, rd) / scaling.factor, 1.0
    elif scaling.rope_type == "llama3":
        inv_freq, scale = _llama3_inv_freq(theta, rd, scaling), 1.0
    elif scaling.rope_type == "yarn":
        inv_freq, scale = _yarn_inv_freq(theta, rd, scaling)
    else:  # pragma: no cover — __post_init__ refuses unknown types
        raise ValueError(f"unknown rope_scaling type {scaling.rope_type!r}")
    return inv_freq.astype(np.float32), float(scale)


def parse_rope_scaling(d) -> Optional[RopeScaling]:
    """HF config ``rope_scaling`` dict -> RopeScaling (None passes through).

    transformers accepts both the legacy ``type`` and current ``rope_type``
    keys; llama-3.1 checkpoints carry rope_type/factor/low_freq_factor/
    high_freq_factor/original_max_position_embeddings, yarn checkpoints
    carry factor/beta_fast/beta_slow/attention_factor.
    """
    if d is None:
        return None
    kind = d.get("rope_type", d.get("type"))
    if kind is None:
        raise ValueError(f"rope_scaling dict without type: {d!r}")
    if kind == "default":
        return None
    kw = dict(rope_type=str(kind), factor=float(d.get("factor", 1.0)))
    if "low_freq_factor" in d:
        kw["low_freq_factor"] = float(d["low_freq_factor"])
    if "high_freq_factor" in d:
        kw["high_freq_factor"] = float(d["high_freq_factor"])
    if "original_max_position_embeddings" in d:
        kw["original_max_position_embeddings"] = int(
            d["original_max_position_embeddings"])
    if "beta_fast" in d:
        kw["beta_fast"] = float(d["beta_fast"])
    if "beta_slow" in d:
        kw["beta_slow"] = float(d["beta_slow"])
    if d.get("attention_factor") is not None:
        kw["attention_factor"] = float(d["attention_factor"])
    if "truncate" in d:
        kw["truncate"] = bool(d["truncate"])
    if d.get("mscale") is not None:
        kw["mscale"] = float(d["mscale"])
    if d.get("mscale_all_dim") is not None:
        kw["mscale_all_dim"] = float(d["mscale_all_dim"])
    return RopeScaling(**kw)


def export_rope_scaling(sc: Optional[RopeScaling]):
    """RopeScaling -> HF config dict (inverse of parse_rope_scaling)."""
    if sc is None:
        return None
    d = {"rope_type": sc.rope_type, "factor": sc.factor}
    if sc.rope_type == "llama3":
        d.update(low_freq_factor=sc.low_freq_factor,
                 high_freq_factor=sc.high_freq_factor,
                 original_max_position_embeddings=(
                     sc.original_max_position_embeddings))
    elif sc.rope_type == "yarn":
        d.update(beta_fast=sc.beta_fast, beta_slow=sc.beta_slow,
                 original_max_position_embeddings=(
                     sc.original_max_position_embeddings),
                 truncate=sc.truncate)
        if sc.attention_factor is not None:
            d["attention_factor"] = sc.attention_factor
        if sc.mscale is not None:
            d["mscale"] = sc.mscale
        if sc.mscale_all_dim is not None:
            d["mscale_all_dim"] = sc.mscale_all_dim
    return d
