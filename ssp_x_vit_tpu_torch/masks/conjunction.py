"""Mask-conjunction algebra: AND-combine masks from multiple pruning methods
and escalate each method's internal sparsity until the conjunction reaches a
target effective sparsity (reference pruning_srp-main/mask_conjunction.py:
97-233 mask generators, :364-421 conjunction loop).

TPU-native formulation: masks are dense boolean arrays stacked over blocks —
[nb, 4, out, in] for attention (q, k, v, proj) and per-matrix arrays for the
FFN pair — so conjunction is one vectorized logical_and and the effective
sparsity one mean(), replacing the per-matrix python loops.

The synthetic model stub is replaced by :class:`ModelDims` (the generators
only ever used the dimensions).

The port's copy of ``ssp_x_vit_tpu/masks/conjunction.py`` (host code, numpy only):
the same results and, where it writes JSON, the same bytes.
"""

from __future__ import annotations

import dataclasses
from math import ceil
from typing import Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class ModelDims:
    """Stand-in for the reference's random-weight VisionModel stub
    (mask_conjunction.py:11-30): emb dim, head dim, num heads, 12 blocks."""

    emb_dim: int
    head_dim: int
    n_heads: int
    n_blocks: int = 12

    @property
    def attn_rows(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def ffn_dim(self) -> int:
        return 4 * self.emb_dim


class DepthPruning:
    """Whole-block masks in a (random or positional) block order."""

    def __init__(self, dims: ModelDims, random: bool = True, seed: int = 0):
        self.dims = dims
        self.random = random
        self.seed = seed

    def fit(self):
        rng = np.random.default_rng(self.seed)
        nb = self.dims.n_blocks
        self.at_ord = rng.permutation(nb) if self.random else np.arange(nb)
        self.fc_ord = rng.permutation(nb) if self.random else np.arange(nb)

    def _block_mask(self, order, sparsity):
        n = ceil(sparsity * self.dims.n_blocks)
        sel = np.zeros(self.dims.n_blocks, bool)
        sel[order[:n]] = True
        return sel

    def mask_at(self, sparsity: float) -> np.ndarray:
        """[nb, 4, attn_rows, emb] — True = pruned."""
        d = self.dims
        sel = self._block_mask(self.at_ord, sparsity)
        return np.broadcast_to(
            sel[:, None, None, None], (d.n_blocks, 4, d.attn_rows, d.emb_dim)
        ).copy()

    def mask_fc(self, sparsity: float) -> Tuple[np.ndarray, np.ndarray]:
        """([nb, ffn, emb] fc1, [nb, emb, ffn] fc2) — True = pruned."""
        d = self.dims
        sel = self._block_mask(self.fc_ord, sparsity)
        fc1 = np.broadcast_to(sel[:, None, None], (d.n_blocks, d.ffn_dim, d.emb_dim)).copy()
        fc2 = np.broadcast_to(sel[:, None, None], (d.n_blocks, d.emb_dim, d.ffn_dim)).copy()
        return fc1, fc2


class WidthPruning:
    """Per-head hidden-dim rows for attention ([q,k] and [v,proj] tied),
    per-neuron rows/cols for the FFN pair."""

    def __init__(self, dims: ModelDims, random: bool = True, seed: int = 1):
        self.dims = dims
        self.random = random
        self.seed = seed

    def fit(self):
        rng = np.random.default_rng(self.seed)
        d = self.dims
        if self.random:
            self.qk_ord = np.stack([rng.permutation(d.head_dim) for _ in range(d.n_blocks)])
            self.vp_ord = np.stack([rng.permutation(d.head_dim) for _ in range(d.n_blocks)])
            self.fc_ord = np.stack([rng.permutation(d.ffn_dim) for _ in range(d.n_blocks)])
        else:
            self.qk_ord = np.tile(np.arange(d.head_dim), (d.n_blocks, 1))
            self.vp_ord = np.tile(np.arange(d.head_dim), (d.n_blocks, 1))
            self.fc_ord = np.tile(np.arange(d.ffn_dim), (d.n_blocks, 1))

    def _row_sel(self, ord_per_block: np.ndarray, n: int, tile_heads: bool) -> np.ndarray:
        """[nb, attn_rows] bool from per-block within-head orders."""
        d = self.dims
        sel = np.zeros((d.n_blocks, d.attn_rows if tile_heads else ord_per_block.shape[1]), bool)
        if n <= 0:
            return sel
        for b in range(d.n_blocks):
            idx = ord_per_block[b][:n]
            if tile_heads:
                offs = (np.arange(d.n_heads) * d.head_dim)[:, None]
                sel[b, (idx[None, :] + offs).ravel()] = True
            else:
                sel[b, idx] = True
        return sel

    def mask_at(self, sparsity: float) -> np.ndarray:
        d = self.dims
        n = ceil(sparsity * d.head_dim)
        qk = self._row_sel(self.qk_ord, n, tile_heads=True)
        vp = self._row_sel(self.vp_ord, n, tile_heads=True)
        rows = np.stack([qk, qk, vp, vp], axis=1)  # [nb, 4, attn_rows]
        return np.broadcast_to(rows[..., None], (d.n_blocks, 4, d.attn_rows, d.emb_dim)).copy()

    def mask_fc(self, sparsity: float) -> Tuple[np.ndarray, np.ndarray]:
        d = self.dims
        n = ceil(sparsity * d.ffn_dim)
        sel = self._row_sel(self.fc_ord, n, tile_heads=False)  # [nb, ffn]
        fc1 = np.broadcast_to(sel[:, :, None], (d.n_blocks, d.ffn_dim, d.emb_dim)).copy()
        fc2 = np.broadcast_to(sel[:, None, :], (d.n_blocks, d.emb_dim, d.ffn_dim)).copy()
        return fc1, fc2


class HeadPruning:
    """Whole attention heads in positional order; no FFN masking."""

    def __init__(self, dims: ModelDims, random: bool = True, seed: int = 2):
        self.dims = dims
        self.random = random

    def fit(self):
        self.orders = np.tile(np.arange(self.dims.n_heads), (self.dims.n_blocks, 1))

    def mask_at(self, sparsity: float) -> np.ndarray:
        d = self.dims
        n = ceil(sparsity * d.n_heads)
        sel = np.zeros((d.n_blocks, d.attn_rows), bool)
        for b in range(d.n_blocks):
            for h in self.orders[b][:n]:
                sel[b, h * d.head_dim : (h + 1) * d.head_dim] = True
        rows = np.broadcast_to(sel[:, None, :], (d.n_blocks, 4, d.attn_rows))
        return np.broadcast_to(rows[..., None], (d.n_blocks, 4, d.attn_rows, d.emb_dim)).copy()

    def mask_fc(self, sparsity: float) -> Tuple[np.ndarray, np.ndarray]:
        d = self.dims
        return (np.zeros((d.n_blocks, d.ffn_dim, d.emb_dim), bool),
                np.zeros((d.n_blocks, d.emb_dim, d.ffn_dim), bool))


def conjunction(*masks):
    """AND-combine any number of same-shaped mask arrays."""
    out = masks[0]
    for m in masks[1:]:
        out = np.logical_and(out, m)
    return out


def count_pruned(*masks) -> float:
    """Pruned fraction over the union of the given mask arrays' elements."""
    pruned = sum(int(m.sum()) for m in masks)
    total = sum(int(m.size) for m in masks)
    return pruned / max(1, total)


def mask_conjunction(
    dims: ModelDims,
    methods: Sequence[Tuple[type, bool, bool]],
    target: float,
    init_sparsity: Tuple[float, float] | None = None,
    random: bool = True,
) -> Tuple[float, float, float, float]:
    """(method_class, prunes_att, prunes_mlp) tuples -> final internal
    sparsities and effective conjunction sparsities (att, mlp).

    Each phase raises the internal sparsity by 2e-3 steps until the
    AND-combined mask reaches the target effective sparsity (reference
    :377-421, step and loop structure preserved)."""
    sparsity_step = 2e-3
    atsp, fcsp = (target, target) if init_sparsity is None else init_sparsity

    pruners = [m[0](dims, random) for m in methods]
    for p in pruners:
        p.fit()

    at_sparsity, ef_sparsity = atsp, 0.0
    while ef_sparsity < target:
        ms = [p.mask_at(at_sparsity) for p, f in zip(pruners, methods) if f[1]]
        ef_sparsity = count_pruned(conjunction(*ms)) if ms else 1.0
        if at_sparsity >= 1:
            break
        at_sparsity = min(1.0, at_sparsity + sparsity_step)
    at_ef = ef_sparsity

    fc_sparsity, ef_sparsity = fcsp, 0.0
    while ef_sparsity < target:
        ms = [p.mask_fc(fc_sparsity) for p, f in zip(pruners, methods) if f[2]]
        if ms:
            fc1 = conjunction(*[m[0] for m in ms])
            fc2 = conjunction(*[m[1] for m in ms])
            ef_sparsity = count_pruned(fc1, fc2)
        else:
            ef_sparsity = 1.0
        if fc_sparsity >= 1:
            break
        fc_sparsity = min(1.0, fc_sparsity + sparsity_step)
    fc_ef = ef_sparsity

    return at_sparsity, fc_sparsity, float(at_ef), float(fc_ef)


def test_unstr_mask_conj(emb_dim, head_dim, num_heads, num_steps, methods, random=True):
    """Sparsity sweep driver (reference :423-439); returns the five series."""
    targets, ats, fcs, at_ef, fc_ef = [0], [0], [0], [0], [0]
    dims = ModelDims(emb_dim, head_dim, num_heads)
    step = 1 / num_steps
    for i in range(num_steps):
        target = (i + 1) * step
        print(f"Sparsity {target*100:3.0f}%: ", end="")
        r = mask_conjunction(dims, methods, target, (ats[-1], fcs[-1]), random)
        targets.append(round(target, 5))
        ats.append(round(r[0], 5))
        fcs.append(round(r[1], 5))
        at_ef.append(round(r[2], 5))
        fc_ef.append(round(r[3], 5))
        print(f"Att: {r[0]*100:4.1f}%    Att Eff: {r[2]*100:4.1f}%    "
              f"MLP: {r[1]*100:4.1f}%    MLP Eff: {r[3]*100:4.1f}%")
    return targets, ats, fcs, at_ef, fc_ef
