"""Paged decode attention over one MLA latent pool, alone and with the
decode layer's row write (replaces ``ssp_x_vit_tpu/ops/pallas/paged_attention.py``'s
``paged_attention_pallas`` where ``llm/paged_mla.py`` calls it:
``paged_attention(q_cat, pool, pool, page_tables, seq_lens + 1)``, one pool
that is both K and V, after ``paged_pool_write`` of the new latent row).

    paged_mla_attention        q [b, nq, D] against the rows ``pos < seq_lens[i]``
                               of layer ``layer_idx`` of the pool ``[A, 1, P, ps, D]``
                               (fp32, bf16, or int8 codes with one scale per row):
                               fp32 scores of ``q / sqrt(D)``, softmax, times the
                               same rows; ``[b, nq, D]`` in q's dtype.
    paged_mla_attention_write  the decode layer: ``new_row`` [b, 1, D] into slot
                               ``positions[i]`` (``paged_pool_write``), then the
                               attention over ``positions + 1`` keys, of which the
                               first ``v_cols`` columns are returned; one launch.

Two kernels, chosen by shape and dtype alone (never on an error):

- ``csrc/paged_mla_hopper.cu`` (counters ``paged_mla_write_hopper`` / ``_q8``)
  takes the write-and-attend call with a bf16 or int8 pool, D = 576, 512
  output columns, a head count that is a multiple of 64 and pages of a power
  of two of at least 8 keys (DeepSeek-V2/V3): 64 heads a CTA on wgmma (a
  scorer warpgroup for S and the softmax, two for P V), 32-key tiles fed by a
  TMA ring, each row read once per head group, runs from
  :func:`mla_hopper_plan` that combine inside a cluster.
- ``csrc/paged_mla.cu`` takes everything else: the standalone attention
  (counters ``paged_mla_attention`` / ``_q8``) and the write-and-attend call
  with an fp32 pool (whose 1e-5 limit rules out bf16 tensor cores), other
  head counts or other widths (``paged_mla_attention_write`` / ``_q8``):
  16 heads a block on mma.sync, runs from :func:`mla_split_plan`.

Both combine their runs in run order inside the launch, so two calls give
the same bits, and both put the new row into their own staged tile where it
is a key (a slot outside the table goes to row 0 of trash page 0, which only
that sequence's rows read). ``paged_mla_attention_write`` decides its checks
and its route once per signature; a known signature checks again only the
card, contiguity and the host-integer layer.

On CPU tensors the wrappers run the plain versions; a CUDA tensor always
launches a kernel or raises (``ValueError`` for a shape no kernel takes).
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Dict, NamedTuple, Optional

import torch

from ssp_x_vit_tpu_torch.ops import dispatch
from ssp_x_vit_tpu_torch.ops.kernels import build, launch_counts
from ssp_x_vit_tpu_torch.ops.kernels.paged_attention import (
    Pool, SplitPlan, _check_int32, _pool_5d, _sm_count, paged_attention_plain,
    paged_pool_write_plain,
)

MLA_MAX_DIM = 576     # must match kMaxDim in csrc/paged_mla.cu
MLA_HEADS = 16        # query heads of one block
MLA_TILE = 64         # keys of one tile; a run holds at least one
MLA_MAX_SPLITS = 64   # runs per sequence the in-launch combine takes
SPLIT_KEYS = 512      # keys one run aims to hold

HOPPER_DIM = 576      # must match csrc/paged_mla_hopper.cu: D
HOPPER_V_COLS = 512   # VC
HOPPER_HEADS = 64     # HEADS: query heads of a CTA (the M of wgmma)
HOPPER_TILE = 32      # BK: keys of a tile
HOPPER_MAX_SPLITS = 8  # MAX_RUNS: a sequence's runs are one cluster
# bytes of one CTA's traffic in the plan's cost: its queries and a row of the pool
_Q_BYTES = HOPPER_HEADS * HOPPER_DIM * 2
_ROW_BYTES = {torch.bfloat16: HOPPER_DIM * 2, torch.int8: HOPPER_DIM + 4}
_POOLS = tuple(_ROW_BYTES)


@functools.lru_cache(maxsize=256)
def mla_split_plan(b: int, nq: int, D: int, ps: int, mp: int, sms: int) -> SplitPlan:
    """Runs of whole pages from the shapes and the SM count alone: about
    ``SPLIT_KEYS`` keys, halved (down to one tile) while the grid would hold
    fewer than two blocks per SM, at most ``MLA_MAX_SPLITS``."""
    groups = -(-nq // MLA_HEADS)
    least = max(1, -(-MLA_TILE // ps))
    pps = max(least, min(mp, max(1, SPLIT_KEYS // ps)))
    while pps > least and b * groups * -(-mp // pps) < 2 * sms:
        pps = max(least, (pps + 1) // 2)
    pps = max(pps, -(-mp // MLA_MAX_SPLITS))
    splits = -(-mp // pps)
    if splits == 1:
        return SplitPlan(pps, 1, 0, 0)
    return SplitPlan(pps, splits, b * groups * splits * MLA_HEADS * (D + 2), b * groups)


@functools.lru_cache(maxsize=256)
def mla_hopper_plan(b: int, nq: int, ps: int, mp: int, pool_dtype: torch.dtype,
                    clusters: tuple) -> SplitPlan:
    """The Hopper kernel's runs, from the shapes and the card alone. One CTA
    per (sequence, group of 64 heads, run), and a sequence's runs one cluster
    of at most ``HOPPER_MAX_SPLITS`` CTAs that combine through each other's
    shared memory; ``clusters[k - 1]`` is how many clusters of k CTAs the card
    holds at once (:func:`cluster_capacity`). A run is whole pages holding
    whole tiles. The run count with the least traffic through the busiest SM:
    waves of clusters times a CTA's queries (each run reads them again) and
    its run's rows. Ties go to fewer runs. No workspace: ``SplitPlan``'s last
    two fields are 0."""
    groups = nq // HOPPER_HEADS
    unit = max(1, HOPPER_TILE // ps)  # pages of one tile
    best = None
    for pps in range(-(-mp // unit) * unit, 0, -unit):  # fewer runs first
        splits = -(-mp // pps)
        if splits > HOPPER_MAX_SPLITS:
            break
        waves = -(-b * groups // clusters[splits - 1])
        cost = waves * (_Q_BYTES + pps * ps * _ROW_BYTES[pool_dtype])
        if best is None or cost < best[0]:
            best = (cost, pps, splits)
    return SplitPlan(best[1], best[2], 0, 0)


_CLUSTERS: Dict[tuple, tuple] = {}


def cluster_capacity(device: torch.device, pool_dtype: torch.dtype) -> tuple:
    """How many clusters of 1 .. ``HOPPER_MAX_SPLITS`` CTAs of the Hopper
    kernel the card holds at once, asked of the driver once per card."""
    key = (device.index, pool_dtype)
    got = _CLUSTERS.get(key)
    if got is None:
        with torch.cuda.device(device):
            got = _CLUSTERS[key] = tuple(build.paged_mla_hopper_clusters(pool_dtype, k)
                                         for k in range(1, HOPPER_MAX_SPLITS + 1))
    return got


def hopper_takes(nq: int, D: int, v_cols: int, ps: int, pool_dtype: torch.dtype) -> bool:
    """The dispatch rule of :func:`paged_mla_attention_write`: the Hopper kernel
    takes bf16 and int8 pools with D = 576, 512 output columns, a multiple of
    64 heads and pages of a power of two of at least 8 keys."""
    return (pool_dtype in _POOLS and D == HOPPER_DIM and v_cols == HOPPER_V_COLS
            and nq % HOPPER_HEADS == 0 and ps >= 8 and ps & (ps - 1) == 0)


def paged_mla_attention_plain(q: torch.Tensor, pool: Pool, page_table: torch.Tensor,
                              seq_lens: torch.Tensor,
                              layer_idx: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version: the generic plain paged attention with the pool
    as both keys and values."""
    return paged_attention_plain(q, pool, pool, page_table, seq_lens, layer_idx=layer_idx)


def paged_mla_attention_write_plain(q: torch.Tensor, new_row: torch.Tensor, pool: Pool,
                                    page_table: torch.Tensor, positions: torch.Tensor,
                                    layer_idx: Optional[int] = None,
                                    v_cols: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version: the row write (in place), then the attention over
    ``positions + 1`` keys; the first ``v_cols`` columns (default all)."""
    paged_pool_write_plain(pool, new_row, page_table, positions, layer_idx)
    out = paged_mla_attention_plain(q, pool, page_table, positions + 1, layer_idx)
    return out[..., :q.shape[-1] if v_cols is None else v_cols].contiguous()


def _check(q: torch.Tensor, pool: Pool, page_table: torch.Tensor, seq_lens: torch.Tensor,
           layer_idx: Optional[int], lens_name: str = "seq_lens"):
    if q.dim() != 3 or not q.is_contiguous():
        raise ValueError(f"q must be a contiguous [b, nq, D] tensor, got {tuple(q.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"paged_mla_attention takes float32 or bfloat16 queries, got {q.dtype}")
    b, nq, D = q.shape
    codes, scales, layer = _pool_5d("pool", pool, layer_idx, q.device)
    if codes.shape[1] != 1 or codes.shape[-1] != D:
        raise ValueError(f"an MLA pool is [A, 1, P, ps, {D}], got {tuple(codes.shape)}")
    if scales is None and codes.dtype != q.dtype:
        raise TypeError(f"a float pool has q's dtype: pool {codes.dtype}, q {q.dtype}")
    if scales is not None and q.dtype != torch.bfloat16:
        raise TypeError(f"an int8 pool computes in bfloat16, got q {q.dtype}")
    if D % 8 or D > MLA_MAX_DIM:
        raise ValueError(f"paged_mla_attention takes rows of at most {MLA_MAX_DIM} elements, "
                         f"a multiple of 8; got {D}")
    if b > 65535:
        raise ValueError(f"paged_mla_attention takes at most 65535 sequences, got {b}")
    for name, t in (("q", q), ("pool", codes), ("scales", scales)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    if page_table.dim() != 2:
        raise ValueError(f"page_table must be [b, mp], got {tuple(page_table.shape)}")
    _check_int32("page_table", page_table, (b, page_table.shape[1]), q.device)
    _check_int32(lens_name, seq_lens, (b,), q.device)
    if page_table.shape[1] * codes.shape[3] > 2 ** 31 - 1:
        raise ValueError("a table of more than 2^31 - 1 keys")
    return codes, scales, layer


def paged_mla_attention(q: torch.Tensor, pool: Pool, page_table: torch.Tensor,
                        seq_lens: torch.Tensor, layer_idx: Optional[int] = None) -> torch.Tensor:
    """q [b, nq, D] -> [b, nq, D] in q's dtype over the rows ``pos <
    seq_lens[i]`` of a 4D MLA pool ``[1, P, ps, D]``, or of layer ``layer_idx``
    (a host integer) of a 5D one; ``page_table`` [b, mp] and ``seq_lens`` [b]
    int32."""
    if not dispatch.use_kernel(q):
        return paged_mla_attention_plain(q, pool, page_table, seq_lens, layer_idx)
    codes, scales, layer = _check(q, pool, page_table, seq_lens, layer_idx)
    b, nq, D = q.shape
    _, _, num_pages, ps, _ = codes.shape
    mp = page_table.shape[1]
    plan = mla_split_plan(b, nq, D, ps, mp, _sm_count(q.device))
    workspace = tickets = None
    if plan.splits > 1:
        workspace = build.workspace(q.device.index, plan.workspace_floats)
        tickets = build.tickets(q.device, plan.tickets)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        build.paged_mla_attention(q, codes, scales, page_table, seq_lens, None, out, layer=layer,
                                  scale=1.0 / math.sqrt(D), pages_per_split=plan.pages_per_split,
                                  splits=plan.splits, workspace=workspace, tickets=tickets)
    launch_counts["paged_mla_attention_q8" if scales is not None else "paged_mla_attention"] += 1
    return out


class _MlaLaunch(NamedTuple):
    """What one signature of ``paged_mla_attention_write`` decides once: the
    kernel (Hopper or mma.sync), the plan, the output shape, the pools' layer
    count and the launch counter."""
    hopper: bool
    plan: SplitPlan
    scale: float
    out_shape: tuple
    layers: int
    counter: str
    device: torch.device


_MLA_LAUNCHES: Dict[tuple, _MlaLaunch] = {}


def _mla_launch(key: tuple, q, new_row, pool, page_table, positions, layer_idx,
                v_cols) -> _MlaLaunch:
    """Every check of the write and of the attention over ``positions + 1``
    keys, on the tensors themselves (raises on a fault); then the signature's
    launch, kept for the next calls."""
    codes, scales, _ = _check(q, pool, page_table, positions, layer_idx, "positions")
    b, nq, D = q.shape
    if tuple(new_row.shape) != (b, 1, D) or new_row.dtype != q.dtype:
        raise ValueError(f"new_row must be [{b}, 1, {D}] in q's dtype {q.dtype}, got "
                         f"{tuple(new_row.shape)} {new_row.dtype}")
    if new_row.device != q.device or not new_row.is_contiguous() or new_row.data_ptr() % 16:
        raise ValueError("new_row must be a contiguous tensor on q's device, on a 16-byte "
                         "boundary")
    v_cols = D if v_cols is None else v_cols
    if type(v_cols) is not int or not 8 <= v_cols <= D or v_cols % 8:
        raise ValueError(f"v_cols must be a multiple of 8 in [8, {D}], got {v_cols!r}")
    layers, _, num_pages, ps, _ = codes.shape
    mp = page_table.shape[1]
    q8 = "_q8" if scales is not None else ""
    hopper = (hopper_takes(nq, D, v_cols, ps, codes.dtype)
              and layers * num_pages * ps < 2 ** 31 - 1)
    if hopper:
        plan = mla_hopper_plan(b, nq, ps, mp, codes.dtype, cluster_capacity(q.device, codes.dtype))
        counter = "paged_mla_write_hopper" + q8
    else:
        plan = mla_split_plan(b, nq, D, ps, mp, _sm_count(q.device))
        counter = "paged_mla_attention_write" + q8
    launch = _MlaLaunch(hopper, plan, 1.0 / math.sqrt(D), (b, nq, v_cols), layers, counter,
                        q.device)
    if len(_MLA_LAUNCHES) >= 256:
        _MLA_LAUNCHES.clear()
    _MLA_LAUNCHES[key] = launch
    return launch


def paged_mla_attention_write(q: torch.Tensor, new_row: torch.Tensor, pool: Pool,
                              page_table: torch.Tensor, positions: torch.Tensor,
                              layer_idx: Optional[int] = None,
                              v_cols: Optional[int] = None) -> torch.Tensor:
    """The MLA decode layer: ``paged_pool_write(pool, new_row, page_table,
    positions, layer_idx)`` then ``paged_mla_attention(q, pool, page_table,
    positions + 1, layer_idx)[..., :v_cols]`` (default all D columns); writes the
    pool in place and returns [b, nq, v_cols] in q's dtype. One launch on the
    card, of the Hopper kernel where :func:`hopper_takes` the shape and dtype,
    else of the mma.sync kernel."""
    if not (q.is_cuda or dispatch.use_kernel(q)):
        return paged_mla_attention_write_plain(q, new_row, pool, page_table, positions,
                                               layer_idx, v_cols)
    q8 = isinstance(pool, dict)
    codes = pool["q"] if q8 else pool
    scales = pool["s"] if q8 else None
    dev = q.get_device()
    key = (q.shape, q.dtype, new_row.shape, new_row.dtype, codes.shape, codes.dtype,
           None if scales is None else (scales.shape, scales.dtype), page_table.shape,
           page_table.dtype, positions.shape, positions.dtype, layer_idx is None, v_cols, dev)
    launch = _MLA_LAUNCHES.get(key)
    layer = 0 if layer_idx is None else layer_idx
    tensors = (q, new_row, codes, page_table, positions) + (() if scales is None else (scales,))
    if (launch is None or type(layer) is not int or not 0 <= layer < launch.layers
            or not all(t.get_device() == dev and t.is_contiguous() for t in tensors)):
        launch = _mla_launch(key, q, new_row, pool, page_table, positions, layer_idx, v_cols)
        layer = 0 if layer_idx is None else int(layer_idx)
    if layer_idx is None:
        codes = codes[None]
        scales = None if scales is None else scales[None]
    plan = launch.plan
    workspace = tickets = None
    if plan.tickets:
        workspace = build.workspace(dev, plan.workspace_floats)
        tickets = build.tickets(launch.device, plan.tickets)
    out = torch.empty(launch.out_shape, dtype=q.dtype, device=launch.device)
    with (contextlib.nullcontext() if torch.cuda.current_device() == dev
          else torch.cuda.device(dev)):
        if launch.hopper:
            build.paged_mla_hopper_write(q, new_row, codes, scales, page_table, positions, out,
                                         layer=layer, scale=launch.scale,
                                         pages_per_split=plan.pages_per_split,
                                         splits=plan.splits, stream=build.raw_stream(dev))
        else:
            build.paged_mla_attention(q, codes, scales, page_table, positions, new_row, out,
                                      layer=layer, scale=launch.scale,
                                      pages_per_split=plan.pages_per_split, splits=plan.splits,
                                      workspace=workspace, tickets=tickets,
                                      stream=build.raw_stream(dev))
    launch_counts[launch.counter] += 1
    return out
