"""Paged decode attention and the paged pool write (replace
``ssp_x_vit_tpu/ops/pallas/paged_attention.py``: ``paged_attention_pallas``
with ``_paged_pallas_grouped`` / ``_paged_pallas_perhead`` /
``_paged_pallas_grouped_q8``, and ``paged_pool_write`` with
``_pool_write_pallas_array`` / ``_pool_write_pallas_q8``).

K/V live in a physical page pool ``[nkv, P, ps, hd]`` per layer, stacked as
``[A, nkv, P, ps, hd]`` and addressed with ``layer_idx``; a sequence owns the
pages its row of ``page_table [b, mp]`` names (unused entries are 0, the trash
page). A pool is a float tensor (fp32 or bf16) or an int8 pool
``{"q": int8 [.., hd], "s": fp32 [..]}`` with one scale per token and KV head.

    paged_attention    one query token per sequence against its keys
                       ``start_lens[i] <= pos < seq_lens[i]``: fp32 scores of
                       ``q / sqrt(hd)`` (times the key scale for int8 pools),
                       optional softcap, softmax, times V.
    paged_cache_write  one new K and V row per sequence at slot
                       ``positions[i]`` of its pages, in place; int8 pools
                       quantize per token and head (``quantize_token_kv``).
    paged_attention_write  the decode step's layer: ``paged_cache_write`` at
                       ``positions``, then ``paged_attention`` over
                       ``positions + 1`` keys, in one launch on the card.

On the card the wrappers launch ``csrc/paged_attention.cu`` (launch counters
``paged_attention``, ``paged_attention_q8``, ``paged_pool_write``,
``paged_pool_write_q8``, ``paged_attention_write``,
``paged_attention_write_q8``). What bounds the attention: each live K and V row is
read once for ``4 * rep * hd`` operations, so bytes; the kernel splits each
sequence's keys into runs of whole pages (:func:`split_plan`, from the shapes
alone), streams the live pages of a run into shared memory with bulk copies
and combines the runs' softmax states in run order inside the same launch; it
reads no page outside ``[start, seq_len)``. The write
moves ``b * nkv * hd`` elements per pool, far below a launch's latency, so the
decode step writes inside its attention launch (``paged_attention_write``,
whose wrapper decides its shape and dtype checks once per signature); the
write alone puts K and V in one launch. ``layer_idx`` is a host integer (the layer loop is a
Python loop); tables, lengths and positions are int32 tensors on the card that
the kernels read through pointers, so a decode step never syncs with the host.

On CPU tensors the wrappers run the plain versions below; a CUDA tensor always
launches the kernel or raises. A row with no key in range (never produced by
the server, which attends ``seq_lens + 1 >= 1`` keys) is 0 from the kernel and
a uniform average from the plain version. The multi-token prefill writes
(``paged_cache_write_many``) are indexed assignments outside any kernel, as
they are ``.at[].set`` in the JAX package.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch

from ssp_x_vit_tpu_torch.ops import dispatch
from ssp_x_vit_tpu_torch.ops.kernels import build, launch_counts

Pool = Union[torch.Tensor, Dict[str, torch.Tensor]]

MAX_HEAD_DIM = 256  # the widest row a warp's lanes cover
MAX_GROUP = 8       # query heads per KV head held in one block's registers
SPLIT_KEYS = 512    # keys one split of the attention aims to hold
MAX_PAGES_PER_SPLIT = 256  # must match pa::kMaxPagesPerSplit in csrc/paged_attention.cu
_NEG_INF = torch.finfo(torch.float32).min
_SM_COUNTS: Dict[int, int] = {}


class SplitPlan(NamedTuple):
    """How the attention kernel splits each sequence's keys: ``splits`` runs
    of ``pages_per_split`` whole pages of the table (the last may be shorter),
    one block per (KV head, sequence, run); more than one run takes
    ``workspace_floats`` fp32 of partial softmax states and ``tickets`` int32
    counters (one per sequence and KV head)."""
    pages_per_split: int
    splits: int
    workspace_floats: int
    tickets: int


@functools.lru_cache(maxsize=256)
def split_plan(b: int, nkv: int, nq: int, hd: int, ps: int, mp: int, sms: int) -> SplitPlan:
    """The split of one call, from its shapes and the card's SM count alone (the
    lengths are device tensors, and a decode step never waits for the host).
    Runs of about ``SPLIT_KEYS`` keys, halved while the grid would hold fewer
    than four blocks per SM (two waves at the two or three blocks an SM
    holds), so a batch of long sequences and a single one both fill the card."""
    pps = max(1, min(mp, MAX_PAGES_PER_SPLIT, SPLIT_KEYS // ps))
    while pps > 1 and b * nkv * -(-mp // pps) < 4 * sms:
        pps = (pps + 1) // 2
    splits = -(-mp // pps)
    if splits == 1:
        return SplitPlan(pps, 1, 0, 0)
    return SplitPlan(pps, splits, b * nkv * splits * (nq // nkv) * (hd + 2), b * nkv)


def _sm_count(device: torch.device) -> int:
    n = _SM_COUNTS.get(device.index)
    if n is None:
        n = _SM_COUNTS[device.index] = torch.cuda.get_device_properties(device).multi_processor_count
    return n


def is_q8(pages: Pool) -> bool:
    return isinstance(pages, dict)


def _codes(pages: Pool) -> torch.Tensor:
    return pages["q"] if isinstance(pages, dict) else pages


def page_size_of(pages: Pool, layer_idx: Optional[int] = None) -> int:
    """Page size of a 4D pool, or of a 5D pool when ``layer_idx`` is given."""
    return _codes(pages).shape[3 if layer_idx is not None else 2]


def layer_of(pages: Pool, layer_idx: Optional[int]) -> Pool:
    """The 4D pool of one layer: a view, never a copy."""
    if layer_idx is None:
        return pages
    if isinstance(pages, dict):
        return {k: v[layer_idx] for k, v in pages.items()}
    return pages[layer_idx]


def quantize_token_kv(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[.., hd] -> (int8 codes, fp32 scale over the last axis): scale =
    amax / 127 (1 where amax == 0), codes = clip(round-half-to-even(t / scale), +-127)."""
    t32 = t.float()
    a = t32.abs().amax(dim=-1)
    # a tensor divisor: dividing a CUDA tensor by a Python number multiplies by its
    # rounded reciprocal, which is not the quotient the kernel and the CPU compute
    sc = torch.where(a > 0, a / torch.full_like(a, 127.0), torch.ones_like(a))
    codes = torch.clamp(torch.round(t32 / sc[..., None]), -127, 127).to(torch.int8)
    return codes, sc


def _dequant_pages(pages: Dict[str, torch.Tensor]) -> torch.Tensor:
    return pages["q"].float() * pages["s"][..., None]


def paged_attention_plain(q: torch.Tensor, k_pages: Pool, v_pages: Pool,
                          page_table: torch.Tensor, seq_lens: torch.Tensor,
                          start_lens: Optional[torch.Tensor] = None,
                          softcap: Optional[float] = None,
                          layer_idx: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version: gather every page of the table, exact softmax
    over the whole ``[mp * ps]`` axis in fp32 with the out-of-range keys at
    ``finfo(float32).min``. int8 pages are dequantized after the gather and
    rounded to q's dtype, as the JAX reference does."""
    k_pages, v_pages = layer_of(k_pages, layer_idx), layer_of(v_pages, layer_idx)
    b, nq, hd = q.shape
    nkv, _, ps, _ = _codes(k_pages).shape
    mp = page_table.shape[1]
    rep = nq // nkv
    table = page_table.long()

    def gather(pages):
        if isinstance(pages, dict):
            out = _dequant_pages({"q": pages["q"][:, table], "s": pages["s"][:, table]}).to(q.dtype)
        else:
            out = pages[:, table]                                  # [nkv, b, mp, ps, hd]
        return out.movedim(0, 1).reshape(b, nkv, mp * ps, hd).float()

    k, v = gather(k_pages), gather(v_pages)
    qh = q.reshape(b, nkv, rep, hd).float() * (1.0 / hd ** 0.5)
    scores = torch.einsum("bkrd,bksd->bkrs", qh, k)
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    pos = torch.arange(mp * ps, device=q.device)
    mask = pos[None, None, None, :] < seq_lens[:, None, None, None]
    if start_lens is not None:
        mask = mask & (pos[None, None, None, :] >= start_lens[:, None, None, None])
    scores = torch.where(mask, scores, torch.full_like(scores, _NEG_INF))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkrs,bksd->bkrd", w, v)
    return out.reshape(b, nq, hd).to(q.dtype)


def _check_int32(name: str, t: torch.Tensor, shape, device) -> None:
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _pool_5d(name: str, pages: Pool, layer_idx: Optional[int], device
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor], int]:
    """(codes or values as [A, nkv, P, ps, hd], scales [A, nkv, P, ps] or None,
    layer) of a checked pool; a 4D pool is an A = 1 view."""
    codes = _codes(pages)
    scales = pages["s"] if isinstance(pages, dict) else None
    want = 4 if layer_idx is None else 5
    if codes.dim() != want:
        raise ValueError(f"{name} must be a {want}D pool "
                         f"({'with' if want == 5 else 'without'} layer_idx), got {codes.dim()}D")
    if scales is not None:
        if codes.dtype != torch.int8 or scales.dtype != torch.float32:
            raise TypeError(f"{name}: an int8 pool holds int8 codes and float32 scales, got "
                            f"{codes.dtype} and {scales.dtype}")
        if tuple(scales.shape) != tuple(codes.shape[:-1]):
            raise ValueError(f"{name}: scales {tuple(scales.shape)} do not match codes "
                             f"{tuple(codes.shape)}")
    elif codes.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: float pools are float32 or bfloat16, got {codes.dtype}")
    for t in (codes, scales):
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if layer_idx is None:
        return codes[None], None if scales is None else scales[None], 0
    if isinstance(layer_idx, torch.Tensor) or not 0 <= int(layer_idx) < codes.shape[0]:
        raise ValueError(f"layer_idx must be a host integer in [0, {codes.shape[0]}), "
                         f"got {layer_idx!r}")
    return codes, scales, int(layer_idx)


def _check_attention(q: torch.Tensor, k_pages: Pool, v_pages: Pool, page_table: torch.Tensor,
                     lens: torch.Tensor, lens_name: str, start_lens: Optional[torch.Tensor],
                     layer_idx: Optional[int]):
    """paged_attention's checks of its operands (``lens`` under ``lens_name``);
    returns the 5D pools, their scales (None for float pools) and the layer."""
    if q.dim() != 3 or not q.is_contiguous():
        raise ValueError(f"q must be a contiguous [b, nq, hd] tensor, got {tuple(q.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"paged_attention takes float32 or bfloat16 queries, got {q.dtype}")
    if is_q8(k_pages) != is_q8(v_pages):
        raise TypeError("k_pages and v_pages must both be float pools or both int8 pools")
    b, nq, hd = q.shape
    k_pool, k_scale, layer = _pool_5d("k_pages", k_pages, layer_idx, q.device)
    v_pool, v_scale, _ = _pool_5d("v_pages", v_pages, layer_idx, q.device)
    if k_pool.shape != v_pool.shape or k_pool.dtype != v_pool.dtype:
        raise ValueError(f"k_pages {tuple(k_pool.shape)} {k_pool.dtype} and v_pages "
                         f"{tuple(v_pool.shape)} {v_pool.dtype} differ")
    nkv = k_pool.shape[1]
    if k_pool.shape[-1] != hd:
        raise ValueError(f"pool head_dim {k_pool.shape[-1]} != q head_dim {hd}")
    if k_scale is None and k_pool.dtype != q.dtype:
        raise TypeError(f"a float pool has q's dtype: pool {k_pool.dtype}, q {q.dtype}")
    if k_scale is not None and q.dtype != torch.bfloat16:
        raise TypeError(f"an int8 pool computes in bfloat16 (cache_compute_dtype), got q {q.dtype}")
    if nq % nkv or nq // nkv > MAX_GROUP:
        raise ValueError(f"nq={nq} must be a multiple of nkv={nkv} with at most {MAX_GROUP} "
                         "query heads per KV head")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"paged_attention takes head_dim <= {MAX_HEAD_DIM}, got {hd}")
    if b > 65535:
        raise ValueError(f"paged_attention takes at most 65535 sequences, got {b}")
    if page_table.dim() != 2:
        raise ValueError(f"page_table must be [b, mp], got {tuple(page_table.shape)}")
    _check_int32("page_table", page_table, (b, page_table.shape[1]), q.device)
    _check_int32(lens_name, lens, (b,), q.device)
    if start_lens is not None:
        _check_int32("start_lens", start_lens, (b,), q.device)
    return k_pool, v_pool, k_scale, v_scale, layer


def paged_attention(q: torch.Tensor, k_pages: Pool, v_pages: Pool, page_table: torch.Tensor,
                    seq_lens: torch.Tensor, start_lens: Optional[torch.Tensor] = None,
                    softcap: Optional[float] = None,
                    layer_idx: Optional[int] = None) -> torch.Tensor:
    """q [b, nq, hd] -> [b, nq, hd] in q's dtype. ``k_pages`` / ``v_pages``:
    4D pools, or 5D pools with the host integer ``layer_idx``; ``page_table``
    [b, mp], ``seq_lens`` and ``start_lens`` [b] int32 (``start_lens`` masks
    the keys below it: sliding-window decode)."""
    if not dispatch.use_kernel(q):
        return paged_attention_plain(q, k_pages, v_pages, page_table, seq_lens, start_lens,
                                     softcap, layer_idx)
    k_pool, v_pool, k_scale, v_scale, layer = _check_attention(
        q, k_pages, v_pages, page_table, seq_lens, "seq_lens", start_lens, layer_idx)
    b, nq, hd = q.shape
    plan = split_plan(b, k_pool.shape[1], nq, hd, k_pool.shape[3], page_table.shape[1],
                      _sm_count(q.device))
    out = torch.empty_like(q)
    workspace = tickets = None
    if plan.splits > 1:
        workspace = torch.empty(plan.workspace_floats, dtype=torch.float32, device=q.device)
        tickets = build.tickets(q.device, plan.tickets)
    with torch.cuda.device(q.device):
        build.paged_attention(q, k_pool, v_pool, k_scale, v_scale, page_table, seq_lens,
                              start_lens, out, layer=layer, scale=1.0 / math.sqrt(hd),
                              softcap=0.0 if softcap is None else float(softcap),
                              pages_per_split=plan.pages_per_split, splits=plan.splits,
                              workspace=workspace, tickets=tickets)
    launch_counts["paged_attention_q8" if k_scale is not None else "paged_attention"] += 1
    return out


def _slot_of(pages: Pool, page_table: torch.Tensor, positions: torch.Tensor,
             layer_idx: Optional[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(physical page, offset in the page) of logical slot ``positions[i]`` of
    sequence i; a slot outside the table (< 0 or >= mp * ps) is row 0 of trash
    page 0, as the kernels write it."""
    ps = page_size_of(pages, layer_idx)
    pos = positions.long()
    inside = (pos >= 0) & (pos < page_table.shape[1] * ps)
    pos = torch.where(inside, pos, torch.zeros_like(pos))
    rows = torch.arange(pos.shape[0], device=pos.device)
    phys = page_table.long()[rows, pos // ps]
    return torch.where(inside, phys, torch.zeros_like(phys)), pos % ps


def _assign(pages: Pool, new: torch.Tensor, phys: torch.Tensor, off: torch.Tensor) -> None:
    """In place: pages[:, phys[i], off[i]] = new[i] for a 4D pool (a view of
    the caller's pool) and new [n, nkv, hd]; int8 pools quantize first."""
    if isinstance(pages, dict):
        codes, sc = quantize_token_kv(new)
        pages["q"][:, phys, off] = codes.movedim(0, 1)
        pages["s"][:, phys, off] = sc.movedim(0, 1)
    else:
        pages[:, phys, off] = new.movedim(0, 1).to(pages.dtype)


def paged_pool_write_plain(pages: Pool, new: torch.Tensor, page_table: torch.Tensor,
                           positions: torch.Tensor, layer_idx: Optional[int] = None) -> Pool:
    """Plain PyTorch version of the single-token write: an indexed assignment
    into the caller's pool (in place; returns the same pool). Sequences own
    disjoint pages; inactive slots all hit trash page 0, where the last write wins."""
    phys, off = _slot_of(pages, page_table, positions, layer_idx)
    _assign(layer_of(pages, layer_idx), new, phys, off)
    return pages


def _check_write(k_pages: Pool, v_pages: Optional[Pool], k_new: torch.Tensor,
                 v_new: Optional[torch.Tensor], page_table: torch.Tensor,
                 positions: torch.Tensor, layer_idx: Optional[int]):
    """The pool write's checks of its operands; returns the 5D pools, their
    scales (None for float pools, or for a missing V pool) and the layer."""
    if k_new.dim() != 3 or k_new.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"new rows must be float32 or bfloat16 [b, nkv, hd], got {k_new.dtype} "
                        f"{tuple(k_new.shape)}")
    b, nkv, hd = k_new.shape
    device = k_new.device
    k_pool, k_scale, layer = _pool_5d("k_pages", k_pages, layer_idx, device)
    v_pool = v_scale = None
    if v_pages is not None:
        if is_q8(k_pages) != is_q8(v_pages):
            raise TypeError("k_pages and v_pages must both be float pools or both int8 pools")
        v_pool, v_scale, _ = _pool_5d("v_pages", v_pages, layer_idx, device)
        if v_pool.shape != k_pool.shape or v_pool.dtype != k_pool.dtype:
            raise ValueError("k_pages and v_pages differ in shape or dtype")
    if tuple(k_pool.shape[1::3]) != (nkv, hd):
        raise ValueError(f"new rows [b, {nkv}, {hd}] do not fit a pool {tuple(k_pool.shape)}")
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        if t is None:
            continue
        if t.shape != k_new.shape or t.dtype != k_new.dtype or t.device != device:
            raise ValueError(f"{name} must match k_new's shape, dtype and device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if b > 65535:
        raise ValueError(f"the pool write takes at most 65535 sequences, got {b}")
    if page_table.dim() != 2:
        raise ValueError(f"page_table must be [b, mp], got {tuple(page_table.shape)}")
    _check_int32("page_table", page_table, (b, page_table.shape[1]), device)
    _check_int32("positions", positions, (b,), device)
    return k_pool, v_pool, k_scale, v_scale, layer


def _write(k_pages: Pool, v_pages: Optional[Pool], k_new: torch.Tensor,
           v_new: Optional[torch.Tensor], page_table: torch.Tensor, positions: torch.Tensor,
           layer_idx: Optional[int]) -> None:
    k_pool, v_pool, k_scale, v_scale, layer = _check_write(k_pages, v_pages, k_new, v_new,
                                                           page_table, positions, layer_idx)
    with torch.cuda.device(k_new.device):
        build.paged_pool_write(k_new, v_new, k_pool, v_pool, k_scale, v_scale, page_table,
                               positions, layer=layer)
    launch_counts["paged_pool_write_q8" if k_scale is not None else "paged_pool_write"] += 1


def paged_pool_write(pages: Pool, new: torch.Tensor, page_table: torch.Tensor,
                     positions: torch.Tensor, layer_idx: Optional[int] = None) -> Pool:
    """Write one row per sequence into a single pool, in place: new [b, nkv, hd]
    at logical slot ``positions[i]`` (== the current length). Returns the pool."""
    if not dispatch.use_kernel(new):
        return paged_pool_write_plain(pages, new, page_table, positions, layer_idx)
    _write(pages, None, new, None, page_table, positions, layer_idx)
    return pages


def paged_cache_write(k_pages: Pool, v_pages: Pool, k_new: torch.Tensor, v_new: torch.Tensor,
                      page_table: torch.Tensor, positions: torch.Tensor,
                      layer_idx: Optional[int] = None) -> Tuple[Pool, Pool]:
    """Write one token's K and V per sequence into its page, in place (one
    launch on the card). k_new / v_new [b, nkv, hd]; ``positions`` [b] int32.
    Returns the two pools it was given."""
    if not dispatch.use_kernel(k_new):
        paged_pool_write_plain(k_pages, k_new, page_table, positions, layer_idx)
        paged_pool_write_plain(v_pages, v_new, page_table, positions, layer_idx)
        return k_pages, v_pages
    _write(k_pages, v_pages, k_new, v_new, page_table, positions, layer_idx)
    return k_pages, v_pages


class _WriteLaunch(NamedTuple):
    """What one signature (shapes, dtypes, card, 4D or 5D pools, softcap) of
    ``paged_attention_write`` decides once: the launch's dimensions, the pools'
    layer count, the split plan's workspace and tickets, and the launch counter."""
    dims: tuple
    layers: int
    workspace_floats: int
    tickets: int
    counter: str
    device: torch.device


_WRITE_LAUNCHES: Dict[tuple, _WriteLaunch] = {}


def _write_launch(key: tuple, q, k_new, v_new, k_pages, v_pages, page_table, positions,
                  start_lens, softcap, layer_idx) -> Tuple[_WriteLaunch, int]:
    """Every check of ``paged_cache_write`` and of ``paged_attention`` over
    ``positions + 1`` keys, on the tensors themselves (raises on a fault); then
    the signature's launch, kept for the next calls, and the layer."""
    k_pool, _, k_scale, _, layer = _check_attention(
        q, k_pages, v_pages, page_table, positions, "positions", start_lens, layer_idx)
    _check_write(k_pages, v_pages, k_new, v_new, page_table, positions, layer_idx)
    if k_new.device != q.device:
        raise ValueError(f"k_new is on {k_new.device}, expected {q.device}")
    b, nq, hd = q.shape
    _, nkv, num_pages, ps, _ = k_pool.shape
    mp = page_table.shape[1]
    if mp * ps > 2 ** 31 - 1:
        raise ValueError(f"a table of {mp} pages of {ps} keys exceeds 2^31 - 1 keys")
    plan = split_plan(b, nkv, nq, hd, ps, mp, _sm_count(q.device))
    dims = (build.DTYPE_CODES[q.dtype], build.POOL_CODES[k_pool.dtype],
            build.DTYPE_CODES[k_new.dtype], b, nq, nkv, hd, ps, mp, num_pages,
            1.0 / math.sqrt(hd), 0.0 if softcap is None else float(softcap),
            plan.pages_per_split, plan.splits)
    launch = _WriteLaunch(dims, k_pool.shape[0], plan.workspace_floats, plan.tickets,
                          "paged_attention_write_q8" if k_scale is not None
                          else "paged_attention_write", q.device)
    if len(_WRITE_LAUNCHES) >= 256:
        _WRITE_LAUNCHES.clear()
    _WRITE_LAUNCHES[key] = launch
    return launch, layer


def paged_attention_write_plain(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                                k_pages: Pool, v_pages: Pool, page_table: torch.Tensor,
                                positions: torch.Tensor, start_lens: Optional[torch.Tensor] = None,
                                softcap: Optional[float] = None,
                                layer_idx: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version: the two pool writes, then the attention over
    ``positions + 1`` keys."""
    paged_pool_write_plain(k_pages, k_new, page_table, positions, layer_idx)
    paged_pool_write_plain(v_pages, v_new, page_table, positions, layer_idx)
    return paged_attention_plain(q, k_pages, v_pages, page_table, positions + 1, start_lens,
                                 softcap, layer_idx)


def paged_attention_write(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                          k_pages: Pool, v_pages: Pool, page_table: torch.Tensor,
                          positions: torch.Tensor, start_lens: Optional[torch.Tensor] = None,
                          softcap: Optional[float] = None,
                          layer_idx: Optional[int] = None) -> torch.Tensor:
    """The decode step's layer: ``paged_cache_write(k_pages, v_pages, k_new, v_new,
    page_table, positions, layer_idx)`` then ``paged_attention(q, k_pages, v_pages,
    page_table, positions + 1, start_lens, softcap, layer_idx)``; writes the
    pools in place and returns the attention [b, nq, hd]. On the card one launch
    (counter ``paged_attention_write`` / ``_q8``). A new signature goes through
    every check of the two wrappers; a known one checks again only what can
    change between calls of one signature: the card, contiguity and the host
    integer ``layer_idx``."""
    if not (q.is_cuda or dispatch.use_kernel(q)):
        return paged_attention_write_plain(q, k_new, v_new, k_pages, v_pages, page_table,
                                           positions, start_lens, softcap, layer_idx)
    k_q8, v_q8 = isinstance(k_pages, dict), isinstance(v_pages, dict)
    kq = k_pages["q"] if k_q8 else k_pages
    vq = v_pages["q"] if v_q8 else v_pages
    scales = (k_pages["s"], v_pages["s"]) if k_q8 and v_q8 else ()
    dev = q.get_device()
    key = (q.shape, q.dtype, k_new.shape, k_new.dtype, v_new.shape, v_new.dtype, kq.shape,
           kq.dtype, vq.shape, vq.dtype, tuple((t.shape, t.dtype) for t in scales),
           page_table.shape, page_table.dtype, positions.shape, positions.dtype,
           None if start_lens is None else (start_lens.shape, start_lens.dtype),
           layer_idx is None, k_q8, v_q8, softcap, dev)
    launch = _WRITE_LAUNCHES.get(key)
    layer = 0 if layer_idx is None else layer_idx
    tensors = (q, k_new, v_new, kq, vq, page_table, positions) + scales + \
        (() if start_lens is None else (start_lens,))
    if (launch is None or type(layer) is not int or not 0 <= layer < launch.layers
            or not all(t.get_device() == dev and t.is_contiguous() for t in tensors)):
        launch, layer = _write_launch(key, q, k_new, v_new, k_pages, v_pages, page_table,
                                      positions, start_lens, softcap, layer_idx)
    workspace = tickets = None
    if launch.tickets:
        workspace = build.workspace(dev, launch.workspace_floats)
        tickets = build.tickets(launch.device, launch.tickets)
    out = torch.empty_like(q)
    with (contextlib.nullcontext() if torch.cuda.current_device() == dev
          else torch.cuda.device(dev)):
        build.paged_attention_write(q, k_new, v_new, kq, vq, *(scales or (None, None)),
                                    page_table, positions, start_lens, out, launch.dims,
                                    layer=layer, workspace=workspace, tickets=tickets,
                                    stream=build.raw_stream(dev))
    launch_counts[launch.counter] += 1
    return out


def paged_pool_write_many(pages: Pool, new: torch.Tensor, page_table: torch.Tensor, start: int,
                          valid_len: Optional[int] = None,
                          layer_idx: Optional[int] = None) -> Pool:
    """Prefill-write s consecutive tokens of ONE sequence into a single pool,
    in place: new [s, nkv, hd], ``page_table`` [mp] that sequence's pages,
    ``start`` the first logical slot. Positions ``>= start + valid_len`` go to
    trash page 0 (a padded prefill). An indexed assignment, as in the JAX
    package; once per request, not on the decode step."""
    s = new.shape[0]
    ps = page_size_of(pages, layer_idx)
    pos = start + torch.arange(s, device=new.device)
    phys = page_table.long()[(pos // ps).clamp(max=page_table.shape[0] - 1)]
    if valid_len is not None:
        phys = torch.where(pos < start + valid_len, phys, torch.zeros_like(phys))
    _assign(layer_of(pages, layer_idx), new, phys, pos % ps)
    return pages


def paged_cache_write_many(k_pages: Pool, v_pages: Pool, k_new: torch.Tensor,
                           v_new: torch.Tensor, page_table: torch.Tensor, start: int,
                           valid_len: Optional[int] = None,
                           layer_idx: Optional[int] = None) -> Tuple[Pool, Pool]:
    """K and V of s consecutive prefill tokens of one sequence (see
    :func:`paged_pool_write_many`)."""
    return (paged_pool_write_many(k_pages, k_new, page_table, start, valid_len, layer_idx),
            paged_pool_write_many(v_pages, v_new, page_table, start, valid_len, layer_idx))
