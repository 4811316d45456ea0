"""Paged decode attention over one MLA latent pool (replaces
``ssp_x_vit_tpu/ops/pallas/paged_attention.py``'s ``paged_attention_pallas``
where ``llm/paged_mla.py`` calls it: ``paged_attention(q_cat, pool, pool,
page_tables, seq_lens + 1)``, one pool that is both K and V).

    paged_mla_attention  q [b, nq, D] against the rows ``pos < seq_lens[i]``
                         of layer ``layer_idx`` of the pool ``[A, 1, P, ps, D]``
                         (fp32, bf16, or int8 codes with one scale per row):
                         fp32 scores of ``q / sqrt(D)``, softmax, times the
                         same rows; ``[b, nq, D]`` in q's dtype.

The generic paged kernel (``ops/kernels/paged_attention.py``) holds at most 8
query heads per KV head and rows of at most 256 in its lanes' registers; MLA
asks for 16 to 128 heads over rows of 576 (DeepSeek-V3: 512 + 64), so this
shape has its own kernel, ``csrc/paged_mla.cu`` (launch counters
``paged_mla_attention`` / ``paged_mla_attention_q8``): 16 heads per block on
the tensor cores, each row staged once for the scores and the values, runs of
whole pages from :func:`mla_split_plan` combined in order inside the launch.
The new row of each step is written before the attention by row 9's
standalone ``paged_pool_write`` (one pool, ``nkv = 1``).

On CPU tensors the wrapper runs :func:`paged_mla_attention_plain`, the generic
plain version with the pool as both K and V; a CUDA tensor always launches the
kernel or raises (``ValueError`` for a shape the kernel does not take).
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from ssp_x_vit_tpu_torch.ops import dispatch
from ssp_x_vit_tpu_torch.ops.kernels import build, launch_counts
from ssp_x_vit_tpu_torch.ops.kernels.paged_attention import (
    Pool, SplitPlan, _check_int32, _pool_5d, _sm_count, paged_attention_plain,
)

MLA_MAX_DIM = 576     # must match kMaxDim in csrc/paged_mla.cu
MLA_HEADS = 16        # query heads of one block
MLA_TILE = 64         # keys of one tile; a run holds at least one
MLA_MAX_SPLITS = 64   # runs per sequence the in-launch combine takes
SPLIT_KEYS = 512      # keys one run aims to hold


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


def paged_mla_attention_plain(q: torch.Tensor, pool: Pool, page_table: torch.Tensor,
                              seq_lens: torch.Tensor,
                              layer_idx: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version: the generic plain paged attention with the pool
    as both keys and values."""
    return paged_attention_plain(q, pool, pool, page_table, seq_lens, layer_idx=layer_idx)


def _check(q: torch.Tensor, pool: Pool, page_table: torch.Tensor, seq_lens: torch.Tensor,
           layer_idx: Optional[int]):
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
    for name, t in (("q", q), ("pool", codes)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    if page_table.dim() != 2:
        raise ValueError(f"page_table must be [b, mp], got {tuple(page_table.shape)}")
    _check_int32("page_table", page_table, (b, page_table.shape[1]), q.device)
    _check_int32("seq_lens", seq_lens, (b,), q.device)
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
        build.paged_mla_attention(q, codes, scales, page_table, seq_lens, out, layer=layer,
                                  scale=1.0 / math.sqrt(D), pages_per_split=plan.pages_per_split,
                                  splits=plan.splits, workspace=workspace, tickets=tickets)
    launch_counts["paged_mla_attention_q8" if scales is not None else "paged_mla_attention"] += 1
    return out
