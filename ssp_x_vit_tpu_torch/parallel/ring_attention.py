"""Ring attention: sequence parallelism over a ``seq`` group (counterpart of
``ssp_x_vit_tpu/parallel/ring_attention.py``).

The sequence is cut into N chunks of ``sl`` rows, one per rank of the ``seq``
axis (rank order is sequence order). Each rank holds its query chunk; the
K/V chunks travel the ring (``collectives.ring_rotate_start``), and after r
steps rank p holds the chunk of rank ``src = (p - r) mod N``. The hop
arithmetic is apart from the transport:

- :func:`ring_hop` takes the local q and one K/V chunk with its source index
  and returns ``(out_r, lse_r)``, fp32 log-sum-exp per row, or None for a hop
  that adds nothing. Causal, for the chunk from ``src``: ``src == p`` is the
  diagonal (causal, offset 0); ``src < p`` sees every key at offset
  ``(p - src) * sl`` (non-causal), or under a window the band at that offset
  (causal with the flash kernel's ``q_offset``), and is skipped when the band
  misses every key (``(p - src) * sl - (sl - 1) >= window``); ``src > p`` is
  skipped (JAX's masked hop adds exactly 0 there: every row already holds
  its diagonal key). The llama family's hops launch the flash kernel (row 5)
  on a CUDA tensor; a ``scale`` or a value width other than the key width
  (MLA) take the plain hop, as JAX's ``jnp`` does.
- :func:`merge_hop` merges hops in fp32 from their ``lse``: a row with no key
  in a hop has ``lse = -inf`` and weight 0. The merged output is rounded to
  q's dtype once (a bf16 kernel hop's output is itself rounded once).

:func:`ring_attention` runs the world's ring (GQA K/V travel un-repeated,
``[b, hkv, sl, hd]``; the next hop's send / receive is posted before the
current hop's kernel); :func:`virtual_ring_attention` runs the same hops over
N chunks held in one process (one card, an off-diagonal hop included).

``make_seq_parallel_nll`` / ``evaluate_perplexity_seq_parallel`` run the
llama-layout and phi blocks (``llm/model.py``'s ``_llama_layer``, its
attention core replaced by the ring) with rope at each chunk's global
positions; a ``DeepseekConfig`` goes to ``parallel/deepseek_parallel.py``.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ssp_x_vit_tpu_torch.ops import dispatch
from ssp_x_vit_tpu_torch.ops.kernels import flash_attention as flash
from ssp_x_vit_tpu_torch.parallel.collectives import (
    all_reduce_sum, gather_along, ring_rotate_start, warm_group,
)
from ssp_x_vit_tpu_torch.parallel.mesh import axis_index, axis_size

Hop = Tuple[torch.Tensor, torch.Tensor]


def hop_mask(p: int, src: int, sl: int, *, causal: bool = True,
             window: Optional[int] = None) -> Optional[Tuple[int, bool, Optional[int]]]:
    """(q_offset, causal, window) of the hop of query chunk ``p`` over key
    chunk ``src``, or None when the hop adds nothing."""
    if not causal:
        if window is not None:
            raise ValueError("sliding window requires causal attention")
        return 0, False, None
    if src > p:
        return None
    off = (p - src) * sl
    if window is not None and off + sl - 1 < window:
        window = None                      # the band covers the whole chunk pair
    if off == 0:
        return 0, True, window
    if window is None:
        return 0, False, None              # every key precedes every query
    if off - (sl - 1) >= window:
        return None                        # the band misses every key
    return off, True, window


def _plain_hop(q, k, v, off: int, causal: bool, window, softcap, scale) -> Hop:
    """The hop in fp32 torch (GQA grouped, any scale and value width)."""
    b, hq, sl, hd = q.shape
    hkv = k.shape[1]
    rep = hq // hkv
    q32 = (q.float() * scale).reshape(b, hkv, rep, sl, hd)
    s_ = torch.einsum("bkrqd,bksd->bkrqs", q32, k.float())
    if softcap is not None:
        s_ = softcap * torch.tanh(s_ / softcap)
    if causal:
        qi = torch.arange(sl, device=q.device)[:, None] + off
        ki = torch.arange(k.shape[2], device=q.device)[None, :]
        keep = ki <= qi
        if window is not None:
            keep = keep & (qi - ki < window)
        s_ = s_.masked_fill(~keep, float("-inf"))
    lse = torch.logsumexp(s_, dim=-1)
    w = torch.exp(s_ - torch.where(torch.isfinite(lse), lse, 0.0)[..., None])
    out = torch.einsum("bkrqs,bksd->bkrqd", w, v.float())
    return out.reshape(b, hq, sl, v.shape[-1]), lse.reshape(b, hq, sl)


def ring_hop(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, p: int, src: int, *,
             causal: bool = True, window: Optional[int] = None,
             softcap: Optional[float] = None, scale: Optional[float] = None) -> Optional[Hop]:
    """Query chunk ``p`` [b, h, sl, hd] against the K/V chunk that came from
    ``src`` ([b, hkv, sl, hd] / [b, hkv, sl, vd]): (out_r, lse_r [b, h, sl]
    fp32), or None when the hop is skipped."""
    mask = hop_mask(p, src, q.shape[2], causal=causal, window=window)
    if mask is None:
        return None
    off, hop_causal, hop_window = mask
    hd = q.shape[-1]
    if scale is None and v.shape[-1] == hd and hd <= flash.MAX_HEAD_DIM:
        if dispatch.use_kernel(q):
            return flash.flash_attention_forward(q, k, v, causal=hop_causal, window=hop_window,
                                                 softcap=softcap, with_lse=True, q_offset=off)
        return flash.flash_attention_plain(q, k, v, causal=hop_causal, window=hop_window,
                                           softcap=softcap, q_offset=off, with_lse=True)
    return _plain_hop(q, k, v, off, hop_causal, hop_window, softcap,
                      1.0 / math.sqrt(hd) if scale is None else scale)


def merge_hop(acc: Optional[Hop], hop: Optional[Hop]) -> Optional[Hop]:
    """The running (out fp32, lse) after one more hop (None hops are skipped)."""
    if hop is None:
        return acc
    out, lse = hop[0].float(), hop[1]
    if acc is None:
        return out, lse
    a_out, a_lse = acc
    new = torch.logaddexp(a_lse, lse)
    base = torch.where(torch.isfinite(new), new, 0.0)
    wa = torch.exp(a_lse - base)[..., None]
    wb = torch.exp(lse - base)[..., None]
    return a_out * wa + out * wb, new


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group, *,
                   n_chunks: int, causal: bool = True, window: Optional[int] = None,
                   softcap: Optional[float] = None, scale: Optional[float] = None
                   ) -> torch.Tensor:
    """Exact attention over the ring of ``group`` (size ``n_chunks``): q / k
    the LOCAL chunks [b, h(kv), sl, hd], v [b, hkv, sl, vd]; returns the local
    output chunk [b, h, sl, vd] in q's dtype. ``window`` / ``softcap`` /
    ``scale`` as JAX's (HF window convention over global positions)."""
    n = 1 if group is None else dist.get_world_size(group)
    if n != n_chunks:
        raise ValueError(f"n_chunks {n_chunks} != seq group size {n}")
    p = 0 if group is None else dist.get_rank(group)
    if n > 1:
        warm_group(group, q.device)
    acc = None
    cur_k, cur_v = k.contiguous(), v.contiguous()
    for r in range(n):
        # the next chunk travels while this hop computes
        pending = ring_rotate_start((cur_k, cur_v), group) if r < n - 1 else None
        acc = merge_hop(acc, ring_hop(q, cur_k, cur_v, p, (p - r) % n, causal=causal,
                                      window=window, softcap=softcap, scale=scale))
        if pending is not None:
            cur_k, cur_v = pending.wait()
    return acc[0].to(q.dtype)   # the diagonal hop always runs


def virtual_ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                           n_chunks: int, causal: bool = True, window: Optional[int] = None,
                           softcap: Optional[float] = None, scale: Optional[float] = None
                           ) -> torch.Tensor:
    """The ring's hops over ``n_chunks`` chunks of the sequence held in one
    process: q [b, h, s, hd], k / v [b, hkv, s, hd | vd] -> [b, h, s, vd]."""
    s = q.shape[2]
    if s % n_chunks:
        raise ValueError(f"seq_len {s} % n_chunks {n_chunks} != 0")
    qs, ks, vs = (t.chunk(n_chunks, dim=2) for t in (q, k, v))
    outs: List[torch.Tensor] = []
    for p in range(n_chunks):
        acc = None
        for r in range(n_chunks):
            src = (p - r) % n_chunks
            acc = merge_hop(acc, ring_hop(qs[p].contiguous(), ks[src].contiguous(),
                                          vs[src].contiguous(), p, src, causal=causal,
                                          window=window, softcap=softcap, scale=scale))
        outs.append(acc[0].to(q.dtype))
    return torch.cat(outs, dim=2)


def _rope_at(q: torch.Tensor, k: torch.Tensor, cfg, positions: torch.Tensor):
    """HF half-rotation rope of q / k [b, h, sl, hd] at explicit global
    ``positions`` [sl] (``rotary_dim`` rotates the first dims only;
    ``rope_scaling`` through ``llm/rope.py``)."""
    from ssp_x_vit_tpu_torch.llm.model import _rope, rope_tables

    start = int(positions[0])
    if not torch.equal(positions.cpu(), torch.arange(start, start + positions.numel())):
        raise ValueError("positions must be consecutive")
    tables = rope_tables(positions.numel(), cfg, q.device, start=start)
    rd = tables[0].shape[-1]
    if rd == q.shape[-1]:
        return _rope(q, k, tables)
    q_rot, k_rot = _rope(q[..., :rd], k[..., :rd], tables)
    return torch.cat([q_rot, q[..., rd:]], dim=-1), torch.cat([k_rot, k[..., rd:]], dim=-1)


def _local_nll(logits: torch.Tensor, tokens: torch.Tensor, start: int, sl: int) -> torch.Tensor:
    """Per-row NLL sums of a chunk's predictions: positions start .. start + sl
    - 1 predict the next token; the window's last position predicts nothing."""
    s = tokens.shape[1]
    n = min(sl, s - 1 - start)
    logp = torch.log_softmax(logits[:, :n].float(), dim=-1)
    targets = tokens[:, start + 1:start + 1 + n]
    return -torch.gather(logp, -1, targets[..., None])[..., 0].sum(dim=1)


def make_seq_parallel_nll(mesh, cfg, compute_dtype=torch.float32):
    """``run(params, tokens [b, s]) -> per-window NLL sums [b]`` with the
    sequence over the mesh's ``seq`` axis and the rows over ``data`` (each
    data rank takes its rows; the sums come back gathered on every rank).
    ``params`` are whole on every rank. Llama layout (llama / mistral / qwen2
    / qwen3 / gemma / gemma-2 with mixed windows, post-norms, softcaps) and
    phi's parallel residual; OPT is refused, as in JAX."""
    from ssp_x_vit_tpu_torch.llm.model import (
        _embed_tokens, _final_norm, _head_logits, _llama_layer, rope_tables,
    )

    sp, pidx = axis_size(mesh, "seq"), axis_index(mesh, "seq")
    dp, di = axis_size(mesh, "data"), axis_index(mesh, "data")
    sg, dg = mesh.get_group("seq"), mesh.get_group("data")
    if cfg.is_opt:
        raise ValueError("seq-parallel path covers llama-layout (incl. "
                         "gemma/gemma-2) and phi configs (OPT's learned-"
                         "position table is bounded at 2048 — no "
                         "long-context use case)")

    def core(q, k, v, window):
        return ring_attention(q, k, v, sg, n_chunks=sp, causal=True, window=window,
                              softcap=cfg.attn_softcap)

    def local(params, tokens: torch.Tensor) -> torch.Tensor:
        b, s = tokens.shape
        sl = s // sp
        start = pidx * sl
        x = _embed_tokens(params, tokens[:, start:start + sl], cfg, compute_dtype)
        rope = rope_tables(sl, cfg, x.device, start=start)
        blocks = params["blocks"]
        for i in range(cfg.num_layers):
            bp = {k: v[i] for k, v in blocks.items()}
            x = _llama_layer(x, bp, i, cfg, compute_dtype, rope, None, None, None, False,
                             "sumsq", attn_core=core)[0]
        x = _final_norm(params, x, cfg)
        logits = _head_logits(params, x, compute_dtype, cfg.final_softcap)
        return all_reduce_sum(_local_nll(logits, tokens, start, sl), sg)

    @torch.no_grad()
    def run(params, tokens) -> torch.Tensor:
        tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.int64)
        b, s = tokens.shape
        if s % sp:
            raise ValueError(f"seq_len {s} % seq axis {sp} != 0")
        if b % dp:
            raise ValueError(f"{b} windows do not split over data={dp}")
        n = b // dp
        mine = tokens[di * n:(di + 1) * n].to(params["embed"].device)
        return gather_along(local(params, mine), 0, dg)

    run.local = local
    return run


@torch.no_grad()
def evaluate_perplexity_seq_parallel(params, cfg, mesh, input_ids, *, seq_len: int = 2048,
                                     compute_dtype=torch.float32) -> float:
    """Sequence-parallel streaming perplexity: windows over ``data`` (round k
    gives window k * dp + j to data rank j), each window's context over
    ``seq``; the NLL sums and token counts are all-reduced over ``data`` at the
    end. A ``DeepseekConfig`` runs the MLA latent ring
    (``deepseek_parallel.make_deepseek_seq_parallel_nll``, fp32)."""
    from ssp_x_vit_tpu_torch.llm.deepseek import is_deepseek

    ids = np.asarray(input_ids).reshape(-1)
    num_windows = ids.size // seq_len
    if num_windows == 0:
        raise ValueError(
            f"input has {ids.size} tokens < seq_len {seq_len}: no full "
            "window to evaluate (a silent ppl=1.0 would corrupt comparisons)")
    if is_deepseek(cfg):
        from ssp_x_vit_tpu_torch.parallel.deepseek_parallel import \
            make_deepseek_seq_parallel_nll

        run = make_deepseek_seq_parallel_nll(mesh, cfg)
    else:
        run = make_seq_parallel_nll(mesh, cfg, compute_dtype)
    dp, j = axis_size(mesh, "data"), axis_index(mesh, "data")
    device = params["embed"].device
    windows = ids[: num_windows * seq_len].reshape(num_windows, seq_len)
    total = torch.zeros((), dtype=torch.float64, device=device)
    count = 0
    for w in range(j, num_windows, dp):
        tokens = torch.from_numpy(windows[w:w + 1].astype(np.int64)).to(device)
        total += run.local(params, tokens).double().sum()
        count += seq_len - 1
    sums = torch.stack([total, torch.tensor(float(count), dtype=torch.float64, device=device)])
    total, count = all_reduce_sum(sums, mesh.get_group("data")).tolist()
    return float(np.exp(total / max(1.0, count)))
