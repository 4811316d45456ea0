"""Paged serving for the MLA (DeepSeek-V3) family over compressed-latent pages
(counterpart of ``ssp_x_vit_tpu/llm/paged_mla.py``).

The MLA cache per token and layer is one head-independent vector, the
normalized latent ``c`` [kv_lora_rank] and the roped key ``k_rot``
[qk_rope_head_dim], so paging it takes one pool of ``cat(c, k_rot)`` rows per
layer:

    pool: [L, 1, num_pages, page_size, kv_lora_rank + qk_rope_head_dim]

Absorbed decode is one-KV-head attention over that pool: the query is
``cat(q_nope @ W_k^T, q_rot)`` and the pool is both keys and values
(``probs @ cat(c, kr)`` sliced to the first kv_lora_rank columns is the
context in compressed space); the query is pre-multiplied by
``sqrt(D) * mla_softmax_scale(cfg)`` since the attention scales by
``1 / sqrt(D)``. On the card each decode layer writes its new row and attends
in one ``paged_mla_attention_write`` launch (``ops/kernels/paged_mla.py``; the
Hopper kernel at DeepSeek-V2/V3 widths), which returns the kv_lora_rank
columns the layer reads; on the CPU it runs the plain write then the plain
attention. The
int8 pool is ``{"q": codes, "s": one fp32 scale per row}``.

As elsewhere in the port: the pools are written in place, the layer loop is a
Python loop with host-integer layer indices, prompts are not padded to a
bucket and the last chunk of a chunked prefill is not padded to the chunk
size. :class:`MLAPagedServer` subclasses :class:`~.paged.PagedServer` with its
three model hooks, so the engine and the HTTP front end serve MLA models.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ssp_x_vit_tpu_torch.llm.deepseek import (
    DeepseekConfig, Params, _absorbed_kv_b, _absorbed_out, _absorbed_q, _apply_rope,
    _deepseek_moe, _embed, _f32mm, _glu, _head_logits, _mla_compressed, _rms, _rope_tables,
    deepseek_forward, deepseek_layers, mla_softmax_scale,
)
from ssp_x_vit_tpu_torch.llm.paged import _NEG_INF, PagedServer, masked_decode_scan
from ssp_x_vit_tpu_torch.ops.kernels.paged_attention import (
    layer_of, paged_pool_write_many,
)
from ssp_x_vit_tpu_torch.ops.kernels.paged_mla import paged_mla_attention_write

__all__ = ["MLAPagedServer", "init_mla_pool", "mla_paged_prefill", "mla_prefill_chunk",
           "mla_paged_prefill_chunked", "mla_paged_decode_step", "mla_paged_generate"]


def init_mla_pool(cfg: DeepseekConfig, num_pages: int, page_size: int, dtype=torch.bfloat16,
                  device="cpu"):
    """``[L, 1, num_pages, page_size, kv_lora_rank + qk_rope_head_dim]`` on
    ``device`` (page 0 is the trash page). ``torch.int8`` makes ``{"q": codes,
    "s": fp32 scales [L, 1, num_pages, page_size]}``, one scale over each
    whole row."""
    shape = (cfg.num_layers, 1, num_pages, page_size, cfg.kv_lora_rank + cfg.qk_rope_head_dim)
    if dtype == torch.int8:
        return {"q": torch.zeros(shape, dtype=torch.int8, device=device),
                "s": torch.ones(shape[:-1], dtype=torch.float32, device=device)}
    return torch.zeros(shape, dtype=dtype, device=device)


def _pool_compute_dtype(pool):
    if isinstance(pool, dict):
        return torch.bfloat16
    return torch.float32 if pool.dtype == torch.float32 else torch.bfloat16


def _as_table(page_table, device) -> torch.Tensor:
    if isinstance(page_table, torch.Tensor):
        return page_table.to(device=device, dtype=torch.int32)
    return torch.as_tensor(np.asarray(page_table, np.int32), device=device)


@torch.no_grad()
def mla_paged_prefill(params: Params, tokens: torch.Tensor, pool, cfg: DeepseekConfig,
                      page_table: torch.Tensor, seq_len: int):
    """One prompt ([1, p], ``p >= seq_len``) -> (next-token logits [V], pool).
    The full forward emits every layer's (c, k_rot); positions past
    ``seq_len`` land on trash page 0."""
    dt = _pool_compute_dtype(pool)
    seq_len = int(seq_len)
    logits, (c, kr) = deepseek_forward(params, tokens, cfg, compute_dtype=dt,
                                       return_caches=True, logit_position=max(seq_len - 1, 0))
    cat = torch.cat([c, kr], dim=-1)[:, 0]                    # [L, s, D]
    for layer in range(cat.shape[0]):
        paged_pool_write_many(pool, cat[layer][:, None], page_table, 0, valid_len=seq_len,
                              layer_idx=layer)
    return logits[0, 0], pool


def _gather_latents(pool_l, page_table: torch.Tensor, dt) -> torch.Tensor:
    """One sequence's mapped pages -> [mp * ps, D] rows in ``dt`` (int8 pools
    dequantized after the gather)."""
    table = page_table.long()
    if isinstance(pool_l, dict):
        out = (pool_l["q"][:, table].float() * pool_l["s"][:, table][..., None]).to(dt)
    else:
        out = pool_l[:, table].to(dt)
    return out.reshape(-1, out.shape[-1])


def _mla_chunk_attention(h, bp, cfg: DeepseekConfig, dt, pool, page_table, seq_len: int,
                         chunk_start: int, cos, sin, layer_idx: int):
    """One layer of chunked MLA prefill: C tokens at global positions
    [chunk_start, chunk_start + C) attend over the whole latent page pool
    (this chunk's rows written first, as the decode path does). h [1, C, d]
    post-ln1; cos/sin [C, rd]. Returns attn_out [1, C, d]."""
    C = h.shape[1]
    c_new, kr_raw = _mla_compressed(h, bp, cfg, dt)           # [1, C, .]
    kr_new = _apply_rope(kr_raw, cos, sin, cfg.rope_interleave)
    vec = torch.cat([c_new, kr_new], dim=-1)[0][:, None]     # [C, 1, D]
    paged_pool_write_many(pool, vec, page_table, chunk_start,
                          valid_len=max(seq_len - chunk_start, 0), layer_idx=layer_idx)

    # the chunk's positions as the rows of the absorbed query: [C, nq, .]
    wkv = _absorbed_kv_b(bp, cfg, dt)
    q_c, q_rot = _absorbed_q(h[0], bp, cfg, dt, cos[:, None], sin[:, None], wkv)
    q_cat = torch.cat([q_c, q_rot], dim=-1).transpose(0, 1)  # [nq, C, D]

    lat = _gather_latents(layer_of(pool, layer_idx), page_table, dt)   # [K, D]
    scores = _f32mm(q_cat, lat.t()) * mla_softmax_scale(cfg)            # [nq, C, K]
    row = chunk_start + torch.arange(C, device=h.device)[:, None]
    col = torch.arange(lat.shape[0], device=h.device)[None, :]
    mask = (col <= row) & (col < seq_len)
    scores = torch.where(mask[None], scores, torch.full_like(scores, _NEG_INF))
    w = torch.softmax(scores, dim=-1)
    ctx = _f32mm(w.to(lat.dtype), lat).to(dt)                 # [nq, C, D]
    return _absorbed_out(ctx[..., :cfg.kv_lora_rank].transpose(0, 1), bp, cfg, dt, wkv)[None]


@torch.no_grad()
def mla_prefill_chunk(params: Params, tokens: torch.Tensor, pool, cfg: DeepseekConfig,
                      page_table: torch.Tensor, chunk_start: int, seq_len: int, layers=None):
    """One chunk ([1, C] tokens at global [chunk_start, chunk_start + C)) of a
    chunked MLA prefill. Returns (logits at min(seq_len, chunk_start + C) - 1
    [V], pool)."""
    dt = _pool_compute_dtype(pool)
    chunk_start, seq_len = int(chunk_start), int(seq_len)
    C = tokens.shape[1]
    x = _embed(params, tokens, dt)                             # [1, C, d]
    cos, sin = _rope_tables(cfg, chunk_start + torch.arange(C, device=tokens.device))
    for li, (moe, bp, mp) in enumerate(layers if layers is not None
                                       else deepseek_layers(params, cfg)):
        h = _rms(x, bp["ln1"], cfg.rms_eps)
        x = x + _mla_chunk_attention(h, bp, cfg, dt, pool, page_table, seq_len, chunk_start,
                                     cos, sin, li)
        h2 = _rms(x, mp["ln2"], cfg.rms_eps)
        x = x + (_deepseek_moe(h2, mp, cfg, dt) if moe else _glu(h2, mp, dt))
    x = _rms(x, params["ln_final"], cfg.rms_eps)
    last = min(max(min(seq_len, chunk_start + C) - 1 - chunk_start, 0), C - 1)
    return _head_logits(x[:, last], params, dt)[0], pool


def mla_paged_prefill_chunked(params: Params, prompt, pool, cfg: DeepseekConfig, page_table, *,
                              chunk_size: int = 64, start: int = 0, layers=None):
    """Prefill one prompt through chunks of at most ``chunk_size`` tokens.
    Returns (next-token logits [V], pool). ``start`` skips tokens whose
    latents the pages already hold (prefix caching; page-aligned)."""
    device = params["embed"].device
    prompt = np.asarray(prompt, np.int64).reshape(-1)
    n = len(prompt)
    table = _as_table(page_table, device)
    logits = None
    for c0 in range(start, n, chunk_size):
        chunk = torch.as_tensor(prompt[None, c0:c0 + chunk_size], device=device)
        logits, pool = mla_prefill_chunk(params, chunk, pool, cfg, table, c0, n, layers)
    return logits, pool


def _absorbed_paged_attention(h, bp, cfg: DeepseekConfig, dt, pool, page_tables, seq_lens,
                              cos, sin, layer_idx: int):
    """One decode position per slot against the latent pool. h [b, d]
    post-ln1; cos/sin [b, rd] at each slot's position ``seq_lens``. Writes
    the new rows at ``seq_lens`` and attends ``seq_lens + 1`` keys in one
    ``paged_mla_attention_write`` call. Returns attn_out [b, d]."""
    c_new, kr_raw = _mla_compressed(h[:, None], bp, cfg, dt)  # [b, 1, .]
    kr_new = _apply_rope(kr_raw, cos[:, None], sin[:, None], cfg.rope_interleave)
    vec = torch.cat([c_new, kr_new], dim=-1)                  # [b, 1, D]

    wkv = _absorbed_kv_b(bp, cfg, dt)
    q_c, q_rot = _absorbed_q(h, bp, cfg, dt, cos[:, None], sin[:, None], wkv)
    q_cat = torch.cat([q_c, q_rot], dim=-1)                   # [b, nq, D]
    # the kernel divides by sqrt(D); MLA wants mla_softmax_scale
    D = q_cat.shape[-1]
    q_cat = (q_cat * (D ** 0.5 * mla_softmax_scale(cfg))).contiguous()
    ctx = paged_mla_attention_write(q_cat, vec, pool, page_tables, seq_lens, layer_idx=layer_idx,
                                    v_cols=cfg.kv_lora_rank)
    return _absorbed_out(ctx, bp, cfg, dt, wkv)


def _mla_decode_body(params: Params, tokens: torch.Tensor, pool, cfg: DeepseekConfig,
                     page_tables: torch.Tensor, seq_lens: torch.Tensor, layers=None):
    """One decode step for all slots: tokens [b] at per-sequence positions
    ``seq_lens``. Returns logits [b, V]; the pool is written in place."""
    dt = _pool_compute_dtype(pool)
    x = _embed(params, tokens, dt)                             # [b, d]
    cos, sin = _rope_tables(cfg, seq_lens)                     # [b, rd]
    for li, (moe, bp, mp) in enumerate(layers if layers is not None
                                       else deepseek_layers(params, cfg)):
        h = _rms(x, bp["ln1"], cfg.rms_eps)
        x = x + _absorbed_paged_attention(h, bp, cfg, dt, pool, page_tables, seq_lens, cos,
                                          sin, li)
        h2 = _rms(x, mp["ln2"], cfg.rms_eps)
        x = x + (_deepseek_moe(h2[:, None], mp, cfg, dt)[:, 0] if moe else _glu(h2, mp, dt))
    x = _rms(x, params["ln_final"], cfg.rms_eps)
    return _head_logits(x, params, dt)


@torch.no_grad()
def mla_paged_decode_step(params: Params, tokens: torch.Tensor, pool, cfg: DeepseekConfig,
                          page_tables: torch.Tensor, seq_lens: torch.Tensor, layers=None):
    """One decode step for all slots -> (logits [b, V], pool)."""
    return _mla_decode_body(params, tokens, pool, cfg, page_tables, seq_lens, layers), pool


def mla_paged_decode_steps_masked(params: Params, tokens, pool, cfg: DeepseekConfig,
                                  page_tables, seq_lens, alive, rem, eos_ids, num_steps: int,
                                  sampler_state=None, layers=None):
    """MLA masked multi-step decode (see ``paged.masked_decode_scan``)."""

    def body(tok, pool, pts, lens):
        return _mla_decode_body(params, tok, pool, cfg, pts, lens, layers), pool

    return masked_decode_scan(body, tokens, pool, page_tables, seq_lens, alive, rem, eos_ids,
                              num_steps, sampler_state)


class MLAPagedServer(PagedServer):
    """Continuous-batching server over the compressed-latent page pool: the
    whole serving machinery of :class:`PagedServer` (slots, admission, cancel,
    per-request sampling, prefix cache, the step loop) with the MLA model
    hooks. ``cache_dtype=torch.int8`` stores the pool quantized, one scale per
    row. Attention-materialized models and per-K/V dtype dicts raise, as in
    the JAX package."""

    def __init__(self, params: Params, cfg: DeepseekConfig, *, max_batch: int = 4,
                 num_pages: int = 128, page_size: int = 64, max_context: int = 1024,
                 cache_dtype=torch.bfloat16, chunked_prefill: Optional[int] = None,
                 prefix_cache: bool = False):
        if isinstance(cache_dtype, dict):
            raise ValueError("MLA stores ONE latent pool; per-K/V dtype "
                             "dicts do not apply — pass torch.int8 directly")
        if cfg.pruned_attention_blocks:
            raise ValueError(
                "paged MLA serving rides the uniform scan-group layout; "
                "attention-materialized models serve through "
                "deepseek_generate (contiguous cache) instead")
        super().__init__(params, cfg, max_batch=max_batch, num_pages=num_pages,
                         page_size=page_size, max_context=max_context, cache_dtype=cache_dtype,
                         chunked_prefill=chunked_prefill, prefix_cache=prefix_cache)

    # ---------------- model hooks ----------------

    def _setup_model(self):
        self._layers = deepseek_layers(self.params, self.cfg)

    def _init_pools(self, num_pages: int, page_size: int, cache_dtype):
        self.pool = init_mla_pool(self.cfg, num_pages, page_size, cache_dtype, self.device)

    def _prefill(self, prompt: List[int], pt: np.ndarray, m: int) -> torch.Tensor:
        if self.chunked_prefill is not None or m > 0:
            # prefix reuse needs the offset-capable chunked path
            logits, _ = mla_paged_prefill_chunked(
                self.params, prompt, self.pool, self.cfg, pt,
                chunk_size=self.chunked_prefill or 64, start=m * self.page_size,
                layers=self._layers)
            return logits
        toks = self._tensor(np.asarray(prompt, np.int64)[None])
        logits, _ = mla_paged_prefill(self.params, toks, self.pool, self.cfg, self._tensor(pt),
                                      len(prompt))
        return logits

    def _decode(self, tokens: np.ndarray, pts: np.ndarray, lens: np.ndarray) -> torch.Tensor:
        self.decode_steps += 1
        logits, _ = mla_paged_decode_step(self.params, self._tensor(tokens.astype(np.int64)),
                                          self.pool, self.cfg, self._tensor(pts),
                                          self._tensor(lens), self._layers)
        return logits

    def _decode_multi(self, tokens, pts, lens, alive, rem, eos, num_steps: int) -> np.ndarray:
        self.decode_steps += num_steps
        emits, _, self.sampler_state = mla_paged_decode_steps_masked(
            self.params, self._tensor(tokens.astype(np.int64)), self.pool, self.cfg,
            self._tensor(pts), self._tensor(lens), self._tensor(alive), self._tensor(rem),
            self._tensor(eos.astype(np.int64)), num_steps, self.sampler_state, self._layers)
        return emits.cpu().numpy()


def mla_paged_generate(params: Params, cfg: DeepseekConfig, prompts, *, max_new_tokens: int = 32,
                       eos_token_id: Optional[int] = None, page_size: int = 64,
                       cache_dtype=torch.bfloat16, max_batch: Optional[int] = None):
    """Bulk MLA paged generation (ragged prompts, continuous batching) on the
    device of ``params``. Returns per-prompt arrays (prompt + generation,
    trimmed at eos) in input order: the paged counterpart of
    ``deepseek_generate``."""
    prompts = [np.asarray(p).reshape(-1).astype(np.int32) for p in prompts]
    counts = [-(-(len(p) + max_new_tokens + 1) // page_size) for p in prompts]
    srv = MLAPagedServer(
        params, cfg, max_batch=max_batch or len(prompts), num_pages=1 + sum(counts),
        page_size=page_size, max_context=max(len(p) + max_new_tokens + 1 for p in prompts),
        cache_dtype=cache_dtype)
    ids = [srv.add_request(p, max_new_tokens=max_new_tokens, eos_token_id=eos_token_id)
           for p in prompts]
    finished = srv.run()
    return [finished[i] for i in ids]
