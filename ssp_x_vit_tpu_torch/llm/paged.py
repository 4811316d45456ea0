"""Paged-KV serving with continuous batching (counterpart of
``ssp_x_vit_tpu/llm/paged.py``).

- one physical page pool per layer (``[A, nkv, num_pages, page_size, hd]``),
  sequences own pages through per-slot page tables;
- per-sequence independent positions: no left-padding, no shared write
  position, so requests of different lengths decode in one batched step and
  new requests join as slots free (continuous batching);
- pages are allocated on demand as a sequence crosses a page boundary and
  returned to the free list when the request completes;
- page 0 is a reserved trash page: inactive slots (and padded prefill
  positions) write there.

Decode attention and the per-step K/V write go through
``ops/kernels/paged_attention.py`` as one write-and-attend call per layer (one
hand-written CUDA kernel launch for CUDA tensors, the plain versions for CPU
tensors). The pools are written in
place; every function that takes pools returns the same objects, which keeps
the JAX package's call shapes. The layer loop is a Python loop: ``layer_idx``
is a host integer, and gemma-2's per-layer windows are static. Eager PyTorch
compiles nothing per shape, so prompts are not padded to a bucket and the last
prefill chunk is not padded to the chunk size. The multi-step decode keeps the
tokens, lengths, liveness and budgets on the device and copies the emitted
tokens to the host once per block. Everything runs under ``torch.no_grad()``.

Covers llama-layout models (llama/mistral/qwen2/qwen3/gemma/gemma-2, and the
mixtral / qwen3_moe mixture of experts through the dropless expert MLP), phi's
parallel block, and width/depth-materialized pruned models (pool rows only for
surviving attention layers). OPT raises; the DeepSeek/MLA family
serves through ``llm/paged_mla.py``'s subclass of :class:`PagedServer`.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ssp_x_vit_tpu_torch.llm.model import (
    LlamaConfig, Params, _embed_tokens, _glu_act, _layer_norm, _mm, _moe_mlp,
    require_llama_config, rms_norm,
)
from ssp_x_vit_tpu_torch.llm.sampling import (
    SamplerState, SamplingParams, init_sampler_state, slot_state_row, vectorized_sample,
)
from ssp_x_vit_tpu_torch.llm.serve import (
    Layer, _block_qkv, _final_logits, cache_compute_dtype, num_attn_layers, rope_tables_at,
    split_layers,
)
from ssp_x_vit_tpu_torch.ops.attention import flash_attention
from ssp_x_vit_tpu_torch.ops.common import gelu
from ssp_x_vit_tpu_torch.ops.kernels.paged_attention import (
    Pool, layer_of, page_size_of, paged_attention_write, paged_cache_write_many,
)

_NEG_INF = torch.finfo(torch.float32).min

def _check_servable(cfg) -> None:
    require_llama_config(cfg)
    if cfg.is_opt:
        raise ValueError("paged serving covers llama-layout and phi models")


def init_paged_pools(cfg: LlamaConfig, num_pages: int, page_size: int,
                     dtype=torch.bfloat16, device="cpu") -> Tuple[Pool, Pool]:
    """[A, nkv, num_pages, page_size, hd] x2 on ``device`` (page 0 reserved as
    trash); one pool row per surviving attention layer. ``torch.int8`` makes
    quantized pools: int8 codes + fp32 per-token-per-head scales."""
    _check_servable(cfg)
    shape = (num_attn_layers(cfg), cfg.num_kv_heads, num_pages, page_size, cfg.head_dim)
    if dtype == torch.int8:
        def mk():
            return {"q": torch.zeros(shape, dtype=torch.int8, device=device),
                    "s": torch.ones(shape[:-1], dtype=torch.float32, device=device)}
        return mk(), mk()
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def _mlp_branch(h2, bp, cfg: LlamaConfig, compute_dtype):
    if cfg.num_experts:
        # the dropless expert MLP, the same path as contiguous serving
        return _moe_mlp(h2, bp, cfg, compute_dtype)[0]
    if cfg.is_phi:
        hm = _mm(h2, bp, "fc1_kernel", compute_dtype) + bp["fc1_bias"].to(compute_dtype)
        return _mm(gelu(hm), bp, "fc2_kernel", compute_dtype) + bp["fc2_bias"].to(compute_dtype)
    if any(k.startswith("gateup_kernel") for k in bp):
        g, u = _mm(h2, bp, "gateup_kernel", compute_dtype).chunk(2, dim=-1)
    else:
        g = _mm(h2, bp, "gate_kernel", compute_dtype)
        u = _mm(h2, bp, "up_kernel", compute_dtype)
    return _mm(_glu_act(cfg)(g) * u, bp, "down_kernel", compute_dtype)


def _o_proj(attn, bp, compute_dtype):
    out = _mm(attn, bp, "o_kernel", compute_dtype)
    if "o_bias" in bp:
        out = out + bp["o_bias"].to(compute_dtype)
    return out


def _block(x, bp, cfg: LlamaConfig, compute_dtype, attend):
    """One transformer block around ``attend(h) -> attention branch`` (None:
    the attention is physically absent): llama sequential / phi parallel /
    gemma-2 post-norms."""
    if cfg.is_phi:
        h = _layer_norm(x, bp["ln1"], bp["ln1_bias"], cfg.layer_norm_eps)
        mlp = _mlp_branch(h, bp, cfg, compute_dtype)
        return x + mlp if attend is None else x + attend(h) + mlp
    if attend is not None:
        attn = attend(rms_norm(x, bp["ln1"], cfg.rms_eps))
        if cfg.is_gemma2:
            attn = rms_norm(attn, bp["ln1_post"], cfg.rms_eps)
        x = x + attn
    mlp = _mlp_branch(rms_norm(x, bp["ln2"], cfg.rms_eps), bp, cfg, compute_dtype)
    if cfg.is_gemma2:
        mlp = rms_norm(mlp, bp["ln2_post"], cfg.rms_eps)
    return x + mlp


def _paged_layer(x, bp, k_pools, v_pools, cfg: LlamaConfig, page_tables, seq_lens,
                 compute_dtype, has_attn=True, window=None, layer_idx=None, ctx=None):
    """One decode-step layer over the paged cache: write the new token's K/V
    at slot ``seq_lens`` of each sequence and attend ``seq_lens + 1`` keys, in
    one ``paged_attention_write`` call (one launch on the card). ``k_pools`` /
    ``v_pools`` are the full 5D pools with the host integer ``layer_idx`` (4D
    pools with None); ``window`` is this layer's static sliding window."""
    b = x.shape[0]
    ctx = {} if ctx is None else ctx

    def attend(h):
        q, k, v = _block_qkv(h, bp, cfg, seq_lens[:, None], compute_dtype, ctx.get("rope"))
        starts = None
        if window is not None:
            # query position == seq_lens; HF window: keys k with q - k < window
            starts = ctx.get(("starts", window))
            if starts is None:
                starts = ctx[("starts", window)] = (seq_lens + 1 - window).clamp_min(0)
        attn = paged_attention_write(q[:, 0].contiguous(), k[:, 0].contiguous(),
                                     v[:, 0].contiguous(), k_pools, v_pools, page_tables,
                                     seq_lens, start_lens=starts, softcap=cfg.attn_softcap,
                                     layer_idx=layer_idx)
        return _o_proj(attn.reshape(b, 1, -1), bp, compute_dtype)

    return _block(x, bp, cfg, compute_dtype, attend if has_attn else None)


def _prefill_layer(x, bp, k_pools, v_pools, cfg: LlamaConfig, page_table, seq_len: int,
                   compute_dtype, has_attn=True, window=None, layer_idx=None, ctx=None):
    """One whole-prompt prefill layer ([1, p] tokens, ``p >= seq_len``): causal
    attention over the prompt itself through ``flash_attention`` and the page
    writes. Positions past ``seq_len`` (a padded prompt) write to the trash
    page; causality alone keeps them out of every valid row."""
    _, p, _ = x.shape
    ctx = {} if ctx is None else ctx

    def attend(h):
        positions = torch.arange(p, device=x.device)[None]
        q, k, v = _block_qkv(h, bp, cfg, positions, compute_dtype, ctx.get("rope"))
        paged_cache_write_many(k_pools, v_pools, k[0], v[0], page_table, 0,
                               valid_len=seq_len if seq_len < p else None, layer_idx=layer_idx)
        attn = flash_attention(q.permute(0, 2, 1, 3).contiguous(),
                               k.permute(0, 2, 1, 3).contiguous(),
                               v.permute(0, 2, 1, 3).contiguous(), causal=True, window=window,
                               softcap=cfg.attn_softcap)
        return _o_proj(attn.permute(0, 2, 1, 3).reshape(1, p, -1), bp, compute_dtype)

    return _block(x, bp, cfg, compute_dtype, attend if has_attn else None)


def _chunk_prefill_layer(x, bp, k_pools, v_pools, cfg: LlamaConfig, page_table, seq_len: int,
                         compute_dtype, has_attn=True, window=None, layer_idx=None, ctx=None,
                         *, chunk_start: int):
    """One layer of chunked prefill: C tokens at global positions
    [chunk_start, chunk_start + C) attend over the paged cache (earlier chunks'
    keys ride the pages; the chunk's own keys are written first, as on the
    decode path). Plain PyTorch ops: an offset-causal softmax over this
    sequence's gathered pages."""
    _, C, _ = x.shape
    ctx = {} if ctx is None else ctx
    ps = page_size_of(k_pools, layer_idx)

    def attend(h):
        positions = chunk_start + torch.arange(C, device=x.device)[None]
        q, k, v = _block_qkv(h, bp, cfg, positions, compute_dtype, ctx.get("rope"))
        valid = max(seq_len - chunk_start, 0)
        paged_cache_write_many(k_pools, v_pools, k[0], v[0], page_table, chunk_start,
                               valid_len=valid if valid < C else None, layer_idx=layer_idx)
        # only the pages that hold keys a row of this chunk may see
        n_pages = -(-min(seq_len, chunk_start + C) // ps)
        pages = page_table[:n_pages].long()

        def gather(pool):
            pool = layer_of(pool, layer_idx)
            if isinstance(pool, dict):
                out = (pool["q"][:, pages].float() * pool["s"][:, pages][..., None]).to(compute_dtype)
            else:
                out = pool[:, pages]
            return out.reshape(cfg.num_kv_heads, n_pages * ps, cfg.head_dim)

        kf, vf = gather(k_pools), gather(v_pools)
        rep = cfg.num_heads // cfg.num_kv_heads
        if rep > 1:
            kf = kf.repeat_interleave(rep, dim=0)
            vf = vf.repeat_interleave(rep, dim=0)
        logits = torch.einsum("qhd,hkd->hqk", q[0].float(), kf.float()) / cfg.head_dim ** 0.5
        if cfg.attn_softcap is not None:
            logits = cfg.attn_softcap * torch.tanh(logits / cfg.attn_softcap)
        row = positions[0][:, None]                              # global query position
        col = torch.arange(n_pages * ps, device=x.device)[None, :]
        mask = (col <= row) & (col < seq_len)
        if window is not None:
            mask = mask & (row - col < window)
        logits = torch.where(mask[None], logits, torch.full_like(logits, _NEG_INF))
        w = torch.softmax(logits, dim=-1).to(vf.dtype)
        attn = torch.einsum("hqk,hkd->qhd", w, vf).reshape(1, C, -1)
        return _o_proj(attn, bp, compute_dtype)

    return _block(x, bp, cfg, compute_dtype, attend if has_attn else None)


def _run_paged_layers(layer_fn, params: Params, x, k_pools, v_pools, cfg: LlamaConfig, table,
                      lens, *, positions, layers: Optional[List[Layer]] = None, **kw):
    """Every layer in turn. The pools are addressed in place by the host
    integer ``layer_idx`` (the compacted attention index of depth-materialized
    models); ``positions [b, s]`` are the rotary positions, whose cos/sin
    tables are made once here for all layers."""
    compute_dtype = cache_compute_dtype(k_pools)
    ctx = {"rope": rope_tables_at(positions, cfg)}
    for i, (bp, j) in enumerate(layers if layers is not None else split_layers(params, cfg)):
        x = layer_fn(x, bp, k_pools, v_pools, cfg, table, lens, compute_dtype,
                     has_attn=j is not None, window=cfg.layer_window(i), layer_idx=j, ctx=ctx,
                     **kw)
    return x


@torch.no_grad()
def paged_prefill_chunk(params: Params, tokens: torch.Tensor, k_pools, v_pools,
                        cfg: LlamaConfig, page_table: torch.Tensor, chunk_start: int,
                        seq_len: int, layers: Optional[List[Layer]] = None):
    """One chunk ([1, C] tokens at global [chunk_start, chunk_start + C)) of a
    chunked prefill. Returns (logits at min(seq_len, chunk_start + C) - 1 [V],
    pools)."""
    _check_servable(cfg)
    compute_dtype = cache_compute_dtype(k_pools)
    chunk_start, seq_len = int(chunk_start), int(seq_len)
    C = tokens.shape[1]
    x = _embed_tokens(params, tokens, cfg, compute_dtype)
    positions = chunk_start + torch.arange(C, device=tokens.device)[None]
    x = _run_paged_layers(_chunk_prefill_layer, params, x, k_pools, v_pools, cfg, page_table,
                          seq_len, positions=positions, layers=layers, chunk_start=chunk_start)
    last = min(max(min(seq_len, chunk_start + C) - 1 - chunk_start, 0), C - 1)
    logits = _final_logits(params, x[:, last:last + 1], cfg, compute_dtype)[0, 0]
    return logits, k_pools, v_pools


def paged_prefill_chunked(params: Params, prompt, k_pools, v_pools, cfg: LlamaConfig,
                          page_table, *, chunk_size: int = 64, start: int = 0,
                          layers: Optional[List[Layer]] = None):
    """Prefill one prompt through chunks of at most ``chunk_size`` tokens.
    Returns (next-token logits [V], pools). ``start`` skips tokens whose K/V
    the pages already hold (prefix caching); it must be page-aligned so writes
    never touch the shared pages."""
    device = params["embed"].device
    prompt = np.asarray(prompt, np.int64).reshape(-1)
    n = len(prompt)
    if isinstance(page_table, torch.Tensor):
        table = page_table.to(device=device, dtype=torch.int32)
    else:
        table = torch.as_tensor(np.asarray(page_table, np.int32), device=device)
    logits = None
    for c0 in range(start, n, chunk_size):
        chunk = torch.as_tensor(prompt[None, c0:c0 + chunk_size], device=device)
        logits, k_pools, v_pools = paged_prefill_chunk(params, chunk, k_pools, v_pools, cfg,
                                                       table, c0, n, layers)
    return logits, k_pools, v_pools


@torch.no_grad()
def paged_prefill(params: Params, tokens: torch.Tensor, k_pools, v_pools, cfg: LlamaConfig,
                  page_table: torch.Tensor, seq_len: int, layers: Optional[List[Layer]] = None):
    """One prompt ([1, p], ``p >= seq_len``; right-padded or not) -> pools
    filled, logits at the last valid position [V]."""
    _check_servable(cfg)
    compute_dtype = cache_compute_dtype(k_pools)
    seq_len = int(seq_len)
    x = _embed_tokens(params, tokens, cfg, compute_dtype)
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None]
    x = _run_paged_layers(_prefill_layer, params, x, k_pools, v_pools, cfg, page_table, seq_len,
                          positions=positions, layers=layers)
    last = max(seq_len - 1, 0)
    logits = _final_logits(params, x[:, last:last + 1], cfg, compute_dtype)[0, 0]
    return logits, k_pools, v_pools


def _paged_decode_body(params, tokens, k_pools, v_pools, cfg, page_tables, seq_lens, layers):
    compute_dtype = cache_compute_dtype(k_pools)
    x = _embed_tokens(params, tokens, cfg, compute_dtype)[:, None]      # [b, 1, d]
    x = _run_paged_layers(_paged_layer, params, x, k_pools, v_pools, cfg, page_tables, seq_lens,
                          positions=seq_lens[:, None], layers=layers)
    return _final_logits(params, x, cfg, compute_dtype)[:, 0]


@torch.no_grad()
def paged_decode_step(params: Params, tokens: torch.Tensor, k_pools, v_pools, cfg: LlamaConfig,
                      page_tables: torch.Tensor, seq_lens: torch.Tensor,
                      layers: Optional[List[Layer]] = None):
    """One decode step for all slots: tokens [b] at per-sequence positions
    ``seq_lens`` [b] int32 (each sequence's own length). Returns
    (logits [b, V], pools)."""
    _check_servable(cfg)
    logits = _paged_decode_body(params, tokens, k_pools, v_pools, cfg, page_tables, seq_lens,
                                layers)
    return logits, k_pools, v_pools


@torch.no_grad()
def paged_decode_scan(params: Params, first_tokens: torch.Tensor, k_pools, v_pools,
                      cfg: LlamaConfig, page_tables: torch.Tensor, seq_lens: torch.Tensor,
                      num_steps: int, layers: Optional[List[Layer]] = None):
    """``num_steps`` greedy paged decode steps with the token feedback on the
    device: nothing is read back between steps. The page tables are fixed for
    the scan, so the caller must own enough pages to cover
    ``seq_lens + num_steps``. Returns (tokens [num_steps, b], pools)."""
    _check_servable(cfg)
    layers = layers if layers is not None else split_layers(params, cfg)
    tok, lens, out = first_tokens, seq_lens, []
    for _ in range(num_steps):
        logits = _paged_decode_body(params, tok, k_pools, v_pools, cfg, page_tables, lens, layers)
        tok = logits.argmax(dim=-1)
        out.append(tok)
        lens = lens + 1
    return torch.stack(out), k_pools, v_pools


@torch.no_grad()
def masked_decode_scan(body_fn, tokens, pools, page_tables, seq_lens, alive, rem, eos_ids,
                       num_steps: int, sampler_state: Optional[SamplerState] = None):
    """``num_steps`` decode steps with per-slot liveness kept on the device: a
    slot whose output token hits its eos or exhausts its remaining budget goes
    dead mid-block (its page-table row is zeroed so further writes land on
    trash page 0, its length freezes, its emitted tokens read -1). One host
    round trip therefore covers up to ``num_steps`` tokens per slot between
    admission points.

    ``body_fn(tok [b], pools, page_tables, seq_lens) -> (logits [b, V], pools)``
    is the model family's decode body. Dead slots still run the body (masked
    work, not a branch). Returns (emits [num_steps, b] int64 with -1 for dead
    steps, pools, sampler_state)."""
    alive = alive.bool()
    tok, lens, emits = tokens, seq_lens, []
    zero_table = torch.zeros_like(page_tables)
    for _ in range(num_steps):
        pt_step = torch.where(alive[:, None], page_tables, zero_table)
        logits, pools = body_fn(tok, pools, pt_step, lens)
        if sampler_state is not None:
            nxt, sampler_state = vectorized_sample(logits, sampler_state)
        else:
            nxt = logits.argmax(dim=-1)
        emits.append(torch.where(alive, nxt, torch.full_like(nxt, -1)))
        live = alive.to(lens.dtype)
        lens = lens + live          # the K/V row this step just wrote
        rem = rem - live
        alive = alive & (nxt != eos_ids) & (rem > 0)
        tok = nxt
    return torch.stack(emits), pools, sampler_state


def paged_decode_steps_masked(params: Params, tokens, k_pools, v_pools, cfg: LlamaConfig,
                              page_tables, seq_lens, alive, rem, eos_ids, num_steps: int,
                              sampler_state: Optional[SamplerState] = None,
                              layers: Optional[List[Layer]] = None):
    """Llama-family masked multi-step decode (see :func:`masked_decode_scan`)."""
    _check_servable(cfg)
    layers = layers if layers is not None else split_layers(params, cfg)

    def body(tok, pools, pts, lens):
        logits = _paged_decode_body(params, tok, pools[0], pools[1], cfg, pts, lens, layers)
        return logits, pools

    emits, (k_pools, v_pools), sampler_state = masked_decode_scan(
        body, tokens, (k_pools, v_pools), page_tables, seq_lens, alive, rem, eos_ids, num_steps,
        sampler_state)
    return emits, k_pools, v_pools, sampler_state


def paged_generate(params: Params, cfg: LlamaConfig, prompts, *, max_new_tokens: int = 32,
                   eos_token_id: Optional[int] = None, page_size: int = 64,
                   cache_dtype=torch.bfloat16) -> List[np.ndarray]:
    """Bulk paged generation on the device that holds ``params``: prefill each
    prompt into its pages, then one greedy scan for the whole batch. Different
    prompt lengths decode at their own positions (no left padding). Returns a
    list of per-prompt token arrays (prompt + generation, trimmed at eos)."""
    _check_servable(cfg)
    device = params["embed"].device
    prompts = [np.asarray(p).reshape(-1).astype(np.int32) for p in prompts]
    b = len(prompts)
    if max_new_tokens <= 0:
        return [p.copy() for p in prompts]
    counts = [-(-(len(p) + max_new_tokens + 1) // page_size) for p in prompts]
    mp = max(counts)
    k_pools, v_pools = init_paged_pools(cfg, 1 + sum(counts), page_size, cache_dtype, device)
    layers = split_layers(params, cfg)

    pts = np.zeros((b, mp), np.int32)
    nxt_page = 1
    for i, c in enumerate(counts):
        pts[i, :c] = np.arange(nxt_page, nxt_page + c)
        nxt_page += c
    tables = torch.as_tensor(pts, device=device)

    firsts = []
    for i, p in enumerate(prompts):
        toks = torch.as_tensor(p[None].astype(np.int64), device=device)
        logits, k_pools, v_pools = paged_prefill(params, toks, k_pools, v_pools, cfg, tables[i],
                                                 len(p), layers)
        firsts.append(logits.argmax())
    first = torch.stack(firsts)

    gen = first[None]
    if max_new_tokens > 1:
        lens = torch.as_tensor([len(p) for p in prompts], dtype=torch.int32, device=device)
        toks, _, _ = paged_decode_scan(params, first, k_pools, v_pools, cfg, tables, lens,
                                       max_new_tokens - 1, layers)
        gen = torch.cat([gen, toks], dim=0)                       # [N, b]
    gen = gen.cpu().numpy()

    outs = []
    for i, p in enumerate(prompts):
        seq = gen[:, i].tolist()
        if eos_token_id is not None and eos_token_id in seq:
            seq = seq[: seq.index(eos_token_id) + 1]
        outs.append(np.asarray(p.tolist() + seq, np.int32))
    return outs


@dataclasses.dataclass
class _Slot:
    active: bool = False
    request_id: int = -1
    pages: List[int] = dataclasses.field(default_factory=list)
    length: int = 0                      # tokens in cache
    last_token: int = 0
    generated: List[int] = dataclasses.field(default_factory=list)
    prompt: List[int] = dataclasses.field(default_factory=list)
    budget: int = 0
    eos: Optional[int] = None
    reserved: int = 0                    # worst-case pages held at admit


class PagedServer:
    """Continuous-batching server over the paged pools, on the device that
    holds ``params``.

    ``max_batch`` slots decode together each ``step()``; ``add_request``
    prefills into freshly allocated pages and joins the next step. Completed
    requests free their pages immediately. Raises if the pool cannot cover a
    request's worst case at admit time (simple admission control).

    ``prefix_cache=True`` enables automatic prefix caching: full pages of a
    prompt are registered under the hash of the token prefix they complete; a
    later prompt sharing that prefix reuses the pages (refcounted, read-only:
    decode writes only ever target a sequence's own tail pages) and prefills
    only the remainder through the chunked path. Finished requests' registered
    pages stay cached (LRU) until pool pressure evicts them. Exact: shared
    pages hold identical K/V (same tokens, same absolute positions, and for
    int8 pools the same per-token quantizer)."""

    def __init__(self, params: Params, cfg: LlamaConfig, *, max_batch: int = 4,
                 num_pages: int = 128, page_size: int = 64, max_context: int = 1024,
                 cache_dtype=torch.bfloat16, chunked_prefill: Optional[int] = None,
                 prefix_cache: bool = False):
        self.params, self.cfg = params, cfg
        self._setup_model()
        self.device = params["embed"].device
        # per-request sampling: lazily activated device state; None = every
        # request greedy through a device argmax
        self.sampler_state: Optional[SamplerState] = None
        self.page_size = page_size
        self.chunked_prefill = chunked_prefill
        self.prefix_cache = prefix_cache
        self.max_pages_per_seq = -(-max_context // page_size)
        self._init_pools(num_pages, page_size, cache_dtype)
        self.free_pages = list(range(num_pages - 1, 0, -1))  # page 0 = trash
        self.slots = [_Slot() for _ in range(max_batch)]
        self._next_id = 0
        self.finished: Dict[int, np.ndarray] = {}
        # prefix-cache state: registered page <-> prefix-hash maps, active
        # refcounts, and an LRU of cached-but-unreferenced pages (evictable)
        self._registry: Dict[bytes, int] = {}  # prefix digest -> page id
        self._page_key: Dict[int, bytes] = {}  # page id -> prefix digest
        self._page_refs: Dict[int, int] = {}   # page id -> active slots
        self._lru: Dict[int, None] = {}        # insertion-ordered, evictable
        self.prefix_hit_pages = 0              # stat: pages served from cache
        self.decode_steps = 0                  # stat: batched decode steps run

    # ---------------- model hooks ----------------

    def _setup_model(self):
        """Check the config and make the per-layer parameter views once."""
        _check_servable(self.cfg)
        self._layers = split_layers(self.params, self.cfg)

    def _init_pools(self, num_pages: int, page_size: int, cache_dtype):
        self.k_pools, self.v_pools = init_paged_pools(self.cfg, num_pages, page_size,
                                                      cache_dtype, self.device)

    def _tensor(self, array: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(array, device=self.device)

    def _prefill(self, prompt: List[int], pt: np.ndarray, m: int) -> torch.Tensor:
        """Prefill one prompt into its page table ``pt`` (the first ``m``
        pages already hold this prefix: a prefix-cache hit); returns the
        next-token logits [V] on the device."""
        if self.chunked_prefill is not None or m > 0:
            # prefix reuse needs the offset-capable chunked path
            logits, _, _ = paged_prefill_chunked(
                self.params, prompt, self.k_pools, self.v_pools, self.cfg, pt,
                chunk_size=self.chunked_prefill or 64, start=m * self.page_size,
                layers=self._layers)
        else:
            toks = self._tensor(np.asarray(prompt, np.int64)[None])
            logits, _, _ = paged_prefill(self.params, toks, self.k_pools, self.v_pools, self.cfg,
                                         self._tensor(pt), len(prompt), self._layers)
        return logits

    def _decode(self, tokens: np.ndarray, pts: np.ndarray, lens: np.ndarray) -> torch.Tensor:
        """One batched decode step (np [b], [b, mp], [b]) -> logits [b, V]."""
        self.decode_steps += 1
        logits, _, _ = paged_decode_step(
            self.params, self._tensor(tokens.astype(np.int64)), self.k_pools, self.v_pools,
            self.cfg, self._tensor(pts), self._tensor(lens), self._layers)
        return logits

    def _decode_multi(self, tokens, pts, lens, alive, rem, eos, num_steps: int) -> np.ndarray:
        """``num_steps`` masked decode steps with one copy back to the host (np
        inputs); returns the emitted-token matrix [num_steps, b] (-1 = dead step)."""
        self.decode_steps += num_steps
        emits, _, _, self.sampler_state = paged_decode_steps_masked(
            self.params, self._tensor(tokens.astype(np.int64)), self.k_pools, self.v_pools,
            self.cfg, self._tensor(pts), self._tensor(lens), self._tensor(alive),
            self._tensor(rem), self._tensor(eos.astype(np.int64)), num_steps,
            self.sampler_state, self._layers)
        return emits.cpu().numpy()

    # ---------------- page accounting ----------------

    def _alloc_page(self) -> int:
        if self.free_pages:
            return self.free_pages.pop()
        if self._lru:  # evict the least-recently-used cached prefix page
            pid = next(iter(self._lru))
            del self._lru[pid]
            del self._registry[self._page_key.pop(pid)]
            self._page_refs.pop(pid, None)
            return pid
        raise RuntimeError("page pool exhausted")

    def _release_page(self, pid: int):
        if pid in self._page_key:   # registered: stays cached, now evictable
            self._page_refs[pid] -= 1
            if self._page_refs[pid] == 0:
                self._lru[pid] = None  # re-inserted at MRU position
        else:
            self.free_pages.append(pid)

    def _prefix_keys(self, prompt) -> List[bytes]:
        """Chained sha256 digests per full page: key_i = H(key_{i-1} || tokens
        of page i); content-derived, so a cached page can never silently serve
        a different prefix."""
        ps = self.page_size
        keys, prev = [], b""
        for i in range(len(prompt) // ps):
            block = np.asarray(prompt[i * ps:(i + 1) * ps], np.int32).tobytes()
            prev = hashlib.sha256(prev + block).digest()
            keys.append(prev)
        return keys

    # ---------------- admission ----------------

    def add_request(self, prompt, max_new_tokens: int = 32, eos_token_id: Optional[int] = None,
                    sampling: Optional[SamplingParams] = None, seed: Optional[int] = None) -> int:
        """``sampling`` (``llm/sampling.SamplingParams``) and ``seed`` select
        this request's decoding: requests with different temperatures,
        penalties and seeds decode together in one step."""
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        slot = next((s for s in self.slots if not s.active), None)
        if slot is None:
            raise RuntimeError("no free slot")
        slot_idx = self.slots.index(slot)
        if (sampling is not None or seed is not None) and self.sampler_state is None:
            # rows default to neutral (greedy, no penalties), so slots admitted
            # before activation keep their exact behavior
            self.sampler_state = init_sampler_state(len(self.slots), self.cfg.vocab_size,
                                                    self.device)
        worst = -(-(len(prompt) + max_new_tokens) // self.page_size)
        if worst > self.max_pages_per_seq:
            raise ValueError("request exceeds max_context")

        keys = self._prefix_keys(prompt) if self.prefix_cache else []
        # reuse at most (len-1)//ps pages: at least one prompt token must still
        # run through the model to produce the first-token logits
        limit = (len(prompt) - 1) // self.page_size
        m = 0
        while m < min(len(keys), limit) and keys[m] in self._registry:
            m += 1

        # Reserve the worst case: concurrent requests must never overcommit the
        # pool. Unreserved = free + evictable cache minus what active slots may
        # still claim. The m reused pages need no new allocation, but the ones
        # sitting in the LRU stop being evictable once referenced, so they do
        # not count as capacity.
        outstanding = sum(max(0, sl.reserved - len(sl.pages)) for sl in self.slots if sl.active)
        m_in_lru = sum(1 for i in range(m) if self._registry[keys[i]] in self._lru)
        if worst - m > len(self.free_pages) + len(self._lru) - m_in_lru - outstanding:
            raise RuntimeError("page pool exhausted")

        reused = [self._registry[keys[i]] for i in range(m)]
        for pid in reused:
            if self._page_refs.get(pid, 0) == 0:
                self._lru.pop(pid, None)  # referenced again: not evictable
            self._page_refs[pid] = self._page_refs.get(pid, 0) + 1
        self.prefix_hit_pages += m

        n0 = -(-len(prompt) // self.page_size)
        pages = reused + [self._alloc_page() for _ in range(n0 - m)]
        pt = np.zeros((self.max_pages_per_seq,), np.int32)
        pt[: len(pages)] = pages

        logits = self._prefill(prompt, pt, m)
        if self.sampler_state is not None:
            # reset this slot's row (a previous occupant's knobs must never leak
            # into a new request) and sample the first token through the same
            # transform the decode steps use
            sp = sampling if sampling is not None else SamplingParams()
            slot_state_row(self.sampler_state, slot_idx, sp, prompt, self.cfg.vocab_size, seed)
            tok, self.sampler_state = vectorized_sample(logits.reshape(1, -1), self.sampler_state,
                                                        rows=[slot_idx])
            first = int(tok[0])
        else:
            first = int(logits.argmax())

        # register this prompt's freshly computed full-prefix pages
        for i in range(m, len(keys)):
            if keys[i] not in self._registry:
                self._registry[keys[i]] = pages[i]
                self._page_key[pages[i]] = keys[i]
                self._page_refs[pages[i]] = 1

        slot.active = True
        slot.request_id = self._next_id
        self._next_id += 1
        slot.pages = pages
        slot.length = len(prompt)
        slot.prompt = prompt
        slot.generated = [first]
        slot.last_token = first
        slot.budget = max_new_tokens
        slot.eos = eos_token_id
        slot.reserved = worst
        if eos_token_id is not None and first == eos_token_id:
            self._finish(slot)
        elif len(slot.generated) >= slot.budget:
            self._finish(slot)
        return slot.request_id

    # ---------------- decode loop ----------------

    def _ensure_page(self, slot: _Slot):
        need = slot.length // self.page_size  # page for the slot being written
        if need >= len(slot.pages):
            slot.pages.append(self._alloc_page())

    def _finish(self, slot: _Slot):
        self.finished[slot.request_id] = np.asarray(slot.prompt + slot.generated, np.int32)
        for pid in slot.pages:
            self._release_page(pid)
        slot.active = False
        slot.pages = []
        slot.reserved = 0

    def cancel(self, request_id: int) -> bool:
        """Abort an active request: its tokens so far move to ``finished`` and
        its pages are released immediately. Returns False when the id is not
        currently active (already finished or never admitted)."""
        for slot in self.slots:
            if slot.active and slot.request_id == request_id:
                self._finish(slot)
                return True
        return False

    def step(self) -> bool:
        """One batched decode step; returns False when no slot is active."""
        if not any(s.active for s in self.slots):
            return False
        b = len(self.slots)
        tokens = np.zeros((b,), np.int32)
        pts = np.zeros((b, self.max_pages_per_seq), np.int32)
        lens = np.zeros((b,), np.int32)
        for i, s in enumerate(self.slots):
            if not s.active:
                continue  # trash-page writes, masked output
            self._ensure_page(s)
            tokens[i] = s.last_token
            pts[i, : len(s.pages)] = s.pages
            lens[i] = s.length

        logits = self._decode(tokens, pts, lens)
        if self.sampler_state is not None:
            # greedy rows (temperature 0) reduce to the same argmax
            toks, self.sampler_state = vectorized_sample(logits, self.sampler_state)
        else:
            toks = logits.argmax(dim=-1)
        nxt = toks.cpu().numpy()

        for i, s in enumerate(self.slots):
            if not s.active:
                continue
            s.length += 1          # the token just written
            tok = int(nxt[i])
            s.generated.append(tok)
            s.last_token = tok
            if (s.eos is not None and tok == s.eos) or len(s.generated) >= s.budget:
                self._finish(s)
        return True

    def step_many(self, num_steps: int = 8) -> bool:
        """Up to ``num_steps`` decode steps for every active slot with one
        copy back to the host (:func:`masked_decode_scan`); returns False when
        no slot is active. Slots that finish mid-block (eos or budget) stop
        advancing on the device; their pages are freed at reconcile. Admission
        happens between blocks, so ``num_steps`` bounds the join latency of a
        new request."""
        if not any(s.active for s in self.slots):
            return False
        if num_steps <= 1:
            return self.step()
        b = len(self.slots)
        tokens = np.zeros((b,), np.int32)
        pts = np.zeros((b, self.max_pages_per_seq), np.int32)
        lens = np.zeros((b,), np.int32)
        alive = np.zeros((b,), bool)
        rem = np.zeros((b,), np.int32)
        eos = np.full((b,), -1, np.int32)
        for i, s in enumerate(self.slots):
            if not s.active:
                continue
            steps_i = min(num_steps, s.budget - len(s.generated))
            # pre-own every page the next steps_i writes can touch: always
            # within the admit-time worst-case reservation, since
            # length + remaining budget <= len(prompt) + max_new_tokens
            while (s.length + steps_i - 1) // self.page_size >= len(s.pages):
                s.pages.append(self._alloc_page())
            tokens[i] = s.last_token
            pts[i, : len(s.pages)] = s.pages
            lens[i] = s.length
            alive[i] = True
            rem[i] = s.budget - len(s.generated)
            if s.eos is not None:
                eos[i] = s.eos
        emits = self._decode_multi(tokens, pts, lens, alive, rem, eos, num_steps)
        for i, s in enumerate(self.slots):
            if not s.active:
                continue
            for t in range(emits.shape[0]):
                tok = int(emits[t, i])
                if tok < 0:
                    break
                s.length += 1
                s.generated.append(tok)
                s.last_token = tok
                if (s.eos is not None and tok == s.eos) or len(s.generated) >= s.budget:
                    self._finish(s)
                    break
        return True

    def run(self, decode_block: int = 8) -> Dict[int, np.ndarray]:
        while self.step_many(decode_block):
            pass
        return self.finished
