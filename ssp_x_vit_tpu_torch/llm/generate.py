"""Text generation (counterpart of ``ssp_x_vit_tpu/llm/generate.py``).

``full_logits`` is the whole-sequence forward for any served config.
``greedy_generate`` and ``beam_generate`` recompute the whole padded sequence
every step (one forward per step, all live beams in one batch), with the
reference's ``no_repeat_ngram_size=3`` ban; ``beam_generate_kv`` runs the same
beam selection over the contiguous KV cache of ``llm/serve.py`` (the beam
reorder is an ``index_select`` of the cache rows). All run on the device of the
parameters. ``generate_response`` turns a text prompt into text through a
tokenizer; ``qualitative_results`` runs it on two fixed prompts with the model
directory's byte-level ``tokenizer.json`` (``llm/tokenizer.py``), which adds no
BOS and has no ``eos_token_id`` (the JAX package's ``AutoTokenizer`` may add
and stop on them).
"""

from __future__ import annotations

import logging
from typing import List, Optional, Tuple

import numpy as np
import torch

from ssp_x_vit_tpu_torch.llm.model import (
    LlamaConfig, llama_forward, llama_forward_materialized, require_llama_config,
)
from ssp_x_vit_tpu_torch.llm.serve import (
    bucket_prompt_pad, decode_step, init_cache, prefill, split_layers,
)

def full_logits(params, tokens: torch.Tensor, cfg, compute_dtype, *,
                remat: bool = False) -> torch.Tensor:
    """[b, s] -> [b, s, V] fp32 logits, picking the gated or the materialized
    forward from the config. ``remat=True`` checkpoints each layer (training
    under autograd); the materialized (pruned) forwards ignore it, as in the
    JAX package. DeepSeek/MLA configs take ``llm/deepseek.py``'s forwards."""
    from ssp_x_vit_tpu_torch.llm.deepseek import (
        deepseek_forward, deepseek_forward_materialized, is_deepseek,
    )

    if is_deepseek(cfg):
        if cfg.pruned_attention_blocks:
            return deepseek_forward_materialized(params, tokens, cfg, compute_dtype=compute_dtype)
        return deepseek_forward(params, tokens, cfg, compute_dtype=compute_dtype, remat=remat)
    require_llama_config(cfg)
    if cfg.pruned_attention_blocks:
        return llama_forward_materialized(params, tokens, cfg, compute_dtype=compute_dtype)
    logits, _ = llama_forward(params, tokens, cfg, compute_dtype=compute_dtype, remat=remat)
    return logits


def _banned_next_tokens(ids, n):
    """Tokens that would complete an already-seen n-gram (no_repeat_ngram)."""
    if not n or len(ids) < n - 1:
        return ()
    prefix = tuple(ids[-(n - 1):]) if n > 1 else ()
    return tuple(ids[i + n - 1] for i in range(len(ids) - n + 1)
                 if tuple(ids[i: i + n - 1]) == prefix)


@torch.no_grad()
def greedy_generate(params, cfg: LlamaConfig, input_ids, *, max_length: int = 64,
                    eos_token_id: Optional[int] = None, no_repeat_ngram_size: int = 3,
                    compute_dtype=None) -> np.ndarray:
    """Greedy decoding by full recompute: the sequence right-padded to
    ``max_length``, the logits read at the cursor, n-grams banned."""
    compute_dtype = compute_dtype or torch.bfloat16
    device = params["embed"].device
    ids = list(np.asarray(input_ids).reshape(-1).tolist())
    while len(ids) < max_length:
        tokens = np.zeros((1, max_length), np.int64)
        tokens[0, : len(ids)] = ids
        logits = full_logits(params, torch.as_tensor(tokens, device=device), cfg,
                             compute_dtype)[0, len(ids) - 1].cpu().numpy().copy()
        for b in _banned_next_tokens(ids, no_repeat_ngram_size):
            logits[b] = -np.inf
        nxt = int(np.argmax(logits))
        ids.append(nxt)
        if eos_token_id is not None and nxt == eos_token_id:
            break
    return np.asarray(ids)


@torch.no_grad()
def beam_generate(params, cfg: LlamaConfig, input_ids, *, max_length: int = 64,
                  num_beams: int = 5, eos_token_id: Optional[int] = None,
                  no_repeat_ngram_size: int = 3, early_stopping: bool = True,
                  compute_dtype=None) -> np.ndarray:
    """Beam search with the reference's generation kwargs (num_beams=5,
    no_repeat_ngram_size=3, early_stopping): all live beams are scored in one
    padded batched forward per step."""
    prompt = list(np.asarray(input_ids).reshape(-1).tolist())
    compute_dtype = compute_dtype or torch.bfloat16
    device = params["embed"].device

    def step_logp(tokens, cursor):
        logits = full_logits(params, torch.as_tensor(tokens, device=device), cfg, compute_dtype)
        return torch.log_softmax(logits[:, cursor].float(), dim=-1).cpu().numpy()

    beams = [(0.0, prompt, False)]  # (logprob, ids, finished)
    while len(beams[0][1]) < max_length:
        if all(f for _, _, f in beams):
            break
        live = [(s, ids) for s, ids, f in beams if not f]
        done = [(s, ids, True) for s, ids, f in beams if f]
        if len(live[0][1]) >= max_length:
            break  # finished shorter beam on top (early_stopping False)
        tokens = np.zeros((num_beams, max_length), np.int64)
        for i, (_, ids) in enumerate(live):
            tokens[i, : len(ids)] = ids
        logp = step_logp(tokens, len(live[0][1]) - 1)           # all live beams share a length
        candidates = list(done)
        for i, (score, ids) in enumerate(live):
            row = logp[i].copy()
            for b in _banned_next_tokens(ids, no_repeat_ngram_size):
                row[b] = -np.inf
            for t in np.argsort(-row)[:num_beams]:
                finished = eos_token_id is not None and int(t) == eos_token_id
                candidates.append((score + float(row[t]), ids + [int(t)], finished))
        candidates.sort(key=lambda c: c[0], reverse=True)
        beams = candidates[:num_beams]
        if early_stopping and beams[0][2]:
            break
    return np.asarray(beams[0][1])


def _log_softmax_host(logits: torch.Tensor) -> np.ndarray:
    return torch.log_softmax(logits.float(), dim=-1).cpu().numpy()


@torch.no_grad()
def beam_generate_kv(params, cfg: LlamaConfig, input_ids, *, max_length: int = 64,
                     num_beams: int = 5, eos_token_id: Optional[int] = None,
                     no_repeat_ngram_size: int = 3, early_stopping: bool = True,
                     cache_dtype=torch.float32) -> np.ndarray:
    """KV-cached beam search: the selection of :func:`beam_generate`, each
    step a cached decode. The prompt is prefilled once and its cache rows
    copied to the beams; before each step the rows are reordered to the live
    beams' parents (``index_select`` on the batch axis), so row i always
    holds beam i's history. Cached logits equal full-recompute logits, so the
    chosen beams match :func:`beam_generate` at fp32."""
    device = params["embed"].device
    prompt = list(np.asarray(input_ids).reshape(-1).tolist())
    if len(prompt) >= max_length:
        return np.asarray(prompt[:max_length])
    B = num_beams
    p_pad = bucket_prompt_pad(len(prompt))
    max_len = p_pad + (max_length - len(prompt))
    layers = split_layers(params, cfg)

    cache_k, cache_v = init_cache(cfg, 1, max_len, cache_dtype, device)
    tokens = np.zeros((1, p_pad), np.int64)
    tokens[0, p_pad - len(prompt):] = prompt
    pad_lens = torch.full((B,), p_pad - len(prompt), dtype=torch.int64, device=device)
    logits, cache_k, cache_v = prefill(params, torch.as_tensor(tokens, device=device), cache_k,
                                       cache_v, cfg, pad_lens[:1], layers=layers)

    def rows(cache, index):
        if isinstance(cache, dict):
            return {k: v.index_select(1, index) for k, v in cache.items()}
        return cache.index_select(1, index)

    first = torch.zeros(B, dtype=torch.int64, device=device)
    cache_k, cache_v = rows(cache_k, first), rows(cache_v, first)   # the prompt in every row
    logp = _log_softmax_host(logits[0])
    for b in _banned_next_tokens(prompt, no_repeat_ngram_size):
        logp[b] = -np.inf
    top = np.argsort(-logp)[:B]
    # beams: (score, ids, finished, cache row); after prefill row i holds the prompt
    beams = [(float(logp[t]), prompt + [int(t)],
              eos_token_id is not None and int(t) == eos_token_id, i)
             for i, t in enumerate(top)]

    pos = p_pad
    while len(beams[0][1]) < max_length:
        if all(f for _, _, f, _ in beams):
            break
        if early_stopping and beams[0][2]:
            break
        live = [bm for bm in beams if not bm[2]]
        done = [bm for bm in beams if bm[2]]
        if len(live[0][1]) >= max_length:
            break  # a finished shorter beam holds the top slot; live beams are at the cap
        parents = np.zeros((B,), np.int64)
        feed = np.zeros((B,), np.int64)
        for i, (_, ids, _, row) in enumerate(live):
            parents[i] = row
            feed[i] = ids[-1]
        index = torch.as_tensor(parents, device=device)
        cache_k, cache_v = rows(cache_k, index), rows(cache_v, index)
        logits, cache_k, cache_v = decode_step(params, torch.as_tensor(feed, device=device),
                                               cache_k, cache_v, cfg, pos, pad_lens,
                                               layers=layers)
        pos += 1
        logp = _log_softmax_host(logits)                                 # [B, V]
        candidates = [(s, ids, True, row) for s, ids, _, row in done]
        for i, (score, ids, _, _) in enumerate(live):
            row = logp[i].copy()
            for b in _banned_next_tokens(ids, no_repeat_ngram_size):
                row[b] = -np.inf
            for t in np.argsort(-row)[:B]:
                fin = eos_token_id is not None and int(t) == eos_token_id
                candidates.append((score + float(row[t]), ids + [int(t)], fin, i))
        candidates.sort(key=lambda c: c[0], reverse=True)
        beams = candidates[:B]
    return np.asarray(beams[0][1])


def generate_response(prompt: str, params, cfg: LlamaConfig, tokenizer, max_length: int = 512,
                      num_beams: int = 5) -> str:
    """``prompt`` -> its continuation's text (prompt included), by beam search
    (greedy for ``num_beams=1``), stopping at the tokenizer's eos id if it has one."""
    enc = tokenizer(prompt, add_special_tokens=True)["input_ids"]
    eos = getattr(tokenizer, "eos_token_id", None)
    if num_beams > 1:
        out = beam_generate(params, cfg, np.asarray(enc), max_length=max_length,
                            num_beams=num_beams, eos_token_id=eos)
    else:
        out = greedy_generate(params, cfg, np.asarray(enc), max_length=max_length,
                              eos_token_id=eos)
    return tokenizer.decode(out.tolist(), skip_special_tokens=True)


def qualitative_results(params, cfg: LlamaConfig, model_name_or_dir: str,
                        max_length: int = 64) -> Optional[List[Tuple[str, str]]]:
    """Log the responses to the JAX package's two prompts, with the tokenizer of
    ``model_name_or_dir``; return the (prompt, response) pairs, or None (with
    the JAX package's warning) when the directory has no usable tokenizer."""
    from ssp_x_vit_tpu_torch.llm.tokenizer import load_tokenizer

    try:
        tokenizer = load_tokenizer(model_name_or_dir)
    except (NotImplementedError, ValueError, OSError) as e:
        logging.warning(f"Tokenizer unavailable ({e}); skipping qualitative results")
        return None
    results = []
    for prompt in ("Who is Albert Einstein?", "The theory of relativity"):
        logging.info(f"Prompt: {prompt}")
        logging.info("-" * 20)
        response = generate_response(prompt, params, cfg, tokenizer, max_length)
        logging.info(response)
        results.append((prompt, response))
    return results
