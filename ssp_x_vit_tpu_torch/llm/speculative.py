"""Self-speculative decoding: a 2SSP-pruned draft accelerates its own dense
model (counterpart of ``ssp_x_vit_tpu/llm/speculative.py``).

Greedy speculative decoding makes the composite exactly equal to dense greedy
decoding: the draft proposes ``k`` tokens, one dense forward over the
k+1-token window verifies them, and the longest agreeing prefix plus the dense
model's own next token are accepted. Stale cache slots are overwritten before
any query can attend to them (causal masking only exposes keys at positions
<= the query), plus one repair write per round for the fully-accepted case
(see ``draft_k``).

The propose / verify / accept loop is a Python loop on the device of the
parameters, with one host sync per round: the accepted count, which sets the
next round's position. b=1 streams, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ssp_x_vit_tpu_torch.llm.model import LlamaConfig, Params, _embed_tokens
from ssp_x_vit_tpu_torch.llm.serve import (
    _decode_body, _final_logits, _run_layers, cache_compute_dtype, init_cache, prefill,
    split_layers,
)


def _extend_body(params: Params, tokens: torch.Tensor, cache_k, cache_v, cfg: LlamaConfig,
                 write_pos: int, layers=None):
    """Multi-token cached forward: tokens ``[1, w]`` at global positions
    ``write_pos + arange(w)``; returns logits at all w positions [1, w, V]."""
    compute_dtype = cache_compute_dtype(cache_k)
    b, w = tokens.shape
    x = _embed_tokens(params, tokens, cfg, compute_dtype)
    global_positions = (write_pos + torch.arange(w, device=tokens.device))[None].expand(b, w)
    pad_lens = torch.zeros((b,), dtype=torch.int64, device=tokens.device)
    x, cache_k, cache_v = _run_layers(
        params, x, cache_k, cache_v, cfg, global_positions=global_positions,
        rope_positions=global_positions, pad_lens=pad_lens, write_pos=write_pos,
        compute_dtype=compute_dtype, layers=layers)
    return _final_logits(params, x, cfg, compute_dtype), cache_k, cache_v


@torch.no_grad()
def spec_decode_scan(dense_params: Params, draft_params: Params, first_token: torch.Tensor,
                     prev_token: torch.Tensor, dense_ck, dense_cv, draft_ck, draft_cv,
                     dense_cfg: LlamaConfig, draft_cfg: LlamaConfig, start_pos: int, k: int,
                     max_steps: int):
    """Generate ``max_steps`` greedy tokens by draft-k / verify-1 rounds.
    ``first_token`` [1] is the dense model's greedy token after prefill
    (already part of the output); ``prev_token`` [1] is the last prompt token
    (sequence index ``start_pos - 1``, re-written by every draft round, see
    ``draft_k``); both caches hold the prompt and continue at ``start_pos``.

    Returns (tokens [n >= max_steps + 1] on the device, first ``max_steps + 1``
    valid with ``first_token`` leading, rounds, accepted draft tokens)."""
    device = first_token.device
    dense_layers, draft_layers = split_layers(dense_params, dense_cfg), \
        split_layers(draft_params, draft_cfg)
    pad0 = torch.zeros((1,), dtype=torch.int64, device=device)

    def draft_k(prev, tok, ck, cv, pos):
        """Propose k tokens. The first step is a 2-token extend over
        [prev @ pos-1, tok @ pos]: re-writing pos-1 repairs the draft-cache
        hole a fully-accepted round leaves (the k-th draft's K/V is never
        written while drafting)."""
        lg2, ck, cv = _extend_body(draft_params, torch.cat([prev, tok])[None], ck, cv,
                                   draft_cfg, pos - 1, draft_layers)
        drafts = [lg2[:, 1].argmax(dim=-1)]
        p = pos + 1
        for _ in range(k - 1):
            logits, ck, cv = _decode_body(draft_params, drafts[-1], ck, cv, draft_cfg, p, pad0,
                                          layers=draft_layers)
            drafts.append(logits.argmax(dim=-1))
            p += 1
        return torch.cat(drafts), ck, cv                                 # [k]

    out = [first_token]
    n_out, prev, nxt, pos = 1, prev_token, first_token, int(start_pos)
    rounds = accepted = 0
    while n_out < 1 + max_steps:
        drafts, draft_ck, draft_cv = draft_k(prev, nxt, draft_ck, draft_cv, pos)
        window = torch.cat([nxt, drafts])                                # [k + 1]
        logits, dense_ck, dense_cv = _extend_body(dense_params, window[None], dense_ck, dense_cv,
                                                  dense_cfg, pos, dense_layers)
        ys = logits[0].argmax(dim=-1)                                    # [k + 1]
        m = int(torch.cumprod((drafts == ys[:k]).to(torch.int64), 0).sum())  # the round's sync
        out.append(torch.cat([drafts[:m], ys[m:m + 1]]))
        n_acc = m + 1
        prev, nxt = window[m:m + 1], ys[m:m + 1]   # the token at index pos + n_acc - 1, and the next
        n_out += n_acc
        pos += n_acc
        rounds += 1
        accepted += m
    return torch.cat(out), rounds, accepted


@torch.no_grad()
def speculative_generate(dense_params: Params, dense_cfg: LlamaConfig, draft_params: Params,
                         draft_cfg: LlamaConfig, input_ids, *, max_length: int = 64, k: int = 4,
                         eos_token_id: Optional[int] = None,
                         cache_dtype=torch.bfloat16) -> Tuple[np.ndarray, dict]:
    """Greedy generation from the DENSE model, accelerated by the draft, on
    the device of ``dense_params``. The output is exactly
    ``serve.generate_kv_scan(dense_params, ...)``'s greedy result. Returns
    (tokens, stats) with stats = {rounds, accepted_drafts, acceptance_rate}."""
    device = dense_params["embed"].device
    prompt = np.asarray(input_ids, np.int64).reshape(1, -1)
    p = prompt.shape[1]
    if p >= max_length:
        raise ValueError("prompt longer than max_length")
    max_steps = max_length - p
    cache_len = p + max_steps + k + 2

    dck, dcv = init_cache(dense_cfg, 1, cache_len, cache_dtype, device)
    fck, fcv = init_cache(draft_cfg, 1, cache_len, cache_dtype, device)
    pad0 = torch.zeros((1,), dtype=torch.int64, device=device)
    tokens = torch.as_tensor(prompt, device=device)
    logits, dck, dcv = prefill(dense_params, tokens, dck, dcv, dense_cfg, pad0)
    _, fck, fcv = prefill(draft_params, tokens, fck, fcv, draft_cfg, pad0)
    first = logits.argmax(dim=-1)                                        # [1]

    out, rounds, accepted = spec_decode_scan(
        dense_params, draft_params, first, tokens[:, -1], dck, dcv, fck, fcv, dense_cfg,
        draft_cfg, p, k, max_steps - 1)
    gen = out.cpu().numpy()[:max_steps].tolist()
    if eos_token_id is not None and eos_token_id in gen:
        gen = gen[: gen.index(eos_token_id) + 1]
    stats = {"rounds": rounds, "accepted_drafts": accepted,
             "acceptance_rate": float(accepted) / max(1, rounds * k)}
    return np.asarray(prompt[0].tolist() + gen, np.int32), stats
