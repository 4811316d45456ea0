"""Perplexity and timing evaluation for the LLM path (counterpart of
``ssp_x_vit_tpu/llm/evaluation.py``; reference src/evaluation.py:9-64, 119-146).

``evaluate_perplexity``: fixed ``seq_len``-token windows, global token-mean
NLL, for gated / masked and for depth-materialized models. The stage-2
candidate loop only changes gate values: ``evaluate_perplexity_candidates``
scores a chunk of skip patterns as one batch (``[C, 1, 1]`` gates per layer
over C copies of the window). NLL sums stay on the device and come to the
host once per window. DeepSeek/MLA models evaluate through ``llm/deepseek.py``'s
forwards in fp32, as the JAX package's ``_window_nll_deepseek*`` do.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from ssp_x_vit_tpu_torch.llm.model import (
    LlamaConfig, llama_forward, llama_forward_materialized, require_llama_config,
)


def _param_device(params) -> torch.device:
    return params["embed"].device


def _deepseek_logits(params, tokens, cfg, attn_gate=None, mlp_gate=None) -> torch.Tensor:
    """fp32 logits of a DeepSeek/MLA model (gated, or materialized)."""
    from ssp_x_vit_tpu_torch.llm.deepseek import deepseek_forward, deepseek_forward_materialized

    if cfg.pruned_attention_blocks:
        return deepseek_forward_materialized(params, tokens, cfg, compute_dtype=torch.float32)
    return deepseek_forward(params, tokens, cfg, compute_dtype=torch.float32,
                            attn_gate=attn_gate, mlp_gate=mlp_gate)


def _nll_sums(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Summed next-token NLL per batch row: logits [b, s, V] fp32, tokens [b, s] -> [b]."""
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    nll = -torch.gather(logp, -1, tokens[:, 1:, None].long())[..., 0]
    return nll.sum(dim=1)


def _as_device_f32(a, device) -> Optional[torch.Tensor]:
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.asarray(a, np.float32)).to(device)


@torch.no_grad()
def evaluate_perplexity_candidates(
    params,
    cfg: LlamaConfig,
    input_ids: np.ndarray,
    attn_gates: np.ndarray,
    mlp_gates: Optional[np.ndarray] = None,
    *,
    seq_len: int = 2048,
    chunk: int = 8,
    compute_dtype=torch.bfloat16,
) -> np.ndarray:
    """Perplexity of C gate candidates over the calibration stream -> [C].

    ``attn_gates`` / ``mlp_gates`` are ``[C, L]``. Candidates are evaluated
    ``chunk`` at a time as one batch (``chunk=1``: one at a time, same numbers
    up to the matmuls' summation order); all windows stream through each chunk.
    DeepSeek/MLA models run in fp32 whatever ``compute_dtype`` says.
    """
    from ssp_x_vit_tpu_torch.llm.deepseek import is_deepseek

    mla = is_deepseek(cfg)
    if not mla:
        require_llama_config(cfg)
    device = _param_device(params)
    ids = np.asarray(input_ids).reshape(-1)
    num_samples = ids.size // seq_len
    C, L = np.asarray(attn_gates).shape
    ga = _as_device_f32(attn_gates, device)
    gm = _as_device_f32(mlp_gates if mlp_gates is not None else np.ones((C, L)), device)

    totals = torch.zeros(C, dtype=torch.float64, device=device)
    for i in range(num_samples):
        window = torch.from_numpy(ids[i * seq_len:(i + 1) * seq_len].astype(np.int64)).to(device)
        for c0 in range(0, C, chunk):
            c1 = min(C, c0 + chunk)
            tokens = window[None].expand(c1 - c0, -1)
            # [c, L] -> [L, c, 1, 1]: row c of the batch runs under candidate c's gates
            gates = (ga[c0:c1].t()[:, :, None, None], gm[c0:c1].t()[:, :, None, None])
            if mla:
                logits = _deepseek_logits(params, tokens, cfg, *gates)
            else:
                logits, _ = llama_forward(params, tokens, cfg, attn_gate=gates[0],
                                          mlp_gate=gates[1], compute_dtype=compute_dtype)
            totals[c0:c1] += _nll_sums(logits, tokens).double()
    tokens_per_window = seq_len - 1
    return np.exp(totals.cpu().numpy() / max(1, num_samples * tokens_per_window))


@torch.no_grad()
def evaluate_perplexity(
    params,
    cfg: LlamaConfig,
    input_ids: np.ndarray,
    *,
    seq_len: int = 2048,
    batch_size: int = 1,
    attn_gate=None,
    mlp_gate=None,
    neuron_mask=None,
    enable_tqdm: bool = True,
    compute_dtype=torch.bfloat16,
) -> float:
    """Perplexity over ``input_ids`` ([1, N] or [N]) in ``seq_len`` windows:
    exp of the global token-mean NLL (the reference's running weighted mean
    of per-window means is the same value). ``compute_dtype`` is the
    forward's (the JAX function always runs bf16); DeepSeek/MLA models run in
    fp32 and take no ``neuron_mask``, as in the JAX package."""
    from ssp_x_vit_tpu_torch.llm.deepseek import is_deepseek

    mla = is_deepseek(cfg)
    if mla and neuron_mask is not None:
        raise ValueError("neuron masks don't apply to the MLA family "
                         "(stage-1 width materializes directly)")
    if not mla:
        require_llama_config(cfg)
    device = _param_device(params)
    ids = np.asarray(input_ids).reshape(-1)
    num_samples = ids.size // seq_len
    if num_samples == 0:
        raise ValueError(f"need at least {seq_len} tokens, got {ids.size}")
    ga = _as_device_f32(attn_gate, device)
    gm = _as_device_f32(mlp_gate, device)
    nm = _as_device_f32(neuron_mask, device)

    materialized = bool(cfg.pruned_attention_blocks)
    total_nll, total_tokens = 0.0, 0
    for i in range(0, num_samples, batch_size):
        j = min(i + batch_size, num_samples)
        window = ids[i * seq_len:j * seq_len].reshape(j - i, seq_len)
        tokens = torch.from_numpy(window.astype(np.int64)).to(device)
        if mla:
            logits = _deepseek_logits(params, tokens, cfg, ga, gm)
        elif materialized:
            logits = llama_forward_materialized(params, tokens, cfg, compute_dtype=compute_dtype)
        else:
            logits, _ = llama_forward(params, tokens, cfg, attn_gate=ga, mlp_gate=gm,
                                      neuron_mask=nm, compute_dtype=compute_dtype)
        total_nll += float(_nll_sums(logits, tokens).sum())  # one host sync per window
        total_tokens += (j - i) * (seq_len - 1)
    return float(np.exp(total_nll / max(1, total_tokens)))


def evaluation_ppl(params, cfg, wikitext_ids, c4_ids, fineweb_ids, seq_len=2048,
                   attn_gate=None, mlp_gate=None):
    """Three-corpus perplexity suite (reference src/evaluation.py:9-17)."""
    out = {}
    for name, ids in (("wikitext2", wikitext_ids), ("c4", c4_ids), ("fineweb-edu", fineweb_ids)):
        if ids is None:
            continue
        ppl = evaluate_perplexity(params, cfg, ids, seq_len=seq_len,
                                  attn_gate=attn_gate, mlp_gate=mlp_gate)
        logging.info(f"Perplexity ({name}): {ppl}")
        out[name] = ppl
    return out


@torch.no_grad()
def evaluate_inference_time(params, cfg: LlamaConfig, sample: np.ndarray,
                            warmup: int = 10, iters: int = 10) -> float:
    """Mean forward latency (ms) over one sample (reference
    src/evaluation.py:119-146): CUDA events on the card, the host clock on the CPU."""
    from ssp_x_vit_tpu_torch.evaluation.latency import measure_latency_fn
    from ssp_x_vit_tpu_torch.llm.generate import full_logits

    device = _param_device(params)
    tokens = torch.from_numpy(np.asarray(sample).reshape(1, -1).astype(np.int64)).to(device)

    def fwd():
        return full_logits(params, tokens, cfg, torch.bfloat16)

    return measure_latency_fn(fwd, device, warmup=1, iters=max(1, iters))
