"""EvoPress depth-pruning baseline on PyTorch (counterpart of
``ssp_x_vit_tpu/llm/evopress.py``; reference src/evopress.py, itself adapted
from IST-DASLab/EvoPress, config as drop_search.sh): an evolutionary search
over (attn, mlp) binary block masks whose fitness is the token-mean
KL(dense || candidate) over a token-budgeted minibatch.

Candidates flip gate values on the gated ``llama_forward`` (no re-slicing),
one candidate and one window per forward, as the JAX package does; the dense
target logits are computed once per calibration window. They stay on the
card in fp32 when they take at most half of its free memory, and go to pinned
host memory otherwise, copied back one window at a time. The KL sums of a
candidate stay on the device and come to the host once per candidate. The
``random.Random(seed)`` stream is consumed call for call as in the JAX
module, so the same fitnesses give the same candidates.
"""

from __future__ import annotations

import copy
import random
import time
import warnings
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ssp_x_vit_tpu_torch.llm.model import (
    LlamaConfig, Params, llama_forward, require_llama_config,
)

DEFAULT_ARGS = dict(
    calibration_tokens=131072,
    calibration_sequence_length=8192,
    offspring=32,
    population_size=1,
    initially_generated=64,
    initial_tokens=2048,
    survivors_per_selection=(2, 1),
    tokens_per_selection=(2048, 32768),
    max_mutations=3,
)


def collect_samples_with_join(documents, num_samples: int,
                              sequence_length: int,
                              separator_ids=()) -> List[np.ndarray]:
    """The reference's sample-joining calibration windows (src/evopress.py:13-49):
    documents (token id arrays) concatenate into a running window; when the
    window reaches ``sequence_length`` it is trimmed to exactly that length
    and emitted (the reference notes this trim's bias; kept), otherwise
    ``separator_ids`` (the reference's tokenized "\\n\\n") append before the
    next document. Stops after ``num_samples`` windows or when documents run
    out. Returns [1, sequence_length] int32 arrays."""
    sep = np.asarray(separator_ids, np.int32).reshape(-1)
    out: List[np.ndarray] = []
    current = np.zeros((0,), np.int32)
    for doc in documents:
        toks = np.asarray(doc, np.int32).reshape(-1)
        current = np.concatenate([current, toks])
        if current.size >= sequence_length:
            out.append(current[:sequence_length].reshape(1, -1).copy())
            current = np.zeros((0,), np.int32)
        else:
            current = np.concatenate([current, sep])
        if len(out) >= num_samples:
            break
    return out


def _tokens(sample, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(sample).reshape(1, -1).astype(np.int64)).to(device)


def _logits(params, tokens, attn_gate, mlp_gate, cfg: LlamaConfig, compute_dtype):
    """Gated forward -> fp32 logits, llama or MLA (both families take
    attention / MLP gates)."""
    from ssp_x_vit_tpu_torch.llm.deepseek import deepseek_forward, is_deepseek

    if is_deepseek(cfg):
        return deepseek_forward(params, tokens, cfg, attn_gate=attn_gate, mlp_gate=mlp_gate,
                                compute_dtype=compute_dtype)
    require_llama_config(cfg)
    return llama_forward(params, tokens, cfg, attn_gate=attn_gate, mlp_gate=mlp_gate,
                         compute_dtype=compute_dtype)[0]


def _kl_sum(params, tokens, target_logits, attn_gate, mlp_gate, cfg, compute_dtype):
    """Sum over positions of KL(target || candidate) and the position count,
    the last position excluded (reference :70-71)."""
    logits = _logits(params, tokens, attn_gate, mlp_gate, cfg, compute_dtype)
    lp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    lt = torch.log_softmax(target_logits[:, :-1].float(), dim=-1)
    kl = torch.sum(torch.exp(lt) * (lt - lp), dim=-1)  # [b, s-1]
    return kl.sum(), kl.numel()


@torch.no_grad()
def compute_kl_div(params, cfg, data, target_logits, attn_mask, mlp_mask, *,
                   compute_dtype=torch.bfloat16) -> float:
    """Token-mean KL over samples (reference compute_kl_div, 'batchmean' over
    positions). ``target_logits`` may lie on the device or in host memory."""
    device = params["embed"].device
    ga = torch.from_numpy(1.0 - np.asarray(attn_mask, np.float32)).to(device)
    gm = torch.from_numpy(1.0 - np.asarray(mlp_mask, np.float32)).to(device)
    total = torch.zeros((), dtype=torch.float64, device=device)
    count = 0
    for tokens, target in zip(data, target_logits):
        s, n = _kl_sum(params, _tokens(tokens, device), target.to(device, non_blocking=True),
                       ga, gm, cfg, compute_dtype)
        total += s.double()   # as the JAX loop's Python float sum of fp32 values
        count += n
    return float(total) / max(1, count)


def selection(
    params, cfg,
    candidates: List[Dict[str, List[int]]],
    num_survive: int,
    calibration_data: List[np.ndarray],
    num_tokens: int,
    target_logits: List[torch.Tensor],
    rng: random.Random,
    verbose: bool = False,
    *,
    compute_dtype=torch.bfloat16,
    history: Optional[List[dict]] = None,
) -> Tuple[List[Dict[str, List[int]]], List[float]]:
    """Fitness on a freshly drawn minibatch of exactly ``num_tokens`` tokens
    (reference :103-143). ``history``, when given, receives one record per
    call: the minibatch's window ids and tokens, the number of candidates
    scored, every candidate's fitness in ascending order (the survivors
    first) and the seconds."""
    t0 = time.perf_counter()
    requested_tokens = num_tokens
    # Cap the budget at what the calibration set holds, or the draw loop never
    # ends (the reference assumes 131k tokens); the cap changes the selection
    # pressure against the reference protocol, so it warns.
    available = sum(np.asarray(c).size for c in calibration_data)
    if num_tokens > available:
        warnings.warn(
            f"EvoPress selection budget capped: requested {num_tokens} tokens "
            f"but calibration set holds only {available}; selection pressure "
            "differs from the reference protocol (which assumes 131k tokens).",
            stacklevel=2,
        )
        num_tokens = available

    minibatch, minibatch_targets, minibatch_ids = [], [], []
    tokens_used = 0
    while tokens_used < num_tokens:
        mid = rng.randint(0, len(calibration_data) - 1)
        if mid in minibatch_ids:
            continue
        minibatch_ids.append(mid)
        sample = np.asarray(calibration_data[mid]).reshape(1, -1)
        take = min(sample.shape[1], num_tokens - tokens_used)
        minibatch.append(sample[:, :take])
        minibatch_targets.append(target_logits[mid][:, :take])
        tokens_used += take

    if verbose:
        print(f"[evopress] selection: candidates={len(candidates)} survive={num_survive} "
              f"effective_tokens={tokens_used} requested_tokens={requested_tokens}")

    fitnesses = [
        compute_kl_div(params, cfg, minibatch, minibatch_targets, c["attn"], c["mlp"],
                       compute_dtype=compute_dtype)
        for c in candidates
    ]
    order = np.argsort(fitnesses)
    best = order[:num_survive]
    if history is not None:
        history.append({"minibatch_ids": list(minibatch_ids), "tokens": tokens_used,
                        "candidates": len(candidates),
                        "fitnesses": [fitnesses[i] for i in order],
                        "seconds": time.perf_counter() - t0})
    return [candidates[i] for i in best], [fitnesses[i] for i in best]


def _target_host(n_bytes: int, device: torch.device) -> bool:
    """Whether the dense target logits go to pinned host memory: on the card
    only when they would take more than half of its free memory."""
    return device.type == "cuda" and n_bytes > torch.cuda.mem_get_info(device)[0] // 2


@torch.no_grad()
def evopress(
    params: Params,
    cfg: LlamaConfig,
    num_prune: int,
    calibration_data: List[np.ndarray],
    *,
    drop_entire_block: bool = False,
    args: Optional[dict] = None,
    seed: int = 0,
    num_generations: Optional[int] = None,
    verbose: bool = True,
    compute_dtype=torch.bfloat16,
    on_phase: Optional[Callable[[Optional[str]], None]] = None,
    history: Optional[List[dict]] = None,
):
    """Returns the attn mask (``drop_entire_block``) or the (attn, mlp) masks.

    ``calibration_data`` is a list of [1, seq] token windows. ``on_phase`` is
    called with ``"targets"`` (the dense forwards) and ``"selection"`` as they
    start; ``history`` receives first ``{"target_bytes", "target_device"}``,
    then one record per selection (see :func:`selection`), each tagged with
    its generation (0: the initial population)."""
    from ssp_x_vit_tpu_torch.llm.deepseek import is_deepseek

    if not is_deepseek(cfg):
        require_llama_config(cfg)
    on_phase = on_phase or (lambda name: None)
    a = dict(DEFAULT_ARGS)
    if args:
        a.update(args)
    rng = random.Random(seed)
    L = cfg.num_layers
    if num_generations is None:
        num_generations = int(num_prune * (L - num_prune) / 1.5)  # EvoPress Table 8
    device = params["embed"].device

    # Dense target logits once (reference :187-190)
    on_phase("targets")
    n_bytes = sum(np.asarray(c).size for c in calibration_data) * cfg.vocab_size * 4
    to_host = _target_host(n_bytes, device)
    target_logits = []
    for c in calibration_data:
        logits = _logits(params, _tokens(c, device), None, None, cfg, compute_dtype)
        if to_host:
            logits = torch.empty(logits.shape, dtype=logits.dtype, pin_memory=True).copy_(logits)
        target_logits.append(logits)
    where = "host (pinned)" if to_host else str(device)
    records: List[dict] = [{"target_bytes": n_bytes, "target_device": where}]

    def select(gen, candidates, num_survive, num_tokens):
        sel = selection(params, cfg, candidates, num_survive, calibration_data, num_tokens,
                        target_logits, rng, verbose=verbose, compute_dtype=compute_dtype,
                        history=records)
        records[-1]["generation"] = gen
        return sel

    on_phase("selection")
    initial: List[Dict[str, List[int]]] = []
    while len(initial) < a["initially_generated"]:
        cand = {"attn": [0] * L, "mlp": [0] * L}
        for ind in rng.sample(range(L), num_prune):
            cand["attn"][ind] = 1
        for ind in rng.sample(range(L), num_prune):
            cand["mlp"][ind] = 1
        if drop_entire_block:
            cand["mlp"] = copy.deepcopy(cand["attn"])
        if cand in initial:
            continue
        initial.append(cand)

    population, train_fitnesses = select(0, initial, a["population_size"], a["initial_tokens"])

    best_individual = population[0]
    for gen_id in range(num_generations):
        if verbose:
            print(f"Generation {gen_id + 1}/{num_generations}")
            print(f"Train fitness {train_fitnesses[0]:.2e}")

        offspring_list: List[Dict[str, List[int]]] = []
        while len(offspring_list) < a["offspring"]:
            offspring = copy.deepcopy(rng.choice(population))
            num_flips = min(rng.randint(1, a["max_mutations"]),
                            rng.randint(1, a["max_mutations"]))  # bias to low
            for _ in range(num_flips):
                subblock = "attn" if rng.randint(0, 1) == 0 else "mlp"
                remove_ind = rng.randint(0, L - 1)
                while offspring[subblock][remove_ind] == 1:
                    remove_ind = rng.randint(0, L - 1)
                add_ind = rng.randint(0, L - 1)
                while offspring[subblock][add_ind] == 0:
                    add_ind = rng.randint(0, L - 1)
                offspring[subblock][remove_ind] = 1
                offspring[subblock][add_ind] = 0
            if drop_entire_block:
                offspring["mlp"] = copy.deepcopy(offspring["attn"])
            if offspring in offspring_list or offspring in population:
                continue
            offspring_list.append(offspring)

        for num_survive, num_tokens in zip(a["survivors_per_selection"],
                                           a["tokens_per_selection"]):
            if num_survive == a["survivors_per_selection"][-1]:
                for p in population:  # elitism into the final selection step
                    if p not in offspring_list:
                        offspring_list.append(p)
            offspring_list, train_fitnesses = select(gen_id + 1, offspring_list, num_survive,
                                                     num_tokens)

        population = offspring_list
        best_individual = population[0]

    on_phase(None)
    if history is not None:
        history.extend(records)
    if drop_entire_block:
        return best_individual["attn"]
    return best_individual["attn"], best_individual["mlp"]
