"""LLM structured-pruning methods: 2SSP and the depth-pruning baselines
(counterpart of ``ssp_x_vit_tpu/llm/pruning.py``; reference src/pruning.py,
src/utilities.py).

All search phases run on the same forward via gate and mask arguments:

- ``two_stage_2ssp``: stage 1 prunes FFN neurons by the mean over samples of
  the L2 norm over tokens of the down_proj input, collected as a side output
  of the forward; stage 2 greedily removes the attention submodule that
  minimizes 1-sample perplexity by flipping gate values.
- ``window_based`` (sliding-window cosine similarity), ``shortgpt`` (block
  influence 1 - cos(in, out)), ``blockpruner`` (greedy attention-or-MLP
  submodule removal). EvoPress, SliceGPT and the ablation variants of 2SSP
  are ``llm/evopress.py``, ``llm/slicegpt.py`` and ``llm/ablations.py``.

DeepSeek/MLA configs take the same methods through ``llm/deepseek.py``'s
forward and ``llm/pruning_deepseek.py``'s surgery, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ssp_x_vit_tpu_torch.llm.evaluation import (
    evaluate_perplexity, evaluate_perplexity_candidates,
)
from ssp_x_vit_tpu_torch.llm import pruning_deepseek as PD
from ssp_x_vit_tpu_torch.llm.deepseek import deepseek_forward, is_deepseek
from ssp_x_vit_tpu_torch.llm.model import (
    LlamaConfig, Params, llama_forward, require_llama_config,
)

def _tokens(sample, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(sample).reshape(1, -1).astype(np.int64)).to(device)


def count_main_params(cfg: LlamaConfig) -> Tuple[int, int, int]:
    """(main_layers_total, attn_per_block, mlp_per_block): the reference counts
    model.model.layers / self_attn / mlp parameters (src/pruning.py:234-241),
    norm scales included in the block total."""
    if is_deepseek(cfg):
        return PD.count_main_params_deepseek(cfg)
    require_llama_config(cfg)
    d, f = cfg.hidden_size, cfg.effective_intermediate
    hq = cfg.num_heads * cfg.head_dim
    hkv = cfg.num_kv_heads * cfg.head_dim
    if cfg.is_phi or cfg.is_opt:
        attn = (d * hq + hq) + 2 * (d * hkv + hkv) + (hq * d + d)  # q/k/v/dense + biases
        mlp = (d * f + f) + (f * d + d)                            # fc1/fc2 + biases
        # phi: one shared LayerNorm; opt: two LayerNorms (scale + bias each)
        per_block_other = 4 * d if cfg.is_opt else 2 * d
    else:
        attn = d * hq + 2 * d * hkv + hq * d
        if cfg.qkv_bias:
            attn += hq + 2 * hkv
        mlp = d * f + d * f + f * d  # gate + up + down projections
        per_block_other = 2 * d      # two RMSNorm scales
    main = cfg.num_layers * (attn + mlp + per_block_other)
    main -= len(cfg.pruned_attention_blocks) * attn  # exclude depth-pruned attention
    return main, attn, mlp


@torch.no_grad()
def mlp_hidden_importance(params: Params, cfg: LlamaConfig,
                          calibration: Sequence[np.ndarray], *,
                          compute_dtype=torch.bfloat16) -> np.ndarray:
    """Mean over samples of the token-L2 of down_proj inputs: [L, f]
    (reference src/pruning.py:270-279). The sum over samples stays on the
    device and comes to the host once."""
    device = params["embed"].device
    mla = is_deepseek(cfg)
    if not mla:
        require_llama_config(cfg)
    sums = None
    for sample in calibration:
        fwd = deepseek_forward if mla else llama_forward
        _, aux = fwd(params, _tokens(sample, device), cfg, collect_mlp_stats=True,
                     compute_dtype=compute_dtype)
        norms = torch.sqrt(aux["mlp_stats"][:, 0, :])  # [L, f]
        sums = norms if sums is None else sums + norms
    return sums.cpu().numpy() / max(1, len(calibration))


def materialize_llm_width_pruning(
    params: Params, cfg: LlamaConfig, keep_indices: Sequence[np.ndarray]
) -> Tuple[Params, LlamaConfig]:
    """Slice gate/up columns and down rows to the kept neurons per block
    (reference prune_mlp, src/utilities.py:392-425). Uniform keep count; the
    gather runs on the parameters' device."""
    if is_deepseek(cfg):
        return PD.materialize_deepseek_width_pruning(params, cfg, keep_indices)
    require_llama_config(cfg)
    keeps = [np.asarray(k) for k in keep_indices]
    n_keep = len(keeps[0])
    if any(len(k) != n_keep for k in keeps):
        raise ValueError("2SSP LLM stage-1 keeps a uniform width")
    blocks = dict(params["blocks"])
    device = params["embed"].device
    idx = torch.from_numpy(np.stack(keeps).astype(np.int64)).to(device)  # [L, n_keep]

    def take(kernel, dim):  # keep idx[l] along `dim` of layer l, one layer at a time
        shape = list(kernel.shape)
        shape[dim + 1] = n_keep
        out = kernel.new_empty(shape)
        for layer in range(kernel.shape[0]):
            torch.index_select(kernel[layer], dim, idx[layer], out=out[layer])
        return out

    def cols(kernel):  # [L, d, F] keep columns
        return take(kernel, 1)

    def rows(kernel):  # [L, F, d] keep rows
        return take(kernel, 0)

    if cfg.is_phi or cfg.is_opt:
        blocks["fc1_kernel"] = cols(blocks["fc1_kernel"])
        blocks["fc1_bias"] = torch.gather(blocks["fc1_bias"], 1, idx)
        blocks["fc2_kernel"] = rows(blocks["fc2_kernel"])
    else:
        blocks["gate_kernel"] = cols(blocks["gate_kernel"])
        blocks["up_kernel"] = cols(blocks["up_kernel"])
        blocks["down_kernel"] = rows(blocks["down_kernel"])

    new_params = dict(params)
    new_params["blocks"] = blocks
    return new_params, dataclasses.replace(cfg, pruned_intermediate_size=n_keep)


# ---------------------------------------------------------------------------
# 2SSP (reference src/pruning.py:228-294)
# ---------------------------------------------------------------------------

def second_stage_attention(
    params: Params,
    cfg: LlamaConfig,
    num_prune: int,
    calibration_input_ids: np.ndarray,
    *,
    seq_len: int = 2048,
    compute_dtype=torch.bfloat16,
) -> Tuple[List[int], List[int]]:
    """Greedy attention-submodule removal minimizing perplexity
    (reference src/utilities.py:446-505). Returns (attnMask, mlpMask)."""
    L = cfg.num_layers
    attn_mask = [0] * L
    mlp_mask = [0] * L

    ppl = evaluate_perplexity(params, cfg, calibration_input_ids, seq_len=seq_len,
                              enable_tqdm=False, compute_dtype=compute_dtype)
    logging.debug(f"Original perplexity: {ppl}")

    for _ in range(num_prune):
        # score all remaining candidates of this round in batched chunks
        cands = [c for c in range(L) if attn_mask[c] == 0]
        gates = np.ones((len(cands), L), np.float32)
        for row, c in enumerate(cands):
            gates[row] = 1.0 - np.asarray(attn_mask, np.float32)
            gates[row, c] = 0.0
        ppls = evaluate_perplexity_candidates(
            params, cfg, calibration_input_ids, gates, seq_len=seq_len,
            compute_dtype=compute_dtype)
        for c, p in zip(cands, ppls):
            logging.debug(f"[Attention] When pruning {c} perplexity is {p}")
        best_idx = int(np.argmin(ppls))  # first minimum, like the reference '<'
        best_to_prune = cands[best_idx]
        logging.debug(f"[Attention] Best to prune: {best_to_prune} ({ppls[best_idx]})")
        attn_mask[best_to_prune] = 1

    return attn_mask, mlp_mask


def two_stage_2ssp(
    params: Params,
    cfg: LlamaConfig,
    calibration: Sequence[np.ndarray],
    pruning_rate: float,
    *,
    num_attn_submodules_to_prune: Optional[int] = None,
    alpha: float = 1.5,
    num_calibration_second_stage: int = 1,
    seq_len: int = 2048,
    on_phase: Optional[Callable[[str], None]] = None,
    compute_dtype=torch.bfloat16,
):
    """Full 2SSP (reference src/pruning.py:228-294). Returns
    (params, cfg, info) with the width materialized and the attention
    depth-pruned, or False when the rate cannot be reached. ``on_phase`` is
    called with the name of each phase as it starts (stats, stage1,
    candidates, materialize), for callers that time or count per phase.
    ``compute_dtype`` is the forwards' (the JAX function always runs bf16)."""
    on_phase = on_phase or (lambda name: None)
    L = cfg.num_layers
    main_total, attn_total, mlp_total = count_main_params(cfg)
    logging.debug(f"Main model params={main_total}, attn/block={attn_total}, mlp/block={mlp_total}")

    if num_attn_submodules_to_prune is None:
        num_attn_submodules_to_prune = round(
            L * pow(pruning_rate, (mlp_total / attn_total) / alpha)
        )
    logging.info(f"Pruning {num_attn_submodules_to_prune} attention submodules")

    if (num_attn_submodules_to_prune * attn_total) / main_total > pruning_rate:
        logging.error("Exceeded pruning parameters number")
        return False
    if (num_attn_submodules_to_prune * attn_total + L * mlp_total) / main_total < pruning_rate:
        logging.error(
            f"Unable to reach the target sparsity rate with only "
            f"{num_attn_submodules_to_prune} pruned attention submodules")
        return False

    # Stage 1: FFN width (reference :260-286)
    parameters_pruned_for_attention = num_attn_submodules_to_prune * attn_total
    target_parameters_to_prune = int(round(pruning_rate * main_total))
    mlp_params_to_prune = int(round(
        (target_parameters_to_prune - parameters_pruned_for_attention) / L))
    mlp_pruning_rate = mlp_params_to_prune / mlp_total
    num_preserve = int(round(cfg.intermediate_size * (1 - mlp_pruning_rate)))

    on_phase("stats")
    importance = mlp_hidden_importance(params, cfg, calibration,
                                       compute_dtype=compute_dtype)  # [L, f]
    on_phase("stage1")
    keep_indices = []
    for li in range(L):
        top = np.argsort(-importance[li], kind="stable")[:num_preserve]
        keep_indices.append(np.sort(top))
    params, cfg = materialize_llm_width_pruning(params, cfg, keep_indices)

    # Stage 2: greedy attention removal on the width-pruned model (:288-293)
    on_phase("candidates")
    calib_cat = np.concatenate(
        [np.asarray(c).reshape(-1) for c in calibration[:num_calibration_second_stage]])
    attn_mask, mlp_mask = second_stage_attention(
        params, cfg, num_attn_submodules_to_prune, calib_cat, seq_len=seq_len,
        compute_dtype=compute_dtype)

    on_phase("materialize")
    pruned_blocks = [i for i, m in enumerate(attn_mask) if m == 1]
    params, cfg = materialize_llm_depth_pruning(params, cfg, pruned_blocks)

    info = {
        "num_attn_pruned": num_attn_submodules_to_prune,
        "pruned_attention_blocks": pruned_blocks,
        "num_preserve_mlp": num_preserve,
        "attn_mask": attn_mask,
        "mlp_mask": mlp_mask,
    }
    return params, cfg, info


def materialize_llm_depth_pruning(
    params: Params, cfg: LlamaConfig, blocks_to_prune: Sequence[int]
) -> Tuple[Params, LlamaConfig]:
    """Physically drop pruned blocks' attention weights (the reference deletes
    the q/k/v/o projections, src/utilities.py:486-503)."""
    if is_deepseek(cfg):
        return PD.materialize_deepseek_attention_pruning(params, cfg, blocks_to_prune)
    require_llama_config(cfg)
    pruned = tuple(sorted(set(int(i) for i in blocks_to_prune)))
    if cfg.num_experts:
        raise ValueError("depth materialization targets dense-MLP configs; "
                         "MoE models are not 2SSP targets")
    if not pruned:
        return params, cfg
    if cfg.pruned_attention_blocks:
        raise ValueError("depth pruning already materialized")
    blocks = dict(params["blocks"])
    keep = torch.tensor([i for i in range(cfg.num_layers) if i not in pruned],
                        dtype=torch.int64, device=params["embed"].device)
    # phi's ln1 feeds both branches, so it survives attention removal.
    # ln1_post (gemma-2) and q_norm/k_norm (qwen3) belong to the attention
    # submodule: the materialized forward indexes them with the compacted
    # attention index, so they compact with q/k/v/o.
    attn_names = ("q_kernel", "k_kernel", "v_kernel", "o_kernel",
                  "q_bias", "k_bias", "v_bias", "o_bias", "ln1_post",
                  "q_norm", "k_norm")
    if cfg.is_opt:
        attn_names = ("ln1", "ln1_bias") + attn_names  # the pre-attention LN goes too
    elif not cfg.is_phi:
        attn_names = ("ln1",) + attn_names
    for name in attn_names:
        if name in blocks:
            blocks[name] = blocks[name].index_select(0, keep)
    new_params = dict(params)
    new_params["blocks"] = blocks
    return new_params, dataclasses.replace(cfg, pruned_attention_blocks=pruned)


def materialize_llm_block_removal(
    params: Params, cfg: LlamaConfig, blocks_to_remove: Sequence[int]
) -> Tuple[Params, LlamaConfig]:
    """Physically drop entire transformer blocks (attention + MLP): the
    deployment artifact of the depth baselines. The result is a plain
    shallower model. Mixed per-layer window indices are remapped to the
    surviving positions."""
    if is_deepseek(cfg):
        return PD.materialize_deepseek_block_removal(params, cfg, blocks_to_remove)
    require_llama_config(cfg)
    removed = tuple(sorted(set(int(i) for i in blocks_to_remove)))
    if not removed:
        return params, cfg
    if cfg.pruned_attention_blocks:
        raise ValueError("materialize block removal BEFORE attention-only "
                         "depth materialization (the stacked layout is "
                         "uniform only while every block still has attention)")
    if max(removed) >= cfg.num_layers or min(removed) < 0:
        raise ValueError(f"block index out of range in {removed}")
    if len(removed) == cfg.num_layers:
        raise ValueError("cannot remove every block")
    keep = [i for i in range(cfg.num_layers) if i not in removed]
    idx = torch.tensor(keep, dtype=torch.int64, device=params["embed"].device)
    blocks = {k: v.index_select(0, idx) for k, v in params["blocks"].items()}
    wl = cfg.window_layers
    if wl is not None:
        wl = tuple(j for j, i in enumerate(keep) if i in set(wl))
        if not wl:  # no windowed layer survived: plain full attention
            wl = None
    new_cfg = dataclasses.replace(
        cfg, num_layers=len(keep), window_layers=wl,
        sliding_window=cfg.sliding_window if wl is not None or cfg.uniform_window else None)
    new_params = dict(params)
    new_params["blocks"] = blocks
    return new_params, new_cfg


# ---------------------------------------------------------------------------
# depth-pruning baselines
# ---------------------------------------------------------------------------

@torch.no_grad()
def compute_intermediate_outputs(
    params: Params, cfg: LlamaConfig, calibration: Sequence[np.ndarray],
    last_token: bool = True,
) -> List[np.ndarray]:
    """Per-sample stacked block outputs (reference src/utilities.py:188-221),
    captured from one forward per sample: [L, d] (last token) or [L, s, d]."""
    device = params["embed"].device
    mla = is_deepseek(cfg)
    if not mla:
        require_llama_config(cfg)
    outs = []
    for sample in calibration:
        fwd = deepseek_forward if mla else llama_forward
        _, aux = fwd(params, _tokens(sample, device), cfg, return_block_outputs=True)
        o = aux["block_outputs"]  # [L, b, s, d]
        o = o[:, 0, -1, :] if last_token else o[:, 0]
        outs.append(o.float().cpu().numpy())
    return outs


def _cos(a: np.ndarray, b: np.ndarray) -> float:
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    return float(np.dot(a, b) / max(1e-12, na * nb))


def window_based(params, cfg: LlamaConfig, num_prune: int,
                 calibration: Sequence[np.ndarray]) -> List[int]:
    """Sliding-window cosine similarity (reference src/pruning.py:29-64)."""
    L = cfg.num_layers
    outs = compute_intermediate_outputs(params, cfg, calibration, last_token=True)
    l1, l2, best_sim = 0, 1, 0.0
    for layer1 in range(L):
        layer2 = layer1 + num_prune
        if layer2 >= L:
            continue
        sims = [_cos(o[layer1], o[layer2]) for o in outs]
        sim = sum(sims) / len(sims)
        if sim >= best_sim:
            best_sim, l1, l2 = sim, layer1, layer2
    mask = [0] * L
    for i in range(l1 + 1, l2 + 1):
        mask[i] = 1
    return mask


def shortgpt(params, cfg: LlamaConfig, num_prune: int,
             calibration: Sequence[np.ndarray]) -> List[int]:
    """Block influence = 1 - cos(input, output) (reference src/pruning.py:82-107)."""
    L = cfg.num_layers
    outs = compute_intermediate_outputs(params, cfg, calibration, last_token=True)
    similarity = [0.0] * L
    for o in outs:
        for li in range(1, L):
            similarity[li] += _cos(o[li - 1], o[li])
    influence = [1 - s / len(outs) for s in similarity]
    to_prune = sorted(range(L), key=lambda i: influence[i])[:num_prune]
    mask = [0] * L
    for i in to_prune:
        mask[i] = 1
    return mask


def blockpruner(params, cfg: LlamaConfig, num_prune: int,
                calibration_sample: np.ndarray, *, seq_len: int = 2048
                ) -> Tuple[List[int], List[int]]:
    """Greedy attention-or-MLP submodule removal minimizing 1-sample
    perplexity (reference src/pruning.py:127-194); the candidates of each
    round are scored in batched chunks."""
    L = cfg.num_layers
    attn_mask, mlp_mask = [0] * L, [0] * L

    def sweep(base_attn, base_mlp, which):
        base = base_attn if which == "attn" else base_mlp
        cands = [c for c in range(L) if base[c] == 0]
        ga = np.tile(1.0 - np.asarray(base_attn, np.float32), (len(cands), 1))
        gm = np.tile(1.0 - np.asarray(base_mlp, np.float32), (len(cands), 1))
        tgt = ga if which == "attn" else gm
        for row, c in enumerate(cands):
            tgt[row, c] = 0.0
        ppls = evaluate_perplexity_candidates(
            params, cfg, calibration_sample, ga, gm, seq_len=seq_len)
        tag = "Attention" if which == "attn" else "MLP"
        for c, p in zip(cands, ppls):
            logging.debug(f"[{tag}] When pruning {c} perplexity is {p}")
        best_idx = int(np.argmin(ppls))
        logging.debug(f"[{tag}] Best to prune: {cands[best_idx]} ({ppls[best_idx]})")
        return cands[best_idx]

    for _ in range(num_prune):
        attn_mask[sweep(attn_mask, mlp_mask, "attn")] = 1
        mlp_mask[sweep(attn_mask, mlp_mask, "mlp")] = 1

    return attn_mask, mlp_mask
