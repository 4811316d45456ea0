"""2SSP ablation suite on PyTorch (counterpart of ``ssp_x_vit_tpu/llm/ablations.py``;
reference src/ablations.py).

- one_stage_2ssp              stage 1 (FFN width) only (:88-126)
- two_stage_2ssp_inverted     rows and columns inverted: the MLP's hidden
                              (embedding-side) dims pruned by the input and
                              output norms (:129-255), as an exact mask on
                              those dims (linear maps with zeroed rows and
                              columns), so nothing is re-sliced
- two_stage_2ssp_l1_norm      stage-1 importance by L1 token norms (:258-343)
- ablation_calibration_dataset calibration size x seed sweep (:22-64)
- ablation_balancing_sparsity_ratio every N_attn at a fixed sparsity (:346-372)
- run_ablations               the whole suite (:375-449)

Every function runs on the parameters' device over ``llm/pruning.py`` and
``llm/evaluation.py``, with the same printed and logged lines as the JAX
module. ``compute_dtype`` is the forwards' (the JAX module always runs bf16).
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ssp_x_vit_tpu_torch.llm import pruning as P
from ssp_x_vit_tpu_torch.llm.evaluation import evaluate_perplexity
from ssp_x_vit_tpu_torch.llm.model import LlamaConfig, Params, llama_forward

BF16 = torch.bfloat16


def _tokens(sample, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(sample).reshape(1, -1).astype(np.int64)).to(device)


def _top_sorted(importance: np.ndarray, n: int) -> List[np.ndarray]:
    """Per layer, the ``n`` most important indices (stable order), sorted."""
    return [np.sort(np.argsort(-row, kind="stable")[:n]) for row in importance]


# ---------------------------------------------------------------------------
# one_stage_2ssp (reference :88-126)
# ---------------------------------------------------------------------------

def one_stage_keep_indices(params: Params, cfg: LlamaConfig, calibration,
                           pruning_rate: float, *, compute_dtype=BF16):
    """Stage-1-only selection: (keep_indices per layer, num_preserve) for
    mlp_pruning_rate = rate * main_params / (L * mlp_params)."""
    L = cfg.num_layers
    main_total, _, mlp_total = P.count_main_params(cfg)
    mlp_pruning_rate = pruning_rate * (main_total / (L * mlp_total))
    num_preserve = int(round(cfg.intermediate_size * (1 - mlp_pruning_rate)))
    importance = P.mlp_hidden_importance(params, cfg, calibration, compute_dtype=compute_dtype)
    return _top_sorted(importance, num_preserve), num_preserve


def one_stage_2ssp(params: Params, cfg: LlamaConfig, calibration, pruning_rate: float, *,
                   compute_dtype=BF16):
    """Stage 1 only: prune FFN neurons to hit the global rate."""
    keep, _ = one_stage_keep_indices(params, cfg, calibration, pruning_rate,
                                     compute_dtype=compute_dtype)
    return P.materialize_llm_width_pruning(params, cfg, keep)


# ---------------------------------------------------------------------------
# inverted rows/cols (reference :129-255)
# ---------------------------------------------------------------------------

@torch.no_grad()
def mlp_io_importance(params, cfg, calibration, *, compute_dtype=BF16):
    """Mean token-L2 of the MLP module's inputs and outputs per hidden dim:
    two [L, d] arrays (the sums over samples stay on the device)."""
    device = params["embed"].device
    s_in = s_out = None
    for sample in calibration:
        _, aux = llama_forward(params, _tokens(sample, device), cfg, collect_mlp_io_stats=True,
                               compute_dtype=compute_dtype)
        a = torch.sqrt(aux["mlp_in_stats"])[:, 0]
        b = torch.sqrt(aux["mlp_out_stats"])[:, 0]
        s_in = a if s_in is None else s_in + a
        s_out = b if s_out is None else s_out + b
    n = max(1, len(calibration))
    return s_in.cpu().numpy() / n, s_out.cpu().numpy() / n


def materialize_inverted_mlp_pruning(params, cfg, keep_in: Sequence[np.ndarray],
                                     keep_out: Sequence[np.ndarray]):
    """Zero the pruned hidden dims: gate/up input rows and down output columns.

    Exactly the reference's slice + zero-scatter forward (:149-164): a linear
    map with zeroed input rows equals slicing the input, and zeroed down
    columns equal scattering the output back with zeros. The parameters stay
    physically present."""
    blocks = dict(params["blocks"])
    d, L = cfg.hidden_size, cfg.num_layers
    device = params["embed"].device
    in_keep = torch.zeros((L, d), dtype=torch.bool)
    out_keep = torch.zeros((L, d), dtype=torch.bool)
    for i in range(L):
        in_keep[i, torch.from_numpy(np.asarray(keep_in[i], np.int64))] = True
        out_keep[i, torch.from_numpy(np.asarray(keep_out[i], np.int64))] = True
    in_keep, out_keep = in_keep.to(device), out_keep.to(device)
    for name in ("gate_kernel", "up_kernel"):
        blocks[name] = blocks[name].masked_fill(~in_keep[:, :, None], 0.0)
    blocks["down_kernel"] = blocks["down_kernel"].masked_fill(~out_keep[:, None, :], 0.0)
    return dict(params, blocks=blocks)


def _attn_budget(cfg: LlamaConfig, pruning_rate: float, num_attn: Optional[int]):
    """(num_attn, main, attn, mlp) or None when the rate cannot be met, with
    the reference's messages."""
    L = cfg.num_layers
    main_total, attn_total, mlp_total = P.count_main_params(cfg)
    if num_attn is None:
        num_attn = round(L * pow(pruning_rate, (mlp_total / attn_total) / 1.5))
    print(f"Pruning {num_attn} attention submodules")
    if (num_attn * attn_total) / main_total > pruning_rate:
        print("Exceeded pruning parameters number")
        return None
    if (num_attn * attn_total + L * mlp_total) / main_total < pruning_rate:
        print(f"Unable to reach the target sparsity rate with only "
              f"{num_attn} pruned attention submodules")
        return None
    return num_attn, main_total, attn_total, mlp_total


def _second_stage(params, cfg, calibration, num_attn, seq_len, compute_dtype):
    calib_cat = np.concatenate([np.asarray(c).reshape(-1) for c in calibration[:1]])
    attn_mask, _ = P.second_stage_attention(params, cfg, num_attn, calib_cat, seq_len=seq_len,
                                            compute_dtype=compute_dtype)
    pruned = [i for i, m in enumerate(attn_mask) if m == 1]
    params, cfg = P.materialize_llm_depth_pruning(params, cfg, pruned)
    return params, cfg, pruned


def two_stage_2ssp_inverted(params, cfg, calibration, pruning_rate,
                            num_attn_submodules_to_prune: Optional[int] = None,
                            seq_len: int = 2048, *, compute_dtype=BF16):
    budget = _attn_budget(cfg, pruning_rate, num_attn_submodules_to_prune)
    if budget is None:
        return False
    num_attn, main_total, _, mlp_total = budget
    mlp_pruning_rate = pruning_rate * (main_total / (cfg.num_layers * mlp_total))
    num_preserve_hidden = int(round(cfg.hidden_size * (1 - mlp_pruning_rate)))

    imp_in, imp_out = mlp_io_importance(params, cfg, calibration, compute_dtype=compute_dtype)
    keep_in = _top_sorted(imp_in, num_preserve_hidden)
    keep_out = _top_sorted(imp_out, num_preserve_hidden)
    params = materialize_inverted_mlp_pruning(params, cfg, keep_in, keep_out)
    params, cfg, pruned = _second_stage(params, cfg, calibration, num_attn, seq_len,
                                        compute_dtype)
    info = {"pruned_attention_blocks": pruned, "keep_in": keep_in,
            "keep_out": keep_out, "num_preserve_hidden": num_preserve_hidden}
    return params, cfg, info


# ---------------------------------------------------------------------------
# L1-norm variant (reference :258-343)
# ---------------------------------------------------------------------------

@torch.no_grad()
def _mlp_l1_importance(params, cfg, calibration, compute_dtype):
    """L1 norm over tokens of the down_proj input (p=1), averaged over samples: [L, f]."""
    device = params["embed"].device
    sums = None
    for sample in calibration:
        _, aux = llama_forward(params, _tokens(sample, device), cfg, collect_mlp_stats=True,
                               mlp_stats_kind="sumabs", compute_dtype=compute_dtype)
        stats = aux["mlp_stats"][:, 0]
        sums = stats if sums is None else sums + stats
    return sums.cpu().numpy() / max(1, len(calibration))


def two_stage_2ssp_l1_norm(params, cfg, calibration, pruning_rate,
                           num_attn_submodules_to_prune: Optional[int] = None,
                           seq_len: int = 2048, *, compute_dtype=BF16):
    budget = _attn_budget(cfg, pruning_rate, num_attn_submodules_to_prune)
    if budget is None:
        return False
    num_attn, main_total, attn_total, mlp_total = budget
    target = int(round(pruning_rate * main_total))
    mlp_params_to_prune = int(round((target - num_attn * attn_total) / cfg.num_layers))
    num_preserve = int(round(cfg.intermediate_size * (1 - mlp_params_to_prune / mlp_total)))

    keep = _top_sorted(_mlp_l1_importance(params, cfg, calibration, compute_dtype), num_preserve)
    params, cfg = P.materialize_llm_width_pruning(params, cfg, keep)
    params, cfg, pruned = _second_stage(params, cfg, calibration, num_attn, seq_len,
                                        compute_dtype)
    info = {"pruned_attention_blocks": pruned, "keep": keep, "num_preserve": num_preserve}
    return params, cfg, info


# ---------------------------------------------------------------------------
# the sweeps (reference :22-64, :346-372, :375-449)
# ---------------------------------------------------------------------------

def _ppl(p, c, eval_ids, seq_len, compute_dtype) -> float:
    return evaluate_perplexity(p, c, eval_ids, seq_len=seq_len, enable_tqdm=False,
                               compute_dtype=compute_dtype)


def ablation_calibration_dataset(params, cfg, sparsity, calib_stream, eval_ids,
                                 calibration_sizes, seq_len=2048,
                                 method="2ssp", seeds=(0, 1, 2, 3, 4), *, compute_dtype=BF16):
    from ssp_x_vit_tpu_torch.llm.datasets import get_calibration
    from ssp_x_vit_tpu_torch.utils.seeding import set_seed

    print(f"************* Test at sparsity {sparsity} - {method} *************")
    results = []
    for cs in calibration_sizes:
        for seed in seeds:
            set_seed(seed)
            # a seeded shift of the calibration windows (the reference
            # reshuffles the source dataset when seed != 0)
            calib = get_calibration(calib_stream, cs + seed, seq_len=seq_len)[-cs:]
            start = time.time()
            if method == "one_stage_2ssp":
                p2, c2 = one_stage_2ssp(params, cfg, calib, sparsity, compute_dtype=compute_dtype)
            elif method == "2ssp":
                out = P.two_stage_2ssp(params, cfg, calib, sparsity, seq_len=seq_len,
                                       compute_dtype=compute_dtype)
                if out is False:
                    continue
                p2, c2, _ = out
            else:
                raise ValueError("use only [one_stage_2ssp, 2ssp]")
            elapsed = time.time() - start
            ppl = _ppl(p2, c2, eval_ids, seq_len, compute_dtype)
            print(f"Pruning Time: {elapsed} s")
            print(f"Calibration size {cs}, Seed {seed}, perplexity {ppl}")
            results.append({"calibration_size": cs, "seed": seed, "ppl": ppl, "time_s": elapsed})
    return results


def ablation_balancing_sparsity_ratio(params, cfg, sparsity, calibration, eval_ids,
                                      seq_len=2048, *, compute_dtype=BF16):
    """Sweep every feasible N_attn at a fixed sparsity (reference :346-372)."""
    results = []
    for n_attn in range(0, cfg.num_layers):
        out = P.two_stage_2ssp(params, cfg, calibration, sparsity,
                               num_attn_submodules_to_prune=n_attn, seq_len=seq_len,
                               compute_dtype=compute_dtype)
        if out is False:
            continue
        p2, c2, _ = out
        ppl = _ppl(p2, c2, eval_ids, seq_len, compute_dtype)
        print(f"When pruning {n_attn} attention submodules @ {sparsity}, "
              f"perplexity is {ppl}")
        results.append({"n_attn": n_attn, "ppl": ppl})
    return results


def run_ablations(params, cfg, calib_stream, eval_ids, calibration_2ssp,
                  seq_len=2048, quick=False, *, compute_dtype=BF16) -> Dict[str, list]:
    """The whole suite (reference :375-449); ``quick`` shrinks the sweeps for
    smoke runs. Returns the rows of each ablation (the JAX function returns
    None): ``calibration`` (size, seed, ppl, seconds), ``stage1``,
    ``inverted`` and ``l1`` ({"rate", "ppl"}; a rate that cannot be met is
    left out), ``balancing`` ({"sparsity", "n_attn", "ppl"})."""
    rows: Dict[str, list] = {"calibration": [], "stage1": [], "inverted": [], "l1": [],
                             "balancing": []}
    kw = dict(compute_dtype=compute_dtype)
    logging.info('Running ablation: Choice of Calibration Set Size')
    sizes = [2, 4] if quick else [2, 4, 8, 16, 32, 64, 128, 256]
    seeds = (0,) if quick else (0, 1, 2, 3, 4)
    rows["calibration"] = ablation_calibration_dataset(
        params, cfg, 0.5, calib_stream, eval_ids, sizes, seq_len=seq_len, method="2ssp",
        seeds=seeds, **kw)

    rates = [0.25] if quick else [0.25, 0.375, 0.5]

    logging.info('Running ablation: Running stage 1 only')
    for rate in rates:
        p2, c2 = one_stage_2ssp(params, cfg, calibration_2ssp, rate, **kw)
        ppl = _ppl(p2, c2, eval_ids, seq_len, compute_dtype)
        logging.info(f"Perplexity @ {rate} : {ppl}")
        rows["stage1"].append({"rate": rate, "ppl": ppl})

    for title, key, fn in (('Pruning Rows-Columns vs. Columns-Rows', "inverted",
                            two_stage_2ssp_inverted),
                           ('Neuron Selection based on L1 norm', "l1", two_stage_2ssp_l1_norm)):
        logging.info(f'Running ablation: {title}')
        for rate in rates:
            out = fn(params, cfg, calibration_2ssp, rate, seq_len=seq_len, **kw)
            if out is False:
                continue
            p2, c2, _ = out
            ppl = _ppl(p2, c2, eval_ids, seq_len, compute_dtype)
            logging.info(f"Perplexity @ {rate} : {ppl}")
            rows[key].append({"rate": rate, "ppl": ppl})

    logging.info('Running ablation: balancing the sparsity rate')
    sweep = range(1, 3) if quick else range(1, cfg.num_layers)
    for i in sweep:
        sparsity = i / cfg.num_layers
        for r in ablation_balancing_sparsity_ratio(params, cfg, sparsity, calibration_2ssp,
                                                   eval_ids, seq_len=seq_len, **kw):
            rows["balancing"].append(dict(r, sparsity=sparsity))
    return rows
