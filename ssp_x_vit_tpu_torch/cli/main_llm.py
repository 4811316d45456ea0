"""LLM pruning CLI on PyTorch (counterpart of the repository's ``main_llm.py``;
reference main.py:18-253): the same flags and flow: method dispatch (2SSP,
the depth baselines, EvoPress, SliceGPT), sparsity sweeps -1/-2,
pruning-time measurement, perplexity, inference-time, downstream and
qualitative evaluation, the ablation suite, weight-only quantized evaluation,
native and HF model saving.

Usage (on the card; ``--backend cpu`` runs the plain PyTorch path instead):
  python -m ssp_x_vit_tpu_torch.cli.main_llm --model tiny-random \\
      --pruning_method 2ssp --sparsity_rate 0.375 --evaluate_perplexity --synthetic-data
  python -m ssp_x_vit_tpu_torch.cli.main_llm --model ckpts/code_llm_small --dense \\
      --quantize int4 --evaluate_perplexity --seq-len 1024
  python -m ssp_x_vit_tpu_torch.cli.main_llm --model tiny-random --synthetic-data \\
      --ablation --ablation-quick --seq-len 128

``--model`` is ``tiny-random``, ``tiny-random-{phi,opt,gemma,gemma2,qwen3}``,
``tiny-random-deepseek`` (MLA + MoE) or ``tiny-random-deepseek-dense``, a native
directory (``model.npz`` + ``config.json``; DeepSeek ones carry ``kv_lora_rank``)
or a local HF directory (``config.json`` + ``*.safetensors``, read by
``load_hf_llama``, or ``load_hf_deepseek`` for ``model_type`` ``deepseek_v3``).
DeepSeek models take every method but SliceGPT, 2SSP only on dense-GLU
configs, and no ``--ablation``, each refused with the JAX CLI's message.
``--evaluate_qualitative`` generates text for two prompts with the
directory's byte-level ``tokenizer.json`` (without one it warns and skips, as
the JAX CLI does); ``--save-format hf`` writes ``export_hf_llama``'s
directory; a sliced (SliceGPT) model is evaluated for perplexity only, and
not saved. ``--evaluate_downstream`` scores the offline task pack of
``--task-pack`` (or $SSP_X_VIT_TASK_PACK; the lm-eval harness leg is not
ported, ROADMAP.md A.10e). With a model directory holding a byte-level
``tokenizer.json``, ``--local_datasets`` reads the corpora from
``./data/{wikitext2,c4_val,fineweb_edu,c4_train}``, each a
``datasets.save_to_disk`` directory (``llm/arrow_ipc.py``; nothing is
downloaded); every other run uses the deterministic synthetic token streams.

``run(args, model=None)`` returns a dict: the corpora used (``corpora``:
``local`` or ``synthetic``), perplexities, the qualitative
(prompt, answer) pairs, the downstream results, pruned blocks, kept width,
achieved sparsity, SliceGPT's ``new_dim``, EvoPress's masks and selection
records, the ablation rows, and the wall seconds and kernel launches of each
phase (setup, stats, stage1, candidates, materialize, search; SliceGPT's
capture, covariance, eigh, rotation; EvoPress's targets, selection;
ablation; evaluation). ``model=(params, cfg)`` runs on a model the caller built.
"""

from __future__ import annotations

import argparse
import logging
import math
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np

TINY_RANDOM = dict(vocab_size=512, hidden_size=64, num_layers=6, num_heads=4,
                   num_kv_heads=4, intermediate_size=172)

_TINY_VARIANTS = {
    "tiny-random": {},
    "tiny-random-phi": dict(model_type="phi", qkv_bias=True, rotary_dim=8),
    "tiny-random-opt": dict(model_type="opt", qkv_bias=True, tie_embeddings=True,
                            max_position_embeddings=512),
    "tiny-random-gemma": dict(model_type="gemma", hidden_act="gelu_tanh",
                              scale_embeddings=True, tie_embeddings=True),
    "tiny-random-gemma2": dict(model_type="gemma2", hidden_act="gelu_tanh",
                               scale_embeddings=True, tie_embeddings=True, sliding_window=64,
                               window_layers=tuple(range(0, TINY_RANDOM["num_layers"], 2)),
                               attn_softcap=50.0, final_softcap=30.0),
    "tiny-random-qwen3": dict(model_type="qwen3", qk_norm=True),
}

# the JAX CLI's DeepSeek test models (main_llm.py): MLA + sigmoid-routed MoE,
# and the all-dense variant that 2SSP targets
_TINY_DEEPSEEK_BASE = dict(vocab_size=512, hidden_size=64, num_layers=4, num_heads=4,
                           q_lora_rank=24, kv_lora_rank=32, qk_nope_head_dim=16,
                           qk_rope_head_dim=8, v_head_dim=16, intermediate_size=172)
_TINY_DEEPSEEK = {
    "tiny-random-deepseek": dict(moe_intermediate_size=48, n_routed_experts=4,
                                 n_shared_experts=1, num_experts_per_tok=2,
                                 first_k_dense_replace=1),
    "tiny-random-deepseek-dense": dict(n_routed_experts=0),
}


def build_argparser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Pruning of transformer models (PyTorch/CUDA)")
    parser.add_argument('--model', type=str, required=True,
                        help="Native model directory (model.npz + config.json), a local HF "
                             "directory (config.json + *.safetensors), or "
                             "'tiny-random[-phi|-opt|-gemma|-gemma2|-qwen3|-deepseek|"
                             "-deepseek-dense]' for an offline test model")
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--cache_dir', type=str, required=False)
    parser.add_argument('--dense', action='store_true',
                        help="Evaluate the original dense model")
    parser.add_argument('--pruning_method', type=str,
                        choices=['2ssp', 'window_based', 'shortgpt', 'blockpruner',
                                 'evopress', 'slicegpt'])
    parser.add_argument('--sparsity_rate', type=float,
                        help="0..1 target sparsity; -1 sweeps i/N; -2 sweeps 25/37.5/50%%")
    parser.add_argument('--main_table_results', action='store_true')
    parser.add_argument('--evaluate_inference', action='store_true')
    parser.add_argument('--evaluate_downstream', action='store_true')
    parser.add_argument('--task-pack', type=str, default=None)
    parser.add_argument('--evaluate_perplexity', action='store_true')
    parser.add_argument('--evaluate_qualitative', action='store_true')
    parser.add_argument('--ablation', action='store_true')
    parser.add_argument('--ablation-quick', action='store_true')
    parser.add_argument('--local_datasets', action='store_true')
    parser.add_argument('--synthetic-data', action='store_true',
                        help="Deterministic synthetic token streams instead of the corpora")
    parser.add_argument('--seq-len', type=int, default=2048)
    parser.add_argument('--num-calibration', type=int, default=256)
    parser.add_argument('--num-calibration-2ssp', type=int, default=32)
    parser.add_argument('--evopress-generations', type=int, default=None)
    parser.add_argument('--quantize', type=str, default='none', choices=('none', 'int8', 'int4'),
                        help='weight-only quantization applied to every evaluated model '
                             '(llm/quant.py; int8 = per-channel scales on the output, '
                             'int4 = packed nibbles through the dequant GEMM kernel)')
    parser.add_argument('--w8a8', action='store_true',
                        help='with --quantize int8: int8 x int8 matmuls with dynamic per-token '
                             'activation scales; with int4 only the int8 lm_head picks it up')
    parser.add_argument('--save-model', type=str, default=None,
                        help='directory to persist the pruned model (materialized weights, '
                             'no gates); sparsity sweeps write per-rate subdirectories')
    parser.add_argument('--save-format', type=str, default='native', choices=('native', 'hf'),
                        help="native = model.npz + config.json (save_llm_model); hf = "
                             "config.json + model.safetensors (export_hf_llama)")
    parser.add_argument('--backend', type=str, default='cuda', choices=['cuda', 'cpu'],
                        help="Device to run on; cuda raises when no GPU is present")
    parser.add_argument('--logging', type=str, default='INFO',
                        choices=['DEBUG', 'INFO', 'WARNING', 'ERROR', 'CRITICAL'])
    return parser


def load_model(args, device):
    import torch

    from ssp_x_vit_tpu_torch.llm import deepseek as DS
    from ssp_x_vit_tpu_torch.llm.checkpoints import load_hf_llama, load_llm_model
    from ssp_x_vit_tpu_torch.llm.model import LlamaConfig, init_llama_params

    if os.path.isdir(args.model):
        import json

        cfg_path = os.path.join(args.model, "config.json")
        raw = {}
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                raw = json.load(f)
        if raw.get("model_type") == "deepseek_v3":
            return DS.load_hf_deepseek(args.model, device=device)
        if not os.path.exists(os.path.join(args.model, "model.npz")):
            return load_hf_llama(args.model, device=device)
        if "kv_lora_rank" in raw:
            return DS.load_deepseek_model(args.model, device=device)
        return load_llm_model(args.model, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    if args.model in _TINY_VARIANTS:
        cfg = LlamaConfig(**TINY_RANDOM, **_TINY_VARIANTS[args.model])
        return init_llama_params(gen, cfg, dtype=torch.float32, device=device), cfg
    if args.model in _TINY_DEEPSEEK:
        cfg = DS.DeepseekConfig(**_TINY_DEEPSEEK_BASE, **_TINY_DEEPSEEK[args.model])
        return DS.init_deepseek_params(gen, cfg, dtype=torch.float32, device=device), cfg
    raise SystemExit("--model must be a native or HF model directory or one of "
                     f"{sorted(_TINY_VARIANTS) + sorted(_TINY_DEEPSEEK)}; got {args.model}")


def _reject_for_deepseek(args, cfg) -> None:
    """The JAX CLI's refusals for DeepSeek models, with its message: SliceGPT
    (the rotation does not commute with the low-rank kv_a / kv_b
    factorization), 2SSP on a MoE config (stage 1 needs dense GLU MLPs) and
    the ablation suite (it assumes the llama layout)."""
    unsupported = [f for f, on in (
        ("--pruning_method slicegpt", args.pruning_method == "slicegpt"),
        ("--pruning_method 2ssp on a MoE deepseek (stage-1 FFN width "
         "needs dense GLU MLPs; use the depth baselines or a "
         "first_k_dense_replace==num_layers config)",
         args.pruning_method == "2ssp" and cfg.n_routed_experts > 0),
        ("--ablation", args.ablation)) if on]
    if unsupported:
        raise SystemExit("unsupported for deepseek models: "
                         f"{unsupported} (slicegpt rotation does not "
                         "commute with the MLA factorization; the "
                         "ablation suite assumes the llama layout)")


def load_corpora(args, cfg, report: Optional[Dict[str, Any]] = None):
    """(wikitext_ids, c4_val_ids, fineweb_ids, c4_train_ids) token streams, as
    the JAX CLI makes them: with a model directory and without
    ``--synthetic-data``, the corpora tokenized by the directory's tokenizer
    (``./data/{wikitext2,c4_val,fineweb_edu,c4_train}`` with
    ``--local_datasets``; without it nothing is downloaded, so the loaders
    give None), all four or none, FineWeb-Edu cut to its first 500 texts;
    otherwise, or when any of that fails, the deterministic synthetic streams
    (seeds 1-4) with the JAX CLI's warning. ``report["corpora"]`` is set to
    ``"local"`` or ``"synthetic"``."""
    from ssp_x_vit_tpu_torch.llm import datasets as D

    report = report if report is not None else {}
    if not args.synthetic_data and os.path.isdir(args.model):
        try:
            from ssp_x_vit_tpu_torch.llm.tokenizer import load_tokenizer

            tok = load_tokenizer(args.model)
            base = "./data" if args.local_datasets else None
            wik = D.load_wikitext2(base and f"{base}/wikitext2")
            c4v = D.load_c4(base and f"{base}/c4_val", split="validation")
            fwe = D.load_fineweb_edu(base and f"{base}/fineweb_edu")
            c4t = D.load_c4(base and f"{base}/c4_train", split="train")
            if all(x is not None for x in (wik, c4v, fwe, c4t)):
                streams = (D.tokenize_corpus(wik, tok), D.tokenize_corpus(c4v, tok),
                           D.tokenize_corpus(fwe[:500], tok), D.tokenize_corpus(c4t, tok))
                report["corpora"] = "local"
                logging.info("Using the local corpora under ./data: "
                             + ", ".join(f"{n} {s.shape[1]} tokens" for n, s in zip(
                                 ("wikitext2", "c4_val", "fineweb_edu", "c4_train"), streams)))
                return streams
        except Exception as e:   # the JAX CLI's fallback: any failure -> synthetic streams
            logging.warning(f"Real datasets unavailable ({e}); falling back to synthetic")

    report["corpora"] = "synthetic"
    logging.info("Using deterministic synthetic token streams")
    n = args.seq_len * (args.num_calibration + 8)
    return tuple(D.synthetic_token_stream(n, cfg.vocab_size, seed=s) for s in (1, 2, 3, 4))


class _Phases:
    """Wall seconds and kernel launches per named phase of a run, summed over
    repeats of a phase; the device is synchronized where a phase ends."""

    def __init__(self, device):
        self.device = device
        self.seconds: Dict[str, float] = {}
        self.launches: Dict[str, Dict[str, int]] = {}
        self._name: Optional[str] = None

    def start(self, name: Optional[str]) -> None:
        """End the running phase, if any, and start ``name`` (None: none)."""
        import torch

        from ssp_x_vit_tpu_torch.ops.kernels import launch_counts

        if self._name is not None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.seconds[self._name] = (self.seconds.get(self._name, 0.0)
                                        + time.perf_counter() - self._t0)
            done = self.launches.setdefault(self._name, {k: 0 for k in launch_counts})
            for k in launch_counts:
                done[k] += launch_counts[k] - self._before[k]
        self._name = name
        self._t0 = time.perf_counter()
        self._before = dict(launch_counts)

    def stop(self) -> None:
        self.start(None)


def run(args, model=None) -> Dict[str, Any]:
    from ssp_x_vit_tpu_torch.device import resolve_device
    from ssp_x_vit_tpu_torch.utils.seeding import set_seed
    from ssp_x_vit_tpu_torch.llm import datasets as D
    from ssp_x_vit_tpu_torch.llm import pruning as P
    from ssp_x_vit_tpu_torch.llm import deepseek as DS
    from ssp_x_vit_tpu_torch.llm.checkpoints import export_hf_llama, save_llm_model
    from ssp_x_vit_tpu_torch.llm.evaluation import (
        evaluate_inference_time, evaluate_perplexity, evaluation_ppl,
    )
    from ssp_x_vit_tpu_torch.llm.quant import (
        quantize_deepseek_params_int4, quantize_deepseek_params_int8, quantize_llm_params_int4,
        quantize_llm_params_int8,
    )
    from ssp_x_vit_tpu_torch.llm.slicegpt import SlicedLlamaConfig, evaluate_perplexity_sliced
    from ssp_x_vit_tpu_torch.ops import dispatch

    device = resolve_device(args.backend)
    phases = _Phases(device)
    phases.start("setup")
    set_seed(args.seed)
    if model is None:
        params, cfg = load_model(args, device)
    else:
        params, cfg = model
        if params["embed"].device.type != device.type:
            raise ValueError(f"the model is on {params['embed'].device}, --backend is {device.type}")
    model_type = getattr(cfg, "model_type", "deepseek_v3")
    logging.info(f"Model: {model_type} L={cfg.num_layers} d={cfg.hidden_size} "
                 f"f={cfg.intermediate_size}")
    is_deepseek = DS.is_deepseek(cfg)
    if is_deepseek:
        _reject_for_deepseek(args, cfg)

    result: Dict[str, Any] = {"model_type": model_type, "quantize": args.quantize, "runs": []}
    wikitext_ids, c4_val_ids, fineweb_ids, c4_train_ids = load_corpora(args, cfg, result)
    calibration = D.get_calibration(c4_train_ids, args.num_calibration, seq_len=args.seq_len)
    calibration_2ssp = calibration[: args.num_calibration_2ssp]
    first_sample = calibration[0]

    def run_evals(p, c, attn_gate=None, mlp_gate=None) -> Dict[str, Any]:
        phases.start("evaluation")
        out: Dict[str, Any] = {}
        if isinstance(c, SlicedLlamaConfig):   # perplexity only, never quantized
            if args.evaluate_perplexity or args.main_table_results:
                out["ppl"] = evaluate_perplexity_sliced(p, c, wikitext_ids, seq_len=args.seq_len)
                logging.info(f"Perplexity (wikitext2): {out['ppl']}")
            phases.stop()
            return out
        if args.quantize != 'none':
            q = quantize_llm_params_int8 if args.quantize == 'int8' else quantize_llm_params_int4
            if is_deepseek:
                q = (quantize_deepseek_params_int8 if args.quantize == 'int8'
                     else quantize_deepseek_params_int4)
            p = q(p, c)
            logging.info(f"Evaluating {args.quantize}-quantized weights")
            if args.w8a8:
                dispatch.set_w8a8_enabled(True)
                if args.quantize == 'int4':
                    logging.warning(
                        "W8A8 with --quantize int4: activation quantization applies only to "
                        "int8-quantized layers (lm_head); int4 matmuls stay weight-only")
                else:
                    logging.info("W8A8 mode: int8 x int8 matmuls")
        if args.evaluate_inference:
            out["inference_ms"] = evaluate_inference_time(p, c, first_sample)
            logging.info(f"Average Inference Time: {out['inference_ms']:.3f} ms")
        if args.evaluate_downstream:
            from ssp_x_vit_tpu_torch.llm.downstream import evaluation_downstream

            out["downstream"] = evaluation_downstream(p, c, args.model, task_pack=args.task_pack)
        if args.main_table_results:
            out["main_table"] = evaluation_ppl(p, c, wikitext_ids, c4_val_ids, fineweb_ids,
                                               seq_len=args.seq_len, attn_gate=attn_gate,
                                               mlp_gate=mlp_gate)
        if args.evaluate_perplexity:
            out["ppl"] = evaluate_perplexity(p, c, wikitext_ids, seq_len=args.seq_len,
                                             attn_gate=attn_gate, mlp_gate=mlp_gate)
            logging.info(f"Perplexity (wikitext2): {out['ppl']}")
        if args.evaluate_qualitative:
            from ssp_x_vit_tpu_torch.llm.generate import qualitative_results

            out["qualitative"] = qualitative_results(p, c, args.model, max_length=128)
        phases.stop()
        return out

    def save_artifact(p, c, suffix=None):
        """Persist a materialized model per --save-format; a form the format
        cannot hold (sliced shortcut matrices; attention-removed blocks in HF)
        warns and skips."""
        if isinstance(c, SlicedLlamaConfig):
            logging.warning("--save-model skipped: sliced models carry "
                            "shortcut matrices with no HF/native encoding "
                            "(re-slice from the saved rotation instead)")
            return None
        out = args.save_model if not suffix else os.path.join(args.save_model, suffix)
        if is_deepseek:
            fn = DS.export_hf_deepseek if args.save_format == 'hf' else DS.save_deepseek_model
        else:
            fn = export_hf_llama if args.save_format == 'hf' else save_llm_model
        try:
            path = fn(out, p, c)
        except ValueError as e:
            logging.warning(f"--save-model skipped: {e}")
            return None
        logging.info(f"[ARTIFACT] {args.save_format} model -> {path}")
        return path

    def materialize_masked(p, c, attn_mask, mlp_mask):
        """Block masks -> physical weights: whole-block removal where both
        submodules fall, attention-only depth materialization (indices
        remapped to the surviving layers) where only attention does."""
        am = [bool(x) for x in np.asarray(attn_mask).reshape(-1)]
        mm = [bool(x) for x in np.asarray(mlp_mask).reshape(-1)]
        both = [i for i, (a, m) in enumerate(zip(am, mm)) if a and m]
        attn_only = [i for i, (a, m) in enumerate(zip(am, mm)) if a and not m]
        if any(m and not a for a, m in zip(am, mm)):
            raise ValueError("MLP-only block masks have no materialized form")
        p, c = P.materialize_llm_block_removal(p, c, both)
        keep = [i for i in range(len(am)) if i not in set(both)]
        remap = {old: new for new, old in enumerate(keep)}
        if attn_only:
            p, c = P.materialize_llm_depth_pruning(p, c, [remap[i] for i in attn_only])
        return p, c

    try:
        if args.dense:
            logging.info("Dense model evaluation")
            result["dense"] = run_evals(params, cfg)
            if args.save_model:
                save_artifact(params, cfg)

        if args.ablation:
            from ssp_x_vit_tpu_torch.llm.ablations import run_ablations

            phases.start("ablation")
            result["ablation"] = run_ablations(params, cfg, c4_train_ids, wikitext_ids,
                                               calibration_2ssp, seq_len=args.seq_len,
                                               quick=args.ablation_quick)
            phases.stop()

        L = cfg.num_layers
        sr = args.sparsity_rate
        if args.pruning_method is None:
            pruning_rates: List[float] = []
        elif sr is not None and int(round(sr)) == -1:
            pruning_rates = [i / L for i in range(1, L - 1)]
        elif sr is not None and int(round(sr)) == -2:
            pruning_rates = [0.25, 0.375, 0.5]
        else:
            pruning_rates = [sr]
        # 2SSP's accounting (MoE DeepSeek configs have none; 2SSP refuses them)
        main_before = P.count_main_params(cfg)[0] if args.pruning_method == "2ssp" else None

        for target_sparsity in pruning_rates:
            set_seed(args.seed)
            start_time = time.time()
            work_params, work_cfg = params, cfg
            attn_mask = mlp_mask = None
            entry: Dict[str, Any] = {"method": args.pruning_method}

            if args.pruning_method in ("window_based", "shortgpt", "blockpruner", "evopress"):
                tsb = target_sparsity * L
                if not float(tsb).is_integer():
                    logging.warning(f"Invalid sparsity rate for {args.pruning_method}: must be a "
                                    f"multiple of 1/{L} since model has {L} blocks.")
                    tsb = int(math.ceil(tsb))
                    logging.warning(f"Rounding to next valid sparsity rate: {tsb/L:.6f} ({tsb} blocks)")
                else:
                    tsb = int(tsb)
                target_sparsity = tsb / L
            logging.info(f"Pruning rate {target_sparsity*100} "
                         f"(equivalent of {target_sparsity * L} blocks)")
            entry["target_sparsity"] = target_sparsity

            phases.start("search")
            if args.pruning_method == "window_based":
                attn_mask = mlp_mask = P.window_based(params, cfg, tsb, calibration)
            elif args.pruning_method == "shortgpt":
                attn_mask = mlp_mask = P.shortgpt(params, cfg, tsb, calibration)
            elif args.pruning_method == "blockpruner":
                attn_mask, mlp_mask = P.blockpruner(params, cfg, tsb, first_sample,
                                                    seq_len=args.seq_len)
            elif args.pruning_method == "evopress":
                from ssp_x_vit_tpu_torch.llm.evopress import DEFAULT_ARGS, evopress

                # reference protocol: the calibration pool holds calibration_tokens
                # (131072) so the 2048/32768-token selection minibatches draw uncapped
                # (src/evopress.py:152-160); fewer windows fire selection()'s cap warning
                n_cal = max(1, DEFAULT_ARGS["calibration_tokens"] // args.seq_len)
                entry["evopress"] = []
                attn_mask, mlp_mask = evopress(
                    params, cfg, tsb, calibration[:n_cal], num_generations=args.evopress_generations,
                    seed=args.seed, on_phase=phases.start, history=entry["evopress"])
            elif args.pruning_method == "slicegpt":
                from ssp_x_vit_tpu_torch.llm.slicegpt import slicegpt

                work_params, work_cfg = slicegpt(params, cfg, target_sparsity, calibration,
                                                 on_phase=phases.start)
                entry["new_dim"] = work_cfg.new_dim
            else:  # 2ssp: its own phases (stats, stage1, candidates, materialize)
                out = P.two_stage_2ssp(params, cfg, calibration_2ssp, target_sparsity,
                                       seq_len=args.seq_len, on_phase=phases.start)
                if out is False:
                    phases.stop()
                    continue
                work_params, work_cfg, info = out
                logging.info(f"2SSP pruned attention blocks: {info['pruned_attention_blocks']}, "
                             f"kept FFN width: {info['num_preserve_mlp']}")
                entry["pruned_attention_blocks"] = info["pruned_attention_blocks"]
                entry["num_preserve_mlp"] = info["num_preserve_mlp"]
                entry["achieved_sparsity"] = 1.0 - P.count_main_params(work_cfg)[0] / main_before
            phases.stop()
            entry["pruning_seconds"] = time.time() - start_time
            logging.info(f"Pruning Time: {entry['pruning_seconds']} s")

            suffix = f"sparsity_{target_sparsity:g}" if len(pruning_rates) > 1 else None
            if attn_mask is None:
                entry.update(run_evals(work_params, work_cfg))
                if args.save_model:
                    entry["saved"] = save_artifact(work_params, work_cfg, suffix)
            else:
                logging.debug(f"Pruned blocks: attn={attn_mask} mlp={mlp_mask}")
                entry["attn_mask"], entry["mlp_mask"] = list(attn_mask), list(mlp_mask)
                ga = 1.0 - np.asarray(attn_mask, np.float32)
                gm = 1.0 - np.asarray(mlp_mask, np.float32)
                entry.update(run_evals(params, cfg, attn_gate=ga, mlp_gate=gm))
                if args.save_model:
                    try:
                        mp, mc = materialize_masked(params, cfg, attn_mask, mlp_mask)
                    except ValueError as e:
                        logging.warning(f"--save-model skipped: {e}")
                    else:
                        entry["saved"] = save_artifact(mp, mc, suffix)
            result["runs"].append(entry)
    finally:
        dispatch.set_w8a8_enabled(False)
        phases.stop()

    result["phase_seconds"] = phases.seconds
    result["kernel_launches"] = phases.launches
    return result


def main(argv=None) -> Dict[str, Any]:
    args = build_argparser().parse_args(argv)
    logging.basicConfig(level=getattr(logging, args.logging.upper()),
                        format='%(asctime)s - %(levelname)s - %(message)s', datefmt='%H:%M:%S')
    return run(args)


if __name__ == "__main__":
    main()
