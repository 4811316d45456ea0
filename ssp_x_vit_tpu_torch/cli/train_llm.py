"""Finetune / recovery-train an LLM, CE or knowledge distillation (counterpart
of ``ssp_x_vit_tpu/cli/train_llm.py``, with the same flags).

Usage (on the card; ``--backend cpu`` runs the plain PyTorch path instead)::

    # a fresh bf16 model of a given shape on the synthetic token stream
    python -m ssp_x_vit_tpu_torch.cli.train_llm --init-json cfg.json --steps 4 \\
        --batch-size 1 --seq-len 2048 --synthetic-data
    # train on a save_to_disk corpus directory that holds a byte-level tokenizer.json
    python -m ssp_x_vit_tpu_torch.cli.train_llm --model ckpts/code_llm_small \\
        --data corpus_dir --steps 200 --batch-size 4 --seq-len 512
    # continue training a native model on a pre-tokenized uint16 corpus
    python -m ssp_x_vit_tpu_torch.cli.train_llm --model ckpts/code_llm_small \\
        --data-bin ckpts/code_llm_small/corpus_slice/train.bin --steps 200 \\
        --checkpoint-dir /tmp/ck
    # KD recovery of a pruned model against its dense teacher
    python -m ssp_x_vit_tpu_torch.cli.train_llm --model pruned_dir --teacher dense_dir

``--model`` / ``--teacher`` take a native model directory (``model.npz`` +
``config.json``), a local HF directory (``config.json`` + ``*.safetensors``;
mixtral and qwen3_moe included) or a ``tiny-random*`` alias (the DeepSeek/MLA
``tiny-random-deepseek[-dense]`` too); ``--init-json`` takes a JSON dict of
``LlamaConfig`` fields (or a file holding one; ``num_experts`` > 0 makes an
MoE model) and makes a fresh bf16 model. Checkpoints are ``torch.save``
files (params, optimizer state, update); rerunning with the same ``--checkpoint-dir`` resumes where the
previous run stopped. ``--save-model`` writes the trained model as a native
directory, or with ``--save-format hf`` as an HF one (``export_hf_llama``).
``--data DIR`` trains on the ``text`` column of a ``datasets.save_to_disk``
directory (``llm/arrow_ipc.py``) tokenized by the directory's byte-level
``tokenizer.json`` (the JAX CLI calls ``transformers.AutoTokenizer``; any other
tokenizer raises naming ROADMAP.md A.10f); a directory that holds no corpus
falls back to the synthetic stream with the JAX CLI's warning.

``run(args)`` returns a dict: the history of ``[TRAIN-LOG]`` records, the
final loss, the run's seconds and the trained (params, cfg).
"""

from __future__ import annotations

import argparse
import functools
import json
import logging
import os
import time
from typing import Any, Dict

import numpy as np


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", default=None,
                   help="Native or HF model dir, or a tiny-random* alias (required unless "
                        "--init-json)")
    p.add_argument("--teacher", default=None,
                   help="Dense teacher (dir or alias): enables KD recovery (CE + T^2*KL)")
    p.add_argument("--kd-alpha", type=float, default=0.5)
    p.add_argument("--kd-temperature", type=float, default=2.0)
    p.add_argument("--steps", type=int, default=100, help="Optimizer updates")
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--seq-len", type=int, default=512)
    p.add_argument("--accum", type=int, default=1,
                   help="Gradient-accumulation microbatches per update")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--warmup", type=int, default=0)
    p.add_argument("--schedule", choices=["cosine", "linear", "constant"], default="cosine")
    p.add_argument("--weight-decay", type=float, default=0.01)
    p.add_argument("--grad-clip", type=float, default=1.0)
    p.add_argument("--compute-dtype", choices=["bfloat16", "float32"], default="bfloat16")
    p.add_argument("--no-remat", action="store_true")
    p.add_argument("--data", default=None,
                   help="A datasets.save_to_disk directory whose text column is tokenized by "
                        "its byte-level tokenizer.json; one that fails to load falls back to "
                        "the synthetic token stream")
    p.add_argument("--data-bin", default=None,
                   help="Pre-tokenized uint16 token-id file (memmapped)")
    p.add_argument("--init-json", default=None,
                   help="JSON dict of LlamaConfig fields (or a file): fresh-init a bf16 "
                        "model of that shape instead of loading --model")
    p.add_argument("--synthetic-data", action="store_true",
                   help="Force the deterministic synthetic stream")
    p.add_argument("--num-tokens", type=int, default=None,
                   help="Training tokens to draw (default: enough for steps*accum batches)")
    p.add_argument("--eval-every", type=int, default=0,
                   help="Perplexity eval cadence (updates); 0 disables")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=100)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--save-model", default=None, help="Write the trained model here when done")
    p.add_argument("--save-format", choices=["native", "hf"], default="native")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--backend", default="cuda", choices=["cuda", "cpu"],
                   help="Device to run on; cuda raises when no GPU is present")
    return p


def _load_any(name: str, seed: int, device):
    from ssp_x_vit_tpu_torch.cli.main_llm import load_model

    return load_model(argparse.Namespace(model=name, seed=seed), device)


def _token_batches(args, cfg):
    """(microbatches [b, s+1], stream for eval): deterministic and restartable
    for resume, as the JAX CLI makes them."""
    from ssp_x_vit_tpu_torch.llm.datasets import (
        load_wikitext2, synthetic_token_stream, tokenize_corpus,
    )
    from ssp_x_vit_tpu_torch.llm.tokenizer import load_tokenizer

    n_micro = args.steps * args.accum
    per = args.batch_size * (args.seq_len + 1)
    if args.data_bin:
        ids = np.memmap(args.data_bin, dtype=np.uint16, mode="r")
        n = min(n_micro, ids.size // per)
        if n == 0:
            raise SystemExit(f"need >= {per} tokens/microbatch, got {ids.size}")

        def gen():
            # windows off the memmap; wrap around when the corpus is shorter
            # than the schedule (multi-epoch)
            for k in range(n_micro):
                off = (k % n) * per
                yield np.asarray(ids[off:off + per], np.int32).reshape(
                    args.batch_size, args.seq_len + 1)

        # held-out eval: the sibling val.bin when present
        val_bin = os.path.join(os.path.dirname(args.data_bin), "val.bin")
        ev = np.memmap(val_bin, dtype=np.uint16, mode="r") if os.path.exists(val_bin) else ids
        return gen(), np.asarray(ev[-64 * (args.seq_len + 1):], np.int32)
    ids = None
    if args.data and not args.synthetic_data:
        texts = load_wikitext2(args.data)
        if texts is None:
            logging.warning(f"dataset load failed (no corpus at {args.data}); synthetic fallback")
        else:
            # a directory without a byte-level tokenizer.json raises naming ROADMAP.md A.10f
            tok = load_tokenizer(args.data)
            try:
                ids = tokenize_corpus(texts, tok)
            except TypeError as e:      # a null row: "\n\n".join fails, as in the JAX CLI
                logging.warning(f"dataset load failed ({e}); synthetic fallback")
    if ids is None:
        need = args.num_tokens or n_micro * per
        ids = synthetic_token_stream(need, cfg.vocab_size, seed=args.seed)
    ids = ids.reshape(-1)
    n = min(n_micro, ids.size // per)
    if n == 0:
        raise SystemExit(f"need >= {per} tokens for one microbatch, got {ids.size}")
    return list(ids[: n * per].reshape(n, args.batch_size, args.seq_len + 1)), ids


def run(args) -> Dict[str, Any]:
    import torch

    from ssp_x_vit_tpu_torch.device import resolve_device
    from ssp_x_vit_tpu_torch.utils.seeding import set_seed
    from ssp_x_vit_tpu_torch.llm.checkpoints import (
        config_from_dict, export_hf_llama, save_llm_model,
    )
    from ssp_x_vit_tpu_torch.llm.model import init_llama_params
    from ssp_x_vit_tpu_torch.llm.trainer import TrainConfig, Trainer

    device = resolve_device(args.backend)
    set_seed(args.seed)
    if args.init_json:
        if os.path.exists(args.init_json):
            with open(args.init_json) as f:
                cfg = config_from_dict(json.load(f))
        else:
            cfg = config_from_dict(json.loads(args.init_json))
        gen = torch.Generator(device=device)
        gen.manual_seed(args.seed)
        params = init_llama_params(gen, cfg, dtype=torch.bfloat16, device=device)
    else:
        if not args.model:
            raise SystemExit("pass --model or --init-json")
        params, cfg = _load_any(args.model, args.seed, device)
    tc = TrainConfig(
        learning_rate=args.lr, total_steps=args.steps, warmup_steps=args.warmup,
        schedule=args.schedule, weight_decay=args.weight_decay, grad_clip=args.grad_clip,
        accum_steps=args.accum, compute_dtype=args.compute_dtype, remat=not args.no_remat,
        log_every=args.log_every, checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every)

    step_factory = None
    if args.teacher:
        from ssp_x_vit_tpu_torch.llm.train import make_distill_train_step

        t_params, t_cfg = _load_any(args.teacher, args.seed, device)
        if t_cfg.vocab_size != cfg.vocab_size:
            raise SystemExit("teacher and student must share a vocab")
        step_factory = functools.partial(make_distill_train_step, t_params, t_cfg,
                                         alpha=args.kd_alpha, temperature=args.kd_temperature)

    batches, stream = _token_batches(args, cfg)
    eval_tokens = stream[-4 * (args.seq_len + 1):] if args.eval_every else None

    t0 = time.perf_counter()
    trainer = Trainer(cfg, tc, step_factory=step_factory)
    params, history = trainer.fit(params, batches, eval_tokens=eval_tokens,
                                  eval_every=args.eval_every, eval_seq_len=args.seq_len)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    final = [h for h in history if "loss" in h]
    if final:
        logging.info(f"[SUMMARY] {{\"final_loss\": {final[-1]['loss']}, "
                     f"\"updates\": {final[-1]['update']}}}")
    if args.save_model:
        fn = export_hf_llama if args.save_format == "hf" else save_llm_model
        path = fn(args.save_model, params, cfg)
        logging.info(f"[ARTIFACT] {args.save_format} model -> {path}")
    return {"history": history, "final_loss": final[-1]["loss"] if final else None,
            "seconds": seconds, "params": params, "cfg": cfg}


def main(argv=None) -> Dict[str, Any]:
    args = build_argparser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    return run(args)


if __name__ == "__main__":
    main()
