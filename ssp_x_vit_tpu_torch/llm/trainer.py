"""Training loop: schedules, accumulation, clipping, resume (counterpart of
``ssp_x_vit_tpu/llm/trainer.py``).

A deterministic, resumable loop over the train steps of :mod:`.train`:

- learning-rate schedules: linear warmup into cosine / linear / constant
  decay, counted in optimizer updates (``llm/optim.py``, optax's semantics);
- gradient accumulation over ``accum_steps`` microbatches per update (the
  running mean of ``optax.MultiSteps``), equal to one large batch;
- global-norm gradient clipping ahead of AdamW;
- checkpoint / resume: ``torch.save`` of (params, optimizer state, update)
  every ``checkpoint_every`` updates (:mod:`ssp_x_vit_tpu_torch.utils.
  checkpointing`); ``fit`` resumes from the newest checkpoint in
  ``checkpoint_dir`` and, the kernels being deterministic, a killed run ends
  bit-identical to an uninterrupted one (the data iterator must be
  deterministic and restartable);
- ``[TRAIN-LOG] {json}`` lines every ``log_every`` updates and an in-memory
  history.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Callable, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ssp_x_vit_tpu_torch.llm.model import LlamaConfig, Params
from ssp_x_vit_tpu_torch.llm.optim import (
    AdamW, Schedule, constant_schedule, cosine_decay_schedule, join_schedules, linear_schedule,
)
from ssp_x_vit_tpu_torch.llm.train import make_llama_train_step

__all__ = ["TrainConfig", "make_schedule", "make_optimizer", "Trainer"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Hyperparameters for one finetune/recovery run."""

    learning_rate: float = 1e-4
    total_steps: int = 1000           # optimizer updates (not microbatches)
    warmup_steps: int = 0
    schedule: str = "cosine"          # cosine | linear | constant
    end_lr_ratio: float = 0.1         # decay floor as a fraction of peak
    weight_decay: float = 0.01
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: Optional[float] = 1.0  # global-norm; None disables
    accum_steps: int = 1              # microbatches per optimizer update
    compute_dtype: str = "bfloat16"
    remat: bool = True
    log_every: int = 10
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 100

    def __post_init__(self):
        if self.schedule not in ("cosine", "linear", "constant"):
            raise ValueError(f"unknown schedule {self.schedule!r}")
        if self.accum_steps < 1:
            raise ValueError("accum_steps must be >= 1")
        if self.warmup_steps >= self.total_steps and self.total_steps > 0 \
                and self.schedule != "constant":
            raise ValueError("warmup_steps must be < total_steps")


def make_schedule(tc: TrainConfig) -> Schedule:
    """Warmup + decay over optimizer updates (accumulation microbatches do not
    advance it)."""
    peak, end = tc.learning_rate, tc.learning_rate * tc.end_lr_ratio
    decay_steps = max(tc.total_steps - tc.warmup_steps, 1)
    if tc.schedule == "constant":
        decay = constant_schedule(peak)
    elif tc.schedule == "linear":
        decay = linear_schedule(peak, end, decay_steps)
    else:
        decay = cosine_decay_schedule(peak, decay_steps, alpha=tc.end_lr_ratio)
    if tc.warmup_steps <= 0:
        return decay
    return join_schedules(linear_schedule(0.0, peak, tc.warmup_steps), decay, tc.warmup_steps)


def make_optimizer(tc: TrainConfig) -> AdamW:
    """clip -> adamw(schedule), accumulating ``accum_steps`` microbatches."""
    return AdamW(make_schedule(tc), b1=tc.b1, b2=tc.b2, weight_decay=tc.weight_decay,
                 grad_clip=tc.grad_clip, accum_steps=tc.accum_steps)


class Trainer:
    """Resumable training loop over a train step.

    ``step_factory`` defaults to :func:`make_llama_train_step`; pass
    ``make_distill_train_step`` partials (any factory with the same
    ``(cfg, optimizer, compute_dtype=, remat=) -> step`` signature) for KD
    recovery runs.
    """

    def __init__(self, cfg: LlamaConfig, tc: TrainConfig, *,
                 step_factory: Optional[Callable] = None):
        self.cfg, self.tc = cfg, tc
        self.optimizer = make_optimizer(tc)
        if tc.compute_dtype not in _DTYPES:
            raise ValueError(f"unknown compute_dtype {tc.compute_dtype!r}")
        factory = step_factory or make_llama_train_step
        self.step_fn = factory(cfg, self.optimizer, compute_dtype=_DTYPES[tc.compute_dtype],
                               remat=tc.remat)
        self.history: List[dict] = []

    # The loop counts microbatches (data consumed); checkpoints and the
    # schedule count optimizer updates: update = microbatch // accum_steps.

    def fit(self, params: Params, batches: Iterable[np.ndarray], *,
            eval_tokens: Optional[np.ndarray] = None, eval_every: int = 0,
            eval_seq_len: int = 128, verbose: bool = True) -> Tuple[Params, List[dict]]:
        """Run up to ``tc.total_steps`` optimizer updates.

        ``batches`` yields token arrays [b, s+1] (inputs + shifted targets); it
        must be deterministic and restartable from an offset for resume to be
        exact: the trainer skips the consumed microbatches after restoring a
        checkpoint. ``params`` is updated in place. Returns (params, history).
        """
        tc = self.tc
        opt_state = self.optimizer.init(params)
        start_update = 0
        if tc.checkpoint_dir:
            from ssp_x_vit_tpu_torch.utils.checkpointing import (
                latest_checkpoint, restore_train_state,
            )

            path = latest_checkpoint(tc.checkpoint_dir)
            if path is not None:
                params, opt_state, start_update = restore_train_state(path, params, opt_state)
                if verbose:
                    print(f"[TRAIN-LOG] "
                          f"{json.dumps({'resumed_from': path, 'update': start_update})}")

        it: Iterator[np.ndarray] = iter(batches)
        # replay the data stream to the resume point (deterministic iterator contract)
        for _ in range(start_update * tc.accum_steps):
            next(it)

        update = start_update
        t0 = time.perf_counter()
        tokens_seen = 0
        losses: List[float] = []
        while update < tc.total_steps:
            try:
                micro = [next(it) for _ in range(tc.accum_steps)]
            except StopIteration:
                break  # data exhausted: stop cleanly at the last full update
            for m in micro:
                params, opt_state, loss = self.step_fn(params, opt_state, np.asarray(m))
                tokens_seen += int(np.prod(np.shape(m)))
            update += 1
            losses.append(float(loss))  # loss of the update's last microbatch

            if tc.log_every and (update % tc.log_every == 0 or update == tc.total_steps):
                dt = time.perf_counter() - t0
                rec = {"update": update,
                       "loss": round(float(np.mean(losses[-tc.log_every:])), 6),
                       "lr": round(float(self.optimizer.schedule(update)), 8),
                       "tokens_seen": tokens_seen,
                       "tok_per_s": round(tokens_seen / max(dt, 1e-9), 1)}
                self.history.append(rec)
                if verbose:
                    print(f"[TRAIN-LOG] {json.dumps(rec)}", flush=True)

            if eval_tokens is not None and eval_every and update % eval_every == 0:
                from ssp_x_vit_tpu_torch.llm.evaluation import evaluate_perplexity

                ppl = evaluate_perplexity(params, self.cfg, eval_tokens, seq_len=eval_seq_len,
                                          enable_tqdm=False)
                rec = {"update": update, "eval_ppl": round(float(ppl), 4)}
                self.history.append(rec)
                if verbose:
                    print(f"[TRAIN-LOG] {json.dumps(rec)}", flush=True)

            if tc.checkpoint_dir and tc.checkpoint_every and update % tc.checkpoint_every == 0:
                from ssp_x_vit_tpu_torch.utils.checkpointing import save_train_state

                save_train_state(tc.checkpoint_dir, update, params, opt_state)

        if tc.checkpoint_dir and update > start_update:
            from ssp_x_vit_tpu_torch.utils.checkpointing import save_train_state

            save_train_state(tc.checkpoint_dir, update, params, opt_state)
        return params, self.history
