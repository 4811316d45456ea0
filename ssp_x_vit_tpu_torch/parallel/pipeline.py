"""Pipeline + tensor + data parallel LLM execution (counterpart of
``ssp_x_vit_tpu/parallel/pipeline.py``).

A ``(data, pipe, model)`` mesh (``mesh.make_pipeline_mesh``), one process per
card. Stage p holds the contiguous layers ``[p * L / P, (p + 1) * L / P)``,
cut for tensor parallelism over ``model`` as ``llm_sharding.llama_shard``
cuts them; the embedding, final norm and head are whole on every rank. A
stage runs its layers through ``llm/model.py``'s ``_llama_layer`` with the
``model`` group (so its attention launches the flash kernel, row 5, and under
autograd its backward kernels, row 6); each layer keeps its own window
(gemma-2's mixed configs). Each data rank takes its contiguous rows of the
batch and cuts them into ``num_microbatches`` microbatches.

Where JAX runs one lockstep ``lax.scan`` over ticks with a wrap-around
``ppermute``, the ranks here run a real point-to-point schedule
(``collectives.py``):

- **GPipe** (the forward, and ``schedule="gpipe"``): every microbatch goes
  stage to stage through ``send_next`` / ``recv_prev``; under autograd their
  backward is the reverse hand-off of the cotangent, so a ``backward()`` a
  microbatch, the last first on every rank (the last stage's of its loss, the
  others' of their hand-off's zero output), runs the drain. The forward broadcasts the last stage's hidden states over
  ``pipe`` and every rank returns the logits of its rows (JAX's ``psum`` over
  ``pipe``).
- **1F1B** (``schedule="1f1b"``): JAX's tick rule, stage p forwards
  microbatch m at ``t = m + p`` (without grad) and backwards it at
  ``t = m + 2P - 2 - p``, re-running the stage forward under autograd from
  the input saved in a buffer of ``2P - 1`` slots, then
  ``torch.autograd.backward(y, ct)``. A tick's hand-offs (the previous
  tick's output forward and input cotangent back, this tick's input and
  output cotangent) are one ``batch_isend_irecv``. Stage 0 re-runs the
  embedding lookup under autograd (its transpose is the lookup's backward),
  the last stage the head and loss.

Gradients: the stage's blocks are averaged over ``data``; the embedding,
norm and head leaves are summed over ``pipe`` (only stage 0 and the last stage
touch them) and averaged over ``data``. The Megatron collectives of the block
make a replicated leaf's gradient whole on every ``model`` rank, so nothing
is reduced over ``model`` (JAX's partial convention psums there instead).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ssp_x_vit_tpu_torch.parallel.collectives import (
    all_reduce_sum, exchange, recv_prev, send_next, warm_group,
)
from ssp_x_vit_tpu_torch.parallel.mesh import axis_index, axis_size
from ssp_x_vit_tpu_torch.parallel.mesh import make_pipeline_mesh  # noqa: F401  (JAX's name here)

Spec = Tuple[Optional[str], ...]
Params = Dict[str, Any]
SCHEDULES = ("gpipe", "1f1b")


def pipeline_block_specs(cfg) -> Dict[str, Spec]:
    """JAX's PartitionSpecs (as tuples) of the stacked blocks on a (data, pipe,
    model) mesh: the layer axis over ``pipe``, Megatron's axes over ``model``."""
    if cfg.is_phi:
        return {
            "ln1": ("pipe", None), "ln1_bias": ("pipe", None),
            "q_kernel": ("pipe", None, "model"), "q_bias": ("pipe", "model"),
            "k_kernel": ("pipe", None, "model"), "k_bias": ("pipe", "model"),
            "v_kernel": ("pipe", None, "model"), "v_bias": ("pipe", "model"),
            "o_kernel": ("pipe", "model", None), "o_bias": ("pipe", None),
            "fc1_kernel": ("pipe", None, "model"), "fc1_bias": ("pipe", "model"),
            "fc2_kernel": ("pipe", "model", None), "fc2_bias": ("pipe", None),
        }
    specs = {
        "ln1": ("pipe", None),
        "q_kernel": ("pipe", None, "model"),
        "k_kernel": ("pipe", None, "model"),
        "v_kernel": ("pipe", None, "model"),
        "o_kernel": ("pipe", "model", None),
        "ln2": ("pipe", None),
        "gate_kernel": ("pipe", None, "model"),
        "up_kernel": ("pipe", None, "model"),
        "down_kernel": ("pipe", "model", None),
    }
    if cfg.qkv_bias:
        specs.update(q_bias=("pipe", "model"), k_bias=("pipe", "model"),
                     v_bias=("pipe", "model"))
    if cfg.is_gemma2:
        specs.update(ln1_post=("pipe", None), ln2_post=("pipe", None))
    return specs


def _stage_layers(mesh, num_layers: int) -> range:
    P, p = axis_size(mesh, "pipe"), axis_index(mesh, "pipe")
    n = num_layers // P
    return range(p * n, (p + 1) * n)


def shard_llama_params_pipeline(params: Params, mesh, cfg) -> Params:
    """This rank's pipeline shard: its stage's layers cut over ``model``
    (``llm_sharding.llama_shard``), the top-level leaves whole."""
    from ssp_x_vit_tpu_torch.parallel.llm_sharding import llama_shard

    _check_llama(mesh, cfg)
    layers = _stage_layers(mesh, cfg.num_layers)
    stage = dict(params, blocks={k: v[layers.start:layers.stop]
                                 for k, v in params["blocks"].items()})
    cut = llama_shard(stage, cfg, axis_index(mesh, "model"), axis_size(mesh, "model"))
    return dict(params, blocks=cut["blocks"])


def _check_llama(mesh, cfg) -> None:
    n_pipe, tp = axis_size(mesh, "pipe"), axis_size(mesh, "model")
    if cfg.num_layers % n_pipe:
        raise ValueError(f"num_layers {cfg.num_layers} % pipe {n_pipe} != 0")
    for name, v in (("num_heads", cfg.num_heads), ("num_kv_heads", cfg.num_kv_heads),
                    ("intermediate_size", cfg.intermediate_size)):
        if v % tp:
            raise ValueError(f"{name} {v} % model {tp} != 0")
    if cfg.is_opt:
        raise ValueError("pipeline path covers llama-layout (incl. gemma/"
                         "gemma-2) and phi configs (OPT's learned-position "
                         "table tops out at 2048)")
    if cfg.num_experts:
        raise ValueError("MoE blocks run expert-parallel (parallel/moe.py) "
                         "or FSDP, not the pipeline TP block")


class Schedule:
    """The pipeline schedules over one family's pieces: ``embed(tree, toks)``
    (stage 0's input), ``stage(tree, x, rope)`` (this rank's layers),
    ``head(tree, y)`` (fp32 logits), ``rope(s, device)`` (tables shared by the
    stage's layers)."""

    def __init__(self, mesh, *, num_microbatches: int, hidden: int, compute_dtype,
                 embed: Callable, stage: Callable, head: Callable, rope: Callable):
        self.M, self.d, self.dt = num_microbatches, hidden, compute_dtype
        self.embed, self.stage_fn, self.head, self.rope = embed, stage, head, rope
        self.P, self.p = axis_size(mesh, "pipe"), axis_index(mesh, "pipe")
        self.dp, self.di = axis_size(mesh, "data"), axis_index(mesh, "data")
        self.pg, self.dg = mesh.get_group("pipe"), mesh.get_group("data")
        self.held_max = 0   # the most saved stage inputs 1F1B held at once

    # ------------------------------------------------------------- helpers ---
    def local_rows(self, tokens, device) -> torch.Tensor:
        tokens = torch.as_tensor(np.asarray(tokens.cpu() if isinstance(tokens, torch.Tensor)
                                            else tokens), dtype=torch.int64)
        b = tokens.shape[0]
        if b % self.M:
            raise ValueError(f"batch {b} % num_microbatches {self.M} != 0")
        if b % (self.M * self.dp):
            raise ValueError(f"batch {b} does not split into {self.M} microbatches over "
                             f"data={self.dp}")
        n = b // self.dp
        return tokens[self.di * n:(self.di + 1) * n].to(device)

    def _micro(self, tokens: torch.Tensor, m: int) -> torch.Tensor:
        mb = tokens.shape[0] // self.M
        return tokens[m * mb:(m + 1) * mb]

    def _shape(self, tokens: torch.Tensor):
        return (tokens.shape[0] // self.M, tokens.shape[1], self.d)

    def _nll(self, tree, y, toks) -> torch.Tensor:
        logits = self.head(tree, y)
        return F.cross_entropy(logits[:, :-1].float().reshape(-1, logits.shape[-1]),
                               toks[:, 1:].reshape(-1))

    # -------------------------------------------------------------- GPipe ---
    def gpipe(self, tree, tokens: torch.Tensor, grad: bool):
        """All microbatches through the stages: (the last stage's outputs, the
        zero scalars of this stage's forward hand-offs)."""
        device = tokens.device
        warm_group(self.pg, device)
        rope = self.rope(tokens.shape[1], device)
        outs, anchors = [], []
        for m in range(self.M):
            if self.p == 0:
                x = self.embed(tree, self._micro(tokens, m))
            else:
                x = recv_prev(self._shape(tokens), self.dt, device, self.pg, requires_grad=grad)
            y = self.stage_fn(tree, x, rope)
            if self.p < self.P - 1:
                anchors.append(send_next(y, self.pg))
            else:
                outs.append(y)
        return outs, anchors

    @torch.no_grad()
    def forward(self, params, tokens) -> torch.Tensor:
        """Logits [b / dp, s, V] fp32 of this data rank's rows, on every rank."""
        device = params["embed"].device
        tokens = self.local_rows(tokens, device)
        outs, _ = self.gpipe(params, tokens, grad=False)
        if self.p == self.P - 1:
            hidden = torch.cat(outs, dim=0)
        else:
            hidden = torch.empty(tokens.shape + (self.d,), dtype=self.dt, device=device)
        if self.P > 1:
            dist.broadcast(hidden, src=dist.get_global_rank(self.pg, self.P - 1),
                           group=self.pg)
        return self.head(params, hidden)

    def gpipe_backward(self, tree, tokens: torch.Tensor) -> torch.Tensor:
        """All forwards, then the drain: one backward a microbatch, the last
        first on every rank (the last stage's of its loss / M, the others' of
        their hand-off's zero scalar), so the reverse hand-offs pair up. Returns
        the mean loss of this rank's rows (0 off the last stage)."""
        outs, anchors = self.gpipe(tree, tokens, grad=True)
        loss = torch.zeros((), device=tokens.device)
        for m in reversed(range(self.M)):
            if self.p == self.P - 1:
                loss_m = self._nll(tree, outs[m], self._micro(tokens, m)) / self.M
                loss = loss + loss_m.detach()
                loss_m.backward()
            else:
                anchors[m].backward()
        return loss

    # --------------------------------------------------------------- 1F1B ---
    def one_f_one_b(self, tree, tokens: torch.Tensor) -> torch.Tensor:
        """Runs the 1F1B schedule, leaving each leaf's gradient in ``.grad``;
        returns the mean loss of this rank's rows (0 off the last stage)."""
        P, p, M = self.P, self.p, self.M
        device = tokens.device
        warm_group(self.pg, device)
        rope = self.rope(tokens.shape[1], device)
        shape = self._shape(tokens)
        slots = 2 * P - 1
        buf: Dict[int, torch.Tensor] = {}
        send_y = send_dx = None
        loss = torch.zeros((), device=device)
        for t in range(M + 2 * P - 2):
            m_f, m_b = t - p, t - (2 * P - 2 - p)
            fwd, bwd = 0 <= m_f < M, 0 <= m_b < M
            sends = [(x, off) for x, off in ((send_y, 1), (send_dx, -1)) if x is not None]
            recvs = []
            if fwd and p > 0:
                recvs.append((torch.empty(shape, dtype=self.dt, device=device), -1))
            if bwd and p < P - 1:
                recvs.append((torch.empty(shape, dtype=self.dt, device=device), 1))
            got = exchange(sends, recvs, self.pg).wait() if (sends or recvs) else []
            send_y = send_dx = None
            if fwd:
                toks = self._micro(tokens, m_f)
                with torch.no_grad():
                    x = self.embed(tree, toks) if p == 0 else got.pop(0)
                    if m_f % slots in buf:
                        raise AssertionError(f"1F1B slot {m_f % slots} still held")
                    buf[m_f % slots] = x
                    self.held_max = max(self.held_max, len(buf))
                    if p < P - 1:
                        send_y = self.stage_fn(tree, x, rope)
            if bwd:
                toks = self._micro(tokens, m_b)
                x = buf.pop(m_b % slots)
                with torch.enable_grad():
                    xg = self.embed(tree, toks) if p == 0 else x.detach().requires_grad_(True)
                    y = self.stage_fn(tree, xg, rope)
                    if p == P - 1:
                        loss_m = self._nll(tree, y, toks)
                        (loss_m / M).backward()
                        loss = loss + loss_m.detach() / M
                    else:
                        torch.autograd.backward(y, got.pop(-1))
                if p > 0:
                    send_dx = xg.grad
        return loss

    # ------------------------------------------------------- gradients ---
    def reduce(self, params, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """Block gradients averaged over data; top-level ones summed over pipe,
        then averaged over data (aligned with ``optim.tree_leaves``)."""
        out, i = [], 0
        for k, v in params.items():
            n = (sum(t.shape[0] for t in v.values()) if isinstance(v, dict) else 1)
            for g in grads[i:i + n]:
                if not isinstance(v, dict):
                    all_reduce_sum(g, self.pg)
                out.append(all_reduce_sum(g, self.dg).div_(self.dp))
            i += n
        return out

    def loss_value(self, loss: torch.Tensor) -> torch.Tensor:
        """The global mean loss from each rank's share (0 off the last stage)."""
        return all_reduce_sum(all_reduce_sum(loss.clone(), self.pg), self.dg).div_(self.dp)


def _llama_pieces(mesh, cfg, compute_dtype):
    from ssp_x_vit_tpu_torch.llm.model import (
        _embed_tokens, _final_norm, _head_logits, _llama_layer, rope_tables,
    )

    layers = _stage_layers(mesh, cfg.num_layers)
    tp = mesh.get_group("model")

    def embed(tree, toks):
        return _embed_tokens(tree, toks, cfg, compute_dtype)

    def stage(tree, x, rope):
        blocks = tree["blocks"]
        for j, i in enumerate(layers):
            bp = {k: v[j] for k, v in blocks.items()}
            x = _llama_layer(x, bp, i, cfg, compute_dtype, rope, None, None, None, False,
                             "sumsq", tp)[0]
        return x

    def head(tree, y):
        return _head_logits(tree, _final_norm(tree, y, cfg), compute_dtype, cfg.final_softcap)

    return dict(embed=embed, stage=stage, head=head,
                rope=lambda s, device: rope_tables(s, cfg, device))


def make_pipeline_forward(mesh, cfg, *, num_microbatches: int, compute_dtype=torch.float32):
    """``forward(params, tokens [b, s]) -> logits [b / dp, s, V]`` fp32 of this
    data rank's rows (contiguous), on every rank of its pipe and model lines;
    ``params`` this rank's ``shard_llama_params_pipeline``."""
    _check_llama(mesh, cfg)
    return Schedule(mesh, num_microbatches=num_microbatches, hidden=cfg.hidden_size,
                    compute_dtype=compute_dtype,
                    **_llama_pieces(mesh, cfg, compute_dtype)).forward


def _pipe_model_group(mesh):
    """The group of this rank's (pipe, model) plane, over which a block leaf
    cut on both axes sums its squared norm."""
    grid = mesh.mesh
    if grid.numel() == dist.get_world_size() and grid.shape[0] == 1:
        return dist.group.WORLD
    mine = None
    for d in range(grid.shape[0]):   # every rank makes every plane's group, in order
        ranks = grid[d].reshape(-1).tolist()
        g = dist.new_group(ranks)
        if dist.get_rank() in ranks:
            mine = g
    return mine


def _train_step(mesh, cfg, sched: Schedule, optimizer, schedule: str, block_specs):
    from ssp_x_vit_tpu_torch.llm.optim import AdamW
    from ssp_x_vit_tpu_torch.llm.train import frozen_leaves, trainable_tree

    if schedule not in SCHEDULES:
        raise ValueError(f"unknown pipeline schedule {schedule!r} (gpipe | 1f1b)")
    optimizer = optimizer or AdamW(1e-4)
    plane = _pipe_model_group(mesh)

    def grads(params, tokens) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        tree, leaves = trainable_tree(params)
        local = sched.local_rows(tokens, params["embed"].device)
        if schedule == "gpipe":
            loss = sched.gpipe_backward(tree, local)
        else:
            loss = sched.one_f_one_b(tree, local)
        gs = [leaf.grad if leaf.grad is not None else torch.zeros_like(leaf) for leaf in leaves]
        return sched.loss_value(loss), sched.reduce(params, gs)

    def norm_groups(params) -> List:
        out: List = []
        for k, v in params.items():
            if isinstance(v, dict):
                for bk, bv in v.items():
                    spec = block_specs(k, bk, bv)
                    g = plane if "model" in spec else sched.pg
                    out += [g] * bv.shape[0]
            else:
                out.append(None)
        return out

    def step(params: Params, opt_state: Dict, tokens):
        loss, gs = grads(params, tokens)
        optimizer.apply(params, gs, opt_state, frozen=frozen_leaves(params, cfg),
                        norm_groups=norm_groups(params))
        return params, opt_state, loss

    step.grads = grads
    step.schedule = sched
    return step


def make_pipeline_train_step(mesh, cfg, optimizer=None, *, num_microbatches: int,
                             compute_dtype=torch.float32, schedule: str = "gpipe"):
    """``step(params, opt_state, tokens) -> (params, opt_state, loss)`` on a
    ``shard_llama_params_pipeline`` shard, updated in place
    (``opt_state = optimizer.init(shard)``; ``optimizer`` an ``optim.AdamW``,
    default ``AdamW(1e-4)``). ``schedule``: ``"gpipe"`` (autograd through the
    hand-offs: every stage holds all M microbatches' activations) or
    ``"1f1b"`` (:func:`make_pipeline_train_step_1f1b`). The loss is the global
    mean on every rank; ``step.grads(params, tokens)`` returns (loss, the
    reduced gradients) without updating."""
    if schedule == "1f1b":
        return make_pipeline_train_step_1f1b(mesh, cfg, optimizer,
                                             num_microbatches=num_microbatches,
                                             compute_dtype=compute_dtype)
    if schedule != "gpipe":
        raise ValueError(f"unknown pipeline schedule {schedule!r} (gpipe | 1f1b)")
    return _llama_train_step(mesh, cfg, optimizer, num_microbatches, compute_dtype, "gpipe")


def make_pipeline_train_step_1f1b(mesh, cfg, optimizer=None, *, num_microbatches: int,
                                  compute_dtype=torch.float32):
    """The 1F1B step: the same shard, loss and update as the GPipe step; each
    stage holds at most ``2P - 1`` saved stage inputs whatever M
    (``step.schedule.held_max`` after a step)."""
    return _llama_train_step(mesh, cfg, optimizer, num_microbatches, compute_dtype, "1f1b")


def _llama_train_step(mesh, cfg, optimizer, num_microbatches, compute_dtype, schedule):
    from ssp_x_vit_tpu_torch.parallel.llm_sharding import _block_key_spec

    _check_llama(mesh, cfg)
    sched = Schedule(mesh, num_microbatches=num_microbatches, hidden=cfg.hidden_size,
                     compute_dtype=compute_dtype, **_llama_pieces(mesh, cfg, compute_dtype))
    return _train_step(mesh, cfg, sched, optimizer, schedule,
                       lambda group, key, v: _block_key_spec(key, v.dim()))
