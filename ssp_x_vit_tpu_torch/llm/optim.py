"""The optimizer and learning-rate schedules of the training path, written to
optax's semantics (the JAX package uses ``optax.adamw``,
``optax.clip_by_global_norm``, ``optax.MultiSteps`` and optax schedules).

``AdamW`` applies ``clip_by_global_norm -> adamw`` in place, one parameter
leaf at a time: the stacked ``[L, ...]`` block tensors are walked layer by
layer (``tree_leaves``), so no temporary ever spans a whole stacked leaf.
What it keeps from optax, and what ``torch.optim`` would change:

- update k (counted from 0) uses ``schedule(k)``, as ``scale_by_schedule``
  does; with warmup the first update has learning rate 0 but still moves the
  moments;
- decoupled weight decay ``-lr * wd * p`` on every leaf, norms and
  embeddings included; eps added outside the square root of the
  bias-corrected second moment;
- the moments (and the accumulated gradients) are stored in the parameter
  dtype: bf16 for a bf16 model. The arithmetic of one update runs in fp32,
  in place where the leaf is fp32, and rounds once per stored tensor (optax
  rounds after every bf16 op; in fp32 the two agree up to fused
  multiply-adds);
- clipping scales by ``max_norm / norm`` only when ``norm >= max_norm``
  (``(g / norm) * max_norm``, no epsilon), with the norm summed in fp32;
- accumulation averages k microbatch gradients by the running mean
  ``acc + (g - acc) / (n + 1)`` and applies one update every k microbatches;
  the schedule and the moments tick once per update.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

Schedule = Callable[[int], float]


def constant_schedule(value: float) -> Schedule:
    return lambda count: value


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    """``optax.linear_schedule``: init -> end over ``transition_steps``, then end."""
    if transition_steps <= 0:
        return constant_schedule(init_value)

    def schedule(count: int) -> float:
        frac = 1 - min(max(count, 0), transition_steps) / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    """``optax.cosine_decay_schedule``: init * ((1 - alpha) * cosine + alpha)."""
    if decay_steps <= 0:
        raise ValueError(f"cosine_decay_schedule needs decay_steps > 0, got {decay_steps}")

    def schedule(count: int) -> float:
        cosine = 0.5 * (1 + math.cos(math.pi * min(count, decay_steps) / decay_steps))
        return init_value * ((1 - alpha) * cosine + alpha)

    return schedule


def join_schedules(first: Schedule, second: Schedule, boundary: int) -> Schedule:
    """``optax.join_schedules([first, second], [boundary])``."""
    return lambda count: first(count) if count < boundary else second(count - boundary)


def tree_leaves(tree: Dict) -> List[torch.Tensor]:
    """The leaves of a parameter tree in a fixed order, the stacked ``[L, ...]``
    tensors of a nested dict (``"blocks"``) cut into their per-layer views."""
    out: List[torch.Tensor] = []
    for value in tree.values():
        if isinstance(value, dict):
            for stacked in value.values():
                out.extend(stacked.unbind(0))
        else:
            out.append(value)
    return out


def zeros_like_tree(tree: Dict) -> Dict:
    return {k: zeros_like_tree(v) if isinstance(v, dict) else torch.zeros_like(v)
            for k, v in tree.items()}


class AdamW:
    """``optax.chain(clip_by_global_norm(grad_clip), adamw(learning_rate, b1, b2,
    eps, weight_decay))``, inside ``optax.MultiSteps(accum_steps)`` when
    ``accum_steps > 1``; ``grad_clip`` None: no clipping. ``learning_rate`` is
    a number or a schedule of the update count."""

    def __init__(self, learning_rate: Union[float, Schedule], *, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 1e-4,
                 grad_clip: Union[float, None] = None, accum_steps: int = 1):
        if accum_steps < 1:
            raise ValueError("accum_steps must be >= 1")
        self.schedule = (learning_rate if callable(learning_rate)
                         else constant_schedule(float(learning_rate)))
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay
        self.grad_clip, self.accum_steps = grad_clip, accum_steps

    def init(self, params: Dict) -> Dict:
        """``count`` (updates applied), ``mu`` and ``nu`` like the params; with
        accumulation also ``acc`` and ``mini_step``."""
        state = {"count": 0, "mu": zeros_like_tree(params), "nu": zeros_like_tree(params)}
        if self.accum_steps > 1:
            state.update(mini_step=0, acc=zeros_like_tree(params))
        return state

    @torch.no_grad()
    def apply(self, params: Dict, grads: Sequence[torch.Tensor], state: Dict,
              frozen: Optional[Sequence[bool]] = None,
              norm_groups: Optional[Sequence] = None) -> bool:
        """Take one microbatch's gradients (aligned with ``tree_leaves(params)``;
        fp32 ones are overwritten); update ``params`` and ``state`` in place.
        ``frozen`` (aligned the same way): leaves whose update is zeroed, so
        neither the step nor the weight decay moves them; their moments
        still tick. ``norm_groups`` (aligned the same way, for a sharded
        tree): the process group a leaf is sharded over, or None for a
        replicated leaf; the clip norm then sums each group's squares over
        its ranks and counts replicated leaves once. True when an update was
        applied."""
        p_leaves = tree_leaves(params)
        if len(grads) != len(p_leaves):
            raise ValueError(f"{len(grads)} gradients for {len(p_leaves)} parameter leaves")
        acc_leaves = None
        if self.accum_steps > 1:
            n = state["mini_step"]
            acc_leaves = tree_leaves(state["acc"])
            for acc, g in zip(acc_leaves, grads):
                a32 = _fp32(acc)
                a32.add_(_fp32(g).sub(a32).div_(n + 1))
                if a32 is not acc:
                    acc.copy_(a32)
            if n + 1 < self.accum_steps:
                state["mini_step"] = n + 1
                return False
            state["mini_step"] = 0
            grads = acc_leaves

        clip = None
        if self.grad_clip is not None:
            norm = torch.stack([torch.linalg.vector_norm(g, dtype=torch.float32)
                                for g in grads]).square()
            norm = (norm.sum() if norm_groups is None
                    else _sharded_sum(norm, norm_groups)).sqrt()
            # (g / norm) * max_norm when norm >= max_norm, else g / 1 * 1 (no host sync)
            small, one = norm < self.grad_clip, torch.ones_like(norm)
            clip = (torch.where(small, one, norm),
                    torch.where(small, one, torch.full_like(norm, self.grad_clip)))
        count = state["count"] + 1
        b1, b2 = np.float32(self.b1), np.float32(self.b2)
        bc1 = float(np.float32(1) - b1 ** np.float32(count))
        bc2 = float(np.float32(1) - b2 ** np.float32(count))
        lr = float(self.schedule(state["count"]))
        frozen = frozen if frozen is not None else [False] * len(p_leaves)
        for p, g, m, v, is_frozen in zip(p_leaves, grads, tree_leaves(state["mu"]),
                                         tree_leaves(state["nu"]), frozen):
            g32 = _fp32(g)
            if clip is not None:
                g32.div_(clip[0]).mul_(clip[1])
            m32 = _fp32(m).mul_(self.b1).add_(g32, alpha=1 - self.b1)
            v32 = _fp32(v).mul_(self.b2).addcmul_(g32, g32, value=1 - self.b2)
            for stored, value in ((m, m32), (v, v32)):
                if value is not stored:
                    stored.copy_(value)
            if is_frozen:
                continue
            u = torch.div(m32, bc1).div_(torch.div(v32, bc2).sqrt_().add_(self.eps))
            p32 = _fp32(p)
            p32.add_(u.add_(p32, alpha=self.weight_decay), alpha=-lr)
            if p32 is not p:
                p.copy_(p32)
        if acc_leaves is not None:
            for acc in acc_leaves:
                acc.zero_()
        state["count"] = count
        return True


def _sharded_sum(squares: torch.Tensor, groups: Sequence) -> torch.Tensor:
    """Sum of per-leaf squared norms where a leaf sharded over a group holds
    only its part: each group's sum is all-reduced over it, the replicated
    leaves (None) are counted once."""
    import torch.distributed as dist

    total = squares[[g is None for g in groups]].sum()
    seen: List = []
    for group in groups:
        if group is None or any(group is s for s in seen):
            continue
        seen.append(group)
        part = squares[[g is group for g in groups]].sum()
        dist.all_reduce(part, group=group)
        total = total + part
    return total


def _fp32(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when it is fp32 (updated in place), else an fp32 copy."""
    return t if t.dtype == torch.float32 else t.float()
