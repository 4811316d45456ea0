"""Single-device LLM training step (counterpart of ``ssp_x_vit_tpu/llm/train.py``):
next-token cross-entropy and the knowledge-distillation step of the 2SSP
"prune -> recover" loop.

The hot path is the flash-attention forward and its backward kernels
(``ops/kernels/flash_attention.py``): under autograd the forward stores each
row's log-sum-exp and the backward launches the dq and dk/dv kernels. With
``remat=True`` (default) every layer is checkpointed, so the backward
relaunches each layer's forward flash kernel before its backward ones.

A step updates the parameters and the optimizer state in place: the stacked
``[L, ...]`` block tensors are handed to autograd as per-layer leaves that
share their storage (``trainable_tree``), each layer's gradient is its own
tensor, and ``optim.AdamW`` writes the new values back through the same
views. At Llama-2-7B width the parameters, gradients and both moments exist
once each on the card, as the JAX package's donated buffers do.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ssp_x_vit_tpu_torch.llm.generate import full_logits
from ssp_x_vit_tpu_torch.llm.model import LlamaConfig, Params, require_llama_config
from ssp_x_vit_tpu_torch.llm.optim import AdamW, tree_leaves

_MOE_NOT_PORTED = ("training mixture-of-experts configs (num_experts > 0) is not ported yet: "
                   "parallel/moe.py is ROADMAP.md A.11c")

Step = Callable[[Params, Dict, torch.Tensor], Tuple[Params, Dict, torch.Tensor]]


def _check_trainable(cfg) -> None:
    require_llama_config(cfg)  # DeepSeek/MLA raises naming ROADMAP.md A.11b
    if cfg.num_experts:
        raise NotImplementedError(_MOE_NOT_PORTED)


def trainable_tree(params: Params) -> Tuple[Params, List[torch.Tensor]]:
    """(tree, leaves): a parameter tree whose ``"blocks"`` entries are lists of
    per-layer tensors, every leaf a fresh autograd leaf that requires grad and
    shares its storage with ``params``; ``leaves`` in ``optim.tree_leaves``
    order. Integer (quantized) leaves cannot train and raise."""
    leaves: List[torch.Tensor] = []

    def leaf(t: torch.Tensor) -> torch.Tensor:
        if not t.is_floating_point():
            raise TypeError(f"cannot train a {t.dtype} leaf: dequantize the model first")
        out = t.detach().requires_grad_(True)
        leaves.append(out)
        return out

    tree: Params = {}
    for key, value in params.items():
        if isinstance(value, dict):
            tree[key] = {k: [leaf(t) for t in v.unbind(0)] for k, v in value.items()}
        else:
            tree[key] = leaf(value)
    return tree, leaves


def _to_tokens(tokens, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(tokens).to(device=device, dtype=torch.int64)


def next_token_loss(params: Params, tokens: torch.Tensor, cfg: LlamaConfig, *,
                    compute_dtype=torch.bfloat16, remat: bool = True) -> torch.Tensor:
    """Mean next-token NLL over tokens [b, s] (logits in fp32 for the softmax).
    Depth-materialized pruned configs train too; their forward has no
    checkpointed layer loop, so ``remat`` is a no-op there."""
    _check_trainable(cfg)
    logits = full_logits(params, tokens[:, :-1], cfg, compute_dtype, remat=remat)
    return F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                           tokens[:, 1:].reshape(-1))


def _make_step(loss_fn, optimizer: AdamW) -> Step:
    def step(params: Params, opt_state: Dict, tokens) -> Tuple[Params, Dict, torch.Tensor]:
        tree, leaves = trainable_tree(params)
        loss = loss_fn(tree, _to_tokens(tokens, params["embed"].device))
        loss.backward()
        grads = [leaf.grad if leaf.grad is not None else torch.zeros_like(leaf) for leaf in leaves]
        optimizer.apply(params, grads, opt_state)
        return params, opt_state, loss.detach()

    return step


def make_llama_train_step(cfg: LlamaConfig, optimizer: Optional[AdamW] = None, *,
                          compute_dtype=torch.bfloat16, remat: bool = True) -> Step:
    """``step(params, opt_state, tokens) -> (params, opt_state, loss)``; params
    and opt_state are updated in place (the same objects come back).
    ``optimizer`` defaults to optax's ``adamw(1e-4)`` (b2 0.999, weight decay
    1e-4, no clipping)."""
    _check_trainable(cfg)
    optimizer = optimizer or AdamW(1e-4)
    return _make_step(lambda tree, tokens: next_token_loss(
        tree, tokens, cfg, compute_dtype=compute_dtype, remat=remat), optimizer)


def make_distill_train_step(teacher_params: Params, teacher_cfg: LlamaConfig,
                            student_cfg: LlamaConfig, optimizer: Optional[AdamW] = None, *,
                            alpha: float = 0.5, temperature: float = 2.0,
                            compute_dtype=torch.bfloat16, remat: bool = True) -> Step:
    """Knowledge-distillation step for pruned-model recovery: loss =
    alpha * next-token CE + (1 - alpha) * T^2 * KL(teacher || student) at
    softmax temperature T. The teacher runs forward only, without grad (its
    flash calls take the no-grad kernel path); the student may be any config
    sharing the vocabulary (2SSP width- or depth-materialized). Student leaves
    that share storage with the teacher are copied before the first update."""
    _check_trainable(teacher_cfg)
    _check_trainable(student_cfg)
    optimizer = optimizer or AdamW(1e-4)
    teacher_storages = {t.untyped_storage().data_ptr() for t in tree_leaves(teacher_params)}

    def loss_fn(student: Params, tokens: torch.Tensor) -> torch.Tensor:
        s_logits = full_logits(student, tokens[:, :-1], student_cfg, compute_dtype,
                               remat=remat).float()
        with torch.no_grad():
            t_logits = full_logits(teacher_params, tokens[:, :-1], teacher_cfg,
                                   compute_dtype).float()
        logp = F.log_softmax(s_logits, dim=-1)
        ce = -logp.gather(-1, tokens[:, 1:, None]).mean()
        t_prob = F.softmax(t_logits / temperature, dim=-1)
        s_logp_t = F.log_softmax(s_logits / temperature, dim=-1)
        kl = (t_prob * (torch.log(t_prob + 1e-9) - s_logp_t)).sum(dim=-1).mean()
        return alpha * ce + (1.0 - alpha) * (temperature ** 2) * kl

    def unshare(student: Params) -> None:
        # A pruned model keeps the dense model's embeddings, norms and head as
        # the same tensors: copy those once, so the in-place updates of the
        # student never reach the teacher.
        for tree in [student] + [v for v in student.values() if isinstance(v, dict)]:
            for key, value in tree.items():
                if isinstance(value, torch.Tensor) and \
                        value.untyped_storage().data_ptr() in teacher_storages:
                    tree[key] = value.clone()

    step = _make_step(loss_fn, optimizer)

    def distill_step(student: Params, opt_state: Dict, tokens):
        unshare(student)
        return step(student, opt_state, tokens)

    return distill_step
