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

Every family trains: the llama family (an MoE config adds ``router_aux_coef``
times the mean of its layers' switch load-balance losses) and DeepSeek/MLA
(``deepseek_forward`` with per-layer remat, or the materialized forward of a
pruned config; no aux term: V3 balances its experts with the
``e_score_correction_bias``, a buffer whose update the steps zero, so weight
decay cannot move it either).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ssp_x_vit_tpu_torch.llm.deepseek import is_deepseek
from ssp_x_vit_tpu_torch.llm.generate import full_logits
from ssp_x_vit_tpu_torch.llm.model import LlamaConfig, Params, llama_forward, require_llama_config
from ssp_x_vit_tpu_torch.llm.optim import AdamW, tree_leaves

Step = Callable[[Params, Dict, torch.Tensor], Tuple[Params, Dict, torch.Tensor]]

# leaves of a DeepSeek tree that are buffers, not trained (e_score_correction_bias)
_BUFFERS = ("e_bias",)


def _check_trainable(cfg) -> None:
    if not is_deepseek(cfg):
        require_llama_config(cfg)


def frozen_leaves(params: Params, cfg) -> Optional[List[bool]]:
    """Per leaf of ``optim.tree_leaves(params)``: True for the buffers whose
    update the train steps zero (DeepSeek's ``e_bias``, as the JAX package's
    ``_freeze_buffers``); None when the config has none."""
    if not is_deepseek(cfg):
        return None
    out: List[bool] = []
    for value in params.values():
        if isinstance(value, dict):
            for k, stacked in value.items():
                out += [k in _BUFFERS] * stacked.shape[0]
        else:
            out.append(False)
    return out


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
                    compute_dtype=torch.bfloat16, remat: bool = True, tp_group=None,
                    gather_layer=None) -> torch.Tensor:
    """Mean next-token NLL over tokens [b, s] (logits in fp32 for the softmax).
    Depth-materialized pruned configs train too; their forward has no
    checkpointed layer loop, so ``remat`` is a no-op there. DeepSeek/MLA
    configs take ``deepseek_forward``; a llama MoE config adds
    ``router_aux_coef`` times the mean over layers of ``moe_aux_loss``.
    ``tp_group`` / ``gather_layer``: a sharded tree's
    (``parallel/llm_sharding.py``), handed to ``llama_forward`` or
    ``deepseek_forward``."""
    _check_trainable(cfg)
    moe = getattr(cfg, "num_experts", 0)
    if is_deepseek(cfg) and (tp_group is not None or gather_layer is not None):
        from ssp_x_vit_tpu_torch.llm.deepseek import deepseek_forward

        logits = deepseek_forward(params, tokens[:, :-1], cfg, compute_dtype=compute_dtype,
                                  remat=remat, tp_group=tp_group, gather_layer=gather_layer)
    elif tp_group is not None or gather_layer is not None:
        logits, aux = llama_forward(params, tokens[:, :-1], cfg, compute_dtype=compute_dtype,
                                    remat=remat, tp_group=tp_group, gather_layer=gather_layer)
    elif moe and not cfg.pruned_attention_blocks:   # the gated forward returns the aux loss
        logits, aux = llama_forward(params, tokens[:, :-1], cfg, compute_dtype=compute_dtype,
                                    remat=remat)
    else:   # a depth-materialized MoE config raises in the materialized forward, as in JAX
        logits = full_logits(params, tokens[:, :-1], cfg, compute_dtype, remat=remat)
    loss = F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                           tokens[:, 1:].reshape(-1))
    if moe:
        loss = loss + cfg.router_aux_coef * aux["moe_aux_loss"].mean()
    return loss


def _make_step(loss_fn, optimizer: AdamW, cfg) -> Step:
    def step(params: Params, opt_state: Dict, tokens) -> Tuple[Params, Dict, torch.Tensor]:
        tree, leaves = trainable_tree(params)
        loss = loss_fn(tree, _to_tokens(tokens, params["embed"].device))
        loss.backward()
        grads = [leaf.grad if leaf.grad is not None else torch.zeros_like(leaf) for leaf in leaves]
        optimizer.apply(params, grads, opt_state, frozen=frozen_leaves(params, cfg))
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
        tree, tokens, cfg, compute_dtype=compute_dtype, remat=remat), optimizer, cfg)


def make_distill_train_step(teacher_params: Params, teacher_cfg: LlamaConfig,
                            student_cfg: LlamaConfig, optimizer: Optional[AdamW] = None, *,
                            alpha: float = 0.5, temperature: float = 2.0,
                            compute_dtype=torch.bfloat16, remat: bool = True) -> Step:
    """Knowledge-distillation step for pruned-model recovery: loss =
    alpha * next-token CE + (1 - alpha) * T^2 * KL(teacher || student) at
    softmax temperature T. The teacher runs forward only, without grad (its
    flash calls take the no-grad kernel path); teacher and student may be any
    configs sharing the vocabulary (2SSP width- or depth-materialized, MoE,
    DeepSeek/MLA). Student leaves that share storage with the teacher are
    copied before the first update."""
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

    step = _make_step(loss_fn, optimizer, student_cfg)

    def distill_step(student: Params, opt_state: Dict, tokens):
        unshare(student)
        return step(student, opt_state, tokens)

    return distill_step
