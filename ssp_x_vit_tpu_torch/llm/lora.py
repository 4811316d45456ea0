"""LoRA adapters for parameter-efficient recovery finetuning (counterpart of
``ssp_x_vit_tpu/llm/lora.py``).

Adapters are stacked like the blocks they decorate: ``a [L, d_in, r]``
(Gaussian / r) and ``b [L, r, d_out]`` (zeros, so the adapted model starts as
the base model). ``apply_lora`` builds ``W + (alpha / r) * A @ B`` in fp32,
cast back to W's dtype, inside the loss: autograd reaches the adapters only,
the base tree is a frozen input that no step changes, and gradients and
AdamW moments exist for the adapters alone. ``merge_lora`` bakes them into
the kernels for serving, quantizing and saving. Works on any tree with a
``"blocks"`` dict of stacked kernels (the llama family and the ViT).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from ssp_x_vit_tpu_torch.llm.model import LlamaConfig, Params
from ssp_x_vit_tpu_torch.llm.optim import AdamW, tree_leaves
from ssp_x_vit_tpu_torch.llm.train import next_token_loss

# The classic LoRA target set (attention projections).
DEFAULT_TARGETS = ("q_kernel", "k_kernel", "v_kernel", "o_kernel")


def init_lora(gen: Optional[torch.Generator], params: Params, rank: int = 8,
              targets: Sequence[str] = DEFAULT_TARGETS, dtype=torch.float32) -> Params:
    """``{target: {"a": [L, d_in, r], "b": [L, r, d_out]}}`` on the device of the
    targets: ``a`` standard normal / r from ``gen`` (a CPU generator; seed 0
    when None), ``b`` zeros. JAX's random stream cannot be reproduced, so
    tests carry adapters across instead."""
    gen = gen if gen is not None else torch.Generator().manual_seed(0)
    lora: Params = {}
    for t in targets:
        w = params["blocks"][t]
        if w.dim() != 3:
            raise ValueError(f"LoRA targets stacked 2-D kernels; {t} has shape {tuple(w.shape)}")
        n_layers, d_in, d_out = w.shape
        a = torch.randn((n_layers, d_in, rank), generator=gen, dtype=torch.float32) / rank
        lora[t] = {"a": a.to(device=w.device, dtype=dtype),
                   "b": torch.zeros((n_layers, rank, d_out), dtype=dtype, device=w.device)}
    return lora


def apply_lora(params: Params, lora: Params, *, alpha: float = 16.0) -> Params:
    """``W + (alpha / r) * A @ B`` per target (differentiable in the adapters);
    every other leaf is shared with ``params``."""
    blocks = dict(params["blocks"])
    for t, ab in lora.items():
        r = ab["a"].shape[-1]
        delta = torch.einsum("ldr,lrn->ldn", ab["a"], ab["b"]) * (alpha / r)
        blocks[t] = (blocks[t].float() + delta.float()).to(blocks[t].dtype)
    out = {k: v for k, v in params.items() if k != "blocks"}
    out["blocks"] = blocks
    return out


def merge_lora(params: Params, lora: Params, *, alpha: float = 16.0) -> Params:
    """The adapters baked into the kernels: the deployment tree, whose forward
    is the adapted model's."""
    with torch.no_grad():
        return apply_lora(params, lora, alpha=alpha)


LoraStep = Callable[..., Tuple[Params, Dict, torch.Tensor]]


def make_adapter_step(loss_fn: Callable[..., torch.Tensor], optimizer: AdamW) -> LoraStep:
    """``step(base, lora, opt_state, *batch) -> (lora, opt_state, loss)`` for
    ``loss_fn(lora, base, *batch)``: the adapters are the only autograd leaves
    (aliases of their storage), and ``optimizer`` (state from
    ``optimizer.init(lora)``) updates them in place; ``base`` is not touched."""
    def step(base: Params, lora: Params, opt_state: Dict, *batch):
        tree = {t: {k: v.detach().requires_grad_(True) for k, v in ab.items()}
                for t, ab in lora.items()}
        loss = loss_fn(tree, base, *batch)
        loss.backward()
        grads = tree_leaves({t: {k: v.grad if v.grad is not None else torch.zeros_like(v)
                                 for k, v in ab.items()} for t, ab in tree.items()})
        optimizer.apply(lora, grads, opt_state)
        return lora, opt_state, loss.detach()

    return step


def make_lora_train_step(cfg: LlamaConfig, optimizer: Optional[AdamW] = None, *,
                         alpha: float = 16.0, compute_dtype=torch.bfloat16,
                         remat: bool = True) -> LoraStep:
    """``step(base_params, lora, opt_state, tokens) -> (lora, opt_state, loss)``
    over ``next_token_loss``; ``optimizer`` defaults to optax's ``adamw(1e-4)``
    (weight decay 1e-4)."""
    optimizer = optimizer or AdamW(1e-4)

    def loss_fn(lora, base, tokens):
        tokens = torch.as_tensor(tokens).to(device=base["embed"].device, dtype=torch.int64)
        return next_token_loss(apply_lora(base, lora, alpha=alpha), tokens, cfg,
                               compute_dtype=compute_dtype, remat=remat)

    return make_adapter_step(loss_fn, optimizer)
