"""Head / full-model finetuning of a (pruned) ViT, knowledge distillation and
LoRA recovery (counterpart of ``ssp_x_vit_tpu/pruning/finetune.py``;
reference ``maybe_finetune_head``: AdamW, cross-entropy, autocast).

Every step differentiates ``vit_forward(..., allow_fused_attn=False)`` (or
``vit_forward_materialized`` for a depth-pruned config), bf16 compute over
fp32 parameters by default, as the JAX steps do. On the card each block's FFN
then runs the ``fused_ffn`` kernel inside its autograd Function (the backward
recomputes the plain FFN and takes its autodiff, as the JAX ``custom_vjp``
does) and the attention branch is plain PyTorch (``sdpa_reference``).

The optimizer is the JAX package's ``optax.chain(masked(adamw(lr,
weight_decay=0.01)), masked(set_to_zero))``, built on ``llm/optim.py``'s
``AdamW``: moments exist for the trainable leaves only (``trainable="head"``
keeps none for the backbone), only those leaves become autograd leaves, and
frozen leaves never change, bit for bit. A step updates the parameters and the
optimizer state in place where the JAX step donates them, and returns the
objects it was given.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ssp_x_vit_tpu_torch.llm.lora import apply_lora, make_adapter_step
from ssp_x_vit_tpu_torch.llm.optim import AdamW
from ssp_x_vit_tpu_torch.models.vit import (
    Params, ViTConfig, params_device, vit_forward, vit_forward_materialized,
)

Step = Callable[..., Tuple[Params, Dict, torch.Tensor]]

VIT_LORA_TARGETS = ("qkv_kernel", "proj_kernel")


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of ``labels`` under ``log_softmax`` in fp32."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels[:, None].long()).mean()


def trainable_mask(params: Params, trainable: str) -> Params:
    """The tree of ``params`` with True where a leaf trains: every leaf for
    ``"all"``, the classifier head's for ``"head"``."""
    def fill(tree, value):
        return {k: fill(v, value) if isinstance(v, dict) else value for k, v in tree.items()}

    if trainable == "all":
        return fill(params, True)
    if trainable == "head":
        return {k: fill(v, k == "head") if isinstance(v, dict) else False
                for k, v in params.items()}
    raise ValueError(f"unknown trainable spec {trainable}")


def _flatten(tree: Params, prefix: str = "") -> Dict[str, object]:
    out: Dict[str, object] = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, path))
        else:
            out[path] = v
    return out


def _replace(tree: Params, new: Dict[str, torch.Tensor], prefix: str = "") -> Params:
    """A copy of the dict structure of ``tree`` with the leaves at ``new``'s paths replaced."""
    out: Params = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out[k] = _replace(v, new, path) if isinstance(v, dict) else new.get(path, v)
    return out


def _check_leaves(params: Params) -> None:
    """Refuse trees made under ``torch.inference_mode()``: autograd cannot save
    inference tensors and the in-place update cannot write them. Nothing is
    copied behind the caller's back."""
    bad = [p for p, t in _flatten(params).items()
           if isinstance(t, torch.Tensor) and t.is_inference()]
    if bad:
        raise ValueError(f"parameters {bad[:3]}{'...' if len(bad) > 3 else ''} are inference "
                         "tensors (made under torch.inference_mode()): finetune a tree made "
                         "outside inference mode, as the CLI does before its evaluations")


class MaskedAdamW:
    """``make_optimizer``'s optimizer: ``AdamW`` over the leaves that
    ``trainable_mask(params, trainable)`` marks; the others get no state and
    no update. ``init(params)`` makes the state; ``apply(params, grads,
    state)`` takes the gradients of :meth:`leaves` in its order."""

    def __init__(self, adamw: AdamW, trainable: str):
        self.adamw, self.trainable = adamw, trainable

    def leaves(self, params: Params) -> Dict[str, torch.Tensor]:
        """path -> tensor of every trainable leaf, in tree order."""
        mask = _flatten(trainable_mask(params, self.trainable))
        out = {p: t for p, t in _flatten(params).items() if mask[p]}
        for p, t in out.items():
            if not t.is_floating_point():
                raise TypeError(f"cannot train {p}, a {t.dtype} leaf: quantize after finetuning")
        return out

    def init(self, params: Params) -> Dict:
        _check_leaves(params)
        return self.adamw.init(self.leaves(params))

    def apply(self, params: Params, grads: List[torch.Tensor], state: Dict) -> bool:
        return self.adamw.apply(self.leaves(params), grads, state)


def make_optimizer(params: Params, lr: float = 5e-5, weight_decay: float = 0.01,
                   trainable: str = "head") -> MaskedAdamW:
    """``optax.masked(adamw(lr, weight_decay))`` over the trainable leaves."""
    trainable_mask(params, trainable)  # an unknown spec raises here
    return MaskedAdamW(AdamW(lr, weight_decay=weight_decay), trainable)


def _masked(optimizer: Union[MaskedAdamW, AdamW]) -> MaskedAdamW:
    """A plain ``AdamW`` (the counterpart of handing the JAX step ``optax.adamw``)
    trains every leaf."""
    return optimizer if isinstance(optimizer, MaskedAdamW) else MaskedAdamW(optimizer, "all")


def _vit_logits(params: Params, cfg: ViTConfig, pixel_values: torch.Tensor,
                compute_dtype) -> torch.Tensor:
    if cfg.pruned_attention_blocks:
        return vit_forward_materialized(params, pixel_values, cfg, compute_dtype=compute_dtype,
                                        allow_fused_attn=False)
    return vit_forward(params, pixel_values, cfg, compute_dtype=compute_dtype,
                       allow_fused_attn=False)[0]


def _batch(pixel_values, labels, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    return (torch.as_tensor(pixel_values).to(device),
            torch.as_tensor(labels).to(device=device, dtype=torch.int64))


def _make_step(loss_fn: Callable[[Params, torch.Tensor, torch.Tensor], torch.Tensor],
               optimizer: Union[MaskedAdamW, AdamW]) -> Step:
    optimizer = _masked(optimizer)

    def step(params: Params, opt_state: Dict, pixel_values, labels):
        _check_leaves(params)
        alias = {p: t.detach().requires_grad_(True) for p, t in optimizer.leaves(params).items()}
        loss = loss_fn(_replace(params, alias), *_batch(pixel_values, labels,
                                                        params_device(params)))
        loss.backward()
        optimizer.apply(params, [t.grad if t.grad is not None else torch.zeros_like(t)
                                 for t in alias.values()], opt_state)
        return params, opt_state, loss.detach()

    return step


def make_train_step(cfg: ViTConfig, optimizer: Union[MaskedAdamW, AdamW],
                    compute_dtype=torch.bfloat16) -> Step:
    """``step(params, opt_state, pixel_values, labels) -> (params, opt_state,
    loss)``, cross-entropy; params and opt_state are updated in place."""
    return _make_step(lambda params, px, labels: cross_entropy_loss(
        _vit_logits(params, cfg, px, compute_dtype), labels), optimizer)


def finetune(
    params: Params,
    cfg: ViTConfig,
    batches_fn: Callable[[], Iterable[dict]],
    *,
    epochs: int = 1,
    lr: float = 5e-5,
    trainable: str = "head",
    compute_dtype=torch.bfloat16,
    verbose: bool = True,
    losses: Optional[List[float]] = None,
) -> Params:
    """Run finetuning in place; ``batches_fn()`` yields the batch dicts of one
    epoch (called once per epoch). ``losses``, if given, receives each step's
    loss (the host reads every step's loss, as the JAX loop does)."""
    optimizer = make_optimizer(params, lr=lr, trainable=trainable)
    opt_state = optimizer.init(params)
    step = make_train_step(cfg, optimizer, compute_dtype=compute_dtype)
    n_train = sum(t.numel() for t in optimizer.leaves(params).values())
    if verbose:
        print(f"[INFO] Fine-tuning ({trainable}) for {epochs} epoch(s) with "
              f"{n_train/1e6:.2f}M trainable params")
    for epoch in range(epochs):
        running, nsteps = 0.0, 0
        for batch in batches_fn():
            params, opt_state, loss = step(params, opt_state, batch["pixel_values"],
                                           batch["labels"])
            value = float(loss)
            running += value
            nsteps += 1
            if losses is not None:
                losses.append(value)
        if verbose:
            print(f"[INFO] Epoch {epoch+1}/{epochs} done. Mean loss: {running/max(1,nsteps):.4f}")
    if verbose:
        print("[INFO] Fine-tuning complete.")
    return params


def make_distill_train_step(teacher_params: Params, teacher_cfg: ViTConfig,
                            student_cfg: ViTConfig, optimizer: Union[MaskedAdamW, AdamW], *,
                            alpha: float = 0.5, temperature: float = 2.0,
                            compute_dtype=torch.bfloat16) -> Step:
    """Knowledge-distillation recovery of a pruned ViT: ``step(student,
    opt_state, pixel_values, labels) -> (student, opt_state, loss)`` with loss =
    alpha * CE(labels) + (1 - alpha) * T^2 * KL(teacher || student) at softmax
    temperature T. The teacher runs forward only, without a graph
    (``torch.no_grad``, the counterpart of ``stop_gradient``); the two may
    have different configs sharing the label space. Trainable student leaves
    that share storage with the teacher (a pruned model keeps the dense
    model's embeddings, norms and head, and may keep its sub-dicts) are copied
    before the first update, so the teacher never changes."""
    teacher_storages = {t.untyped_storage().data_ptr()
                        for t in _flatten(teacher_params).values() if isinstance(t, torch.Tensor)}
    teacher_dicts = set()

    def collect(tree):
        teacher_dicts.add(id(tree))
        for v in tree.values():
            if isinstance(v, dict):
                collect(v)

    collect(teacher_params)
    masked = _masked(optimizer)

    def unshare(student: Params, mask: Params) -> None:
        # Copy the trainable leaves that live in the teacher's storage, and the
        # dicts that hold them where the student shares the teacher's dict.
        for k, v in student.items():
            if isinstance(v, dict):
                if id(v) in teacher_dicts:
                    v = student[k] = dict(v)
                unshare(v, mask[k])
            elif mask[k] and v.untyped_storage().data_ptr() in teacher_storages:
                student[k] = v.clone()

    def loss_fn(student: Params, px: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        s_logits = _vit_logits(student, student_cfg, px, compute_dtype).float()
        with torch.no_grad():
            t_logits = _vit_logits(teacher_params, teacher_cfg, px, compute_dtype).float()
        ce = cross_entropy_loss(s_logits, labels)
        t_prob = F.softmax(t_logits / temperature, dim=-1)
        s_logp_t = F.log_softmax(s_logits / temperature, dim=-1)
        kl = (t_prob * (torch.log(t_prob + 1e-9) - s_logp_t)).sum(dim=-1).mean()
        return alpha * ce + (1.0 - alpha) * (temperature ** 2) * kl

    step = _make_step(loss_fn, masked)

    def distill_step(student: Params, opt_state: Dict, pixel_values, labels):
        unshare(student, trainable_mask(student, masked.trainable))
        return step(student, opt_state, pixel_values, labels)

    return distill_step


def make_lora_train_step(cfg: ViTConfig, optimizer: AdamW, *, alpha: float = 16.0,
                         compute_dtype=torch.bfloat16) -> Step:
    """LoRA finetuning of the ViT: ``step(base, lora, opt_state, pixel_values,
    labels) -> (lora, opt_state, loss)`` (``llm/lora.py`` adapters, e.g. on
    ``VIT_LORA_TARGETS``; opt_state = ``optimizer.init(lora)``). The base stays
    frozen; only the adapters carry gradients and optimizer state."""
    def loss_fn(lora: Params, base: Params, pixel_values, labels) -> torch.Tensor:
        _check_leaves(base)
        px, labels = _batch(pixel_values, labels, params_device(base))
        logits = _vit_logits(apply_lora(base, lora, alpha=alpha), cfg, px, compute_dtype)
        return cross_entropy_loss(logits, labels)

    return make_adapter_step(loss_fn, optimizer)
