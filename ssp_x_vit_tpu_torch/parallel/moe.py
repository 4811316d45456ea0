"""Mixture-of-experts FFN, single device (counterpart of
``ssp_x_vit_tpu/parallel/moe.py``).

- ``moe_ffn``: the GShard / Switch capacity formulation. Top-1 (switch) or
  top-k routing with a per-expert capacity ``C`` (``cfg.capacity``, a
  multiple of 8, times k); the k choices claim queue slots choice-major (all
  first choices, then the second ones after the first round's counts), and
  a token whose assignments all overflow falls through on the residual path
  (its output row is 0). Dispatch and combine are dense ``[T, E, C]``
  one-hot products, as in the JAX package.
- ``moe_ffn_dropless``: every expert on every token, weighted by the dense
  ``[T, E]`` gate matrix (top-1: the argmax probability; top-k: the chosen
  probabilities renormalized over the k). Sequence-length independent, so a
  cached decode equals the full forward. Expert stacks are float,
  ``_q`` int8 or ``_q4`` packed int4 with per-(expert, out-channel)
  ``_scale``.

The top-k is a stable descending sort (the lower expert index first among
equal probabilities, ``lax.top_k``'s rule) and the top-1 an ``argmax`` (the
first maximum); the chosen indices carry no gradient, the gates do. The
all-expert product (``dropless_experts``, shared with the DeepSeek MoE of
``llm/deepseek.py``) takes the experts in chunks bounded in bytes and sums
the combine over experts in fp32, rounding once, as the JAX package's one
``einsum`` over E does. Like the JAX package's ``einsum``, these products are
plain ``torch.matmul``: no Pallas kernel computes them there.

Expert parallelism (``moe_param_specs``, ``shard_moe_params``, ``moe_ffn(...,
mesh=)`` on a ``(data, expert)`` mesh): a rank holds E / ep whole experts.
Where GSPMD moves the dispatched ``[E, C, d]`` activations with an all-to-all
for JAX, here every rank of the ``expert`` group computes the same routing on
the same tokens, runs its own experts' slice of the dispatch and combine, and
the combine is summed over the group (``collectives.reduce_from_tp``), so
``y`` and ``aux`` are the single device's on every rank. The dropless
products take ``group=`` the same way (``dropless_experts`` on the rank's
expert range, or on every expert's slice of f for a tensor-parallel shard).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ssp_x_vit_tpu_torch.device import DeviceLike, resolve_device
from ssp_x_vit_tpu_torch.parallel.collectives import copy_to_tp, reduce_from_tp

Params = Dict[str, Any]

# bytes of a chunk's [n, T, f] / [n, T, d] expert products, and of a chunk's
# weights in the compute dtype, held at once
EXPERT_CHUNK_BYTES = 1 << 30


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    hidden_size: int
    expert_intermediate: int
    num_experts: int
    capacity_factor: float = 1.25
    top_k: int = 1  # 1 = switch; 2 = mixtral-style (capacity and dropless)

    def capacity(self, num_tokens: int) -> int:
        c = int(self.capacity_factor * num_tokens / self.num_experts)
        return max(1, -(-c // 8) * 8)  # a multiple of 8


def init_moe_params(gen: Optional[torch.Generator], cfg: MoEConfig, dtype=torch.float32,
                    device: DeviceLike = None) -> Params:
    """router [d, E] and the SwiGLU expert stacks [E, d, f] / [E, f, d],
    normal with std 0.02, drawn in float32 from ``gen`` (a generator on
    ``device``; None: a fresh one seeded with 0) and cast."""
    dev = resolve_device(device)
    if gen is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
    d, f, E = cfg.hidden_size, cfg.expert_intermediate, cfg.num_experts

    def nrm(*shape):
        return (torch.randn(shape, generator=gen, device=dev) * 0.02).to(dtype)

    return {"router": nrm(d, E), "gate_kernel": nrm(E, d, f), "up_kernel": nrm(E, d, f),
            "down_kernel": nrm(E, f, d)}


def moe_param_specs() -> Dict[str, Tuple[Optional[str], ...]]:
    """JAX's PartitionSpecs as tuples: the expert axis of the stacks over
    ``expert``, the router replicated."""
    return {"router": (None, None), "gate_kernel": ("expert", None, None),
            "up_kernel": ("expert", None, None), "down_kernel": ("expert", None, None)}


def shard_moe_params(params: Params, mesh) -> Params:
    """This rank's experts (axis 0 cut over the mesh's ``expert`` axis); the
    router is the same tensor."""
    from ssp_x_vit_tpu_torch.parallel.mesh import axis_index, axis_size

    ep, r = axis_size(mesh, "expert"), axis_index(mesh, "expert")
    out = {}
    for k, v in params.items():
        spec = moe_param_specs().get(k, (None,) * v.dim())
        if "expert" in spec:
            if v.shape[0] % ep:
                raise ValueError(f"{k}: {v.shape[0]} experts not divisible by expert-axis "
                                 f"size {ep}")
            n = v.shape[0] // ep
            v = v[r * n:(r + 1) * n].contiguous()
        out[k] = v
    return out


def _expert_range(stack: torch.Tensor, num_experts: int, group) -> Tuple[int, int]:
    """[e0, e1) of the experts this rank's stack holds: all of them, unless
    the stack is an expert shard (fewer than ``num_experts``)."""
    n = stack.shape[0]
    if n == num_experts:
        return 0, n
    e0 = dist.get_rank(group) * n
    return e0, e0 + n


def top_k_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest along the last axis, the lower index first
    among equal values (``lax.top_k``'s rule; ``torch.topk`` promises no
    order on the card): a stable descending sort."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


def _router_probs(xt: torch.Tensor, router: torch.Tensor) -> torch.Tensor:
    return torch.softmax(xt.float() @ router.float(), dim=-1)            # [T, E] fp32


def _top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gates [T, k] renormalized over the k when k > 1, experts [T, k])."""
    top_e = top_k_indices(probs, k)
    top_p = torch.gather(probs, 1, top_e)
    if k > 1:
        top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    return top_p, top_e


def moe_ffn(params: Params, x: torch.Tensor, cfg: MoEConfig, mesh=None):
    """x [b, s, d] -> (y [b, s, d], aux) through capacity-routed expert FFNs.
    aux: ``load`` (per-expert fraction of the routed top-k assignments [E]),
    ``dropped`` (fraction of tokens with no surviving assignment) and
    ``aux_loss`` (the switch load-balance loss). ``mesh``: a ``(data,
    expert)`` mesh and ``params`` this rank's ``shard_moe_params``; every rank
    of the expert group passes the same x and gets the same y and aux."""
    group = None if mesh is None else mesh.get_group("expert")
    b, s, d = x.shape
    E, k = cfg.num_experts, cfg.top_k
    T = b * s
    C = cfg.capacity(T) * max(1, k)   # top-k needs room for every assignment round
    xt = x.reshape(T, d)
    probs = _router_probs(xt, params["router"])
    top_p, top_e = _top_k(probs, k)

    dispatch = torch.zeros((T, E, C), dtype=x.dtype, device=x.device)
    combine = torch.zeros((T, E, C), dtype=x.dtype, device=x.device)
    counts = torch.zeros((E,), dtype=torch.int64, device=x.device)
    keep_any = torch.zeros((T,), dtype=torch.bool, device=x.device)
    for kk in range(k):
        e_k = top_e[:, kk]
        onehot_k = F.one_hot(e_k, E)                                     # [T, E]
        pos_k = ((onehot_k.cumsum(dim=0) - onehot_k) * onehot_k).sum(dim=-1) + counts[e_k]
        counts = counts + onehot_k.sum(dim=0)
        keep_k = pos_k < C
        keep_any = keep_any | keep_k
        gate_k = torch.where(keep_k, top_p[:, kk], torch.zeros_like(top_p[:, kk]))
        slot = F.one_hot(torch.where(keep_k, pos_k, torch.full_like(pos_k, C)), C + 1)[:, :C]
        d_k = onehot_k.to(x.dtype)[:, :, None] * slot.to(x.dtype)[:, None, :]   # [T, E, C]
        dispatch = dispatch + d_k
        combine = combine + d_k * gate_k.to(x.dtype)[:, None, None]
    # membership over every routed choice, as the dropless path counts it
    onehot = F.one_hot(top_e, E).sum(dim=1)

    e0, e1 = _expert_range(params["gate_kernel"], E, group)
    if group is not None:
        xt, dispatch, combine = (copy_to_tp(t, group) for t in (xt, dispatch, combine))
    ex_in = torch.einsum("tec,td->ecd", dispatch[:, e0:e1], xt)         # [E_local, C, d]
    g = torch.matmul(ex_in, params["gate_kernel"].to(x.dtype))
    u = torch.matmul(ex_in, params["up_kernel"].to(x.dtype))
    ex_out = torch.matmul(F.silu(g) * u, params["down_kernel"].to(x.dtype))
    y = torch.einsum("tec,ecd->td", combine[:, e0:e1], ex_out)
    y = reduce_from_tp(y, group).reshape(b, s, d)

    load = onehot.float().mean(dim=0)
    aux = {"load": load, "dropped": 1.0 - keep_any.float().mean(),
           "aux_loss": E * (load * probs.mean(dim=0)).sum()}
    return y, aux


def _expert_weights(p: Params, name: str, e0: int, e1: int, dt) -> Tuple[torch.Tensor, Any]:
    """Experts [e0, e1) of a stacked ``[E, K, N]`` kernel in ``dt`` and their
    per-(expert, out-channel) scales in ``dt`` (None for float stacks);
    packed int4 stacks unpack here, one chunk at a time."""
    if name in p:
        return p[name][e0:e1].to(dt), None
    if name + "_q4" in p:
        from ssp_x_vit_tpu_torch.ops.kernels.quant_matmul import unpack_int4

        w = unpack_int4(p[name + "_q4"][e0:e1])
    else:
        w = p[name + "_q"][e0:e1]
    return w.to(dt), p[name + "_scale"][e0:e1].to(dt)


def dropless_experts(xt: torch.Tensor, sel: torch.Tensor, p: Params, dt) -> torch.Tensor:
    """sum_e sel[:, e] * down_e(silu(gate_e(xt)) * up_e(xt)) over every expert:
    xt [T, d] in ``dt``, sel [T, E] in ``dt``, ``p`` the expert stacks
    (``gate_kernel`` / ``up_kernel`` [E, d, f], ``down_kernel`` [E, f, d]; float,
    ``_q`` or ``_q4`` with ``_scale``). The experts go in chunks whose
    products and converted weights each stay within ``EXPERT_CHUNK_BYTES``;
    the combine accumulates in fp32 across the chunks and rounds to ``dt``
    once. Returns [T, d] in ``dt``."""
    T, d = xt.shape
    E = sel.shape[1]
    stack = next(p[k] for k in ("down_kernel", "down_kernel_q", "down_kernel_q4") if k in p)
    f = stack.shape[1] * (2 if "down_kernel_q4" in p else 1)
    elem = torch.empty((), dtype=dt).element_size()
    chunk = max(1, min(E, EXPERT_CHUNK_BYTES // max(1, T * (2 * f + d) * elem),
                       EXPERT_CHUNK_BYTES // (3 * d * f * elem)))
    out = None
    for e0 in range(0, E, chunk):
        e1 = min(E, e0 + chunk)

        def expert_mm(t, name):
            w, scale = _expert_weights(p, name, e0, e1, dt)
            y = torch.matmul(t, w)                                       # [n, T, N]
            return y if scale is None else y * scale[:, None, :]

        g = expert_mm(xt, "gate_kernel")
        u = expert_mm(xt, "up_kernel")
        y = expert_mm(F.silu(g) * u, "down_kernel")                      # [n, T, d]
        part = torch.einsum("te,etd->td", sel[:, e0:e1].float(), y.float())
        out = part if out is None else out + part
    return out.to(dt)


def grouped_dropless(xt: torch.Tensor, sel: torch.Tensor, p: Params, dt, group) -> torch.Tensor:
    """:func:`dropless_experts` of this rank's share, summed over ``group``:
    an expert shard runs its expert range (the columns of ``sel`` it holds),
    a tensor-parallel shard every expert's slice of f; both sum in ``dt``.
    ``xt`` and ``sel`` enter through ``copy_to_tp``, so their gradients are
    whole on every rank. ``group`` None is :func:`dropless_experts`."""
    if group is None:
        return dropless_experts(xt, sel, p, dt)
    stack = next(p[k] for k in ("gate_kernel", "gate_kernel_q", "gate_kernel_q4") if k in p)
    e0, e1 = _expert_range(stack, sel.shape[1], group)
    local = dropless_experts(copy_to_tp(xt, group), copy_to_tp(sel, group)[:, e0:e1], p, dt)
    return reduce_from_tp(local, group)


def moe_ffn_dropless(params: Params, x: torch.Tensor, cfg: MoEConfig, group=None):
    """Dropless MoE: x [b, s, d] -> (y [b, s, d] in x's dtype, aux). Every
    token goes through every expert; the gates select and weight the outputs
    (top-1: the argmax's probability; top-k: the k probabilities renormalized
    over the k). aux as :func:`moe_ffn`'s, ``dropped`` 0; ``load`` counts
    top-k membership (a gate that rounds to 0 in x's dtype does not count).
    ``group``: the experts of a sharded tree, summed over it
    (:func:`grouped_dropless`)."""
    b, s, d = x.shape
    E = cfg.num_experts
    xt = x.reshape(b * s, d)
    probs = _router_probs(xt, params["router"])
    if cfg.top_k == 1:
        expert = probs.argmax(dim=-1)                                    # [T]
        gate = torch.gather(probs, 1, expert[:, None])
        sel = torch.zeros_like(probs).scatter(1, expert[:, None], gate).to(x.dtype)
        member = F.one_hot(expert, E).float()
    else:
        top_p, top_e = _top_k(probs, cfg.top_k)
        sel = torch.zeros_like(probs).scatter(1, top_e, top_p).to(x.dtype)
        member = (sel > 0).float()
    out = grouped_dropless(xt, sel, params, x.dtype, group).reshape(b, s, d)
    load = member.mean(dim=0)
    aux = {"load": load, "dropped": torch.zeros((), device=x.device),
           "aux_loss": E * (load * probs.mean(dim=0)).sum()}
    return out, aux
