"""Tensor / data / fully-sharded parallelism for the LLM path (counterpart of
``ssp_x_vit_tpu/parallel/llm_sharding.py``).

The JAX package places arrays and lets GSPMD insert the collectives. Here the
specs (the JAX ``PartitionSpec``s as tuples of axis names, so tests compare
them spec for spec) choose how each leaf is cut, a shard is this rank's
plain tensors under the unsharded tree's keys, and the collectives are
written in the forwards (``llm/model.py``, ``llm/serve.py``) and in the
train steps below:

- Megatron's split: column-parallel q/k/v, gate/up, fc1 and the lm_head's
  vocab; row-parallel o, down and fc2 (summed over ``model`` before their
  bias); norms, embeddings and a tied head replicated.
- Quantized trees: ``<k>_q`` int8 is cut like its float kernel; a
  row-parallel ``_scale`` stays whole (a per-column scale distributes over
  the sum). An int4 row-parallel ``_q4`` stays replicated, since the
  split-half nibble packing interleaves K rows; that layer gathers its
  input and reduces nothing.
- Packed trees (``serve.pack_llm_params_for_serving``): ``qkv_kernel`` is
  ``[q | k | v]`` and ``gateup_kernel`` ``[gate | up]`` along the last axis.
  An equal split of that axis is not a rank's ``[q_r | k_r | v_r]`` (GSPMD
  reshuffles behind JAX's back), so each component is cut and packed again
  per rank.
- Each rank holds whole KV heads: ``num_kv_heads % model`` is refused
  (GSPMD would reshard a cut head for JAX).

- Mixture-of-experts llama trees: under ``model`` the expert stacks cut their
  f axis (gate / up column-, down row-parallel; an int4 expert stack is
  refused, its packing interleaves f); under ``expert``
  (``shard_moe_llama_params``) a rank holds whole experts and
  ``llama_forward(..., expert_group=)`` sums their outputs.
- DeepSeek / MLA trees (``shard_deepseek_params``): Megatron for MLA, the
  routed experts cut on E (``llm/deepseek.py`` runs the collectives);
  quantized leaves are cut like their float kernels, where GSPMD keeps JAX's
  ``_q`` leaves whole. FSDP trains DeepSeek trees too: the layer bodies of
  ``dense_blocks`` / ``moe_blocks`` gather their weights, ``e_bias`` frozen.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ssp_x_vit_tpu_torch.llm.model import LlamaConfig, Params, llama_forward, require_llama_config
from ssp_x_vit_tpu_torch.parallel.collectives import all_reduce_sum, fsdp_gather, gather_along
from ssp_x_vit_tpu_torch.parallel.mesh import axis_index, axis_size

Spec = Tuple[Optional[str], ...]


def _rep(ndim: int) -> Spec:
    return (None,) * ndim


def llama_param_specs(cfg: LlamaConfig) -> Dict[str, Any]:
    """Specs of the DENSE llama layout, from the same per-key rules that
    :func:`shard_llama_params` applies; prefer :func:`llm_param_specs_like`
    for anything pruned, quantized or packed."""
    names = ["ln1", "q_kernel", "k_kernel", "v_kernel", "o_kernel",
             "ln2", "gate_kernel", "up_kernel", "down_kernel"]
    if cfg.qkv_bias:
        names += ["q_bias", "k_bias", "v_bias"]
    if cfg.qk_norm:
        names += ["q_norm", "k_norm"]   # per-head-dim scales: replicated
    blocks = {n: _block_key_spec(n, 3 if n.endswith("_kernel") else 2) for n in names}
    specs: Dict[str, Any] = {"embed": _top_key_spec("embed", 2), "blocks": blocks,
                             "ln_final": _top_key_spec("ln_final", 1)}
    if not cfg.tie_embeddings:
        specs["lm_head"] = _top_key_spec("lm_head", 2)
    return specs


# Megatron split: column-parallel producers of the head / intermediate dim,
# row-parallel consumers (their partial products are summed over "model").
_COL = frozenset({"q_kernel", "k_kernel", "v_kernel", "gate_kernel", "up_kernel", "fc1_kernel",
                  "qkv_kernel", "gateup_kernel"})
_ROW = frozenset({"o_kernel", "down_kernel", "fc2_kernel"})
_COL_BIAS = frozenset({"q_bias", "k_bias", "v_bias", "fc1_bias"})


def _split_key(key: str) -> Tuple[str, str]:
    for suffix, kind in (("_q4", "q4"), ("_q", "q"), ("_scale", "scale")):
        if key.endswith(suffix):
            return key[: -len(suffix)], kind
    return key, "plain"


def _block_key_spec(key: str, ndim: int) -> Spec:
    """Spec of one stacked block leaf, quantized variants included."""
    base, kind = _split_key(key)
    if base in _COL:
        return _rep(ndim - 1) + ("model",)   # the output (column) axis
    if base in _ROW:
        if kind in ("q4", "scale"):
            return _rep(ndim)
        return _rep(ndim - 2) + ("model", None)   # the contracted (row) axis
    if base in _COL_BIAS:
        return (None, "model")
    return _rep(ndim)


def _top_key_spec(key: str, ndim: int) -> Spec:
    if key in ("lm_head", "lm_head_q"):
        return (None, "model")
    if key in ("lm_head_scale", "lm_head_bias"):
        return ("model",)
    return _rep(ndim)


def llm_param_specs_like(params: Params) -> Dict[str, Any]:
    """Specs from the tree's own keys: dense, 2SSP-materialized, phi / OPT
    layouts, int8 / int4 and packed trees."""
    specs: Dict[str, Any] = {}
    for k, v in params.items():
        if k == "blocks":
            specs["blocks"] = {bk: _block_key_spec(bk, bv.dim()) for bk, bv in v.items()}
        else:
            specs[k] = _top_key_spec(k, v.dim())
    return specs


def _cut(t: torch.Tensor, axis: int, rank: int, n: int) -> torch.Tensor:
    size = t.shape[axis] // n
    return t.narrow(axis, rank * size, size).contiguous().clone()


def _cut_packed(t: torch.Tensor, sizes, rank: int, n: int) -> torch.Tensor:
    """Each component of a last-axis concatenation cut for ``rank``, packed again."""
    return torch.cat([_cut(part, -1, rank, n) for part in t.split(sizes, dim=-1)], dim=-1)


def _check_tp(params: Params, cfg: LlamaConfig, tp: int) -> None:
    require_llama_config(cfg)
    blocks = params["blocks"]
    if cfg.num_experts and tp > 1 and any(k.endswith("_q4") and k.startswith(
            ("gate_kernel", "up_kernel", "down_kernel")) for k in blocks):
        raise ValueError("int4 expert stacks cannot be cut on their f axis (the nibble "
                         "packing interleaves it): shard the float or int8 tree, or place "
                         "whole experts with shard_moe_llama_params")
    if any(k.endswith(("_lora_a", "_lora_b")) for k in blocks):
        raise ValueError("shard the base tree before attaching LoRA adapters")
    for what, n in (("num_heads", cfg.num_heads), ("num_kv_heads", cfg.num_kv_heads)):
        if n % tp:
            raise ValueError(f"{what} {n} not divisible by model-axis size {tp} (each rank "
                             "holds whole heads)")
    specs = llm_param_specs_like(params)
    leaves = [(k, v, specs[k]) for k, v in params.items() if k != "blocks"]
    leaves += [(k, v, specs["blocks"][k]) for k, v in blocks.items()]
    for key, v, spec in leaves:
        if "model" in spec and v.shape[spec.index("model")] % tp:
            raise ValueError(f"{key} axis {spec.index('model')} of {tuple(v.shape)} not "
                             f"divisible by model-axis size {tp}")


def shard_llama_params(params: Params, mesh, cfg: LlamaConfig) -> Params:
    """This rank's tensor-parallel shard over the mesh's ``model`` axis
    (replicated leaves are the same tensors)."""
    return llama_shard(params, cfg, axis_index(mesh, "model"), axis_size(mesh, "model"))


def llama_shard(params: Params, cfg: LlamaConfig, r: int, tp: int) -> Params:
    """The shard of model rank ``r`` of ``tp`` (what :func:`shard_llama_params`
    gives that rank; in one process, any rank's)."""
    _check_tp(params, cfg, tp)
    hq, hkv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim

    def place(key, v, spec):
        if "model" not in spec or tp == 1:
            return v
        base = _split_key(key)[0]
        if base == "qkv_kernel":
            return _cut_packed(v, (hq, hkv, hkv), r, tp)
        if base == "gateup_kernel":
            return _cut_packed(v, (v.shape[-1] // 2,) * 2, r, tp)
        return _cut(v, spec.index("model"), r, tp)

    specs = llm_param_specs_like(params)
    out = {k: place(k, v, specs[k]) for k, v in params.items() if k != "blocks"}
    out["blocks"] = {k: place(k, v, specs["blocks"][k]) for k, v in params["blocks"].items()}
    return out


# ---------------------------------------------------------------- serving ---

def shard_llm_cache(mesh, cache):
    """This rank's KV heads (axis 3) of a ``serve.init_cache`` cache: a
    ``[A, b, len, nkv, hd]`` tensor or the int8 ``{"q", "s"}`` dict."""
    tp, r = axis_size(mesh, "model"), axis_index(mesh, "model")
    if isinstance(cache, dict):
        return {k: _cut(v, 3, r, tp) for k, v in cache.items()}
    return _cut(cache, 3, r, tp)


def tp_cache_factory(mesh):
    """``serve.init_cache``-compatible factory of this rank's head-sharded
    cache; pass as ``generate_kv_scan(..., cache_factory=tp_cache_factory(mesh))``."""
    from ssp_x_vit_tpu_torch.llm.serve import init_cache

    tp = axis_size(mesh, "model")
    device = "cuda" if mesh.device_type == "cuda" else "cpu"

    def factory(cfg, batch, max_len, dtype):
        if cfg.num_kv_heads % tp:
            raise ValueError(f"num_kv_heads {cfg.num_kv_heads} not divisible by model-axis "
                             f"size {tp}")
        local = dataclasses.replace(cfg, num_kv_heads=cfg.num_kv_heads // tp,
                                    explicit_head_dim=cfg.head_dim)
        return init_cache(local, batch, max_len, dtype, device)

    return factory


def tp_generate_kv_scan(params: Params, cfg: LlamaConfig, mesh, input_ids, **kw):
    """Tensor-parallel ``generate_kv_scan``: the full tree is sharded here
    (``shard_llama_params``), the cache is head-sharded, attention is
    head-local, the o / down sums and the vocab gather run over ``model``;
    every rank returns the same tokens."""
    from ssp_x_vit_tpu_torch.llm.serve import generate_kv_scan

    sharded = shard_llama_params(params, mesh, cfg)
    return generate_kv_scan(sharded, cfg, input_ids, cache_factory=tp_cache_factory(mesh),
                            tp_group=mesh.get_group("model"), **kw)


# ------------------------------------------------------------- perplexity ---

def _window_nll(params, tokens: torch.Tensor, cfg: LlamaConfig, tp, compute_dtype):
    """Per-window NLL sums ``[b]`` over each window's seq_len - 1 predictions."""
    logits, _ = llama_forward(params, tokens, cfg, compute_dtype=compute_dtype, tp_group=tp)
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    return -torch.gather(logp, -1, tokens[:, 1:, None])[..., 0].sum(dim=1)


def sharded_window_nll_fn(mesh, cfg: LlamaConfig, *, compute_dtype=torch.bfloat16):
    """``run(params, tokens [b, s]) -> [b]`` per-window NLL sums: the rows
    split over ``data``, each rank's ``model`` group running the
    tensor-parallel forward on its rows, the sums gathered back in row order."""
    dp, i = axis_size(mesh, "data"), axis_index(mesh, "data")
    dg, tg = mesh.get_group("data"), mesh.get_group("model")

    @torch.no_grad()
    def run(params, tokens) -> torch.Tensor:
        tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.int64)
        if tokens.shape[0] % dp:
            raise ValueError(f"{tokens.shape[0]} windows do not split over data={dp}")
        n = tokens.shape[0] // dp
        local = tokens[i * n:(i + 1) * n].to(params["embed"].device)
        sums = _window_nll(params, local, cfg, tg, compute_dtype)
        return gather_along(sums, 0, dg)

    return run


@torch.no_grad()
def evaluate_perplexity_sharded(params, cfg: LlamaConfig, mesh, input_ids, *,
                                seq_len: int = 2048, compute_dtype=torch.bfloat16) -> float:
    """Data + tensor-parallel perplexity with the single-device estimator:
    round k gives window k * dp + j to data rank j (a rank with no window in
    the last round adds nothing), params are the ``model`` shard; the NLL sums
    and token counts are all-reduced over ``data`` once at the end."""
    ids = np.asarray(input_ids).reshape(-1)
    num_windows = ids.size // seq_len
    if num_windows == 0:
        raise ValueError(f"input has {ids.size} tokens < seq_len {seq_len}: no full "
                         "window to evaluate (a silent ppl=1.0 would corrupt comparisons)")
    dp, j = axis_size(mesh, "data"), axis_index(mesh, "data")
    dg, tg = mesh.get_group("data"), mesh.get_group("model")
    device = params["embed"].device
    windows = ids[: num_windows * seq_len].reshape(num_windows, seq_len)
    total = torch.zeros((), dtype=torch.float64, device=device)
    count = 0
    for w in range(j, num_windows, dp):
        tokens = torch.from_numpy(windows[w:w + 1].astype(np.int64)).to(device)
        total += _window_nll(params, tokens, cfg, tg, compute_dtype).double().sum()
        count += seq_len - 1
    sums = torch.stack([total, torch.tensor(float(count), dtype=torch.float64, device=device)])
    total, count = all_reduce_sum(sums, dg).tolist()
    return float(np.exp(total / max(1.0, count)))


# ---------------------------------------------------------------- training ---

def _local_rows(mesh, tokens, device) -> torch.Tensor:
    """This rank's rows of the global token batch (split over ``data``)."""
    dp, i = axis_size(mesh, "data"), axis_index(mesh, "data")
    tokens = torch.as_tensor(np.asarray(tokens.cpu() if isinstance(tokens, torch.Tensor)
                                        else tokens), dtype=torch.int64)
    if tokens.shape[0] % dp:
        raise ValueError(f"batch of {tokens.shape[0]} rows does not split over data={dp}")
    n = tokens.shape[0] // dp
    return tokens[i * n:(i + 1) * n].to(device)


def _leaf_groups(params: Params, specs, axis: str, group) -> List:
    """Per leaf of ``optim.tree_leaves(params)``: ``group`` where the leaf is
    sharded over ``axis``, else None (replicated: counted once)."""
    out: List = []
    for k, v in params.items():
        if isinstance(v, dict):
            for bk, bv in v.items():
                out += [group if axis in specs[k][bk] else None] * bv.shape[0]
        else:
            out.append(group if axis in specs[k] else None)
    return out


def _mean_over(t: torch.Tensor, group, n: int) -> torch.Tensor:
    return all_reduce_sum(t, group).div_(n)


def make_sharded_llama_train_step(mesh, cfg: LlamaConfig, optimizer=None, *,
                                  compute_dtype=torch.bfloat16, remat: bool = True):
    """dp x tp training step ``step(params, opt_state, tokens) -> (params,
    opt_state, loss)`` on a ``shard_llama_params`` shard, updated in place
    (``opt_state = optimizer.init(shard)``). ``tokens`` is the global batch:
    each data rank takes its rows and the mean loss of its tokens; the
    gradients are averaged over ``data`` (the row-parallel sums ride the
    forward's and backward's ``model`` collectives); global-norm clipping
    sums the squares of sharded leaves over ``model`` and counts replicated
    leaves once; the flash kernels and per-layer remat are the single-device
    step's. The loss returned is the mean over ``data``."""
    from ssp_x_vit_tpu_torch.llm.optim import AdamW
    from ssp_x_vit_tpu_torch.llm.train import frozen_leaves, next_token_loss, trainable_tree

    require_llama_config(cfg)
    optimizer = optimizer or AdamW(1e-4)
    dp, dg, tg = axis_size(mesh, "data"), mesh.get_group("data"), mesh.get_group("model")

    def step(params: Params, opt_state: Dict, tokens):
        tree, leaves = trainable_tree(params)
        loss = next_token_loss(tree, _local_rows(mesh, tokens, params["embed"].device), cfg,
                               compute_dtype=compute_dtype, remat=remat, tp_group=tg)
        loss.backward()
        grads = [_mean_over(leaf.grad if leaf.grad is not None else torch.zeros_like(leaf),
                            dg, dp) for leaf in leaves]
        groups = _leaf_groups(params, llm_param_specs_like(params), "model", tg)
        optimizer.apply(params, grads, opt_state, frozen=frozen_leaves(params, cfg),
                        norm_groups=groups)
        return params, opt_state, _mean_over(loss.detach(), dg, dp)

    return step


# ------------------------------------------------------------------- FSDP ---

def fsdp_llama_param_specs_like(params: Params, dp: int) -> Dict[str, Any]:
    """Fully-sharded specs: each leaf shards its largest dp-divisible axis over
    ``data`` (never axis 0 of a stacked block leaf: that would cut whole
    layers); a leaf with no divisible axis stays replicated. Computed on the
    full (unsharded) tree."""
    def leaf_spec(v, start_axis):
        cands = [(s, i) for i, s in enumerate(v.shape) if i >= start_axis and s % dp == 0]
        if not cands:
            return _rep(v.dim())
        _, ax = max(cands)
        spec = [None] * v.dim()
        spec[ax] = "data"
        return tuple(spec)

    return {k: ({bk: leaf_spec(bv, 1) for bk, bv in v.items()} if isinstance(v, dict)
                else leaf_spec(v, 0)) for k, v in params.items()}


def shard_llama_params_fsdp(params: Params, mesh) -> Params:
    """This rank's fully-sharded shard over ``data`` (specs of
    :func:`fsdp_llama_param_specs_like`); a ``model`` > 1 mesh is refused."""
    if axis_size(mesh, "model") != 1:
        raise ValueError(
            "FSDP shards over 'data' only and would silently drop a megatron 'model' "
            "placement — use a model=1 mesh (fsdp x tp composition is future work; dp x tp "
            "lives in make_sharded_llama_train_step)")
    dp = axis_size(mesh, "data")
    return _place(params, fsdp_llama_param_specs_like(params, dp), "data",
                  axis_index(mesh, "data"), dp)


def make_fsdp_llama_train_step(mesh, cfg, optimizer=None, *, specs,
                               compute_dtype=torch.bfloat16, remat: bool = True):
    """FSDP training step ``step(params, opt_state, tokens)`` on a
    ``shard_llama_params_fsdp`` shard, updated in place; ``specs`` are
    :func:`fsdp_llama_param_specs_like` of the full tree (a shard's shapes do
    not say which axis was cut). Each layer's weights are all-gathered inside
    the (checkpointed) layer body, so the backward gathers them again, and the
    gather's backward reduce-scatters their gradients; the top-level leaves
    are gathered once a step. AdamW holds moments for the local shard only
    (``optimizer.init(shard)``); the clip norm sums the shards' squares over
    ``data``. Requires a model=1 mesh. ``cfg`` may be a ``DeepseekConfig``:
    the ``dense_blocks`` / ``moe_blocks`` layer bodies gather their weights and
    ``e_bias``'s update is zeroed, as in the single-device step."""
    from ssp_x_vit_tpu_torch.llm.deepseek import is_deepseek
    from ssp_x_vit_tpu_torch.llm.optim import AdamW
    from ssp_x_vit_tpu_torch.llm.train import frozen_leaves, next_token_loss, trainable_tree

    if not is_deepseek(cfg):
        require_llama_config(cfg)
    if axis_size(mesh, "model") != 1:
        raise ValueError("FSDP step requires a model=1 mesh (see shard_llama_params_fsdp)")
    optimizer = optimizer or AdamW(1e-4)
    dp, dg = axis_size(mesh, "data"), mesh.get_group("data")
    stacks = ("dense_blocks", "moe_blocks") if is_deepseek(cfg) else ("blocks",)

    def gather(t, spec, offset):
        if "data" not in spec:
            return t
        return fsdp_gather(t, spec.index("data") - offset, dg)

    def gather_layer(bp, key="blocks"):
        return {k: gather(v, specs[key][k], 1) for k, v in bp.items()}

    def step(params: Params, opt_state: Dict, tokens):
        tree, leaves = trainable_tree(params)
        full = {k: (v if k in stacks else gather(v, specs[k], 0)) for k, v in tree.items()}
        loss = next_token_loss(full, _local_rows(mesh, tokens, params["embed"].device), cfg,
                               compute_dtype=compute_dtype, remat=remat,
                               gather_layer=gather_layer)
        loss.backward()
        groups = _leaf_groups(params, specs, "data", dg)
        grads = []
        for leaf, group in zip(leaves, groups):
            g = leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)
            # a sharded leaf's gradient is already the sum over data (the reduce-scatter)
            grads.append(g.div_(dp) if group is not None else _mean_over(g, dg, dp))
        optimizer.apply(params, grads, opt_state, frozen=frozen_leaves(params, cfg),
                        norm_groups=groups)
        return params, opt_state, _mean_over(loss.detach(), dg, dp)

    return step


# ----------------------------------------- MoE-llama expert-parallel placement ---

_MOE_KEYS = frozenset({"gate_kernel", "up_kernel", "down_kernel"})


def moe_llama_param_specs_like(params: Params) -> Dict[str, Any]:
    """Specs of a MoE-llama tree (``num_experts`` > 0): the expert axis of the
    stacked expert leaves ``[L, E, ...]`` (float, ``_q``, ``_q4`` and their
    ``_scale``) over ``expert``; attention, norms, router and embeddings
    replicated."""
    specs: Dict[str, Any] = {}
    for k, v in params.items():
        if k == "blocks":
            specs["blocks"] = {
                bk: ((None, "expert") + (None,) * (bv.dim() - 2)
                     if _split_key(bk)[0] in _MOE_KEYS and bv.dim() >= 3 else _rep(bv.dim()))
                for bk, bv in v.items()}
        else:
            specs[k] = _rep(v.dim())
    return specs


def _place(params: Params, specs, axis: str, r: int, n: int) -> Params:
    """Every leaf cut on the axis its spec names ``axis`` (rank ``r`` of ``n``)."""
    def place(key, v, spec):
        if axis not in spec or n == 1:
            return v
        ax = spec.index(axis)
        if v.shape[ax] % n:
            raise ValueError(f"{key} axis {ax} of {tuple(v.shape)} not divisible by "
                             f"{axis}-axis size {n}")
        return _cut(v, ax, r, n)

    return {k: ({bk: place(bk, bv, specs[k][bk]) for bk, bv in v.items()} if isinstance(v, dict)
                else place(k, v, specs[k])) for k, v in params.items()}


def shard_moe_llama_params(params: Params, mesh) -> Params:
    """This rank's experts over the mesh's ``expert`` axis; run it with
    ``llama_forward(..., expert_group=mesh.get_group("expert"))``."""
    return _place(params, moe_llama_param_specs_like(params), "expert",
                  axis_index(mesh, "expert"), axis_size(mesh, "expert"))


# ------------------------------------------ DeepSeek / MLA tensor parallelism ---

# head-major output-dim kernels (an equal cut of the last axis is whole heads)
# and their row-parallel consumers
_DS_COL = frozenset({"q_kernel", "q_b_kernel", "kv_b_kernel",
                     "gate_kernel", "up_kernel", "shared_gate", "shared_up"})
_DS_ROW = frozenset({"o_kernel", "down_kernel", "shared_down"})


def _ds_block_spec(group: str, key: str, ndim: int) -> Spec:
    base, kind = _split_key(key)
    if group == "moe_blocks" and base in _MOE_KEYS:     # routed experts [L, E, ...]
        return (None, "model") + (None,) * (ndim - 2)
    if base in _DS_COL:
        return _rep(ndim - 1) + ("model",)
    if base in _DS_ROW:
        return _rep(ndim) if kind in ("q4", "scale") else _rep(ndim - 2) + ("model", None)
    return _rep(ndim)


def deepseek_param_specs_like(params: Params) -> Dict[str, Any]:
    """Megatron-for-MLA specs of a DeepSeek tree: column-parallel q / q_b /
    kv_b (head-major) and the dense / shared gate / up, row-parallel o / down /
    shared_down, the routed experts ``[L, E, d, f]`` over E, q_a / kv_a, norms,
    router and ``e_bias`` replicated, the untied lm_head over the vocabulary.
    A float tree's specs are JAX's; quantized leaves follow their float
    kernel's cut (JAX keeps them whole)."""
    specs: Dict[str, Any] = {}
    for k, v in params.items():
        if k in ("dense_blocks", "moe_blocks"):
            specs[k] = {bk: _ds_block_spec(k, bk, bv.dim()) for bk, bv in v.items()}
        else:
            specs[k] = _top_key_spec(k, v.dim())
    return specs


def shard_deepseek_params(params: Params, mesh, cfg) -> Params:
    """This rank's tensor-parallel shard over the mesh's ``model`` axis (JAX's
    divisibility refusals); run it with ``deepseek_forward`` /
    ``deepseek_generate(..., tp_group=mesh.get_group("model"))``."""
    tp = axis_size(mesh, "model")
    if cfg.num_heads % tp:
        raise ValueError(f"num_heads {cfg.num_heads} not divisible by "
                         f"model-axis size {tp}")
    if cfg.n_routed_experts and cfg.n_routed_experts % tp:
        raise ValueError(f"n_routed_experts {cfg.n_routed_experts} not "
                         f"divisible by model-axis size {tp}")
    if cfg.vocab_size % tp:
        raise ValueError(f"vocab_size {cfg.vocab_size} not divisible by "
                         f"model-axis size {tp}")
    if cfg.n_dense_layers and cfg.intermediate_size % tp:
        raise ValueError(f"intermediate_size {cfg.intermediate_size} not "
                         f"divisible by model-axis size {tp}")
    if cfg.n_moe_layers and cfg.n_shared_experts and \
            (cfg.moe_intermediate_size * cfg.n_shared_experts) % tp:
        raise ValueError("shared-expert width not divisible by model axis")
    return _place(params, deepseek_param_specs_like(params), "model",
                  axis_index(mesh, "model"), tp)
