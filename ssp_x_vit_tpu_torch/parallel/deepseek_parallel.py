"""DeepSeek / MLA parallelism (counterpart of
``ssp_x_vit_tpu/parallel/deepseek_parallel.py``): the latent ring of sequence
parallelism and the dp x pp x tp pipeline of dense-MLP configs.

- :func:`mla_ring_attention`: the ring of ``parallel/ring_attention.py`` over
  MLA's COMPRESSED pair (``c_norm [b, sl, kv_lora_rank]``, ``k_rot [b, sl,
  rope_dim]``): the pair travels (``kv_lora_rank + rope_dim`` values a token,
  ~18x fewer bytes than the expanded per-head K/V at V3 widths) and each hop
  re-expands ``k_nope`` / ``v`` with the replicated ``kv_b``. The hop is the
  plain one (MLA's yarn scale and ``v_head_dim != qk_head_dim``), as JAX's
  ``jnp`` and the port's single-device ``_mla_attention`` are.
- :func:`make_deepseek_seq_parallel_nll`: the streaming NLL with the sequence
  over ``seq``; MoE blocks route their own tokens locally.
- the pipeline (:func:`make_deepseek_pipeline_forward` /
  :func:`make_deepseek_pipeline_train_step`): ``parallel/pipeline.py``'s
  schedules over ``llm/deepseek.py``'s layer with the ``model`` group (q / q_b
  / kv_b column-parallel, kv_a replicated, o / down row-parallel). Routed-expert
  configs are refused, as in JAX.
- FSDP of DeepSeek trees is ``llm_sharding.make_fsdp_llama_train_step`` with a
  ``DeepseekConfig``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ssp_x_vit_tpu_torch.parallel.collectives import (
    all_reduce_sum, gather_along, ring_rotate_start, warm_group,
)
from ssp_x_vit_tpu_torch.parallel.mesh import axis_index, axis_size
from ssp_x_vit_tpu_torch.parallel.ring_attention import _local_nll, merge_hop, ring_hop

Params = Dict[str, Any]


def mla_ring_attention(q_nope, q_rot, c_norm, k_rot, bp, cfg, group, *, n_chunks: int,
                       dt) -> torch.Tensor:
    """Causal MLA attention over the latent ring of ``group``: q_nope [b, nq,
    sl, nope] and q_rot [b, nq, sl, rd] (rope at global positions), c_norm [b,
    sl, kvr] / k_rot [b, sl, rd] the local compressed chunk (what the serving
    cache holds). Returns the local context [b, nq, sl, vd] in ``dt``."""
    from ssp_x_vit_tpu_torch.llm.deepseek import _mla_expand_kv, mla_softmax_scale

    n = 1 if group is None else torch.distributed.get_world_size(group)
    if n != n_chunks:
        raise ValueError(f"n_chunks {n_chunks} != seq group size {n}")
    p = 0 if group is None else torch.distributed.get_rank(group)
    if n > 1:
        warm_group(group, q_nope.device)
    q = torch.cat([q_nope, q_rot], dim=-1)
    scale = mla_softmax_scale(cfg)
    acc, cur_c, cur_kr = None, c_norm.contiguous(), k_rot.contiguous()
    for r in range(n):
        pending = ring_rotate_start((cur_c, cur_kr), group) if r < n - 1 else None
        k_nope, v = _mla_expand_kv(cur_c, bp, cfg, dt)
        k = torch.cat([k_nope, cur_kr[:, None].expand(-1, k_nope.shape[1], -1, -1)], dim=-1)
        acc = merge_hop(acc, ring_hop(q, k, v, p, (p - r) % n, causal=True, scale=scale))
        if pending is not None:
            cur_c, cur_kr = pending.wait()
    return acc[0].to(dt)   # the diagonal hop always runs


def make_deepseek_seq_parallel_nll(mesh, cfg, compute_dtype=torch.float32):
    """``run(params, tokens [b, s]) -> per-window NLL sums [b]``: the sequence
    over ``seq`` (latent ring), the rows over ``data``, params whole on every
    rank (``run.local(params, tokens)``: this rank's windows' sums, summed over
    ``seq``)."""
    from ssp_x_vit_tpu_torch.llm.deepseek import (
        _apply_rope, _deepseek_moe, _glu, _head_logits, _mla_compressed, _mla_q, _mm, _rms,
        _rope_tables, deepseek_layers,
    )

    sp, pidx = axis_size(mesh, "seq"), axis_index(mesh, "seq")
    dp, di = axis_size(mesh, "data"), axis_index(mesh, "data")
    sg, dg = mesh.get_group("seq"), mesh.get_group("data")
    dt = compute_dtype

    def local(params, tokens: torch.Tensor) -> torch.Tensor:
        b, s = tokens.shape
        sl = s // sp
        start = pidx * sl
        x = params["embed"][tokens[:, start:start + sl]].to(dt)
        cos, sin = _rope_tables(cfg, torch.arange(start, start + sl, device=x.device))
        for moe, ap, mp in deepseek_layers(params, cfg):
            if ap is not None:
                h = _rms(x, ap["ln1"], cfg.rms_eps)
                q = _mla_q(h, ap, cfg, dt)
                q_nope, q_rot = q[..., :cfg.qk_nope_head_dim], q[..., cfg.qk_nope_head_dim:]
                c_norm, k_rot_raw = _mla_compressed(h, ap, cfg, dt)
                q_rot = _apply_rope(q_rot, cos, sin, cfg.rope_interleave)
                k_rot = _apply_rope(k_rot_raw, cos, sin, cfg.rope_interleave)
                ctx = mla_ring_attention(q_nope, q_rot, c_norm, k_rot, ap, cfg, sg,
                                         n_chunks=sp, dt=dt)
                x = x + _mm(ctx.transpose(1, 2).reshape(b, sl, -1), ap, "o_kernel", dt)
            h2 = _rms(x, mp["ln2"], cfg.rms_eps)
            x = x + (_deepseek_moe(h2, mp, cfg, dt) if moe else _glu(h2, mp, dt))
        x = _rms(x, params["ln_final"], cfg.rms_eps)
        return all_reduce_sum(_local_nll(_head_logits(x, params, dt), tokens, start, sl), sg)

    @torch.no_grad()
    def run(params, tokens) -> torch.Tensor:
        tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.int64)
        b, s = tokens.shape
        if s % sp:
            raise ValueError(f"seq_len {s} % seq axis {sp} != 0")
        if b % dp:
            raise ValueError(f"{b} windows do not split over data={dp}")
        n = b // dp
        return gather_along(local(params, tokens[di * n:(di + 1) * n].to(
            params["embed"].device)), 0, dg)

    run.local = torch.no_grad()(local)
    return run


# ------------------------------------------------------------------ pipeline ---

def deepseek_pipeline_block_specs(cfg) -> Dict[str, tuple]:
    """JAX's PartitionSpecs (as tuples) of the stacked ``dense_blocks`` on a
    (data, pipe, model) mesh."""
    specs = {
        "ln1": ("pipe", None), "ln2": ("pipe", None),
        "kv_a_kernel": ("pipe", None, None),
        "kv_a_norm": ("pipe", None),
        "kv_b_kernel": ("pipe", None, "model"),
        "o_kernel": ("pipe", "model", None),
        "gate_kernel": ("pipe", None, "model"),
        "up_kernel": ("pipe", None, "model"),
        "down_kernel": ("pipe", "model", None),
    }
    if cfg.q_lora_rank is None:
        specs["q_kernel"] = ("pipe", None, "model")
    else:
        specs.update(q_a_kernel=("pipe", None, None), q_a_norm=("pipe", None),
                     q_b_kernel=("pipe", None, "model"))
    return specs


def _check(mesh, cfg) -> None:
    n_pipe, tp = axis_size(mesh, "pipe"), axis_size(mesh, "model")
    if cfg.n_moe_layers:
        raise ValueError(
            "the MLA pipeline covers dense-MLP DeepSeek configs "
            "(first_k_dense_replace == num_layers); routed experts run "
            "expert-parallel (parallel/llm_sharding.py MLA tp specs shard "
            "the expert axis) — an [E, d, f] expert einsum does not "
            "decompose along a pipe stage's layer scan")
    if cfg.num_layers % n_pipe:
        raise ValueError(f"num_layers {cfg.num_layers} % pipe {n_pipe} != 0")
    if cfg.num_heads % tp:
        raise ValueError(f"num_heads {cfg.num_heads} % model {tp} != 0")
    if cfg.effective_intermediate % tp:
        raise ValueError(f"intermediate {cfg.effective_intermediate} % "
                         f"model {tp} != 0")


def shard_deepseek_params_pipeline(params: Params, mesh, cfg) -> Params:
    """This rank's shard: its stage's dense layers cut over ``model`` (the
    specs of ``llm_sharding.deepseek_param_specs_like``), the top-level leaves
    whole."""
    from ssp_x_vit_tpu_torch.parallel.llm_sharding import _place, deepseek_param_specs_like
    from ssp_x_vit_tpu_torch.parallel.pipeline import _stage_layers

    _check(mesh, cfg)
    layers = _stage_layers(mesh, cfg.num_layers)
    stage = {"dense_blocks": {k: v[layers.start:layers.stop]
                              for k, v in params["dense_blocks"].items()}}
    cut = _place(stage, deepseek_param_specs_like(stage), "model",
                 axis_index(mesh, "model"), axis_size(mesh, "model"))
    return dict(params, dense_blocks=cut["dense_blocks"])


def _pieces(mesh, cfg, dt):
    from ssp_x_vit_tpu_torch.llm.deepseek import _embed, _head_logits, _layer, _rms
    from ssp_x_vit_tpu_torch.parallel.pipeline import _stage_layers

    n = len(_stage_layers(mesh, cfg.num_layers))
    tp = mesh.get_group("model")

    def stage(tree, x, rope):
        blocks = tree["dense_blocks"]
        for j in range(n):
            bp = {k: v[j] for k, v in blocks.items()}
            x = _layer(x, False, bp, bp, cfg, dt, None, None, False, tp)[0]
        return x

    def head(tree, y):
        return _head_logits(_rms(y, tree["ln_final"], cfg.rms_eps), tree, dt)

    return dict(embed=lambda tree, toks: _embed(tree, toks, dt), stage=stage, head=head,
                rope=lambda s, device: None)


def _schedule(mesh, cfg, num_microbatches, compute_dtype):
    from ssp_x_vit_tpu_torch.parallel.pipeline import Schedule

    _check(mesh, cfg)
    return Schedule(mesh, num_microbatches=num_microbatches, hidden=cfg.hidden_size,
                    compute_dtype=compute_dtype, **_pieces(mesh, cfg, compute_dtype))


def make_deepseek_pipeline_forward(mesh, cfg, *, num_microbatches: int,
                                   compute_dtype=torch.float32):
    """``forward(params, tokens [b, s]) -> logits [b / dp, s, V]`` fp32 of this
    data rank's rows, on a ``shard_deepseek_params_pipeline`` shard (the GPipe
    schedule of ``parallel/pipeline.py``)."""
    return _schedule(mesh, cfg, num_microbatches, compute_dtype).forward


def make_deepseek_pipeline_train_step(mesh, cfg, optimizer=None, *, num_microbatches: int,
                                      compute_dtype=torch.float32, schedule: str = "gpipe"):
    """``step(params, opt_state, tokens) -> (params, opt_state, loss)`` through
    the pipelined MLA blocks (``parallel/pipeline.py``'s step: GPipe, or
    ``schedule="1f1b"``), updated in place."""
    from ssp_x_vit_tpu_torch.parallel.llm_sharding import _ds_block_spec
    from ssp_x_vit_tpu_torch.parallel.pipeline import _train_step

    return _train_step(mesh, cfg, _schedule(mesh, cfg, num_microbatches, compute_dtype),
                       optimizer, schedule,
                       lambda group, key, v: _ds_block_spec(group, key, v.dim()))
