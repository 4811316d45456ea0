"""Worlds of CPU processes for the port's parallel tests (gloo).

``run_world(tmp_path, n, task, payload)`` starts ``n`` processes with the
``spawn`` method (the pytest process holds XLA's threads, which ``fork``
would copy mid-flight), joins them through a ``FileStore`` under
``tmp_path`` (so concurrent test workers never race for a port), runs
``TASKS[task](payload)`` in each with one intra-op thread, and returns each rank's picklable result. A rank that fails fails
the test with its traceback; a world still running after ``timeout``
seconds is killed and fails the test instead of eating the suite's clock.

This module imports only torch, numpy and the port: it is what the spawned
processes import.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import traceback

import numpy as np
import torch


def run_world(tmp_path, n: int, task: str, payload, timeout: float = 120.0):
    import multiprocessing as mp

    tmp = str(tmp_path)
    with open(os.path.join(tmp, "payload.pkl"), "wb") as f:
        pickle.dump(payload, f)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(r, n, tmp, task)) for r in range(n)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    results = []
    for r in range(n):
        path = os.path.join(tmp, f"rank{r}.pkl")
        if not os.path.exists(path):
            raise AssertionError(f"rank {r} of {task} wrote no result (hung: {hung}, exit codes "
                                 f"{[p.exitcode for p in procs]})")
        with open(path, "rb") as f:
            ok, value = pickle.load(f)
        if not ok:
            raise AssertionError(f"rank {r} of {task} failed:\n{value}")
        results.append(value)
    if hung:
        raise AssertionError(f"ranks {hung} of {task} hung past {timeout} s")
    return results


def _entry(rank: int, n: int, tmp: str, task: str) -> None:
    torch.set_num_threads(1)
    from ssp_x_vit_tpu_torch.parallel.mesh import init_distributed

    try:
        init_distributed("cpu", init_method="file://" + os.path.join(tmp, "store"), rank=rank,
                         world_size=n, timeout=datetime.timedelta(seconds=120))
        with open(os.path.join(tmp, "payload.pkl"), "rb") as f:
            payload = pickle.load(f)
        out = (True, TASKS[task](payload))
    except Exception:   # the traceback goes back to the test
        out = (False, traceback.format_exc())
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    if out[0]:
        torch.distributed.destroy_process_group()


def _raises(fn, *args, **kwargs) -> str:
    """The message of the ValueError that ``fn`` raises ('' when it returns)."""
    try:
        fn(*args, **kwargs)
    except ValueError as e:
        return str(e)
    return ""


# ------------------------------------------------------------------ ViT ---

def _vit_batches(payload):
    return [{"pixel_values": torch.from_numpy(px), "labels": torch.from_numpy(lb)}
            for px, lb in payload["batches"]]


def vit_task(payload):
    """Meshes and their refusals, then ViT top-1 / candidates / importances
    under data and tensor parallelism (world of 4)."""
    from ssp_x_vit_tpu_torch.evaluation.classify import evaluate_top1
    from ssp_x_vit_tpu_torch.models.vit import ViTConfig
    from ssp_x_vit_tpu_torch.parallel import mesh as M
    from ssp_x_vit_tpu_torch.parallel import vit_sharding as V
    from ssp_x_vit_tpu_torch.pruning.depth import copy_replace_attention_importance
    from ssp_x_vit_tpu_torch.pruning.width import compute_ffn_activation_importance

    out = {"mesh_2": tuple(M.make_mesh(model=2).mesh.shape),
           "mesh_all": tuple(M.make_mesh().mesh.shape),
           "coords_2x2": tuple(M.make_mesh(model=2).get_coordinate()),
           "refuse_model3": _raises(M.make_mesh, model=3),
           "refuse_8": _raises(M.make_mesh, data=4, model=2),
           "hybrid": M.make_hybrid_mesh(2, ici_data=1, model=2).mesh.tolist(),
           "refuse_hybrid": _raises(M.make_hybrid_mesh, 4, ici_data=2, model=2),
           "batch_spec": M.batch_sharding(M.make_mesh(), 4)}
    cfg = ViTConfig(**payload["cfg"])
    params = {k: ({kk: torch.from_numpy(vv) for kk, vv in v.items()} if isinstance(v, dict)
                  else torch.from_numpy(v)) for k, v in payload["params"].items()}
    batches = _vit_batches(payload)
    meshes = {"dp4": M.make_mesh(model=1), "hybrid": M.make_hybrid_mesh(2, ici_data=2),
              "tp4": M.make_mesh(model=4), "dp2xtp2": M.make_mesh(model=2)}
    for name, mesh in meshes.items():
        shard = V.shard_vit_params(params, mesh, cfg)
        local = [M.shard_batch(mesh, b) for b in batches]
        dg, tg = mesh.get_group("data"), mesh.get_group("model")
        out[f"top1_{name}"] = V.evaluate_top1_sharded(shard, cfg, local, mesh)
        out[f"imp_{name}"] = compute_ffn_activation_importance(shard, cfg, local, data_group=dg,
                                                               tp_group=tg)
        if name in ("dp4", "dp2xtp2"):
            out[f"att_{name}"] = copy_replace_attention_importance(
                shard, cfg, local, batch_limit=None, verbose=False, data_group=dg, tp_group=tg)
        if name == "tp4":
            out["top1_tp4_replicated_batches"] = evaluate_top1(shard, cfg, batches, tp_group=tg)
    out["refuse_odd_batch"] = _raises(M.shard_batch, meshes["dp4"],
                                      {"labels": torch.zeros(6, dtype=torch.int64)})
    tp4 = meshes["tp4"]
    out["refuse_tp_materialized"] = _raises(
        evaluate_top1, V.shard_vit_params(params, tp4, cfg),
        dataclasses.replace(cfg, pruned_attention_blocks=(0,)), batches,
        tp_group=tp4.get_group("model"))
    return out


# ------------------------------------------------------------------ LLM ---

def _llm_tree(tree):
    from ssp_x_vit_tpu_torch.llm.checkpoints import llm_params_from_jax

    return llm_params_from_jax(tree, device="cpu")


def llm_task(payload):
    """dp x tp perplexity and tensor-parallel serving of each case (world of 4)."""
    from ssp_x_vit_tpu_torch.llm.model import LlamaConfig
    from ssp_x_vit_tpu_torch.llm.quant import quantize_llm_params_int4, quantize_llm_params_int8
    from ssp_x_vit_tpu_torch.llm.serve import pack_llm_params_for_serving
    from ssp_x_vit_tpu_torch.parallel import llm_sharding as S
    from ssp_x_vit_tpu_torch.parallel import mesh as M

    meshes = {"2x2": M.make_mesh(model=2), "1x4": M.make_mesh(model=4)}
    out = {}
    for name, case in payload["ppl"].items():
        cfg = LlamaConfig(**case["cfg"])
        params = _llm_tree(case["params"])
        mesh = meshes[case["mesh"]]
        shard = S.shard_llama_params(params, mesh, cfg)
        out[f"ppl_{name}"] = S.evaluate_perplexity_sharded(
            shard, cfg, mesh, case["stream"], seq_len=case["seq_len"],
            compute_dtype=torch.float32)
        out[f"nll_{name}"] = S.sharded_window_nll_fn(mesh, cfg, compute_dtype=torch.float32)(
            shard, case["windows"]).numpy()
    for name, case in payload["serve"].items():
        cfg = LlamaConfig(**case["cfg"])
        tree = _llm_tree(case["params"])
        if case.get("quant") == "int8":
            tree = quantize_llm_params_int8(tree, cfg)
        elif case.get("quant") == "int4":
            tree = quantize_llm_params_int4(tree, cfg)
        if case.get("packed"):
            tree = pack_llm_params_for_serving(tree, cfg)
        cache = {"fp32": torch.float32, "int8": torch.int8}[case["cache"]]
        toks = S.tp_generate_kv_scan(tree, cfg, meshes[case["mesh"]], case["prompts"],
                                     max_length=case["max_length"], cache_dtype=cache)
        out[f"serve_{name}"] = [np.asarray(t) for t in (toks if isinstance(toks, list)
                                                        else [toks])]
    cfg = LlamaConfig(**payload["refusal_cfg"])
    params = _llm_tree(payload["refusal_params"])
    from ssp_x_vit_tpu_torch.llm.serve import init_cache

    full = init_cache(cfg, 2, 8, torch.int8, "cpu")[0]
    full["q"].copy_(torch.arange(full["q"].numel()).reshape(full["q"].shape) % 100)
    local = S.shard_llm_cache(meshes["2x2"], full)
    made = S.tp_cache_factory(meshes["2x2"])(cfg, 2, 8, torch.int8)[0]
    out["cache"] = {k: (tuple(v.shape), tuple(made[k].shape)) for k, v in local.items()}
    out["cache_heads"] = local["q"].numpy()
    out["refuse_kv"] = _raises(S.shard_llama_params, params, meshes["1x4"], cfg)
    out["refuse_window"] = _raises(S.evaluate_perplexity_sharded,
                                   S.shard_llama_params(params, meshes["2x2"], cfg), cfg,
                                   meshes["2x2"], np.arange(10), seq_len=16)
    return out


def train_task(payload):
    """One dp x tp step and one FSDP step from the same tree and tokens."""
    from ssp_x_vit_tpu_torch.llm.model import LlamaConfig
    from ssp_x_vit_tpu_torch.llm.optim import AdamW, tree_leaves
    from ssp_x_vit_tpu_torch.parallel import llm_sharding as S
    from ssp_x_vit_tpu_torch.parallel import mesh as M

    cfg = LlamaConfig(**payload["cfg"])
    out = {}
    for clip in (None, payload["clip"]):
        opt = AdamW(1e-2, grad_clip=clip)
        mesh = M.make_mesh(model=2)
        shard = S.shard_llama_params(_llm_tree(payload["params"]), mesh, cfg)
        step = S.make_sharded_llama_train_step(mesh, cfg, opt, compute_dtype=torch.float32)
        shard, _, loss = step(shard, opt.init(shard), payload["tokens"])
        out[f"tp_{clip}"] = (float(loss), {k: _np_tree(v) for k, v in shard.items()})

        mesh = M.make_mesh(model=1)
        full = _llm_tree(payload["params"])
        specs = S.fsdp_llama_param_specs_like(full, M.axis_size(mesh, "data"))
        shard = S.shard_llama_params_fsdp(full, mesh)
        step = S.make_fsdp_llama_train_step(mesh, cfg, opt, specs=specs,
                                            compute_dtype=torch.float32)
        state = opt.init(shard)
        shard, state, loss = step(shard, state, payload["tokens"])
        out[f"fsdp_{clip}"] = (float(loss), {k: _np_tree(v) for k, v in shard.items()})
        out["fsdp_specs"] = specs
        out["moment_elems"] = sum(t.numel() for t in tree_leaves(state["mu"]))
        out["full_elems"] = sum(t.numel() for t in tree_leaves(full))
    out["refuse_fsdp_tp"] = _raises(S.shard_llama_params_fsdp, _llm_tree(payload["params"]),
                                    M.make_mesh(model=2))
    return out


def _np_tree(v):
    if isinstance(v, dict):
        return {k: t.detach().numpy().copy() for k, t in v.items()}
    return v.detach().numpy().copy()


def _clone(tree):
    return {k: (_clone(v) if isinstance(v, dict) else v.clone()) for k, v in tree.items()}


def _cut_seq(t: torch.Tensor, mesh) -> torch.Tensor:
    from ssp_x_vit_tpu_torch.parallel.mesh import axis_index, axis_size

    n, r = axis_size(mesh, "seq"), axis_index(mesh, "seq")
    sl = t.shape[2] // n
    return t[:, :, r * sl:(r + 1) * sl].contiguous()


def ring_task(payload):
    """Ring attention (each case's full output gathered over seq) and
    sequence-parallel perplexity on the (1, 4) and (2, 2) seq meshes."""
    from ssp_x_vit_tpu_torch.llm.model import LlamaConfig
    from ssp_x_vit_tpu_torch.parallel import mesh as M
    from ssp_x_vit_tpu_torch.parallel import ring_attention as R
    from ssp_x_vit_tpu_torch.parallel.collectives import gather_along

    meshes = {"1x4": M.make_seq_mesh(1, 4), "2x2": M.make_seq_mesh(2, 2)}
    out = {}
    for mname, mesh in meshes.items():
        g, n = mesh.get_group("seq"), M.axis_size(mesh, "seq")
        for name, c in payload["attn"].items():
            q, k, v = (_cut_seq(torch.from_numpy(c[x]), mesh) for x in "qkv")
            o = R.ring_attention(q, k, v, g, n_chunks=n, causal=True, window=c["window"],
                                 softcap=c["softcap"], scale=c["scale"])
            out[f"attn_{mname}_{name}"] = gather_along(o, 2, g).numpy()
        for name, c in payload["ppl"].items():
            cfg = LlamaConfig(**c["cfg"])
            params = _llm_tree(c["params"])
            out[f"ppl_{mname}_{name}"] = R.evaluate_perplexity_seq_parallel(
                params, cfg, mesh, c["stream"], seq_len=c["seq_len"])
            out[f"nll_{mname}_{name}"] = R.make_seq_parallel_nll(mesh, cfg)(
                params, c["windows"]).numpy()
    out["refuse_opt"] = _raises(R.make_seq_parallel_nll, meshes["1x4"],
                                LlamaConfig(**payload["opt_cfg"]))
    out["refuse_seq"] = _raises(R.make_seq_parallel_nll(meshes["1x4"], LlamaConfig(
        **payload["ppl"]["llama"]["cfg"])), _llm_tree(payload["ppl"]["llama"]["params"]),
        np.zeros((1, 6), np.int64))
    return out


def _np_shard(tree):
    return {k: (_np_shard(v) if isinstance(v, dict) else v.detach().numpy().copy())
            for k, v in tree.items()}


def _grad_tree(params, grads):
    """The reduced gradients (``optim.tree_leaves`` order) as a tree of stacks."""
    out, i = {}, 0
    for k, v in params.items():
        if isinstance(v, dict):
            out[k] = {}
            for bk, bv in v.items():
                n = bv.shape[0]
                out[k][bk] = torch.stack(grads[i:i + n]).numpy()
                i += n
        else:
            out[k] = grads[i].numpy()
            i += 1
    return out


def pipeline_task(payload):
    """The llama pipeline on (1, 2, 2) and (1, 4, 1): logits, gradients, one
    GPipe and one 1F1B AdamW step, 1F1B's held inputs, the refusals."""
    from ssp_x_vit_tpu_torch.llm.model import LlamaConfig
    from ssp_x_vit_tpu_torch.llm.optim import AdamW
    from ssp_x_vit_tpu_torch.parallel import mesh as M
    from ssp_x_vit_tpu_torch.parallel import pipeline as PP

    out = {}
    meshes = {s: M.make_pipeline_mesh(*s) for s in ((1, 2, 2), (1, 4, 1))}
    for mshape, mesh in meshes.items():
        out[f"coord_{mshape}"] = tuple(mesh.get_coordinate())
        for name, c in payload["cases"].items():
            cfg = LlamaConfig(**c["cfg"])
            params = _llm_tree(c["params"])
            shard = PP.shard_llama_params_pipeline(_clone(params), mesh, cfg)
            fwd = PP.make_pipeline_forward(mesh, cfg, num_microbatches=2)
            out[f"fwd_{mshape}_{name}"] = fwd(shard, c["tokens"]).numpy()
            step = PP.make_pipeline_train_step(mesh, cfg, num_microbatches=2)
            loss, grads = step.grads(shard, c["tokens"])
            out[f"grad_{mshape}_{name}"] = (float(loss), _grad_tree(shard, grads))
            if name != "llama":
                continue
            for sched in PP.SCHEDULES:
                opt = AdamW(payload["lr"], eps=payload["eps"])
                tree = PP.shard_llama_params_pipeline(_clone(params), mesh, cfg)
                step = PP.make_pipeline_train_step(mesh, cfg, opt, num_microbatches=4,
                                                   schedule=sched)
                tree, _, loss = step(tree, opt.init(tree), payload["step_tokens"])
                out[f"step_{mshape}_{sched}"] = (float(loss), _np_shard(tree))
                out[f"held_{mshape}_{sched}"] = step.schedule.held_max
    mesh = meshes[(1, 4, 1)]
    c = payload["cases"]["llama"]
    cfg, params = LlamaConfig(**c["cfg"]), _llm_tree(c["params"])
    opt = AdamW(payload["lr"], eps=payload["eps"])
    step = PP.make_pipeline_train_step_1f1b(mesh, cfg, opt, num_microbatches=8)
    step(PP.shard_llama_params_pipeline(_clone(params), mesh, cfg), opt.init(
        PP.shard_llama_params_pipeline(_clone(params), mesh, cfg)), payload["long_tokens"])
    out["held_m8"] = step.schedule.held_max
    refusals = {}
    for name, (kind, kw) in payload["refusals"].items():
        bad = LlamaConfig(**kw)
        m = meshes[(1, 2, 2)]
        if kind == "forward":
            refusals[name] = _raises(PP.make_pipeline_forward, m, bad, num_microbatches=2)
        elif kind == "batch":
            fwd = PP.make_pipeline_forward(m, bad, num_microbatches=3)
            refusals[name] = _raises(fwd, PP.shard_llama_params_pipeline(params, m, cfg),
                                     np.zeros((4, 8), np.int64))
        else:
            refusals[name] = _raises(PP.make_pipeline_train_step, m, bad,
                                     num_microbatches=2, schedule="zigzag")
    out["refusals"] = refusals
    return out


def deepseek_task(payload):
    """DeepSeek: the latent ring, tp = 4 generation, the placements' refusals,
    FSDP, the dense pipeline and its MoE refusal."""
    from ssp_x_vit_tpu_torch.llm.checkpoints import deepseek_params_from_jax
    from ssp_x_vit_tpu_torch.llm.deepseek import DeepseekConfig, deepseek_generate
    from ssp_x_vit_tpu_torch.llm.optim import AdamW
    from ssp_x_vit_tpu_torch.parallel import deepseek_parallel as DP
    from ssp_x_vit_tpu_torch.parallel import llm_sharding as S
    from ssp_x_vit_tpu_torch.parallel import mesh as M
    from ssp_x_vit_tpu_torch.parallel import ring_attention as R

    def tree(t):
        return deepseek_params_from_jax(t, device="cpu")

    out = {}
    cfg, params = DeepseekConfig(**payload["moe_cfg"]), tree(payload["moe_params"])
    for shape in ((1, 4), (2, 2)):
        out[f"ppl_{shape}"] = R.evaluate_perplexity_seq_parallel(
            params, cfg, M.make_seq_mesh(*shape), payload["stream"], seq_len=payload["seq_len"])
    tp4 = M.make_mesh(model=4)
    shard = S.shard_deepseek_params(params, tp4, cfg)
    out["tp_tokens"] = np.asarray(deepseek_generate(
        shard, cfg, payload["prompt"], max_new_tokens=6, compute_dtype=torch.float32,
        tp_group=tp4.get_group("model")))
    out["tp_shapes"] = {k: {kk: tuple(vv.shape) for kk, vv in v.items()} if isinstance(v, dict)
                        else tuple(v.shape) for k, v in shard.items()}
    out["refusals"] = {name: _raises(S.shard_deepseek_params, tree(t), tp4, DeepseekConfig(**kw))
                       for name, (kw, t) in payload["refusals"].items()}

    dp4 = M.make_mesh(model=1)
    full = tree(payload["moe_params"])
    specs = S.fsdp_llama_param_specs_like(full, 4)
    fsdp = S.shard_llama_params_fsdp(full, dp4)
    opt = AdamW(payload["lr"], eps=payload["eps"])
    state = opt.init(fsdp)
    fsdp, state, loss = S.make_fsdp_llama_train_step(dp4, cfg, opt, specs=specs,
                                                     compute_dtype=torch.float32)(
        fsdp, state, payload["fsdp_tokens"])
    out["fsdp"] = (float(loss), _np_shard(fsdp))
    out["fsdp_specs"] = specs

    dcfg, dparams = DeepseekConfig(**payload["dense_cfg"]), tree(payload["dense_params"])
    for shape in ((1, 2, 2), (1, 4, 1)):
        mesh = M.make_pipeline_mesh(*shape)
        out[f"coord_{shape}"] = tuple(mesh.get_coordinate())
        sh = DP.shard_deepseek_params_pipeline(_clone(dparams), mesh, dcfg)
        out[f"fwd_{shape}"] = DP.make_deepseek_pipeline_forward(
            mesh, dcfg, num_microbatches=2)(sh, payload["pipe_tokens"]).numpy()
        opt = AdamW(payload["lr"], eps=payload["eps"])
        step = DP.make_deepseek_pipeline_train_step(mesh, dcfg, opt, num_microbatches=2)
        sh, _, loss = step(sh, opt.init(sh), payload["pipe_tokens"])
        out[f"step_{shape}"] = (float(loss), _np_shard(sh))
    out["refuse_moe"] = _raises(DP.make_deepseek_pipeline_forward,
                                M.make_pipeline_mesh(1, 2, 2), cfg, num_microbatches=2)
    return out


def expert_task(payload):
    """moe_ffn on the (1, 4) expert mesh; the MoE-llama forward with whole
    experts per rank (expert mesh) and with their f axis cut (tp = 4)."""
    from ssp_x_vit_tpu_torch.llm.model import LlamaConfig, llama_forward
    from ssp_x_vit_tpu_torch.llm.quant import quantize_llm_params_int4, quantize_llm_params_int8
    from ssp_x_vit_tpu_torch.parallel import llm_sharding as S
    from ssp_x_vit_tpu_torch.parallel import mesh as M
    from ssp_x_vit_tpu_torch.parallel import moe as MO

    em, tp4 = M.make_expert_mesh(1, 4), M.make_mesh(model=4)
    out = {}
    for name, c in payload["moe"].items():
        cfg = MO.MoEConfig(**c["cfg"])
        shard = MO.shard_moe_params({k: torch.from_numpy(v) for k, v in c["params"].items()}, em)
        y, aux = MO.moe_ffn(shard, torch.from_numpy(c["x"]), cfg, mesh=em)
        out[f"moe_{name}"] = (y.numpy(), {k: v.numpy() for k, v in aux.items()},
                              tuple(shard["gate_kernel"].shape))
    cfg = LlamaConfig(**payload["llama_cfg"])
    tokens = torch.from_numpy(payload["tokens"])
    for quant in ("float", "int8", "int4"):
        params = _llm_tree(payload["llama_params"])
        if quant == "int8":
            params = quantize_llm_params_int8(params, cfg)
        elif quant == "int4":
            params = quantize_llm_params_int4(params, cfg)
        with torch.no_grad():
            logits, aux = llama_forward(S.shard_moe_llama_params(params, em), tokens, cfg,
                                        compute_dtype=torch.float32,
                                        expert_group=em.get_group("expert"))
            out[f"ep_{quant}"] = (logits.numpy(), aux["moe_aux_loss"].numpy())
            if quant == "int4":
                out["refuse_tp_int4"] = _raises(S.shard_llama_params, params, tp4, cfg)
                continue
            logits, aux = llama_forward(S.shard_llama_params(params, tp4, cfg), tokens, cfg,
                                        compute_dtype=torch.float32,
                                        tp_group=tp4.get_group("model"))
            out[f"tp_{quant}"] = (logits.numpy(), aux["moe_aux_loss"].numpy())
    return out


TASKS = {"vit": vit_task, "llm": llm_task, "train": train_task, "ring": ring_task,
         "pipeline": pipeline_task, "deepseek": deepseek_task, "expert": expert_task}
