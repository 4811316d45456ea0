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


TASKS = {"vit": vit_task, "llm": llm_task, "train": train_task}
