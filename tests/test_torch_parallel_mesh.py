"""The port's meshes and ViT data / tensor parallelism against the JAX package.

The port runs in one gloo world of 4 CPU processes (``torch_parallel_workers``:
spawned workers, a FileStore rendezvous under ``tmp_path``, one intra-op
thread each, a 120 s bound on the world), the JAX package on the conftest's
8 virtual devices. The tiny ViT's weights and batches come from numpy seeds.

- meshes: shapes, coordinates, and JAX's refusals ("not divisible by
  model", "needs 8 devices", the hybrid mesh's "needs 16");
- top-1 with the batches split over ``data`` (4 ranks, and a hybrid mesh of
  2 hosts x 2) and the model over ``model`` (4 ranks of 1 head, and 2 x 2),
  against JAX's sharded ``evaluate_top1`` on a (2, 2) mesh and its
  single-device one (``tests/test_parallel.py`` pins the two equal):
  |delta| < 1e-9; the FFN importances within rtol 1e-5 and the same kept
  neurons; the copy-replace attention scores equal;
- the specs of ``vit_param_specs`` equal JAX's spec for spec;
- ``auto_2ssp --backend cpu --data-parallel`` as a world of 2 processes
  under ``torch.distributed.run`` (the command the CLI starts on more than
  one card) against the JAX CLI's report (``--data-parallel`` over 8
  devices): the same plan, pruned blocks, kept neurons and top-1,
  importances within rtol 1e-5; and the CLI's choice of that command.
"""

import glob
import json
import os
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch_parallel_workers import run_world

from ssp_x_vit_tpu.evaluation.classify import evaluate_top1 as j_top1
from ssp_x_vit_tpu.models.vit import ViTConfig as JViTConfig, init_vit_params
from ssp_x_vit_tpu.parallel import make_mesh as j_make_mesh, shard_batch as j_shard_batch
from ssp_x_vit_tpu.parallel.vit_sharding import (
    shard_vit_params as j_shard_vit, vit_param_specs as j_vit_specs,
)
from ssp_x_vit_tpu.pruning.depth import copy_replace_attention_importance as j_att
from ssp_x_vit_tpu.pruning.width import compute_ffn_activation_importance as j_imp
from ssp_x_vit_tpu.pruning.width import select_keep_indices

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(image_size=32, patch_size=8, hidden_size=64, num_layers=4, num_heads=4,
           intermediate_size=128, num_classes=10)
MESHES = ("dp4", "hybrid", "tp4", "dp2xtp2")


@pytest.fixture(scope="module")
def case():
    params = jax.tree.map(np.asarray, init_vit_params(jax.random.PRNGKey(3), JViTConfig(**CFG)))
    rng = np.random.default_rng(4)
    batches = [(rng.normal(size=(8, 32, 32, 3)).astype(np.float32),
                rng.integers(0, 10, size=8).astype(np.int64)) for _ in range(3)]
    return params, batches


@pytest.fixture(scope="module")
def world(case, tmp_path_factory):
    params, batches = case
    return run_world(tmp_path_factory.mktemp("vit_world"), 4, "vit",
                     {"cfg": CFG, "params": params, "batches": batches})


@pytest.fixture(scope="module")
def jax_ref(case):
    params, batches = case
    cfg = JViTConfig(**CFG)
    jb = [{"pixel_values": jnp.asarray(px), "labels": jnp.asarray(lb)} for px, lb in batches]
    mesh = j_make_mesh(data=2, model=2)   # the first 4 of the 8 virtual devices
    sharded = j_top1(j_shard_vit(params, mesh, cfg), cfg, [j_shard_batch(mesh, b) for b in jb])
    return {"top1": j_top1(params, cfg, jb), "top1_sharded": sharded,
            "imp": np.asarray(j_imp(params, cfg, jb)),
            "att": j_att(params, cfg, jb, batch_limit=3, verbose=False)}


def test_mesh_shapes_and_refusals(world):
    for rank, out in enumerate(world):
        assert out["mesh_2"] == (2, 2) and out["mesh_all"] == (4, 1)
        assert out["coords_2x2"] == (rank // 2, rank % 2)   # model is the inner axis
        assert "4 devices not divisible by model=3" in out["refuse_model3"]
        assert "mesh 4x2 needs 8 devices, have 4" in out["refuse_8"]
        assert "does not split over data=4" in out["refuse_odd_batch"]
        assert out["batch_spec"] == ("data", None, None, None)
        # tensor parallelism takes the dense forward only (GSPMD shards any tree for JAX)
        assert "dense forward only" in out["refuse_tp_materialized"]


def test_hybrid_mesh_hosts_outermost(world):
    for out in world:
        assert out["hybrid"] == [[0, 1], [2, 3]]   # host h holds ranks 2h, 2h+1
        assert "needs 16" in out["refuse_hybrid"]


@pytest.mark.parametrize("mesh", MESHES)
def test_vit_top1_matches_jax(world, jax_ref, mesh):
    assert abs(jax_ref["top1"] - jax_ref["top1_sharded"]) < 1e-9
    for out in world:   # every rank returns the same accuracy
        assert abs(out[f"top1_{mesh}"] - jax_ref["top1"]) < 1e-9
    if mesh == "tp4":
        assert abs(world[0]["top1_tp4_replicated_batches"] - jax_ref["top1"]) < 1e-9


@pytest.mark.parametrize("mesh", MESHES)
def test_vit_ffn_importance_matches_jax(world, jax_ref, mesh):
    want = jax_ref["imp"]
    keep = select_keep_indices(want, n_to_prune_per_block=[40] * 4, min_remaining=32,
                               verbose=False).keep_indices
    for out in world:
        got = out[f"imp_{mesh}"]
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
        np.testing.assert_array_equal(got, world[0][f"imp_{mesh}"])
        mine = select_keep_indices(got, n_to_prune_per_block=[40] * 4, min_remaining=32,
                                   verbose=False).keep_indices
        assert all((a == b).all() for a, b in zip(mine, keep))


@pytest.mark.parametrize("mesh", ("dp4", "dp2xtp2"))
def test_vit_copy_replace_scores_match_jax(world, jax_ref, mesh):
    impacts, base = jax_ref["att"]
    for out in world:
        got, got_base = out[f"att_{mesh}"]
        assert abs(got_base - base) < 1e-9
        np.testing.assert_allclose(got, impacts, atol=1e-9)


def test_vit_param_specs_match_jax():
    from ssp_x_vit_tpu_torch.models.vit import ViTConfig
    from ssp_x_vit_tpu_torch.parallel.vit_sharding import vit_param_specs

    for head in ("linear", "adapter"):
        kw = dict(CFG, head_type=head, adapter_bottleneck=16)
        want = jax.tree.map(tuple, j_vit_specs(JViTConfig(**kw)),
                            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        assert vit_param_specs(ViTConfig(**kw)) == want


def test_auto_2ssp_data_parallel_matches_jax_cli(tmp_path):
    """Two CPU processes under ``torch.distributed.run``
    (``auto_2ssp.launcher_argv``) against the JAX CLI on 8 virtual devices;
    rank 0 alone writes."""
    from ssp_x_vit_tpu.cli import auto_2ssp as jcli
    from ssp_x_vit_tpu.cli.common import NAMED_CONFIGS
    from ssp_x_vit_tpu.models.persistence import save_pruned_model
    from ssp_x_vit_tpu_torch.cli import auto_2ssp as tcli

    # one model for both CLIs: the tiny architecture saved in the framework format
    cfg = JViTConfig(num_classes=10, **NAMED_CONFIGS["tiny"])
    save_pruned_model(str(tmp_path / "model"), init_vit_params(jax.random.PRNGKey(5), cfg), cfg)
    argv = ["--model", str(tmp_path / "model"), "--dataset", "synthetic", "--target", "0.25",
            "--eval-batches", "2", "--min-remaining", "32", "--calib-per-class", "4",
            "--data-parallel"]
    jr = jcli.run(jcli.build_argparser().parse_args(argv + ["--out-root", str(tmp_path / "j")]))
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    # its own session, so that a world past its bound is killed whole
    proc = subprocess.Popen(tcli.launcher_argv(2, argv + ["--backend", "cpu", "--out-root",
                                                          str(tmp_path / "t")]),
                            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=150)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    assert proc.returncode == 0, stdout[-3000:] + stderr[-3000:]
    assert stdout.count("[INFO] Data-parallel eval over 2 devices") == 1   # rank 0 prints
    assert stdout.count("[SUMMARY]") == 1
    reports = glob.glob(str(tmp_path / "t" / "reports" / "*.json"))
    assert len(reports) == 1
    with open(reports[0]) as f:
        tr = json.load(f)
    assert tr["plan"] == jr["plan"]
    for key in ("params_before_stage1", "params_after_stage1", "params_after_stage2",
                "acc_baseline", "acc_stage1", "acc_stage2"):
        assert tr["metrics"][key] == jr["metrics"][key], key
    assert tr["artifacts"]["pruned_block_indices"] == jr["artifacts"]["pruned_block_indices"]

    def artifact(root, name):
        (path,) = glob.glob(str(root / "artifacts" / "*" / name))
        with open(path) as f:
            return json.load(f)

    assert artifact(tmp_path / "t", "ffn_prune_masks.json")["masks"] == \
        artifact(tmp_path / "j", "ffn_prune_masks.json")["masks"]
    t_imp = artifact(tmp_path / "t", "iterative_vit_b16_ffn_importances.json")["ffn"]
    j_imp_ = artifact(tmp_path / "j", "iterative_vit_b16_ffn_importances.json")["ffn"]
    assert list(t_imp) == list(j_imp_)
    np.testing.assert_allclose(list(t_imp.values()), list(j_imp_.values()), rtol=1e-5,
                               atol=1e-7)
    assert len(glob.glob(str(tmp_path / "t" / "artifacts" / "*"))) == 1


def test_auto_2ssp_starts_one_worker_per_card(monkeypatch):
    """``--data-parallel`` from the command line on more than one card (faked
    here: nothing reaches a card) builds the kernel libraries once, then
    becomes ``torch.distributed.run`` with one worker per card running the
    same command; under torchrun's environment, with ``--backend cpu`` or
    without the flag it runs in this process."""
    import torch

    from ssp_x_vit_tpu_torch.cli import auto_2ssp
    from ssp_x_vit_tpu_torch.ops.kernels import build

    calls = []

    def execv(path, cmd):   # never returns
        calls.append(cmd)
        raise SystemExit(0)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(build, "build_all", lambda: calls.append("build"))
    monkeypatch.setattr(auto_2ssp.os, "execv", execv)
    monkeypatch.setattr(auto_2ssp, "run", lambda args: calls.append("run"))
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    argv = ["--model", "tiny", "--data-parallel"]
    monkeypatch.setattr(sys, "argv", ["auto_2ssp"] + argv)
    with pytest.raises(SystemExit):
        auto_2ssp.main()
    assert calls == ["build", [sys.executable, "-m", "torch.distributed.run", "--standalone",
                               "--nproc_per_node=4", "-m", "ssp_x_vit_tpu_torch.cli.auto_2ssp",
                               *argv]]
    for extra, env in ((["--backend", "cpu"], {}), ([], {"RANK": "0", "WORLD_SIZE": "4"})):
        calls.clear()
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        monkeypatch.setattr(sys, "argv", ["auto_2ssp"] + argv + extra)
        auto_2ssp.main()
        assert calls == ["run"]
    monkeypatch.setattr(sys, "argv", ["auto_2ssp", "--model", "tiny"])
    calls.clear()
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var)
    auto_2ssp.main()
    assert calls == ["run"]
