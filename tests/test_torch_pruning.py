"""The ported 2SSP pruning against the JAX package on the CPU: identical
plans, parameter counts, keep sets, candidate impacts and pruning results."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from ssp_x_vit_tpu.cli.common import NAMED_CONFIGS as J_NAMED
from ssp_x_vit_tpu.models.vit import ViTConfig as JConfig
from ssp_x_vit_tpu import pruning as jpr
from ssp_x_vit_tpu_torch.cli.common import NAMED_CONFIGS as T_NAMED
from ssp_x_vit_tpu_torch.models.checkpoints import params_from_jax
from ssp_x_vit_tpu_torch.models.vit import ViTConfig as TConfig
from ssp_x_vit_tpu_torch import pruning as tpr

PROCGEN = dict(image_size=64, patch_size=8, hidden_size=256, num_layers=10, num_heads=4,
               intermediate_size=1024, num_classes=16)
CONFIGS = {"vit-b16": J_NAMED["vit-b16"], "vit-s16": J_NAMED["vit-s16"],
           "vit-ti16": J_NAMED["vit-ti16"], "vit_procgen": PROCGEN}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's tiny tensors: the suite runs six
    workers on the host's cores, where a pool per worker only contends."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(kw):
    return JConfig(**kw), TConfig(**kw)


def test_named_configs_are_the_same():
    assert T_NAMED == J_NAMED


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("target", [0.1, 0.25, 0.4, 0.6])
def test_plan_identical(name, target, capsys):
    jcfg, tcfg = _pair(CONFIGS[name])
    min_remaining = 32 if name == "vit_procgen" else 512
    jplan = jpr.plan_2ssp_allocation(jcfg, target, min_remaining=min_remaining)
    jlog = capsys.readouterr().out
    tplan = tpr.plan_2ssp_allocation(tcfg, target, min_remaining=min_remaining)
    tlog = capsys.readouterr().out
    assert dataclasses.asdict(tplan) == dataclasses.asdict(jplan)
    assert tlog == jlog and "[PLAN-LOG] chosen" in tlog


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_accounting_identical(name):
    jcfg, tcfg = _pair(CONFIGS[name])
    L, f = jcfg.num_layers, jcfg.intermediate_size
    pruned = dict(block_intermediate_sizes=tuple(f - 7 * i for i in range(L)),
                  pruned_attention_blocks=(1, L - 2))
    for jc, tc in ((jcfg, tcfg), (dataclasses.replace(jcfg, **pruned),
                                  dataclasses.replace(tcfg, **pruned))):
        assert tpr.count_total_params(tc) == jpr.count_total_params(jc)
        assert tpr.count_block_params(tc) == jpr.count_block_params(jc)
        assert tpr.count_attention_params_per_block(tc) == jpr.count_attention_params_per_block(jc)
        assert tpr.count_ffn_params_per_block(tc) == jpr.count_ffn_params_per_block(jc)


def test_select_keep_indices_identical():
    rng = np.random.default_rng(0)
    imp = rng.random((4, 300)).astype(np.float32)
    imp[:, ::7] = 0.5  # ties: the stable descending argsort decides
    for kw in (dict(n_to_prune_per_block=[0, 10, 150, 290], min_remaining=16),
               dict(sparsity=0.3, min_remaining=256)):
        j = jpr.select_keep_indices(imp, verbose=False, **kw)
        t = tpr.select_keep_indices(imp, verbose=False, **kw)
        for a, b in zip(t.keep_indices, j.keep_indices):
            np.testing.assert_array_equal(a, b)
        assert t.prune_masks == j.prune_masks and t.n_pruned_per_block == j.n_pruned_per_block


def _torch_batches(batches):
    return [{"pixel_values": torch.from_numpy(np.array(b["pixel_values"])),
             "labels": torch.from_numpy(np.asarray(b["labels"]).astype(np.int64))}
            for b in batches]


def test_ffn_importance_and_copy_impacts_identical(tiny_cfg, tiny_params, tiny_batches):
    tparams = params_from_jax(jax.device_get(tiny_params), device="cpu")
    tcfg = TConfig(**dataclasses.asdict(tiny_cfg))
    tb = _torch_batches(tiny_batches)
    np.testing.assert_allclose(
        tpr.compute_ffn_activation_importance(tparams, tcfg, tb),
        jpr.compute_ffn_activation_importance(tiny_params, tiny_cfg, tiny_batches),
        rtol=1e-5, atol=1e-5)
    j_imp, j_base = jpr.copy_replace_attention_importance(tiny_params, tiny_cfg, tiny_batches,
                                                          batch_limit=3, verbose=False)
    t_imp, t_base = tpr.copy_replace_attention_importance(tparams, tcfg, tb, batch_limit=3,
                                                          verbose=False)
    assert t_base == j_base
    np.testing.assert_array_equal(t_imp, j_imp)


def test_two_ssp_prune_vit_identical(tiny_cfg, tiny_params, tiny_batches, capsys):
    tparams = params_from_jax(jax.device_get(tiny_params), device="cpu")
    tcfg = TConfig(**dataclasses.asdict(tiny_cfg))
    tb = _torch_batches(tiny_batches)
    kw = dict(importance_mode="copy", batch_limit=2, min_remaining=32)
    jp, jc, jres = jpr.two_ssp_prune_vit(tiny_params, tiny_cfg, 0.3, calibration_batches=tiny_batches,
                                         eval_batches=tiny_batches, **kw)
    tp, tc, tres = tpr.two_ssp_prune_vit(tparams, tcfg, 0.3, calibration_batches=tb,
                                         eval_batches=tb, **kw)
    capsys.readouterr()
    assert tc == TConfig(**dataclasses.asdict(jc))
    assert dataclasses.asdict(tres.plan) == dataclasses.asdict(jres.plan)
    assert tres.pruned_attention_blocks == jres.pruned_attention_blocks
    for a, b in zip(tres.width.keep_indices, jres.width.keep_indices):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tres.att_importance, jres.att_importance)
    w = np.asarray(jp["blocks"]["fc1_kernel"]).shape[-1]
    np.testing.assert_array_equal(tp["blocks"]["fc1_kernel"].numpy()[..., :w],
                                  np.asarray(jp["blocks"]["fc1_kernel"]))
    np.testing.assert_array_equal(tp["blocks"]["fc2_kernel"].numpy()[:, :w],
                                  np.asarray(jp["blocks"]["fc2_kernel"]))
    np.testing.assert_array_equal(tp["blocks"]["qkv_kernel"].numpy(),
                                  np.asarray(jp["blocks"]["qkv_kernel"]))
