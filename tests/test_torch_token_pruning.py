"""The port's token pruning (``models/token_pruning.py``) and
``evaluate_top1(..., token_keep_schedule=...)`` against the JAX package's on
the CPU, fp32, on the tiny config (s = 17): dense, width-materialized and int8
trees, with JAX's weights carried across and numpy-seeded inputs.

Tolerances: scores and logits 1e-5 absolute (the same fp32 ops in another
summation order); the pruned token sequences, where the kept set is the same,
1e-6. Tied scores must keep JAX's set and order (``lax.top_k`` takes the lower
index first).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssp_x_vit_tpu.evaluation.classify import evaluate_top1 as jevaluate_top1
from ssp_x_vit_tpu.models import token_pruning as jtp
from ssp_x_vit_tpu.models import vit as jvit
from ssp_x_vit_tpu.pruning import materialize_depth_pruning as jdepth
from ssp_x_vit_tpu.pruning import materialize_width_pruning as jwidth
from ssp_x_vit_tpu_torch.evaluation.classify import evaluate_top1
from ssp_x_vit_tpu_torch.models import token_pruning as ttp
from ssp_x_vit_tpu_torch.models import vit as tvit
from ssp_x_vit_tpu_torch.models.checkpoints import params_from_jax
from ssp_x_vit_tpu_torch.models.quant import quantize_vit_params_int8 as tquantize
from ssp_x_vit_tpu_torch.pruning import materialize_depth_pruning as tdepth
from ssp_x_vit_tpu_torch.pruning import materialize_width_pruning as twidth

SCHEDULES = {"dense": [((1, 12),), ((0, 14), (2, 9), (3, 4)), ((3, 2),)],
             "width": [((0, 14), (2, 9), (3, 4))], "int8": [((1, 6), (2, 3))]}
# one compiled program per (tree, schedule): eager JAX dispatch is slow here
_jax_forward = jax.jit(jtp.vit_forward_token_pruned, static_argnames=("cfg", "keep_schedule"))
_jax_embed = jax.jit(jvit.embed, static_argnums=(1, 3))
_jax_scores = jax.jit(jtp.cls_attention_scores, static_argnums=2)
_jax_prune = jax.jit(jtp.prune_tokens, static_argnums=2)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's tiny tensors: the suite runs six
    workers on the host's cores, where a pool per worker only contends."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tcfg(jcfg):
    return tvit.ViTConfig(**dataclasses.asdict(jcfg))


def _pixels(cfg, n, seed):
    return np.random.default_rng(seed).normal(
        size=(n, cfg.image_size, cfg.image_size, 3)).astype(np.float32)


_TREES = {}


def _trees(kind, jcfg, jparams):
    """(jax params, jax cfg, port params, port cfg) of one tree kind, made once
    per module (JAX's eager int8 quantizer takes seconds here)."""
    if kind not in _TREES:
        _TREES[kind] = _make_trees(kind, jcfg, jparams)
    return _TREES[kind]


def _make_trees(kind, jcfg, jparams):
    tparams = params_from_jax(jax.device_get(jparams), device="cpu")
    tcfg = _tcfg(jcfg)
    if kind == "width":
        rng = np.random.default_rng(7)
        keep = [np.sort(rng.choice(jcfg.intermediate_size, n, replace=False))
                for n in (100, 128, 77, 90)]
        jp, jc = jwidth(jparams, jcfg, keep)
        tp, tc = twidth(tparams, tcfg, keep)
        return jp, jc, tp, tc
    if kind == "int8":
        # the port's quantizer is JAX's bit for bit (tests/test_torch_vit_quant_adapter.py),
        # and JAX's eager one takes seconds here: JAX gets the port's codes and scales
        tq = tquantize(tparams, tcfg)
        return jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), tq), jcfg, tq, tcfg
    return jparams, jcfg, tparams, tcfg


@pytest.mark.parametrize("kind", ["dense", "int8"])
def test_cls_attention_scores_match_jax(tiny_cfg, tiny_params, kind):
    jp, jc, tp, tc = _trees(kind, tiny_cfg, tiny_params)
    px = _pixels(tiny_cfg, 3, 0)
    jx = _jax_embed(jp, jc, jnp.asarray(px), jnp.float32)
    tx = tvit.embed(tp, tc, torch.from_numpy(px), torch.float32)
    for i in (0, 2):
        jbp = {k: v[i] for k, v in jp["blocks"].items()}
        tbp = {k: v[i] for k, v in tp["blocks"].items()}
        want = np.asarray(_jax_scores(jx, jbp, jc))
        got = ttp.cls_attention_scores(tx, tbp, tc).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got.sum(axis=1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("keep", [2, 5, 16])
def test_prune_tokens_matches_jax(keep):
    rng = np.random.default_rng(keep)
    x = rng.normal(size=(3, 17, 8)).astype(np.float32)
    scores = rng.uniform(0.01, 1.0, size=(3, 17)).astype(np.float32)
    want = np.asarray(_jax_prune(jnp.asarray(x), jnp.asarray(scores), keep))
    got = ttp.prune_tokens(torch.from_numpy(x), torch.from_numpy(scores), keep).numpy()
    assert got.shape == want.shape == (3, keep, 8)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_prune_tokens_keeps_jax_order_on_tied_scores():
    """Scores from 3 distinct values (bf16 scores tie like this on the card):
    the kept patches and their order are lax.top_k's, the lower index first."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(4, 17, 8)).astype(np.float32)
    scores = rng.choice(np.float32([0.25, 0.5, 0.75]), size=(4, 17))
    for keep in (4, 9, 13):
        _, jtop = jax.lax.top_k(jnp.asarray(scores[:, 1:]), keep - 2)
        np.testing.assert_array_equal(
            ttp.top_k_indices(torch.from_numpy(scores[:, 1:]), keep - 2).numpy(), np.asarray(jtop))
        want = np.asarray(_jax_prune(jnp.asarray(x), jnp.asarray(scores), keep))
        got = ttp.prune_tokens(torch.from_numpy(x), torch.from_numpy(scores), keep).numpy()
        np.testing.assert_array_equal(got[:, :-1], want[:, :-1])   # CLS and the kept rows
        np.testing.assert_allclose(got[:, -1], want[:, -1], rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind,schedule", [(k, s) for k, v in SCHEDULES.items() for s in v])
def test_vit_forward_token_pruned_matches_jax(tiny_cfg, tiny_params, kind, schedule):
    jp, jc, tp, tc = _trees(kind, tiny_cfg, tiny_params)
    px = _pixels(tiny_cfg, 4, 1)
    want = np.asarray(_jax_forward(jp, jnp.asarray(px), cfg=jc, keep_schedule=schedule))
    got = ttp.vit_forward_token_pruned(tp, torch.from_numpy(px), tc, schedule).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_empty_schedule_is_vit_forward(tiny_cfg, tiny_params):
    _, _, tp, tc = _trees("dense", tiny_cfg, tiny_params)
    px = torch.from_numpy(_pixels(tiny_cfg, 2, 2))
    ref, _ = tvit.vit_forward(tp, px, tc)
    assert torch.equal(ttp.vit_forward_token_pruned(tp, px, tc, ()), ref)


def test_token_pruning_raises_as_jax(tiny_cfg, tiny_params):
    jp, jc, tp, tc = _trees("dense", tiny_cfg, tiny_params)
    x = torch.zeros(1, 17, 8)
    for keep in (1, 17):
        with pytest.raises(ValueError, match="must be in"):
            ttp.prune_tokens(x, torch.ones(1, 17), keep)
        with pytest.raises(ValueError, match="must be in"):
            jtp.prune_tokens(jnp.zeros((1, 17, 8)), jnp.ones((1, 17)), keep)
    px = _pixels(tiny_cfg, 1, 3)
    with pytest.raises(ValueError, match="duplicate"):
        ttp.vit_forward_token_pruned(tp, torch.from_numpy(px), tc, ((1, 8), (1, 6)))
    with pytest.raises(ValueError, match="duplicate"):
        jtp.vit_forward_token_pruned(jp, jnp.asarray(px), jc, ((1, 8), (1, 6)))
    dp, dc = tdepth(tp, tc, [1])
    with pytest.raises(ValueError, match="depth-materialized"):
        ttp.vit_forward_token_pruned(dp, torch.from_numpy(px), dc, ((2, 8),))
    jdp, jdc = jdepth(jp, jc, [1])
    with pytest.raises(ValueError, match="depth-materialized"):
        jtp.vit_forward_token_pruned(jdp, jnp.asarray(px), jdc, ((2, 8),))


def test_evaluate_top1_with_a_schedule_matches_jax(tiny_cfg, tiny_params, tiny_batches):
    jp, jc, tp, tc = _trees("dense", tiny_cfg, tiny_params)
    batches = tiny_batches[:2]
    tb = [{"pixel_values": torch.tensor(np.asarray(b["pixel_values"])),
           "labels": torch.tensor(np.asarray(b["labels"]))} for b in batches]
    for sched in ((), ((1, 8), (3, 5))):
        assert evaluate_top1(tp, tc, tb, token_keep_schedule=sched) == \
            jevaluate_top1(jp, jc, batches, token_keep_schedule=sched)
