"""EvoPress of the PyTorch port (``ssp_x_vit_tpu_torch/llm/evopress.py``)
against the JAX package on the CPU.

A tiny llama (hidden 32, 4 layers, windows of 64 tokens) carried across by
``llm_params_from_jax``. The JAX module runs its forwards in bf16, where the
two frameworks round at other places; for the exact comparisons its module
global ``llama_forward`` is swapped, for the duration of the reference
computations only, for the same function at ``compute_dtype=float32`` (its
jit caches cleared before and after), and the port runs with
``compute_dtype=torch.float32``. Tolerances: fitnesses (token-mean KL) within
1e-5 relative in fp32, with 1e-8 absolute for a divergence near 0 (a sum of
differences of fp32 log-softmaxes that cancel; 1.25e-5 differs by 2.7e-9),
and 2e-2 relative at the bf16 default (the LLM tests' TOL); survivors, masks and the ``random.Random`` state after a search equal;
``collect_samples_with_join`` equal.
"""

import dataclasses
import functools
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssp_x_vit_tpu.llm import datasets as jdata
from ssp_x_vit_tpu.llm import evopress as jevo
from ssp_x_vit_tpu.llm import model as jmodel
from ssp_x_vit_tpu_torch.cli import main_llm as tcli
from ssp_x_vit_tpu_torch.llm import checkpoints as tckpt
from ssp_x_vit_tpu_torch.llm import evopress as tevo
from ssp_x_vit_tpu_torch.llm import model as tmodel

CFG = dict(vocab_size=128, hidden_size=32, num_layers=4, num_heads=4, num_kv_heads=2,
           intermediate_size=64)
SEQ = 64
# 3 offspring: with one block of 4 pruned, drop_entire_block leaves 3 candidates besides
# the population (the search loops until it has its offspring)
ARGS = dict(initially_generated=4, offspring=3, initial_tokens=SEQ,
            tokens_per_selection=(SEQ, 4 * SEQ))
RTOL = 1e-5
ATOL = 1e-8
TOL = 2e-2
MASKS = [([0, 1, 0, 0], [0, 0, 1, 0]), ([1, 0, 0, 0], [1, 0, 0, 0]), ([0, 0, 0, 0], [0, 0, 0, 1])]
F32 = dict(compute_dtype=torch.float32)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's tiny tensors: the suite runs six
    workers on the host's cores, where a pool per worker only contends."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _candidates():
    return [{"attn": list(a), "mlp": list(m)} for a, m in MASKS * 2][:5] + \
        [{"attn": [0, 0, 1, 0], "mlp": [0, 1, 0, 0]}, {"attn": [0, 0, 0, 1], "mlp": [1, 0, 0, 0]}]


@pytest.fixture(scope="module")
def setup():
    jcfg = jmodel.LlamaConfig(**CFG)
    tree = jax.tree.map(np.asarray, jmodel.init_llama_params(jax.random.PRNGKey(0), jcfg,
                                                             dtype=jnp.float32))
    # larger o / down projections: removing a block moves the logits well
    # beyond the frameworks' rounding, so the fitnesses are far apart
    for name in ("o_kernel", "down_kernel"):
        tree["blocks"][name] = tree["blocks"][name] * np.float32(20.0)
    stream = jdata.synthetic_token_stream(8 * SEQ, CFG["vocab_size"], seed=0)
    calib = jdata.get_calibration(stream, 6, seq_len=SEQ)
    return (jax.tree.map(jnp.asarray, tree), jcfg, tckpt.llm_params_from_jax(tree, device="cpu"),
            tmodel.LlamaConfig(**dataclasses.asdict(jcfg)), calib)


def _clear_jax_caches():
    jevo._logits.clear_cache()
    jevo._kl_sum.clear_cache()


@pytest.fixture(scope="module")
def ref(setup):
    """The JAX module's results: fp32 (forward swapped) and bf16 (as it is)."""
    jp, jc, _, _, calib = setup
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jevo, "llama_forward",
                   functools.partial(jmodel.llama_forward, compute_dtype=jnp.float32))
        _clear_jax_caches()
        ones = jnp.ones((CFG["num_layers"],), jnp.float32)
        targets = [np.asarray(jevo._logits(jp, jnp.asarray(c, jnp.int32), ones, ones, jc))
                   for c in calib]
        out["kl"] = [jevo.compute_kl_div(jp, jc, calib[:3], targets[:3], a, m) for a, m in MASKS]
        rng = random.Random(5)
        out["selection"] = jevo.selection(jp, jc, _candidates(), 3, calib, 3 * SEQ, targets, rng)
        out["selection_rng"] = rng.getstate()
        for drop in (False, True):
            out[("evopress", drop)] = jevo.evopress(jp, jc, 1, calib, args=ARGS, seed=3,
                                                    num_generations=2, drop_entire_block=drop,
                                                    verbose=False)
        _clear_jax_caches()
    out["kl_bf16"] = [jevo.compute_kl_div(jp, jc, calib[:3], targets[:3], a, m) for a, m in MASKS]
    _clear_jax_caches()
    return out


def test_collect_samples_with_join_matches_jax():
    rng = np.random.default_rng(0)
    docs = [rng.integers(0, 500, size=int(n)) for n in rng.integers(5, 90, size=40)]
    for n, s, sep in ((6, 64, (198, 198)), (100, 50, ()), (3, 16, (7,))):
        got = tevo.collect_samples_with_join(docs, n, s, separator_ids=sep)
        want = jevo.collect_samples_with_join(docs, n, s, separator_ids=sep)
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            assert a.dtype == b.dtype == np.int32 and a.shape == (1, s)
            np.testing.assert_array_equal(a, b)


def _targets(setup, **kw):
    _, _, tp, tc, calib = setup
    return [tevo._logits(tp, torch.from_numpy(np.asarray(c, np.int64)), None, None, tc, **kw)
            for c in calib]


def test_compute_kl_div_matches_jax(setup, ref):
    _, _, tp, tc, calib = setup
    targets = _targets(setup, **F32)
    got = [tevo.compute_kl_div(tp, tc, calib[:3], targets[:3], a, m, **F32) for a, m in MASKS]
    np.testing.assert_allclose(got, ref["kl"], rtol=RTOL, atol=ATOL)
    assert got[2] > 0.0 and min(got) >= 0.0
    # the dense mask has no divergence; targets in (pinned) host memory or not, the same value
    assert tevo.compute_kl_div(tp, tc, calib[:2], targets[:2], [0] * 4, [0] * 4, **F32) == 0.0
    # the bf16 default, against the JAX module as it is
    bf16 = [tevo.compute_kl_div(tp, tc, calib[:3], targets[:3], a, m) for a, m in MASKS]
    np.testing.assert_allclose(bf16, ref["kl_bf16"], rtol=TOL, atol=ATOL)


def test_selection_matches_jax_and_consumes_the_same_rng(setup, ref):
    _, _, tp, tc, calib = setup
    rng = random.Random(5)
    history = []
    survivors, fits = tevo.selection(tp, tc, _candidates(), 3, calib, 3 * SEQ,
                                     _targets(setup, **F32), rng, history=history, **F32)
    want_survivors, want_fits = ref["selection"]
    assert survivors == want_survivors
    np.testing.assert_allclose(fits, want_fits, rtol=RTOL, atol=ATOL)
    assert rng.getstate() == ref["selection_rng"]
    (rec,) = history
    assert rec["candidates"] == 7 and rec["tokens"] == 3 * SEQ and rec["fitnesses"][:3] == fits
    assert rec["fitnesses"] == sorted(rec["fitnesses"]) and len(rec["fitnesses"]) == 7
    assert len(rec["minibatch_ids"]) == 3 and rec["seconds"] >= 0.0


@pytest.mark.parametrize("drop_entire_block", [False, True])
def test_evopress_end_to_end_matches_jax(setup, ref, drop_entire_block):
    _, _, tp, tc, calib = setup
    history, phases = [], []
    got = tevo.evopress(tp, tc, 1, calib, args=ARGS, seed=3, num_generations=2,
                        drop_entire_block=drop_entire_block, verbose=False,
                        on_phase=phases.append, history=history, **F32)
    assert got == ref[("evopress", drop_entire_block)]
    assert history[0] == {"target_bytes": 6 * SEQ * CFG["vocab_size"] * 4, "target_device": "cpu"}
    # the initial selection, then two per generation
    assert [r["generation"] for r in history[1:]] == [0, 1, 1, 2, 2]
    assert [r["candidates"] for r in history[1:]] == [4, 3, 3, 3, 3]
    assert [r["tokens"] for r in history[1:]] == [SEQ, SEQ, 4 * SEQ, SEQ, 4 * SEQ]
    assert phases == ["targets", "selection", None]


def test_cli_takes_the_windows_there_are_and_selection_warns(setup):
    """The CLI slices ``131072 // seq_len`` windows out of a calibration set
    of 2: it takes those 2, and the selection warns that its budget is
    capped, as the JAX module does (the initial selection only: 64 distinct
    candidates exist for 2 of tiny-random's 6 blocks, not for 1 of 4)."""
    args = tcli.build_argparser().parse_args([
        "--model", "tiny-random", "--backend", "cpu", "--synthetic-data", "--seq-len", "32",
        "--num-calibration", "2", "--pruning_method", "evopress", "--sparsity_rate", "0.3",
        "--evopress-generations", "0", "--logging", "WARNING"])
    with pytest.warns(UserWarning, match="budget capped: requested 2048 tokens but calibration "
                                         "set holds only 64"):
        out = tcli.run(args)
    (entry,) = out["runs"]
    assert entry["target_sparsity"] == pytest.approx(2 / 6)
    assert sum(entry["attn_mask"]) == sum(entry["mlp_mask"]) == 2
    assert entry["evopress"][1]["tokens"] == 64 and entry["evopress"][1]["candidates"] == 64
    _, _, tp, tc, calib = setup
    with pytest.warns(UserWarning, match="budget capped"):
        tevo.selection(tp, tc, _candidates()[:2], 1, calib[:1], 2 * SEQ, _targets(setup, **F32)[:1],
                       random.Random(0))
    with pytest.warns(UserWarning, match="budget capped"):
        jevo.selection(*setup[:2], _candidates()[:2], 1, calib[:1], 2 * SEQ,
                       [np.zeros((1, SEQ, CFG["vocab_size"]), np.float32)], random.Random(0))
