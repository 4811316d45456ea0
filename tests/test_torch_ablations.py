"""The 2SSP ablation suite of the PyTorch port (``ssp_x_vit_tpu_torch/llm/ablations.py``)
against the JAX package on the CPU.

Both packages run their bf16 default, where they round at other places:
perplexities and importances agree to rtol 2e-2 (TOL), and a pruning
decision is compared only where the JAX scores' own margin exceeds 5 * TOL,
as ``tests/test_torch_llm_pruning.py`` does. The tiny llama (hidden 32, 4
layers, f 64) is edited so that the margins exist, with power-of-two scalings
that are exact in binary floating point:

- layer 2's attention output projection is replaced by noise: removing that
  attention block is by far the best second-stage choice;
- per layer, the MLP output columns of the hidden dims with the largest
  output norms are doubled (the inverted variant's ``keep_out``);
- per layer, the post-attention norm scale of the hidden dims with the
  largest MLP input norms is doubled and their gate/up rows halved (the
  function is unchanged; ``keep_in`` gets its margin);
- the up-projection columns of the FFN neurons with the largest importance
  are scaled by 4 (16 for the top 37) and their down rows by 1/4 (1/16): the
  function is unchanged, the stage-1 statistics (L2 and L1) get a margin at
  both keep counts (37 for stage 1 alone, 48 for the L1 two-stage run).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssp_x_vit_tpu.llm import ablations as jabl
from ssp_x_vit_tpu.llm import datasets as jdata
from ssp_x_vit_tpu.llm import evaluation as jeval
from ssp_x_vit_tpu.llm import model as jmodel
from ssp_x_vit_tpu.llm import pruning as jprune
from ssp_x_vit_tpu_torch.llm import ablations as tabl
from ssp_x_vit_tpu_torch.llm import checkpoints as tckpt
from ssp_x_vit_tpu_torch.llm import evaluation as teval
from ssp_x_vit_tpu_torch.llm import model as tmodel

CFG = dict(vocab_size=128, hidden_size=32, num_layers=4, num_heads=4, num_kv_heads=4,
           intermediate_size=64)
SEQ = 64
TOL = 2e-2
MARGIN = 5 * TOL
N_HIDDEN, N_STAGE1, N_L1 = 19, 37, 48   # the keep counts at rate 0.25 for this config


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's tiny tensors: the suite runs six
    workers on the host's cores, where a pool per worker only contends."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(tree):
    jcfg = jmodel.LlamaConfig(**CFG)
    return (jax.tree.map(jnp.asarray, tree), jcfg, tckpt.llm_params_from_jax(tree, device="cpu"),
            tmodel.LlamaConfig(**dataclasses.asdict(jcfg)))


def _top(row, n):
    return np.argsort(-row, kind="stable")[:n]


def _boundary_margin(imp, n):
    ranked = -np.sort(-imp, axis=1)
    return (ranked[:, n - 1] / ranked[:, n] - 1.0).min()


@pytest.fixture(scope="module")
def setup():
    jcfg = jmodel.LlamaConfig(**CFG)
    tree = jax.tree.map(np.array, jmodel.init_llama_params(jax.random.PRNGKey(0), jcfg,
                                                           dtype=jnp.float32))   # writable copies
    blocks = tree["blocks"]
    blocks["o_kernel"][2] = np.random.default_rng(3).normal(
        size=blocks["o_kernel"][2].shape).astype(np.float32)
    stream = jdata.synthetic_token_stream(12 * SEQ, CFG["vocab_size"], seed=0)
    calib = jdata.get_calibration(stream, 4, seq_len=SEQ)
    L = CFG["num_layers"]
    for layer in range(L):      # keep_out: a layer's output norms depend on layers <= it
        _, imp_out = jabl.mlp_io_importance(_both(tree)[0], jcfg, calib)
        blocks["down_kernel"][layer][:, _top(imp_out[layer], N_HIDDEN)] *= 2.0
    imp_in, _ = jabl.mlp_io_importance(_both(tree)[0], jcfg, calib)
    for layer in range(L):
        strong = _top(imp_in[layer], N_HIDDEN)
        blocks["ln2"][layer][strong] *= 2.0
        blocks["gate_kernel"][layer][strong, :] *= 0.5
        blocks["up_kernel"][layer][strong, :] *= 0.5
    imp = jprune.mlp_hidden_importance(_both(tree)[0], jcfg, calib)
    for layer in range(L):
        for n in (N_L1, N_STAGE1):
            strong = _top(imp[layer], n)
            blocks["up_kernel"][layer][:, strong] *= 4.0
            blocks["down_kernel"][layer][strong, :] *= 0.25
    return _both(tree) + (calib, stream[:, :2 * SEQ])


def test_one_stage_keep_sets_and_model_match_jax(setup):
    jp, jc, tp, tc, calib, stream = setup
    imp = jprune.mlp_hidden_importance(jp, jc, calib)
    assert _boundary_margin(imp, N_STAGE1) > MARGIN
    keep, n = tabl.one_stage_keep_indices(tp, tc, calib, 0.25)
    ref_keep, ref_n = jabl.one_stage_keep_indices(jp, jc, calib, 0.25)
    assert n == ref_n == N_STAGE1
    for a, b in zip(keep, ref_keep):
        np.testing.assert_array_equal(a, b)
    p2, c2 = tabl.one_stage_2ssp(tp, tc, calib, 0.25)
    rp, rc = jabl.one_stage_2ssp(jp, jc, calib, 0.25)
    assert dataclasses.asdict(c2) == dataclasses.asdict(rc) and not c2.pruned_attention_blocks
    got = teval.evaluate_perplexity(p2, c2, stream, seq_len=SEQ)
    ref = jeval.evaluate_perplexity(rp, rc, stream, seq_len=SEQ, enable_tqdm=False)
    assert got == pytest.approx(ref, rel=TOL)


def test_inverted_masking_is_exact(setup):
    """Zeroed gate/up rows and down columns where the JAX function zeroes
    them, the other weights untouched; the fp32 forward of the masked model
    equals JAX's (1e-5 of max(1, |logit|))."""
    jp, jc, tp, tc, calib, _ = setup
    rng = np.random.default_rng(0)
    d, L = CFG["hidden_size"], CFG["num_layers"]
    keep_in = [np.sort(rng.permutation(d)[:24]) for _ in range(L)]
    keep_out = [np.sort(rng.permutation(d)[:20]) for _ in range(L)]
    got = tabl.materialize_inverted_mlp_pruning(tp, tc, keep_in, keep_out)
    ref = jabl.materialize_inverted_mlp_pruning(jp, jc, keep_in, keep_out)
    for name in ("gate_kernel", "up_kernel", "down_kernel"):
        np.testing.assert_array_equal(got["blocks"][name].numpy(), np.asarray(ref["blocks"][name]))
    assert got["blocks"]["q_kernel"] is tp["blocks"]["q_kernel"]
    tokens = np.asarray(calib[0])
    logits, _ = tmodel.llama_forward(got, torch.from_numpy(tokens.astype(np.int64)), tc,
                                     compute_dtype=torch.float32)
    want, _ = jmodel.llama_forward(ref, jnp.asarray(tokens), jc, compute_dtype=jnp.float32)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5 * max(1.0, float(np.abs(want).max())))


def test_two_stage_inverted_matches_jax(setup):
    jp, jc, tp, tc, calib, stream = setup
    imp_in, imp_out = jabl.mlp_io_importance(jp, jc, calib)
    assert min(_boundary_margin(imp_in, N_HIDDEN), _boundary_margin(imp_out, N_HIDDEN)) > MARGIN
    got_in, got_out = tabl.mlp_io_importance(tp, tc, calib)
    np.testing.assert_allclose(got_in, imp_in, rtol=TOL)
    np.testing.assert_allclose(got_out, imp_out, rtol=TOL)
    p2, c2, info = tabl.two_stage_2ssp_inverted(tp, tc, calib, 0.25, seq_len=SEQ)
    rp, rc, rinfo = jabl.two_stage_2ssp_inverted(jp, jc, calib, 0.25, seq_len=SEQ)
    assert info["num_preserve_hidden"] == rinfo["num_preserve_hidden"] == N_HIDDEN
    assert info["pruned_attention_blocks"] == rinfo["pruned_attention_blocks"] == [2]
    for key in ("keep_in", "keep_out"):
        for a, b in zip(info[key], rinfo[key]):
            np.testing.assert_array_equal(a, b)
    assert dataclasses.asdict(c2) == dataclasses.asdict(rc)
    got = teval.evaluate_perplexity(p2, c2, stream, seq_len=SEQ)
    ref = jeval.evaluate_perplexity(rp, rc, stream, seq_len=SEQ, enable_tqdm=False)
    assert got == pytest.approx(ref, rel=TOL)


def test_two_stage_l1_matches_jax(setup):
    jp, jc, tp, tc, calib, stream = setup
    p2, c2, info = tabl.two_stage_2ssp_l1_norm(tp, tc, calib, 0.25, seq_len=SEQ)
    rp, rc, rinfo = jabl.two_stage_2ssp_l1_norm(jp, jc, calib, 0.25, seq_len=SEQ)
    imp = tabl._mlp_l1_importance(tp, tc, calib, torch.bfloat16)
    assert _boundary_margin(imp, N_L1) > MARGIN
    assert info["num_preserve"] == rinfo["num_preserve"] == N_L1
    assert info["pruned_attention_blocks"] == rinfo["pruned_attention_blocks"] == [2]
    for a, b in zip(info["keep"], rinfo["keep"]):
        np.testing.assert_array_equal(a, b)
    assert dataclasses.asdict(c2) == dataclasses.asdict(rc)
    got = teval.evaluate_perplexity(p2, c2, stream, seq_len=SEQ)
    ref = jeval.evaluate_perplexity(rp, rc, stream, seq_len=SEQ, enable_tqdm=False)
    assert got == pytest.approx(ref, rel=TOL)
    # a rate the attention budget alone exceeds is refused by both
    assert tabl.two_stage_2ssp_l1_norm(tp, tc, calib, 0.25, 3, seq_len=SEQ) is False
    assert jabl.two_stage_2ssp_l1_norm(jp, jc, calib, 0.25, 3, seq_len=SEQ) is False


def test_balancing_and_calibration_sweeps_match_jax(setup, capsys):
    jp, jc, tp, tc, calib, stream = setup
    got = tabl.ablation_balancing_sparsity_ratio(tp, tc, 0.25, calib, stream, seq_len=SEQ)
    ref = jabl.ablation_balancing_sparsity_ratio(jp, jc, 0.25, calib, stream, seq_len=SEQ)
    assert [r["n_attn"] for r in got] == [r["n_attn"] for r in ref] == [0, 1, 2]
    np.testing.assert_allclose([r["ppl"] for r in got], [r["ppl"] for r in ref], rtol=TOL)
    got = tabl.ablation_calibration_dataset(tp, tc, 0.25, stream, stream, [2], seq_len=SEQ,
                                            method="one_stage_2ssp", seeds=(0, 2))
    ref = jabl.ablation_calibration_dataset(jp, jc, 0.25, stream, stream, [2], seq_len=SEQ,
                                            method="one_stage_2ssp", seeds=(0, 2))
    assert [(r["calibration_size"], r["seed"]) for r in got] == \
        [(r["calibration_size"], r["seed"]) for r in ref] == [(2, 0), (2, 2)]
    np.testing.assert_allclose([r["ppl"] for r in got], [r["ppl"] for r in ref], rtol=TOL)
    printed = capsys.readouterr().out
    assert "When pruning 1 attention submodules @ 0.25, perplexity is" in printed
    assert "Calibration size 2, Seed 2, perplexity" in printed
    with pytest.raises(ValueError, match="use only"):
        tabl.ablation_calibration_dataset(tp, tc, 0.25, stream, stream, [1], seq_len=SEQ,
                                          method="other", seeds=(0,))
