"""LLM evaluation, 2SSP, the depth baselines and quantization of the PyTorch
port against the JAX package on the CPU.

Both packages run their bf16 default here, where they round at other places:
perplexities and importances agree to rtol 2e-2 (TOL). A pruning decision can
only be compared where the reference's own scores are further apart than that:
every decision test asserts that the JAX scores' margin (k-th against k+1-th
importance, best against second-best perplexity, in every round) exceeds
5 * TOL, on models built so that it does: the trained ``ckpts/code_llm_small``
with some blocks replaced by noise (removing them helps a lot), the
activation of the most important FFN neurons doubled (a gap at the keep
boundary) or some blocks made the identity (zero influence).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssp_x_vit_tpu.llm import checkpoints as jckpt
from ssp_x_vit_tpu.llm import evaluation as jeval
from ssp_x_vit_tpu.llm import model as jmodel
from ssp_x_vit_tpu.llm import pruning as jprune
from ssp_x_vit_tpu.llm import quant as jquant
from ssp_x_vit_tpu_torch.llm import checkpoints as tckpt
from ssp_x_vit_tpu_torch.llm import evaluation as teval
from ssp_x_vit_tpu_torch.llm import model as tmodel
from ssp_x_vit_tpu_torch.llm import pruning as tprune
from ssp_x_vit_tpu_torch.llm import quant as tquant

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "ckpts", "code_llm_small")
TOL = 2e-2
MARGIN = 5 * TOL
SEQ = 128


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's tiny tensors: the suite runs six
    workers on the host's cores, where a pool per worker only contends."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trained():
    """(numpy tree in fp32, config kwargs, val tokens) of the committed checkpoint."""
    jparams, jcfg = jckpt.load_llm_model(CKPT)
    tree = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jparams)
    val = np.asarray(np.memmap(os.path.join(CKPT, "corpus_slice", "val.bin"), np.uint16, "r")[:8192],
                     np.int32)
    return tree, dataclasses.asdict(jcfg), val


def both(tree, cfg_kw):
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg_kw.items()}
    return (jax.tree.map(jnp.asarray, tree), jmodel.LlamaConfig(**kw),
            tckpt.llm_params_from_jax(tree, device="cpu"), tmodel.LlamaConfig(**kw))


def edited(tree, edits):
    """A copy of the tree with ``edits[name](stacked leaf)`` applied."""
    blocks = dict(tree["blocks"])
    for name, fn in edits.items():
        blocks[name] = fn(blocks[name].copy())
    return dict(tree, blocks=blocks)


def noise_blocks(name, layers_std, seed):
    """Replace ``name`` of the given layers by N(0, std): a block whose removal helps."""
    def fn(leaf):
        rng = np.random.default_rng(seed)
        for layer, std in layers_std.items():
            leaf[layer] = (std * rng.normal(size=leaf[layer].shape)).astype(np.float32)
        return leaf
    return {name: fn}


def calibration(val, n):
    return [val[i * SEQ:(i + 1) * SEQ].reshape(1, SEQ) for i in range(n)]


def greedy_margins(score_fn, L, rounds):
    """Run a greedy first-minimum search with ``score_fn(mask) -> ppl per
    remaining candidate``; return the choices and, per round, the relative
    margin of the second-best score over the best."""
    mask, picks, margins = [0] * L, [], []
    for _ in range(rounds):
        cands = [c for c in range(L) if not mask[c]]
        ppls = np.asarray(score_fn(mask, cands))
        order = np.argsort(ppls, kind="stable")
        margins.append(ppls[order[1]] / ppls[order[0]] - 1.0)
        mask[cands[order[0]]] = 1
        picks.append(cands[order[0]])
    return picks, margins


def test_count_main_params_matches_jax(trained):
    _, cfg_kw, _ = trained
    variants = [dict(), dict(model_type="phi", qkv_bias=True), dict(model_type="opt", qkv_bias=True),
                dict(qkv_bias=True), dict(pruned_intermediate_size=600),
                dict(pruned_attention_blocks=(1, 4)), dict(explicit_head_dim=32)]
    for extra in variants:
        kw = dict({k: tuple(v) if isinstance(v, list) else v for k, v in cfg_kw.items()}, **extra)
        assert tprune.count_main_params(tmodel.LlamaConfig(**kw)) == \
            jprune.count_main_params(jmodel.LlamaConfig(**kw))


def test_evaluate_perplexity_matches_jax(trained):
    tree, cfg_kw, val = trained
    jp, jc, tp, tc = both(tree, cfg_kw)
    L = tc.num_layers
    ga = np.ones(L, np.float32)
    ga[3] = 0.0
    nm = (np.random.default_rng(0).random((L, tc.intermediate_size)) > 0.2).astype(np.float32)
    for kw in (dict(), dict(batch_size=2), dict(attn_gate=ga, mlp_gate=ga[::-1].copy()),
               dict(neuron_mask=nm)):
        ref = jeval.evaluate_perplexity(jp, jc, val[:4 * SEQ], seq_len=SEQ, enable_tqdm=False, **kw)
        got = teval.evaluate_perplexity(tp, tc, val[:4 * SEQ], seq_len=SEQ, **kw)
        assert got == pytest.approx(ref, rel=TOL), kw
    with pytest.raises(ValueError, match="need at least"):
        teval.evaluate_perplexity(tp, tc, val[:SEQ - 1], seq_len=SEQ)
    suite = teval.evaluation_ppl(tp, tc, val[:SEQ], None, val[SEQ:2 * SEQ], seq_len=SEQ)
    ref = jeval.evaluation_ppl(jp, jc, val[:SEQ], None, val[SEQ:2 * SEQ], seq_len=SEQ)
    assert set(suite) == set(ref) == {"wikitext2", "fineweb-edu"}
    for k in suite:
        assert suite[k] == pytest.approx(ref[k], rel=TOL)
    assert teval.evaluate_inference_time(tp, tc, val[:SEQ], iters=2) > 0.0


def test_evaluate_perplexity_candidates_matches_jax(trained):
    tree, cfg_kw, val = trained
    jp, jc, tp, tc = both(tree, cfg_kw)
    L = tc.num_layers
    rng = np.random.default_rng(1)
    ga = (rng.random((11, L)) > 0.2).astype(np.float32)
    gm = (rng.random((11, L)) > 0.2).astype(np.float32)
    ga[:, 0] = gm[:, 0] = 1.0  # block 0 carries the model: keep the perplexities finite
    ref = jeval.evaluate_perplexity_candidates(jp, jc, val[:2 * SEQ], ga, gm, seq_len=SEQ)
    got = teval.evaluate_perplexity_candidates(tp, tc, val[:2 * SEQ], ga, gm, seq_len=SEQ)
    np.testing.assert_allclose(got, ref, rtol=TOL)
    # chunks of 8 as a batch, or one candidate at a time: the same numbers
    one = teval.evaluate_perplexity_candidates(tp, tc, val[:2 * SEQ], ga, gm, seq_len=SEQ, chunk=1)
    np.testing.assert_allclose(one, got, rtol=1e-3)
    # a candidate row is the gated evaluate_perplexity of that row
    single = teval.evaluate_perplexity(tp, tc, val[:2 * SEQ], seq_len=SEQ, attn_gate=ga[4],
                                       mlp_gate=gm[4])
    assert single == pytest.approx(got[4], rel=1e-3)


def test_mlp_hidden_importance_matches_jax(trained):
    tree, cfg_kw, val = trained
    jp, jc, tp, tc = both(tree, cfg_kw)
    calib = calibration(val, 3)
    ref = jprune.mlp_hidden_importance(jp, jc, calib)
    got = tprune.mlp_hidden_importance(tp, tc, calib)
    assert got.shape == ref.shape == (tc.num_layers, tc.intermediate_size)
    np.testing.assert_allclose(got, ref, rtol=TOL)


def test_two_stage_2ssp_matches_jax(trained):
    """Rate 0.375 with two attention blocks: the kept neurons of every layer
    are the ones whose activation was doubled, the removed attention blocks the two noisy ones."""
    tree, cfg_kw, val = trained
    L, f = cfg_kw["num_layers"], cfg_kw["intermediate_size"]
    calib = calibration(val, 3)
    # the width depends on the config, the rate and the attention count only
    jc = jmodel.LlamaConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in cfg_kw.items()})
    main, attn, mlp = jprune.count_main_params(jc)
    n_keep = int(round(f * (1 - int(round((int(round(0.375 * main)) - 2 * attn) / L)) / mlp)))
    assert 0 < n_keep < f
    noisy = edited(tree, noise_blocks("o_kernel", {3: 1.0, 6: 0.3}, 3))
    base = jprune.mlp_hidden_importance(*both(noisy, cfg_kw)[:2], calib)
    strong = np.stack([np.sort(np.argsort(-base[layer], kind="stable")[:n_keep])
                       for layer in range(L)])

    # doubling a neuron's up column and halving its down row is exact in
    # binary floating point and leaves the block's output as it was, while the
    # down_proj input (what the importance observes) doubles for that neuron
    def double_cols(leaf):
        for layer in range(L):
            leaf[layer][:, strong[layer]] *= 2.0
        return leaf

    def halve_rows(leaf):
        for layer in range(L):
            leaf[layer][strong[layer], :] *= 0.5
        return leaf

    model = edited(noisy, {"up_kernel": double_cols, "down_kernel": halve_rows})
    jp, jc, tp, tc = both(model, cfg_kw)

    imp = jprune.mlp_hidden_importance(jp, jc, calib)
    ranked = -np.sort(-imp, axis=1)
    assert (ranked[:, n_keep - 1] / ranked[:, n_keep] - 1.0).min() > MARGIN

    ref = jprune.two_stage_2ssp(jp, jc, calib, 0.375, seq_len=SEQ, num_attn_submodules_to_prune=2)
    got = tprune.two_stage_2ssp(tp, tc, calib, 0.375, seq_len=SEQ, num_attn_submodules_to_prune=2)
    rp, rc, rinfo = ref
    gp, gc, ginfo = got
    assert ginfo == rinfo and ginfo["num_preserve_mlp"] == n_keep
    assert ginfo["pruned_attention_blocks"] == [3, 6]
    assert dataclasses.asdict(gc) == dataclasses.asdict(rc)
    for k, v in gp["blocks"].items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(rp["blocks"][k]), err_msg=k)

    # the reference's stage-2 margins on the width-pruned model, round by round
    wp, wc = jprune.materialize_llm_width_pruning(jp, jc, list(strong))
    ids = calib[0].reshape(-1)

    def score(mask, cands):
        gates = np.tile(1.0 - np.asarray(mask, np.float32), (len(cands), 1))
        gates[np.arange(len(cands)), cands] = 0.0
        return jeval.evaluate_perplexity_candidates(wp, wc, ids, gates, seq_len=SEQ)

    picks, margins = greedy_margins(score, L, 2)
    assert picks == [3, 6] and min(margins) > MARGIN, (picks, margins)

    # the phase hook names every phase once, in order
    seen = []
    tprune.two_stage_2ssp(tp, tc, calib[:1], 0.375, seq_len=SEQ, num_attn_submodules_to_prune=1,
                          on_phase=seen.append)
    assert seen == ["stats", "stage1", "candidates", "materialize"]
    # unreachable rates return False, as the reference does
    assert tprune.two_stage_2ssp(tp, tc, calib[:1], 0.05, seq_len=SEQ,
                                 num_attn_submodules_to_prune=4) is False
    assert jprune.two_stage_2ssp(jp, jc, calib[:1], 0.05, seq_len=SEQ,
                                 num_attn_submodules_to_prune=4) is False


def test_blockpruner_matches_jax(trained):
    tree, cfg_kw, val = trained
    L = cfg_kw["num_layers"]
    model = edited(tree, {**noise_blocks("o_kernel", {2: 1.0, 5: 0.3}, 4),
                          **noise_blocks("down_kernel", {4: 1.0, 6: 0.3}, 5)})
    jp, jc, tp, tc = both(model, cfg_kw)
    sample = val[:SEQ]
    ref = jprune.blockpruner(jp, jc, 2, sample, seq_len=SEQ)
    got = tprune.blockpruner(tp, tc, 2, sample, seq_len=SEQ)
    assert got == ref == ([0, 0, 1, 0, 0, 1, 0, 0], [0, 0, 0, 0, 1, 0, 1, 0])

    # replay the reference's rounds (attention, MLP, attention, MLP) for their margins
    attn_mask, mlp_mask, margins = [0] * L, [0] * L, []
    for which in ("attn", "mlp", "attn", "mlp"):
        base = attn_mask if which == "attn" else mlp_mask
        cands = [c for c in range(L) if not base[c]]
        ga = np.tile(1.0 - np.asarray(attn_mask, np.float32), (len(cands), 1))
        gm = np.tile(1.0 - np.asarray(mlp_mask, np.float32), (len(cands), 1))
        (ga if which == "attn" else gm)[np.arange(len(cands)), cands] = 0.0
        ppls = np.asarray(jeval.evaluate_perplexity_candidates(jp, jc, sample, ga, gm, seq_len=SEQ))
        order = np.argsort(ppls, kind="stable")
        margins.append(ppls[order[1]] / ppls[order[0]] - 1.0)
        base[cands[order[0]]] = 1
    assert (attn_mask, mlp_mask) == ref and min(margins) > MARGIN, margins


def test_shortgpt_and_window_based_match_jax(trained):
    """Blocks 2-4 made the identity (zero attention output and zero MLP
    output): zero influence, and the window over them has similarity 1."""
    tree, cfg_kw, val = trained
    L = cfg_kw["num_layers"]

    def zero(leaf):
        leaf[2:5] = 0.0
        return leaf

    jp, jc, tp, tc = both(edited(tree, {"o_kernel": zero, "down_kernel": zero}), cfg_kw)
    calib = calibration(val, 3)
    routs = jprune.compute_intermediate_outputs(jp, jc, calib, last_token=True)
    gouts = tprune.compute_intermediate_outputs(tp, tc, calib, last_token=True)
    for r, g in zip(routs, gouts):
        assert g.shape == r.shape == (L, tc.hidden_size)
        assert np.abs(g - r).max() <= TOL * np.abs(r).max()
    full = tprune.compute_intermediate_outputs(tp, tc, calib[:1], last_token=False)[0]
    assert full.shape == (L, SEQ, tc.hidden_size)

    influence = np.array([1.0 - np.mean([jprune._cos(o[i - 1], o[i]) for o in routs]) if i else 1.0
                          for i in range(L)])
    ranked = np.sort(influence)
    assert ranked[3] - ranked[2] > MARGIN * ranked[3]  # 3rd against 4th lowest influence
    expect = [0, 0, 1, 1, 1, 0, 0, 0]
    assert tprune.shortgpt(tp, tc, 3, calib) == jprune.shortgpt(jp, jc, 3, calib) == expect

    sims = np.array([np.mean([jprune._cos(o[i], o[i + 3]) for o in routs]) for i in range(L - 3)])
    ranked = np.sort(1.0 - sims)
    assert ranked[1] - ranked[0] > MARGIN * ranked[1]  # best against second-best window
    assert tprune.window_based(tp, tc, 3, calib) == jprune.window_based(jp, jc, 3, calib) == expect


def test_block_removal_matches_jax(trained):
    tree, cfg_kw, _ = trained
    kw = dict(cfg_kw, sliding_window=32, window_layers=(0, 2, 4, 6))
    jp, jc, tp, tc = both(tree, kw)
    rp, rc = jprune.materialize_llm_block_removal(jp, jc, [2, 5])
    gp, gc = tprune.materialize_llm_block_removal(tp, tc, [5, 2])
    assert dataclasses.asdict(gc) == dataclasses.asdict(rc) and gc.window_layers == (0, 3, 4)
    for k, v in gp["blocks"].items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(rp["blocks"][k]))
    for bad, msg in (([8], "out of range"), (list(range(8)), "every block")):
        with pytest.raises(ValueError, match=msg):
            tprune.materialize_llm_block_removal(tp, tc, bad)
    dp, dc = tprune.materialize_llm_depth_pruning(tp, tc, [1])
    with pytest.raises(ValueError, match="already materialized"):
        tprune.materialize_llm_depth_pruning(dp, dc, [2])
    with pytest.raises(ValueError, match="BEFORE"):
        tprune.materialize_llm_block_removal(dp, dc, [2])


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_trees_equal_leaf_for_leaf(trained, bits):
    tree, cfg_kw, val = trained
    jp, jc, tp, tc = both(tree, cfg_kw)
    jq = (jquant.quantize_llm_params_int8 if bits == 8 else jquant.quantize_llm_params_int4)(jp, jc)
    tq = (tquant.quantize_llm_params_int8 if bits == 8 else tquant.quantize_llm_params_int4)(tp, tc)
    assert set(tq) == set(jq) and set(tq["blocks"]) == set(jq["blocks"])
    for k, v in list(tq["blocks"].items()) + [(k, v) for k, v in tq.items() if k != "blocks"]:
        ref = np.asarray(jq["blocks"][k] if k in jq["blocks"] else jq[k])
        assert v.numpy().dtype == ref.dtype, k
        np.testing.assert_array_equal(v.numpy(), ref, err_msg=k)
    assert tquant.quantized_param_bytes(tq) == jquant.quantized_param_bytes(jq)
    # carried across, the reference's quantized tree is the port's
    carried = tckpt.llm_params_from_jax(jax.tree.map(np.asarray, jq), device="cpu")
    for k, v in carried["blocks"].items():
        assert v.dtype == tq["blocks"][k].dtype and torch.equal(v, tq["blocks"][k]), k
    ref = jeval.evaluate_perplexity(jq, jc, val[:2 * SEQ], seq_len=SEQ, enable_tqdm=False)
    got = teval.evaluate_perplexity(tq, tc, val[:2 * SEQ], seq_len=SEQ)
    assert got == pytest.approx(ref, rel=TOL)


def test_quantize_weight_int8_and_dequantize_match_jax():
    rng = np.random.default_rng(6)
    w = rng.normal(size=(3, 40, 24)).astype(np.float32)
    w[:, :, 5] = 0.0
    w_q, scale = tquant.quantize_weight_int8(torch.from_numpy(w))
    ref_q, ref_s = jquant.quantize_weight_int8(jnp.asarray(w))
    np.testing.assert_array_equal(w_q.numpy(), np.asarray(ref_q))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(ref_s))
    np.testing.assert_array_equal(tquant.dequantize_weight(w_q, scale).numpy(),
                                  np.asarray(jquant.dequantize_weight(ref_q, ref_s)))
    assert np.abs(tquant.dequantize_weight(w_q, scale).numpy() - w).max() <= scale.max().item() / 2 + 1e-7
