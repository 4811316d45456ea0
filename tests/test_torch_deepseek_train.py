"""Training the port's DeepSeek/MLA family (``llm/train.py`` over
``llm/deepseek.py``) against the JAX package on the CPU, mirroring
``tests/test_deepseek_train.py``.

Tiny configs (3 layers: 1 dense + 2 MoE with grouped sigmoid routing, shared
experts and routed scaling; the all-dense variant for the ``Trainer``) with
numpy-seeded weights in the JAX layout, small nonzero e_score_correction
biases, token batches from numpy seeds, fp32 on both sides:

- ``next_token_loss`` and its gradients against ``jax.value_and_grad`` (loss
  1e-5 relative, gradients 1e-4 of max(1, max |grad|)); remat on and off give
  the same bits; ``e_bias`` gets no gradient.
- three AdamW updates (weight decay 0.1) against optax's: the losses (1e-5
  relative), and every ``e_bias`` bit for bit unchanged in both packages.
- a pruned (attention-materialized) model's recovery steps, the distillation
  step with a DeepSeek teacher into a pruned DeepSeek student, and a llama
  student of a DeepSeek teacher's vocabulary: losses against JAX's.
- the ``Trainer`` loop (warmup, accumulation 2) against the JAX ``Trainer``,
  and ``train_llm`` on ``tiny-random-deepseek``: finite losses, ``e_bias``
  unchanged, a resumed run bit for bit an uninterrupted one.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ssp_x_vit_tpu.llm import deepseek as J
from ssp_x_vit_tpu.llm import pruning_deepseek as JPD
from ssp_x_vit_tpu.llm import train as jtrain
from ssp_x_vit_tpu.llm import trainer as jtrainer
from ssp_x_vit_tpu_torch.cli import train_llm as tcli
from ssp_x_vit_tpu_torch.llm import deepseek as T
from ssp_x_vit_tpu_torch.llm import pruning_deepseek as TPD
from ssp_x_vit_tpu_torch.llm import train as ttrain
from ssp_x_vit_tpu_torch.llm import trainer as ttrainer
from ssp_x_vit_tpu_torch.llm.checkpoints import deepseek_params_from_jax
from ssp_x_vit_tpu_torch.llm.optim import AdamW

BASE = dict(vocab_size=64, hidden_size=32, num_layers=3, num_heads=4, q_lora_rank=16,
            kv_lora_rank=16, qk_nope_head_dim=8, qk_rope_head_dim=4, v_head_dim=8,
            intermediate_size=48, moe_intermediate_size=16, n_routed_experts=4,
            n_shared_experts=1, num_experts_per_tok=2, n_group=2, topk_group=1,
            routed_scaling_factor=1.5, first_k_dense_replace=1)
DENSE = dict(n_routed_experts=0, n_shared_experts=0, first_k_dense_replace=3)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's tiny tensors: the suite runs six
    workers on the host's cores, where a pool per worker only contends."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make(seed=0, **over):
    """(JAX params, JAX cfg, port params, port cfg): kernels ~ N(0, 0.1), norms
    at one, e_bias ~ U(-0.05, 0.05)."""
    kw = dict(BASE, **over)
    jcfg, tcfg = J.DeepseekConfig(**kw), T.DeepseekConfig(**kw)
    rng = np.random.default_rng(seed)

    def fill(name, t):
        if isinstance(t, dict):
            return {k: fill(k, v) for k, v in t.items()}
        if name.startswith("ln") or name.endswith("norm"):
            return np.ones(tuple(t.shape), np.float32)
        if name == "e_bias":
            return rng.uniform(-0.05, 0.05, tuple(t.shape)).astype(np.float32)
        return (rng.standard_normal(tuple(t.shape)) * 0.1).astype(np.float32)

    tree = {k: fill(k, v) for k, v in T.init_deepseek_params(None, tcfg, device="cpu").items()}
    return (jax.tree.map(jnp.asarray, tree), jcfg, deepseek_params_from_jax(tree, device="cpu"),
            tcfg)


def batch(seed, vocab=64, b=2, s=16):
    return np.random.default_rng(seed).integers(0, vocab, (b, s + 1)).astype(np.int32)


def by_path(tree, prefix=""):
    """{path: leaf} of a tree's tensor (or array) leaves; per-layer lists are left out."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(by_path(v, f"{prefix}{k}/"))
        elif not isinstance(v, list):
            out[prefix + k] = v
    return out


def port_grads(params, loss_fn):
    """(loss, {path: stacked gradient}) of ``loss_fn(tree)`` over the train tree."""
    tree, _ = ttrain.trainable_tree(params)
    loss = loss_fn(tree)
    loss.backward()
    grads = {}
    for path, leaf in by_path(tree).items():
        grads[path] = leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)
    for group in ("dense_blocks", "moe_blocks"):
        for k, layers in tree.get(group, {}).items():
            grads[f"{group}/{k}"] = torch.stack([
                g.grad if g.grad is not None else torch.zeros_like(g) for g in layers])
    return loss.detach(), grads


def assert_grads_close(got, want):
    want = {k: np.asarray(v) for k, v in by_path(want).items()}
    scale = max(1.0, max(np.abs(v).max() for v in want.values()))
    for k, v in want.items():
        err = np.abs(got[k].numpy() - v).max()
        assert err <= 1e-4 * scale, (k, err)


def test_loss_and_gradients_match_jax_and_remat_changes_nothing():
    jp, jc, tp, tc = make(seed=1)
    toks = batch(1)
    loss_j, grads_j = jax.value_and_grad(jtrain.next_token_loss)(
        jp, jnp.asarray(toks), jc, compute_dtype=jnp.float32, remat=True)
    runs = {remat: port_grads(tp, lambda tree: ttrain.next_token_loss(
        tree, torch.from_numpy(toks).long(), tc, compute_dtype=torch.float32, remat=remat))
        for remat in (True, False)}
    loss, grads = runs[True]
    assert abs(loss.item() - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    assert_grads_close(grads, grads_j)
    assert not grads["moe_blocks/e_bias"].any()
    assert torch.equal(runs[False][0], loss)
    assert all(torch.equal(runs[False][1][k], v) for k, v in grads.items())


def run_steps(jp, jc, tp, tc, toks, n, lr=1e-3, wd=0.1, step_j=None, step_t=None):
    opt_j = optax.adamw(lr, weight_decay=wd)
    step_j = step_j or jtrain.make_llama_train_step(jc, opt_j, compute_dtype=jnp.float32)
    opt_t = AdamW(lr, weight_decay=wd)
    step_t = step_t or (lambda o: ttrain.make_llama_train_step(tc, o, compute_dtype=torch.float32))
    step_t = step_t(opt_t)
    js, ts = opt_j.init(jp), opt_t.init(tp)
    losses = []
    for _ in range(n):
        jp, js, jl = step_j(jp, js, jnp.asarray(toks))
        tp, ts, tl = step_t(tp, ts, toks)
        losses.append((float(tl), float(jl)))
    for tl, jl in losses:
        assert abs(tl - jl) <= 1e-5 * abs(jl), losses
    return jp, tp, losses


def test_three_updates_match_optax_and_e_bias_stays_frozen():
    jp, jc, tp, tc = make(seed=2)
    bias = tp["moe_blocks"]["e_bias"].clone()
    jbias = np.asarray(jp["moe_blocks"]["e_bias"]).copy()
    jp, tp, losses = run_steps(jp, jc, tp, tc, batch(2), 3)
    assert losses[-1][0] < losses[0][0]
    assert torch.equal(tp["moe_blocks"]["e_bias"], bias)
    np.testing.assert_array_equal(np.asarray(jp["moe_blocks"]["e_bias"]), jbias)
    assert not torch.equal(tp["moe_blocks"]["router"], make(seed=2)[2]["moe_blocks"]["router"])
    assert ttrain.frozen_leaves(tp, tc).count(True) == 2   # one e_bias per MoE layer


def test_pruned_recovery_steps_match_jax():
    jp, jc, tp, tc = make(seed=3)
    jpp, jpc = JPD.materialize_deepseek_attention_pruning(jp, jc, [1])
    tpp, tpc = TPD.materialize_deepseek_attention_pruning(tp, tc, [1])
    assert tpc.pruned_attention_blocks == (1,)
    tpp = {k: ({kk: vv.clone() for kk, vv in v.items()} if isinstance(v, dict) else v.clone())
           for k, v in tpp.items()}
    run_steps(jpp, jpc, tpp, tpc, batch(3), 2)
    out = T.deepseek_generate(tpp, tpc, np.asarray([3, 1, 4], np.int32), max_new_tokens=4,
                              compute_dtype=torch.float32)
    assert np.asarray(out).shape == (7,)


def test_distillation_with_a_deepseek_teacher_matches_jax():
    jp, jc, tp, tc = make(seed=4)
    jsp, jsc = JPD.materialize_deepseek_attention_pruning(jp, jc, [2])
    tsp, tsc = TPD.materialize_deepseek_attention_pruning(tp, tc, [2])
    opt_j = optax.adamw(1e-3)
    step_j = jtrain.make_distill_train_step(jp, jc, jsc, opt_j, compute_dtype=jnp.float32)
    teacher_bias = tp["moe_blocks"]["e_bias"].clone()
    run_steps(jsp, jsc, tsp, tsc, batch(4), 2, wd=1e-4, step_j=step_j,
              step_t=lambda o: ttrain.make_distill_train_step(tp, tc, tsc, o,
                                                              compute_dtype=torch.float32))
    assert torch.equal(tp["moe_blocks"]["e_bias"], teacher_bias)


def test_trainer_loop_matches_the_jax_trainer():
    jp, jc, tp, tc = make(seed=5, **DENSE)
    kw = dict(total_steps=3, accum_steps=2, learning_rate=1e-3, warmup_steps=1,
              compute_dtype="float32", log_every=1)
    batches = [batch(50 + i) for i in range(6)]
    _, jhist = jtrainer.Trainer(jc, jtrainer.TrainConfig(**kw)).fit(jp, batches, verbose=False)
    tparams, thist = ttrainer.Trainer(tc, ttrainer.TrainConfig(**kw)).fit(tp, batches,
                                                                          verbose=False)
    assert tparams is tp and [h["update"] for h in thist] == [h["update"] for h in jhist]
    for t, j in zip(thist, jhist):
        assert abs(t["loss"] - j["loss"]) <= 1e-5 * abs(j["loss"])


def test_train_llm_on_tiny_random_deepseek(tmp_path):
    argv = ["--model", "tiny-random-deepseek", "--backend", "cpu", "--steps", "3",
            "--batch-size", "1", "--seq-len", "16", "--log-every", "1", "--synthetic-data",
            "--compute-dtype", "float32", "--accum", "2", "--schedule", "constant"]
    args = tcli.build_argparser().parse_args(argv)
    before = tcli._load_any("tiny-random-deepseek", 0, torch.device("cpu"))[0]
    out = tcli.run(args)
    assert isinstance(out["cfg"], T.DeepseekConfig) and out["cfg"].n_routed_experts > 0
    assert [h["update"] for h in out["history"]] == [1, 2, 3]
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    assert torch.equal(out["params"]["moe_blocks"]["e_bias"], before["moe_blocks"]["e_bias"])
    assert not torch.equal(out["params"]["moe_blocks"]["router"], before["moe_blocks"]["router"])
    # two updates, then a run resumed from their checkpoint, is the three-update run
    ck = ["--checkpoint-dir", str(tmp_path / "ck"), "--checkpoint-every", "1"]
    tcli.run(tcli.build_argparser().parse_args([*argv[:5], "2", *argv[6:], *ck]))
    resumed = tcli.run(tcli.build_argparser().parse_args(argv + ck))
    for k, v in out["params"]["moe_blocks"].items():
        assert torch.equal(resumed["params"]["moe_blocks"][k], v), k
    dense = tcli.run(tcli.build_argparser().parse_args(
        ["--model", "tiny-random-deepseek-dense", "--teacher", "tiny-random-deepseek",
         *argv[2:]]))
    assert all(np.isfinite(h["loss"]) for h in dense["history"])
