"""The port's training path against the JAX package on the CPU.

Tiny llama-family models (2 layers, hidden 32, 4 query heads over 2 KV heads)
with numpy-seeded weights carried across by ``llm_params_from_jax``, token
batches from numpy seeds, ``compute_dtype=float32`` on both sides:

- ``next_token_loss`` and its gradients against ``jax.value_and_grad``
  (loss rel 1e-6, gradients 1e-6 of max(1, max |grad|): fp32, another
  summation order); the port's remat on and off give the same bits.
- three ``Trainer`` updates (warmup 1, cosine, clip 0.5 that triggers, weight
  decay, b2 0.95, accumulation 2) against the JAX ``Trainer``: the logged
  losses (1e-5 rel), the learning rate of every update (exact to 1e-12), and
  the parameters. Adam divides by sqrt(v) + eps, so a gradient near 0 may
  flip an element's step between the frameworks; the parameters must agree
  within 1e-6 absolute at 99.9% of elements and within 2 * lr * updates
  everywhere.
- the distillation step and a depth- and width-materialized pruned model,
  each two steps with optax's default ``adamw(1e-4)``.
- the optimizer against optax itself on random trees, bf16 moments kept in
  the parameter dtype, and a bit-exact resume from a checkpoint.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ssp_x_vit_tpu.llm import model as jmodel
from ssp_x_vit_tpu.llm import pruning as jprune
from ssp_x_vit_tpu.llm import train as jtrain
from ssp_x_vit_tpu.llm import trainer as jtrainer
from ssp_x_vit_tpu_torch.llm import checkpoints as tckpt
from ssp_x_vit_tpu_torch.llm import model as tmodel
from ssp_x_vit_tpu_torch.llm import pruning as tprune
from ssp_x_vit_tpu_torch.llm import train as ttrain
from ssp_x_vit_tpu_torch.llm import trainer as ttrainer
from ssp_x_vit_tpu_torch.llm.optim import AdamW, tree_leaves

TINY = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2,
            intermediate_size=48)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's tiny tensors: the suite runs six
    workers on the host's cores, where a pool per worker only contends."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_model(seed=0, **overrides):
    """(jax params, jax cfg, torch params, torch cfg): kernels ~ N(0, 0.1),
    norm scales ~ 1 + N(0, 0.1)."""
    kw = dict(TINY, **overrides)
    jcfg, tcfg = jmodel.LlamaConfig(**kw), tmodel.LlamaConfig(**kw)
    shapes = jax.eval_shape(lambda: jmodel.init_llama_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(seed)

    def leaf(name, shape):
        if name.startswith("ln") or name.endswith("_norm"):
            return (1 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        return (0.1 * rng.normal(size=shape)).astype(np.float32)

    tree = {k: ({kk: leaf(kk, vv.shape) for kk, vv in v.items()} if isinstance(v, dict)
                else leaf(k, v.shape)) for k, v in shapes.items()}
    return (jax.tree.map(jnp.asarray, tree), jcfg,
            tckpt.llm_params_from_jax(tree, device="cpu"), tcfg)


def batch(seed, b=4, s=32, vocab=128):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, s + 1)).astype(np.int32)


def jax_leaves(tree):
    return tree_leaves(jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree))


def assert_params_close(got, want, lr, updates):
    diffs = torch.cat([(a - b).abs().flatten() for a, b in zip(tree_leaves(got), jax_leaves(want))])
    assert (diffs <= 1e-6).float().mean().item() >= 0.999
    assert diffs.max().item() <= 2 * lr * updates


def grads_of(step_params, loss_fn):
    tree, leaves = ttrain.trainable_tree(step_params)
    loss = loss_fn(tree)
    loss.backward()
    return loss.detach(), [leaf.grad for leaf in leaves]


def test_next_token_loss_and_grads_match_jax_with_and_without_remat():
    jp, jc, tp, tc = make_model()
    toks = batch(1)
    loss_j, grads_j = jax.value_and_grad(jtrain.next_token_loss)(
        jp, jnp.asarray(toks), jc, compute_dtype=jnp.float32, remat=True)
    runs = {}
    for remat in (True, False):
        runs[remat] = grads_of(tp, lambda tree: ttrain.next_token_loss(
            tree, torch.from_numpy(toks).long(), tc, compute_dtype=torch.float32, remat=remat))
    loss, grads = runs[True]
    assert abs(loss.item() - float(loss_j)) <= 1e-6 * abs(float(loss_j))
    want = jax_leaves(grads_j)
    scale = max(1.0, max(g.abs().max().item() for g in want))
    assert max((a - b).abs().max().item() for a, b in zip(grads, want)) <= 1e-6 * scale
    assert torch.equal(runs[False][0], loss)
    assert all(torch.equal(a, b) for a, b in zip(runs[False][1], grads))


def test_trainer_matches_the_jax_trainer():
    jp, jc, tp, tc = make_model(seed=2)
    kw = dict(learning_rate=1e-3, total_steps=3, warmup_steps=1, schedule="cosine",
              weight_decay=0.01, b2=0.95, grad_clip=0.5, accum_steps=2,
              compute_dtype="float32", log_every=1)
    batches = [batch(10 + i, b=2) for i in range(6)]
    jparams, jhist = jtrainer.Trainer(jc, jtrainer.TrainConfig(**kw)).fit(
        jp, batches, verbose=False)
    tparams, thist = ttrainer.Trainer(tc, ttrainer.TrainConfig(**kw)).fit(
        tp, batches, verbose=False)
    assert tparams is tp  # updated in place
    assert [h["update"] for h in thist] == [h["update"] for h in jhist] == [1, 2, 3]
    for t, j in zip(thist, jhist):
        assert abs(t["loss"] - j["loss"]) <= 1e-5 * abs(j["loss"])
        assert abs(t["lr"] - j["lr"]) <= 1e-12
        assert t["tokens_seen"] == j["tokens_seen"]
    jsched = jtrainer.make_schedule(jtrainer.TrainConfig(**kw))
    tsched = ttrainer.make_schedule(ttrainer.TrainConfig(**kw))
    assert [tsched(n) for n in range(5)] == pytest.approx([float(jsched(n)) for n in range(5)],
                                                          abs=1e-10)
    assert_params_close(tparams, jparams, 1e-3, 3)


def test_distill_and_pruned_steps_match_jax():
    """Two KD steps (dense teacher, width-materialized student) and two CE steps
    of a depth- and width-materialized model, each against the JAX step."""
    keep = [list(range(0, 48, 2))] * 2

    def pruned(depth):
        # fresh trees per run: JAX donates the student's buffers, and the
        # pruned models share their unpruned leaves with the dense one
        jt, jtc, tt, ttc = make_model(seed=3)
        js, jsc = jprune.materialize_llm_width_pruning(jt, jtc, keep)
        ts, tsc = tprune.materialize_llm_width_pruning(tt, ttc, keep)
        if depth:
            js, jsc = jprune.materialize_llm_depth_pruning(js, jsc, [1])
            ts, tsc = tprune.materialize_llm_depth_pruning(ts, tsc, [1])
        return jt, jtc, tt, ttc, js, jsc, ts, tsc

    jt, jtc, tt, ttc, js, jsc, ts, tsc = pruned(False)
    teacher = {k: v.clone() for k, v in tt.items() if not isinstance(v, dict)}
    _, _, _, _, jd, jdc, td, tdc = pruned(True)
    runs = [
        (functools.partial(jtrain.make_distill_train_step, jt, jtc, jsc, alpha=0.3),
         functools.partial(ttrain.make_distill_train_step, tt, ttc, tsc, alpha=0.3), js, ts),
        (functools.partial(jtrain.make_llama_train_step, jdc),
         functools.partial(ttrain.make_llama_train_step, tdc), jd, td),
    ]
    for jfactory, tfactory, jparams, tparams in runs:
        jstep = jfactory(compute_dtype=jnp.float32)
        tstep = tfactory(compute_dtype=torch.float32)
        jstate = optax.adamw(1e-4).init(jparams)
        tstate = AdamW(1e-4).init(tparams)
        for i in range(2):
            toks = batch(20 + i)
            jparams, jstate, jloss = jstep(jparams, jstate, jnp.asarray(toks))
            tparams, tstate, tloss = tstep(tparams, tstate, toks)
            assert abs(tloss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
        assert_params_close(tparams, jparams, 1e-4, 2)
    # the student shared the teacher's embeddings, norms and head: the teacher is untouched
    assert all(torch.equal(tt[k], v) for k, v in teacher.items())


@pytest.mark.parametrize("accum", [1, 3])
def test_optimizer_matches_optax(accum):
    """AdamW against optax's chain on random fp32 trees: clipping that triggers
    and that does not, warmup (lr 0 on the first update), accumulation."""
    rng = np.random.default_rng(5)
    tree = {"embed": rng.normal(size=(6, 4)), "blocks": {"w": rng.normal(size=(3, 4, 5))}}
    tree = jax.tree.map(lambda a: a.astype(np.float32), tree)
    sched = optax.join_schedules([optax.linear_schedule(0.0, 1e-2, 1),
                                  optax.cosine_decay_schedule(1e-2, 4, alpha=0.1)], [1])
    jopt = optax.chain(optax.clip_by_global_norm(3.0),
                       optax.adamw(sched, b1=0.8, b2=0.95, weight_decay=0.1))
    if accum > 1:
        jopt = optax.MultiSteps(jopt, every_k_schedule=accum)
    topt = AdamW(lambda n: float(sched(n)), b1=0.8, b2=0.95, weight_decay=0.1, grad_clip=3.0,
                 accum_steps=accum)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jopt.init(jparams)
    jupdate = jax.jit(jopt.update)
    tparams = jax.tree.map(torch.from_numpy, tree)
    tstate = topt.init(tparams)
    for i in range(4 * accum):
        scale = 0.1 if i % 2 else 3.0  # the clip triggers on every other microbatch
        grads = jax.tree.map(lambda a: (scale * rng.normal(size=a.shape)).astype(np.float32), tree)
        updates, jstate = jupdate(jax.tree.map(jnp.asarray, grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        applied = topt.apply(tparams, tree_leaves(jax.tree.map(torch.from_numpy, grads)), tstate)
        assert applied == ((i + 1) % accum == 0)
    assert tstate["count"] == 4
    for a, b in zip(tree_leaves(tparams), jax_leaves(jparams)):
        assert (a - b).abs().max().item() <= 1e-6


def test_bf16_moments_stay_in_the_param_dtype():
    params = {"embed": torch.randn(8, 4).bfloat16(), "blocks": {"w": torch.randn(2, 4, 3).bfloat16()}}
    opt = AdamW(1e-3, accum_steps=2)
    state = opt.init(params)
    for leaf in tree_leaves(state["mu"]) + tree_leaves(state["nu"]) + tree_leaves(state["acc"]):
        assert leaf.dtype == torch.bfloat16
    grads = [torch.ones_like(p) for p in tree_leaves(params)]
    before = [p.clone() for p in tree_leaves(params)]
    assert not opt.apply(params, grads, state)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params), before))
    assert opt.apply(params, grads, state)
    assert all(not torch.equal(a, b) for a, b in zip(tree_leaves(params), before))
    assert all(p.dtype == torch.bfloat16 for p in tree_leaves(params))


class _Killed(Exception):
    pass


def test_resume_from_a_checkpoint_is_bit_exact(tmp_path):
    """Four updates with a checkpoint every two; a run killed after its third
    microbatch pair resumes from update 2 and ends bit-identical to the
    uninterrupted run, optimizer state included."""
    _, _, params, cfg = make_model(seed=4)
    batches = [batch(30 + i, b=2) for i in range(4)]
    kw = dict(learning_rate=1e-3, total_steps=4, warmup_steps=1, compute_dtype="float32",
              checkpoint_every=2, log_every=1)

    def clone(tree):
        return {k: clone(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}

    whole = clone(params)
    tc = ttrainer.TrainConfig(checkpoint_dir=str(tmp_path / "a"), **kw)
    ttrainer.Trainer(cfg, tc).fit(whole, batches, verbose=False)

    def dies_after_three():
        yield from batches[:3]
        raise _Killed

    tc = ttrainer.TrainConfig(checkpoint_dir=str(tmp_path / "b"), **kw)
    killed = clone(params)
    with pytest.raises(_Killed):
        ttrainer.Trainer(cfg, tc).fit(killed, dies_after_three(), verbose=False)
    assert sorted(p.name for p in (tmp_path / "b").iterdir()) == ["step_2.pt"]
    resumed = clone(params)
    _, hist = ttrainer.Trainer(cfg, tc).fit(resumed, batches, verbose=False)
    assert [h["update"] for h in hist] == [3, 4]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(resumed), tree_leaves(whole)))
    a = torch.load(tmp_path / "a" / "step_4.pt", weights_only=True)
    b = torch.load(tmp_path / "b" / "step_4.pt", weights_only=True)
    assert a["update"] == b["update"] == 4
    for key in ("mu", "nu"):
        assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a["opt_state"][key]),
                                                     tree_leaves(b["opt_state"][key])))


def test_unported_configs_name_the_roadmap_item():
    """MoE configs (once refused naming ROADMAP.md A.11c) train: the loss of a
    top-2 MoE model, load-balance term included, and its gradients match the
    JAX package's; a config of neither family is refused as a TypeError."""
    jp, jc, tp, tc = make_model(seed=5, num_experts=4, moe_top_k=2, router_aux_coef=0.5)
    toks = batch(6)
    loss_j, grads_j = jax.value_and_grad(jtrain.next_token_loss)(
        jp, jnp.asarray(toks), jc, compute_dtype=jnp.float32, remat=True)
    loss, grads = grads_of(tp, lambda tree: ttrain.next_token_loss(
        tree, torch.from_numpy(toks).long(), tc, compute_dtype=torch.float32, remat=True))
    assert abs(loss.item() - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    want = jax_leaves(grads_j)
    scale = max(1.0, max(g.abs().max().item() for g in want))
    assert max((a - b).abs().max().item() for a, b in zip(grads, want)) <= 1e-4 * scale
    with pytest.raises(TypeError, match="LlamaConfig"):
        ttrain.next_token_loss(tp, torch.zeros(1, 4, dtype=torch.long), object())
