"""The port's pipeline (``parallel/pipeline.py``) against the JAX package.

The port runs in one gloo world of 4 CPU processes (``torch_parallel_workers``)
on the (1, 2, 2) and (1, 4, 1) ``(data, pipe, model)`` meshes; JAX runs on a
(2, 2, 2) mesh of the conftest's virtual devices. Everything is fp32.

- ``pipeline_block_specs`` equals JAX's for llama (qkv bias), phi and gemma-2;
- the GPipe forward's logits of llama, phi and gemma-2 (mixed windows, tied
  head, softcaps) within 1e-4 of JAX's ``make_pipeline_forward``;
- the GPipe gradients (``step.grads``) within atol 5e-5 / rtol 5e-4 of JAX's
  single-device gradients of the same loss (JAX's own tolerance), each rank's
  stage and ``model`` cut;
- one GPipe and one 1F1B AdamW step (M = 4) against JAX's
  ``make_pipeline_train_step(schedule=...)`` and its single-device
  ``make_llama_train_step``: the loss within rtol 1e-5, every rank's
  parameters within rtol 1e-4 / atol 1e-5 (AdamW's eps at 1e-3, so the
  first update is no sign of tiny gradients);
- 1F1B never holds more than 2P - 1 saved stage inputs (M = 8 over P = 4);
- the refusals (layers, heads, KV heads, intermediate over the axes, OPT,
  MoE, a batch that M does not divide, an unknown schedule) with JAX's
  messages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_parallel_workers import run_world

from ssp_x_vit_tpu.llm import model as jmodel
from ssp_x_vit_tpu.llm import train as jtrain
from ssp_x_vit_tpu.parallel import pipeline as jpipe
from ssp_x_vit_tpu_torch.llm import checkpoints as tckpt
from ssp_x_vit_tpu_torch.llm import model as tmodel
from ssp_x_vit_tpu_torch.parallel import llm_sharding as tshard
from ssp_x_vit_tpu_torch.parallel import pipeline as tpipe

BASE = dict(vocab_size=64, hidden_size=32, num_layers=4, num_heads=4, num_kv_heads=4,
            intermediate_size=64)
CASES = {
    "llama": dict(qkv_bias=True, num_kv_heads=2),
    "phi": dict(model_type="phi", qkv_bias=True, rotary_dim=4),
    "gemma2": dict(model_type="gemma2", vocab_size=96, num_kv_heads=2, explicit_head_dim=16,
                   hidden_act="gelu_tanh", scale_embeddings=True, tie_embeddings=True,
                   sliding_window=6, window_layers=(0, 2), attn_softcap=50.0,
                   final_softcap=30.0),
}
SHAPES = ((1, 2, 2), (1, 4, 1))
LR, EPS = 1e-2, 1e-3
REFUSALS = {
    "layers": ("forward", dict(num_layers=3)),
    "heads": ("forward", dict(num_heads=3, num_kv_heads=3, hidden_size=24)),
    "kv_heads": ("forward", dict(num_kv_heads=1)),
    "intermediate": ("forward", dict(intermediate_size=63)),
    "opt": ("forward", dict(model_type="opt", qkv_bias=True)),
    "moe": ("forward", dict(num_experts=4)),
    "batch": ("batch", dict()),
    "schedule": ("schedule", dict()),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_tree(kw, seed):
    shapes = jax.eval_shape(lambda: jmodel.init_llama_params(jax.random.PRNGKey(0),
                                                             jmodel.LlamaConfig(**kw)))
    rng = np.random.default_rng(seed)

    def leaf(k, shape):
        if k.endswith("bias"):
            return (0.1 * rng.normal(size=shape)).astype(np.float32)
        if k.startswith("ln") or k.endswith("_norm"):
            return (1 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        return (0.08 * rng.normal(size=shape)).astype(np.float32)

    return {k: ({kk: leaf(kk, vv.shape) for kk, vv in v.items()} if isinstance(v, dict)
                else leaf(k, v.shape)) for k, v in shapes.items()}


def tokens(seed, b, vocab, s=16):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int64)


@pytest.fixture(scope="module")
def cases():
    out = {}
    for i, (name, extra) in enumerate(CASES.items()):
        kw = dict(BASE, **extra)
        out[name] = dict(cfg=kw, params=make_tree(kw, 60 + i),
                         tokens=tokens(70 + i, 4, kw["vocab_size"]))
    llama = out["llama"]["cfg"]
    return {"cases": out, "lr": LR, "eps": EPS, "step_tokens": tokens(80, 8, llama["vocab_size"]),
            "long_tokens": tokens(81, 8, llama["vocab_size"]),
            "refusals": {k: (kind, dict(llama, **kw)) for k, (kind, kw) in REFUSALS.items()}}


@pytest.fixture(scope="module")
def world(cases, tmp_path_factory):
    return run_world(tmp_path_factory.mktemp("pipe_world"), 4, "pipeline", cases, timeout=150)


@pytest.fixture(scope="module")
def jax_mesh():
    return jpipe.make_pipeline_mesh(data=2, pipe=2, model=2)


def expected_cut(tree, kw, coord, shape):
    """The port's shard of rank ``coord`` on a ``shape`` mesh, from a full tree
    (numpy): its stage's layers cut over model as ``llama_shard`` cuts them."""
    cfg = tmodel.LlamaConfig(**kw)
    _, p, m = coord
    n = cfg.num_layers // shape[1]
    full = tckpt.llm_params_from_jax(tree, device="cpu")
    stage = dict(full, blocks={k: v[p * n:(p + 1) * n] for k, v in full["blocks"].items()})
    cut = tshard.llama_shard(stage, cfg, m, shape[2])
    return dict(full, blocks=cut["blocks"])


def assert_tree_close(got, want, **tol):
    for k, v in want.items():
        if isinstance(v, dict):
            assert set(got[k]) == set(v), k
            for kk, vv in v.items():
                np.testing.assert_allclose(got[k][kk], vv.numpy(), err_msg=f"{k}/{kk}", **tol)
        else:
            np.testing.assert_allclose(got[k], v.numpy(), err_msg=k, **tol)


@pytest.mark.parametrize("name", list(CASES))
def test_block_specs_match_jax(cases, name):
    kw = cases["cases"][name]["cfg"]
    want = {k: tuple(v) for k, v in jpipe.pipeline_block_specs(jmodel.LlamaConfig(**kw)).items()}
    assert tpipe.pipeline_block_specs(tmodel.LlamaConfig(**kw)) == want


@pytest.mark.parametrize("name", list(CASES))
def test_forward_matches_jax_pipeline(world, cases, jax_mesh, name):
    c = cases["cases"][name]
    cfg = jmodel.LlamaConfig(**c["cfg"])
    sharded = jpipe.shard_llama_params_pipeline(jax.tree.map(jnp.asarray, c["params"]),
                                                jax_mesh, cfg)
    fwd = jax.jit(jpipe.make_pipeline_forward(jax_mesh, cfg, num_microbatches=2))
    want = np.asarray(fwd(sharded, jnp.asarray(c["tokens"].astype(np.int32))))
    for out in world:
        for shape in SHAPES:
            np.testing.assert_allclose(out[f"fwd_{shape}_{name}"], want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", list(CASES))
def test_gradients_match_jax(world, cases, name):
    c = cases["cases"][name]
    cfg = jmodel.LlamaConfig(**c["cfg"])
    toks = jnp.asarray(c["tokens"].astype(np.int32))

    def loss_fn(p):
        logits, _ = jmodel.llama_forward(p, toks, cfg, compute_dtype=jnp.float32)
        logp = jax.nn.log_softmax(logits[:, :-1], axis=-1)
        return -jnp.take_along_axis(logp, toks[:, 1:, None], axis=-1)[..., 0].mean()

    loss, grads = jax.value_and_grad(loss_fn)(jax.tree.map(jnp.asarray, c["params"]))
    grads = jax.tree.map(np.asarray, grads)
    for out in world:
        for shape in SHAPES:
            got_loss, got = out[f"grad_{shape}_{name}"]
            assert abs(got_loss - float(loss)) <= 1e-5 * abs(float(loss))
            want = expected_cut(grads, c["cfg"], out[f"coord_{shape}"], shape)
            assert_tree_close(got, want, atol=5e-5, rtol=5e-4)


@pytest.mark.parametrize("schedule", list(tpipe.SCHEDULES))
def test_train_step_matches_jax(world, cases, jax_mesh, schedule):
    c = cases["cases"]["llama"]
    cfg = jmodel.LlamaConfig(**c["cfg"])
    params = jax.tree.map(jnp.asarray, c["params"])
    toks = jnp.asarray(cases["step_tokens"].astype(np.int32))
    opt = optax.adamw(LR, eps=EPS)
    single = jtrain.make_llama_train_step(cfg, opt, compute_dtype=jnp.float32)
    p1, _, loss1 = single(jax.tree.map(jnp.copy, params), opt.init(params), np.asarray(toks))
    sharded = jpipe.shard_llama_params_pipeline(params, jax_mesh, cfg)
    step = jpipe.make_pipeline_train_step(jax_mesh, cfg, opt, num_microbatches=4,
                                          schedule=schedule)
    p2, _, loss2 = step(sharded, opt.init(sharded), toks)
    np.testing.assert_allclose(float(loss1), float(loss2), rtol=1e-5)
    p2 = jax.tree.map(np.asarray, p2)
    for out in world:
        for shape in SHAPES:
            loss, got = out[f"step_{shape}_{schedule}"]
            assert abs(loss - float(loss2)) <= 1e-5 * abs(float(loss2))
            want = expected_cut(p2, c["cfg"], out[f"coord_{shape}"], shape)
            assert_tree_close(got, want, rtol=1e-4, atol=1e-5)


def test_1f1b_holds_at_most_2p_minus_1_inputs(world):
    for out in world:
        p = out["coord_(1, 4, 1)"][1]
        # stage p holds the microbatches forwarded but not yet backwarded:
        # 2 (P - 1 - p) + 1 at most, whatever M
        assert out["held_m8"] == 2 * (4 - 1 - p) + 1 <= 2 * 4 - 1
        assert out["held_(1, 4, 1)_1f1b"] <= 2 * 4 - 1


def test_refusals_match_jax(world, cases, jax_mesh):
    kw = cases["cases"]["llama"]["cfg"]
    for name, (kind, bad) in cases["refusals"].items():
        cfg = jmodel.LlamaConfig(**bad)
        with pytest.raises(ValueError) as err:
            if kind == "forward":
                jpipe.make_pipeline_forward(jax_mesh, cfg, num_microbatches=2)
            elif kind == "batch":
                fwd = jpipe.make_pipeline_forward(jax_mesh, cfg, num_microbatches=3)
                fwd(jpipe.shard_llama_params_pipeline(
                    jax.tree.map(jnp.asarray, cases["cases"]["llama"]["params"]), jax_mesh,
                    jmodel.LlamaConfig(**kw)), jnp.zeros((4, 8), jnp.int32))
            else:
                jpipe.make_pipeline_train_step(jax_mesh, cfg, optax.sgd(0.1),
                                               num_microbatches=2, schedule="zigzag")
        want = str(err.value)
        if name in ("heads", "kv_heads", "intermediate"):   # JAX names model=2, the port too
            assert "% model 2 != 0" in want
        for out in world:
            assert out["refusals"][name] == want, name
