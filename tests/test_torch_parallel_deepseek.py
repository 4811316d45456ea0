"""The port's DeepSeek / MLA parallelism against the JAX package.

The port runs in one gloo world of 4 CPU processes (``torch_parallel_workers``);
JAX on the conftest's virtual devices. Weights come from numpy seeds (the
JAX tree layout, ``deepseek_params_from_jax``); everything is fp32. The MoE
config is ``tests/test_deepseek_parallel.py``'s (1 dense + 2 MoE layers,
shared expert, q-lora) with nonzero ``e_bias``.

- the MLA latent ring (``evaluate_perplexity_seq_parallel`` on the (1, 4) and
  (2, 2) seq meshes) within 1e-5 in log of JAX's on (2, 4);
- ``deepseek_generate`` at tp = 4 (``shard_deepseek_params``, MoE experts cut
  on E, the lm_head on the vocabulary) token for token against JAX's single
  device and JAX's tp = 4, every rank the same; the shard's shapes;
- ``deepseek_param_specs_like`` equals JAX's on the float tree; the four
  divisibility refusals with JAX's messages;
- one FSDP AdamW step (dp = 4) against JAX's single-device step: loss within
  rtol 1e-5, every shard within rtol 1e-4 / atol 1e-5 (AdamW's eps at 1e-3),
  ``e_bias`` bit for bit; the FSDP specs equal JAX's;
- the dense variant's pipeline on (1, 2, 2) and (1, 4, 1): logits within 1e-4
  of JAX's ``make_deepseek_pipeline_forward`` on (2, 2, 2), one GPipe AdamW
  step against JAX's ``make_deepseek_pipeline_train_step``; the MoE config's
  refusal with JAX's message.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec
from torch_parallel_workers import run_world

from ssp_x_vit_tpu.llm import deepseek as J
from ssp_x_vit_tpu.llm import train as jtrain
from ssp_x_vit_tpu.parallel import deepseek_parallel as jdp
from ssp_x_vit_tpu.parallel import llm_sharding as jshard
from ssp_x_vit_tpu.parallel import make_mesh as j_make_mesh
from ssp_x_vit_tpu.parallel.ring_attention import evaluate_perplexity_seq_parallel
from ssp_x_vit_tpu_torch.llm import deepseek as T
from ssp_x_vit_tpu_torch.llm.checkpoints import deepseek_params_from_jax
from ssp_x_vit_tpu_torch.parallel import llm_sharding as tshard

MOE = dict(vocab_size=64, hidden_size=16, num_layers=3, num_heads=4, kv_lora_rank=8,
           qk_nope_head_dim=4, qk_rope_head_dim=4, v_head_dim=4, intermediate_size=24,
           n_routed_experts=4, n_shared_experts=1, num_experts_per_tok=2,
           moe_intermediate_size=12, q_lora_rank=8, first_k_dense_replace=1,
           routed_scaling_factor=1.5)
DENSE = dict(vocab_size=64, hidden_size=16, num_layers=4, num_heads=4, kv_lora_rank=8,
             qk_nope_head_dim=4, qk_rope_head_dim=4, v_head_dim=4, intermediate_size=24,
             n_routed_experts=0)
REFUSALS = {   # JAX's four checks, each with tp = 4
    "num_heads": dict(DENSE, num_heads=2),
    "n_routed_experts": dict(MOE, n_routed_experts=2, num_experts_per_tok=1),
    "vocab_size": dict(DENSE, vocab_size=62),
    "intermediate_size": dict(DENSE, intermediate_size=26),
}
SEQ, LR, EPS = 64, 1e-2, 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_tree(kw, seed):
    """Kernels ~ N(0, 0.1), norms at one, e_bias ~ U(-0.05, 0.05)."""
    rng = np.random.default_rng(seed)

    def fill(name, t):
        if isinstance(t, dict):
            return {k: fill(k, v) for k, v in t.items()}
        if name.startswith("ln") or name.endswith("norm"):
            return np.ones(tuple(t.shape), np.float32)
        if name == "e_bias":
            return rng.uniform(-0.05, 0.05, tuple(t.shape)).astype(np.float32)
        return (rng.standard_normal(tuple(t.shape)) * 0.1).astype(np.float32)

    shapes = T.init_deepseek_params(None, T.DeepseekConfig(**kw), device="cpu")
    return {k: fill(k, v) for k, v in shapes.items()}


def jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def cases():
    rng = np.random.default_rng(5)
    return {
        "moe_cfg": MOE, "moe_params": make_tree(MOE, 1),
        "stream": rng.integers(0, 64, 3 * SEQ), "seq_len": SEQ,
        "prompt": np.asarray([3, 11, 7, 30]),
        "refusals": {k: (kw, make_tree(kw, 2)) for k, kw in REFUSALS.items()},
        "lr": LR, "eps": EPS, "fsdp_tokens": rng.integers(0, 64, (8, 24)).astype(np.int64),
        "dense_cfg": DENSE, "dense_params": make_tree(DENSE, 3),
        "pipe_tokens": rng.integers(0, 64, (4, 12)).astype(np.int64),
    }


@pytest.fixture(scope="module")
def world(cases, tmp_path_factory):
    return run_world(tmp_path_factory.mktemp("ds_world"), 4, "deepseek", cases, timeout=150)


def test_mla_ring_perplexity_matches_jax(world, cases):
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(2, 4), ("data", "seq"))
    want = evaluate_perplexity_seq_parallel(jtree(cases["moe_params"]), J.DeepseekConfig(**MOE),
                                            mesh, cases["stream"], seq_len=SEQ)
    for out in world:
        for shape in ((1, 4), (2, 2)):
            assert abs(np.log(out[f"ppl_{shape}"]) - np.log(want)) < 1e-5


def test_tp4_generation_matches_jax(world, cases):
    cfg, params = J.DeepseekConfig(**MOE), jtree(cases["moe_params"])
    single = np.asarray(J.deepseek_generate(params, cfg, cases["prompt"], max_new_tokens=6,
                                            compute_dtype=jnp.float32))
    mesh = j_make_mesh(model=4)
    tp = np.asarray(J.deepseek_generate(jshard.shard_deepseek_params(params, mesh, cfg), cfg,
                                        cases["prompt"], max_new_tokens=6,
                                        compute_dtype=jnp.float32))
    np.testing.assert_array_equal(tp, single)
    for out in world:
        np.testing.assert_array_equal(out["tp_tokens"], single)
        blocks = out["tp_shapes"]["moe_blocks"]
        assert blocks["gate_kernel"] == (2, 1, 16, 12)          # one of 4 experts a rank
        assert blocks["kv_b_kernel"] == (2, 8, 8)               # one head of 4: nope + vd
        assert blocks["o_kernel"] == (2, 4, 16) and blocks["kv_a_kernel"] == (2, 16, 12)
        assert out["tp_shapes"]["lm_head"] == (16, 16)


def test_param_specs_match_jax(cases):
    tree = cases["moe_params"]
    want = jax.tree.map(tuple, jshard.deepseek_param_specs_like(jtree(tree)),
                        is_leaf=lambda x: isinstance(x, PartitionSpec))
    assert tshard.deepseek_param_specs_like(deepseek_params_from_jax(tree, device="cpu")) == want


def test_divisibility_refusals_match_jax(world, cases):
    mesh = j_make_mesh(model=4)
    for name, (kw, tree) in cases["refusals"].items():
        with pytest.raises(ValueError) as err:
            jshard.shard_deepseek_params(jtree(tree), mesh, J.DeepseekConfig(**kw))
        assert name in str(err.value)
        for out in world:
            assert out["refusals"][name] == str(err.value)


def test_fsdp_step_matches_jax(world, cases):
    cfg, params = J.DeepseekConfig(**MOE), jtree(cases["moe_params"])
    opt = optax.adamw(LR, eps=EPS)
    step = jtrain.make_llama_train_step(cfg, opt, compute_dtype=jnp.float32)
    p1, _, loss = step(jax.tree.map(jnp.copy, params), opt.init(params),
                       cases["fsdp_tokens"].astype(np.int32))
    p1 = jax.tree.map(np.asarray, p1)
    specs = jax.tree.map(tuple, jshard.fsdp_llama_param_specs_like(params, 4),
                         is_leaf=lambda x: isinstance(x, PartitionSpec))
    e0 = cases["moe_params"]["moe_blocks"]["e_bias"]
    for r, out in enumerate(world):
        got_loss, shard = out["fsdp"]
        assert abs(got_loss - float(loss)) <= 1e-5 * abs(float(loss))
        assert out["fsdp_specs"] == specs

        def cut(v, spec):
            if "data" not in spec:
                return v
            ax = spec.index("data")
            n = v.shape[ax] // 4
            return np.take(v, range(r * n, (r + 1) * n), axis=ax)

        for k, v in p1.items():
            if isinstance(v, dict):
                for bk, bv in v.items():
                    np.testing.assert_allclose(shard[k][bk], cut(bv, specs[k][bk]), rtol=1e-4,
                                               atol=1e-5, err_msg=f"{k}/{bk}")
            else:
                np.testing.assert_allclose(shard[k], cut(v, specs[k]), rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(shard["moe_blocks"]["e_bias"],
                                      cut(e0, specs["moe_blocks"]["e_bias"]))


@pytest.fixture(scope="module")
def pipe_mesh():
    return Mesh(np.asarray(jax.devices()[:8]).reshape(2, 2, 2), ("data", "pipe", "model"))


def test_pipeline_forward_matches_jax(world, cases, pipe_mesh):
    cfg = J.DeepseekConfig(**DENSE)
    sharded = jdp.shard_deepseek_params_pipeline(jtree(cases["dense_params"]), pipe_mesh, cfg)
    fwd = jax.jit(jdp.make_deepseek_pipeline_forward(pipe_mesh, cfg, num_microbatches=2))
    want = np.asarray(fwd(sharded, jnp.asarray(cases["pipe_tokens"].astype(np.int32))))
    for out in world:
        for shape in ((1, 2, 2), (1, 4, 1)):
            np.testing.assert_allclose(out[f"fwd_{shape}"], want, atol=1e-4, rtol=1e-4)


def test_pipeline_train_step_matches_jax(world, cases, pipe_mesh):
    cfg = J.DeepseekConfig(**DENSE)
    opt = optax.adamw(LR, eps=EPS)
    sharded = jdp.shard_deepseek_params_pipeline(jtree(cases["dense_params"]), pipe_mesh, cfg)
    step = jdp.make_deepseek_pipeline_train_step(pipe_mesh, cfg, opt, num_microbatches=2)
    p2, _, loss = step(sharded, opt.init(sharded),
                       jnp.asarray(cases["pipe_tokens"].astype(np.int32)))
    p2 = jax.tree.map(np.asarray, p2)
    col = {k for k, v in jdp.deepseek_pipeline_block_specs(cfg).items() if v[-1] == "model"}
    for out in world:
        for shape in ((1, 2, 2), (1, 4, 1)):
            got_loss, shard = out[f"step_{shape}"]
            assert abs(got_loss - float(loss)) <= 1e-5 * abs(float(loss))
            _, p, m = out[f"coord_{shape}"]
            n, tp = DENSE["num_layers"] // shape[1], shape[2]
            for k, v in p2["dense_blocks"].items():
                v = v[p * n:(p + 1) * n]
                ax = 2 if k in col else (1 if k in ("o_kernel", "down_kernel") else None)
                if ax is not None:
                    w = v.shape[ax] // tp
                    v = np.take(v, range(m * w, (m + 1) * w), axis=ax)
                np.testing.assert_allclose(shard["dense_blocks"][k], v, rtol=1e-4, atol=1e-5,
                                           err_msg=k)
            for k in ("embed", "ln_final", "lm_head"):
                np.testing.assert_allclose(shard[k], p2[k], rtol=1e-4, atol=1e-5, err_msg=k)


def test_pipeline_moe_refusal_matches_jax(world, pipe_mesh):
    with pytest.raises(ValueError, match="expert-parallel") as err:
        jdp.make_deepseek_pipeline_forward(pipe_mesh, J.DeepseekConfig(**MOE),
                                           num_microbatches=2)
    for out in world:
        assert out["refuse_moe"] == str(err.value)
