"""The port's expert parallelism and MoE-llama placements against the JAX
package.

The port runs in one gloo world of 4 CPU processes (``torch_parallel_workers``);
JAX on the conftest's virtual devices. Weights and inputs come from numpy
seeds; everything is fp32.

- ``moe_ffn(..., mesh=)`` on the (1, 4) expert mesh (one expert of 4 a rank):
  ``y`` within 1e-5 of JAX's ep = 4 forward on a (2, 4) mesh, ``aux`` (load,
  dropped, aux_loss) within 1e-6, top-1 with overflow drops and top-2;
- ``moe_llama_param_specs_like`` equals JAX's on float, int8 and int4 trees;
- the MoE-llama forward (top-2, 4 experts) with whole experts a rank
  (``shard_moe_llama_params``, ``expert_group=``) on float, int8 and int4
  trees, and with the experts' f axis cut over ``model`` (tp = 4) on float
  and int8 trees, within 1e-5 of max(1, |JAX|) of JAX's ``llama_forward``
  (on JAX's own expert-sharded placement for the float tree), the layers'
  load-balance losses within 1e-6; an int4 tree under tp is refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec
from torch_parallel_workers import run_world

from ssp_x_vit_tpu.llm import model as jmodel
from ssp_x_vit_tpu.llm import quant as jquant
from ssp_x_vit_tpu.parallel import llm_sharding as jshard
from ssp_x_vit_tpu.parallel import moe as jmoe
from ssp_x_vit_tpu_torch.llm import checkpoints as tckpt
from ssp_x_vit_tpu_torch.llm import model as tmodel
from ssp_x_vit_tpu_torch.llm import quant as tquant
from ssp_x_vit_tpu_torch.parallel import llm_sharding as tshard

MOE = {
    "top1_drops": dict(hidden_size=32, expert_intermediate=64, num_experts=4,
                       capacity_factor=0.5),
    "top2": dict(hidden_size=32, expert_intermediate=64, num_experts=4, capacity_factor=2.0,
                 top_k=2),
}
LLAMA = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=4,
             intermediate_size=48, num_experts=4, moe_top_k=2)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def moe_case(name, seed):
    kw = MOE[name]
    rng = np.random.default_rng(seed)
    d, f, E = kw["hidden_size"], kw["expert_intermediate"], kw["num_experts"]

    def w(*shape):
        return (0.2 * rng.standard_normal(shape)).astype(np.float32)

    return dict(cfg=kw, params={"router": w(d, E), "gate_kernel": w(E, d, f),
                                "up_kernel": w(E, d, f), "down_kernel": w(E, f, d)},
                x=rng.standard_normal((2, 16, d)).astype(np.float32))


def llama_tree(seed):
    shapes = jax.eval_shape(lambda: jmodel.init_llama_params(jax.random.PRNGKey(0),
                                                             jmodel.LlamaConfig(**LLAMA)))
    rng = np.random.default_rng(seed)

    def leaf(k, shape):
        if k.startswith("ln"):
            return (1 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        return (0.1 * rng.normal(size=shape)).astype(np.float32)

    return {k: ({kk: leaf(kk, vv.shape) for kk, vv in v.items()} if isinstance(v, dict)
                else leaf(k, v.shape)) for k, v in shapes.items()}


@pytest.fixture(scope="module")
def cases():
    return {"moe": {n: moe_case(n, i) for i, n in enumerate(MOE)}, "llama_cfg": LLAMA,
            "llama_params": llama_tree(7),
            "tokens": np.random.default_rng(8).integers(0, 64, (2, 12)).astype(np.int64)}


@pytest.fixture(scope="module")
def world(cases, tmp_path_factory):
    return run_world(tmp_path_factory.mktemp("expert_world"), 4, "expert", cases)


@pytest.mark.parametrize("name", list(MOE))
def test_moe_ffn_expert_parallel_matches_jax(world, cases, name):
    c = cases["moe"][name]
    cfg = jmoe.MoEConfig(**c["cfg"])
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(2, 4), ("data", "expert"))
    params = jmoe.shard_moe_params(jax.tree.map(jnp.asarray, c["params"]), mesh)
    x = jax.device_put(jnp.asarray(c["x"]), NamedSharding(mesh, PartitionSpec("data")))
    y, aux = jax.jit(lambda p, x: jmoe.moe_ffn(p, x, cfg, mesh=mesh))(params, x)
    if name == "top1_drops":
        assert float(aux["dropped"]) > 0
    for out in world:
        got_y, got_aux, local = out[f"moe_{name}"]
        assert local == (1, 32, 64)
        np.testing.assert_allclose(got_y, np.asarray(y), atol=1e-5)
        for k, v in aux.items():
            np.testing.assert_allclose(got_aux[k], np.asarray(v), atol=1e-6, err_msg=k)


@pytest.mark.parametrize("quant", ["float", "int8", "int4"])
def test_moe_llama_specs_match_jax(cases, quant):
    jcfg, tcfg = jmodel.LlamaConfig(**LLAMA), tmodel.LlamaConfig(**LLAMA)
    jt = jax.tree.map(jnp.asarray, cases["llama_params"])
    tt = tckpt.llm_params_from_jax(cases["llama_params"], device="cpu")
    if quant != "float":
        jt = getattr(jquant, f"quantize_llm_params_{quant}")(jt, jcfg)
        tt = getattr(tquant, f"quantize_llm_params_{quant}")(tt, tcfg)
    want = jax.tree.map(tuple, jshard.moe_llama_param_specs_like(jt),
                        is_leaf=lambda x: isinstance(x, PartitionSpec))
    assert tshard.moe_llama_param_specs_like(tt) == want


def _jax_forward(cases, quant):
    cfg = jmodel.LlamaConfig(**LLAMA)
    tree = jax.tree.map(jnp.asarray, cases["llama_params"])
    if quant != "float":
        tree = getattr(jquant, f"quantize_llm_params_{quant}")(tree, cfg)
    else:   # JAX's own expert placement (GSPMD) for the float tree
        mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(1, 4), ("data", "expert"))
        tree = jshard.shard_moe_llama_params(tree, mesh)
    logits, aux = jmodel.llama_forward(tree, jnp.asarray(cases["tokens"].astype(np.int32)), cfg,
                                       compute_dtype=jnp.float32)
    return np.asarray(logits), np.asarray(aux["moe_aux_loss"])


@pytest.mark.parametrize("quant", ["float", "int8", "int4"])
def test_moe_llama_forward_matches_jax(world, cases, quant):
    logits, aux = _jax_forward(cases, quant)
    scale = max(1.0, float(np.abs(logits).max()))
    for out in world:
        for kind in ("ep", "tp"):
            if kind == "tp" and quant == "int4":
                assert "int4 expert stacks" in out["refuse_tp_int4"]
                continue
            got, got_aux = out[f"{kind}_{quant}"]
            assert np.abs(got - logits).max() <= 1e-5 * scale, kind
            np.testing.assert_allclose(got_aux, aux, atol=1e-6)
