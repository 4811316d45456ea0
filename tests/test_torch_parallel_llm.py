"""The port's LLM tensor and data parallelism against the JAX package.

The port runs in one gloo world of 4 CPU processes (``torch_parallel_workers``),
on a dp=2 x tp=2 mesh and a tp=4 mesh; weights come from numpy seeds and
cross over through ``llm_params_from_jax``; everything is fp32.

- specs: ``llm_param_specs_like`` / ``llama_param_specs`` equal JAX's spec
  for spec on dense, qkv-bias / qk-norm, phi, OPT, int8, int4 and packed
  (fused qkv / gate-up, float and int8) trees;
- perplexity (``evaluate_perplexity_sharded``): llama at tp=4, GQA, phi,
  gemma-2 (tied, softcaps, mixed windows), OPT and an odd window count (3
  windows over data=2) at dp=2 x tp=2, within 1e-5 in log of the JAX
  package's; per-window NLL sums of ``sharded_window_nll_fn`` within rtol
  1e-5. The JAX reference is the single-device ``llama_forward`` in fp32
  (``tests/test_parallel.py`` pins JAX's sharded perplexity to it), and
  JAX's own ``evaluate_perplexity_sharded`` on a (2, 2) mesh for GQA, its
  forward switched to fp32 for the call;
- tensor-parallel serving (``tp_generate_kv_scan``): fp32, GQA batched,
  int8 weights, int4 weights (the replicated int4 down projection), packed
  float and packed int8 trees: the JAX single-device ``generate_kv_scan``'s
  tokens (JAX's test pins its tp serving to it), every rank the same; the
  int8 cache (bf16 compute) against the port's single-device run;
- refusals: KV heads that do not split over ``model``, a stream with no full
  window.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec
from torch_parallel_workers import run_world

from ssp_x_vit_tpu.llm import model as jmodel
from ssp_x_vit_tpu.llm import quant as jquant
from ssp_x_vit_tpu.llm import serve as jserve
from ssp_x_vit_tpu.parallel import llm_sharding as jshard
from ssp_x_vit_tpu.parallel import make_mesh as j_make_mesh
from ssp_x_vit_tpu_torch.llm import checkpoints as tckpt
from ssp_x_vit_tpu_torch.llm import model as tmodel
from ssp_x_vit_tpu_torch.llm import quant as tquant
from ssp_x_vit_tpu_torch.llm import serve as tserve
from ssp_x_vit_tpu_torch.parallel import llm_sharding as tshard

BASE = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=4,
            intermediate_size=48)
FAMILIES = {
    "llama": dict(),
    "gqa": dict(num_kv_heads=2),
    "phi": dict(model_type="phi", qkv_bias=True, rotary_dim=4),
    "gemma2": dict(model_type="gemma2", tie_embeddings=True, attn_softcap=50.0,
                   final_softcap=30.0, sliding_window=6, window_layers=(0,),
                   hidden_act="gelu_tanh", scale_embeddings=True),
    "opt": dict(model_type="opt", qkv_bias=True),
}
SEQ = 16
PPL = {name: dict(family=name, mesh="1x4" if name == "llama" else "2x2", windows=4)
       for name in FAMILIES}
PPL["odd_windows"] = dict(family="gqa", mesh="2x2", windows=3)
SERVE = {
    "fp32": dict(family="llama", mesh="1x4", prompts=[3, 5, 7, 11], max_length=16),
    "gqa_batched": dict(family="gqa", mesh="2x2", prompts=[[1, 2, 3], [9, 8]], max_length=12),
    "int8": dict(family="llama", mesh="1x4", prompts=[4, 8, 15, 16], max_length=14,
                 quant="int8"),
    "int4": dict(family="gqa", mesh="2x2", prompts=[[4, 8, 15], [16, 23]], max_length=14,
                 quant="int4"),
    "packed": dict(family="llama", mesh="1x4", prompts=[2, 3, 5, 7], max_length=12,
                   packed=True),
    "packed_int8": dict(family="gqa", mesh="2x2", prompts=[[2, 3, 5], [7]], max_length=12,
                        quant="int8", packed=True),
    "int8_cache": dict(family="gqa", mesh="2x2", prompts=[[6, 1, 2], [3, 3]], max_length=12,
                       quant="int8", cache="int8"),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_tree(family: str, seed: int, **extra):
    """(numpy tree, config kwargs): kernels ~ N(0, 0.08), norms ~ 1 + N(0, 0.1),
    biases ~ N(0, 0.1)."""
    kw = dict(BASE, **FAMILIES[family], **extra)
    shapes = jax.eval_shape(lambda: jmodel.init_llama_params(jax.random.PRNGKey(0),
                                                             jmodel.LlamaConfig(**kw)))
    rng = np.random.default_rng(seed)

    def leaf(name, shape):
        if name.endswith("bias"):
            return (0.1 * rng.normal(size=shape)).astype(np.float32)
        if name.startswith("ln") or name.endswith("_norm"):
            return (1 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        return (0.08 * rng.normal(size=shape)).astype(np.float32)

    tree = {k: ({kk: leaf(kk, vv.shape) for kk, vv in v.items()} if isinstance(v, dict)
                else leaf(k, v.shape)) for k, v in shapes.items()}
    return tree, kw


def stream(n_windows: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, BASE["vocab_size"], n_windows * SEQ)


def jax_window_nll(tree, kw, ids) -> np.ndarray:
    windows = jnp.asarray(ids.reshape(-1, SEQ).astype(np.int32))
    logits, _ = jmodel.llama_forward(jax.tree.map(jnp.asarray, tree), windows,
                                     jmodel.LlamaConfig(**kw), compute_dtype=jnp.float32)
    logp = jax.nn.log_softmax(logits[:, :-1], axis=-1)
    nll = -jnp.take_along_axis(logp, windows[:, 1:, None], axis=-1)[..., 0]
    return np.asarray(nll.sum(axis=1), np.float64)


def _quantized(tree, cfg, case, lib, pack):
    if case.get("quant"):
        tree = getattr(lib, f"quantize_llm_params_{case['quant']}")(tree, cfg)
    return pack(tree, cfg) if case.get("packed") else tree


@pytest.fixture(scope="module")
def cases():
    ppl, serve = {}, {}
    for i, (name, c) in enumerate(PPL.items()):
        tree, kw = make_tree(c["family"], seed=10 + i)
        ids = stream(c["windows"], seed=20 + i)
        ppl[name] = dict(cfg=kw, params=tree, stream=ids, seq_len=SEQ, mesh=c["mesh"],
                         windows=ids.reshape(-1, SEQ)[:2])
    for i, (name, c) in enumerate(SERVE.items()):
        tree, kw = make_tree(c["family"], seed=30 + i)
        serve[name] = dict(c, cfg=kw, params=tree, cache=c.get("cache", "fp32"))
    refusal, refusal_kw = make_tree("gqa", seed=1)
    return {"ppl": ppl, "serve": serve, "refusal_cfg": refusal_kw, "refusal_params": refusal}


@pytest.fixture(scope="module")
def world(cases, tmp_path_factory):
    return run_world(tmp_path_factory.mktemp("llm_world"), 4, "llm", cases)


@pytest.mark.parametrize("name", list(PPL))
def test_sharded_perplexity_matches_jax(world, cases, name):
    case = cases["ppl"][name]
    nll = jax_window_nll(case["params"], case["cfg"], case["stream"])
    want = np.exp(nll.sum() / (len(nll) * (SEQ - 1)))
    for out in world:
        assert out[f"ppl_{name}"] == world[0][f"ppl_{name}"]
        assert abs(np.log(out[f"ppl_{name}"]) - np.log(want)) < 1e-5
        np.testing.assert_allclose(out[f"nll_{name}"], nll[:2], rtol=1e-5)


def test_jax_sharded_perplexity_agrees(cases, world, monkeypatch):
    """JAX's own dp x tp perplexity on a (2, 2) mesh (its forward switched to
    fp32 for the call) against the port's world, on the GQA case."""
    case = cases["ppl"]["gqa"]
    monkeypatch.setattr(jmodel, "llama_forward",
                        functools.partial(jmodel.llama_forward, compute_dtype=jnp.float32))
    cfg = jmodel.LlamaConfig(**case["cfg"])
    mesh = j_make_mesh(data=2, model=2)
    sharded = jshard.shard_llama_params(jax.tree.map(jnp.asarray, case["params"]), mesh, cfg)
    got = jshard.evaluate_perplexity_sharded(sharded, cfg, mesh, case["stream"], seq_len=SEQ)
    assert abs(np.log(got) - np.log(world[0]["ppl_gqa"])) < 1e-5


def _jax_tokens(case):
    kw = case["cfg"]
    tree = jax.tree.map(jnp.asarray, case["params"])
    tree = _quantized(tree, jmodel.LlamaConfig(**kw), case, jquant,
                      jserve.pack_llm_params_for_serving)
    out = jserve.generate_kv_scan(tree, jmodel.LlamaConfig(**kw), case["prompts"],
                                  max_length=case["max_length"], cache_dtype=jnp.float32)
    return [np.asarray(t) for t in (out if isinstance(out, list) else [out])]


def _port_tokens(case):
    kw = case["cfg"]
    cfg = tmodel.LlamaConfig(**kw)
    tree = _quantized(tckpt.llm_params_from_jax(case["params"], device="cpu"), cfg, case,
                      tquant, tserve.pack_llm_params_for_serving)
    out = tserve.generate_kv_scan(tree, cfg, case["prompts"], max_length=case["max_length"],
                                  cache_dtype=torch.int8 if case["cache"] == "int8"
                                  else torch.float32)
    return [np.asarray(t) for t in (out if isinstance(out, list) else [out])]


@pytest.mark.parametrize("name", list(SERVE))
def test_tp_serving_matches_single_device(world, cases, name):
    case = cases["serve"][name]
    want = _port_tokens(case) if case["cache"] == "int8" else _jax_tokens(case)
    for out in world:
        got = out[f"serve_{name}"]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_refusals(world):
    for out in world:
        assert "num_kv_heads 2 not divisible by model-axis size 4" in out["refuse_kv"]
        assert "no full window" in out["refuse_window"]


def test_kv_cache_shards_over_heads(world):
    """``shard_llm_cache`` cuts axis 3 (the KV heads) of the int8 ``{"q", "s"}``
    cache, and ``tp_cache_factory`` makes caches of the same local shape."""
    full = np.arange(2 * 2 * 8 * 2 * 8).reshape(2, 2, 8, 2, 8) % 100   # [A, b, len, nkv, hd]
    for rank, out in enumerate(world):
        assert out["cache"] == {"q": ((2, 2, 8, 1, 8),) * 2, "s": ((2, 2, 8, 1),) * 2}
        np.testing.assert_array_equal(out["cache_heads"], full[:, :, :, rank % 2:rank % 2 + 1])


def _j_specs(tree):
    return jax.tree.map(tuple, jshard.llm_param_specs_like(tree),
                        is_leaf=lambda x: isinstance(x, PartitionSpec))


@pytest.mark.parametrize("variant", ["dense", "qkv_bias_qk_norm", "phi", "opt", "int8", "int4",
                                     "packed", "packed_int8"])
def test_specs_match_jax(variant):
    family = variant if variant in ("phi", "opt") else "llama"
    extra = dict(qkv_bias=True, qk_norm=True) if variant == "qkv_bias_qk_norm" else {}
    tree, kw = make_tree(family, seed=3, **extra)
    case = {"quant": variant.replace("packed_", "") if "int" in variant else None,
            "packed": variant.startswith("packed")}
    jtree = _quantized(jax.tree.map(jnp.asarray, tree), jmodel.LlamaConfig(**kw), case, jquant,
                       jserve.pack_llm_params_for_serving)
    cfg = tmodel.LlamaConfig(**kw)
    ttree = _quantized(tckpt.llm_params_from_jax(tree, device="cpu"), cfg, case, tquant,
                       tserve.pack_llm_params_for_serving)
    assert tshard.llm_param_specs_like(ttree) == _j_specs(jtree)
    if variant in ("dense", "qkv_bias_qk_norm"):
        want = jax.tree.map(tuple, jshard.llama_param_specs(jmodel.LlamaConfig(**kw)),
                            is_leaf=lambda x: isinstance(x, PartitionSpec))
        assert tshard.llama_param_specs(cfg) == want
