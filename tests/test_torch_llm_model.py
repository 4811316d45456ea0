"""The port's llama-family forward against the JAX package on the CPU.

Weights and tokens come from a numpy seed and are carried across by
``llm_params_from_jax``. At ``compute_dtype=float32`` the two frameworks run
the same arithmetic in another summation order: logits atol 1e-4, ``mlp_stats``
rtol 1e-5. At the bf16 default they round at other places: error scaled by
max(1, max |reference|) <= 5e-2.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssp_x_vit_tpu.llm import checkpoints as jckpt
from ssp_x_vit_tpu.llm import datasets as jdata
from ssp_x_vit_tpu.llm import model as jmodel
from ssp_x_vit_tpu.llm import pruning as jprune
from ssp_x_vit_tpu_torch.cli.main_llm import _TINY_VARIANTS, TINY_RANDOM
from ssp_x_vit_tpu_torch.llm import checkpoints as tckpt
from ssp_x_vit_tpu_torch.llm import datasets as tdata
from ssp_x_vit_tpu_torch.llm import model as tmodel
from ssp_x_vit_tpu_torch.llm import pruning as tprune

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = sorted(_TINY_VARIANTS)
SMALL = dict(TINY_RANDOM, num_layers=3)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's tiny tensors: the suite runs six
    workers on the host's cores, where a pool per worker only contends."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_model(family, seed=0, **overrides):
    """(jax params, jax cfg, torch params, torch cfg) with numpy-seeded weights:
    kernels ~ N(0, 0.05), norm scales ~ 1 + N(0, 0.1), biases ~ N(0, 0.1)."""
    kw = dict(SMALL, **_TINY_VARIANTS[family])
    if "window_layers" in kw:
        kw["window_layers"] = tuple(i for i in kw["window_layers"] if i < kw["num_layers"])
    kw.update(overrides)
    jcfg, tcfg = jmodel.LlamaConfig(**kw), tmodel.LlamaConfig(**kw)
    shapes = jax.eval_shape(lambda: jmodel.init_llama_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(seed)

    def leaf(name, shape):
        if name.endswith("bias"):
            return (0.1 * rng.normal(size=shape)).astype(np.float32)
        if name.startswith("ln") or name.endswith("_norm"):
            return (1 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        return (0.05 * rng.normal(size=shape)).astype(np.float32)

    tree = {k: ({kk: leaf(kk, vv.shape) for kk, vv in v.items()} if isinstance(v, dict)
                else leaf(k, v.shape)) for k, v in shapes.items()}
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = tckpt.llm_params_from_jax(tree, device="cpu")
    return jparams, jcfg, tparams, tcfg


def tokens(seed, b, s, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, s)).astype(np.int32)


def scaled_err(got, ref):
    ref = np.asarray(ref, np.float32)
    return np.abs(got.float().numpy() - ref).max() / max(1.0, np.abs(ref).max())


def test_config_is_field_for_field_the_jax_config():
    jf = [(f.name, f.default) for f in dataclasses.fields(jmodel.LlamaConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tmodel.LlamaConfig)]
    assert jf == tf
    jc, tc = jmodel.LlamaConfig(), tmodel.LlamaConfig()
    for prop in ("head_dim", "effective_intermediate", "attn_store_index", "uniform_window"):
        assert getattr(jc, prop) == getattr(tc, prop)


@pytest.mark.parametrize("family", FAMILIES)
def test_llama_forward_fp32_matches_jax(family):
    jparams, jcfg, tparams, tcfg = make_model(family)
    ids = tokens(1, 2, 96)
    L, f = tcfg.num_layers, tcfg.intermediate_size
    rng = np.random.default_rng(2)
    ga = rng.choice([0.0, 0.5, 1.0], size=L).astype(np.float32)
    gm = rng.choice([0.0, 1.0], size=L).astype(np.float32)
    nm = (rng.random((L, f)) > 0.3).astype(np.float32)
    for kw in (dict(), dict(attn_gate=ga, mlp_gate=gm, neuron_mask=nm)):
        ref, raux = jmodel.llama_forward(
            jparams, jnp.asarray(ids), jcfg, collect_mlp_stats=True, collect_mlp_io_stats=True,
            return_block_outputs=True, compute_dtype=jnp.float32,
            **{k: jnp.asarray(v) for k, v in kw.items()})
        got, gaux = tmodel.llama_forward(
            tparams, torch.from_numpy(ids).long(), tcfg, collect_mlp_stats=True,
            collect_mlp_io_stats=True, return_block_outputs=True, compute_dtype=torch.float32,
            **{k: torch.from_numpy(v) for k, v in kw.items()})
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=0)
        assert set(gaux) == set(raux)
        assert gaux["mlp_stats"].shape == (L, 2, f) and gaux["mlp_stats"].dtype == torch.float32
        np.testing.assert_allclose(gaux["mlp_stats"].numpy(), np.asarray(raux["mlp_stats"]),
                                   rtol=1e-5, atol=1e-7)
        for key in ("mlp_in_stats", "mlp_out_stats", "block_outputs"):
            np.testing.assert_allclose(gaux[key].numpy(), np.asarray(raux[key]),
                                       rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("family", FAMILIES)
def test_llama_forward_bf16_default_matches_jax(family):
    jparams, jcfg, tparams, tcfg = make_model(family, seed=3)
    ids = tokens(4, 1, 64)
    ref, raux = jmodel.llama_forward(jparams, jnp.asarray(ids), jcfg, collect_mlp_stats=True)
    got, gaux = tmodel.llama_forward(tparams, torch.from_numpy(ids).long(), tcfg,
                                     collect_mlp_stats=True)
    assert got.dtype == torch.float32
    assert scaled_err(got, ref) <= 5e-2
    assert scaled_err(gaux["mlp_stats"], raux["mlp_stats"]) <= 5e-2


def test_mlp_stats_kind_sumabs_matches_jax():
    jparams, jcfg, tparams, tcfg = make_model("tiny-random", seed=5)
    ids = tokens(6, 2, 48)
    _, raux = jmodel.llama_forward(jparams, jnp.asarray(ids), jcfg, collect_mlp_stats=True,
                                   mlp_stats_kind="sumabs", compute_dtype=jnp.float32)
    _, gaux = tmodel.llama_forward(tparams, torch.from_numpy(ids).long(), tcfg,
                                   collect_mlp_stats=True, mlp_stats_kind="sumabs",
                                   compute_dtype=torch.float32)
    np.testing.assert_allclose(gaux["mlp_stats"].numpy(), np.asarray(raux["mlp_stats"]),
                               rtol=1e-5, atol=1e-7)


def test_candidate_gate_batch_equals_one_forward_per_candidate():
    """[L, C, 1, 1] gates over C copies of a window are C single forwards."""
    _, _, tparams, tcfg = make_model("tiny-random", seed=7)
    ids = torch.from_numpy(tokens(8, 1, 40)).long()
    L = tcfg.num_layers
    gates = torch.ones(L, L)
    gates[torch.arange(L), torch.arange(L)] = 0.0  # candidate c skips layer c
    batch, _ = tmodel.llama_forward(tparams, ids.expand(L, -1), tcfg,
                                    attn_gate=gates.t()[:, :, None, None],
                                    compute_dtype=torch.float32)
    for c in range(L):
        one, _ = tmodel.llama_forward(tparams, ids, tcfg, attn_gate=gates[c],
                                      compute_dtype=torch.float32)
        np.testing.assert_allclose(batch[c].numpy(), one[0].numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("family", FAMILIES)
def test_llama_forward_materialized_matches_jax(family):
    """Width-materialize to 100 neurons, drop the attention of layer 1, and
    compare the materialized forwards (and the port's own gated forward)."""
    jparams, jcfg, tparams, tcfg = make_model(family, seed=9)
    rng = np.random.default_rng(10)
    keep = [np.sort(rng.choice(tcfg.intermediate_size, size=100, replace=False))
            for _ in range(tcfg.num_layers)]
    jp, jc = jprune.materialize_llm_width_pruning(jparams, jcfg, keep)
    tp, tc = tprune.materialize_llm_width_pruning(tparams, tcfg, keep)
    ids = tokens(11, 2, 80)
    gate = np.ones(tcfg.num_layers, np.float32)
    gate[1] = 0.0
    gated, _ = tmodel.llama_forward(tp, torch.from_numpy(ids).long(), tc,
                                    attn_gate=torch.from_numpy(gate),
                                    compute_dtype=torch.float32)
    jp, jc = jprune.materialize_llm_depth_pruning(jp, jc, [1])
    tp, tc = tprune.materialize_llm_depth_pruning(tp, tc, [1])
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    for k, v in tp["blocks"].items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jp["blocks"][k]))
    ref = jmodel.llama_forward_materialized(jp, jnp.asarray(ids), jc, compute_dtype=jnp.float32)
    got = tmodel.llama_forward_materialized(tp, torch.from_numpy(ids).long(), tc,
                                            compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.numpy(), gated.numpy(), atol=1e-4, rtol=0)
    with pytest.raises(ValueError, match="llama_forward_materialized"):
        tmodel.llama_forward(tp, torch.from_numpy(ids).long(), tc)


def test_rope_scaling_and_mistral_window_match_jax():
    from ssp_x_vit_tpu.llm.rope import RopeScaling as JRope
    from ssp_x_vit_tpu_torch.llm.rope import RopeScaling as TRope

    sc = dict(rope_type="llama3", factor=8.0, original_max_position_embeddings=64)
    kw = dict(SMALL, num_kv_heads=2, sliding_window=24, qkv_bias=True)
    jcfg = jmodel.LlamaConfig(**kw, rope_scaling=JRope(**sc))
    tcfg = tmodel.LlamaConfig(**kw, rope_scaling=TRope(**sc))
    jparams, _, tparams, _ = make_model("tiny-random", seed=12, num_kv_heads=2, qkv_bias=True)
    ids = tokens(13, 1, 90)
    ref, _ = jmodel.llama_forward(jparams, jnp.asarray(ids), jcfg, compute_dtype=jnp.float32)
    got, _ = tmodel.llama_forward(tparams, torch.from_numpy(ids).long(), tcfg,
                                  compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


def test_moe_configs_name_the_roadmap_item():
    """MoE configs (once refused naming their ROADMAP item) run: the port's
    initializer makes the JAX layout, and the fp32 logits and per-layer
    ``moe_aux_loss`` of a top-2 model match the JAX package's."""
    jparams, jcfg, tparams, tcfg = make_model("tiny-random", seed=14, num_experts=4, moe_top_k=2)
    made = tmodel.init_llama_params(None, tcfg, device="cpu")
    assert {k: tuple(v.shape) for k, v in made["blocks"].items()} == \
        {k: tuple(v.shape) for k, v in tparams["blocks"].items()}
    ids = tokens(15, 2, 40)
    ref, jaux = jmodel.llama_forward(jparams, jnp.asarray(ids), jcfg, compute_dtype=jnp.float32)
    got, taux = tmodel.llama_forward(tparams, torch.from_numpy(ids).long(), tcfg,
                                     compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=0)
    np.testing.assert_allclose(taux["moe_aux_loss"].numpy(), np.asarray(jaux["moe_aux_loss"]),
                               atol=1e-4, rtol=0)


def test_init_llama_params_layout_matches_jax():
    """Same leaves, shapes and dtypes as the JAX initializer for every family
    (the values differ: the two frameworks draw other numbers from a seed)."""
    for family in FAMILIES:
        kw = dict(SMALL, **_TINY_VARIANTS[family])
        jp = jax.eval_shape(lambda: jmodel.init_llama_params(jax.random.PRNGKey(0),
                                                             jmodel.LlamaConfig(**kw)))
        gen = torch.Generator().manual_seed(0)
        tp = tmodel.init_llama_params(gen, tmodel.LlamaConfig(**kw), device="cpu")
        assert set(tp) == set(jp) and set(tp["blocks"]) == set(jp["blocks"]), family
        for k, v in tp["blocks"].items():
            assert tuple(v.shape) == jp["blocks"][k].shape and v.dtype == torch.float32
        again = tmodel.init_llama_params(torch.Generator().manual_seed(0),
                                         tmodel.LlamaConfig(**kw), device="cpu")
        assert torch.equal(again["blocks"]["q_kernel"], tp["blocks"]["q_kernel"])
    bf = tmodel.init_llama_params(None, tmodel.LlamaConfig(**SMALL), dtype=torch.bfloat16,
                                  device="cpu")
    assert bf["blocks"]["gate_kernel"].dtype == torch.bfloat16


def test_synthetic_token_stream_and_calibration_bit_identical():
    for n, vocab, seed in ((1000, 512, 0), (4096 + 7, 32000, 3)):
        got = tdata.synthetic_token_stream(n, vocab, seed=seed)
        ref = jdata.synthetic_token_stream(n, vocab, seed=seed)
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
    stream = tdata.synthetic_token_stream(1000, 512, seed=1)
    got, ref = tdata.get_calibration(stream, 5, 256), jdata.get_calibration(stream, 5, 256)
    assert len(got) == len(ref) == 3
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    assert tdata.load_wikitext2() is None and tdata.load_c4() is None
    assert tdata.load_fineweb_edu() is None


def test_save_and_load_llm_model_round_trip_with_the_jax_package(tmp_path):
    """A tree saved by either package loads in the other: plain fp32, bf16
    leaves (raw 2-byte words) and int8 codes; and as an HF directory, whose
    port export the JAX loader reads back to the same values (the quantized
    tree has no HF form)."""
    from ssp_x_vit_tpu_torch.llm.quant import quantize_llm_params_int4

    jparams, jcfg, tparams, tcfg = make_model("tiny-random-gemma2", seed=14)
    tq = quantize_llm_params_int4(tparams, tcfg)
    tq["embed"] = tq["embed"].bfloat16()
    tckpt.save_llm_model(str(tmp_path / "t"), tq, tcfg)
    back, cfg_back = tckpt.load_llm_model(str(tmp_path / "t"), device="cpu", dtype=None)
    assert cfg_back == tcfg and isinstance(cfg_back.window_layers, tuple)
    assert back["embed"].dtype == torch.bfloat16
    for k, v in tq["blocks"].items():
        assert back["blocks"][k].dtype == v.dtype and torch.equal(back["blocks"][k], v)
    jback, jcfg_back = jckpt.load_llm_model(str(tmp_path / "t"), dtype=jnp.float32)
    assert dataclasses.asdict(jcfg_back) == dataclasses.asdict(tcfg)
    np.testing.assert_array_equal(np.asarray(jback["blocks"]["q_kernel_q4"]),
                                  tq["blocks"]["q_kernel_q4"].numpy())
    jckpt.save_llm_model(str(tmp_path / "j"), jparams, jcfg)
    from_j, cfg_j = tckpt.load_llm_model(str(tmp_path / "j"), device="cpu", dtype=torch.float32)
    assert cfg_j == tcfg
    assert torch.equal(from_j["blocks"]["down_kernel"], tparams["blocks"]["down_kernel"])
    tckpt.export_hf_llama(str(tmp_path / "hf"), tparams, tcfg)
    jhf, jhf_cfg = jckpt.load_hf_llama(str(tmp_path / "hf"), dtype=jnp.float32)
    # gemma-2's config.json carries head_dim, which the loader keeps as explicit
    assert dataclasses.asdict(jhf_cfg) == dataclasses.asdict(
        dataclasses.replace(tcfg, explicit_head_dim=tcfg.head_dim))
    for k, v in tparams["blocks"].items():
        np.testing.assert_array_equal(np.asarray(jhf["blocks"][k]), v.numpy())
    with pytest.raises(ValueError, match="quantized"):
        tckpt.export_hf_llama(str(tmp_path / "hf_q"), tq, tcfg)
    assert not (tmp_path / "hf_q").exists()


def test_trained_checkpoint_logits_match_jax():
    """ckpts/code_llm_small (GQA: 6 heads over 2 KV heads) on its first 2048
    val tokens, fp32, as two windows of 1024."""
    ckpt = os.path.join(ROOT, "ckpts", "code_llm_small")
    jparams, jcfg = jckpt.load_llm_model(ckpt)
    jparams = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
    tparams, tcfg = tckpt.load_llm_model(ckpt, device="cpu", dtype=torch.float32)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    val = np.asarray(np.memmap(os.path.join(ckpt, "corpus_slice", "val.bin"), np.uint16, "r")[:2048],
                     np.int32).reshape(2, 1024)
    ref, _ = jmodel.llama_forward(jparams, jnp.asarray(val), jcfg, compute_dtype=jnp.float32)
    got, _ = tmodel.llama_forward(tparams, torch.from_numpy(val).long(), tcfg,
                                  compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=0)
    assert (got.argmax(-1).numpy() == np.asarray(ref).argmax(-1)).mean() > 0.999
