"""The port's ring attention and sequence-parallel perplexity
(``parallel/ring_attention.py``) against the JAX package.

The port runs in one gloo world of 4 CPU processes (``torch_parallel_workers``)
on the (1, 4) and (2, 2) ``(data, seq)`` meshes; JAX runs its ``shard_map``
ring on a (2, 4) mesh of the conftest's virtual devices. Everything is fp32.

- ``ring_attention``: causal, GQA, a window binding across chunk edges, a
  softcap, a value width other than the key width with a custom scale,
  within 1e-5 of JAX's ring and of ``sdpa_reference``; the virtual ring (the
  same hops over chunks held in one process) on the same cases at N = 1, 2,
  4 and 8;
- the hop's plain version (``flash_attention_plain(q_offset=, with_lse=True)``)
  against the band shifted by the offset computed in float64, a row with no
  key included (output 0, lse -inf), and ``hop_mask``'s skips;
- ``evaluate_perplexity_seq_parallel``: tiny llama (GQA), phi (partial
  rotary, biases), gemma-2 (mixed windows, softcaps, tied head) and a uniform
  window, within 1e-5 in log of JAX's own sequence-parallel perplexity; the
  per-window NLL sums within rtol 1e-5 of JAX's single-device forward;
- the OPT and sequence-length refusals with JAX's messages.
"""

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P
from torch_parallel_workers import run_world

from ssp_x_vit_tpu.llm import model as jmodel
from ssp_x_vit_tpu.ops.attention import sdpa_reference as j_sdpa
from ssp_x_vit_tpu_torch.llm import model as tmodel
from ssp_x_vit_tpu_torch.ops.kernels import flash_attention as tflash
from ssp_x_vit_tpu_torch.parallel import ring_attention as tring

# the package exports a function of the module's name: take the module itself
jring = importlib.import_module("ssp_x_vit_tpu.parallel.ring_attention")
B, H, S, HD = 2, 4, 32, 8
ATTN = {
    "causal": dict(hkv=4, window=None, softcap=None, scale=None, vd=HD),
    "gqa": dict(hkv=2, window=None, softcap=None, scale=None, vd=HD),
    "window_softcap": dict(hkv=2, window=6, softcap=5.0, scale=None, vd=HD),
    "wide_window": dict(hkv=1, window=12, softcap=None, scale=None, vd=HD),
    "value_width_scale": dict(hkv=2, window=None, softcap=None, scale=0.3, vd=5),
}
BASE = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2,
            intermediate_size=48)
PPL = {
    "llama": dict(),
    "phi": dict(model_type="phi", qkv_bias=True, rotary_dim=4, num_kv_heads=4),
    "gemma2": dict(model_type="gemma2", num_layers=4, vocab_size=96, intermediate_size=64,
                   explicit_head_dim=16, hidden_act="gelu_tanh", scale_embeddings=True,
                   tie_embeddings=True, sliding_window=6, window_layers=(0, 2),
                   attn_softcap=50.0, final_softcap=30.0),
    "uniform_window": dict(sliding_window=10),
}
SEQ = 64


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def attn_case(name):
    c = ATTN[name]
    rng = np.random.default_rng(sorted(ATTN).index(name))
    q = rng.standard_normal((B, H, S, HD)).astype(np.float32)
    k = rng.standard_normal((B, c["hkv"], S, HD)).astype(np.float32)
    v = rng.standard_normal((B, c["hkv"], S, c["vd"])).astype(np.float32)
    return dict(q=q, k=k, v=v, window=c["window"], softcap=c["softcap"], scale=c["scale"])


def reference(c):
    """sdpa over repeated K/V in float64 (custom scale and value width included)."""
    rep = H // c["k"].shape[1]
    q, k, v = (c[x].astype(np.float64) for x in "qkv")
    k, v = np.repeat(k, rep, axis=1), np.repeat(v, rep, axis=1)
    scale = c["scale"] if c["scale"] is not None else 1 / math.sqrt(HD)
    s_ = np.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if c["softcap"] is not None:
        s_ = c["softcap"] * np.tanh(s_ / c["softcap"])
    i = np.arange(S)
    keep = i[None, :] <= i[:, None]
    if c["window"] is not None:
        keep &= i[:, None] - i[None, :] < c["window"]
    s_ = np.where(keep, s_, -np.inf)
    w = np.exp(s_ - s_.max(-1, keepdims=True))
    return np.einsum("bhqk,bhkd->bhqd", w / w.sum(-1, keepdims=True), v)


def make_tree(name, seed):
    kw = dict(BASE, **PPL[name])
    shapes = jax.eval_shape(lambda: jmodel.init_llama_params(jax.random.PRNGKey(0),
                                                             jmodel.LlamaConfig(**kw)))
    rng = np.random.default_rng(seed)

    def leaf(k, shape):
        if k.endswith("bias"):
            return (0.1 * rng.normal(size=shape)).astype(np.float32)
        if k.startswith("ln") or k.endswith("_norm"):
            return (1 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        return (0.08 * rng.normal(size=shape)).astype(np.float32)

    tree = {k: ({kk: leaf(kk, vv.shape) for kk, vv in v.items()} if isinstance(v, dict)
                else leaf(k, v.shape)) for k, v in shapes.items()}
    return tree, kw


@pytest.fixture(scope="module")
def cases():
    ppl = {}
    for i, name in enumerate(PPL):
        tree, kw = make_tree(name, 40 + i)
        ids = np.random.default_rng(50 + i).integers(0, kw["vocab_size"], 3 * SEQ)
        ppl[name] = dict(cfg=kw, params=tree, stream=ids, seq_len=SEQ,
                         windows=ids[:2 * SEQ].reshape(2, SEQ))
    return {"attn": {n: attn_case(n) for n in ATTN}, "ppl": ppl,
            "opt_cfg": dict(BASE, model_type="opt", qkv_bias=True)}


@pytest.fixture(scope="module")
def world(cases, tmp_path_factory):
    return run_world(tmp_path_factory.mktemp("ring_world"), 4, "ring", cases)


@pytest.fixture(scope="module")
def jax_mesh():
    return Mesh(np.asarray(jax.devices()[:8]).reshape(2, 4), ("data", "seq"))


def jax_ring(c, mesh):
    spec = P(None, None, "seq", None)
    fn = jax.shard_map(
        lambda q, k, v: jring.ring_attention(q, k, v, "seq", n_chunks=4, causal=True,
                                             window=c["window"], softcap=c["softcap"],
                                             scale=c["scale"]),
        mesh=mesh, in_specs=(spec,) * 3, out_specs=spec, check_vma=False)
    return np.asarray(jax.jit(fn)(*(jnp.asarray(c[x]) for x in "qkv")))


@pytest.mark.parametrize("name", list(ATTN))
def test_ring_attention_matches_jax(world, cases, jax_mesh, name):
    c = cases["attn"][name]
    want = jax_ring(c, jax_mesh)
    ref = reference(c)
    np.testing.assert_allclose(want, ref, atol=1e-5)
    if c["scale"] is None and ATTN[name]["vd"] == HD:
        rep = H // ATTN[name]["hkv"]
        k, v = (jnp.repeat(jnp.asarray(c[x]), rep, axis=1) for x in "kv")
        sdpa = j_sdpa(jnp.asarray(c["q"]), k, v, causal=True, window=c["window"],
                      softcap=c["softcap"])
        np.testing.assert_allclose(want, np.asarray(sdpa), atol=1e-5)
    for out in world:
        for mesh in ("1x4", "2x2"):
            np.testing.assert_allclose(out[f"attn_{mesh}_{name}"], want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", list(ATTN))
def test_virtual_ring_matches_reference(cases, name):
    c = cases["attn"][name]
    ref = reference(c)
    q, k, v = (torch.from_numpy(c[x]) for x in "qkv")
    for n in (1, 2, 4, 8):
        got = tring.virtual_ring_attention(q, k, v, n_chunks=n, window=c["window"],
                                           softcap=c["softcap"], scale=c["scale"])
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    if c["scale"] is None and ATTN[name]["vd"] == HD:   # the kernel's plain version, whole
        whole = tflash.flash_attention_plain(q, k, v, causal=True, window=c["window"],
                                             softcap=c["softcap"])
        np.testing.assert_allclose(whole.numpy(), ref, atol=1e-5)


@pytest.mark.parametrize("off,window,softcap", [(0, None, None), (16, None, None),
                                                (16, 20, None), (32, 40, 5.0), (16, 16, None)])
def test_plain_hop_at_an_offset(off, window, softcap):
    """``flash_attention_plain`` with a query offset: row r sits at key position
    r + off; (out, lse) against the shifted band in float64."""
    rng = np.random.default_rng(off)
    sl = 16
    q = rng.standard_normal((1, 4, sl, HD)).astype(np.float32)
    k = rng.standard_normal((1, 2, sl, HD)).astype(np.float32)
    v = rng.standard_normal((1, 2, sl, HD)).astype(np.float32)
    out, lse = tflash.flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=True,
        window=window, softcap=softcap, q_offset=off, with_lse=True)
    kk, vv = np.repeat(k, 2, 1).astype(np.float64), np.repeat(v, 2, 1).astype(np.float64)
    s_ = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), kk) / math.sqrt(HD)
    if softcap is not None:
        s_ = softcap * np.tanh(s_ / softcap)
    qi, ki = np.arange(sl)[:, None] + off, np.arange(sl)[None, :]
    keep = ki <= qi
    if window is not None:
        keep &= qi - ki < window
    s_ = np.where(keep, s_, -np.inf)
    with np.errstate(invalid="ignore", divide="ignore"):
        m = s_.max(-1, keepdims=True)
        w = np.where(np.isfinite(m), np.exp(s_ - np.where(np.isfinite(m), m, 0)), 0.0)
        l = w.sum(-1, keepdims=True)
        want_lse = np.where(l[..., 0] > 0, np.log(l[..., 0]) + m[..., 0], -np.inf)
        want = np.einsum("bhqk,bhkd->bhqd", np.where(l > 0, w / np.maximum(l, 1e-300), 0), vv)
    np.testing.assert_allclose(out.numpy(), want, atol=1e-5)
    np.testing.assert_array_equal(np.isinf(lse.numpy()), np.isinf(want_lse))
    fin = np.isfinite(want_lse)
    np.testing.assert_allclose(lse.numpy()[fin], want_lse[fin], atol=1e-5)
    if window == 16:   # row 15 (position 31) sees no key of 0..15: 0 out, -inf lse
        assert np.isinf(want_lse).any() and not np.isinf(want_lse).all()


def test_hop_mask_skips():
    """Hops above the diagonal and windowed hops whose band misses every key
    are skipped; a band covering the whole chunk pair runs unmasked."""
    assert tring.hop_mask(0, 1, 16) is None
    assert tring.hop_mask(2, 2, 16) == (0, True, None)
    assert tring.hop_mask(2, 2, 16, window=4) == (0, True, 4)
    assert tring.hop_mask(3, 1, 16) == (0, False, None)
    assert tring.hop_mask(3, 1, 16, window=20) == (32, True, 20)
    assert tring.hop_mask(3, 1, 16, window=17) is None          # 32 - 15 >= 17
    assert tring.hop_mask(3, 1, 16, window=18) == (32, True, 18)
    assert tring.hop_mask(3, 1, 16, window=48) == (0, False, None)   # 32 + 15 < 48


@pytest.mark.parametrize("name", ["llama", "phi"])
def test_rope_at_global_positions_matches_jax(cases, name):
    """``_rope_at``: rope of a chunk at its global positions (phi: the first
    rotary_dim dims only) equals JAX's."""
    kw = cases["ppl"][name]["cfg"]
    rng = np.random.default_rng(7)
    hd = kw["hidden_size"] // kw["num_heads"]
    q = rng.standard_normal((1, 4, 8, hd)).astype(np.float32)
    k = rng.standard_normal((1, kw["num_kv_heads"], 8, hd)).astype(np.float32)
    pos = np.arange(40, 48)
    jq, jk = jring._rope_at(jnp.asarray(q), jnp.asarray(k), jmodel.LlamaConfig(**kw),
                            jnp.asarray(pos))
    tq, tk = tring._rope_at(torch.from_numpy(q), torch.from_numpy(k),
                            tmodel.LlamaConfig(**kw), torch.from_numpy(pos))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-6)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-6)


@pytest.mark.parametrize("name", list(PPL))
def test_seq_parallel_perplexity_matches_jax(world, cases, jax_mesh, name):
    c = cases["ppl"][name]
    jp = jax.tree.map(jnp.asarray, c["params"])
    jcfg = jmodel.LlamaConfig(**c["cfg"])
    want = jring.evaluate_perplexity_seq_parallel(jp, jcfg, jax_mesh, c["stream"], seq_len=SEQ)
    windows = jnp.asarray(c["windows"].astype(np.int32))
    logits, _ = jmodel.llama_forward(jp, windows, jcfg, compute_dtype=jnp.float32)
    logp = jax.nn.log_softmax(logits[:, :-1], axis=-1)
    nll = -np.asarray(jnp.take_along_axis(logp, windows[:, 1:, None], axis=-1)[..., 0].sum(1))
    for out in world:
        for mesh in ("1x4", "2x2"):
            assert abs(np.log(out[f"ppl_{mesh}_{name}"]) - np.log(want)) < 1e-5
            np.testing.assert_allclose(out[f"nll_{mesh}_{name}"], nll, rtol=1e-5)


def test_refusals_match_jax(world, cases, jax_mesh):
    with pytest.raises(ValueError) as opt:
        jring.make_seq_parallel_nll(jax_mesh, jmodel.LlamaConfig(**cases["opt_cfg"]))
    c = cases["ppl"]["llama"]
    run = jring.make_seq_parallel_nll(jax_mesh, jmodel.LlamaConfig(**c["cfg"]))
    with pytest.raises(ValueError) as seq:
        run(jax.tree.map(jnp.asarray, c["params"]), jnp.zeros((2, 6), jnp.int32))
    for out in world:
        assert out["refuse_opt"] == str(opt.value)
        assert out["refuse_seq"] == str(seq.value)
