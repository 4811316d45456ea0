"""SliceGPT of the PyTorch port (``ssp_x_vit_tpu_torch/llm/slicegpt.py``)
against the JAX package on the CPU.

Tiny configs (hidden 32, 3 layers, windows of 64 tokens) of each engine: the
llama layout, the llama layout with GQA, q/k/v biases and a sliding window of
32, phi-2's parallel block and OPT. Norm scales and biases are moved off
their init values so that the fusion matters. The rotations are compared by
function, never by their weights: eigenvector signs, and the basis inside the
kept subspace, may differ between LAPACK builds.

Tolerances (fp32 forwards, fp64 rotations): the port's sliced logits against
JAX's ``slicegpt`` + ``sliced_llama_forward`` within 1e-5 absolute (measured
about 2e-7, logits of magnitude ~1); rotation-only logits against the dense
model within 5e-3 (the JAX test's own tolerance, ``tests/test_slicegpt.py``);
perplexities within 1e-6 relative; ``pca_calc`` eigenvalues within 1e-10
relative; ``random_orthogonal_upper_left`` bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssp_x_vit_tpu.llm import datasets as jdata
from ssp_x_vit_tpu.llm import model as jmodel
from ssp_x_vit_tpu.llm import slicegpt as jslice
from ssp_x_vit_tpu_torch.llm import checkpoints as tckpt
from ssp_x_vit_tpu_torch.llm import model as tmodel
from ssp_x_vit_tpu_torch.llm import slicegpt as tslice

BASE = dict(vocab_size=96, hidden_size=32, num_layers=3, num_heads=4, num_kv_heads=4,
            intermediate_size=64)
ENGINES = {
    "llama": dict(),
    "llama-gqa-window": dict(num_kv_heads=2, qkv_bias=True, sliding_window=32),
    "phi": dict(model_type="phi", qkv_bias=True, rotary_dim=4),
    "opt": dict(model_type="opt", qkv_bias=True, tie_embeddings=True, max_position_embeddings=128),
}
SEQ = 64
ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's tiny tensors: the suite runs six
    workers on the host's cores, where a pool per worker only contends."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _perturbed(tree, rng):
    """Norm scales and biases (every leaf of rank <= 2 that is not a table or
    a head) moved off 1 / 0, so the fusions have something to fold."""
    def move(path, a):
        name = path[-1].key
        if name in ("embed", "pos_embed", "lm_head") or a.ndim > 2:
            return a
        return a + 0.1 * rng.normal(size=a.shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(move, tree)


@pytest.fixture(scope="module", params=list(ENGINES))
def engine(request):
    """(name, JAX params, JAX cfg, port params, port cfg, calibration, stream)."""
    jcfg = jmodel.LlamaConfig(**dict(BASE, **ENGINES[request.param]))
    tree = jax.tree.map(np.asarray, jmodel.init_llama_params(jax.random.PRNGKey(0), jcfg,
                                                             dtype=jnp.float32))
    tree = _perturbed(tree, np.random.default_rng(1))
    stream = jdata.synthetic_token_stream(4 * SEQ, BASE["vocab_size"], seed=0)
    calib = jdata.get_calibration(stream, 3, seq_len=SEQ)
    return (request.param, jax.tree.map(jnp.asarray, tree), jcfg,
            tckpt.llm_params_from_jax(tree, device="cpu"),
            tmodel.LlamaConfig(**dataclasses.asdict(jcfg)), calib, stream)


@pytest.fixture(scope="module")
def sliced(engine):
    """Both packages' sliced models at (sparsity, orientation) pairs, and the
    phase names the port's engine announced."""
    _, jp, jc, tp, tc, calib, _ = engine
    out = {}
    for key in ((0.0, "pca"), (0.25, "pca"), (0.25, "random")):
        phases = []
        t = tslice.slicegpt(tp, tc, key[0], calib, final_orientation=key[1],
                            on_phase=phases.append)
        out[key] = (jslice.slicegpt(jp, jc, key[0], calib, final_orientation=key[1]), t, phases)
    return out


def _tokens(calib):
    return np.asarray(calib[0]), torch.from_numpy(np.asarray(calib[0]).astype(np.int64))


def test_rotation_only_is_lossless(engine, sliced):
    _, jp, jc, tp, tc, calib, _ = engine
    _, (params, scfg), phases = sliced[(0.0, "pca")]
    assert scfg.new_dim == tc.hidden_size
    jt, tt = _tokens(calib)
    dense, _ = tmodel.llama_forward(tp, tt, tc, compute_dtype=torch.float32)
    got = tslice.sliced_llama_forward(params, tt, scfg)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=5e-3, atol=5e-3)
    ref, _ = jmodel.llama_forward(jp, jnp.asarray(jt), jc, compute_dtype=jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=5e-3, atol=5e-3)
    # the sequential engines take two PCAs per layer, phi-2's one; each
    # covariance is followed by its eigh and a rotation
    pcas = 1 + tc.num_layers * (1 if tc.is_phi else 2)
    assert phases.count("covariance") == phases.count("eigh") == pcas
    assert phases[-1] is None and set(phases[:-1]) == {"capture", "covariance", "eigh", "rotation"}


@pytest.mark.parametrize("orientation", ["pca", "random"])
def test_sliced_logits_match_jax_at_25_percent(engine, sliced, orientation):
    name, _, _, _, tc, calib, _ = engine
    (jparams, jscfg), (params, scfg), _ = sliced[(0.25, orientation)]
    assert scfg.new_dim == jscfg.new_dim == 24 and scfg.last_dim == tc.hidden_size
    assert params["layers"][0]["q_kernel"].shape == (24, tc.num_heads * tc.head_dim)
    jt, tt = _tokens(calib)
    ref = np.asarray(jslice.sliced_llama_forward(jparams, jnp.asarray(jt), jscfg))
    got = tslice.sliced_llama_forward(params, tt, scfg).numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL, err_msg=name)


def test_evaluate_perplexity_sliced_matches_jax(engine, sliced):
    stream = engine[-1]
    for key in ((0.0, "pca"), (0.25, "random")):
        (jparams, jscfg), (params, scfg), _ = sliced[key]
        ref = jslice.evaluate_perplexity_sliced(jparams, jscfg, stream, seq_len=SEQ)
        got = tslice.evaluate_perplexity_sliced(params, scfg, stream, seq_len=SEQ)
        assert got == pytest.approx(ref, rel=1e-6), key


def test_sliced_forward_on_carried_weights(engine, sliced):
    """JAX's sliced tree carried across by ``sliced_params_from_jax``: the
    port's forward gives JAX's logits on the same sliced weights."""
    calib = engine[5]
    (jparams, jscfg), (params, scfg), _ = sliced[(0.25, "random")]
    carried = tckpt.sliced_params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    assert set(carried) == set(params) and len(carried["layers"]) == len(params["layers"])
    for a, b in zip(carried["layers"], params["layers"]):
        assert {k: v.shape for k, v in a.items()} == {k: v.shape for k, v in b.items()}
    jt, tt = _tokens(calib)
    ref = np.asarray(jslice.sliced_llama_forward(jparams, jnp.asarray(jt), jscfg))
    got = tslice.sliced_llama_forward(carried, tt, tslice.SlicedLlamaConfig(
        base=engine[4], new_dim=jscfg.new_dim)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_pca_calc_and_random_orthogonal_block_match_jax():
    rng = np.random.default_rng(3)
    signals = [(rng.normal(size=(1, 40, 24)) * np.linspace(0.1, 3.0, 24)).astype(np.float32)
               for _ in range(3)]
    ref_val, ref_vec = jslice.pca_calc(signals)
    val, vec = tslice.pca_calc([torch.from_numpy(s) for s in signals])
    assert val.dtype == vec.dtype == torch.float64
    np.testing.assert_allclose(val.numpy(), ref_val, rtol=1e-10)
    # eigenvectors agree up to sign (the eigenvalues here are distinct)
    np.testing.assert_allclose(np.abs(np.sum(vec.numpy() * ref_vec, axis=0)), 1.0, atol=1e-8)
    for total, upper, seed in ((32, 24, 0), (32, 32, 7), (16, 8, 10_003)):
        a = tslice.random_orthogonal_upper_left(total, upper, seed)
        b = jslice.random_orthogonal_upper_left(total, upper, seed)
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_gemma_and_qwen3_are_refused():
    for extra, match in ((dict(model_type="gemma", hidden_act="gelu_tanh", scale_embeddings=True,
                               tie_embeddings=True), "gemma"),
                         (dict(model_type="qwen3", qk_norm=True), "qwen3")):
        cfg = tmodel.LlamaConfig(**BASE, **extra)
        params = tmodel.init_llama_params(None, cfg, device="cpu")
        with pytest.raises(ValueError, match=match):
            tslice.slicegpt(params, cfg, 0.25, [np.zeros((1, SEQ), np.int32)])
        jcfg = jmodel.LlamaConfig(**BASE, **extra)
        with pytest.raises(ValueError, match=match):
            jslice.slicegpt({}, jcfg, 0.25, [])
