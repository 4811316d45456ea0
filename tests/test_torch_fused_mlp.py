"""The fused int8 SwiGLU MLP (``ops/kernels/quant_fused_mlp.py``) and the
serving layer that routes to it (``llm/serve.py`` ``_layer_step``) against the
JAX package on the CPU, and the CUDA kernel against its plain version on the
card (the ``cuda`` case, skipped without one).

The port's plain version against JAX's ``fused_mlp_int8`` run in interpret
mode: fp32 rtol/atol 1e-5 (other summation order); a bf16 x within 2e-2 of
max(1, max |reference|) (the plain version accumulates the bf16 products in
fp32 as the Pallas kernel does, but rounds at other places than XLA's
interpreter). The int8 llama layer at fp32 equals JAX's ``_mm`` composition to
1e-5.

The JAX package is imported inside the tests that use it, so the card-only case
runs where JAX is not installed (``pytest --noconftest -m cuda``).
"""

import numpy as np
import pytest
import torch

from ssp_x_vit_tpu_torch.llm import checkpoints as tckpt
from ssp_x_vit_tpu_torch.llm import model as tmodel
from ssp_x_vit_tpu_torch.llm import serve as tserve
from ssp_x_vit_tpu_torch.llm.quant import quantize_weight_int8
from ssp_x_vit_tpu_torch.ops import dispatch
from ssp_x_vit_tpu_torch.ops.kernels import KERNEL_NAMES, launch_counts, reset_launch_counts
from ssp_x_vit_tpu_torch.ops.kernels import quant_fused_mlp as tfm


def operands(m, d, f, seed=0):
    """numpy (x, gq, gs, uq, us, dq, ds): symmetric per-column int8 weights
    (the quantizer is the same arithmetic in both packages)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, d)).astype(np.float32)
    ws = []
    for shape in ((d, f), (d, f), (f, d)):
        q, s = quantize_weight_int8(torch.from_numpy(rng.normal(size=shape) * 0.05).float())
        ws += [q.numpy(), s.numpy()]
    return [x] + ws


@pytest.mark.parametrize("m,d,f,f_tile", [(3, 128, 256, 128), (3, 128, 200, 512),
                                          (1, 128, 256, 128), (9, 64, 128, 64)])
def test_plain_version_matches_the_pallas_kernel(m, d, f, f_tile):
    """The JAX wrapper halves f_tile until it divides f (f=200: 8-column tiles)."""
    import jax.numpy as jnp

    from ssp_x_vit_tpu.ops.pallas.quant_fused_mlp import fused_mlp_int8 as jax_fused_mlp_int8

    ops = operands(m, d, f, seed=m + f)
    ref = jax_fused_mlp_int8(*[jnp.asarray(a) for a in ops], f_tile=f_tile, interpret=True)
    got = tfm.fused_mlp_int8(*[torch.from_numpy(a) for a in ops])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    xb = jnp.asarray(ops[0], jnp.bfloat16)
    ref16 = np.asarray(jax_fused_mlp_int8(xb, *[jnp.asarray(a) for a in ops[1:]], f_tile=f_tile,
                                          interpret=True), np.float32)
    got16 = tfm.fused_mlp_int8(torch.from_numpy(ops[0]).bfloat16(),
                               *[torch.from_numpy(a) for a in ops[1:]])
    assert got16.dtype == torch.bfloat16
    assert np.abs(got16.float().numpy() - ref16).max() / max(1.0, np.abs(ref16).max()) <= 2e-2


def test_int8_llama_layer_step_matches_jax():
    """One int8 llama layer of a prefill (left-padded rows, 4D caches, fp32):
    the port routes the MLP through ``fused_mlp_int8`` and equals JAX's
    ``_mm`` composition; the packed ``gateup_kernel_q`` tree keeps the
    composition and gives the same numbers."""
    import jax
    import jax.numpy as jnp

    from ssp_x_vit_tpu.llm import model as jmodel
    from ssp_x_vit_tpu.llm import quant as jquant
    from ssp_x_vit_tpu.llm import serve as jserve

    kw = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2,
              intermediate_size=48)
    jcfg, tcfg = jmodel.LlamaConfig(**kw), tmodel.LlamaConfig(**kw)
    jparams = jquant.quantize_llm_params_int8(
        jmodel.init_llama_params(jax.random.PRNGKey(3), jcfg), jcfg)
    tparams = tckpt.llm_params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    rng = np.random.default_rng(4)
    b, s = 2, 5
    x = rng.normal(size=(b, s, 32)).astype(np.float32)
    pad_lens = np.array([0, 2], np.int32)
    gpos = np.broadcast_to(np.arange(s), (b, s)).astype(np.int32)
    rpos = np.maximum(0, gpos - pad_lens[:, None]).astype(np.int32)
    cache = np.zeros((b, 8, 2, 8), np.float32)
    jbp = {k: v[1] for k, v in jparams["blocks"].items()}
    ref, jk, jv = jserve._layer_step(
        jnp.asarray(x), jbp, jnp.asarray(cache), jnp.asarray(cache), jcfg,
        global_positions=jnp.asarray(gpos), rope_positions=jnp.asarray(rpos),
        pad_lens=jnp.asarray(pad_lens), write_pos=0, compute_dtype=jnp.float32)
    calls = []
    real = tserve.fused_mlp_int8
    for packed in (False, True):
        tp = tserve.pack_llm_params_for_serving(tparams, tcfg) if packed else tparams
        tbp = {k: v[1] for k, v in tp["blocks"].items()}
        ck, cv = torch.from_numpy(cache.copy()), torch.from_numpy(cache.copy())
        tserve.fused_mlp_int8 = lambda *a: calls.append(packed) or real(*a)
        try:
            got, ck, cv = tserve._layer_step(
                torch.from_numpy(x), tbp, ck, cv, tcfg, global_positions=torch.from_numpy(gpos),
                rope_positions=torch.from_numpy(rpos).long(),
                pad_lens=torch.from_numpy(pad_lens).long(), write_pos=0,
                compute_dtype=torch.float32)
        finally:
            tserve.fused_mlp_int8 = real
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(ck.numpy(), np.asarray(jk), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(cv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-5)
    assert calls == [False]                       # the unpacked tree only


def test_route_conditions():
    """The fused route takes unpacked int8 SwiGLU llama blocks only."""
    bp = {k: None for k in ("gate_kernel_q", "up_kernel_q", "down_kernel_q")}
    llama = tmodel.LlamaConfig()
    assert tserve._fused_int8_route(bp, llama)
    assert not tserve._fused_int8_route({"gateup_kernel_q": None, "down_kernel_q": None}, llama)
    assert not tserve._fused_int8_route({"gate_kernel": None}, llama)
    assert not tserve._fused_int8_route(bp, tmodel.LlamaConfig(hidden_act="gelu_tanh"))
    assert not tserve._fused_int8_route(bp, tmodel.LlamaConfig(model_type="gemma2"))
    assert not tserve._fused_int8_route(bp, tmodel.LlamaConfig(num_experts=2))
    dispatch.set_w8a8_enabled(True)
    try:
        assert not tserve._fused_int8_route(bp, llama)
    finally:
        dispatch.set_w8a8_enabled(False)


def test_wrapper_checks_operands_and_cpu_launches_nothing(monkeypatch):
    """CPU tensors take the plain version and count no launch; other devices
    raise; and what the wrapper refuses before a launch raises for tensors
    that claim to be on the card (``dispatch.use_kernel`` patched)."""
    assert KERNEL_NAMES[-1] == "fused_mlp_int8"
    reset_launch_counts()
    ops = [torch.from_numpy(a) for a in operands(3, 16, 24)]
    assert tfm.fused_mlp_int8(*ops).shape == (3, 16)
    assert tfm.fused_mlp_int8(ops[0][None], *ops[1:]).shape == (1, 3, 16)
    assert all(n == 0 for n in launch_counts.values())
    with pytest.raises(ValueError, match="no kernel or plain version"):
        tfm.fused_mlp_int8(ops[0].to("meta"), *ops[1:])

    monkeypatch.setattr(dispatch, "use_kernel", lambda x: True)
    x, gq, gs, uq, us, dq, ds = ops
    for bad, exc, match in (
            ((x.double(), gq, gs, uq, us, dq, ds), TypeError, "float32 or bfloat16"),
            ((x.t(), gq, gs, uq, us, dq, ds), ValueError, "x must be contiguous"),
            ((x[:0], gq, gs, uq, us, dq, ds), ValueError, "empty"),
            ((x, gq.float(), gs, uq, us, dq, ds), ValueError, "gate_q must be int8"),
            ((x, gq, gs, uq[:, :8], us, dq, ds), ValueError, "up_q must be int8"),
            ((x, gq, gs, uq, us, dq.t(), ds), ValueError, "down_q must be int8"),
            ((x, gq, gs.double(), uq, us, dq, ds), ValueError, "gate_scale must be float32"),
            ((x, gq, gs, uq, us, dq, ds[:4]), ValueError, "down_scale must be float32"),
            ((x, gq, gs, uq, us, dq.t().contiguous().t(), ds), ValueError, "contiguous"),
            ((x, gq, gs, uq, us.to("meta"), dq, ds), ValueError, "is on meta")):
        with pytest.raises(exc, match=match):
            tfm.fused_mlp_int8(*bad)
    assert all(n == 0 for n in launch_counts.values())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m cuda tests/test_torch_fused_mlp.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
def test_kernel_matches_plain_version_on_the_card(cuda_device, dtype, tol):
    """Skinny (m <= 16: the bf16 weight stream, the fp32 SIMT product) and
    tensor-core (m > 16) paths at ragged widths (f off 8 and 16, d off 8), and
    every m from 1 to 16 at a width off TMA's 16-byte rules (d = 200, f = 333:
    element loads) and at one that meets them (d = 256, f = 512); one launch
    per call, the same bits on a second run; tolerance on max |diff| /
    max(1, max |plain|)."""
    reset_launch_counts()
    shapes = [(1, 256, 512), (8, 200, 333), (13, 96, 72), (17, 128, 250), (130, 264, 1000)]
    shapes += [(m, d, f) for d, f in ((200, 333), (256, 512)) for m in range(1, 17)]
    for m, d, f in shapes:
        x, *ws = [torch.from_numpy(a).to(cuda_device) for a in operands(m, d, f, seed=m)]
        x = x.to(dtype)
        got, again = tfm.fused_mlp_int8(x, *ws), tfm.fused_mlp_int8(x, *ws)
        ref = tfm.fused_mlp_int8_plain(x, *ws)
        assert torch.isfinite(got.float()).all() and torch.equal(got, again)
        err = (got.float() - ref.float()).abs().max().item()
        assert err / max(1.0, ref.float().abs().max().item()) <= tol, (m, d, f, err)
    assert launch_counts["fused_mlp_int8"] == 2 * len(shapes)
