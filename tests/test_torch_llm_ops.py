"""LLM ops of the PyTorch port against the JAX package on the CPU.

Inputs come from a numpy seed and go to both packages. The plain versions of
the flash-attention and dequant-GEMM kernels (the CPU side of
``ssp_x_vit_tpu_torch/ops/kernels``) are held against the Pallas kernels run
in interpret mode. Tolerances: attention atol = rtol = 2e-5 in fp32 (another
summation order), products atol = rtol = 1e-5, packed bytes and quantized
codes bit-identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ssp_x_vit_tpu.llm import rope as jrope
from ssp_x_vit_tpu.ops import attention as jattn
from ssp_x_vit_tpu.ops import common as jcommon
from ssp_x_vit_tpu.ops import dispatch as jdispatch
from ssp_x_vit_tpu.ops.pallas import flash_attention as jflash
from ssp_x_vit_tpu.ops.pallas import quant_matmul as jqm
from ssp_x_vit_tpu_torch.llm import rope as trope
from ssp_x_vit_tpu_torch.ops import attention as tattn
from ssp_x_vit_tpu_torch.ops import common as tcommon
from ssp_x_vit_tpu_torch.ops import dispatch as tdispatch
from ssp_x_vit_tpu_torch.ops.kernels import flash_attention as tflash
from ssp_x_vit_tpu_torch.ops.kernels import quant_matmul as tqm

ATTN_TOL = dict(rtol=2e-5, atol=2e-5)
MM_TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a, dtype=np.float32):
    return torch.from_numpy(np.asarray(a, dtype))


def _j(a, dtype=np.float32):
    return jnp.asarray(np.asarray(a, dtype))


def _qkv(seed, b, h, hkv, s, hd):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, s, hd)), rng.normal(size=(b, hkv, s, hd)),
            rng.normal(size=(b, hkv, s, hd)))


FLASH_CASES = [  # b, h, hkv, s, hd, causal, window, softcap
    pytest.param(2, 4, 4, 197, 64, False, None, None, id="noncausal-ragged"),
    pytest.param(1, 2, 2, 160, 32, True, None, None, id="causal"),
    pytest.param(1, 6, 2, 130, 16, True, None, None, id="causal-gqa"),
    pytest.param(1, 4, 2, 200, 32, True, 48, None, id="gqa-window"),
    pytest.param(1, 2, 2, 96, 32, True, None, 50.0, id="softcap"),
    pytest.param(1, 4, 1, 150, 16, True, 64, 30.0, id="gqa-window-softcap"),
]


@pytest.mark.parametrize("b,h,hkv,s,hd,causal,window,softcap", FLASH_CASES)
def test_flash_attention_plain_matches_pallas_interpret(b, h, hkv, s, hd, causal, window, softcap):
    q, k, v = _qkv(0, b, h, hkv, s, hd)
    with pltpu.force_tpu_interpret_mode():
        ref = jflash.flash_attention(_j(q), _j(k), _j(v), causal=causal, window=window,
                                     softcap=softcap)
    kw = dict(causal=causal, window=window, softcap=softcap)
    plain = tflash.flash_attention_plain(_t(q), _t(k), _t(v), **kw)
    np.testing.assert_allclose(plain.numpy(), np.asarray(ref), **ATTN_TOL)
    # the public entry takes the plain version for a CPU tensor: same numbers
    entry = tattn.flash_attention(_t(q), _t(k), _t(v), **kw)
    assert torch.equal(entry, plain)


@pytest.mark.parametrize("causal,window,softcap", [(False, None, None), (True, None, None),
                                                   (True, 20, None), (True, None, 50.0)])
def test_sdpa_reference_matches_jax(causal, window, softcap):
    q, k, v = _qkv(1, 2, 3, 3, 57, 16)
    got = tattn.sdpa_reference(_t(q), _t(k), _t(v), causal=causal, window=window, softcap=softcap)
    ref = jattn.sdpa_reference(_j(q), _j(k), _j(v), causal=causal, window=window, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_flash_attention_argument_checks_match_jax():
    q, k, v = (_t(a) for a in _qkv(2, 1, 4, 4, 32, 16))
    for mod, conv in ((tattn, lambda a: a), (jflash, lambda a: jnp.asarray(a.numpy()))):
        qq, kk, vv = conv(q), conv(k), conv(v)
        with pytest.raises(ValueError, match="multiple of num_kv_heads"):
            mod.flash_attention(qq, kk[:, :3], vv[:, :3])
        with pytest.raises(ValueError, match="requires causal"):
            mod.flash_attention(qq, kk, vv, window=8)
        with pytest.raises(ValueError, match="window must be >= 1"):
            mod.flash_attention(qq, kk, vv, causal=True, window=0)
    with pytest.raises(ValueError, match="requires causal"):
        tattn.sdpa_reference(q, k, v, window=8)
    # a window of at least s is full causal attention
    full = tattn.flash_attention(q, k, v, causal=True)
    assert torch.equal(tattn.flash_attention(q, k, v, causal=True, window=32), full)


def test_multi_head_attention_causal_matches_jax():
    rng = np.random.default_rng(3)
    d, heads = 48, 3
    x = rng.normal(size=(2, 19, d))
    wqkv, bqkv = rng.normal(size=(d, 3 * d)) * 0.1, rng.normal(size=3 * d) * 0.1
    wo, bo = rng.normal(size=(d, d)) * 0.1, rng.normal(size=d) * 0.1
    for use_flash in (None, False, True):  # on the CPU all three are the plain attention
        got = tattn.multi_head_attention(_t(x), _t(wqkv), _t(bqkv), _t(wo), _t(bo), heads,
                                         causal=True, use_flash=use_flash)
        ref = jattn.multi_head_attention(_j(x), _j(wqkv), _j(bqkv), _j(wo), _j(bo), heads,
                                         causal=True, use_flash=False)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k,n", [(64, 48), (30, 17), (2, 5)])
def test_pack_unpack_int4_bit_identical(k, n):
    rng = np.random.default_rng(4)
    q4 = rng.integers(-8, 8, size=(3, k, n)).astype(np.int8)
    packed = tqm.pack_int4(torch.from_numpy(q4))
    ref = np.asarray(jqm.pack_int4(jnp.asarray(q4)))
    assert packed.dtype == torch.int8
    np.testing.assert_array_equal(packed.numpy(), ref)
    np.testing.assert_array_equal(tqm.unpack_int4(packed).numpy(), q4)
    np.testing.assert_array_equal(np.asarray(jqm.unpack_int4(jnp.asarray(ref))), q4)
    with pytest.raises(ValueError, match="even K"):
        tqm.pack_int4(torch.zeros(3, 5, dtype=torch.int8))


@pytest.mark.parametrize("shape", [(32, 24), (4, 32, 24), (2, 3, 16, 8)])
def test_quantize_weight_int4_bit_identical(shape):
    rng = np.random.default_rng(5)
    w = rng.normal(size=shape).astype(np.float32)
    w[..., 3] = 0.0  # an all-zero output channel takes scale 1
    w_p, scale = tqm.quantize_weight_int4(torch.from_numpy(w))
    ref_p, ref_s = jqm.quantize_weight_int4(jnp.asarray(w))
    np.testing.assert_array_equal(w_p.numpy(), np.asarray(ref_p))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(ref_s))


@pytest.mark.parametrize("lead,k,n", [((5,), 64, 128), ((2, 7), 32, 48), ((1,), 256, 128)])
def test_quant_matmuls_plain_match_pallas_interpret(lead, k, n):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(*lead, k)).astype(np.float32)
    w = (rng.normal(size=(k, n)) * 0.05).astype(np.float32)
    w_p, s4 = jqm.quantize_weight_int4(jnp.asarray(w))
    ref4 = jqm.quant4_matmul(_j(x), w_p, s4, unpack="int32", interpret=True)
    got4 = tqm.quant4_matmul_plain(_t(x), torch.from_numpy(np.asarray(w_p)),
                                   torch.from_numpy(np.asarray(s4)))
    np.testing.assert_allclose(got4.numpy(), np.asarray(ref4), **MM_TOL)
    w_q = rng.integers(-127, 128, size=(k, n)).astype(np.int8)
    s8 = (rng.random(n) * 0.01 + 0.001).astype(np.float32)
    ref8 = jqm.quant_matmul(_j(x), jnp.asarray(w_q), jnp.asarray(s8), interpret=True)
    got8 = tqm.quant_matmul_plain(_t(x), torch.from_numpy(w_q), torch.from_numpy(s8))
    np.testing.assert_allclose(got8.numpy(), np.asarray(ref8), **MM_TOL)
    # the wrappers take the plain versions for CPU tensors
    assert torch.equal(tqm.quant_matmul(_t(x), torch.from_numpy(w_q), torch.from_numpy(s8)), got8)


def test_quant_matmul_plain_bf16_rounds_like_the_contract():
    """bf16 activations: fp32 accumulation of x @ w.to(bf16), times the fp32
    scale, one rounding to bf16 at the store."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(9, 64)).astype(np.float32)).bfloat16()
    w_q = torch.from_numpy(rng.integers(-127, 128, size=(64, 32)).astype(np.int8))
    s = torch.from_numpy((rng.random(32) * 0.01 + 0.001).astype(np.float32))
    got = tqm.quant_matmul_plain(x, w_q, s)
    want = ((x.float() @ w_q.float()) * s).bfloat16()
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


@pytest.mark.parametrize("variant", ["plain", "q", "q4", "w8a8"])
def test_mm_quant_matches_jax(variant):
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 11, 64)).astype(np.float32)
    w = (rng.normal(size=(64, 48)) * 0.05).astype(np.float32)
    if variant == "plain":
        jbp = {"w": jnp.asarray(w)}
    elif variant == "q4":
        w_p, s = jqm.quantize_weight_int4(jnp.asarray(w))
        jbp = {"w_q4": w_p, "w_scale": s}
    else:
        from ssp_x_vit_tpu.llm.quant import quantize_weight_int8

        w_q, s = quantize_weight_int8(jnp.asarray(w))
        jbp = {"w_q": w_q, "w_scale": s}
    tbp = {k: torch.from_numpy(np.asarray(v)) for k, v in jbp.items()}
    try:
        jdispatch.set_w8a8_enabled(variant == "w8a8")
        tdispatch.set_w8a8_enabled(variant == "w8a8")
        assert tdispatch.use_w8a8() == (variant == "w8a8")
        ref = jcommon.mm_quant(_j(x), jbp, "w", jnp.float32)
        got = tcommon.mm_quant(_t(x), tbp, "w", torch.float32)
    finally:
        jdispatch.set_w8a8_enabled(False)
        tdispatch.set_w8a8_enabled(False)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **MM_TOL)


@pytest.mark.parametrize("scaling", [
    None,
    dict(rope_type="linear", factor=4.0),
    dict(rope_type="llama3", factor=8.0, low_freq_factor=1.0, high_freq_factor=4.0,
         original_max_position_embeddings=8192),
    dict(rope_type="yarn", factor=4.0, original_max_position_embeddings=4096),
    dict(rope_type="yarn", factor=40.0, mscale=1.0, mscale_all_dim=0.8, beta_fast=32.0,
         beta_slow=1.0, original_max_position_embeddings=4096),
])
def test_rope_freqs_match_jax(scaling):
    tsc, jsc = trope.parse_rope_scaling(scaling), jrope.parse_rope_scaling(scaling)
    for rd in (16, 64, 128):
        got, got_scale = trope.rope_freqs(10000.0, rd, tsc)
        ref, ref_scale = jrope.rope_freqs(10000.0, rd, jsc)
        np.testing.assert_array_equal(got, ref)
        assert got_scale == ref_scale
    assert trope.export_rope_scaling(tsc) == jrope.export_rope_scaling(jsc)
    with pytest.raises(ValueError, match="unsupported"):
        trope.parse_rope_scaling({"rope_type": "dynamic", "factor": 2.0})
