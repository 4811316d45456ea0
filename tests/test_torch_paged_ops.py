"""The port's paged attention, pool writes and KV quantizer against the JAX
package on the CPU (``ops/kernels/paged_attention.py`` vs
``ops/pallas/paged_attention.py``).

Inputs come from a numpy seed. The JAX side is ``paged_attention_reference``
(how the JAX package's own tests reach paged attention on the CPU), the
``paged_pool_write`` / ``paged_cache_write_many`` fallbacks, and the Pallas
write kernels in TPU interpret mode. On CPU tensors the port's wrappers run
their plain versions. Attention: atol 1e-5 in fp32 (same arithmetic, another
summation order). Quantizer codes and scales, and every written pool: bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ssp_x_vit_tpu.ops.pallas import paged_attention as jpa
from ssp_x_vit_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
from ssp_x_vit_tpu_torch.ops.kernels import paged_attention as tpa


def to_torch(pool):
    """A JAX pool (array or {"q", "s"}) as the port's, on the CPU."""
    if isinstance(pool, dict):
        return {k: torch.from_numpy(np.array(v)) for k, v in pool.items()}
    return torch.from_numpy(np.array(pool))


def assert_pools_equal(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def make_pools(rng, lead, nkv, P, ps, hd, q8):
    """K and V pools with random contents: numpy float arrays, or int8 codes
    with positive scales."""
    shape = lead + (nkv, P, ps, hd)
    if q8:
        def mk():
            return {"q": rng.integers(-127, 128, shape).astype(np.int8),
                    "s": (rng.random(shape[:-1]) * 0.05 + 0.001).astype(np.float32)}
        return mk(), mk()
    return (rng.normal(size=shape).astype(np.float32), rng.normal(size=shape).astype(np.float32))


def as_jax(pool):
    return {k: jnp.asarray(v) for k, v in pool.items()} if isinstance(pool, dict) \
        else jnp.asarray(pool)


ATTN_CASES = [  # id, b, nq, nkv, hd, ps, mp, layers, softcap, window, q8
    ("mha-4d", 3, 4, 4, 16, 4, 5, None, None, None, False),
    ("gqa-5d", 3, 8, 2, 32, 8, 3, 3, None, None, False),
    ("gqa-window", 4, 6, 2, 16, 4, 6, None, None, 7, False),
    ("softcap-5d-window", 2, 4, 2, 24, 6, 4, 2, 30.0, 5, False),
    ("int8-4d", 3, 4, 2, 16, 4, 5, None, None, None, True),
    ("int8-5d-softcap-window", 3, 8, 2, 32, 8, 3, 2, 50.0, 9, True),
    ("rep3-hd40-ps5", 2, 6, 2, 40, 5, 4, None, None, 6, False),
]


@pytest.mark.parametrize("case", ATTN_CASES, ids=[c[0] for c in ATTN_CASES])
def test_paged_attention_plain_matches_jax_reference(case):
    _, b, nq, nkv, hd, ps, mp, layers, softcap, window, q8 = case
    rng = np.random.default_rng(0)
    P = 1 + b * mp
    lead = () if layers is None else (layers,)
    layer = None if layers is None else layers - 1
    k_np, v_np = make_pools(rng, lead, nkv, P, ps, hd, q8)
    table = np.zeros((b, mp), np.int32)
    table[:] = 1 + rng.permutation(P - 1)[: b * mp].reshape(b, mp)
    lens = rng.integers(1, mp * ps + 1, size=b).astype(np.int32)
    lens[0] = 1
    starts = None if window is None else np.maximum(lens - window, 0).astype(np.int32)
    q = rng.normal(size=(b, nq, hd)).astype(np.float32)

    ref = jpa.paged_attention_reference(
        jnp.asarray(q), jpa._layer_of(as_jax(k_np), layer), jpa._layer_of(as_jax(v_np), layer),
        jnp.asarray(table), jnp.asarray(lens),
        None if starts is None else jnp.asarray(starts), softcap)
    reset_launch_counts()
    got = tpa.paged_attention(
        torch.from_numpy(q), to_torch(k_np), to_torch(v_np), torch.from_numpy(table),
        torch.from_numpy(lens), None if starts is None else torch.from_numpy(starts),
        softcap, layer)
    assert got.dtype == torch.float32 and got.shape == (b, nq, hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    assert all(n == 0 for n in launch_counts.values())  # CPU tensors launch nothing


def test_paged_attention_bf16_queries_match_jax_reference():
    """bf16 queries and pools: both sides score in fp32 and round the output
    to bf16; within one bf16 rounding of the output (atol 2e-2 at |out| <= 2)."""
    rng = np.random.default_rng(1)
    b, nq, nkv, hd, ps, mp = 2, 4, 2, 16, 4, 4
    k_np, v_np = make_pools(rng, (), nkv, 1 + b * mp, ps, hd, False)
    table = (1 + np.arange(b * mp).reshape(b, mp)).astype(np.int32)
    lens = np.array([5, 16], np.int32)
    q = rng.normal(size=(b, nq, hd)).astype(np.float32)
    ref = jpa.paged_attention_reference(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k_np, jnp.bfloat16),
        jnp.asarray(v_np, jnp.bfloat16), jnp.asarray(table), jnp.asarray(lens))
    got = tpa.paged_attention(
        torch.from_numpy(q).bfloat16(), torch.from_numpy(k_np).bfloat16(),
        torch.from_numpy(v_np).bfloat16(), torch.from_numpy(table), torch.from_numpy(lens))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), atol=2e-2)


def quantizer_rows():
    """Rows for the quantizer: random, one all-zero row, and rows whose
    quotients land on exact .5 ties (amax 127 -> scale 1, so x / scale == x)."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(6, 3, 16)).astype(np.float32)
    x[1, 2] = 0.0
    x[2, 0] = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 126.5, -126.5, 0.25, -0.75,
                        64.5, -64.5, 10.0, -127.0], np.float32)
    x[3, 1] = 3.0 * x[2, 0]  # scale 3: the same ties after the division
    return x


def test_quantize_token_kv_is_bit_identical_to_jax():
    x = quantizer_rows()
    ref_codes, ref_scale = jpa._quantize_token_kv(jnp.asarray(x))
    codes, scale = tpa.quantize_token_kv(torch.from_numpy(x))
    assert codes.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(codes.numpy(), np.asarray(ref_codes))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(ref_scale))
    assert scale[1, 2].item() == 1.0 and not codes[1, 2].any()       # the zero row
    # round-half-to-even, not half away from zero
    assert codes[2, 0].tolist()[:8] == [127, 0, 2, 2, 0, -2, -2, 4]
    # bf16 inputs quantize from their fp32 values
    xb = torch.from_numpy(x).bfloat16()
    ref_codes, ref_scale = jpa._quantize_token_kv(jnp.asarray(x, jnp.bfloat16))
    codes, scale = tpa.quantize_token_kv(xb)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(ref_codes))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(ref_scale))


@pytest.mark.parametrize("q8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("layers", [None, 3], ids=["4d", "5d"])
def test_pool_write_matches_jax_fallback_and_interpreted_pallas(q8, layers):
    """One new row per sequence, including page boundaries, two inactive
    slots colliding on trash page 0 and the quantizer's tie rows: the port's
    in-place write == the JAX package's DUS-chain fallback == its Pallas write
    kernels in interpret mode, whole pools compared."""
    rng = np.random.default_rng(3)
    b, nkv, hd, ps, P, mp = 6, 3, 16, 8, 9, 3
    lead = () if layers is None else (layers,)
    layer = None if layers is None else 1
    k_np, _ = make_pools(rng, lead, nkv, P, ps, hd, q8)
    table = rng.integers(1, P, (b, mp)).astype(np.int32)
    table[4:] = 0                                  # inactive slots: page 0, offset 0
    pos = np.array([0, 7, 8, 15, 0, 0], np.int32)
    new = quantizer_rows()                         # [6, 3, 16]
    new[4] = new[5]                                # identical rows: the collision is benign

    jpool = as_jax(k_np)
    ref = jpa.paged_pool_write(jpool, jnp.asarray(new), jnp.asarray(table), jnp.asarray(pos), layer)
    phys = jnp.asarray(table[np.arange(b), pos // ps])
    off = jnp.asarray(pos % ps)
    with pltpu.force_tpu_interpret_mode():
        kernel = jpa._pool_write_pallas_q8 if q8 else jpa._pool_write_pallas_array
        ref_kernel = kernel(jpool, jnp.asarray(new), phys, off, layer)

    pool = to_torch(k_np)
    out = tpa.paged_pool_write(pool, torch.from_numpy(new), torch.from_numpy(table),
                               torch.from_numpy(pos), layer)
    assert out is pool                              # in place, never copied
    assert_pools_equal(pool, ref)
    assert_pools_equal(pool, ref_kernel)
    # K and V together
    k2, v2 = to_torch(k_np), to_torch(k_np)
    tpa.paged_cache_write(k2, v2, torch.from_numpy(new), torch.from_numpy(-new),
                          torch.from_numpy(table), torch.from_numpy(pos), layer)
    rk, rv = jpa.paged_cache_write(jpool, jpool, jnp.asarray(new), jnp.asarray(-new),
                                   jnp.asarray(table), jnp.asarray(pos), layer)
    assert_pools_equal(k2, rk)
    assert_pools_equal(v2, rv)


@pytest.mark.parametrize("q8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("layers", [None, 2], ids=["4d", "5d"])
def test_pool_write_many_matches_jax(q8, layers):
    """The prefill write of s consecutive tokens of one sequence, from a
    non-zero start, with and without a padded tail redirected to page 0."""
    rng = np.random.default_rng(4)
    nkv, hd, ps, P, mp, s = 2, 16, 4, 8, 5, 11
    lead = () if layers is None else (layers,)
    layer = None if layers is None else 1
    k_np, v_np = make_pools(rng, lead, nkv, P, ps, hd, q8)
    table = np.array([3, 1, 7, 5, 2], np.int32)
    k_new = rng.normal(size=(s, nkv, hd)).astype(np.float32)
    v_new = rng.normal(size=(s, nkv, hd)).astype(np.float32)
    for start, valid in ((0, None), (4, None), (8, 7)):
        rk, rv = jpa.paged_cache_write_many(
            as_jax(k_np), as_jax(v_np), jnp.asarray(k_new), jnp.asarray(v_new),
            jnp.asarray(table), start, None if valid is None else jnp.asarray(valid), layer)
        gk, gv = to_torch(k_np), to_torch(v_np)
        tpa.paged_cache_write_many(gk, gv, torch.from_numpy(k_new), torch.from_numpy(v_new),
                                   torch.from_numpy(table), start, valid, layer)
        if valid is not None:  # page 0 takes the padded tail in either order: leave it out
            rk, rv, gk, gv = (trash_zeroed(p, len(lead)) for p in (rk, rv, gk, gv))
        assert_pools_equal(gk, rk)
        assert_pools_equal(gv, rv)


def trash_zeroed(pool, n_lead):
    """The pool as numpy-backed tensors with page 0 zeroed."""
    def zero(a):
        a = np.array(a)
        a[(slice(None),) * (n_lead + 1) + (0,)] = 0
        return torch.from_numpy(a)
    return {k: zero(v) for k, v in pool.items()} if isinstance(pool, dict) else zero(pool)


def test_write_then_attend_reads_the_new_token_back():
    """The decode step's order: the row written at slot ``len`` is a key of
    the attention over ``len + 1`` keys (int8 pools, 5D, against JAX)."""
    rng = np.random.default_rng(5)
    b, nq, nkv, hd, ps, mp, A = 2, 4, 2, 16, 4, 3, 2
    k_np, v_np = make_pools(rng, (A,), nkv, 1 + b * mp, ps, hd, True)
    table = (1 + np.arange(b * mp).reshape(b, mp)).astype(np.int32)
    lens = np.array([4, 9], np.int32)
    q = rng.normal(size=(b, nq, hd)).astype(np.float32)
    k_new = (10 * rng.normal(size=(b, nkv, hd))).astype(np.float32)
    v_new = rng.normal(size=(b, nkv, hd)).astype(np.float32)
    rk, rv = jpa.paged_cache_write(as_jax(k_np), as_jax(v_np), jnp.asarray(k_new),
                                   jnp.asarray(v_new), jnp.asarray(table), jnp.asarray(lens), 1)
    ref = jpa.paged_attention(jnp.asarray(q), rk, rv, jnp.asarray(table), jnp.asarray(lens + 1),
                              layer_idx=1)
    gk, gv = to_torch(k_np), to_torch(v_np)
    tpa.paged_cache_write(gk, gv, torch.from_numpy(k_new), torch.from_numpy(v_new),
                          torch.from_numpy(table), torch.from_numpy(lens), 1)
    got = tpa.paged_attention(torch.from_numpy(q), gk, gv, torch.from_numpy(table),
                              torch.from_numpy(lens + 1), layer_idx=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    stale = tpa.paged_attention(torch.from_numpy(q), to_torch(k_np), to_torch(v_np),
                                torch.from_numpy(table), torch.from_numpy(lens + 1), layer_idx=1)
    assert (got - stale).abs().max() > 1e-3        # the new row matters
