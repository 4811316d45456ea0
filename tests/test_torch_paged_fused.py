"""The port's write-and-attend call (``ops/kernels/paged_attention.py``
``paged_attention_write``) against the JAX package on the CPU: its
``paged_cache_write`` then ``paged_attention`` over ``positions + 1`` keys.

Inputs come from a numpy seed. On CPU tensors the port runs its plain version
(the two plain writes, then the plain attention). The JAX side is the
package's own CPU path (the write fallback and ``paged_attention_reference``)
and, in one case, its Pallas write and attention kernels in TPU interpret
mode. Pools bit for bit (int8 codes and scales exact); outputs within 1e-5
in fp32 (same arithmetic, another summation order) and 2e-2 in bf16 (one bf16
rounding of outputs of magnitude <= 2, at other places).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ssp_x_vit_tpu.llm import model as jmodel
from ssp_x_vit_tpu.llm import paged as jpaged
from ssp_x_vit_tpu.ops.pallas import paged_attention as jpa
from ssp_x_vit_tpu_torch.llm import checkpoints as tckpt
from ssp_x_vit_tpu_torch.llm import model as tmodel
from ssp_x_vit_tpu_torch.llm import paged as tpaged
from ssp_x_vit_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
from ssp_x_vit_tpu_torch.ops.kernels import paged_attention as tpa

DTYPES = {"float32": (np.float32, jnp.float32, torch.float32),
          "bfloat16": (np.float32, jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def to_jax(a, dtype):
    if isinstance(a, dict):
        return {k: jnp.asarray(v) for k, v in a.items()}
    return jnp.asarray(a, DTYPES[dtype][1])


def to_torch(a, dtype):
    if isinstance(a, dict):
        return {k: torch.from_numpy(v.copy()) for k, v in a.items()}
    return torch.from_numpy(a.copy()).to(DTYPES[dtype][2])


def as_numpy(pool):
    """A pool of either package as float32 numpy arrays (int8 codes stay int8)."""
    if isinstance(pool, dict):
        return {k: as_numpy(v) for k, v in pool.items()}
    if isinstance(pool, torch.Tensor):
        return pool.numpy() if pool.dtype == torch.int8 else pool.float().numpy()
    return np.asarray(pool) if pool.dtype == jnp.int8 else np.asarray(pool, np.float32)


def assert_pools_equal(got, want, keep=None):
    """Bit for bit; ``keep(a)`` selects the part of each array to compare."""
    got, want = as_numpy(got), as_numpy(want)
    pairs = [(got[k], want[k]) for k in want] if isinstance(want, dict) else [(got, want)]
    for g, w in pairs:
        if keep is not None:
            g, w = keep(g), keep(w)
        np.testing.assert_array_equal(g, w)


def make_pools(rng, lead, nkv, P, ps, hd, pool):
    shape = lead + (nkv, P, ps, hd)
    if pool == "int8":
        def mk():
            return {"q": rng.integers(-127, 128, shape).astype(np.int8),
                    "s": (rng.random(shape[:-1]) * 0.05 + 0.001).astype(np.float32)}
        return mk(), mk()
    return rng.normal(size=shape).astype(np.float32), rng.normal(size=shape).astype(np.float32)


def edge_positions(b, nq, nkv, hd, ps, mp):
    """Slot 0, a page boundary, a run's last key, a run boundary and the key
    after it (runs of more than one page, as the card's split plan cuts this
    table on a card of a few SMs), and the table's last slot."""
    runs = [tpa.split_plan(b, nkv, nq, hd, ps, mp, sms).pages_per_split * ps
            for sms in (1, 2, 4, 8, 16)]
    run = next(r for r in runs if ps < r < mp * ps)
    return np.array([0, ps, run - 1, run, run + 1, mp * ps - 1], np.int32)


CASES = [  # id, nq, nkv, hd, ps, mp, layers, softcap, window, pool, q dtype, new-row dtype
    ("fp32-4d", 4, 2, 16, 4, 8, None, None, None, "float32", "float32", "float32"),
    ("fp32-5d-softcap-window", 6, 2, 24, 4, 8, 3, 30.0, 6, "float32", "float32", "float32"),
    ("fp32-rep8-hd40-ps5", 8, 1, 40, 5, 7, None, None, None, "float32", "float32", "float32"),
    ("bf16-5d", 8, 2, 32, 4, 8, 2, None, None, "bfloat16", "bfloat16", "bfloat16"),
    ("bf16-pool-fp32-rows-window", 4, 4, 16, 4, 8, None, None, 5, "bfloat16", "bfloat16",
     "float32"),
    ("int8-4d", 4, 2, 16, 4, 8, None, None, None, "int8", "float32", "float32"),
    ("int8-5d-softcap-window-bf16", 8, 2, 32, 4, 8, 2, 50.0, 9, "int8", "bfloat16", "bfloat16"),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_write_attend_matches_jax_write_then_attend(case):
    _, nq, nkv, hd, ps, mp, layers, softcap, window, pool, qd, nd = case
    rng = np.random.default_rng(0)
    b = 6
    P = 1 + b * mp
    lead = () if layers is None else (layers,)
    layer = None if layers is None else layers - 1
    k_np, v_np = make_pools(rng, lead, nkv, P, ps, hd, pool)
    table = (1 + rng.permutation(P - 1)).reshape(b, mp).astype(np.int32)
    pos = edge_positions(b, nq, nkv, hd, ps, mp)
    starts = None if window is None else np.maximum(pos + 1 - window, 0).astype(np.int32)
    q = rng.normal(size=(b, nq, hd)).astype(np.float32)
    k_new = (3 * rng.normal(size=(b, nkv, hd))).astype(np.float32)
    v_new = rng.normal(size=(b, nkv, hd)).astype(np.float32)
    k_new[1, 0] = 0.0  # a zero row: scale 1, codes 0

    pdt = "bfloat16" if pool == "bfloat16" else "float32"
    rk, rv = jpa.paged_cache_write(to_jax(k_np, pdt), to_jax(v_np, pdt), to_jax(k_new, nd),
                                   to_jax(v_new, nd), jnp.asarray(table), jnp.asarray(pos), layer)
    ref = jpa.paged_attention(to_jax(q, qd), rk, rv, jnp.asarray(table), jnp.asarray(pos + 1),
                              None if starts is None else jnp.asarray(starts), softcap, layer)
    gk, gv = to_torch(k_np, pdt), to_torch(v_np, pdt)
    reset_launch_counts()
    got = tpa.paged_attention_write(to_torch(q, qd), to_torch(k_new, nd), to_torch(v_new, nd),
                                    gk, gv, torch.from_numpy(table), torch.from_numpy(pos),
                                    None if starts is None else torch.from_numpy(starts),
                                    softcap, layer)
    assert all(n == 0 for n in launch_counts.values())  # CPU tensors launch nothing
    assert got.dtype == DTYPES[qd][2] and got.shape == (b, nq, hd)
    assert_pools_equal(gk, rk)
    assert_pools_equal(gv, rv)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), atol=TOL[qd],
                               rtol=0)
    # the written key is scored: the same call on the pools as they were differs
    stale = tpa.paged_attention(to_torch(q, qd), to_torch(k_np, pdt), to_torch(v_np, pdt),
                                torch.from_numpy(table), torch.from_numpy(pos + 1),
                                None if starts is None else torch.from_numpy(starts), softcap,
                                layer)
    assert (got.float() - stale.float()).abs().amax(dim=(1, 2)).min() > 1e-3


@pytest.mark.parametrize("pool", ["float32", "int8"])
def test_dead_slot_and_slot_past_the_table(pool):
    """Row 1 is a dead slot (its table row zeroed: it writes and reads trash
    page 0), row 2 writes past its table (to row 0 of page 0, and its key is
    not scored: it attends its mp * ps cached keys). The live rows 0 and 3
    equal JAX's write then attend; row 2 equals JAX's attention over the pools
    as they were; every page but page 0 and row 2's own (where JAX's clamped
    index may land) equals JAX's pools, and row 2's pages are untouched."""
    rng = np.random.default_rng(1)
    b, nq, nkv, hd, ps, mp = 4, 4, 2, 16, 4, 3
    P = 1 + b * mp
    k_np, v_np = make_pools(rng, (2,), nkv, P, ps, hd, pool)
    table = (1 + np.arange(b * mp)).reshape(b, mp).astype(np.int32)
    table[1] = 0
    pos = np.array([5, 9, mp * ps + 2, 0], np.int32)
    q = rng.normal(size=(b, nq, hd)).astype(np.float32)
    k_new = rng.normal(size=(b, nkv, hd)).astype(np.float32)
    v_new = rng.normal(size=(b, nkv, hd)).astype(np.float32)

    rk, rv = jpa.paged_cache_write(to_jax(k_np, "float32"), to_jax(v_np, "float32"),
                                   jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(table),
                                   jnp.asarray(pos), 1)
    ref = np.asarray(jpa.paged_attention(jnp.asarray(q), rk, rv, jnp.asarray(table),
                                         jnp.asarray(pos + 1), layer_idx=1))
    before = np.asarray(jpa.paged_attention(jnp.asarray(q), to_jax(k_np, "float32"),
                                            to_jax(v_np, "float32"), jnp.asarray(table),
                                            jnp.asarray(np.full(b, mp * ps, np.int32)),
                                            layer_idx=1))
    gk, gv = to_torch(k_np, "float32"), to_torch(v_np, "float32")
    got = tpa.paged_attention_write(torch.from_numpy(q), torch.from_numpy(k_new),
                                    torch.from_numpy(v_new), gk, gv, torch.from_numpy(table),
                                    torch.from_numpy(pos), layer_idx=1).numpy()
    np.testing.assert_allclose(got[[0, 3]], ref[[0, 3]], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[2], before[2], atol=1e-5, rtol=0)
    others = np.setdiff1d(np.arange(1, P), table[2])
    for g, r, orig in ((gk, rk, k_np), (gv, rv, v_np)):
        assert_pools_equal(g, r, keep=lambda a: a[:, :, others])
        assert_pools_equal(g, orig, keep=lambda a: a[:, :, table[2]])
    # page 0 of layer 1: row 0 holds row 2's K, row 9 % ps the dead slot's
    if pool == "int8":
        codes, scales = tpa.quantize_token_kv(torch.from_numpy(k_new))
        assert torch.equal(gk["q"][1, :, 0, 0], codes[2]) and torch.equal(gk["s"][1, :, 0, 0], scales[2])
        assert torch.equal(gk["q"][1, :, 0, 9 % ps], codes[1])
    else:
        assert torch.equal(gk[1, :, 0, 0], torch.from_numpy(k_new[2]))
        assert torch.equal(gk[1, :, 0, 9 % ps], torch.from_numpy(k_new[1]))


@pytest.mark.parametrize("pool", ["float32", "int8"])
def test_write_attend_matches_interpreted_pallas_kernels(pool):
    """The JAX package's Pallas write kernels and its Pallas paged attention,
    both in TPU interpret mode, on 5D pools (layer 1 of 2), GQA, a window."""
    rng = np.random.default_rng(2)
    b, nq, nkv, hd, ps, mp = 3, 8, 2, 128, 8, 3
    P = 1 + b * mp
    k_np, v_np = make_pools(rng, (2,), nkv, P, ps, hd, pool)
    table = (1 + rng.permutation(P - 1)).reshape(b, mp).astype(np.int32)
    pos = np.array([0, 8, 20], np.int32)
    starts = np.maximum(pos + 1 - 12, 0).astype(np.int32)
    qd = "float32"  # the Pallas int8 kernel scores without rounding K to q's dtype
    q = rng.normal(size=(b, nq, hd)).astype(np.float32)
    k_new = rng.normal(size=(b, nkv, hd)).astype(np.float32)
    v_new = rng.normal(size=(b, nkv, hd)).astype(np.float32)
    phys = jnp.asarray(table[np.arange(b), pos // ps])
    off = jnp.asarray(pos % ps)
    write = jpa._pool_write_pallas_q8 if pool == "int8" else jpa._pool_write_pallas_array
    with pltpu.force_tpu_interpret_mode():
        rk = write(to_jax(k_np, "float32"), jnp.asarray(k_new), phys, off, 1)
        rv = write(to_jax(v_np, "float32"), jnp.asarray(v_new), phys, off, 1)
        ref = jpa.paged_attention_pallas(to_jax(q, qd), rk, rv, jnp.asarray(table),
                                         jnp.asarray(pos + 1), jnp.asarray(starts), None, 1)
    gk, gv = to_torch(k_np, "float32"), to_torch(v_np, "float32")
    got = tpa.paged_attention_write(to_torch(q, qd), torch.from_numpy(k_new),
                                    torch.from_numpy(v_new), gk, gv, torch.from_numpy(table),
                                    torch.from_numpy(pos), torch.from_numpy(starts), None, 1)
    assert_pools_equal(gk, rk)
    assert_pools_equal(gv, rv)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), atol=TOL[qd],
                               rtol=0)


def test_paged_decode_steps_with_the_fused_layer_match_jax():
    """A gemma-2-shaped tiny model (a window on layer 0, attention and final
    softcaps) through ``paged_decode_step``, whose layers now make one
    write-and-attend call each: 6 steps of 3 sequences across page
    boundaries, fp32 pools, every step's logits within 1e-4 of the JAX
    package's, fed the same tokens; the written pool rows within 1e-5."""
    kw = dict(vocab_size=96, hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2,
              intermediate_size=48, model_type="gemma2", hidden_act="gelu_tanh",
              scale_embeddings=True, tie_embeddings=True, window_layers=(0,), sliding_window=5,
              attn_softcap=50.0, final_softcap=30.0)
    jcfg, tcfg = jmodel.LlamaConfig(**kw), tmodel.LlamaConfig(**kw)
    shapes = jax.eval_shape(lambda: jmodel.init_llama_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(3)
    tree = jax.tree.map(lambda s: (0.08 * rng.normal(size=s.shape)).astype(np.float32), shapes)
    jparams, tparams = jax.tree.map(jnp.asarray, tree), tckpt.llm_params_from_jax(tree, device="cpu")
    ps, mp, b = 4, 4, 3
    table = (1 + rng.permutation(b * mp)).reshape(b, mp).astype(np.int32)
    jk, jv = jpaged.init_paged_pools(jcfg, 1 + b * mp, ps, jnp.float32)
    tk, tv = tpaged.init_paged_pools(tcfg, 1 + b * mp, ps, torch.float32)
    lens = np.array([0, 3, 6], np.int32)
    for step in range(6):
        toks = rng.integers(0, 96, b)
        ref, jk, jv = jpaged.paged_decode_step(jparams, jnp.asarray(toks, jnp.int32), jk, jv, jcfg,
                                               jnp.asarray(table), jnp.asarray(lens + step))
        got, tk, tv = tpaged.paged_decode_step(tparams, torch.from_numpy(toks), tk, tv, tcfg,
                                               torch.from_numpy(table),
                                               torch.from_numpy(lens + step))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=0)
    for g, r in ((tk, jk), (tv, jv)):
        np.testing.assert_allclose(g.numpy()[:, :, 1:], np.asarray(r)[:, :, 1:], atol=1e-5, rtol=0)
