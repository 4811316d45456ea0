"""The MLA decode layer's one call, ``paged_mla_attention_write``
(``ops/kernels/paged_mla.py``): the latent row written at ``positions``, then
the attention over ``positions + 1`` keys with the pool as keys and values,
of which the first ``v_cols`` columns are returned.

On the CPU the wrapper runs its plain version. It is held against the JAX
package as ``ssp_x_vit_tpu/llm/paged_mla.py`` calls it: ``paged_pool_write``,
then ``paged_attention_reference`` (the JAX package's CPU path), on the same
numpy inputs. Outputs within 1e-6 of max(1, max |ref|) in fp32 (the same
arithmetic in another summation order) and 2e-2 in bf16 and int8 pools (one
bf16 rounding of outputs of magnitude ~1-4, at other places); the written
pools bit for bit, int8 codes and scales exactly JAX's ``_quantize_token_kv``.
Then, on the port alone: a slot outside the table (row 0 of trash page 0,
where JAX's gather would clamp; the accepted difference of the paged write),
the Hopper kernel's split plan, the shape-and-dtype dispatch rule and the
wrapper's refusals. The card's checks of both kernels are in
``tests/test_torch_paged_mla_kernel.py`` (no JAX there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssp_x_vit_tpu.ops.pallas import paged_attention as jpa
from ssp_x_vit_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
from ssp_x_vit_tpu_torch.ops.kernels import paged_attention as tpa
from ssp_x_vit_tpu_torch.ops.kernels import paged_mla as tpm

TOL = {"float32": 1e-6, "bfloat16": 2e-2, "int8": 2e-2}
# clusters of 1-8 CTAs an H100 80GB HBM3 holds at once for this kernel, as
# cluster_capacity read them on the card
H100_CLUSTERS = (132, 66, 39, 30, 22, 17, 15, 15)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's tiny tensors: the suite runs six
    workers on the host's cores, where a pool per worker only contends."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(kind, *, b=3, nq=4, D=40, ps=4, positions=(0, 5, 11), layers=2, seed=0):
    """numpy q [b, nq, D] (times 3, so a few keys carry each head), new rows
    [b, 1, D], a pool [layers, 1, P, ps, D] (int8: codes and scales from the
    JAX quantizer), a table of distinct shuffled pages (never page 0) and
    int32 positions."""
    rng = np.random.default_rng(seed)
    mp = max(p for p in positions if p >= 0) // ps + 2
    P = 1 + b * mp
    rows = rng.normal(size=(layers, 1, P, ps, D)).astype(np.float32)
    if kind == "int8":
        codes, scales = jpa._quantize_token_kv(jnp.asarray(rows))
        pool = {"q": np.asarray(codes), "s": np.asarray(scales)}
    else:
        pool = rows
    table = (rng.permutation(P - 1)[: b * mp] + 1).reshape(b, mp).astype(np.int32)
    q = (rng.normal(size=(b, nq, D)) * 3).astype(np.float32)
    new = rng.normal(size=(b, 1, D)).astype(np.float32)
    return q, new, pool, table, np.asarray(positions, np.int32)


def _to_jax(a, kind):
    if isinstance(a, dict):
        return {k: jnp.asarray(v) for k, v in a.items()}
    return jnp.asarray(a, jnp.float32 if kind == "float32" else jnp.bfloat16)


def _to_torch(a, kind):
    if isinstance(a, dict):
        return {k: torch.from_numpy(v.copy()) for k, v in a.items()}
    return torch.from_numpy(a.copy()).to(torch.float32 if kind == "float32" else torch.bfloat16)


def _numpy(pool):
    if isinstance(pool, dict):
        return {k: _numpy(v) for k, v in pool.items()}
    if isinstance(pool, torch.Tensor):
        return pool.numpy() if pool.dtype == torch.int8 else pool.float().numpy()
    return np.asarray(pool) if pool.dtype == jnp.int8 else np.asarray(pool, np.float32)


def _scaled_err(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_write_and_attend_matches_jax_write_then_reference(kind):
    q, new, pool, table, pos = _inputs(kind)
    v_cols, layer = 32, 1
    jpool = jpa.paged_pool_write(_to_jax(pool, kind), _to_jax(new, "bfloat16" if kind == "int8"
                                                              else kind),
                                 jnp.asarray(table), jnp.asarray(pos), layer_idx=layer)
    jlayer = jpa._layer_of(jpool, layer)
    jq = _to_jax(q, "bfloat16" if kind == "int8" else kind)
    ref = jpa.paged_attention_reference(jq, jlayer, jlayer, jnp.asarray(table),
                                        jnp.asarray(pos) + 1)[..., :v_cols]

    tpool = _to_torch(pool, kind)
    tq = _to_torch(q, "bfloat16" if kind == "int8" else kind)
    tnew = _to_torch(new, "bfloat16" if kind == "int8" else kind)
    reset_launch_counts()
    got = tpm.paged_mla_attention_write(tq, tnew, tpool, torch.from_numpy(table),
                                        torch.from_numpy(pos), layer_idx=layer, v_cols=v_cols)
    assert all(n == 0 for n in launch_counts.values())  # a CPU tensor runs the plain version
    assert got.shape == (3, 4, v_cols) and got.dtype == tq.dtype and got.is_contiguous()
    assert _scaled_err(got.float().numpy(), np.asarray(ref, np.float32)) <= TOL[kind]
    want, have = _numpy(jpool), _numpy(tpool)
    for k in (want if isinstance(want, dict) else [None]):
        np.testing.assert_array_equal(have if k is None else have[k], want if k is None else want[k])
    if kind == "int8":  # the written rows: exactly JAX's quantizer of the new rows
        codes, scales = jpa._quantize_token_kv(jnp.asarray(tnew.float().numpy()))
        for i in range(3):
            page, off = table[i, pos[i] // 4], pos[i] % 4
            np.testing.assert_array_equal(tpool["q"][layer, 0, page, off].numpy(),
                                          np.asarray(codes)[i, 0])
            assert tpool["s"][layer, 0, page, off].item() == float(np.asarray(scales)[i, 0])


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_write_and_attend_is_the_write_then_the_attention(kind):
    """The plain version is ``paged_pool_write`` then ``paged_mla_attention``
    over positions + 1, sliced: the same bits, pools included; v_cols None
    returns all D columns."""
    q, new, pool, table, pos = _inputs(kind, seed=1)
    dt = "bfloat16" if kind == "int8" else kind
    tq, tnew = _to_torch(q, dt), _to_torch(new, dt)
    table_t, pos_t = torch.from_numpy(table), torch.from_numpy(pos)
    a, b = _to_torch(pool, kind), _to_torch(pool, kind)
    got = tpm.paged_mla_attention_write(tq, tnew, a, table_t, pos_t, layer_idx=1)
    tpa.paged_pool_write(b, tnew, table_t, pos_t, layer_idx=1)
    want = tpm.paged_mla_attention(tq, b, table_t, pos_t + 1, layer_idx=1)
    assert torch.equal(got, want)
    if kind == "int8":
        assert torch.equal(a["q"], b["q"]) and torch.equal(a["s"], b["s"])
    else:
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_slot_outside_the_table_goes_to_trash_page_zero(kind):
    """Sequence 1 writes past its table and sequence 2 below 0: both rows go
    to row 0 of trash page 0 (the later write stays), no page of a sequence
    changes, sequence 1 attends all its table's keys and sequence 2 none (the
    plain version's uniform average)."""
    q, new, pool, table, _ = _inputs(kind, seed=2)
    mp, ps = table.shape[1], 4
    pos = np.asarray([5, mp * ps + 3, -1], np.int32)
    dt = "bfloat16" if kind == "int8" else kind
    tq, tnew = _to_torch(q, dt), _to_torch(new, dt)
    before, tpool = _to_torch(pool, kind), _to_torch(pool, kind)
    got = tpm.paged_mla_attention_write(tq, tnew, tpool, torch.from_numpy(table),
                                        torch.from_numpy(pos), layer_idx=1)
    after, old = _numpy(tpool), _numpy(before)
    pairs = [(after[k], old[k]) for k in after] if kind == "int8" else [(after, old)]
    for a, o in pairs:
        changed = np.argwhere(np.any((a != o).reshape(*a.shape[:4], -1), axis=-1))
        written = {tuple(x) for x in changed.tolist()}
        assert written <= {(1, 0, 0, 0), (1, 0, int(table[0, 1]), 1)}, written
    trash = tpa.layer_of(tpool, 1)
    trash_row = (trash["q"][0, 0, 0].float() * trash["s"][0, 0, 0] if kind == "int8"
                 else trash[0, 0, 0].float())
    want_row = tnew[2, 0].float()
    if kind == "int8":
        codes, sc = tpa.quantize_token_kv(tnew[2:3])
        want_row = codes[0, 0].float() * sc[0, 0]
    assert torch.equal(trash_row, want_row)
    full = tpm.paged_mla_attention_plain(tq, tpool, torch.from_numpy(table),
                                         torch.as_tensor([6, mp * ps, 0], dtype=torch.int32),
                                         layer_idx=1)
    assert torch.equal(got, full)


def test_hopper_plan_covers_the_table_in_whole_tiles():
    for b, nq, ps, mp, dtype in [(8, 128, 64, 32, torch.bfloat16), (8, 128, 64, 10, torch.int8),
                                 (1, 128, 16, 128, torch.bfloat16), (64, 128, 64, 32, torch.int8),
                                 (3, 64, 8, 7, torch.bfloat16), (2, 256, 256, 3, torch.int8),
                                 (5, 128, 32, 1, torch.bfloat16)]:
        plan = tpm.mla_hopper_plan(b, nq, ps, mp, dtype, H100_CLUSTERS)
        span = plan.pages_per_split * ps
        assert 1 <= plan.splits <= tpm.HOPPER_MAX_SPLITS
        assert plan.pages_per_split * plan.splits >= mp > (plan.splits - 1) * plan.pages_per_split
        assert plan.workspace_floats == 0 and plan.tickets == 0  # the runs combine in their cluster
        if plan.splits > 1:
            assert span % tpm.HOPPER_TILE == 0  # runs of whole tiles
        runs = [(k // span) for k in range(mp * ps)]  # every key in exactly one run
        assert sorted(set(runs)) == list(range(plan.splits))
        # one plan for every head group of a sequence: it counts (sequence,
        # group) clusters, so 8 sequences of 2 groups plan as 16 of 1
        assert plan == tpm.mla_hopper_plan(b * nq // 64, 64, ps, mp, dtype, H100_CLUSTERS)


def test_hopper_plan_picks_the_measured_best_runs():
    """At DeepSeek-V3 decode (8 sequences of 2048 keys, pages of 64) and the
    served shape (a 10-page table) the plan takes 6 and 5 runs: clusters of 7
    and 8 CTAs do not all fit on the card at once (15 of the 16 needed)."""
    for dtype in (torch.bfloat16, torch.int8):
        assert tpm.mla_hopper_plan(8, 128, 64, 32, dtype, H100_CLUSTERS).splits == 6
        assert tpm.mla_hopper_plan(8, 128, 64, 10, dtype, H100_CLUSTERS).splits == 5
    # with room for every cluster, more runs only re-read the queries more
    assert tpm.mla_hopper_plan(1, 128, 64, 32, torch.bfloat16, H100_CLUSTERS).splits == 8
    assert tpm.mla_hopper_plan(64, 128, 64, 32, torch.bfloat16, H100_CLUSTERS).splits == 1


@pytest.mark.parametrize("nq,D,v_cols,ps,dtype,hopper", [
    (128, 576, 512, 64, torch.bfloat16, True), (128, 576, 512, 64, torch.int8, True),
    (64, 576, 512, 16, torch.bfloat16, True), (256, 576, 512, 256, torch.int8, True),
    (128, 576, 512, 8, torch.bfloat16, True), (128, 576, 512, 64, torch.float32, False),
    (16, 576, 512, 64, torch.bfloat16, False), (96, 576, 512, 64, torch.bfloat16, False),
    (128, 576, 576, 64, torch.bfloat16, False), (4, 40, 32, 16, torch.int8, False),
    (128, 576, 512, 4, torch.bfloat16, False), (128, 576, 512, 48, torch.bfloat16, False)])
def test_dispatch_rule_is_shape_and_dtype(nq, D, v_cols, ps, dtype, hopper):
    assert tpm.hopper_takes(nq, D, v_cols, ps, dtype) is hopper


def test_wrapper_refuses_what_no_kernel_takes(monkeypatch):
    """The checks that come before any launch, reached on a CPU tensor by
    treating it as a card tensor."""
    from ssp_x_vit_tpu_torch.ops import dispatch

    monkeypatch.setattr(dispatch, "use_kernel", lambda x: True)
    q, new, pool, table, pos = _inputs("bfloat16", seed=3)
    q, new, pool = _to_torch(q, "bfloat16"), _to_torch(new, "bfloat16"), _to_torch(pool, "bfloat16")
    table, pos = torch.from_numpy(table), torch.from_numpy(pos)

    def call(**kw):
        args = dict(q=q, new_row=new, pool=pool, page_table=table, positions=pos, layer_idx=1)
        args.update(kw)
        return tpm.paged_mla_attention_write(**args)

    with pytest.raises(ValueError, match="new_row must be"):
        call(new_row=new[:, :, :32].contiguous())
    with pytest.raises(ValueError, match="new_row must be"):
        call(new_row=new.float())
    with pytest.raises(ValueError, match="contiguous tensor"):
        call(new_row=torch.zeros(3, 1, 80, dtype=torch.bfloat16)[..., ::2])
    with pytest.raises(ValueError, match="v_cols"):
        call(v_cols=36)
    with pytest.raises(ValueError, match="v_cols"):
        call(v_cols=48)
    with pytest.raises(TypeError, match="int32"):
        call(positions=pos.long())
    with pytest.raises(ValueError, match="positions has shape"):
        call(positions=pos[:2].contiguous())
    with pytest.raises(ValueError, match="layer_idx"):
        call(layer_idx=2)
    with pytest.raises(TypeError, match="q's dtype"):
        call(q=q.float())
