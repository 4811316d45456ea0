"""The MLA decode kernel (``ops/kernels/paged_mla.py``, ``csrc/paged_mla.cu``)
against its plain version.

No JAX here, so the card runs this file as it is
(``pytest --noconftest -m cuda tests/test_torch_paged_mla_kernel.py``). On the
CPU: the plain version against a direct softmax over the gathered rows, the
split plan's invariants and the wrapper's refusals. On the card: every pool
kind at D = 40 and 576, nq = 4, 16, 20 and 128, pages of 16, 64 and 256,
ragged lengths, runs of one page to many, within 1e-5 (fp32) or 3e-2 (bf16,
int8 pools) of max(1, max |plain|), the same bits on a second call, one launch
per call; the MLA row write (row 9's ``paged_pool_write`` at nkv = 1) bit for
bit the plain write; and the decode layer's one launch,
``paged_mla_attention_write``, on both kernels (the Hopper kernel for bf16 and
int8 pools at 64 and 128 heads, D = 576, 512 columns, pages of 8 to 256,
ragged lengths from 1 to 2048 keys and a slot past the table; the mma.sync
kernel for fp32 pools and the other shapes): within the same limits, the same
bits twice, one launch of the expected counter per call, the pools bit for
bit the plain write's outside trash page 0. The card's queries are scaled by
``Q_SCALE`` so that a few keys carry each head and max |plain| is ~2-4: the
CPU test of the limits shows they reject planted faults at those inputs.
"""

import math

import numpy as np
import pytest
import torch

from ssp_x_vit_tpu_torch.ops.kernels import launch_counts
from ssp_x_vit_tpu_torch.ops.kernels import paged_attention as tpa
from ssp_x_vit_tpu_torch.ops.kernels import paged_mla as tpm

TOL = {"float32": 1e-5, "bfloat16": 3e-2, "int8": 3e-2}
Q_SCALE = 3.0  # scores of std 3 (unscaled: outputs of ~0.04, under the limit's floor of 1)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's tiny tensors: the suite runs six
    workers on the host's cores, where a pool per worker only contends."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(gen, device, kind, *, b, nq, D, ps, lens, layers=2, layer=1, q_scale=1.0):
    """q (normal, times ``q_scale``), a 5D pool with random rows (int8: codes
    and scales from quantize_token_kv), tables of distinct shuffled pages,
    int32 lengths."""
    lens = list(lens)
    mp = max(-(-n // ps) for n in lens) + 1
    num_pages = 1 + b * mp
    dtype = torch.float32 if kind == "float32" else torch.bfloat16
    rows = torch.randn((layers, 1, num_pages, ps, D), generator=gen, device=device)
    pool = tpa.quantize_token_kv(rows) if kind == "int8" else rows.to(dtype)
    if kind == "int8":
        pool = {"q": pool[0], "s": pool[1]}
    perm = torch.randperm(num_pages - 1, generator=gen, device=device) + 1
    table = perm[: b * mp].reshape(b, mp).to(torch.int32).contiguous()
    q = (torch.randn((b, nq, D), generator=gen, device=device) * q_scale).to(dtype)
    seq = torch.as_tensor(lens, dtype=torch.int32, device=device)
    return q, pool, table, seq, layer


def _scaled_err(got, ref) -> float:
    return float((got.float() - ref.float()).abs().max()) / max(1.0, float(ref.abs().max()))


def _direct(q, pool, table, seq, layer):
    """softmax(q . row / sqrt(D)) . row over each sequence's rows, in float64."""
    codes = pool["q"] if isinstance(pool, dict) else pool
    rows = codes[layer, 0].double()
    if isinstance(pool, dict):
        rows = (codes[layer, 0].float() * pool["s"][layer, 0][..., None]).to(q.dtype).double()
    b, nq, D = q.shape
    ps = rows.shape[1]
    out = torch.zeros(b, nq, D, dtype=torch.float64)
    for i in range(b):
        n = int(seq[i])
        keys = torch.stack([rows[int(table[i, p // ps]), p % ps] for p in range(n)])
        w = torch.softmax(q[i].double() @ keys.t() / math.sqrt(D), dim=-1)
        out[i] = w @ keys
    return out


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_plain_version_is_the_softmax_over_the_sequence_rows(kind):
    gen = torch.Generator().manual_seed(0)
    q, pool, table, seq, layer = _setup(gen, "cpu", kind, b=3, nq=5, D=40, ps=4,
                                        lens=[1, 7, 12])
    got = tpm.paged_mla_attention(q, pool, table, seq, layer_idx=layer)
    ref = _direct(q, pool, table, seq, layer)
    err = (got.double() - ref).abs().max() / max(1.0, ref.abs().max())
    assert err < (1e-6 if kind == "float32" else 1e-2)


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("b,nq,D,ps,lens", [(8, 128, 576, 64, [2048] * 8),
                                            (8, 16, 576, 16, [520 + 3 * i for i in range(8)]),
                                            (3, 4, 40, 16, [1, 18, 64])])
def test_limits_reject_planted_faults_at_the_checked_inputs(kind, b, nq, D, ps, lens):
    """At the card check's inputs, the limit rejects what a kernel with one
    page of keys left out, the rope columns left out of the scores, or a page
    read from another sequence would return (made by the plain version from
    altered operands)."""
    gen = torch.Generator().manual_seed(3)
    q, pool, table, seq, layer = _setup(gen, "cpu", kind, b=b, nq=nq, D=D, ps=ps, lens=lens,
                                        q_scale=Q_SCALE)
    ref = tpm.paged_mla_attention_plain(q, pool, table, seq, layer_idx=layer)
    assert float(ref.float().abs().max()) > 1.0   # the limit is relative to the outputs
    j = table.shape[1] // 2
    full = seq >= (j + 1) * ps
    shifted = torch.cat([table[:, :j], table[:, j + 1:], table[:, j:j + 1]], dim=1)
    q_cut = q.clone()
    q_cut[..., -(8 if D == 40 else 64):] = 0
    wrong = table.clone()
    wrong[:, j] = table[:, j].roll(1)
    faults = {
        "page left out": (q, torch.where(full[:, None], shifted, table).contiguous(),
                          torch.where(full, seq - ps, seq)),
        "rope columns left out": (q_cut, table, seq),
        "page of another sequence": (q, wrong, seq),
    }
    for what, (fq, ft, fs) in faults.items():
        bad = tpm.paged_mla_attention_plain(fq, pool, ft, fs, layer_idx=layer)
        assert _scaled_err(bad, ref) > 3 * TOL[kind], (what, _scaled_err(bad, ref))


def test_split_plan_covers_the_table_in_whole_runs():
    for b, nq, D, ps, mp in [(8, 128, 576, 64, 32), (8, 16, 576, 16, 34), (1, 4, 40, 256, 2),
                             (3, 20, 40, 16, 300), (1, 16, 576, 1, 5000)]:
        plan = tpm.mla_split_plan(b, nq, D, ps, mp, 132)
        assert plan.pages_per_split * plan.splits >= mp
        assert (plan.splits - 1) * plan.pages_per_split < mp
        assert plan.splits <= tpm.MLA_MAX_SPLITS
        groups = -(-nq // 16)
        if plan.splits > 1:
            assert plan.workspace_floats == b * groups * plan.splits * 16 * (D + 2)
            assert plan.tickets == b * groups
        # a run holds at least one tile of keys unless the table is shorter
        assert plan.pages_per_split * ps >= min(tpm.MLA_TILE, mp * ps)


def test_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    """The checks that come before any launch, reached on a CPU tensor by
    treating it as a card tensor."""
    from ssp_x_vit_tpu_torch.ops import dispatch

    monkeypatch.setattr(dispatch, "use_kernel", lambda x: True)
    gen = torch.Generator().manual_seed(1)
    q, pool, table, seq, layer = _setup(gen, "cpu", "bfloat16", b=2, nq=4, D=40, ps=4,
                                        lens=[3, 5])
    with pytest.raises(ValueError, match="multiple of 8"):
        tpm.paged_mla_attention(q[..., :36].contiguous(), pool[..., :36].contiguous(), table,
                                seq, layer_idx=layer)
    wide = torch.zeros((1, 1, 2, 4, 584), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="at most 576"):
        tpm.paged_mla_attention(torch.zeros((2, 4, 584), dtype=torch.bfloat16), wide, table,
                                seq, layer_idx=0)
    with pytest.raises(ValueError, match=r"\[A, 1, P, ps"):
        tpm.paged_mla_attention(q, pool.expand(2, 2, -1, -1, -1).contiguous(), table, seq,
                                layer_idx=layer)
    with pytest.raises(TypeError, match="q's dtype"):
        tpm.paged_mla_attention(q.float(), pool, table, seq, layer_idx=layer)
    with pytest.raises(TypeError, match="int32"):
        tpm.paged_mla_attention(q, pool, table.long(), seq, layer_idx=layer)
    with pytest.raises(ValueError, match="layer_idx"):
        tpm.paged_mla_attention(q, pool, table, seq, layer_idx=2)
    int8 = {"q": torch.zeros((2, 1, 3, 4, 40), dtype=torch.int8),
            "s": torch.ones((2, 1, 3, 4), dtype=torch.float32)}
    with pytest.raises(TypeError, match="bfloat16"):
        tpm.paged_mla_attention(q.float(), int8, table, seq, layer_idx=0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "pytest --noconftest -m cuda tests/test_torch_paged_mla_kernel.py)")
    return torch.device("cuda", 0)


CASES = [  # b, nq, D, ps, lens
    (3, 4, 40, 16, [1, 17, 63]),
    (2, 20, 40, 256, [300, 5]),
    (8, 16, 576, 16, [520, 511, 530, 1, 64, 65, 519, 525]),
    (8, 16, 576, 256, [520, 511, 530, 1, 64, 65, 519, 525]),
    (8, 128, 576, 64, [2048] * 8),
    (2, 128, 576, 64, [2048, 70]),
]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_mla_kernel_matches_plain_version_on_the_card(cuda_device, kind):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    suffix = "_q8" if kind == "int8" else ""
    for b, nq, D, ps, lens in CASES:
        q, pool, table, seq, layer = _setup(gen, cuda_device, kind, b=b, nq=nq, D=D, ps=ps,
                                            lens=lens, q_scale=Q_SCALE)
        before = launch_counts["paged_mla_attention" + suffix]
        got = tpm.paged_mla_attention(q, pool, table, seq, layer_idx=layer)
        again = tpm.paged_mla_attention(q, pool, table, seq, layer_idx=layer)
        assert launch_counts["paged_mla_attention" + suffix] == before + 2
        ref = tpm.paged_mla_attention_plain(q, pool, table, seq, layer_idx=layer)
        err = _scaled_err(got, ref)
        assert err <= TOL[kind], (kind, b, nq, D, ps, err)
        assert torch.equal(got, again), (kind, b, nq, D, ps)
        # the 4D view of the same layer
        flat = ({k: v[layer] for k, v in pool.items()} if isinstance(pool, dict)
                else pool[layer])
        assert torch.equal(tpm.paged_mla_attention(q, flat, table, seq), got)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_mla_row_write_matches_plain_write_on_the_card(cuda_device, kind):
    """The decode layer's write of the new latent rows ([b, 1, D], nkv = 1)
    through row 9's standalone write, a slot past the table included (trash
    page 0, as the plain write sends it)."""
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    for D in (40, 576):
        q, pool, table, seq, layer = _setup(gen, cuda_device, kind, b=4, nq=16, D=D, ps=16,
                                            lens=[5, 16, 31, 40])
        dtype = torch.float32 if kind == "float32" else torch.bfloat16
        new = torch.randn((4, 1, D), generator=gen, device=cuda_device).to(dtype)
        pos = seq.clone()
        pos[3] = table.shape[1] * 16 + 3
        clone = ({k: v.clone() for k, v in pool.items()} if isinstance(pool, dict)
                 else pool.clone())
        tpa.paged_pool_write(pool, new, table, pos, layer_idx=layer)
        tpa.paged_pool_write_plain(clone, new, table, pos, layer_idx=layer)
        if isinstance(pool, dict):
            assert torch.equal(pool["q"], clone["q"]) and torch.equal(pool["s"], clone["s"])
        else:
            assert torch.equal(pool, clone)


PAST = 1 << 30  # a position past the table: the row goes to trash page 0
WRITE_CASES = [  # b, nq, D, v_cols, ps, positions
    (8, 128, 576, 512, 64, [2047] * 8),
    (8, 128, 576, 512, 64, [519 + 3 * i for i in range(8)]),
    (8, 128, 576, 512, 16, [0, 1, 63, 64, 520, 1000, 1500, PAST]),
    (8, 128, 576, 512, 256, [0, 1, 63, 64, 520, 1000, 1500, 2047]),
    (2, 64, 576, 512, 8, [5, 300]),
    (8, 16, 576, 512, 64, [519 + 3 * i for i in range(8)]),
    (3, 4, 40, 32, 16, [0, 17, PAST]),
    (2, 128, 576, 576, 64, [70, 2047]),
]


def _without_trash(pool):
    return [t[:, :, 1:] for t in (pool.values() if isinstance(pool, dict) else [pool])]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_mla_write_and_attend_matches_plain_version_on_the_card(cuda_device, kind):
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    q8 = "_q8" if kind == "int8" else ""
    for b, nq, D, v_cols, ps, positions in WRITE_CASES:
        q, pool, table, _, layer = _setup(gen, cuda_device, kind, b=b, nq=nq, D=D, ps=ps,
                                          lens=[p + 1 for p in positions if p != PAST] or [1],
                                          q_scale=Q_SCALE)
        mp = table.shape[1]
        pos = torch.as_tensor([mp * ps + 3 if p == PAST else p for p in positions],
                              dtype=torch.int32, device=cuda_device)
        new = torch.randn((b, 1, D), generator=gen, device=cuda_device).to(q.dtype)
        codes = pool["q"] if isinstance(pool, dict) else pool
        hopper = tpm.hopper_takes(nq, D, v_cols, ps, codes.dtype)
        assert hopper == (kind != "float32" and nq % 64 == 0 and v_cols == 512)
        counter = ("paged_mla_write_hopper" if hopper else "paged_mla_attention_write") + q8
        clone = ({k: v.clone() for k, v in pool.items()} if isinstance(pool, dict)
                 else pool.clone())
        ref = tpm.paged_mla_attention_write_plain(q, new, clone, table, pos, layer_idx=layer,
                                                  v_cols=v_cols)
        before = dict(launch_counts)
        got = tpm.paged_mla_attention_write(q, new, pool, table, pos, layer_idx=layer,
                                            v_cols=v_cols)
        again = tpm.paged_mla_attention_write(q, new, pool, table, pos, layer_idx=layer,
                                              v_cols=v_cols)
        moved = {k: launch_counts[k] - before[k] for k in launch_counts
                 if launch_counts[k] != before[k]}
        assert moved == {counter: 2}, (kind, b, nq, ps, moved)
        assert got.shape == (b, nq, v_cols) and got.dtype == q.dtype
        err = _scaled_err(got, ref)
        assert err <= TOL[kind], (kind, b, nq, D, ps, err)
        assert torch.equal(got, again), (kind, b, nq, D, ps)
        for x, y in zip(_without_trash(pool), _without_trash(clone)):
            assert torch.equal(x, y), (kind, b, nq, D, ps)
