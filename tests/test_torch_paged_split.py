"""The split plan of the paged decode attention kernel
(``ops/kernels/paged_attention.py`` ``split_plan``), on the CPU.

The kernel splits each sequence's keys into runs of whole pages, one block
per (KV head, sequence, run), and combines the runs inside its launch. The
plan must come from the shapes alone (a decode step never waits for the
host), cover every page of the table exactly once, fill the card at the
served decode shape, and size the workspace the wrapper allocates.
"""

import contextlib
import inspect

import pytest
import torch

from ssp_x_vit_tpu_torch.ops import dispatch
from ssp_x_vit_tpu_torch.ops.kernels import build
from ssp_x_vit_tpu_torch.ops.kernels import paged_attention as tpa

SHAPES = [  # b, nkv, nq, hd, ps, mp, sms
    (8, 32, 32, 128, 64, 32, 132),    # the served decode shape (Llama-2-7B, 8 slots)
    (1, 32, 32, 128, 64, 32, 132),    # one sequence
    (8, 8, 32, 128, 64, 94, 132),     # Mistral-7B, context 6000
    (4, 8, 16, 256, 64, 16, 132),     # gemma-2 head_dim 256
    (2, 2, 6, 40, 12, 9, 132),        # ragged group and page
    (3, 4, 4, 64, 16, 4, 132),        # a short table
    (8, 32, 32, 128, 64, 1, 132),     # one page: one run
    (1, 2, 8, 64, 1, 2048, 132),      # pages of one key
    (64, 32, 32, 128, 64, 32, 78),    # many sequences, a smaller card
    (5, 2, 2, 20, 3, 9, 16),
]


def _runs(plan, mp):
    return [range(s * plan.pages_per_split, min(mp, (s + 1) * plan.pages_per_split))
            for s in range(plan.splits)]


@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
def test_every_page_falls_in_exactly_one_run(shape):
    """Runs start on page boundaries, none is empty, and together they cover
    each page of the table once."""
    b, nkv, nq, hd, ps, mp, sms = shape
    plan = tpa.split_plan(*shape)
    assert 1 <= plan.pages_per_split <= tpa.MAX_PAGES_PER_SPLIT
    runs = _runs(plan, mp)
    assert all(len(r) > 0 and r.start % plan.pages_per_split == 0 for r in runs)
    pages = [p for r in runs for p in r]
    assert pages == list(range(mp))


@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
def test_the_grid_fills_the_card_where_the_table_allows(shape):
    """At least four blocks per SM (two waves of two or three resident blocks)
    unless every run is already a single page."""
    b, nkv, nq, hd, ps, mp, sms = shape
    plan = tpa.split_plan(*shape)
    assert b * nkv * plan.splits >= 4 * sms or plan.pages_per_split == 1 or plan.splits == mp
    if plan.splits == 1:
        assert plan.workspace_floats == 0 and plan.tickets == 0
    else:
        assert plan.workspace_floats == b * nkv * plan.splits * (nq // nkv) * (hd + 2)
        assert plan.tickets == b * nkv


def test_the_served_decode_shape_fills_two_waves():
    """b=8, 32 KV heads, a 32-page table of 64 keys: at least two waves of
    blocks on 132 SMs, runs of whole pages of at most ``SPLIT_KEYS`` keys."""
    plan = tpa.split_plan(8, 32, 32, 128, 64, 32, 132)
    assert 8 * 32 * plan.splits >= 2 * 132
    assert plan.pages_per_split * 64 <= tpa.SPLIT_KEYS


def test_the_plan_reads_nothing_but_shapes(monkeypatch):
    """Its arguments are the shapes and the SM count, all host integers; it
    never touches a tensor, the card or the host clock of a device."""
    assert list(inspect.signature(tpa.split_plan).parameters) == [
        "b", "nkv", "nq", "hd", "ps", "mp", "sms"]

    def refuse(*args, **kwargs):
        raise AssertionError("the split plan touched torch")

    for name in ("item", "tolist", "cpu", "__bool__", "__int__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    tpa.split_plan.cache_clear()
    for shape in SHAPES:
        assert tpa.split_plan(*shape) == tpa.split_plan(*shape)


@pytest.mark.parametrize("shape", SHAPES[:6], ids=[str(s) for s in SHAPES[:6]])
def test_the_wrapper_allocates_the_plans_workspace(monkeypatch, shape):
    """The wrapper passes the plan's runs to the launch with a workspace of
    the plan's size and its tickets, and reads no length back to the host
    (``dispatch.use_kernel`` and the launch patched, tensors on the CPU)."""
    b, nkv, nq, hd, ps, mp, sms = shape
    plan = tpa.split_plan(*shape)
    seen = {}

    def launch(q, k_pool, v_pool, k_scale, v_scale, page_table, seq_lens, start_lens, out, *,
               layer, scale, softcap, pages_per_split, splits, workspace, tickets):
        seen.update(pps=pages_per_split, splits=splits, workspace=workspace, tickets=tickets)
        return out

    def refuse(*args, **kwargs):
        raise AssertionError("the wrapper read a device value back to the host")

    monkeypatch.setattr(dispatch, "use_kernel", lambda x: True)
    monkeypatch.setattr(build, "paged_attention", launch)
    monkeypatch.setattr(build, "tickets", lambda device, n: torch.zeros(n, dtype=torch.int32))
    monkeypatch.setattr(tpa, "_sm_count", lambda device: sms)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    pool = torch.zeros(nkv, 1 + b * mp, ps, hd)
    table = torch.arange(b * mp, dtype=torch.int32).reshape(b, mp) + 1
    lens = torch.full((b,), mp * ps, dtype=torch.int32)
    q = torch.zeros(b, nq, hd)
    for name in ("item", "tolist", "cpu", "__bool__", "__int__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    tpa.paged_attention(q, pool, pool, table, lens)
    assert (seen["pps"], seen["splits"]) == (plan.pages_per_split, plan.splits)
    if plan.splits == 1:
        assert seen["workspace"] is None and seen["tickets"] is None
    else:
        assert seen["workspace"].numel() == plan.workspace_floats
        assert seen["workspace"].dtype == torch.float32
        assert seen["tickets"].numel() >= plan.tickets


@pytest.mark.parametrize("shape", SHAPES[:6], ids=[str(s) for s in SHAPES[:6]])
def test_the_write_attend_wrapper_passes_the_plan(monkeypatch, shape):
    """``paged_attention_write`` launches the same split plan, with a workspace of
    at least the plan's size, and reads no length or position back to the host
    (the launch patched, tensors on the CPU)."""
    b, nkv, nq, hd, ps, mp, sms = shape
    plan = tpa.split_plan(*shape)
    seen = {}

    def launch(q, k_new, v_new, k_pool, v_pool, k_scale, v_scale, page_table, positions,
               start_lens, out, dims, *, layer, workspace, tickets, stream):
        seen.update(dims=dims, workspace=workspace, tickets=tickets)
        return out

    def refuse(*args, **kwargs):
        raise AssertionError("the wrapper read a device value back to the host")

    monkeypatch.setattr(dispatch, "use_kernel", lambda x: True)
    monkeypatch.setattr(build, "paged_attention_write", launch)
    monkeypatch.setattr(build, "raw_stream", lambda index: 0)
    monkeypatch.setattr(build, "workspace", lambda index, n: torch.zeros(n))
    monkeypatch.setattr(build, "tickets", lambda device, n: torch.zeros(n, dtype=torch.int32))
    monkeypatch.setattr(tpa, "_sm_count", lambda device: sms)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: -1)
    pool = torch.zeros(nkv, 1 + b * mp, ps, hd)
    table = torch.arange(b * mp, dtype=torch.int32).reshape(b, mp) + 1
    positions = torch.full((b,), mp * ps - 1, dtype=torch.int32)
    q, new = torch.zeros(b, nq, hd), torch.zeros(b, nkv, hd)
    for name in ("item", "tolist", "cpu", "__bool__", "__int__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    tpa.paged_attention_write(q, new, new, pool, pool, table, positions)
    assert seen["dims"][-2:] == (plan.pages_per_split, plan.splits)
    assert seen["dims"][3:10] == (b, nq, nkv, hd, ps, mp, 1 + b * mp)
    if plan.splits == 1:
        assert seen["workspace"] is None and seen["tickets"] is None
    else:
        assert seen["workspace"].numel() >= plan.workspace_floats
        assert seen["tickets"].numel() >= plan.tickets
