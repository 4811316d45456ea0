#!/usr/bin/env python3
"""Time the PyTorch port's paged decode kernels on one card, bf16 queries,
beside their bounds, the plain versions and PyTorch's page gather + SDPA:

- ``paged_attention`` (row 7, bf16 pools) and ``paged_attention_q8`` (row 8,
  int8 pools with fp32 scales), the standalone K/V write ``paged_cache_write``
  (row 9), the two as the decode step made them before they were fused (write,
  then attend), and ``paged_attention_write`` (rows 7-9 in one launch) where
  the checkout has it;
- at the served Llama-2-7B decode shape: b=8 sequences, 32 query and 32 KV
  heads, head_dim 128, pages of 64, 2048 keys each (a 32-page table; the new
  key at slot 2047), and at the decode step of the served measurement: 8 live
  slots of ~520 keys in a 32-page table.

    python3 scripts/torch_paged_timing.py [--root CHECKOUT] [--reps 3]

Imports ``ssp_x_vit_tpu_torch`` from ``--root`` (default: this checkout) and
builds only the sources it times, so two checkouts can be timed in turns
within one machine (A, B, B, A). Prints one JSON line: the card's name and
power limit; ptxas's registers and spills for every instantiation of the
paged kernels of that checkout; the shapes with their bounds (each input
byte read once, each output byte written once, at 3.35 TB/s), the plain and
library times; and per repetition, for each call: the device milliseconds
per call from a profiler trace of 20 calls, the host's microseconds per call
to enqueue 200 calls while the card is busy with a spin kernel (no
synchronize inside), and the CUDA-event milliseconds over 50 calls (where
the host takes longer to issue a call than the card to run it, the events
time the host; the trace does not). ``host_parts`` splits one attention call
and one write-and-attend call into the wrapper's parts, timed the same way.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

PEAK_BYTES = 3.35e12
B, NQ, NKV, HD, PS, MP = 8, 32, 32, 128, 64, 32


def _busy() -> None:
    """Keep the card busy (~50 ms) so that host timings measure the enqueue."""
    import torch

    torch.cuda._sleep(100_000_000)


def _host_us(fn, iters: int = 200) -> float:
    """Microseconds of the host's clock per call to enqueue ``iters`` calls
    behind a spin kernel: what a host-bound loop pays per call."""
    import torch

    fn()
    torch.cuda.synchronize()
    _busy()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds * 1e6 / iters


def _device_ms(fn, iters: int = 20) -> float:
    """Device milliseconds per call from a ``torch.profiler`` trace of ``iters``
    calls: the kernels' own time, which a host-bound timing loop cannot show."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            total_us += getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
    return total_us / iters / 1e3


def _ms(fn, iters: int = 50, warmup: int = 10) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def build_report(log: str) -> dict:
    """ptxas's registers and spills per kernel of ``paged_attention.cu``, keyed
    by the demangled kernel with its template arguments."""
    names, out, entry = [], {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
            names.append(entry)
            out[entry] = {}
        elif entry is not None:
            for key, pat in (("registers", r"Used (\d+) registers"),
                             ("spill_stores", r"(\d+) bytes spill stores"),
                             ("spill_loads", r"(\d+) bytes spill loads"),
                             ("stack_frame", r"(\d+) bytes stack frame")):
                m = re.search(pat, line)
                if m:
                    out[entry][key] = int(m.group(1))
    try:
        plain = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                               text=True, timeout=60).stdout.splitlines()
    except OSError:
        plain = names
    return {re.sub(r"\(anonymous namespace\)::|ssp::|pa::", "", p).split("(")[0]: out[n]
            for n, p in zip(names, plain)}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--reps", type=int, default=3)
    args = parser.parse_args()

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("torch_paged_timing: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from ssp_x_vit_tpu_torch.ops.kernels import build
    from ssp_x_vit_tpu_torch.ops.kernels import paged_attention as tpa

    build.SOURCES = ("gemm", "paged_attention")
    build.build_all()
    fused = hasattr(tpa, "paged_attention_write")
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)

    def operands(kind, keys):
        """Pools of a shuffled page table with ``keys[i]`` live keys per
        sequence (the last one the new key, written at slot keys[i] - 1)."""
        need = [-(-n // PS) for n in keys]
        pages = 1 + sum(need)
        order = (1 + torch.randperm(pages - 1, generator=gen, device=device)).to(torch.int32)
        table = torch.zeros(B, MP, dtype=torch.int32, device=device)
        at = 0
        for i, n in enumerate(need):
            table[i, :n] = order[at:at + n]
            at += n

        def pool():
            rows = torch.randn(NKV, pages, PS, HD, generator=gen, device=device)
            if kind == "int8":
                codes, scales = tpa.quantize_token_kv(rows)
                return {"q": codes, "s": scales}
            return rows.bfloat16()

        lens = torch.tensor(keys, dtype=torch.int32, device=device)
        q = torch.randn(B, NQ, HD, generator=gen, device=device).bfloat16()
        k_new = torch.randn(B, NKV, HD, generator=gen, device=device).bfloat16()
        v_new = torch.randn(B, NKV, HD, generator=gen, device=device).bfloat16()
        return dict(k=pool(), v=pool(), table=table, lens=lens, pos=lens - 1, q=q,
                    k_new=k_new, v_new=v_new)

    def gathered(pool, table, q8):
        t = table.long()
        if q8:
            out = pool["q"][:, t].bfloat16() * pool["s"][:, t][..., None].bfloat16()
        else:
            out = pool[:, t]
        return out.movedim(0, 1).reshape(B, NKV, MP * PS, HD)

    def calls(c):
        """The calls timed for one case: name -> zero-argument function."""
        out = {
            "attend": lambda: tpa.paged_attention(c["q"], c["k"], c["v"], c["table"], c["lens"]),
            "write": lambda: tpa.paged_cache_write(c["k"], c["v"], c["k_new"], c["v_new"],
                                                   c["table"], c["pos"]),
        }
        out["write + attend"] = lambda: (out["write"](), out["attend"]())
        if fused:
            out["write-and-attend"] = lambda: tpa.paged_attention_write(
                c["q"], c["k_new"], c["v_new"], c["k"], c["v"], c["table"], c["pos"])
        return out

    cases, shapes = {}, {}
    for label, keys in (("2048 keys each", [2048] * B),
                        ("8 live slots, ~520 keys each", [520 + 3 * i for i in range(B)])):
        for kind in ("bf16", "int8"):
            c = operands(kind, keys)
            q8 = kind == "int8"
            key = f"b={B} nq={NQ} nkv={NKV} hd={HD} ps={PS}, {label}, {kind} pools"
            row_bytes = HD + 4 if q8 else 2 * HD
            common = 2 * B * NQ * HD * 2 + c["table"].numel() * 4 + 4 * B  # q, out, table, lens
            new_rows = 2 * B * NKV * (2 * HD + row_bytes)  # read k_new / v_new, write the rows
            attn_bytes = 2 * NKV * row_bytes * sum(keys) + common
            write_bytes = new_rows + c["table"].numel() * 4 + 4 * B
            fused_bytes = 2 * NKV * row_bytes * (sum(keys) - B) + new_rows + common
            mask = (torch.arange(MP * PS, device=device)[None] < c["lens"][:, None])[:, None, None]

            def library(c=c, mask=mask, q8=q8):
                return F.scaled_dot_product_attention(
                    c["q"][:, :, None], gathered(c["k"], c["table"], q8),
                    gathered(c["v"], c["table"], q8), attn_mask=mask)

            def plain(c=c):
                tpa.paged_pool_write_plain(c["k"], c["k_new"], c["table"], c["pos"])
                tpa.paged_pool_write_plain(c["v"], c["v_new"], c["table"], c["pos"])
                return tpa.paged_attention_plain(c["q"], c["k"], c["v"], c["table"], c["lens"])

            shapes[key] = {
                "bound_ms": {"attend": attn_bytes / PEAK_BYTES * 1e3,
                             "write": write_bytes / PEAK_BYTES * 1e3,
                             "write-and-attend": fused_bytes / PEAK_BYTES * 1e3},
                "bytes": {"attend": attn_bytes, "write": write_bytes,
                          "write-and-attend": fused_bytes},
                "library_ms": _ms(library, iters=20, warmup=3),
                "plain_ms": {"attend": _ms(lambda c=c: tpa.paged_attention_plain(
                                 c["q"], c["k"], c["v"], c["table"], c["lens"]), iters=5, warmup=1),
                             "write-and-attend": _ms(plain, iters=5, warmup=1)}}
            if fused:  # the fused call against its plain version on these inputs
                k0 = {k: v.clone() for k, v in c["k"].items()} if q8 else c["k"].clone()
                v0 = {k: v.clone() for k, v in c["v"].items()} if q8 else c["v"].clone()
                got = calls(c)["write-and-attend"]()
                c["k"], c["v"] = k0, v0
                ref = plain()
                err = (got.float() - ref.float()).abs().max().item()
                shapes[key]["max_abs_err"] = err
                if err / max(1.0, ref.float().abs().max().item()) > 3e-2:
                    raise AssertionError(f"{key}: write-and-attend disagrees with its plain version")
            cases[key] = (c, calls(c))
    reps = []
    for _ in range(args.reps):
        rec = {}
        for key, (_, fns) in cases.items():
            for name, fn in fns.items():
                rec[f"{key}: {name}"] = {"device_ms": _device_ms(fn), "host_us": _host_us(fn),
                                         "event_ms": _ms(fn)}
        reps.append(rec)
    key = f"b={B} nq={NQ} nkv={NKV} hd={HD} ps={PS}, 8 live slots, ~520 keys each, bf16 pools"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(json.dumps({"root": os.path.abspath(args.root), "card": smi.splitlines()[0],
                      "fused": fused, "build": build_report(build.build_log.get("paged_attention", "")),
                      "host_parts": host_parts(tpa, build, *cases[key], fused),
                      "shapes": shapes, "reps": reps}))
    return 0


def host_parts(tpa, build, c, fns, fused) -> dict:
    """Host microseconds per call of the parts of one ``paged_attention`` call
    and one ``paged_attention_write`` call at the served decode shape (bf16
    pools): the whole call, the call with its ctypes launch replaced by
    nothing, the device guard, the stream lookup, the output and workspace
    allocations and the ctypes launch alone."""
    import torch

    q, dev = c["q"], c["q"].device
    plan = tpa.split_plan(B, NKV, NQ, HD, PS, MP, tpa._sm_count(dev))
    ws = torch.empty(plan.workspace_floats, dtype=torch.float32, device=dev)
    tickets = build.tickets(dev, plan.tickets)
    o = torch.empty_like(q)
    lib = build.library("paged_attention")
    raw = (1, 1, q.data_ptr(), c["k"].data_ptr(), c["v"].data_ptr(), None, None,
           c["table"].data_ptr(), c["lens"].data_ptr(), None, o.data_ptr(), B, NQ, NKV, HD, PS,
           MP, c["k"].shape[1], 0, HD ** -0.5, 0.0, plan.pages_per_split, plan.splits,
           ws.data_ptr(), tickets.data_ptr(), torch.cuda.current_stream().cuda_stream)

    def guard():
        with torch.cuda.device(dev):
            pass

    out = {"attend": _host_us(fns["attend"]),
           "device guard": _host_us(guard),
           "current_stream().cuda_stream": _host_us(lambda: torch.cuda.current_stream().cuda_stream),
           "empty_like(q)": _host_us(lambda: torch.empty_like(q)),
           "empty(workspace)": _host_us(lambda: torch.empty(plan.workspace_floats,
                                                            dtype=torch.float32, device=dev)),
           "ctypes launch alone": _host_us(lambda: lib.ssp_paged_attention(*raw))}
    real = build.paged_attention
    build.paged_attention = lambda *a, **k: None
    try:
        out["attend, launch replaced by nothing"] = _host_us(fns["attend"])
    finally:
        build.paged_attention = real
    if fused:
        out["write-and-attend"] = _host_us(fns["write-and-attend"])
        real = build.paged_attention_write
        build.paged_attention_write = lambda *a, **k: None
        try:
            out["write-and-attend, launch replaced by nothing"] = _host_us(fns["write-and-attend"])
        finally:
            build.paged_attention_write = real
    return out


if __name__ == "__main__":
    sys.exit(main())
