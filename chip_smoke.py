#!/usr/bin/env python3
"""Drive the PyTorch port (``ssp_x_vit_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, one card

Phases, in order; any failure raises and the script exits non-zero:

1. device   card name and power limit (nvidia-smi), torch/CUDA versions; TF32 off.
2. build    nvcc-builds every kernel source of the port in parallel; ptxas's
            registers and spills per kernel ([BUILD] lines, one per bf16
            flash instantiation and per bf16 ViT GEMM and attention-core
            instantiation).
3. kernels  every hand-written kernel against its plain PyTorch version on the
            card, fp32 and bf16: the ViT block kernels at ViT-B/16, ViT-Ti/16, a
            pruned FFN width and the ``vit_procgen`` shapes, gates {0, 0.5, 1},
            with and without a neuron mask (their plain versions launch no
            kernel); the attention core alone against ``sdpa_reference`` by
            ``flash_errors`` at the ViT-B/16, ViT-Ti/16, ``vit_procgen`` and
            s=257 shapes, with the criteria's teeth (the ragged last query
            tile zeroed, two heads swapped); the ViT GEMM at its edge shapes
            (1-12608 rows, K 682, N 250 and 2305, A off 16 bytes, each
            epilogue with the stats, the same bits twice); ``flash_attention`` at the
            Llama-2-7B (b=1, and b=8 as the 2SSP candidate search runs it),
            Mistral-7B (GQA + window), ``code_llm_small`` and ragged shapes
            (head_dim 32 to 256, softcap); its lse output and the backward
            kernels (``flash_attention_bwd_dq``, ``_dkv``) at the same
            Llama-2-7B, Mistral-7B, ``code_llm_small`` and ragged shapes;
            every flash case also by ``flash_errors`` (the RMS error of the
            whole tensor and of its worst 64-row tile), whose teeth are
            shown on copies of the plain result with a late tile zeroed or
            two heads swapped; bf16 flash again with q one element off 16
            bytes (the element-load producer) and a second run's bits;
            ``quant4_matmul`` and ``quant_matmul`` at the Llama-2-7B
            projections, a ragged pruned K, the tile pipeline's edges (1-300
            rows, K = 682 and 8190, N = 250, an x one element off 16 bytes)
            and 16384 rows, the same bits on a second run; ``fused_mlp_int8``
            at decode and prefill rows and the same edges; ``fused_ffn_block``
            under autograd (a grad_fn, gradients against the host CPU's) and
            the attention blocks raising under autograd; the paged
            decode kernels. Times kernel, plain version and a PyTorch library
            call with CUDA events, beside the data-sheet bound; then times each
            launch inside the wrappers ([PART] lines) beside ``torch.mm`` and
            SDPA. The op-level ``ops.ffn.ffn_forward`` is driven on the card
            against the same call on CPU copies.
4. main     the 2SSP CLI (``cli.auto_2ssp.run``) on full-width ViT-B/16 with
            random weights and the synthetic dataset, then on ViT-Ti/16 (odd
            head count); then the LLM CLI (``cli.main_llm.run``) on a
            Llama-2-7B-width model (32 layers, random bf16 weights made on the
            card): 25% 2SSP with dense and pruned perplexity at s=2048, and a
            dense ``--quantize int4`` evaluation; the same model served over
            HTTP on 127.0.0.1; then the training CLI (``cli.train_llm.run``)
            on a fresh bf16 model of the same shape, 4 updates at b=1, s=2048
            with remat, and a profiler split of one update. Kernel launches
            per run, each driven path with the counts set to 0 just before it.
5. anchor   the committed trained checkpoints: ``ckpts/vit_procgen`` (dense top-1
            and top-1 after 25% 2SSP) and ``ckpts/code_llm_small`` (perplexity
            against the pinned value and the host CPU's plain path; int8, int4,
            25% 2SSP; served tokens; fp32 training on the card against the
            host CPU, a bit-exact resume and gradient accumulation).

The last lines of standard output are the ``{"kernels": [...]}`` line, the card's
``name, power.limit`` line and ``{"ok": true, "device": {...}}``. Without a CUDA
device, or without the package beside this script, it exits non-zero and prints
no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

# Data-sheet peaks of one H100 SXM (dense): bf16 tensor cores, fp32 outside the
# tensor cores, HBM3 bandwidth. Rates assume the card's full 700 W power limit.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

# Tolerances on the kernel's error in the branch it computes (see branch_err),
# over the branch's own max |plain|, per dtype. fp32: both sides are exact fp32
# products summed in different orders (TF32 off). bf16: the plain version
# rounds every intermediate (q/k/v, P, h, the branch) to bf16 at other places
# than the kernel, which keeps them in fp32 until the store; one bf16 ulp is
# 2^-8 to 2^-7 of the magnitude.
TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 10, warmup: int = 3) -> float:
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


def scaled_err(got, ref) -> tuple:
    """(max abs error, that error over max(1, max |ref|))."""
    err = (got.float() - ref.float()).abs().max().item()
    return err, err / max(1.0, ref.float().abs().max().item())


def branch_err(got, ref, x=None) -> tuple:
    """(max |got - ref|, scaled error) of a kernel computing x + branch (x=None:
    the branch alone). Each element may differ by one rounding of the output
    dtype at its magnitude, since both sides round x + branch once at the store;
    the scaled error is the largest excess over that, divided by the branch's
    own max |plain| (ref - x), so the residual cannot widen the limit."""
    import torch

    eps = torch.finfo(got.dtype).eps
    got, ref = got.float(), ref.float()
    diff = (got - ref).abs()
    branch = ref if x is None else ref - x.float()
    excess = (diff - eps * ref.abs()).clamp_min(0.0).max().item()
    return diff.max().item(), excess / branch.abs().max().item()


# ---------------------------------------------------------------- phase 3 ---

def _attn_inputs(gen, b, s, d, dtype, device):
    import torch

    def rn(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen, device=device) * std).to(dtype)

    return dict(x=rn(b, s, d), ln_scale=(1 + rn(d, std=0.1).float()).to(dtype),
                ln_bias=rn(d, std=0.1), qkv_kernel=rn(d, 3 * d, std=d ** -0.5),
                qkv_bias=rn(3 * d, std=0.1), proj_kernel=rn(d, d, std=d ** -0.5),
                proj_bias=rn(d, std=0.1))


def _ffn_inputs(gen, b, s, d, f, dtype, device):
    import torch

    def rn(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen, device=device) * std).to(dtype)

    return dict(x=rn(b, s, d), ln_scale=(1 + rn(d, std=0.1).float()).to(dtype),
                ln_bias=rn(d, std=0.1), fc1_kernel=rn(d, f, std=d ** -0.5),
                fc1_bias=rn(f, std=0.1), fc2_kernel=rn(f, d, std=f ** -0.5),
                fc2_bias=rn(d, std=0.1))


def _attn_bound(b, s, d, heads, elem):
    m, hd = b * s, d // heads
    flops = 2 * m * d * 3 * d + 2 * m * d * d + 4 * b * heads * s * s * hd
    nbytes = 2 * m * d * elem + (4 * d * d + 6 * d) * elem + 4
    return flops, nbytes


def _ffn_bound(b, s, d, f, elem, block):
    m = b * s
    flops = 4 * m * d * f
    nbytes = 2 * m * d * elem + (2 * d * f + f + d) * elem + 4 * b * f + 4 * f
    if block:
        nbytes += 2 * d * elem + 4
    return flops, nbytes


def _bound(flops, nbytes, dtype_name):
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype_name], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def phase_kernels(device) -> dict:
    """Hold every kernel against its plain version; return the kernels-line
    records keyed by wrapper name (timed at the main path's ViT shape, bf16)."""
    import torch
    import torch.nn.functional as F

    from ssp_x_vit_tpu_torch.ops.kernels import fused_attn_block as fab
    from ssp_x_vit_tpu_torch.ops.kernels import fused_ffn as ffk
    from ssp_x_vit_tpu_torch.ops.kernels import launch_counts

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    records = {}
    errs = {}  # (wrapper, dtype) -> (max abs error, allowed abs error) at the timed shape

    attn_cases = [  # (wrapper, plain, (b, s, d, heads), timed)
        ("fused_attn_block_v2", (64, 197, 768, 12), True),
        ("fused_attn_block_v2", (64, 65, 256, 4), False),
        ("fused_attn_block_v2", (1, 197, 768, 12), False),  # split-K, 16-row query tiles
        ("fused_attn_block", (64, 197, 192, 3), True),
        ("fused_attn_block", (64, 197, 768, 12), False),
    ]
    for name, (b, s, d, heads), timed in attn_cases:
        wrapper = getattr(fab, name)
        plain = getattr(fab, name + "_plain")
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[1]
            inp = _attn_inputs(gen, b, s, d, dtype, device)
            args = [inp[k] for k in ("x", "ln_scale", "ln_bias", "qkv_kernel", "qkv_bias",
                                     "proj_kernel", "proj_bias")]
            worst, worst_rel = 0.0, 0.0
            for gate_val in (0.0, 0.5, 1.0):
                gate = torch.full((), gate_val, dtype=torch.float32, device=device)
                got = wrapper(*args, heads, gate=gate)
                flash_before = launch_counts["flash_attention"]
                ref = plain(*args, heads, gate=gate)
                torch.cuda.synchronize()
                if launch_counts["flash_attention"] != flash_before:
                    raise AssertionError(f"{name}_plain launched the flash kernel: the plain "
                                         f"version must be plain PyTorch")
                if gate_val == 0.0:
                    if not torch.equal(got, inp["x"]):
                        raise AssertionError(f"{name} gate=0 is not the identity residual")
                    continue
                err, rel = branch_err(got, ref, inp["x"])
                if rel > TOL[dn]:
                    raise AssertionError(f"{name} b={b} s={s} d={d} heads={heads} {dn} "
                                         f"gate={gate_val}: scaled error {rel:.3e} > {TOL[dn]}")
                worst, worst_rel = max(worst, err), max(worst_rel, rel)
            log(f"[KERNEL] {name} b={b} s={s} d={d} heads={heads} {dn} gates 0/0.5/1: "
                f"max_abs_err={worst:.3e} scaled={worst_rel:.3e} tol={TOL[dn]} ok")
            if timed:
                errs[(name, dn)] = (worst, worst_rel)
            if timed and dtype == torch.bfloat16:
                gate = torch.ones((), dtype=torch.float32, device=device)
                k_ms = time_ms(lambda: wrapper(*args, heads, gate=gate))
                p_ms = time_ms(lambda: plain(*args, heads, gate=gate))
                w_qkv_t, w_proj_t = inp["qkv_kernel"].t().contiguous(), inp["proj_kernel"].t().contiguous()

                def library():
                    y = F.layer_norm(inp["x"], (d,), inp["ln_scale"], inp["ln_bias"], 1e-12)
                    q, k, v = F.linear(y, w_qkv_t, inp["qkv_bias"]).split(d, dim=-1)
                    q, k, v = (t.reshape(b, s, heads, d // heads).transpose(1, 2) for t in (q, k, v))
                    o = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(b, s, d)
                    return inp["x"] + gate.to(dtype) * F.linear(o, w_proj_t, inp["proj_bias"])

                l_ms = time_ms(library)
                flops, nbytes = _attn_bound(b, s, d, heads, 2)
                bound_ms, bound_by = _bound(flops, nbytes, dn)
                records[name] = dict(
                    name=name, route="cuda",
                    source="ssp_x_vit_tpu_torch/ops/kernels/csrc/gemm.cu + csrc/attention.cu",
                    replaces=("ssp_x_vit_tpu/ops/pallas/fused_attn_block.py:219"
                              if name == "fused_attn_block_v2"
                              else "ssp_x_vit_tpu/ops/pallas/fused_attn_block.py:287"),
                    tpu_kernel=name, shape=f"b={b} s={s} d={d} heads={heads} bf16",
                    max_abs_err=worst, scaled_err=worst_rel, tol=TOL[dn],
                    max_abs_err_fp32=errs[(name, "float32")][0],
                    scaled_err_fp32=errs[(name, "float32")][1], tol_fp32=TOL["float32"],
                    ms=k_ms, kernel_ms=k_ms, plain_ms=p_ms,
                    bound_ms=bound_ms, bound_by=bound_by, library_ms=l_ms, flops=flops,
                    bytes=nbytes)
                log(f"[TIME] {name} {records[name]['shape']}: kernel {k_ms:.4f} ms, plain "
                    f"{p_ms:.4f} ms, library {l_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")

    ffn_cases = [  # (b, s, d, f, timed)
        (64, 197, 768, 3072, True),
        (64, 197, 192, 768, False),
        (64, 197, 768, 2305, False),
        (64, 65, 256, 1024, False),
        (1, 197, 768, 3072, False),  # split-K GEMMs, stats from the split reduce
    ]
    for name in ("fused_ffn_block", "fused_ffn"):
        block = name == "fused_ffn_block"
        wrapper = getattr(ffk, name)
        plain = getattr(ffk, name + "_plain")
        for b, s, d, f, timed in ffn_cases:
            for dtype in (torch.float32, torch.bfloat16):
                dn = str(dtype).split(".")[1]
                inp = _ffn_inputs(gen, b, s, d, f, dtype, device)
                mask = (torch.rand(f, generator=gen, device=device) > 0.3).float()
                if block:
                    args = [inp[k] for k in ("x", "ln_scale", "ln_bias", "fc1_kernel",
                                             "fc1_bias", "fc2_kernel", "fc2_bias")]
                    variants = [dict(gate=torch.full((), g, device=device), neuron_mask=nm)
                                for g in (0.0, 0.5, 1.0) for nm in (None, mask)]
                else:
                    args = [inp[k] for k in ("x", "fc1_kernel", "fc1_bias", "fc2_kernel",
                                             "fc2_bias")]
                    variants = [dict(neuron_mask=nm) for nm in (None, mask)]
                worst, worst_rel, worst_stats = 0.0, 0.0, 0.0
                for kw in variants:
                    got, got_stats = wrapper(*args, collect_stats=True, **kw)
                    ref, ref_stats = plain(*args, collect_stats=True, **kw)
                    torch.cuda.synchronize()
                    gate0 = block and kw["gate"].item() == 0.0
                    if gate0 and not torch.equal(got, inp["x"]):
                        raise AssertionError(f"{name} gate=0 is not the identity residual")
                    err, rel = (0.0, 0.0) if gate0 else branch_err(got, ref, inp["x"] if block else None)
                    s_err = (got_stats - ref_stats).abs().max().item()
                    s_rel = s_err / ref_stats.abs().max().item()
                    if rel > TOL[dn] or s_rel > TOL[dn]:
                        desc = (f"gate={kw['gate'].item()} " if "gate" in kw else "") + \
                            f"mask={'yes' if kw['neuron_mask'] is not None else 'no'}"
                        raise AssertionError(f"{name} b={b} s={s} d={d} f={f} {dn} {desc}: scaled "
                                             f"error {rel:.3e}, stats {s_rel:.3e} > {TOL[dn]}")
                    worst_rel, worst_stats = max(worst_rel, rel), max(worst_stats, s_rel)
                    worst = max(worst, err)
                log(f"[KERNEL] {name} b={b} s={s} d={d} f={f} {dn} "
                    f"{'gates 0/0.5/1 x ' if block else ''}mask/no mask, stats: "
                    f"max_abs_err={worst:.3e} scaled={worst_rel:.3e} stats_rel={worst_stats:.3e} "
                    f"tol={TOL[dn]} ok")
                if timed:
                    errs[(name, dn)] = (worst, worst_rel)
                if timed and dtype == torch.bfloat16:
                    kw = dict(neuron_mask=mask, collect_stats=True)
                    if block:
                        kw["gate"] = torch.ones((), device=device)
                    k_ms = time_ms(lambda: wrapper(*args, **kw))
                    p_ms = time_ms(lambda: plain(*args, **kw))
                    w1t, w2t = inp["fc1_kernel"].t().contiguous(), inp["fc2_kernel"].t().contiguous()
                    mask_t = mask.to(dtype)

                    def library():
                        y = inp["x"]
                        if block:
                            y = F.layer_norm(y, (d,), inp["ln_scale"], inp["ln_bias"], 1e-12)
                        h = F.gelu(F.linear(y, w1t, inp["fc1_bias"])) * mask_t
                        out = F.linear(h, w2t, inp["fc2_bias"])
                        return inp["x"] + out if block else out

                    l_ms = time_ms(library)
                    flops, nbytes = _ffn_bound(b, s, d, f, 2, block)
                    bound_ms, bound_by = _bound(flops, nbytes, dn)
                    records[name] = dict(
                        name=name, route="cuda", source="ssp_x_vit_tpu_torch/ops/kernels/csrc/gemm.cu",
                        replaces=("ssp_x_vit_tpu/ops/pallas/fused_ffn.py:334" if block
                                  else "ssp_x_vit_tpu/ops/pallas/fused_ffn.py:215"),
                        tpu_kernel=name, shape=f"b={b} s={s} d={d} f={f} bf16 mask stats",
                        max_abs_err=worst, scaled_err=worst_rel, tol=TOL[dn],
                        max_abs_err_fp32=errs[(name, "float32")][0],
                        scaled_err_fp32=errs[(name, "float32")][1], tol_fp32=TOL["float32"],
                        ms=k_ms, kernel_ms=k_ms, plain_ms=p_ms,
                        bound_ms=bound_ms, bound_by=bound_by, library_ms=l_ms, flops=flops,
                        bytes=nbytes)
                    log(f"[TIME] {name} {records[name]['shape']}: kernel {k_ms:.4f} ms, plain "
                        f"{p_ms:.4f} ms, library {l_ms:.4f} ms (no stats), bound "
                        f"{bound_ms:.4f} ms ({bound_by})")
    return records


def check_vit_block_gradients(device) -> None:
    """Under autograd, fused_ffn_block runs its kernel inside an autograd
    Function: the output has a grad_fn and the gradients of every input (the
    gate a tensor) match the host CPU's fp32 autodiff of the plain version,
    fp32 and bf16, at ViT-B/16 width (b=2); the fused attention blocks, which
    have no backward, raise under autograd."""
    import torch

    from ssp_x_vit_tpu_torch.ops.kernels import fused_attn_block as fab
    from ssp_x_vit_tpu_torch.ops.kernels import fused_ffn as ffk
    from ssp_x_vit_tpu_torch.ops.kernels import launch_counts

    gen = torch.Generator().manual_seed(13)
    b, s, d, f = 2, 197, 768, 3072
    host = [torch.randn(b, s, d, generator=gen), 1 + 0.1 * torch.randn(d, generator=gen),
            0.1 * torch.randn(d, generator=gen), torch.randn(d, f, generator=gen) * d ** -0.5,
            0.1 * torch.randn(f, generator=gen), torch.randn(f, d, generator=gen) * f ** -0.5,
            0.1 * torch.randn(d, generator=gen), torch.full((), 0.7)]
    mask = (torch.rand(f, generator=gen) > 0.3).float()
    g_out = torch.randn(b, s, d, generator=gen)
    names = ("x", "ln_scale", "ln_bias", "fc1_kernel", "fc1_bias", "fc2_kernel", "fc2_bias", "gate")

    def grads(dev, dtype):
        leaves = [t.to(dev, dtype if t.dim() else torch.float32, copy=True).requires_grad_()
                  for t in host]
        out, stats = ffk.fused_ffn_block(*leaves[:7], neuron_mask=mask.to(dev), gate=leaves[7],
                                         collect_stats=True)
        if out.grad_fn is None or stats.grad_fn is not None:
            raise AssertionError("fused_ffn_block under autograd: no grad_fn on the output")
        out.backward(g_out.to(dev, dtype))
        return [t.grad.float().cpu() for t in leaves]

    ref = grads("cpu", torch.float32)
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        before = launch_counts["fused_ffn_block"]
        got = grads(device, dtype)
        torch.cuda.synchronize()
        if launch_counts["fused_ffn_block"] - before != 1:
            raise AssertionError("fused_ffn_block under autograd did not launch its kernel once")
        worst = 0.0
        for name, a, r in zip(names, got, ref):
            rel = (a - r).abs().max().item() / max(1.0, r.abs().max().item())
            if rel > TOL[dn]:
                raise AssertionError(f"fused_ffn_block gradient of {name} {dn}: scaled error "
                                     f"{rel:.3e} > {TOL[dn]}")
            worst = max(worst, rel)
        log(f"[KERNEL] fused_ffn_block under autograd b={b} s={s} d={d} f={f} {dn}: grad_fn set, "
            f"gradients of {len(names)} inputs vs the host CPU's fp32 autodiff: worst scaled "
            f"error {worst:.3e} tol={TOL[dn]} ok")
    x = host[0].to(device, torch.bfloat16).requires_grad_()
    attn = [t.to(device, torch.bfloat16) for t in (
        torch.ones(d), torch.zeros(d), torch.randn(d, 3 * d, generator=gen) * 0.03,
        torch.zeros(3 * d), torch.randn(d, d, generator=gen) * 0.03, torch.zeros(d))]
    for name, heads in (("fused_attn_block_v2", 12), ("fused_attn_block", 3)):
        try:
            getattr(fab, name)(x, *attn, heads)
        except RuntimeError as e:
            if "allow_fused_attn=False" not in str(e):
                raise
            log(f"[KERNEL] {name} under autograd raises as it should: {e}")
        else:
            raise AssertionError(f"{name} under autograd returned instead of raising")


def check_vit_core(device) -> None:
    """The attention core alone (``build.attention``, csrc/attention.cu) against
    ``attention_core_plain`` (``sdpa_reference`` per head) on the same fused
    QKV buffer, by ``flash_errors`` on the [b, h, s, hd] views and the scaled
    error, at the ViT-B/16, ViT-Ti/16 and ``vit_procgen`` shapes (b=64) and at
    s=257 (two passes over the keys), fp32 and bf16; the criteria must reject
    a copy of the plain output with the ragged last query tile of each image
    zeroed and one with two heads swapped."""
    import torch

    from ssp_x_vit_tpu_torch.ops.kernels import build
    from ssp_x_vit_tpu_torch.ops.kernels import fused_attn_block as fab

    gen = torch.Generator(device=device)
    gen.manual_seed(5)
    for label, b, s, heads, hd in (("ViT-B/16", 64, 197, 12, 64), ("ViT-Ti/16", 64, 197, 3, 64),
                                   ("vit_procgen", 64, 65, 4, 64), ("s=257", 4, 257, 12, 64)):
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[1]
            d = heads * hd
            qkv = torch.randn(b * s, 3 * d, generator=gen, device=device).to(dtype)
            got = build.attention(qkv, torch.empty(b * s, d, device=device, dtype=dtype), b, s,
                                  heads, hd, hd ** -0.5)
            ref = fab.attention_core_plain(qkv, b, s, heads)
            torch.cuda.synchronize()
            what = f"attention core {label} b={b} s={s} heads={heads} hd={hd}"
            err, rel = scaled_err(got, ref)
            if rel > TOL[dn]:
                raise AssertionError(f"{what} {dn}: scaled error {rel:.3e} > {TOL[dn]}")
            got_v, ref_v = fab.head_view(got, b, s, heads), fab.head_view(ref, b, s, heads)
            whole, tile = flash_check(what, got_v, ref_v, dn)
            log(f"[KERNEL] {what} {dn} vs sdpa_reference: max_abs_err={err:.3e} scaled={rel:.3e} "
                f"whole={whole:.3e} tile={tile:.3e} ok")
            check_flash_teeth(what, ref_v, dn, start=(s - 1) // 64 * 64)  # the ragged last tile


def check_vit_gemm_edges(device) -> None:
    """The ViT block GEMM (``build.gemm``, csrc/gemm.cu) against ``gemm_plain``
    where its tiles change course: M = 1, 197, 300, 12608 (split-K at the
    small ones), (K, N) = (192, 576), (768, 2305), (682, 250) (element loads
    where K or N is not a multiple of 8), A one element off 16 bytes; each
    epilogue, GELU with the mask and the stats; the output's bits equal on a
    second launch without stats. fp32 and bf16."""
    import torch

    from ssp_x_vit_tpu_torch.ops.kernels import build
    from ssp_x_vit_tpu_torch.ops.kernels.fused_ffn import gemm_plain

    gen = torch.Generator(device=device)
    gen.manual_seed(6)
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]

        def rn(*shape, std=1.0, offset=0):
            numel = 1
            for n_ in shape:
                numel *= n_
            t = (torch.randn(numel + offset, generator=gen, device=device) * std).to(dtype)
            return t[offset:].view(*shape)

        worst, worst_stats = 0.0, 0.0
        for m in (1, 197, 300, 12608):
            seq = 197 if m % 197 == 0 else 25 if m % 25 == 0 else m
            for k, n in ((192, 576), (768, 2305), (682, 250)):
                w, bias = rn(k, n, std=k ** -0.5), rn(n, std=0.1)
                resid, gate = rn(m, n), torch.full((), 0.5, device=device)
                mask = (torch.rand(n, generator=gen, device=device) > 0.3).float()
                for offset in (0, 1):
                    a = rn(m, k, offset=offset)
                    for epi, kw in ((build.EPI_BIAS, {}), (build.EPI_GELU, dict(mask=mask)),
                                    (build.EPI_RESIDUAL, dict(resid=resid, gate=gate))):
                        stats = (torch.empty(m // seq, n, device=device)
                                 if epi == build.EPI_GELU else None)
                        got = build.gemm(a, w, torch.empty(m, n, device=device, dtype=dtype), epi,
                                         bias=bias, stats=stats, seq=seq, **kw)
                        again = build.gemm(a, w, torch.empty_like(got), epi, bias=bias, seq=seq, **kw)
                        ref, ref_stats = gemm_plain(a, w, epi, bias=bias, seq=seq,
                                                    collect_stats=stats is not None, **kw)
                        torch.cuda.synchronize()
                        what = f"gemm m={m} k={k} n={n} epi={epi} off16={offset} {dn}"
                        if not torch.equal(got, again):
                            raise AssertionError(f"{what}: a second launch gave other bits")
                        rel = scaled_err(got, ref)[1]
                        s_rel = 0.0 if stats is None else (
                            (stats - ref_stats).abs().max().item() / ref_stats.abs().max().item())
                        if rel > TOL[dn] or s_rel > TOL[dn]:
                            raise AssertionError(f"{what}: scaled error {rel:.3e}, stats {s_rel:.3e}")
                        worst, worst_stats = max(worst, rel), max(worst_stats, s_rel)
        log(f"[KERNEL] gemm edges {dn} (M 1/197/300/12608, (K, N) (192, 576) / (768, 2305) / "
            f"(682, 250), A off 16 bytes, bias / gelu+mask+stats / residual, same bits twice): "
            f"scaled={worst:.3e} stats_rel={worst_stats:.3e} tol={TOL[dn]} ok")


def drive_ffn_forward(device) -> int:
    """The op-level FFN entry (``ops.ffn.ffn_forward``, the counterpart of the
    JAX package's dispatching ``ffn_forward``) on CUDA tensors at the ViT-B/16
    shape, against the same call on CPU copies; returns the ``fused_ffn``
    launches this drive made."""
    import torch

    from ssp_x_vit_tpu_torch.ops.ffn import ffn_forward
    from ssp_x_vit_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    gen = torch.Generator(device=device)
    gen.manual_seed(2)
    b, s, d, f = 8, 197, 768, 3072  # 8 images keep the CPU side of the comparison short
    reset_launch_counts()
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        inp = _ffn_inputs(gen, b, s, d, f, dtype, device)
        mask = (torch.rand(f, generator=gen, device=device) > 0.3).float()
        args = [inp[k] for k in ("x", "fc1_kernel", "fc1_bias", "fc2_kernel", "fc2_bias")]
        got, got_stats = ffn_forward(*args, neuron_mask=mask, collect_stats=True)
        ref, ref_stats = ffn_forward(*[a.cpu() for a in args], neuron_mask=mask.cpu(),
                                     collect_stats=True)
        torch.cuda.synchronize()
        err, rel = branch_err(got.cpu(), ref)
        s_rel = ((got_stats.cpu() - ref_stats).abs().max() / ref_stats.abs().max()).item()
        log(f"[KERNEL] ops.ffn.ffn_forward b={b} s={s} d={d} f={f} {dn} on the card vs the same "
            f"call on CPU copies: max_abs_err={err:.3e} scaled={rel:.3e} stats_rel={s_rel:.3e} "
            f"tol={TOL[dn]} ok")
        if rel > TOL[dn] or s_rel > TOL[dn]:
            raise AssertionError(f"ffn_forward {dn}: scaled error {rel:.3e}, stats {s_rel:.3e}")
    launches = launch_counts["fused_ffn"]
    if launches != 2:
        raise AssertionError(f"ffn_forward launched fused_ffn {launches} times, expected 2")
    return launches


def drive_quant_matmul(device) -> int:
    """``quant_matmul`` (int8) has no caller in either package: ``mm_quant``'s
    int8 branch is a plain product with a convert, as in the JAX package. Its
    public wrapper is driven here at the Llama-2-7B gate projection on weights
    from ``quantize_weight_int8``, against that int8 branch of ``mm_quant``;
    returns the launches this drive made."""
    import torch

    from ssp_x_vit_tpu_torch.llm.quant import quantize_weight_int8
    from ssp_x_vit_tpu_torch.ops.common import mm_quant
    from ssp_x_vit_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from ssp_x_vit_tpu_torch.ops.kernels.quant_matmul import quant_matmul

    gen = torch.Generator(device=device)
    gen.manual_seed(6)
    m, k, n = 2048, 4096, 11008
    w_q, scale = quantize_weight_int8(torch.randn(k, n, generator=gen, device=device) * 0.02)
    reset_launch_counts()
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        x = torch.randn(m, k, generator=gen, device=device).to(dtype)
        got = quant_matmul(x, w_q, scale)
        ref = mm_quant(x, {"w_q": w_q, "w_scale": scale}, "w", dtype)
        torch.cuda.synchronize()
        err, rel = scaled_err(got, ref)
        log(f"[KERNEL] quant_matmul M={m} K={k} N={n} {dn} vs mm_quant's int8 branch "
            f"(torch.matmul with a convert): max_abs_err={err:.3e} scaled={rel:.3e} "
            f"tol={TOL[dn]} ok")
        if rel > TOL[dn]:
            raise AssertionError(f"quant_matmul vs mm_quant {dn}: scaled error {rel:.3e}")
    return launch_counts["quant_matmul"]


def flash_check(label, got, ref, dn) -> tuple:
    """The flash criteria beside the scaled error: ``flash_errors`` (RMS error
    of the whole tensor and of its worst 64-row tile, relative to the plain
    version's with an absolute allowance), each within ``FLASH_LIMITS``;
    raises otherwise. Returns (whole, tile)."""
    from ssp_x_vit_tpu_torch.ops.kernels.flash_attention import FLASH_LIMITS, flash_errors

    rel, tile = flash_errors(got, ref)
    rel_lim, tile_lim, _ = FLASH_LIMITS[got.dtype]
    if rel > rel_lim or tile > tile_lim:
        raise AssertionError(f"{label} {dn}: relative error {rel:.3e} (limit {rel_lim}), worst "
                             f"64-row tile {tile:.3e} (limit {tile_lim})")
    return rel, tile


def check_flash_teeth(label, ref, dn, start=None) -> None:
    """The flash criteria reject a copy of the plain result ``ref`` [b, h, s, hd]
    with one 64-row query tile zeroed (a late one, or the one from row
    ``start``), and one with two heads swapped; logs what the scaled error
    alone says of the same copies."""
    from ssp_x_vit_tpu_torch.ops.kernels.flash_attention import flash_agrees

    s = ref.shape[2]
    if start is None:
        start = max(0, (s // 64 - 2) * 64)
    zeroed = ref.clone()
    zeroed[:, :, start:start + 64] = 0
    swapped = ref.clone()
    swapped[:, [0, 1]] = ref[:, [1, 0]]
    for what, bad in ((f"query rows {start}-{min(s, start + 64) - 1} zeroed", zeroed),
                      ("heads 0 and 1 swapped", swapped)):
        if flash_agrees(bad, ref):
            raise AssertionError(f"flash criteria accept {label} {dn} with {what}")
        log(f"[KERNEL] flash criteria reject {label} {dn} with {what} (scaled error alone: "
            f"{scaled_err(bad, ref)[1]:.3e}, tol {TOL[dn]})")


def _off16(t):
    """A copy of t whose data starts one element off 16 bytes."""
    import torch

    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view_as(t)
    out.copy_(t)
    return out


def _attended_pairs(s: int, causal: bool, window) -> int:
    """Unmasked (query, key) pairs of one head."""
    if not causal:
        return s * s
    if window is None or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def _sdpa_library(q, k, v, causal, window):
    """One PyTorch call computing the same function (the yardstick; the port
    never calls it): SDPA, GQA by ``enable_gqa``, a window by a boolean mask."""
    import torch
    import torch.nn.functional as F

    kw = {}
    if q.shape[1] != k.shape[1]:
        kw["enable_gqa"] = True
    if window is not None:
        s = q.shape[2]
        i = torch.arange(s, device=q.device)
        kw["attn_mask"] = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < window)
    else:
        kw["is_causal"] = causal
    return lambda: F.scaled_dot_product_attention(q, k, v, **kw)


def phase_llm_kernels(device) -> dict:
    """flash_attention, quant4_matmul and quant_matmul against their plain
    versions; returns their kernels-line records (timed at the Llama-2-7B
    shapes of the main path, bf16)."""
    import torch

    from ssp_x_vit_tpu_torch.ops.attention import flash_attention
    from ssp_x_vit_tpu_torch.ops.kernels import flash_attention as tfa
    from ssp_x_vit_tpu_torch.ops.kernels import quant_matmul as tqm

    gen = torch.Generator(device=device)
    gen.manual_seed(3)
    records = {}

    def rn(shape, dtype, std=1.0):
        return (torch.randn(*shape, generator=gen, device=device) * std).to(dtype)

    flash_cases = [  # (label, b, h, hkv, s, hd, causal, window, softcap, timed)
        ("Llama-2-7B", 1, 32, 32, 2048, 128, True, None, None, True),
        ("Llama-2-7B search", 8, 32, 32, 2048, 128, True, None, None, True),  # the candidate batch
        ("Mistral-7B", 1, 32, 8, 4096, 128, True, 1024, None, True),
        ("code_llm_small", 2, 6, 2, 1024, 64, True, None, None, False),
        ("ViT", 2, 4, 4, 197, 64, False, None, None, False),
        ("ragged", 1, 2, 2, 160, 32, True, None, None, False),
        ("phi head_dim", 1, 8, 4, 300, 80, True, None, None, False),
        ("gemma head_dim", 1, 4, 2, 257, 256, True, None, 50.0, False),
    ]
    errs = {}
    for label, b, h, hkv, s, hd, causal, window, softcap, timed in flash_cases:
        kw = dict(causal=causal, window=window, softcap=softcap)
        shape = (f"b={b} h={h} hkv={hkv} s={s} hd={hd}" + (" causal" if causal else "")
                 + (f" window={window}" if window else "") + (f" softcap={softcap}" if softcap else ""))
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[1]
            q, k, v = rn((b, h, s, hd), dtype), rn((b, hkv, s, hd), dtype), rn((b, hkv, s, hd), dtype)
            got = flash_attention(q, k, v, **kw)
            ref = tfa.flash_attention_plain(q, k, v, **kw)
            torch.cuda.synchronize()
            if not torch.isfinite(got.float()).all():
                raise AssertionError(f"flash_attention {shape} {dn}: non-finite output")
            err, rel = scaled_err(got, ref)
            if rel > TOL[dn]:
                raise AssertionError(f"flash_attention {shape} {dn}: scaled error {rel:.3e}")
            frob, tile = flash_check(f"flash_attention {label} {shape}", got, ref, dn)
            extra = ""
            if dtype == torch.bfloat16:
                again = flash_attention(q, k, v, **kw)
                off = flash_attention(_off16(q), k, v, **kw)
                torch.cuda.synchronize()
                if not torch.equal(got, again):
                    raise AssertionError(f"flash_attention {shape} {dn}: two runs differ")
                off_frob, off_tile = flash_check(f"flash_attention {label} {shape} q off 16 bytes",
                                                 off, ref, dn)
                extra = (f"; q one element off 16 bytes (element loads): relative {off_frob:.3e}, "
                         f"worst tile {off_tile:.3e}; same bits on a second run")
            log(f"[KERNEL] flash_attention {label} {shape} {dn}: max_abs_err={err:.3e} "
                f"scaled={rel:.3e} tol={TOL[dn]}; relative {frob:.3e}, worst tile {tile:.3e}{extra} ok")
            if label == "Llama-2-7B":
                check_flash_teeth(f"flash_attention {label}", ref, dn)
            errs[(label, dn)] = (err, rel)
            if timed and dtype == torch.bfloat16:
                k_ms = time_ms(lambda: flash_attention(q, k, v, **kw))
                p_ms = time_ms(lambda: tfa.flash_attention_plain(q, k, v, **kw), iters=5, warmup=1)
                l_ms = time_ms(_sdpa_library(q, k, v, causal, window))
                flops = 4 * hd * _attended_pairs(s, causal, window) * b * h
                nbytes = 2 * (2 * b * h * s * hd + 2 * b * hkv * s * hd)
                bound_ms, bound_by = _bound(flops, nbytes, dn)
                log(f"[TIME] flash_attention {label} {shape} bf16: kernel {k_ms:.4f} ms "
                    f"({flops / k_ms / 1e9:.1f} TFLOP/s), plain {p_ms:.4f} ms, library SDPA "
                    f"{l_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
                if label == "Llama-2-7B search":
                    records["flash_attention"].update(
                        ms_b8=k_ms, plain_ms_b8=p_ms, library_ms_b8=l_ms, bound_ms_b8=bound_ms,
                        shape_b8=shape + " bf16")
                if label == "Llama-2-7B":
                    records["flash_attention"] = dict(
                        name="flash_attention", route="cuda",
                        source="ssp_x_vit_tpu_torch/ops/kernels/csrc/flash_attention.cu",
                        replaces="ssp_x_vit_tpu/ops/pallas/flash_attention.py:466",
                        tpu_kernel="flash_attention (forward)", shape=shape + " bf16",
                        max_abs_err=err, scaled_err=rel, tol=TOL[dn],
                        max_abs_err_fp32=errs[(label, "float32")][0],
                        scaled_err_fp32=errs[(label, "float32")][1], tol_fp32=TOL["float32"],
                        ms=k_ms, kernel_ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms,
                        bound_by=bound_by, library_ms=l_ms, flops=flops, bytes=nbytes)

    quant_cases = [  # (m, k, n, timed); the tiles take 16/32/64/128 activation rows
        (2048, 4096, 11008, True),
        (8, 4096, 11008, True),      # decode rows: split-K, bound by the weight bytes
        (2048, 11008, 4096, False),
        (2048, 8190, 4096, False),   # a 2SSP-pruned down projection: ragged K, element loads
        (1, 4096, 4096, False),      # split-K
        (16384, 384, 1024, False),   # 8 candidates x 2048 tokens at the code_llm_small width
        (17, 4096, 4096, False),
        (64, 682, 4096, False),      # K = 682: element loads
        (136, 4096, 250, False),     # N = 250: element loads
        (300, 4096, 4096, False),
    ]
    for name, bits in (("quant4_matmul", 4), ("quant_matmul", 8)):
        wrapper, plain = getattr(tqm, name), getattr(tqm, name + "_plain")
        for m, k, n, timed in quant_cases:
            shape = f"M={m} K={k} N={n}"
            # any byte is a valid pair of nibbles; int8 codes stay within [-127, 127]
            if bits == 4:
                w = torch.randint(-128, 128, (k // 2, n), generator=gen, device=device).to(torch.int8)
            else:
                w = torch.randint(-127, 128, (k, n), generator=gen, device=device).to(torch.int8)
            scale = torch.rand(n, generator=gen, device=device) * 0.01 + 0.001
            for dtype in (torch.float32, torch.bfloat16):
                dn = str(dtype).split(".")[1]
                x = rn((m, k), dtype)
                # the same rows one element off 16 bytes: the element-load producer
                x_off = rn((m * k + 1,), dtype)[1:].view(m, k)
                x_off.copy_(x)
                got, ref = wrapper(x, w, scale), plain(x, w, scale)
                again, off = wrapper(x, w, scale), wrapper(x_off, w, scale)
                torch.cuda.synchronize()
                if not torch.isfinite(got.float()).all():
                    raise AssertionError(f"{name} {shape} {dn}: non-finite output")
                if not torch.equal(got, again):
                    raise AssertionError(f"{name} {shape} {dn}: two runs differ")
                err, rel = scaled_err(got, ref)
                off_rel = scaled_err(off, ref)[1]
                if ref.float().abs().max().item() < 1.0:
                    raise AssertionError(f"{name} {shape} {dn}: max |plain| is under 1")
                log(f"[KERNEL] {name} {shape} {dn}: max_abs_err={err:.3e} scaled={rel:.3e} "
                    f"(x one element off 16 bytes: scaled={off_rel:.3e}) tol={TOL[dn]} ok "
                    f"(same bits on a second run)")
                if max(rel, off_rel) > TOL[dn]:
                    raise AssertionError(f"{name} {shape} {dn}: scaled error {rel:.3e} / "
                                         f"{off_rel:.3e} (offset x)")
                errs[(name, dn, m)] = (err, rel)
                if timed and dtype == torch.bfloat16:
                    k_ms = time_ms(lambda: wrapper(x, w, scale))
                    p_ms = time_ms(lambda: plain(x, w, scale))
                    unpack = tqm.unpack_int4 if bits == 4 else (lambda t: t)
                    w_bf16, scale_bf16 = unpack(w).to(dtype), scale.to(dtype)
                    l_ms = time_ms(lambda: torch.mm(x, w_bf16) * scale_bf16)
                    l_in_ms = time_ms(lambda: torch.mm(x, unpack(w).to(dtype)) * scale_bf16)
                    flops = 2 * m * n * k
                    nbytes = 2 * (m * k + m * n) + k * n * bits // 8 + 4 * n
                    bound_ms, bound_by = _bound(flops, nbytes, dn)
                    rate = (f"{nbytes / k_ms / 1e9:.2f} TB/s of the bytes it must move"
                            if bound_by == "bytes" else f"{flops / k_ms / 1e9:.1f} TFLOP/s")
                    log(f"[TIME] {name} {shape} bf16: kernel {k_ms:.4f} ms "
                        f"({rate}), plain {p_ms:.4f} ms, library "
                        f"torch.mm on a dequantised copy {l_ms:.4f} ms (dequantising inside the "
                        f"timed call: {l_in_ms:.4f} ms), bound {bound_ms:.4f} ms ({bound_by})")
                    if m != 2048:
                        continue
                    records[name] = dict(
                        name=name, route="cuda",
                        source="ssp_x_vit_tpu_torch/ops/kernels/csrc/quant_gemm.cu + csrc/qgemm_tile.cuh",
                        replaces="ssp_x_vit_tpu/ops/pallas/quant_matmul.py:111",
                        tpu_kernel=name, shape=shape + " bf16",
                        max_abs_err=err, scaled_err=rel, tol=TOL[dn],
                        max_abs_err_fp32=errs[(name, "float32", m)][0],
                        scaled_err_fp32=errs[(name, "float32", m)][1], tol_fp32=TOL["float32"],
                        ms=k_ms, kernel_ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms,
                        bound_by=bound_by, library_ms=l_ms, library_with_dequant_ms=l_in_ms,
                        flops=flops, bytes=nbytes)
    return records


def _masked_logits(q, k, causal, window, softcap):
    """fp32 [b, h, s, s] logits of the plain version, masked entries -inf."""
    import torch

    rep = q.shape[1] // k.shape[1]
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float().repeat_interleave(rep, 1))
    logits = logits * q.shape[-1] ** -0.5
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    if causal:
        i = torch.arange(q.shape[2], device=q.device)
        mask = i[None, :] <= i[:, None]
        if window is not None:
            mask = mask & (i[:, None] - i[None, :] < window)
        logits = logits.masked_fill(~mask, float("-inf"))
    return logits


def phase_flash_backward(device) -> dict:
    """The training path's flash kernels: the forward with its lse output and
    the backward (dq kernel, then dk/dv kernel) against the plain versions at
    the Llama-2-7B, Mistral-7B, ``code_llm_small`` and ragged shapes, fp32 and
    bf16 (dq, dk, dv each: scaled error <= TOL). Timed in bf16 at the
    Llama-2-7B and Mistral-7B shapes: each kernel, the whole backward, the
    plain backward, SDPA forward + backward through autograd (on repeated K/V
    for GQA), and the data-sheet bound. Returns the kernels-line records of
    both backward kernels (Llama-2-7B shape)."""
    import torch
    import torch.nn.functional as F

    from ssp_x_vit_tpu_torch.ops.kernels import build
    from ssp_x_vit_tpu_torch.ops.kernels import flash_attention as tfa

    gen = torch.Generator(device=device)
    gen.manual_seed(5)
    records = {}
    cases = [  # (label, b, h, hkv, s, hd, window, softcap, timed); all causal
        ("Llama-2-7B", 1, 32, 32, 2048, 128, None, None, True),
        ("Llama-2-7B search", 8, 32, 32, 2048, 128, None, None, True),  # the candidate batch
        ("Mistral-7B", 1, 32, 8, 4096, 128, 1024, None, True),
        ("code_llm_small", 2, 6, 2, 1024, 64, None, None, False),
        # windows of 16 / 40 leave whole key tiles, and the padded rows of the
        # last query tile, with no key
        ("ragged hd 80", 1, 4, 2, 197, 80, 16, 50.0, False),
        ("ragged hd 256", 1, 4, 2, 300, 256, 40, 50.0, False),
    ]
    for label, b, h, hkv, s, hd, window, softcap, timed in cases:
        kw = dict(causal=True, window=window, softcap=softcap)
        shape = (f"b={b} h={h} hkv={hkv} s={s} hd={hd} causal" + (f" window={window}" if window else "")
                 + (f" softcap={softcap}" if softcap else ""))
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[1]

            def rn(*shp):
                return torch.randn(*shp, generator=gen, device=device).to(dtype)

            q, k, v, g = rn(b, h, s, hd), rn(b, hkv, s, hd), rn(b, hkv, s, hd), rn(b, h, s, hd)
            out, lse = tfa.flash_attention_forward(q, k, v, with_lse=True, **kw)
            out_nolse, _ = tfa.flash_attention_forward(q, k, v, **kw)
            lse_ref = torch.logsumexp(_masked_logits(q, k, True, window, softcap), dim=-1)
            lse_err, lse_rel = scaled_err(lse, lse_ref)
            if not torch.equal(out, out_nolse) or lse_rel > TOL["float32"]:
                raise AssertionError(f"flash forward with lse {shape} {dn}: out changed or lse "
                                     f"off by {lse_rel:.3e}")
            got = tfa.flash_attention_backward(q, k, v, out, lse, g, **kw)
            ref = tfa.flash_attention_backward_plain(q, k, v, g, **kw)
            torch.cuda.synchronize()
            line, crit = [], []
            for name, a, r in zip(("dq", "dk", "dv"), got, ref):
                if not torch.isfinite(a.float()).all():
                    raise AssertionError(f"flash backward {shape} {dn}: non-finite {name}")
                err, rel = scaled_err(a, r)
                errs[(name, dn)] = (err, rel)
                line.append(f"{name} {err:.3e}/{rel:.3e}")
                if rel > TOL[dn]:
                    raise AssertionError(f"flash backward {shape} {dn}: {name} scaled error {rel:.3e}")
                frob, tile = flash_check(f"flash backward {label} {shape} {name}", a, r, dn)
                crit.append(f"{name} {frob:.3e}/{tile:.3e}")
            extra = ""
            if dtype == torch.bfloat16:
                again = tfa.flash_attention_backward(q, k, v, out, lse, g, **kw)
                off = tfa.flash_attention_backward(_off16(q), k, v, out, lse, g, **kw)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b_) for a, b_ in zip(got, again)):
                    raise AssertionError(f"flash backward {shape} {dn}: two runs differ")
                off_crit = []
                for name, a, r in zip(("dq", "dk", "dv"), off, ref):
                    frob, tile = flash_check(f"flash backward {label} {shape} q off 16 bytes {name}",
                                             a, r, dn)
                    off_crit.append(f"{name} {frob:.3e}/{tile:.3e}")
                extra = (f"; q one element off 16 bytes (element loads): relative/worst tile "
                         f"{', '.join(off_crit)}; same bits on a second run")
            log(f"[KERNEL] flash_attention backward {label} {shape} {dn}: max_abs_err/scaled "
                f"{', '.join(line)} tol={TOL[dn]}; relative/worst tile {', '.join(crit)}; lse "
                f"{lse_err:.3e}{extra}; ok")
            if label == "Llama-2-7B":
                for name, r in zip(("dq", "dk", "dv"), ref):
                    check_flash_teeth(f"flash backward {label} {name}", r, dn)
            if not (timed and dtype == torch.bfloat16):
                continue
            delta = torch.empty(b, h, s, dtype=torch.float32, device=device)
            dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
            bkw = dict(scale=hd ** -0.5, causal=True, window=window or 0, softcap=softcap or 0.0)
            fwd_ms = time_ms(lambda: tfa.flash_attention_forward(q, k, v, **kw))
            fwd_lse_ms = time_ms(lambda: tfa.flash_attention_forward(q, k, v, with_lse=True, **kw))
            bwd_ms = time_ms(lambda: tfa.flash_attention_backward(q, k, v, out, lse, g, **kw))
            dq_ms = time_ms(lambda: build.flash_attention_bwd_dq(q, k, v, out, g, lse, delta, dq, **bkw))
            dkv_ms = time_ms(lambda: build.flash_attention_bwd_dkv(q, k, v, g, lse, delta, dk, dv,
                                                                   **bkw))
            p_ms = time_ms(lambda: tfa.flash_attention_backward_plain(q, k, v, g, **kw), iters=3,
                           warmup=1)
            rep = h // hkv
            lq = q.detach().clone().requires_grad_()
            lk = k.repeat_interleave(rep, 1).requires_grad_()
            lv = v.repeat_interleave(rep, 1).requires_grad_()
            sdpa = _sdpa_library(lq, lk, lv, True, window)
            l_ms = time_ms(lambda: torch.autograd.grad(sdpa(), (lq, lk, lv), g))
            pairs = _attended_pairs(s, True, window) * b * h
            q_bytes, kv_bytes, stat_bytes = 2 * b * h * s * hd, 2 * b * hkv * s * hd, 4 * b * h * s
            bound_ms, bound_by = _bound(10 * hd * pairs, 4 * q_bytes + 4 * kv_bytes + stat_bytes, dn)
            dq_bound = _bound(6 * hd * pairs, 4 * q_bytes + 2 * kv_bytes + 2 * stat_bytes, dn)
            dkv_bound = _bound(8 * hd * pairs, 2 * q_bytes + 4 * kv_bytes + 2 * stat_bytes, dn)
            log(f"[TIME] flash_attention backward {label} {shape} bf16: dq kernel {dq_ms:.4f} ms "
                f"(bound {dq_bound[0]:.4f}), dk/dv kernel {dkv_ms:.4f} ms (bound {dkv_bound[0]:.4f}), "
                f"backward wrapper {bwd_ms:.4f} ms ({10 * hd * pairs / bwd_ms / 1e9:.1f} TFLOP/s of "
                f"10*hd per pair), bound {bound_ms:.4f} ms ({bound_by}), plain {p_ms:.4f} ms, "
                f"library SDPA forward + backward {l_ms:.4f} ms; forward {fwd_ms:.4f} ms, "
                f"with lse {fwd_lse_ms:.4f} ms")
            if label == "Llama-2-7B search":
                for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
                    records[name].update(
                        ms_b8=dq_ms if name.endswith("dq") else dkv_ms, backward_ms_b8=bwd_ms,
                        backward_bound_ms_b8=bound_ms, plain_ms_b8=p_ms, library_ms_b8=l_ms,
                        bound_ms_b8=(dq_bound if name.endswith("dq") else dkv_bound)[0])
            if label != "Llama-2-7B":
                continue
            common = dict(route="cuda",
                          source="ssp_x_vit_tpu_torch/ops/kernels/csrc/flash_attention_bwd.cu",
                          shape=shape + " bf16", tol=TOL["bfloat16"], tol_fp32=TOL["float32"],
                          plain_ms=p_ms, plain_covers="dq, dk and dv", library_ms=l_ms,
                          library="SDPA forward + backward through autograd",
                          backward_ms=bwd_ms, backward_bound_ms=bound_ms)
            for name, grads, ms, (kb_ms, kb_by), flops, line_no in (
                    ("flash_attention_bwd_dq", ("dq",), dq_ms, dq_bound, 6 * hd * pairs, 845),
                    ("flash_attention_bwd_dkv", ("dk", "dv"), dkv_ms, dkv_bound, 8 * hd * pairs, 879)):
                worst = max((errs[(gname, "bfloat16")] for gname in grads), key=lambda e: e[1])
                worst32 = max((errs[(gname, "float32")] for gname in grads), key=lambda e: e[1])
                records[name] = dict(
                    common, name=name, replaces=f"ssp_x_vit_tpu/ops/pallas/flash_attention.py:{line_no}",
                    tpu_kernel=("_flash_backward_streaming " + ("dq pass" if line_no == 845 else "dk/dv pass")
                                + " and _flash_backward_pallas (:608)"),
                    max_abs_err=worst[0], scaled_err=worst[1], max_abs_err_fp32=worst32[0],
                    scaled_err_fp32=worst32[1], ms=ms, kernel_ms=ms, bound_ms=kb_ms,
                    bound_by=kb_by, flops=flops)
    return records


def _paged_setup(gen, device, dtype, pool_kind, *, nq, nkv, hd, ps, lens, window=None,
                 layers=None, layer=None):
    """One decode step's operands at the given geometry: pools whose live rows
    are random (int8 pools: quantized random rows), a page table of shuffled
    physical pages with room for one more token per sequence, lengths, window
    starts, the new K/V rows and the query. ``layers``/``layer``: a 5D pool
    with only that layer filled."""
    import torch

    from ssp_x_vit_tpu_torch.ops.kernels.paged_attention import quantize_token_kv

    b = len(lens)
    need = [-(-(n + 1) // ps) for n in lens]
    mp, num_pages = max(need), 1 + sum(need)
    order = (1 + torch.randperm(num_pages - 1, generator=gen, device=device)).to(torch.int32)
    table = torch.zeros(b, mp, dtype=torch.int32, device=device)
    at = 0
    for i, n in enumerate(need):
        table[i, :n] = order[at:at + n]
        at += n

    def pool():
        shape = (nkv, num_pages, ps, hd)
        lead = () if layers is None else (layers,)
        if pool_kind == "int8":
            full = {"q": torch.zeros(lead + shape, dtype=torch.int8, device=device),
                    "s": torch.ones(lead + shape[:-1], dtype=torch.float32, device=device)}
            one = {k: (v if layers is None else v[layer]) for k, v in full.items()}
            for h in range(nkv):  # one head at a time bounds the fp32 temporary
                codes, sc = quantize_token_kv(torch.randn(shape[1:], generator=gen, device=device))
                one["q"][h], one["s"][h] = codes, sc
            return full
        full = torch.zeros(lead + shape, dtype=dtype, device=device)
        one = full if layers is None else full[layer]
        for h in range(nkv):
            one[h] = torch.randn(shape[1:], generator=gen, device=device).to(dtype)
        return full

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=device).to(dtype)

    lens_t = torch.tensor(lens, dtype=torch.int32, device=device)
    starts = None
    if window is not None:  # the query sits at position len: keys >= len + 1 - window
        starts = (lens_t + 1 - window).clamp_min(0).to(torch.int32)
    return dict(k=pool(), v=pool(), table=table, lens=lens_t, starts=starts,
                k_new=rn(b, nkv, hd), v_new=rn(b, nkv, hd), q=rn(b, nq, hd), layer=layer)


def _clone_pool(pool):
    return {k: v.clone() for k, v in pool.items()} if isinstance(pool, dict) else pool.clone()


def _pools_differ(a, b) -> int:
    """Number of elements (codes and scales of an int8 pool) that differ."""
    if isinstance(a, dict):
        return sum(_pools_differ(a[k], b[k]) for k in a)
    return int((a != b).sum().item())


def phase_paged_kernels(device) -> dict:
    """paged_attention, paged_attention_q8, paged_pool_write and
    paged_pool_write_q8 against their plain versions, as one decode step does
    them (write the new row at slot len, then attend len + 1 keys); returns
    their kernels-line records, timed at the Llama-2-7B decode shape of the
    served run (b=8, 2048 keys each, bf16 and int8 pools)."""
    import torch
    import torch.nn.functional as F

    from ssp_x_vit_tpu_torch.ops.kernels import paged_attention as tpa

    gen = torch.Generator(device=device)
    gen.manual_seed(8)
    records = {}
    source = "ssp_x_vit_tpu_torch/ops/kernels/csrc/paged_attention.cu"
    cases = [  # label, geometry, softcap, timed
        ("Llama-2-7B decode, ragged, layer 17 of an 18-layer pool (offsets past 2^31 elements)",
         dict(nq=32, nkv=32, hd=128, ps=64, lens=[1, 63, 64, 300, 777, 1024, 1500, 2047],
              layers=18, layer=17), None, False),
        ("Llama-2-7B decode, 2047 cached keys each",
         dict(nq=32, nkv=32, hd=128, ps=64, lens=[2047] * 8), None, True),
        ("Mistral-7B, context 6000, window 4096",
         dict(nq=32, nkv=8, hd=128, ps=64, lens=[5999, 6000, 4500, 100], window=4096), None, False),
        ("gemma-2 head_dim 256, softcap 50",
         dict(nq=16, nkv=8, hd=256, ps=64, lens=[5, 200, 1000, 333]), 50.0, False),
        ("phi-2 head_dim 80", dict(nq=32, nkv=32, hd=80, ps=64, lens=[17, 400, 900]), None, False),
        ("page size 16", dict(nq=8, nkv=2, hd=64, ps=16, lens=[250]), None, False),
        ("page size 256", dict(nq=8, nkv=8, hd=128, ps=256, lens=[1000]), None, False),
        ("page size 512", dict(nq=6, nkv=2, hd=128, ps=512, lens=[1300, 511]), None, False),
        ("ragged group and page (rep 3, ps 12, head_dim 40)",
         dict(nq=6, nkv=2, hd=40, ps=12, lens=[0, 11, 12, 100], window=30), 30.0, False),
    ]
    variants = [("float32", torch.float32, "float"), ("bfloat16", torch.bfloat16, "float"),
                ("bfloat16", torch.bfloat16, "int8")]  # an int8 cache computes in bf16
    for label, geo, softcap, timed in cases:
        for dn, dtype, kind in variants:
            c = _paged_setup(gen, device, dtype, kind, **geo)
            li, lens1 = c["layer"], c["lens"] + 1
            name = f"{label}: b={len(geo['lens'])} nq={geo['nq']} nkv={geo['nkv']} " \
                   f"hd={geo['hd']} ps={geo['ps']} {dn}{' int8 pools' if kind == 'int8' else ''}"
            # the write: kernel on the pools, plain version on clones; whole pools compared
            # (codes and scales bit for bit), so a stray write anywhere shows
            k_ref, v_ref = _clone_pool(c["k"]), _clone_pool(c["v"])
            tpa.paged_cache_write(c["k"], c["v"], c["k_new"], c["v_new"], c["table"], c["lens"], li)
            tpa.paged_pool_write_plain(k_ref, c["k_new"], c["table"], c["lens"], li)
            tpa.paged_pool_write_plain(v_ref, c["v_new"], c["table"], c["lens"], li)
            torch.cuda.synchronize()
            differ = _pools_differ(c["k"], k_ref) + _pools_differ(c["v"], v_ref)
            if differ:
                raise AssertionError(f"paged_cache_write {name}: {differ} pool elements differ "
                                     "from the plain write")
            del k_ref, v_ref
            got = tpa.paged_attention(c["q"], c["k"], c["v"], c["table"], lens1, c["starts"],
                                      softcap, li)
            ref = tpa.paged_attention_plain(c["q"], c["k"], c["v"], c["table"], lens1, c["starts"],
                                            softcap, li)
            torch.cuda.synchronize()
            if not torch.isfinite(got.float()).all():
                raise AssertionError(f"paged_attention {name}: non-finite output")
            err, rel = scaled_err(got, ref)
            tol = TOL["bfloat16"] if kind == "int8" else TOL[dn]
            log(f"[KERNEL] paged write (pools identical to the plain write) + attention {name}: "
                f"max_abs_err={err:.3e} scaled={rel:.3e} tol={tol} ok")
            if rel > tol:
                raise AssertionError(f"paged_attention {name}: scaled error {rel:.3e} > {tol}")
            if not (timed and dtype == torch.bfloat16):
                del c
                continue

            # times at the served decode shape, bf16 queries
            q8 = kind == "int8"
            nq, nkv, hd, ps = geo["nq"], geo["nkv"], geo["hd"], geo["ps"]
            keys = int((lens1 - (c["starts"] if c["starts"] is not None else 0)).sum().item())
            b = len(geo["lens"])
            row_bytes = (hd + 4) if q8 else hd * 2
            a_bytes = 2 * nkv * row_bytes * keys + 2 * b * nq * hd * 2 + c["table"].numel() * 4 + 8 * b
            a_flops = 4 * nq * hd * keys
            a_bound, a_by = _bound(a_flops, a_bytes, "bfloat16")
            a_ms = time_ms(lambda: tpa.paged_attention(c["q"], c["k"], c["v"], c["table"], lens1,
                                                       None, None, li), iters=20)
            ap_ms = time_ms(lambda: tpa.paged_attention_plain(c["q"], c["k"], c["v"], c["table"],
                                                              lens1, None, None, li), iters=5, warmup=1)
            table_l = c["table"].long()
            mp = table_l.shape[1]
            key_mask = (torch.arange(mp * ps, device=device)[None] < lens1[:, None])[:, None, None]

            def gathered(pool):
                if q8:
                    out = pool["q"][:, table_l].to(dtype) * pool["s"][:, table_l][..., None].to(dtype)
                else:
                    out = pool[:, table_l]
                return out.movedim(0, 1).reshape(b, nkv, mp * ps, hd)

            def attn_library():  # the page gather and one SDPA call
                return F.scaled_dot_product_attention(c["q"][:, :, None], gathered(c["k"]),
                                                      gathered(c["v"]), attn_mask=key_mask,
                                                      enable_gqa=nq != nkv)

            lib_err = scaled_err(attn_library()[:, :, 0], ref)[1]
            if lib_err > tol:
                raise AssertionError(f"the library composition disagrees with the plain version: {lib_err}")
            al_ms = time_ms(attn_library)
            w_bytes = 2 * b * nkv * (hd * 2 + (hd + 4 if q8 else hd * 2)) + c["table"].numel() * 4 + 4 * b
            w_bound, w_by = _bound(0, w_bytes, "bfloat16")
            w_ms = time_ms(lambda: tpa.paged_cache_write(c["k"], c["v"], c["k_new"], c["v_new"],
                                                         c["table"], c["lens"], li), iters=20)

            def write_plain():
                tpa.paged_pool_write_plain(c["k"], c["k_new"], c["table"], c["lens"], li)
                tpa.paged_pool_write_plain(c["v"], c["v_new"], c["table"], c["lens"], li)

            wp_ms = time_ms(write_plain)
            rows = torch.arange(b, device=device)
            phys, off = table_l[rows, c["lens"].long() // ps], c["lens"].long() % ps
            wl_ms = None
            if not q8:  # one index_put_ per pool; an int8 pool has no single call (quantize first)
                k_rows, v_rows = c["k_new"].movedim(0, 1), c["v_new"].movedim(0, 1)
                at = (torch.arange(nkv, device=device)[:, None], phys[None], off[None])

                def write_library():
                    c["k"].index_put_(at, k_rows)
                    c["v"].index_put_(at, v_rows)

                wl_ms = time_ms(write_library)
            suffix = "_q8" if q8 else ""
            shape = f"b={b} nq={nq} nkv={nkv} hd={hd} ps={ps}, {keys // b} keys each, bf16" + \
                (" queries, int8 pools" if q8 else "")
            log(f"[TIME] paged_attention{suffix} {shape}: kernel {a_ms:.4f} ms "
                f"({a_bytes / a_ms / 1e9:.1f} TB/s of the bytes it must move), plain {ap_ms:.4f} ms, "
                f"library page gather + SDPA {al_ms:.4f} ms, bound {a_bound:.4f} ms ({a_by})")
            log(f"[TIME] paged_pool_write{suffix} {shape}: kernel {w_ms:.4f} ms (K and V in one "
                f"launch), plain {wp_ms:.4f} ms, library index_put_ "
                f"{'none for an int8 pool' if wl_ms is None else f'{wl_ms:.4f} ms'}, bound "
                f"{w_bound:.6f} ms ({w_by}; {w_bytes} bytes, far under a launch's latency)")
            common = dict(route="cuda", source=source, shape=shape, tol=tol)
            records["paged_attention" + suffix] = dict(
                common, name="paged_attention" + suffix,
                replaces="ssp_x_vit_tpu/ops/pallas/paged_attention.py:" + ("349" if q8 else "243"),
                tpu_kernel="_paged_pallas_grouped_q8" if q8 else "paged_attention_pallas",
                max_abs_err=err, scaled_err=rel, ms=a_ms, kernel_ms=a_ms, plain_ms=ap_ms,
                bound_ms=a_bound, bound_by=a_by, library_ms=al_ms, flops=a_flops, bytes=a_bytes)
            records["paged_pool_write" + suffix] = dict(
                common, name="paged_pool_write" + suffix,
                replaces="ssp_x_vit_tpu/ops/pallas/paged_attention.py:" + ("587" if q8 else "541"),
                tpu_kernel="_pool_write_pallas_q8" if q8 else "_pool_write_pallas_array",
                max_abs_err=0.0, scaled_err=0.0, ms=w_ms, kernel_ms=w_ms, plain_ms=wp_ms,
                bound_ms=w_bound, bound_by=w_by, library_ms=wl_ms, flops=0, bytes=w_bytes)
            del c
        torch.cuda.empty_cache()
    return records


def _fused_mlp_bound(m, d, f, elem, dtype_name):
    """(bound ms, bound_by, flops, bytes) of one fused int8 MLP call: each input
    read once (x, three int8 matrices, their scales), the output written once."""
    flops = 6 * m * d * f
    nbytes = 3 * d * f + 4 * (2 * f + d) + 2 * m * d * elem
    return (*_bound(flops, nbytes, dtype_name), flops, nbytes)


def phase_fused_mlp(device) -> dict:
    """fused_mlp_int8 against its plain version, fp32 and bf16, at the
    Llama-2-7B shapes (m=1 and m=8 decode rows, m=4096 prefill rows), a
    2SSP-pruned f=8253 and the code_llm_small width; times the bf16 calls
    beside the composition the port runs for bf16 trees (three ``torch.matmul``
    over int8 -> bf16 converts with the scales), ``torch.mm`` over
    pre-dequantised bf16 copies, and the bound; returns its kernels-line record
    (the m=8 decode shape of contiguous serving)."""
    import torch
    import torch.nn.functional as F

    from ssp_x_vit_tpu_torch.llm.quant import quantize_weight_int8
    from ssp_x_vit_tpu_torch.ops.kernels import quant_fused_mlp as tfm

    gen = torch.Generator(device=device)
    gen.manual_seed(12)
    cases = [  # label, m, d, f, timed
        ("Llama-2-7B decode b=1", 1, 4096, 11008, True),
        ("Llama-2-7B decode b=8", 8, 4096, 11008, True),
        ("Llama-2-7B, 2SSP-pruned f", 8, 4096, 8253, False),
        ("Llama-2-7B, 2SSP-pruned f, prefill rows", 300, 4096, 8253, False),
        ("Llama-2-7B prefill chunk", 300, 4096, 11008, True),
        ("Llama-2-7B prefill b=8 x 512", 4096, 4096, 11008, True),
        ("tile edge: 17 rows", 17, 1024, 2048, False),
        ("tile edge: 64 rows, d=682", 64, 682, 1024, False),
        ("tile edge: 136 rows, f=250", 136, 768, 250, False),
        ("code_llm_small decode", 4, 384, 1024, False),
        ("code_llm_small prefill", 1024, 384, 1024, False),
        ("ragged rows", 13, 200, 72, False),
    ]
    records = {}
    for label, m, d, f, timed in cases:
        # weights N(0, 1/fan_in) as in _ffn_inputs: max |plain| >= 1 at every shape, so
        # the limit is 3e-2 (1e-5) of the output's own peak, never a flat one
        ws = [quantize_weight_int8(torch.randn(*shape, generator=gen, device=device)
                                   * shape[0] ** -0.5)
              for shape in ((d, f), (d, f), (f, d))]
        args = [t for pair in ws for t in pair]        # gq, gs, uq, us, dq, ds
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[1]
            x = torch.randn(m, d, generator=gen, device=device).to(dtype)
            got, ref = tfm.fused_mlp_int8(x, *args), tfm.fused_mlp_int8_plain(x, *args)
            again = tfm.fused_mlp_int8(x, *args)
            # the same rows one element off 16 bytes (element loads in the wide tiles)
            x_off = torch.empty(m * d + 1, device=device, dtype=dtype)[1:].view(m, d)
            x_off.copy_(x)
            off_rel = scaled_err(tfm.fused_mlp_int8(x_off, *args), ref)[1]
            # m <= 16: the wgmma tiles forced at these rows, the skinny product's yardstick
            wide_rel = (scaled_err(tfm.fused_mlp_int8_cuda(x, *args, wide=True), ref)[1]
                        if m <= 16 else 0.0)
            torch.cuda.synchronize()
            if not torch.isfinite(got.float()).all():
                raise AssertionError(f"fused_mlp_int8 {label} {dn}: non-finite output")
            if not torch.equal(got, again):
                raise AssertionError(f"fused_mlp_int8 {label} {dn}: two runs differ")
            err, rel = scaled_err(got, ref)
            errs[dn] = (err, rel)
            peak = ref.float().abs().max().item()
            if peak < 1.0:
                raise AssertionError(f"fused_mlp_int8 {label} {dn}: max |plain| {peak:.3e} is "
                                     f"under 1, so the scaled limit would not follow the output")
            differ = int((got != ref).sum())
            log(f"[KERNEL] fused_mlp_int8 {label} m={m} d={d} f={f} {dn}: max_abs_err={err:.3e} "
                f"scaled={rel:.3e} (x off 16 bytes: {off_rel:.3e}"
                + (f"; wgmma tiles forced: {wide_rel:.3e}" if m <= 16 else "")
                + f") tol={TOL[dn]} ok (max |plain| {peak:.3e}, {differ} of "
                f"{ref.numel()} elements differ; same bits on a second run)")
            if max(rel, off_rel, wide_rel) > TOL[dn]:
                raise AssertionError(f"fused_mlp_int8 {label} {dn}: scaled error {rel:.3e} / "
                                     f"{off_rel:.3e} (offset x) / {wide_rel:.3e} (wgmma tiles)")
            if not (timed and dtype == torch.bfloat16):
                continue
            gq, gs, uq, us, dq, ds = args
            k_ms = time_ms(lambda: tfm.fused_mlp_int8(x, *args), iters=20)
            p_ms = time_ms(lambda: tfm.fused_mlp_int8_plain(x, *args), iters=5, warmup=1)
            sc = [s.to(dtype) for s in (gs, us, ds)]

            def composition():  # ops.common.mm_quant's int8 branch, three times
                g = (x @ gq.to(dtype)) * sc[0]
                u = (x @ uq.to(dtype)) * sc[1]
                return (F.silu(g) * u) @ dq.to(dtype) * sc[2]

            deq = [w.to(dtype) for w in (gq, uq, dq)]

            def dequantised():  # torch.mm over pre-dequantised copies, scales on the outputs
                g = torch.mm(x, deq[0]) * sc[0]
                u = torch.mm(x, deq[1]) * sc[1]
                return torch.mm(F.silu(g) * u, deq[2]) * sc[2]

            c_ms = time_ms(composition, iters=20)
            l_ms = time_ms(dequantised, iters=20)
            bound_ms, bound_by, flops, nbytes = _fused_mlp_bound(m, d, f, 2, dn)
            rate = (f"{nbytes / k_ms / 1e9:.2f} TB/s of the bytes it must move" if bound_by == "bytes"
                    else f"{flops / k_ms / 1e9:.1f} TFLOP/s")
            log(f"[TIME] fused_mlp_int8 {label} m={m} d={d} f={f} bf16: kernel {k_ms:.4f} ms "
                f"({rate}), plain {p_ms:.4f} ms, the port's bf16 composition (3 torch.matmul over "
                f"int8 -> bf16 converts) {c_ms:.4f} ms, library torch.mm over dequantised copies "
                f"{l_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
            if m <= 16:
                w_ms = time_ms(lambda: tfm.fused_mlp_int8_cuda(x, *args, wide=True), iters=20)
                log(f"[TIME] fused_mlp_int8 {label} m={m} bf16, the wgmma tiles forced at these "
                    f"rows: {w_ms:.4f} ms against the skinny product's {k_ms:.4f} ms")
            if m == 8:
                records["fused_mlp_int8"] = dict(
                    name="fused_mlp_int8", route="cuda",
                    source="ssp_x_vit_tpu_torch/ops/kernels/csrc/quant_fused_mlp.cu + csrc/qgemm_tile.cuh",
                    replaces="ssp_x_vit_tpu/ops/pallas/quant_fused_mlp.py:68",
                    tpu_kernel="fused_mlp_int8", shape=f"m={m} d={d} f={f} bf16",
                    max_abs_err=err, scaled_err=rel, tol=TOL[dn],
                    max_abs_err_fp32=errs["float32"][0], scaled_err_fp32=errs["float32"][1],
                    tol_fp32=TOL["float32"], ms=k_ms, kernel_ms=k_ms, plain_ms=p_ms,
                    bound_ms=bound_ms, bound_by=bound_by, library_ms=l_ms, composition_ms=c_ms,
                    flops=flops, bytes=nbytes)
        del ws, args
    torch.cuda.empty_cache()
    return records


def time_llm_parts(device) -> None:
    """Time each C entry point of the LLM kernels at the Llama-2-7B shapes of
    one layer call (b=1, s=2048, bf16), beside the ``torch.matmul``s that carry
    the layer's projections and the library calls."""
    import torch
    import torch.nn.functional as F

    from ssp_x_vit_tpu_torch.ops.kernels import build
    from ssp_x_vit_tpu_torch.ops.kernels import quant_matmul as tqm

    dtype, m, d, f, h, hd = torch.bfloat16, 2048, 4096, 11008, 32, 128
    gen = torch.Generator(device=device)
    gen.manual_seed(4)

    def rn(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen, device=device) * std).to(dtype)

    x, hmid = rn(m, d), rn(m, f)
    wq, wg, wd = rn(d, d, std=0.02), rn(d, f, std=0.02), rn(f, d, std=0.02)
    q, k, v = rn(1, h, m, hd), rn(1, h, m, hd), rn(1, h, m, hd)
    o = torch.empty_like(q)
    w4 = torch.randint(-128, 128, (d // 2, f), generator=gen, device=device).to(torch.int8)
    w8 = torch.randint(-127, 128, (d, f), generator=gen, device=device).to(torch.int8)
    scale = torch.rand(f, generator=gen, device=device) * 0.01 + 0.001
    out = torch.empty(m, f, dtype=dtype, device=device)
    w_deq = tqm.unpack_int4(w4).to(dtype)
    attn_flops = 4 * hd * _attended_pairs(m, True, None) * h
    parts = [
        ("flash_attention core (causal)", attn_flops,
         lambda: build.flash_attention(q, k, v, o, scale=hd ** -0.5, causal=True, window=0,
                                       softcap=0.0)),
        ("library sdpa (causal)", attn_flops,
         lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)),
        ("torch.matmul q/k/v/o projection (each)", 2 * m * d * d, lambda: torch.mm(x, wq)),
        ("torch.matmul gate/up projection (each)", 2 * m * d * f, lambda: torch.mm(x, wg)),
        ("torch.matmul down projection", 2 * m * d * f, lambda: torch.mm(hmid, wd)),
        ("quant_gemm int4 gate/up projection", 2 * m * d * f,
         lambda: build.quant_gemm(x, w4, scale, out, 4)),
        ("quant_gemm int8 gate/up projection", 2 * m * d * f,
         lambda: build.quant_gemm(x, w8, scale, out, 8)),
        ("library torch.mm on a dequantised copy", 2 * m * d * f, lambda: torch.mm(x, w_deq)),
    ]
    for label, flops, fn in parts:
        ms = time_ms(fn, iters=20)
        log(f"[PART] bfloat16 Llama-2-7B layer b=1 s=2048 {label}: {ms:.4f} ms "
            f"{flops / ms / 1e9:.1f} TFLOP/s")


def time_kernel_parts(device, b: int, dtype) -> None:
    """Time each C entry point the block wrappers launch (LayerNorm, the four
    GEMMs with their epilogues, the attention core) at ViT-B/16 shapes, on the
    inputs of phase 3's kind, beside ``torch.mm`` at each GEMM's shape and SDPA
    (the core)."""
    import torch
    import torch.nn.functional as F

    from ssp_x_vit_tpu_torch.ops.kernels import build

    s, d, heads, f = 197, 768, 12, 3072
    m, hd, dn = b * s, d // heads, str(dtype).split(".")[1]
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    att = _attn_inputs(gen, b, s, d, dtype, device)
    ffn = _ffn_inputs(gen, b, s, d, f, dtype, device)
    x = att["x"]
    y = build.layer_norm(x, att["ln_scale"], att["ln_bias"], 1e-12)
    qkv = torch.empty(m, 3 * d, device=device, dtype=dtype)
    o, out = torch.empty(m, d, device=device, dtype=dtype), torch.empty_like(x)
    h = torch.empty(m, f, device=device, dtype=dtype)
    stats = torch.empty(b, f, device=device)
    mask = torch.ones(f, device=device)
    gate = torch.ones((), device=device)
    build.gemm(y, att["qkv_kernel"], qkv, build.EPI_BIAS, bias=att["qkv_bias"])
    parts = [
        ("layer_norm", 0, lambda: build.layer_norm(x, att["ln_scale"], att["ln_bias"], 1e-12)),
        ("qkv gemm (+bias)", 2 * m * d * 3 * d,
         lambda: build.gemm(y, att["qkv_kernel"], qkv, build.EPI_BIAS, bias=att["qkv_bias"])),
        ("attention core", 4 * b * heads * s * s * hd,
         lambda: build.attention(qkv, o, b, s, heads, hd, hd ** -0.5)),
        ("proj gemm (+gated residual)", 2 * m * d * d,
         lambda: build.gemm(o, att["proj_kernel"], out, build.EPI_RESIDUAL,
                            bias=att["proj_bias"], resid=x, gate=gate)),
        ("fc1 gemm (+gelu, mask, stats)", 2 * m * d * f,
         lambda: build.gemm(y, ffn["fc1_kernel"], h, build.EPI_GELU, bias=ffn["fc1_bias"],
                            mask=mask, stats=stats, seq=s)),
        ("fc1 gemm (+gelu, no stats)", 2 * m * d * f,
         lambda: build.gemm(y, ffn["fc1_kernel"], h, build.EPI_GELU, bias=ffn["fc1_bias"])),
        ("fc2 gemm (+gated residual)", 2 * m * d * f,
         lambda: build.gemm(h, ffn["fc2_kernel"], out, build.EPI_RESIDUAL,
                            bias=ffn["fc2_bias"], resid=x, gate=gate)),
        ("library torch.mm qkv", 2 * m * d * 3 * d, lambda: torch.mm(y.view(m, d), att["qkv_kernel"])),
        ("library torch.mm proj", 2 * m * d * d, lambda: torch.mm(o, att["proj_kernel"])),
        ("library torch.mm fc1", 2 * m * d * f, lambda: torch.mm(y.view(m, d), ffn["fc1_kernel"])),
        ("library torch.mm fc2", 2 * m * d * f, lambda: torch.mm(h, ffn["fc2_kernel"])),
        ("library sdpa core", 4 * b * heads * s * s * hd,
         lambda: F.scaled_dot_product_attention(*qkv.view(b, s, 3, heads, hd).permute(2, 0, 3, 1, 4))),
    ]
    for label, flops, fn in parts:
        ms = time_ms(fn, iters=20)
        rate = f" {flops / ms / 1e9:.1f} TFLOP/s" if flops else ""
        log(f"[PART] {dn} b={b} {label}: {ms:.4f} ms{rate}")


# ------------------------------------------------------------ phases 4, 5 ---

def check_forward(model: str, device) -> None:
    """The model the CLI builds (same seed), on 4 and on 1 synthetic test
    images: the kernel path on the card against the plain path on the host
    CPU, fp32 (scaled error <= 1e-4, same top-1) and bf16 (scaled error <= 5e-2)."""
    import torch

    from ssp_x_vit_tpu_torch.cli.common import resolve_dataset, resolve_model
    from ssp_x_vit_tpu_torch.models.vit import cast_params, vit_forward

    params, cfg = resolve_model(model, device=device)
    _, test, _ = resolve_dataset("synthetic", cfg, device=device)
    host = cast_params(params, torch.float32)
    host = {k: ({kk: vv.cpu() for kk, vv in v.items()} if isinstance(v, dict) else v.cpu())
            for k, v in host.items()}
    for n_img in (4, 1):  # one image: the small-batch kernel paths (split-K, 16-row tiles)
        px = test.batches(1)[0]["pixel_values"][:n_img]
        with torch.inference_mode():
            ref, _ = vit_forward(host, px.cpu(), cfg)
            for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 5e-2)):
                got, _ = vit_forward(cast_params(params, dtype), px, cfg, compute_dtype=dtype)
                got = got.float().cpu()
                if not torch.isfinite(got).all():
                    raise AssertionError(f"{model} {dtype}: non-finite logits")
                err, rel = scaled_err(got, ref)
                log(f"[MAIN] {model} forward, card kernels {dtype} vs host CPU plain fp32, "
                    f"{n_img} image(s): max_abs_err={err:.3e} scaled={rel:.3e} tol={tol}")
                if rel > tol:
                    raise AssertionError(f"{model}: kernel forward disagrees with the CPU reference")
                if dtype == torch.float32 and not torch.equal(got.argmax(-1), ref.argmax(-1)):
                    raise AssertionError(f"{model}: fp32 top-1 differs from the CPU reference")


def phase_main(out_root: str, device) -> dict:
    """Full-width 2SSP CLI runs; returns launches per kernel summed over them."""
    from ssp_x_vit_tpu_torch.cli import auto_2ssp
    from ssp_x_vit_tpu_torch.ops.kernels import KERNEL_NAMES, launch_counts, reset_launch_counts

    totals = {name: 0 for name in KERNEL_NAMES}
    runs = [
        ("vit-b16", "fused_attn_block_v2"),
        ("vit-ti16", "fused_attn_block"),
    ]
    for model, _ in runs:
        check_forward(model, device)
    for model, attn_kernel in runs:
        argv = ["--model", model, "--dataset", "synthetic", "--target", "0.25",
                "--stage", "both", "--eval-batches", "2", "--min-remaining", "512",
                "--backend", "cuda", "--out-root", os.path.join(out_root, model)]
        log(f"[MAIN] auto_2ssp {' '.join(argv)}")
        reset_launch_counts()
        t0 = time.perf_counter()
        report = auto_2ssp.run(auto_2ssp.build_argparser().parse_args(argv))
        seconds = time.perf_counter() - t0
        for name in KERNEL_NAMES:
            totals[name] += launch_counts[name]
        by_phase = report["kernel_launches"]
        log(f"[MAIN] {model}: {seconds:.1f} s; seconds by phase "
            f"{json.dumps({k: round(v, 3) for k, v in report['phase_seconds'].items()})}")
        log(f"[MAIN] {model}: launches by phase {json.dumps(by_phase)}")
        for phase in ("candidates", "stats", "materialized"):
            for kernel in (attn_kernel, "fused_ffn_block"):
                if by_phase[phase][kernel] <= 0:
                    raise AssertionError(f"{model}: {kernel} not launched in the {phase} phase")
        plan, m = report["plan"], report["metrics"]
        est = plan["estimated_total_removed_params"] / m["params_before_stage1"]
        achieved = 1.0 - m["params_after_stage2"] / m["params_before_stage1"]
        log(f"[MAIN] {model}: planned sparsity {est:.4f}, achieved {achieved:.4f}, "
            f"top-1 {m['acc_baseline']} -> {m['acc_stage2']}, latency(b=1) "
            f"{m['latency_baseline_ms']} -> {m['latency_stage2_ms']} ms")
        if abs(achieved - est) > 0.02:
            raise AssertionError(f"{model}: achieved sparsity {achieved} vs plan {est}")
        for key in ("acc_baseline", "acc_stage1", "acc_stage2"):
            if not 0.0 <= m[key] <= 1.0:
                raise AssertionError(f"{model}: {key}={m[key]}")
    return totals


def phase_anchor(device) -> None:
    """Trained checkpoint: dense top-1 >= pinned - 0.02, >= 0.9 after 25% 2SSP."""
    from ssp_x_vit_tpu_torch.data.pipeline import DataPipeline, load_procgen_slice
    from ssp_x_vit_tpu_torch.evaluation.classify import evaluate_top1
    from ssp_x_vit_tpu_torch.models.persistence import load_pruned_model
    from ssp_x_vit_tpu_torch.pruning import two_ssp_prune_vit

    here = os.path.dirname(os.path.abspath(__file__))
    ckpt = os.path.join(here, "ckpts", "vit_procgen")
    params, cfg = load_pruned_model(ckpt, device=device)
    with open(os.path.join(ckpt, "train_meta.json")) as f:
        pinned = json.load(f)["val_top1"]
    sl = load_procgen_slice()
    test = DataPipeline(sl["test_images"], sl["test_labels"], img_size=cfg.image_size,
                        batch_size=64, device=device).batches()
    calib = DataPipeline(sl["calib_images"], sl["calib_labels"], img_size=cfg.image_size,
                         batch_size=32, device=device).batches()
    dense = evaluate_top1(params, cfg, test)
    p2, c2, res = two_ssp_prune_vit(params, cfg, 0.25, calibration_batches=calib,
                                    eval_batches=test, importance_mode="copy",
                                    batch_limit=2, min_remaining=32)
    pruned = evaluate_top1(p2, c2, test)
    log(f"[ANCHOR] vit_procgen: dense top-1 {dense:.4f} (pinned {pinned}), after 25% 2SSP "
        f"{pruned:.4f} (pruned attention {res.pruned_attention_blocks}, "
        f"t={res.plan.per_block_neurons_to_prune})")
    if dense < pinned - 0.02:
        raise AssertionError(f"dense top-1 {dense} < pinned {pinned} - 0.02")
    if pruned < 0.9:
        raise AssertionError(f"top-1 after 25% 2SSP {pruned} < 0.9")


LLAMA_2_7B = dict(vocab_size=32000, hidden_size=4096, num_layers=32, num_heads=32,
                  num_kv_heads=32, intermediate_size=11008, rms_eps=1e-5, rope_theta=10000.0)


def _tree_to(params, device=None, dtype=None):
    """A copy of a parameter tree on ``device`` with float leaves cast to ``dtype``."""
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out[k] = _tree_to(v, device, dtype)
        else:
            out[k] = v.to(device=device, dtype=dtype if v.is_floating_point() else None)
    return out


def check_llm_forward(params, cfg, device) -> None:
    """The first two layers of the full-width model on 1 x 2048 tokens: the
    kernel path on the card against the plain path on the host CPU in fp32
    (scaled error <= 1e-4) and at the bf16 default (<= 5e-2)."""
    import dataclasses

    import torch

    from ssp_x_vit_tpu_torch.llm.datasets import synthetic_token_stream
    from ssp_x_vit_tpu_torch.llm.model import llama_forward
    from ssp_x_vit_tpu_torch.ops.kernels import launch_counts

    cfg2 = dataclasses.replace(cfg, num_layers=2)
    two = dict(params, blocks={k: v[:2] for k, v in params["blocks"].items()})
    ids = torch.from_numpy(synthetic_token_stream(2048, cfg.vocab_size, seed=5).astype("int64"))
    t0 = time.perf_counter()
    with torch.no_grad():
        ref, _ = llama_forward(_tree_to(two, "cpu", torch.float32), ids, cfg2,
                               compute_dtype=torch.float32)
        host_s = time.perf_counter() - t0
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 5e-2)):
            before = launch_counts["flash_attention"]
            card = _tree_to(two, dtype=dtype)
            got, _ = llama_forward(card, ids.to(device), cfg2, compute_dtype=dtype)
            got = got.cpu()
            if launch_counts["flash_attention"] - before != 2:
                raise AssertionError("the 2-layer forward did not launch flash_attention twice")
            if not torch.isfinite(got).all():
                raise AssertionError(f"Llama-2-7B width forward {dtype}: non-finite logits")
            err, rel = scaled_err(got, ref)
            log(f"[MAIN] Llama-2-7B width, 2 layers, 1 x 2048 tokens: card kernels {dtype} vs host "
                f"CPU plain fp32 ({host_s:.1f} s): max_abs_err={err:.3e} scaled={rel:.3e} tol={tol}")
            if rel > tol:
                raise AssertionError("the kernel forward disagrees with the CPU reference")


def profile_llm_forward(params, cfg, device) -> None:
    """Where one forward's time goes: ``torch.profiler`` over two dense forwards
    (b=1) and two candidate-batch forwards (b=8) at s=2048; prints the wall time
    per forward, the share of it the device was busy, and the kernels with the
    most device time. Prints "not measured" if the trace holds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ssp_x_vit_tpu_torch.llm.datasets import synthetic_token_stream
    from ssp_x_vit_tpu_torch.llm.model import llama_forward

    ids = torch.from_numpy(synthetic_token_stream(2048, cfg.vocab_size, seed=7).astype("int64"))
    ids = ids.to(device)
    for b in (1, 8):
        tokens = ids.expand(b, -1)
        gates = torch.ones(cfg.num_layers, b, 1, 1, device=device)
        with torch.no_grad():
            llama_forward(params, tokens, cfg, attn_gate=gates)  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(2):
                llama_forward(params, tokens, cfg, attn_gate=gates)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / 2  # without the profiler
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(2):
                    llama_forward(params, tokens, cfg, attn_gate=gates)
                torch.cuda.synchronize()

        # rows of device activities only: the host-side operator rows repeat their kernels' time
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA and _device_us(e) > 0]
        total_ms = sum(_device_us(e) for e in kernels) / 1e3 / 2
        if total_ms <= 0:
            log(f"[PROFILE] llm forward b={b}: the trace holds no device time: not measured")
            continue
        log(f"[PROFILE] llm forward b={b} s=2048 bf16: {wall_ms:.1f} ms wall per forward (host "
            f"clock, no profiler), {total_ms:.1f} ms of device activity in the trace "
            f"({100 * total_ms / wall_ms:.0f}% of the wall time)")
        for e in sorted(kernels, key=_device_us, reverse=True)[:8]:
            ms = _device_us(e) / 1e3 / 2
            log(f"[PROFILE]   {ms:8.3f} ms {100 * ms / total_ms:5.1f}%  x{e.count // 2:<4d} {e.key[:90]}")


def _device_us(event) -> float:
    """Self device time of a profiler row, in microseconds."""
    return event.self_device_time_total


def make_llama_7b(device):
    """(params, cfg) at the full width and depth of Llama-2-7B: random bf16
    weights made on the card from a seed."""
    import torch

    from ssp_x_vit_tpu_torch.llm.model import LlamaConfig, init_llama_params

    cfg = LlamaConfig(**LLAMA_2_7B)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = init_llama_params(gen, cfg, dtype=torch.bfloat16, device=device)
    torch.cuda.synchronize()
    n_params = sum(v.numel() for v in params["blocks"].values()) + sum(
        v.numel() for k, v in params.items() if k != "blocks")
    log(f"[MAIN] Llama-2-7B width model: {n_params / 1e9:.3f} B parameters in bf16 made on the "
        f"card in {time.perf_counter() - t0:.2f} s "
        f"({torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB allocated)")
    return params, cfg


def phase_main_llm(device, params, cfg) -> dict:
    """The LLM CLI at the full width and depth of Llama-2-7B; returns launches
    per kernel summed over its two runs."""
    import math

    import torch

    from ssp_x_vit_tpu_torch.cli import main_llm
    from ssp_x_vit_tpu_torch.ops.kernels import KERNEL_NAMES, launch_counts, reset_launch_counts

    check_llm_forward(params, cfg, device)
    profile_llm_forward(params, cfg, device)

    common = ["--model", "llama-2-7b-width", "--synthetic-data", "--seq-len", "2048",
              "--num-calibration", "16", "--num-calibration-2ssp", "8", "--backend", "cuda",
              "--evaluate_perplexity", "--dense", "--logging", "WARNING"]
    runs = [
        ("2ssp", common + ["--pruning_method", "2ssp", "--sparsity_rate", "0.25"]),
        ("int4", common + ["--quantize", "int4"]),
    ]
    totals = {name: 0 for name in KERNEL_NAMES}
    results = {}
    for label, argv in runs:
        log(f"[MAIN] main_llm {' '.join(argv)}")
        reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = main_llm.run(main_llm.build_argparser().parse_args(argv), model=(params, cfg))
        seconds = time.perf_counter() - t0
        for name in KERNEL_NAMES:
            totals[name] += launch_counts[name]
        results[label] = out
        by_phase = {ph: {k: n for k, n in counts.items() if n} for ph, counts
                    in out["kernel_launches"].items()}
        log(f"[MAIN] llm {label}: {seconds:.1f} s, peak {torch.cuda.max_memory_allocated() / 2 ** 30:.1f} "
            f"GiB; seconds by phase "
            f"{json.dumps({k: round(v, 3) for k, v in out['phase_seconds'].items()})}")
        log(f"[MAIN] llm {label}: launches by phase {json.dumps(by_phase)}")

    out = results["2ssp"]
    (entry,) = out["runs"]
    dense, pruned = out["dense"]["ppl"], entry["ppl"]
    log(f"[MAIN] llm 2ssp: dense ppl {dense:.2f}, after 25% 2SSP {pruned:.2f}; pruned attention "
        f"{entry['pruned_attention_blocks']}, kept FFN width {entry['num_preserve_mlp']} of "
        f"{cfg.intermediate_size}, achieved sparsity {entry['achieved_sparsity']:.4f}, pruning "
        f"{entry['pruning_seconds']:.1f} s")
    if not (math.isfinite(dense) and math.isfinite(pruned)):
        raise AssertionError(f"non-finite perplexity: dense {dense}, pruned {pruned}")
    if abs(entry["achieved_sparsity"] - 0.25) > 0.02:
        raise AssertionError(f"achieved sparsity {entry['achieved_sparsity']} vs 0.25")
    for phase in ("stats", "candidates", "evaluation"):
        if out["kernel_launches"][phase]["flash_attention"] <= 0:
            raise AssertionError(f"flash_attention not launched in the {phase} phase")
    out4 = results["int4"]
    ppl4 = out4["dense"]["ppl"]
    log(f"[MAIN] llm int4: dense ppl {ppl4:.2f} (bf16 weights: {dense:.2f})")
    for kernel in ("quant4_matmul", "flash_attention"):
        if out4["kernel_launches"]["evaluation"][kernel] <= 0:
            raise AssertionError(f"{kernel} not launched in the int4 evaluation")
    # random weights sit near the vocabulary size either way: this catches a broken kernel only
    if not math.isfinite(ppl4) or abs(math.log(ppl4) - math.log(dense)) > 0.05 * math.log(dense):
        raise AssertionError(f"int4 perplexity {ppl4} vs dense {dense}")
    return totals


PAGE = 64  # page size of the served runs


def check_paged_against_host(params, cfg, device) -> None:
    """Two layers of the full-width model, two prompts, prefill + 8 decode
    steps through the paged path: every step's logits on the card (kernels)
    against the same calls on CPU copies (plain versions), fed the same tokens.
    fp32 pools: scaled error <= 1e-4; bf16 pools: <= 5e-2."""
    import dataclasses

    import torch

    from ssp_x_vit_tpu_torch.llm.datasets import synthetic_token_stream
    from ssp_x_vit_tpu_torch.llm.paged import init_paged_pools, paged_decode_step, paged_prefill
    from ssp_x_vit_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    cfg2 = dataclasses.replace(cfg, num_layers=2)
    two = dict(params, blocks={k: v[:2] for k, v in params["blocks"].items()})
    stream = synthetic_token_stream(200, cfg.vocab_size, seed=9).reshape(-1).astype("int64")
    prompts = [stream[:70], stream[70:103]]
    steps, mp = 8, 3
    tables = torch.arange(1, 1 + 2 * mp, dtype=torch.int32).reshape(2, mp)

    def run(tree, dev, dtype, feed=None):
        """Logits of both prefills and of every decode step; ``feed``: the
        tokens to decode with (the host's), else this run's own argmax."""
        kp, vp = init_paged_pools(cfg2, 1 + 2 * mp, PAGE, dtype, dev)
        out, toks = [], []
        for i, p in enumerate(prompts):
            lg, _, _ = paged_prefill(tree, torch.as_tensor(p[None], device=dev), kp, vp, cfg2,
                                     tables[i].to(dev), len(p))
            out.append(lg.float().cpu())
        lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32, device=dev)
        tok = torch.stack([o.argmax() for o in out]) if feed is None else feed[0]
        for t in range(steps):
            toks.append(tok.cpu())
            lg, _, _ = paged_decode_step(tree, tok.to(dev), kp, vp, cfg2, tables.to(dev), lens + t)
            out.append(lg.float().cpu())
            tok = lg.argmax(-1) if feed is None else feed[min(t + 1, steps - 1)]
        return out, toks

    t0 = time.perf_counter()
    ref, feed = run(_tree_to(two, "cpu", torch.float32), torch.device("cpu"), torch.float32)
    host_s = time.perf_counter() - t0
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 5e-2)):
        reset_launch_counts()
        got, _ = run(_tree_to(two, device, dtype), device, dtype, feed)
        worst = max(scaled_err(g, r)[1] for g, r in zip(got, ref))
        if not all(torch.isfinite(g).all() for g in got):
            raise AssertionError(f"paged path {dtype}: non-finite logits")
        n_attn, n_write = launch_counts["paged_attention"], launch_counts["paged_pool_write"]
        log(f"[SERVE] Llama-2-7B width, 2 layers, prompts of 70 and 33 tokens, prefill + {steps} "
            f"decode steps: card kernels {dtype} vs host CPU plain fp32 ({host_s:.1f} s), worst "
            f"scaled logit error over {len(got)} logit rows {worst:.3e} tol={tol}; launches "
            f"paged_attention {n_attn}, paged_pool_write {n_write}, flash_attention "
            f"{launch_counts['flash_attention']}")
        if worst > tol:
            raise AssertionError("the paged path on the card disagrees with the CPU plain path")
        if n_attn != 2 * steps or n_write != 2 * steps or launch_counts["flash_attention"] != 4:
            raise AssertionError("unexpected kernel launch counts on the paged path")


def _post(port: int, body: dict) -> dict:
    """POST /v1/completions; returns finish_reason, token ids, seconds to the
    first streamed token (None unless streaming) and to the end."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    t0 = time.perf_counter()
    conn.request("POST", "/v1/completions", json.dumps(body), {"Content-Type": "application/json"})
    resp = conn.getresponse()
    if resp.status != 200:
        raise AssertionError(f"HTTP {resp.status}: {resp.read()[:300]!r}")
    first, tokens, finish = None, [], None
    if body.get("stream"):
        while True:
            line = resp.readline()
            if not line:
                break
            line = line.strip()
            if not line.startswith(b"data: ") or line == b"data: [DONE]":
                continue
            event = json.loads(line[len(b"data: "):])
            if "error" in event:
                raise AssertionError(f"stream error: {event['error']}")
            choice = event["choices"][0]
            if choice["finish_reason"] is None:
                if first is None:
                    first = time.perf_counter() - t0
                tokens.extend(choice["token_ids"])
            else:
                finish = choice["finish_reason"]
    else:
        choice = json.loads(resp.read())["choices"][0]
        tokens, finish = choice["token_ids"], choice["finish_reason"]
    conn.close()
    return dict(finish=finish, tokens=tokens, first_s=first, total_s=time.perf_counter() - t0)


def _alone_gaps(params, cfg, prompt, tokens, cache_dtype, device) -> tuple:
    """The request run alone through the paged path (whole-prompt prefill, then
    one-sequence decode steps) and fed the served tokens: at every step, how far
    the served token's logit lies below the alone run's best logit. Returns
    (steps where the served token is the alone argmax, worst gap, largest |logit|).
    All gaps 0 means ``paged_generate`` on this prompt alone emits these tokens."""
    import torch

    from ssp_x_vit_tpu_torch.llm.paged import init_paged_pools, paged_decode_step, paged_prefill

    n = len(prompt)
    pages = -(-(n + len(tokens) + 1) // PAGE)
    kp, vp = init_paged_pools(cfg, 1 + pages, PAGE, cache_dtype, device)
    table = torch.arange(1, 1 + pages, dtype=torch.int32, device=device)
    toks = torch.as_tensor(tokens, dtype=torch.int64, device=device)
    logits, _, _ = paged_prefill(params, torch.as_tensor([prompt], dtype=torch.int64, device=device),
                                 kp, vp, cfg, table, n)
    gaps, peaks = [], []
    for t in range(len(tokens)):
        gaps.append(logits.max() - logits[toks[t]])
        peaks.append(logits.abs().max())
        if t + 1 < len(tokens):
            lens = torch.full((1,), n + t, dtype=torch.int32, device=device)
            logits = paged_decode_step(params, toks[t:t + 1], kp, vp, cfg, table[None], lens)[0][0]
    gaps = torch.stack(gaps)
    return int((gaps == 0).sum()), float(gaps.max()), float(torch.stack(peaks).max())


def _serve(params, cfg, device, flags, requests, label) -> dict:
    """Start the HTTP server the CLI builds (``cli.serve_http.build_engine`` +
    ``llm.server_http.create_server``) on 127.0.0.1 port 0 with the model handed
    in, post ``requests`` from one thread each, stop everything; returns the
    responses, the kernel launches of the run and its counters."""
    import threading

    import torch

    from ssp_x_vit_tpu_torch.cli import serve_http
    from ssp_x_vit_tpu_torch.llm.server_http import create_server
    from ssp_x_vit_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    argv = ["--model", "llama-2-7b-width", "--backend", device.type, "--port", "0", "--max-batch", "8",
            "--page-size", str(PAGE), "--num-pages", "512", "--max-context", "2048", *flags]
    log(f"[SERVE] {label}: serve_http {' '.join(argv)}")
    args = serve_http.build_argparser().parse_args(argv)
    torch.cuda.reset_peak_memory_stats()
    engine, eos = serve_http.build_engine(args, model=(params, cfg))
    srv = create_server(engine, **serve_http.server_kwargs(args, eos))
    server_thread = threading.Thread(target=srv.serve_forever, daemon=True)
    server_thread.start()
    port = srv.server_address[1]
    responses = [None] * len(requests)
    errors = []

    def client(i):
        try:
            responses[i] = _post(port, requests[i])
        except Exception as e:  # re-raised below, in the main thread
            errors.append((i, e))

    try:
        reset_launch_counts()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(requests))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(launch_counts)
        stats = dict(decode_steps=engine.decode_steps, prefix_hit_pages=engine.prefix_hit_pages)
    finally:
        srv.shutdown()
        srv.server_close()
        engine.shutdown()
        server_thread.join(timeout=30)
    if errors:
        raise AssertionError(f"{label}: request {errors[0][0]} failed: {errors[0][1]!r}")
    if any(r is None for r in responses):
        raise AssertionError(f"{label}: a request did not return")
    n_tokens = sum(len(r["tokens"]) for r in responses)
    log(f"[SERVE] {label}: {len(requests)} requests, {n_tokens} tokens in {seconds:.2f} s = "
        f"{n_tokens / seconds:.1f} tokens/s over the run (prefills included); "
        f"{stats['decode_steps']} batched decode steps; request latency "
        f"{min(r['total_s'] for r in responses):.2f}-{max(r['total_s'] for r in responses):.2f} s; "
        f"peak {torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB")
    firsts = [r["first_s"] for r in responses if r["first_s"] is not None]
    if firsts:
        log(f"[SERVE] {label}: time to first token of the streamed requests (client clock, "
            f"queueing and prefill included): {', '.join(f'{x:.3f}' for x in firsts)} s")
    shown = {k: v for k, v in launches.items() if v}
    log(f"[SERVE] {label}: launches {json.dumps(shown)}; prefix_hit_pages {stats['prefix_hit_pages']}")
    for i, (req, r) in enumerate(zip(requests, responses)):
        if r["finish"] != "length" or len(r["tokens"]) != req["max_tokens"]:
            raise AssertionError(f"{label}: request {i} ended with {r['finish']} after "
                                 f"{len(r['tokens'])} of {req['max_tokens']} tokens")
        if not all(0 <= t < cfg.vocab_size for t in r["tokens"]):
            raise AssertionError(f"{label}: request {i} returned a token outside the vocabulary")
    return dict(responses=responses, launches=launches, seconds=seconds, **stats)


def _check_greedy_alone(params, cfg, device, requests, responses, cache_dtype, label) -> None:
    """Every greedy request against the same prompt run alone (see
    ``_alone_gaps``). The served batch multiplies 8 rows at a time and the
    alone run 1, so bf16 GEMMs round differently and a near-tie may flip:
    the served token must lie within 5e-2 of max(1, max |logit|) of the alone
    run's best logit at every step; the count of exact agreements is printed."""
    exact = total = 0
    worst_rel = 0.0
    for req, r in zip(requests, responses):
        if req.get("temperature", 1.0) != 0:
            continue
        same, gap, peak = _alone_gaps(params, cfg, req["prompt"], r["tokens"], cache_dtype, device)
        exact, total = exact + same, total + len(r["tokens"])
        worst_rel = max(worst_rel, gap / max(1.0, peak))
    log(f"[SERVE] {label}: greedy tokens against each prompt run alone: {exact} of {total} are the "
        f"alone run's argmax; worst logit gap {worst_rel:.3e} of max(1, max |logit|), tol 5e-2")
    if worst_rel > 5e-2:
        raise AssertionError(f"{label}: a served greedy token is not the alone run's best token")


def _expect_decode_launches(label, run, cfg, names) -> None:
    """Each named kernel launched once per layer and batched decode step of the
    run, and the kernels of the other pool kind not at all: the decode phase
    went through them and through nothing else."""
    want = run["decode_steps"] * cfg.num_layers
    paged = ("paged_attention", "paged_pool_write", "paged_attention_q8", "paged_pool_write_q8")
    for name in paged:
        expect = want if name in names else 0
        if run["launches"][name] != expect or want <= 0:
            raise AssertionError(f"{label}: {name} launched {run['launches'][name]} times over "
                                 f"{run['decode_steps']} decode steps of {cfg.num_layers} layers, "
                                 f"expected {expect}")


def measure_decode(params, cfg, device) -> None:
    """Eight live slots with 512-token prompts on a ``PagedServer`` of the
    served geometry: ms per decode step over blocks of 8 (host clock around a
    synchronized block), launches per step, and a ``torch.profiler`` split of
    one block."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ssp_x_vit_tpu_torch.llm.datasets import synthetic_token_stream
    from ssp_x_vit_tpu_torch.llm.paged import PagedServer
    from ssp_x_vit_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    server = PagedServer(params, cfg, max_batch=8, num_pages=512, page_size=PAGE,
                         max_context=2048)
    stream = synthetic_token_stream(8 * 512, cfg.vocab_size, seed=21).reshape(-1)
    for i in range(8):
        server.add_request(np.asarray(stream[i * 512:(i + 1) * 512]), max_new_tokens=400)
    server.step_many(8)  # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    blocks = 4
    t0 = time.perf_counter()
    for _ in range(blocks):
        server.step_many(8)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / (blocks * 8)
    ours = {k: v / (blocks * 8) for k, v in launch_counts.items() if v}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        server.step_many(8)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and _device_us(e) > 0]
    total_ms = sum(_device_us(e) for e in kernels) / 1e3 / 8
    n_launch = sum(e.count for e in kernels) / 8
    weights_ms = sum(v.numel() * v.element_size() for v in params["blocks"].values()) / PEAK_BYTES * 1e3
    log(f"[SERVE] decode at 8 live slots (~520 cached tokens each), bf16 pools: {step_ms:.2f} ms "
        f"per step over {blocks} blocks of 8 (host clock, no profiler) = {8e3 / step_ms:.0f} "
        f"tokens/s; hand-written kernel launches per step {json.dumps(ours)}; reading the block "
        f"weights once takes {weights_ms:.2f} ms at the data-sheet rate")
    if total_ms <= 0:
        log("[PROFILE] decode block: the trace holds no device time: not measured")
        return
    log(f"[PROFILE] decode block of 8 steps: {n_launch:.0f} device kernels and {total_ms:.2f} ms "
        f"of device activity per step ({100 * total_ms / step_ms:.0f}% of the step's wall time; "
        f"the rest is the host dispatching)")
    for e in sorted(kernels, key=_device_us, reverse=True)[:8]:
        ms = _device_us(e) / 1e3 / 8
        log(f"[PROFILE]   {ms:8.3f} ms {100 * ms / total_ms:5.1f}%  x{e.count // 8:<4d} {e.key[:90]}")


def phase_serving(device, params, cfg) -> dict:
    """The served path at the full width and depth of Llama-2-7B: the host
    comparison, 12 requests over HTTP with bf16 pools and the prefix cache,
    4 with int8 pools and chunked prefill, and the decode-step measurement.
    Returns the paged kernels' launches on the two served runs."""
    import torch

    from ssp_x_vit_tpu_torch.llm.datasets import synthetic_token_stream
    from ssp_x_vit_tpu_torch.llm.paged import paged_generate

    check_paged_against_host(params, cfg, device)
    stream = [int(t) for t in synthetic_token_stream(8192, cfg.vocab_size, seed=11).reshape(-1)]

    def prompt(start, n):
        return stream[start:start + n]

    greedy = dict(temperature=0)
    sampled = dict(temperature=0.8, top_p=0.9, seed=11)
    shared = prompt(0, 256)
    requests = [  # twins are one page or less, so neither takes the prefix cache's chunked path
        dict(prompt=prompt(300, 64), max_tokens=48, stream=True, **greedy),
        dict(prompt=prompt(300, 64), max_tokens=48, **greedy),
        dict(prompt=prompt(400, 64), max_tokens=32, stream=True, **greedy),
        dict(prompt=prompt(400, 64), max_tokens=32, **greedy),
        dict(prompt=shared + prompt(500, 144), max_tokens=40, **greedy),
        dict(prompt=shared + prompt(700, 344), max_tokens=40, **greedy),
        dict(prompt=prompt(1100, 64), max_tokens=48, **sampled),
        dict(prompt=prompt(1100, 64), max_tokens=48, **sampled),
        dict(prompt=prompt(1200, 128), max_tokens=64, **greedy),
        dict(prompt=prompt(1400, 512), max_tokens=56, **greedy),
        dict(prompt=prompt(2000, 1024), max_tokens=48, **greedy),
        dict(prompt=prompt(3100, 1536), max_tokens=32, **greedy),
    ]
    run1 = _serve(params, cfg, device, ["--prefix-cache"], requests, "run 1 (bf16 pools)")
    r = run1["responses"]
    for a, b, what in ((0, 1, "streamed vs not"), (2, 3, "streamed vs not"),
                       (6, 7, "sampled, same seed")):
        if r[a]["tokens"] != r[b]["tokens"]:
            raise AssertionError(f"run 1: requests {a} and {b} ({what}) returned different tokens")
    if run1["prefix_hit_pages"] <= 0:
        raise AssertionError("run 1: the shared 256-token prefix hit no cached page")
    _expect_decode_launches("run 1", run1, cfg, ("paged_attention", "paged_pool_write"))
    _check_greedy_alone(params, cfg, device, requests, r, torch.bfloat16, "run 1")
    alone = paged_generate(params, cfg, [requests[8]["prompt"]], max_new_tokens=64, page_size=PAGE)
    same = sum(1 for x, y in zip(alone[0][128:].tolist(), r[8]["tokens"]) if x == y)
    log(f"[SERVE] run 1: paged_generate on request 8's prompt alone emits {same} of 64 tokens "
        "identical to the served ones (position by position)")

    requests2 = [dict(prompt=prompt(4700, 100), max_tokens=40, **greedy),
                 dict(prompt=prompt(4900, 300), max_tokens=32, **greedy),
                 dict(prompt=prompt(5300, 700), max_tokens=48, stream=True, **greedy),
                 dict(prompt=prompt(6100, 64), max_tokens=64, **greedy)]
    run2 = _serve(params, cfg, device, ["--kv-dtype", "int8", "--chunked-prefill", "64"], requests2,
                  "run 2 (int8 pools, chunked prefill)")
    _expect_decode_launches("run 2", run2, cfg, ("paged_attention_q8", "paged_pool_write_q8"))
    _check_greedy_alone(params, cfg, device, requests2, run2["responses"], torch.int8, "run 2")
    measure_decode(params, cfg, device)
    return {"paged_attention": run1["launches"]["paged_attention"],
            "paged_pool_write": run1["launches"]["paged_pool_write"],
            "paged_attention_q8": run2["launches"]["paged_attention_q8"],
            "paged_pool_write_q8": run2["launches"]["paged_pool_write_q8"]}


GEN_MAX_LENGTH = 640  # prompt + generation of the contiguous-serving runs
GEN_PROMPTS = (64, 512)  # shortest and longest prompt of the b=8 runs


def _extend_gaps(params, cfg, seqs, starts, cache_dtype, device) -> tuple:
    """Each sequence alone at b=1 (no padding) through one cached forward over
    prompt + generated tokens (``speculative._extend_body``: the serving
    layers, logits at every position): at every generated position, how far
    the token's logit lies below the alone run's best logit. Returns (tokens
    that are the alone argmax, tokens checked, worst gap over max(1, max
    |logit|))."""
    import torch

    from ssp_x_vit_tpu_torch.llm.serve import init_cache
    from ssp_x_vit_tpu_torch.llm.speculative import _extend_body

    same = total = 0
    worst = 0.0
    with torch.no_grad():
        for seq, start in zip(seqs, starts):
            toks = torch.as_tensor(seq[None].astype("int64"), device=device)
            ck, cv = init_cache(cfg, 1, len(seq), cache_dtype, device)
            logits = _extend_body(params, toks, ck, cv, cfg, 0)[0][0, start - 1:len(seq) - 1]
            chosen = logits.gather(1, toks[0, start:, None])[:, 0]
            gaps = logits.max(dim=-1).values - chosen
            same += int((gaps == 0).sum())
            total += len(seq) - start
            worst = max(worst, float(gaps.max()) / max(1.0, float(logits.abs().max())))
            del ck, cv, logits
    return same, total, worst


def _profile_decode(params, cfg, device, cache_dtype, prompts) -> dict:
    """The contiguous path split in its parts at b=8: prefill seconds, ms per
    decode step over 16 steps (host clock around synchronized work), and a
    ``torch.profiler`` split of 4 more steps."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ssp_x_vit_tpu_torch.llm import serve

    tokens, pad_lens, _, p_pad = serve._prepare_prompts(prompts, GEN_MAX_LENGTH)
    b = tokens.shape[0]
    layers = serve.split_layers(params, cfg)
    ck, cv = serve.init_cache(cfg, b, GEN_MAX_LENGTH + 1, cache_dtype, device)
    pads = torch.as_tensor(pad_lens.astype(np.int64), device=device)
    toks = torch.as_tensor(tokens.astype(np.int64), device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, ck, cv = serve.prefill(params, toks, ck, cv, cfg, pads, layers=layers)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    tok, pos = logits.argmax(-1), p_pad
    for _ in range(2):  # warm-up
        logits, ck, cv = serve.decode_step(params, tok, ck, cv, cfg, pos, pads, layers=layers)
        tok, pos = logits.argmax(-1), pos + 1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(16):
        logits, ck, cv = serve.decode_step(params, tok, ck, cv, cfg, pos, pads, layers=layers)
        tok, pos = logits.argmax(-1), pos + 1
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / 16
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            logits, ck, cv = serve.decode_step(params, tok, ck, cv, cfg, pos, pads, layers=layers)
            tok, pos = logits.argmax(-1), pos + 1
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and _device_us(e) > 0]
    busy_ms = sum(_device_us(e) for e in kernels) / 1e3 / 4
    top = [(e.key[:80], _device_us(e) / 1e3 / 4, e.count // 4)
           for e in sorted(kernels, key=_device_us, reverse=True)[:6]]
    n_launch = sum(e.count for e in kernels) / 4
    return dict(prefill_s=prefill_s, step_ms=step_ms, busy_ms=busy_ms, top=top, n_launch=n_launch)


def phase_contiguous(device, params, cfg) -> dict:
    """Contiguous KV serving at the full width and depth of Llama-2-7B: the
    model quantized to int8 on the card, ``generate_kv_scan`` at b=8 on
    left-padded prompts of 64-512 tokens (max_length 640, greedy) with a bf16
    cache and then an int8 cache, each MLP through ``fused_mlp_int8`` (exactly
    32 launches per forward); every batch token held to the same prompt run
    alone at b=1; b=1 on the bf16 tree (no kernel of this package on its
    path); the prefill / decode-step split and a profiler split of decode
    steps. Returns the launches of the two int8 runs."""
    import numpy as np
    import torch

    from ssp_x_vit_tpu_torch.llm.datasets import synthetic_token_stream
    from ssp_x_vit_tpu_torch.llm.quant import quantize_llm_params_int8, quantized_param_bytes
    from ssp_x_vit_tpu_torch.llm.serve import generate_kv_scan
    from ssp_x_vit_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    t0 = time.perf_counter()
    q8 = quantize_llm_params_int8(params, cfg)
    torch.cuda.synchronize()
    log(f"[GEN] Llama-2-7B width quantized to int8 on the card in {time.perf_counter() - t0:.2f} s: "
        f"{quantized_param_bytes(q8) / 2 ** 30:.2f} GiB ({torch.cuda.memory_allocated() / 2 ** 30:.1f} "
        f"GiB allocated with the bf16 tree)")
    rng = np.random.default_rng(31)
    lo, hi = GEN_PROMPTS
    lens = [lo, hi] + sorted(rng.integers(lo + 1, hi, 6).tolist())
    stream = synthetic_token_stream(sum(lens), cfg.vocab_size, seed=33).reshape(-1)
    cuts = np.cumsum([0] + lens)
    prompts = [stream[cuts[i]:cuts[i + 1]].astype(np.int64) for i in range(len(lens))]
    steps = GEN_MAX_LENGTH - min(lens) - 1
    launches = {}
    for label, tree, cache_dtype in (("int8 tree, bf16 cache", q8, torch.bfloat16),
                                     ("int8 tree, int8 cache", q8, torch.int8)):
        reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = generate_kv_scan(tree, cfg, prompts, max_length=GEN_MAX_LENGTH,
                                cache_dtype=cache_dtype)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        n_gen = sum(len(o) - n for o, n in zip(outs, lens))
        run = {k: v for k, v in launch_counts.items() if v}
        for name, n in run.items():
            launches[name] = launches.get(name, 0) + n
        log(f"[GEN] b=8 {label}: generate_kv_scan on prompts of {lo}-{hi} tokens (left-padded), "
            f"max_length {GEN_MAX_LENGTH}: {steps} decode steps, {n_gen} tokens "
            f"kept in {seconds:.2f} s = {n_gen / seconds:.1f} tokens/s (prefill included; "
            f"{8 * (steps + 1) / seconds:.1f} tokens/s counting every row's step); peak "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB; launches {json.dumps(run)}")
        want = cfg.num_layers * (1 + steps)
        if run.get("fused_mlp_int8", 0) != want:
            raise AssertionError(f"{label}: fused_mlp_int8 launched {run.get('fused_mlp_int8')} "
                                 f"times, expected {cfg.num_layers} x (1 + {steps}) = {want}")
        for o, p in zip(outs, prompts):
            if len(o) != GEN_MAX_LENGTH or not (o[:len(p)] == p).all() or \
                    not ((0 <= o) & (o < cfg.vocab_size)).all():
                raise AssertionError(f"{label}: a row is not its prompt + tokens of the vocabulary "
                                     f"up to {GEN_MAX_LENGTH}")
        same, total, worst = _extend_gaps(q8, cfg, outs, lens, cache_dtype, device)
        log(f"[GEN] b=8 {label}: every batch token against the same prompt run alone at b=1: "
            f"{same} of {total} are the alone run's argmax; worst logit gap {worst:.3e} of "
            f"max(1, max |logit|), tol 5e-2")
        if worst > 5e-2:
            raise AssertionError(f"{label}: a batch token is not the alone run's best token")
        part = _profile_decode(tree, cfg, device, cache_dtype, prompts)
        log(f"[GEN] b=8 {label}: prefill of 8 x {hi} tokens {part['prefill_s']:.3f} s; decode "
            f"{part['step_ms']:.2f} ms per step (host clock, 16 steps after the prefill) = "
            f"{8e3 / part['step_ms']:.0f} tokens/s")
        if part["busy_ms"] > 0:
            log(f"[PROFILE] contiguous decode step, {label}: {part['n_launch']:.0f} device kernels "
                f"and {part['busy_ms']:.2f} ms of device activity per step "
                f"({100 * part['busy_ms'] / part['step_ms']:.0f}% of the step's wall time)")
            for key, ms, count in part["top"]:
                log(f"[PROFILE]   {ms:8.3f} ms {100 * ms / part['busy_ms']:5.1f}%  x{count:<4d} {key}")
        else:
            log("[PROFILE] contiguous decode step: the trace holds no device time: not measured")
        del outs
        torch.cuda.empty_cache()
    del q8
    torch.cuda.empty_cache()

    reset_launch_counts()
    one = prompts[1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = generate_kv_scan(params, cfg, one, max_length=GEN_MAX_LENGTH, cache_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    n_gen = len(out) - len(one)
    log(f"[GEN] b=1 bf16 tree, bf16 cache, prompt of {len(one)} tokens: {n_gen} tokens in "
        f"{seconds:.2f} s = {n_gen / seconds:.1f} tokens/s (prefill included); launches of this "
        f"package's kernels {sum(launch_counts.values())}")
    if any(launch_counts.values()) or len(out) != GEN_MAX_LENGTH:
        raise AssertionError("the bf16 tree launched a kernel of this package or stopped early")
    return launches


def _first_divergence(got, ref, start, host, cfg, compute_dtype, tol) -> int:
    """Tokens of ``got`` from ``start`` that equal ``ref`` before the first
    difference; at a difference the host's own top-2 logit margin there must
    be under ``tol`` of max(1, max |logit|) (a near-tie), else it raises."""
    import torch

    from ssp_x_vit_tpu_torch.llm.model import llama_forward

    if list(got) == list(ref):
        return len(ref) - start
    at = next(i for i, (x, y) in enumerate(zip(got, ref)) if x != y)
    with torch.no_grad():
        logits, _ = llama_forward(host, torch.tensor([list(ref[:at])]), cfg,
                                  compute_dtype=compute_dtype)
    top2 = logits[0, -1].topk(2).values
    margin = float(top2[0] - top2[1]) / max(1.0, float(logits[0, -1].abs().max()))
    if margin > tol:
        raise AssertionError(f"token {at - start} differs where the host's top-2 margin is "
                             f"{margin:.2e} > {tol}")
    return at - start


def phase_anchor_contiguous(device) -> None:
    """``ckpts/code_llm_small`` through contiguous serving on the card against
    the host CPU: fp32 ``generate_kv_scan`` on 4 val prompts x 32 greedy
    tokens, then the int8 tree (``fused_mlp_int8``), then an int8 cache; a
    speculative run with a 25%-2SSP draft equal to dense greedy decoding on
    the card, token for token;
    ``beam_generate_kv`` equal to ``beam_generate``; a rolling cache on a
    uniform-window tiny model. fp32 runs may differ only where the host's
    top-2 margin is under 1e-3, the int8 cache (bf16 compute) where it is
    under 5e-2 of max(1, max |logit|)."""
    import numpy as np
    import torch

    from ssp_x_vit_tpu_torch.llm.checkpoints import load_llm_model
    from ssp_x_vit_tpu_torch.llm.generate import beam_generate, beam_generate_kv
    from ssp_x_vit_tpu_torch.llm.model import LlamaConfig, init_llama_params
    from ssp_x_vit_tpu_torch.llm.pruning import two_stage_2ssp
    from ssp_x_vit_tpu_torch.llm.quant import quantize_llm_params_int8
    from ssp_x_vit_tpu_torch.llm.serve import generate_kv_scan
    from ssp_x_vit_tpu_torch.llm.speculative import speculative_generate
    from ssp_x_vit_tpu_torch.ops.kernels import launch_counts

    here = os.path.dirname(os.path.abspath(__file__))
    ckpt = os.path.join(here, "ckpts", "code_llm_small")
    params, cfg = load_llm_model(ckpt, device=device, dtype=torch.float32)
    host = _tree_to(params, "cpu", torch.float32)
    val = np.asarray(np.memmap(os.path.join(ckpt, "corpus_slice", "val.bin"), np.uint16, "r")[:4096],
                     np.int32)
    prompts = [val[a:a + n].tolist() for a, n in ((0, 48), (500, 100), (1000, 160), (2000, 200))]
    new = 32
    runs = [("fp32 tree, fp32 cache", params, host, torch.float32, torch.float32, 1e-3),
            ("int8 tree (fused_mlp_int8), fp32 cache", quantize_llm_params_int8(params, cfg),
             quantize_llm_params_int8(host, cfg), torch.float32, torch.float32, 1e-3),
            ("fp32 tree, int8 cache", params, host, torch.int8, torch.bfloat16, 5e-2)]
    for label, card_tree, host_tree, cache_dtype, compute, tol in runs:
        before = launch_counts["fused_mlp_int8"]
        kw = dict(max_length=max(len(p) for p in prompts) + new, cache_dtype=cache_dtype)
        got = [generate_kv_scan(card_tree, cfg, p, **dict(kw, max_length=len(p) + new))
               for p in prompts]
        together = generate_kv_scan(card_tree, cfg, prompts, **kw)
        ref = [generate_kv_scan(host_tree, cfg, p, **dict(kw, max_length=len(p) + new))
               for p in prompts]
        fused = launch_counts["fused_mlp_int8"] - before
        checked = 0
        for p, g, t, r in zip(prompts, got, together, ref):
            checked += _first_divergence(g.tolist(), r.tolist(), len(p), host_tree, cfg, compute,
                                         tol)
            checked += _first_divergence(t[:len(p) + new].tolist(), r.tolist(), len(p), host_tree,
                                         cfg, compute, tol)
        log(f"[ANCHOR] code_llm_small generate_kv_scan, {label}: card (each prompt alone and the 4 "
            f"batched) == host CPU on {checked} of {2 * 4 * new} tokens (the rest follow a "
            f"near-tie); fused_mlp_int8 launches {fused}")
        if ("int8 tree" in label) != (fused > 0):
            raise AssertionError(f"{label}: fused_mlp_int8 launched {fused} times")

    calib = [np.asarray(np.memmap(os.path.join(ckpt, "corpus_slice", "train.bin"), np.uint16,
                                  "r")[i * 1024:(i + 1) * 1024], np.int32).reshape(1, 1024)
             for i in range(8)]
    draft, dcfg, _ = two_stage_2ssp(params, cfg, calib, 0.25, seq_len=1024)
    rates, equal = [], 0
    for p in prompts[:2]:
        dense = generate_kv_scan(params, cfg, p, max_length=len(p) + 48,
                                 cache_dtype=torch.float32).tolist()
        spec, stats = speculative_generate(params, cfg, draft, dcfg, p, max_length=len(p) + 48,
                                           k=4, cache_dtype=torch.float32)
        spec = spec.tolist()
        rates.append(stats["acceptance_rate"])
        equal += sum(x == y for x, y in zip(spec[len(p):], dense[len(p):]))
        if spec != dense:
            raise AssertionError(f"speculative_generate differs from dense greedy "
                                 f"generate_kv_scan at fp32 (prompt of {len(p)} tokens)")
    log(f"[ANCHOR] code_llm_small speculative_generate (k=4, 25% 2SSP draft, fp32): {equal} of "
        f"{2 * 48} tokens equal to dense generate_kv_scan, held exactly; acceptance rate "
        f"{', '.join(f'{r:.3f}' for r in rates)}")

    p = prompts[0][:24]
    beams = beam_generate(params, cfg, np.asarray(p), max_length=len(p) + 12, num_beams=5,
                          compute_dtype=torch.float32)
    beams_kv = beam_generate_kv(params, cfg, np.asarray(p), max_length=len(p) + 12, num_beams=5,
                                cache_dtype=torch.float32)
    log(f"[ANCHOR] code_llm_small 5-beam search, 12 tokens, fp32: beam_generate_kv "
        f"{'==' if beams.tolist() == beams_kv.tolist() else '!='} beam_generate")
    if beams.tolist() != beams_kv.tolist():
        raise AssertionError("beam_generate_kv differs from beam_generate at fp32")

    wcfg = LlamaConfig(vocab_size=512, hidden_size=128, num_layers=3, num_heads=4, num_kv_heads=2,
                       intermediate_size=256, sliding_window=16)
    gen = torch.Generator().manual_seed(0)
    whost = init_llama_params(gen, wcfg, device="cpu")
    wcard = _tree_to(whost, device)
    wp = [[int(t) for t in val[3000:3000 + n] % 512] for n in (40, 7, 25)]
    got = generate_kv_scan(wcard, wcfg, wp, max_length=72, rolling=True, cache_dtype=torch.float32)
    ref = generate_kv_scan(whost, wcfg, wp, max_length=72, rolling=True, cache_dtype=torch.float32)
    checked = sum(_first_divergence(g.tolist(), r.tolist(), len(q), whost, wcfg, torch.float32,
                                    1e-3) for g, r, q in zip(got, ref, wp))
    log(f"[ANCHOR] rolling cache (window 16, 16 slots, tiny random model): card == host CPU on "
        f"{checked} of {sum(72 - len(q) for q in wp)} tokens")


def phase_anchor_serving(device) -> None:
    """The trained ``ckpts/code_llm_small`` with fp32 pools: four prompts cut
    from the committed val tokens, 32 greedy tokens each, served together by a
    ``PagedServer`` on the card == each alone on the card == the plain path on
    the host CPU, token for token. fp32 differences are ~1e-6, so a token may
    differ only where the host's own top-2 logit margin is below 1e-3."""
    import numpy as np
    import torch

    from ssp_x_vit_tpu_torch.llm.checkpoints import load_llm_model
    from ssp_x_vit_tpu_torch.llm.model import llama_forward
    from ssp_x_vit_tpu_torch.llm.paged import PagedServer, paged_generate

    here = os.path.dirname(os.path.abspath(__file__))
    ckpt = os.path.join(here, "ckpts", "code_llm_small")
    params, cfg = load_llm_model(ckpt, device=device, dtype=torch.float32)
    host = _tree_to(params, "cpu", torch.float32)
    val = np.asarray(np.memmap(os.path.join(ckpt, "corpus_slice", "val.bin"), np.uint16, "r")[:4096],
                     np.int32)
    prompts = [val[a:a + n].tolist() for a, n in ((0, 48), (500, 100), (1000, 160), (2000, 200))]
    new, kw = 32, dict(page_size=16, cache_dtype=torch.float32)
    server = PagedServer(params, cfg, max_batch=4, num_pages=96, max_context=512, **kw)
    ids = [server.add_request(p, max_new_tokens=new) for p in prompts]
    done = server.run(8)
    together = [done[i].tolist() for i in ids]
    alone = [paged_generate(params, cfg, [p], max_new_tokens=new, **kw)[0].tolist() for p in prompts]
    cpu = [paged_generate(host, cfg, [p], max_new_tokens=new, **kw)[0].tolist() for p in prompts]
    checked = 0
    for p, ref, *others in zip(prompts, cpu, together, alone):
        for what, got in zip(("served together", "alone on the card"), others):
            if got == ref:
                checked += new
                continue
            at = next(i for i, (x, y) in enumerate(zip(got, ref)) if x != y)
            with torch.no_grad():
                logits, _ = llama_forward(host, torch.tensor([ref[:at]]), cfg,
                                          compute_dtype=torch.float32)
            top2 = logits[0, -1].topk(2).values
            margin = float(top2[0] - top2[1])
            log(f"[ANCHOR] code_llm_small {what}: token {at - len(p)} differs from the host's "
                f"where the host's top-2 margin is {margin:.2e}")
            if margin > 1e-3:
                raise AssertionError(f"code_llm_small {what}: tokens differ from the host CPU's")
            checked += at - len(p)
    log(f"[ANCHOR] code_llm_small served (4 prompts of 48-200 val tokens, {new} greedy tokens each, "
        f"fp32 pools): PagedServer on the card == each alone == host CPU plain path on "
        f"{checked} of {2 * 4 * new} compared tokens (the rest follow a near-tie)")


def phase_anchor_llm(device) -> None:
    """The trained ``ckpts/code_llm_small``: perplexity on the card against the
    pinned value (5%) and the port's plain path on the host CPU (1e-2), int8
    within 2% of dense, int4 against the host's plain int4 path (1e-2), and a
    25% 2SSP (finite, below 10x dense)."""
    import math

    import numpy as np
    import torch

    from ssp_x_vit_tpu_torch.llm.checkpoints import load_llm_model
    from ssp_x_vit_tpu_torch.llm.evaluation import evaluate_perplexity
    from ssp_x_vit_tpu_torch.llm.pruning import count_main_params, two_stage_2ssp
    from ssp_x_vit_tpu_torch.llm.quant import quantize_llm_params_int4, quantize_llm_params_int8

    here = os.path.dirname(os.path.abspath(__file__))
    ckpt = os.path.join(here, "ckpts", "code_llm_small")
    params, cfg = load_llm_model(ckpt, device=device, dtype=torch.float32)
    with open(os.path.join(ckpt, "train_meta.json")) as f:
        pinned = json.load(f)["val_ppl_16k"]
    val = np.asarray(np.memmap(os.path.join(ckpt, "corpus_slice", "val.bin"), np.uint16, "r")[:16384],
                     np.int32)
    train = np.asarray(np.memmap(os.path.join(ckpt, "corpus_slice", "train.bin"), np.uint16,
                                 "r")[:8 * 1024], np.int32)
    kw = dict(seq_len=1024, batch_size=2)
    host = _tree_to(params, "cpu", torch.float32)
    dense = evaluate_perplexity(params, cfg, val, **kw)
    dense_host = evaluate_perplexity(host, cfg, val, **kw)
    int8 = evaluate_perplexity(quantize_llm_params_int8(params, cfg), cfg, val, **kw)
    int4 = evaluate_perplexity(quantize_llm_params_int4(params, cfg), cfg, val, **kw)
    int4_host = evaluate_perplexity(quantize_llm_params_int4(host, cfg), cfg, val, **kw)
    log(f"[ANCHOR] code_llm_small val ppl (16384 tokens, s=1024, b=2): card {dense:.4f}, host CPU "
        f"plain path {dense_host:.4f}, pinned {pinned}; int8 {int8:.4f}; int4 card {int4:.4f}, "
        f"host {int4_host:.4f}")
    if abs(dense - pinned) / pinned > 0.05:
        raise AssertionError(f"ppl {dense} is not within 5% of the pinned {pinned}")
    if abs(dense - dense_host) / dense_host > 1e-2:
        raise AssertionError(f"ppl on the card {dense} vs the host's plain path {dense_host}")
    if abs(int8 - dense) / dense > 0.02:
        raise AssertionError(f"int8 ppl {int8} is not within 2% of dense {dense}")
    if abs(int4 - int4_host) / int4_host > 1e-2:
        raise AssertionError(f"int4 ppl on the card {int4} vs the host's plain path {int4_host}")
    calib = [train[i * 1024:(i + 1) * 1024].reshape(1, 1024) for i in range(8)]
    p2, c2, info = two_stage_2ssp(params, cfg, calib, 0.25, seq_len=1024)
    pruned = evaluate_perplexity(p2, c2, val, **kw)
    sparsity = 1.0 - count_main_params(c2)[0] / count_main_params(cfg)[0]
    log(f"[ANCHOR] code_llm_small after 25% 2SSP: ppl {pruned:.4f}, pruned attention "
        f"{info['pruned_attention_blocks']}, kept FFN width {info['num_preserve_mlp']} of "
        f"{cfg.intermediate_size}, achieved sparsity {sparsity:.4f}")
    if not math.isfinite(pruned) or pruned > 10 * dense:
        raise AssertionError(f"ppl after 25% 2SSP {pruned} vs dense {dense}")


TRAIN_UPDATES = 4


def profile_train_step(params, cfg, device) -> None:
    """Where one update's time goes at the main path's shape (remat on, b=1,
    s=2048, clip, AdamW with bf16 moments): a warm-up update, one timed on the
    host clock, then ``torch.profiler`` over one more; prints the wall time,
    the device activity's share of it and the device time by kind: the port's
    flash forward and backward kernels, GEMMs, the rest."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ssp_x_vit_tpu_torch.llm.datasets import synthetic_token_stream
    from ssp_x_vit_tpu_torch.llm.train import make_llama_train_step
    from ssp_x_vit_tpu_torch.llm.trainer import TrainConfig, make_optimizer

    tc = TrainConfig(total_steps=TRAIN_UPDATES)
    optimizer = make_optimizer(tc)
    step = make_llama_train_step(cfg, optimizer)
    state = optimizer.init(params)
    tokens = synthetic_token_stream(2049, cfg.vocab_size, seed=9).reshape(1, 2049)
    step(params, state, tokens)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(params, state, tokens)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3  # without the profiler
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(params, state, tokens)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and _device_us(e) > 0]
    total_ms = sum(_device_us(e) for e in kernels) / 1e3
    if total_ms <= 0:
        log("[PROFILE] train update: the trace holds no device time: not measured")
        return
    kinds = {"flash forward (ssp::flash::)": 0.0, "flash backward (ssp::flash_bwd::)": 0.0,
             "GEMMs (gemm / nvjet / sm90 / cutlass)": 0.0, "other": 0.0}
    for e in kernels:
        name = e.key.lower()
        if "flash_bwd" in name:
            kind = "flash backward (ssp::flash_bwd::)"
        elif "ssp::flash" in name:
            kind = "flash forward (ssp::flash::)"
        elif any(t in name for t in ("gemm", "nvjet", "sm90", "cutlass")):
            kind = "GEMMs (gemm / nvjet / sm90 / cutlass)"
        else:
            kind = "other"
        kinds[kind] += _device_us(e) / 1e3
    log(f"[PROFILE] train update b=1 s=2048 bf16 remat: {wall_ms:.1f} ms wall (host clock, no "
        f"profiler), {total_ms:.1f} ms of device activity in the trace "
        f"({100 * total_ms / wall_ms:.0f}% of the wall time); by kind: "
        + ", ".join(f"{k} {v:.1f} ms ({100 * v / total_ms:.1f}%)" for k, v in kinds.items()))
    for e in sorted(kernels, key=_device_us, reverse=True)[:8]:
        ms = _device_us(e) / 1e3
        log(f"[PROFILE]   {ms:8.3f} ms {100 * ms / total_ms:5.1f}%  x{e.count:<5d} {e.key[:90]}")


def phase_main_train(device) -> dict:
    """The training CLI (``cli.train_llm``) on a fresh bf16 model of Llama-2-7B
    width and depth (``--init-json``): b=1, s=2048, remat on, the synthetic
    stream, ``TRAIN_UPDATES`` updates. Losses finite at every update; flash
    forward launches = layers x updates x 2 (forward and remat recompute),
    each backward kernel = layers x updates. Returns the run's launches."""
    import math

    import torch

    from ssp_x_vit_tpu_torch.cli import train_llm
    from ssp_x_vit_tpu_torch.ops.kernels import KERNEL_NAMES, launch_counts, reset_launch_counts

    argv = ["--init-json", json.dumps(LLAMA_2_7B), "--steps", str(TRAIN_UPDATES),
            "--batch-size", "1", "--seq-len", "2048", "--synthetic-data", "--log-every", "1",
            "--backend", "cuda"]
    log(f"[MAIN] train_llm {' '.join(argv)}")
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = train_llm.run(train_llm.build_argparser().parse_args(argv))
    seconds = time.perf_counter() - t0
    counts = {name: launch_counts[name] for name in KERNEL_NAMES}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    hist = [h for h in out["history"] if "loss" in h]
    elapsed = [h["tokens_seen"] / h["tok_per_s"] for h in hist]
    per_update = [b - a for a, b in zip([0.0] + elapsed[:-1], elapsed)]
    n_params = sum(v.numel() for v in out["params"]["blocks"].values()) + sum(
        v.numel() for k, v in out["params"].items() if k != "blocks")
    log(f"[MAIN] train_llm Llama-2-7B width ({n_params / 1e9:.3f} B bf16 parameters, bf16 AdamW "
        f"moments): {seconds:.1f} s for the CLI run, {out['seconds']:.1f} s in fit; s/update "
        f"{', '.join(f'{t:.3f}' for t in per_update)}; {hist[-1]['tok_per_s']} tokens/s over the "
        f"run ({2048 / per_update[-1]:.0f} at the last update); peak {peak:.1f} GiB")
    log(f"[MAIN] train_llm launches {json.dumps({k: n for k, n in counts.items() if n})}")
    if len(hist) != TRAIN_UPDATES or not all(math.isfinite(h["loss"]) for h in hist):
        raise AssertionError(f"train_llm: losses {[h['loss'] for h in hist]}")
    layers = LLAMA_2_7B["num_layers"]
    want = {"flash_attention": layers * TRAIN_UPDATES * 2,
            "flash_attention_bwd_dq": layers * TRAIN_UPDATES,
            "flash_attention_bwd_dkv": layers * TRAIN_UPDATES}
    if any(counts[k] != n for k, n in want.items()):
        raise AssertionError(f"train_llm launches {counts} != {want}")
    profile_train_step(out["params"], out["cfg"], device)
    return counts


def phase_anchor_train(device) -> None:
    """``ckpts/code_llm_small`` in fp32 on ``corpus_slice/train.bin``: the first
    update's gradients and three updates' losses on the card (kernels) against
    the host CPU (plain path) from the same batches (1e-4 of max(1, |grad|),
    1e-4 relative); four updates killed after the checkpoint at update 2 and
    resumed end bit-identical to the uninterrupted run; accumulation of two
    b=4 microbatches equals one b=8 batch (loss after two updates, 1e-5)."""
    import numpy as np
    import torch

    from ssp_x_vit_tpu_torch.llm.checkpoints import load_llm_model
    from ssp_x_vit_tpu_torch.llm.optim import tree_leaves
    from ssp_x_vit_tpu_torch.llm.train import next_token_loss, trainable_tree
    from ssp_x_vit_tpu_torch.llm.trainer import TrainConfig, Trainer

    here = os.path.dirname(os.path.abspath(__file__))
    ckpt = os.path.join(here, "ckpts", "code_llm_small")
    params, cfg = load_llm_model(ckpt, device=device, dtype=torch.float32)
    s = 512
    ids = np.asarray(np.memmap(os.path.join(ckpt, "corpus_slice", "train.bin"), np.uint16, "r")
                     [:20 * (s + 1)], np.int32).reshape(20, s + 1)
    batches4 = [ids[4 * i:4 * i + 4] for i in range(4)]
    kw = dict(learning_rate=3e-4, total_steps=4, warmup_steps=1, compute_dtype="float32",
              log_every=1)

    def copy(tree, dev):
        return {k: copy(v, dev) if isinstance(v, dict) else v.to(dev, copy=True)
                for k, v in tree.items()}

    # the first update's gradients, card against host
    places = (("card", device), ("host", torch.device("cpu")))
    grads, losses = {}, {}
    for place, dev in places:
        tree, leaves = trainable_tree(copy(params, dev))
        next_token_loss(tree, torch.from_numpy(batches4[0]).long().to(dev), cfg,
                        compute_dtype=torch.float32).backward()
        grads[place] = [leaf.grad.cpu() for leaf in leaves]
    scale = max(1.0, max(g.abs().max().item() for g in grads["host"]))
    gerr = max((a - b).abs().max().item() for a, b in zip(grads["card"], grads["host"])) / scale
    t0 = time.perf_counter()
    for place, dev in places:
        _, hist = Trainer(cfg, TrainConfig(**dict(kw, total_steps=3))).fit(
            copy(params, dev), batches4[:3], verbose=False)
        losses[place] = [h["loss"] for h in hist]
    lerr = max(abs(a - b) / abs(b) for a, b in zip(losses["card"], losses["host"]))
    log(f"[ANCHOR] code_llm_small train fp32 b=4 s={s}: first-update grads card vs host CPU "
        f"scaled {gerr:.3e} (tol 1e-4); losses card {losses['card']} host {losses['host']} "
        f"(max rel {lerr:.3e}, tol 1e-4; {time.perf_counter() - t0:.1f} s)")
    if gerr > 1e-4 or lerr > 1e-4 or len(losses["card"]) != 3:
        raise AssertionError("code_llm_small training on the card disagrees with the host")

    class Killed(Exception):
        pass

    def dies_after_three():
        yield from batches4[:3]
        raise Killed

    with tempfile.TemporaryDirectory() as tmp:
        whole = copy(params, device)
        Trainer(cfg, TrainConfig(checkpoint_dir=os.path.join(tmp, "a"), checkpoint_every=2,
                                 **kw)).fit(whole, batches4, verbose=False)
        resumed = copy(params, device)
        tc = TrainConfig(checkpoint_dir=os.path.join(tmp, "b"), checkpoint_every=2, **kw)
        try:
            Trainer(cfg, tc).fit(resumed, dies_after_three(), verbose=False)
            raise AssertionError("the killed run did not stop")
        except Killed:
            pass
        _, hist = Trainer(cfg, tc).fit(resumed, batches4, verbose=False)
        a = torch.load(os.path.join(tmp, "a", "step_4.pt"), weights_only=True)
        b = torch.load(os.path.join(tmp, "b", "step_4.pt"), weights_only=True)
    same = all(torch.equal(x, y) for x, y in zip(tree_leaves(whole), tree_leaves(resumed)))
    same_state = all(torch.equal(x, y) for key in ("mu", "nu") for x, y in
                     zip(tree_leaves(a["opt_state"][key]), tree_leaves(b["opt_state"][key])))
    log(f"[ANCHOR] code_llm_small resume on the card: killed after update 2's checkpoint, resumed "
        f"at update {hist[0]['update']}: parameters bit-identical {same}, moments {same_state}")
    if not (same and same_state and hist[0]["update"] == 3):
        raise AssertionError("the resumed run is not bit-identical to the uninterrupted one")

    eval_tokens = torch.from_numpy(ids[16:20]).long().to(device)
    after = {}
    for accum, bsz in ((2, 4), (1, 8)):
        run_batches = [ids[bsz * i:bsz * i + bsz] for i in range(16 // bsz)]
        trained = copy(params, device)
        Trainer(cfg, TrainConfig(**dict(kw, total_steps=2, accum_steps=accum))).fit(
            trained, run_batches, verbose=False)
        with torch.no_grad():
            after[accum] = next_token_loss(trained, eval_tokens, cfg,
                                           compute_dtype=torch.float32, remat=False).item()
    rel = abs(after[2] - after[1]) / abs(after[1])
    log(f"[ANCHOR] code_llm_small accumulation: 2 updates of --accum 2 at b=4 vs b=8, loss on "
        f"held-out rows {after[2]:.7f} vs {after[1]:.7f} (rel {rel:.3e}, tol 1e-5)")
    if rel > 1e-5:
        raise AssertionError("accumulated microbatches differ from the large batch")


def flash_build_summary(build_log) -> list:
    """One [BUILD] line per bf16 flash kernel instantiation (the wgmma
    kernels: forward, dq, dk/dv at head_dim tiles 64 / 128 / 256): ptxas's
    registers and spill bytes."""
    import re

    lines = []
    for source in ("flash_attention", "flash_attention_bwd"):
        entry, spill = "", ""
        for line in build_log.get(source, "").splitlines():
            if "Compiling entry function" in line:
                entry, spill = (line.split("'")[1] if "'" in line else ""), ""
            elif "spill stores" in line:
                spill = line.strip()
            elif "Used" in line and "registers" in line:
                kind = re.search(r"2wg\d*(fwd_kernel|dq_kernel|dkv_kernel)ILi(\d+)E", entry)
                regs = re.search(r"Used (\d+) registers", line)
                if kind and regs:
                    lines.append(f"[BUILD] flash bf16 {kind.group(1)} head_dim tile {kind.group(2)}: "
                                 f"{regs.group(1)} registers; {spill}")
    return lines


def vit_build_summary(build_log) -> list:
    """One [BUILD] line per bf16 wgmma instantiation of the ViT block kernels:
    the GEMM (tile width, TMA or element loads, epilogue kind) and the
    attention core (head_dim tile, key chunks in registers, 0 = two passes):
    ptxas's registers and spill bytes."""
    import re

    kinds = {"0": "bias", "1": "gelu", "2": "gelu+stats", "3": "residual", "4": "any"}
    lines = []
    for source in ("gemm", "attention"):
        entry, spill = "", ""
        for line in build_log.get(source, "").splitlines():
            if "Compiling entry function" in line:
                entry, spill = (line.split("'")[1] if "'" in line else ""), ""
            elif "spill stores" in line:
                spill = line.strip()
            elif "Used" in line and "registers" in line:
                regs = re.search(r"Used (\d+) registers", line)
                g = re.search(r"gemm_kernelILi(\d+)ELb(\d)ELi(\d)E", entry)
                c = re.search(r"core_kernelILi(\d+)ELi(\d)E", entry)
                if g and regs:
                    lines.append(f"[BUILD] vit gemm bf16 128x{g.group(1)} "
                                 f"{'tma' if g.group(2) == '1' else 'element loads'} "
                                 f"{kinds[g.group(3)]}: {regs.group(1)} registers; {spill}")
                elif c and regs:
                    lines.append(f"[BUILD] vit attention core bf16 head_dim tile {c.group(1)} "
                                 f"key chunks {c.group(2)}: {regs.group(1)} registers; {spill}")
    return lines


def main() -> int:
    if len(sys.argv) > 1:
        print(f"usage: python3 {sys.argv[0]}  (takes no arguments)", file=sys.stderr)
        return 2

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        from ssp_x_vit_tpu_torch.ops.kernels import build
    except ImportError as e:
        print(f"chip_smoke: the ssp_x_vit_tpu_torch package is not beside this script ({e})",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    log(f"[DEVICE] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[DEVICE] allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    build.build_all()
    log(f"[BUILD] {time.perf_counter() - t0:.1f} s (nvcc {build.build_seconds:.1f} s, "
        f"parallel over {len(build.SOURCES)} sources)")
    for name, text in build.build_log.items():
        entry = ""
        for line in text.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else ""
            elif "registers" in line or "spill" in line or "wgmma" in line:
                log(f"[BUILD] {name} {entry}: {line.strip()}")
    for line in flash_build_summary(build.build_log) + vit_build_summary(build.build_log):
        log(line)

    phase_t0 = time.perf_counter()

    def phase_done(name):
        nonlocal phase_t0
        torch.cuda.synchronize()
        log(f"[PHASE] {name}: {time.perf_counter() - phase_t0:.1f} s")
        phase_t0 = time.perf_counter()

    from ssp_x_vit_tpu_torch.ops.kernels import KERNEL_NAMES

    records = phase_kernels(device)
    check_vit_core(device)
    check_vit_gemm_edges(device)
    check_vit_block_gradients(device)
    records.update(phase_llm_kernels(device))
    records.update(phase_flash_backward(device))
    records.update(phase_paged_kernels(device))
    records.update(phase_fused_mlp(device))
    for b, dtype in ((64, torch.bfloat16), (64, torch.float32), (1, torch.float32)):
        time_kernel_parts(device, b, dtype)
    time_llm_parts(device)
    # Driven paths, each with the counts set to 0 just before it and read just
    # after. The CLI runs (two ViT, two LLM) are the main paths; fused_ffn and
    # quant_matmul have no caller under the CLIs (quant_matmul has none in
    # either package), so each is driven through its public op-level entry and
    # its record says so.
    direct = {"fused_ffn": ("ops.ffn.ffn_forward called directly", drive_ffn_forward(device)),
              "quant_matmul": ("direct wrapper call, no caller in the package",
                               drive_quant_matmul(device))}
    phase_done("kernels (phase 3)")
    cli_launches = {name: 0 for name in KERNEL_NAMES}
    with tempfile.TemporaryDirectory() as out_root:
        for name, n in phase_main(out_root, device).items():
            cli_launches[name] += n
    phase_done("main, ViT (phase 4)")
    llama = make_llama_7b(device)
    for name, n in phase_main_llm(device, *llama).items():
        cli_launches[name] += n
    phase_done("main, LLM (phase 4)")
    for name, n in phase_serving(device, *llama).items():
        cli_launches[name] += n
    phase_done("main, serving (phase 4)")
    for name, n in phase_contiguous(device, *llama).items():
        cli_launches[name] += n
    del llama
    torch.cuda.empty_cache()
    phase_done("main, contiguous serving (phase 4)")
    for name, n in phase_main_train(device).items():
        cli_launches[name] += n
    torch.cuda.empty_cache()
    phase_done("main, training (phase 4)")
    phase_anchor(device)
    phase_anchor_llm(device)
    phase_anchor_serving(device)
    phase_anchor_contiguous(device)
    phase_anchor_train(device)
    phase_done("anchors (phase 5)")

    missing = [name for name in KERNEL_NAMES
               if (direct[name][1] if name in direct else cli_launches[name]) <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on a driven path: {missing}")
    kernels = []
    for name in KERNEL_NAMES:
        driven_by, n_direct = direct.get(name, (
            "served runs over HTTP" if name.startswith("paged_")
            else "generate_kv_scan (contiguous serving)" if name == "fused_mlp_int8"
            else "cli runs", 0))
        kernels.append(dict(records[name], launches=cli_launches[name] + n_direct,
                            cli_launches=cli_launches[name], driven_by=driven_by))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
