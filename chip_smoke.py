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
            at decode and prefill rows and the same edges, and its bf16 weight
            stream at every m from 1 to 16 at three widths; ``fused_ffn_block``
            and ``fused_ffn`` under autograd (a grad_fn, one launch, gradients
            against the host CPU's; ``fused_ffn`` also at b=32 as the finetune
            steps call it, timed) and the attention blocks raising under
            autograd; the paged decode kernels, the write and the attention apart and in one
            write-and-attend launch from the same pools (with the key-run
            edges of the split plan, a dead slot and a slot past its table,
            the same bits twice), and the device time, host enqueue time and
            events time of each at the served decode shapes. Times kernel,
            plain version and a PyTorch library call with CUDA events, beside
            the data-sheet bound; then times each launch inside the wrappers
            ([PART] lines) beside ``torch.mm`` and SDPA. The op-level
            ``ops.ffn.ffn_forward`` and the standalone paged write and
            attention are driven on the card against the same call on CPU
            copies and against the write-and-attend launch. The MLA decode
            kernel (``paged_mla_attention`` / ``_q8``) after the latent-row
            write (pools bit for bit the plain write's) at DeepSeek-V3 decode
            (b=8, 128 heads, D=576, 2048 keys), 16 heads over ~520 ragged keys
            in pages of 16 and 256, and D=40, fp32 / bf16 / int8 pools, timed
            beside page gather + SDPA and the bound. The MLA decode layer's
            one launch (``paged_mla_attention_write``: the row write, then
            the attention) against its plain version, on the Hopper kernel
            (``paged_mla_write_hopper`` / ``_q8``; bf16 and int8 pools, 128
            heads) at DeepSeek-V3 decode, at the served shape (8 slots of ~520
            ragged keys) and over ragged 1-2048 keys in pages of 16 and 256,
            and on the mma.sync kernel (fp32 pools, 16 and 4 heads): pools bit
            for bit outside trash page 0, the same bits twice, planted faults
            rejected, timed (events, device, host enqueue) at both V3 shapes;
            the standalone row write + attention driven against it.
4. main     the 2SSP CLI (``cli.auto_2ssp.run``) on full-width ViT-B/16 with
            random weights and the synthetic dataset, finetuned first
            (``--do-finetune``: one epoch, 32 steps at b=32, bf16, every step
            through ``fused_ffn`` under autograd) and evaluated in int8 at the
            end (``--quantize int8``), then on ViT-Ti/16 (odd head count) with
            an adapter head trained on the frozen backbone and saved; a
            profiler split of one ViT-B/16 finetune step; then the LLM CLI
            (``cli.main_llm.run``) on a Llama-2-7B-width model (32 layers,
            random bf16 weights made on the card): 25% 2SSP with dense and
            pruned perplexity at s=2048, and a dense ``--quantize int4``
            evaluation; the same model served over HTTP on 127.0.0.1; then
            the training CLI (``cli.train_llm.run``) on a fresh bf16 model of
            the same shape, 4 updates at b=1, s=2048 with remat, and a
            profiler split of one update; then the HF round trips: ViT-B/16
            exported with ``export_hf_vit`` and the 2SSP CLI run on that
            directory (loaded parameters and fp32 logits bit for bit the
            source's), and Llama-2-7B widths cut to 2 layers exported with
            ``export_hf_llama`` and loaded back in bf16 (bit for bit; export
            and load seconds, peak host RSS during the load; one s=2048
            forward of each, same logits); then the ViT mask-ensembling and
            SRP stack on synthesized files in the real on-disk formats (AugReg
            ``.npz`` at ViT-B/16 and ViT-Ti/16 widths, ``index.csv``, CIFAR-100
            python pickles): ``auto_2ssp --use-srp-checkpoint`` on Ti/16 with
            ``--dataset cifar100 --export-framework-prefix --data-parallel``
            and on B/16 (``--stage s1``), ``normalize_scores`` on two ViT-B/16
            score files, a summation and a consensus grid (each one
            ``apply_mask_prune`` subprocess on the card; a re-run adds no row),
            ``apply_mask_prune.run`` in-process (rows 1 and 3, 12 launches per
            forward at the mask's widths, no plain block on the card), the
            token-pruned ViT-B/16 forward (b=64, bf16, schedule ((3, 139), (6,
            98), (9, 69)); logits against the plain blocks on the card, launches
            at the shortened lengths, latency with and without the schedule),
            ``vit_procgen`` token-pruned top-1 on the card against the host CPU,
            and the cubic resize on the card against the host; then the LLM
            comparison methods through ``cli.main_llm.run`` at Llama-2-7B
            widths (random bf16 weights; depth cut to 4 layers, 8 for
            EvoPress; 16 calibration windows of 2048 where the CLI defaults to
            256): SliceGPT rotation only (``slicegpt`` itself: fp32 logits
            within 5e-3 of max(1, |dense|) of the dense model's) and at 25%
            (``new_dim`` 3072, the sliced perplexity; seconds of capture,
            covariance, eigh and rotation), EvoPress with 2 generations (2
            blocks in each mask; the chosen masks' fitness recomputed over the
            last selection's minibatch, targets through pinned host memory,
            within 1e-5; no worse than generation 1's best; target bytes,
            forwards and seconds per generation), ``--ablation
            --ablation-quick`` (every row finite) and a 32-example code-cloze
            task pack built from the port's sources (byte ids); then the
            DeepSeek-V3 family at its published widths cut to 4 layers (3 dense
            + 1 MoE; random bf16 weights): through ``main_llm.run`` dense
            perplexity, shortGPT 25%, ``--quantize int4`` (row 10 must launch)
            and 25% 2SSP on the all-dense variant, ``deepseek_generate`` at
            b=8, and ``ServingEngine`` over ``MLAPagedServer`` (8 slots, bf16
            pools, int8 pools with chunked prefill: the Hopper write-and-attend
            kernel once per layer and decode step, no standalone row write or
            MLA attention, each served token within
            5e-2 of the prompt run alone), a decode-step measurement and
            profiler splits; then Mixtral-8x7B widths (random bf16 weights, 8
            experts, top-2): ``main_llm`` dense and ``--quantize int4`` at 4
            layers (row 10 must launch), the 8-layer model served over HTTP
            with bf16 pools and with int8 pools and chunked prefill (12
            requests of 64-512 tokens x 16; the write-and-attend kernel once
            per layer and decode step and no other paged kernel; each token
            within 5e-2 of its prompt run alone with the served run's expert
            choices, the flips counted), a decode-step measurement,
            ``generate_kv_scan`` at b=8, ``train_llm --init-json`` at 2 layers
            (flash forward / dq / dk-dv launches = 2 x updates x 2 / x 1 / x 1),
            and DeepSeek-V3 widths cut to 4 layers and 32 routed experts
            trained through ``Trainer`` (``e_bias`` bit for bit unchanged).
            Also: every ViT CLI batch through the native
            ``gather_batch`` (``native/dataloader.cc``), bit for bit the numpy
            gather's; multi-LoRA on the Llama-2-7B-width int8 tree ([LORA]: 3
            adapters of rank 16 on q/k/v/o, b=8 prompts of 448-480 tokens,
            ``lora_ids`` (0, 1, 2, 3, 0, 1, 2, 3), 64 decode steps of
            ``generate_kv_scan``: id-0 rows bit for bit the batch without ids,
            every token within 5e-2 of its prompt run alone with its id,
            ``fused_mlp_int8`` = 32 x 65; ms per decode step with and without
            ids); then local corpora: ``corpus_slice`` decoded, cut into
            documents at blank lines and written as ``save_to_disk``
            directories by ``scripts/arrow_corpus.py`` ([CORPUS], read back
            equal), ``main_llm --local_datasets`` 25% 2SSP at Llama-2-7B
            widths cut to 4 layers from a saved directory ([LOCAL]: the
            corpora used, sparsity within 0.02, flash per phase) and
            ``train_llm --data`` at Llama-2-7B width and depth ([TRAIN]: the
            first microbatch == the host tokenization, flash / dq / dk-dv = 32
            x updates x 2 / x 1 / x 1).
            Kernel launches per run, each driven path with the counts set to
            0 just before it.
5. anchor   the committed trained checkpoints: ``ckpts/vit_procgen`` (dense top-1,
            top-1 after 25% 2SSP, then after 2 epochs of finetuning; int8
            top-1; 4 LoRA and 4 KD steps with falling losses), the ViT-B/16
            finetune step in fp32 on the card against the host CPU, LoRA on
            ``ckpts/code_llm_small`` against the host CPU, and
            ``ckpts/code_llm_small`` (perplexity against the pinned value and
            the host CPU's plain path; int8, int4, 25% 2SSP; served tokens;
            fp32 training on the card against the host CPU, a bit-exact
            resume and gradient accumulation); then text: the native BPE
            engine re-encodes all of the decoded ``val.bin`` to the committed
            ids ([TOK] line), ``code_llm_small`` exported to an HF directory
            with its ``tokenizer.json`` runs ``cli.main_llm.run`` with
            ``--evaluate_perplexity --evaluate_qualitative --save-format hf``
            (perplexity against the ``.npz`` directory's and the pinned value,
            the answers as text, the saved directory bit for bit), and
            ``serve_http`` on that directory serves string prompts, a chat and
            a stop string with the host CPU's greedy text; then the LLM
            comparison methods on ``code_llm_small`` at s=256 in fp32, card
            against host CPU: SliceGPT 25% (sliced perplexity, rtol 1e-4),
            EvoPress seed 0 with one generation (the same masks, fitnesses
            within rtol 1e-4), ``run_ablations(quick=True)`` (each perplexity
            within rtol 1e-4) and a task pack through the committed
            ``tokenizer.json`` (the same accuracy, every score within 1e-3);
            then the tiny DeepSeek models, card against host CPU in fp32
            through ``main_llm.run`` (dense, shortGPT, window_based,
            blockpruner, 2SSP on the all-dense variant: perplexities within
            rtol 1e-4, the same choices), EvoPress with a small search (the
            same masks), and paged MLA greedy tokens == ``deepseek_generate``;
            then tiny llama-MoE (top-1, top-2) and DeepSeek models in fp32,
            card against host CPU: first-update gradients, three updates'
            losses and fp32-pool served tokens; then ``code_llm_small`` with
            ``--local_datasets`` on the card and the host CPU (the same token
            streams, dense perplexity within 1e-4 relative) and with two
            adapters through ``generate_kv_scan`` (``lora_ids`` (0, 1, 2, 1),
            fp32, token for token against the host CPU).

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


def check_vit_block_gradients(device) -> dict:
    """Under autograd, fused_ffn_block (row 3) and fused_ffn (row 4, the call
    every finetune step makes) run their kernel inside an autograd Function:
    the output has a grad_fn, the kernel launches once per call, and the
    gradients of every input that takes one (the block's gate a tensor)
    match the host CPU's fp32 autodiff of the plain version, fp32 and bf16,
    at ViT-B/16 width: the block at b=2 with mask, gate and stats; fused_ffn
    at b=2 with mask and stats and at b=32 (the finetune batch) as the
    finetune steps call it, no mask and no stats (the stats stay out of the
    graph, None stays None). Times row 4 under autograd at b=32 bf16 (forward,
    forward + backward) beside the plain version's autodiff and returns those
    times. The fused attention blocks, which have no backward, raise under
    autograd."""
    import torch

    from ssp_x_vit_tpu_torch.ops.kernels import fused_attn_block as fab
    from ssp_x_vit_tpu_torch.ops.kernels import fused_ffn as ffk
    from ssp_x_vit_tpu_torch.ops.kernels import launch_counts

    gen = torch.Generator().manual_seed(13)
    s, d, f = 197, 768, 3072
    names = ("x", "ln_scale", "ln_bias", "fc1_kernel", "fc1_bias", "fc2_kernel", "fc2_bias", "gate")
    mask = (torch.rand(f, generator=gen) > 0.3).float()
    cases = [("fused_ffn_block", 2, True), ("fused_ffn", 2, True), ("fused_ffn", 32, False)]
    timing = {}
    for name, b, extras in cases:
        block = name == "fused_ffn_block"
        host = [torch.randn(b, s, d, generator=gen), 1 + 0.1 * torch.randn(d, generator=gen),
                0.1 * torch.randn(d, generator=gen), torch.randn(d, f, generator=gen) * d ** -0.5,
                0.1 * torch.randn(f, generator=gen), torch.randn(f, d, generator=gen) * f ** -0.5,
                0.1 * torch.randn(d, generator=gen), torch.full((), 0.7)]
        picked = list(range(8)) if block else [0, 3, 4, 5, 6]
        g_out = torch.randn(b, s, d, generator=gen)
        kw = dict(neuron_mask=mask, collect_stats=True) if extras else {}

        def call(leaves, dev):
            kwx = dict(kw, neuron_mask=mask.to(dev)) if extras else kw
            if block:
                return ffk.fused_ffn_block(*leaves[:7], gate=leaves[7], **kwx)
            return ffk.fused_ffn(*leaves, **kwx)

        def grads(dev, dtype):
            leaves = [host[i].to(dev, dtype if host[i].dim() else torch.float32, copy=True)
                      .requires_grad_() for i in picked]
            out, stats = call(leaves, dev)
            if out.grad_fn is None or (stats is not None and stats.grad_fn is not None) \
                    or (stats is None) == extras:
                raise AssertionError(f"{name} under autograd: no grad_fn on the output, or the "
                                     f"stats in the graph or missing")
            out.backward(g_out.to(dev, dtype))
            return [t.grad.float().cpu() for t in leaves]

        t0 = time.perf_counter()
        ref = grads("cpu", torch.float32)
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[1]
            before = launch_counts[name]
            got = grads(device, dtype)
            torch.cuda.synchronize()
            if launch_counts[name] - before != 1:
                raise AssertionError(f"{name} under autograd did not launch its kernel once")
            worst = 0.0
            for i, a, r in zip(picked, got, ref):
                rel = (a - r).abs().max().item() / max(1.0, r.abs().max().item())
                if rel > TOL[dn]:
                    raise AssertionError(f"{name} b={b} gradient of {names[i]} {dn}: scaled "
                                         f"error {rel:.3e} > {TOL[dn]}")
                worst = max(worst, rel)
            log(f"[KERNEL] {name} under autograd b={b} s={s} d={d} f={f} {dn}"
                f"{' mask, stats' if extras else ' no mask, no stats (the finetune call)'}: "
                f"grad_fn set, one launch, gradients of {len(picked)} inputs vs the host CPU's "
                f"fp32 autodiff: worst scaled error {worst:.3e} tol={TOL[dn]} ok "
                f"({time.perf_counter() - t0:.1f} s with the host reference)")
        if name == "fused_ffn" and b == 32:
            leaves = [host[i].to(device, torch.bfloat16).requires_grad_() for i in picked]
            g = g_out.to(device, torch.bfloat16)
            plain = ffk.fused_ffn_plain

            def fwd_bwd(fn):
                out, _ = fn(*leaves)
                torch.autograd.grad(out, leaves, g)

            timing = dict(
                autograd_fwd_ms=time_ms(lambda: ffk.fused_ffn(*leaves)),
                autograd_fwd_bwd_ms=time_ms(lambda: fwd_bwd(ffk.fused_ffn)),
                autograd_plain_fwd_bwd_ms=time_ms(lambda: fwd_bwd(plain)),
                autograd_fwd_device_ms=device_ms(lambda: ffk.fused_ffn(*leaves)),
                autograd_fwd_bwd_device_ms=device_ms(lambda: fwd_bwd(ffk.fused_ffn)),
                autograd_plain_fwd_bwd_device_ms=device_ms(lambda: fwd_bwd(plain)))
            log(f"[TIME] fused_ffn under autograd b=32 s={s} d={d} f={f} bf16 (the finetune "
                f"call), CUDA events (host dispatch included) / profiler device time per call: "
                f"forward {timing['autograd_fwd_ms']:.4f} / "
                f"{_ms(timing['autograd_fwd_device_ms'])}, forward + backward "
                f"{timing['autograd_fwd_bwd_ms']:.4f} / {_ms(timing['autograd_fwd_bwd_device_ms'])} "
                f"(the backward recomputes the plain FFN); the plain version's autodiff "
                f"{timing['autograd_plain_fwd_bwd_ms']:.4f} / "
                f"{_ms(timing['autograd_plain_fwd_bwd_device_ms'])}")
    x = torch.randn(2, s, d, generator=gen).to(device, torch.bfloat16).requires_grad_()
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
    return timing


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
                 layers=None, layer=None, mp=None):
    """One decode step's operands at the given geometry: pools whose live rows
    are random (int8 pools: quantized random rows), a page table of shuffled
    physical pages with room for one more token per sequence (``mp`` columns
    at least, the rest 0), lengths, window starts, the new K/V rows and the
    query. ``layers``/``layer``: a 5D pool with only that layer filled."""
    import torch

    from ssp_x_vit_tpu_torch.ops.kernels.paged_attention import quantize_token_kv

    b = len(lens)
    need = [-(-(n + 1) // ps) for n in lens]
    mp, num_pages = max(need + [mp or 0]), 1 + sum(need)
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


def host_us(fn, iters: int = 200) -> float:
    """Host microseconds per call to enqueue ``iters`` calls behind a spin
    kernel that keeps the card busy (no synchronize inside): what a
    host-bound loop pays per call."""
    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds * 1e6 / iters


_PROFILER_WARM = []


def device_ms(fn, iters: int = 20):
    """Device milliseconds per call from a ``torch.profiler`` trace of
    ``iters`` calls (the kernels' own time), or None: not measured. The first
    trace of a process is taken once untimed (it can miss kernels while CUPTI
    starts its activity buffers). A trace that holds no device time is taken
    again, up to twice; if all come back empty a line says so, with what the
    traces held, and the result is None: CUDA-event time, which includes the
    launches, is the records' ``ms`` and never their device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    if not _PROFILER_WARM:
        with profile(activities=[ProfilerActivity.CUDA]):
            fn()
            torch.cuda.synchronize()
        _PROFILER_WARM.append(True)
    seen = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = prof.key_averages()
        ms = sum(_device_us(e) for e in rows
                 if e.device_type == torch.autograd.DeviceType.CUDA) / iters / 1e3
        if ms > 0:
            return ms
        on_device = sum(e.device_type == torch.autograd.DeviceType.CUDA for e in rows)
        seen.append(f"{len(rows)} rows, {on_device} on the device")
    log(f"[TIME] three profiler traces held no device time ({'; '.join(seen)}): device time "
        f"not measured")
    return None


def _ms(x) -> str:
    """A time in ms, or 'not measured' for None."""
    return "not measured" if x is None else f"{x:.4f} ms"


def _rate(amount, ms, unit: str, per_ms: float) -> str:
    """amount / ms in ``unit`` (``per_ms``: the amount per ms that is one unit), or
    'not measured'."""
    return "rate not measured" if ms is None else f"{amount / max(ms, 1e-9) / per_ms:.2f} {unit}"


def _without_trash(pool, layered):
    """The pool's tensors with trash page 0 cut out."""
    cut = (slice(None),) * (2 if layered else 1) + (slice(1, None),)
    return [t[cut] for t in (pool.values() if isinstance(pool, dict) else [pool])]


def phase_paged_kernels(device) -> dict:
    """paged_attention, paged_attention_q8, paged_pool_write and
    paged_pool_write_q8 against their plain versions, as the decode step made
    them before they were fused (write the new row at slot len, then attend
    len + 1 keys), and paged_attention_write / _q8, the two in one launch,
    against the same plain versions from the same pools; returns their
    kernels-line records, timed at the Llama-2-7B decode shape (b=8, 2048 keys
    each, and 8 slots of ~520 keys; bf16 and int8 pools)."""
    import torch
    import torch.nn.functional as F

    from ssp_x_vit_tpu_torch.ops.kernels import launch_counts
    from ssp_x_vit_tpu_torch.ops.kernels import paged_attention as tpa

    gen = torch.Generator(device=device)
    gen.manual_seed(8)
    records = {}
    source = "ssp_x_vit_tpu_torch/ops/kernels/csrc/paged_attention.cu"
    run = tpa.split_plan(8, 32, 32, 128, 64, 32, tpa._sm_count(device)).pages_per_split * 64
    if 4 * run > 32 * 64:
        raise AssertionError(f"runs of {run} keys leave no empty run after the window case")
    cases = [  # label, geometry, softcap, timed
        ("Llama-2-7B decode, ragged, layer 17 of an 18-layer pool (offsets past 2^31 elements)",
         dict(nq=32, nkv=32, hd=128, ps=64, lens=[1, 63, 64, 300, 777, 1024, 1500, 2047],
              layers=18, layer=17), None, False),
        ("Llama-2-7B decode, 2047 cached keys each",
         dict(nq=32, nkv=32, hd=128, ps=64, lens=[2047] * 8), None, True),
        ("Llama-2-7B decode, 8 slots of ~520 cached keys",
         dict(nq=32, nkv=32, hd=128, ps=64, lens=[519 + 3 * i for i in range(8)], mp=32), None,
         True),
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
        # the served table width (32 pages of 64) at b=8: 1, ps - 1, ps, ps + 1, a run - 1,
        # a run, a run + 1 keys (a run: the split plan's pages of one block), and 2.5 runs
        # of keys under a window of one run, which starts inside the second run: the
        # first run is empty, and so is the fourth
        ("split edges, served table width",
         dict(nq=32, nkv=32, hd=128, ps=64, lens=[0, 62, 63, 64, run - 2, run - 1, run,
                                                   2 * run + run // 2 - 1], mp=32, window=run),
         None, False),
        # a dead slot (its table row zeroed: it writes and reads trash page 0; its output is
        # not compared) and a slot past its full table (it writes row 0 of page 0 and
        # attends the table's mp * ps keys without the new one)
        ("dead slot and a slot past the table, served table width",
         dict(nq=32, nkv=32, hd=128, ps=64, lens=[5, 100, 700, 1500, 2046, 300, 900, 2040],
              mp=32, dead=[5], past=[7]), None, False),
    ]
    variants = [("float32", torch.float32, "float"), ("bfloat16", torch.bfloat16, "float"),
                ("bfloat16", torch.bfloat16, "int8")]  # an int8 cache computes in bf16
    for label, geo, softcap, timed in cases:
        geo = dict(geo)
        dead, past = geo.pop("dead", []), geo.pop("past", [])
        for dn, dtype, kind in variants:
            c = _paged_setup(gen, device, dtype, kind, **geo)
            li = c["layer"]
            b, mp = len(geo["lens"]), c["table"].shape[1]
            for r in dead:
                c["table"][r] = 0
            for r in past:
                c["lens"][r] = mp * geo["ps"] + 5
            lens1 = c["lens"] + 1
            live = torch.tensor([r not in dead for r in range(b)], device=device)
            name = f"{label}: b={b} nq={geo['nq']} nkv={geo['nkv']} " \
                   f"hd={geo['hd']} ps={geo['ps']} {dn}{' int8 pools' if kind == 'int8' else ''}"
            k_orig, v_orig = _clone_pool(c["k"]), _clone_pool(c["v"])
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
            again = tpa.paged_attention(c["q"], c["k"], c["v"], c["table"], lens1, c["starts"],
                                        softcap, li)
            ref = tpa.paged_attention_plain(c["q"], c["k"], c["v"], c["table"], lens1, c["starts"],
                                            softcap, li)
            torch.cuda.synchronize()
            if not torch.isfinite(got[live].float()).all():
                raise AssertionError(f"paged_attention {name}: non-finite output")
            if not torch.equal(got, again):
                raise AssertionError(f"paged_attention {name}: two runs differ")
            err, rel = scaled_err(got[live], ref[live])
            tol = TOL["bfloat16"] if kind == "int8" else TOL[dn]
            if rel > tol:
                raise AssertionError(f"paged_attention {name}: scaled error {rel:.3e} > {tol}")
            # write-and-attend in one launch, twice, each from the pools as they were: pools
            # bit for bit with the plain write outside trash page 0, the output of the live
            # rows within tol of the plain write + attention, the same bits both times
            n0 = launch_counts["paged_attention_write" + ("_q8" if kind == "int8" else "")]
            fused = []
            for _ in range(2):
                kf, vf = _clone_pool(k_orig), _clone_pool(v_orig)
                fused.append((tpa.paged_attention_write(c["q"], c["k_new"], c["v_new"], kf, vf,
                                                        c["table"], c["lens"], c["starts"],
                                                        softcap, li), kf, vf))
            torch.cuda.synchronize()
            (f_got, kf, vf), (f_again, kf2, vf2) = fused
            if launch_counts["paged_attention_write" + ("_q8" if kind == "int8" else "")] != n0 + 2:
                raise AssertionError(f"paged_attention_write {name}: not one launch per call")
            layered = li is not None
            for a, b_, r in ((kf, kf2, c["k"]), (vf, vf2, c["v"])):
                for x, y, z in zip(_without_trash(a, layered), _without_trash(b_, layered),
                                   _without_trash(r, layered)):
                    if not (torch.equal(x, y) and torch.equal(x, z)):
                        raise AssertionError(f"paged_attention_write {name}: pools differ from "
                                             "the plain write or between two runs")
            if not torch.equal(f_got[live], f_again[live]):  # a dead slot reads what it writes
                raise AssertionError(f"paged_attention_write {name}: two runs differ")
            if not torch.isfinite(f_got[live].float()).all():
                raise AssertionError(f"paged_attention_write {name}: non-finite output")
            f_err, f_rel = scaled_err(f_got[live], ref[live])
            if f_rel > tol:
                raise AssertionError(f"paged_attention_write {name}: scaled error {f_rel:.3e} > {tol}")
            del kf, vf, kf2, vf2, fused, k_orig, v_orig
            plan = tpa.split_plan(b, geo["nkv"], geo["nq"], geo["hd"], geo["ps"], mp,
                                  tpa._sm_count(device))
            log(f"[KERNEL] paged write (pools identical to the plain write) + attention {name}: "
                f"max_abs_err={err:.3e} scaled={rel:.3e}; write-and-attend in one launch (pools "
                f"identical outside page 0): max_abs_err={f_err:.3e} scaled={f_rel:.3e}; "
                f"tol={tol} ok (runs of {plan.pages_per_split} pages x {plan.splits}; same bits "
                "on a second run)")
            if not (timed and dtype == torch.bfloat16):
                del c
                continue

            # times at the served decode shapes, bf16 queries
            q8 = kind == "int8"
            nq, nkv, hd, ps = geo["nq"], geo["nkv"], geo["hd"], geo["ps"]
            keys = int(lens1.sum().item())
            row_bytes = (hd + 4) if q8 else hd * 2
            common_bytes = 2 * b * nq * hd * 2 + c["table"].numel() * 4 + 4 * b  # q, out, table, lens
            new_bytes = 2 * b * nkv * (hd * 2 + row_bytes)  # read k_new / v_new, write the rows
            a_bytes = 2 * nkv * row_bytes * keys + common_bytes
            a_flops = 4 * nq * hd * keys
            a_bound, a_by = _bound(a_flops, a_bytes, "bfloat16")
            w_bytes = new_bytes + c["table"].numel() * 4 + 4 * b
            w_bound, w_by = _bound(0, w_bytes, "bfloat16")
            f_bytes = 2 * nkv * row_bytes * (keys - b) + new_bytes + common_bytes
            f_bound, f_by = _bound(a_flops, f_bytes, "bfloat16")

            def attend():
                return tpa.paged_attention(c["q"], c["k"], c["v"], c["table"], lens1, None, None, li)

            def write():
                return tpa.paged_cache_write(c["k"], c["v"], c["k_new"], c["v_new"], c["table"],
                                             c["lens"], li)

            def pair():
                write()
                return attend()

            def write_attend():
                return tpa.paged_attention_write(c["q"], c["k_new"], c["v_new"], c["k"], c["v"],
                                                 c["table"], c["lens"], None, None, li)

            def write_plain():
                tpa.paged_pool_write_plain(c["k"], c["k_new"], c["table"], c["lens"], li)
                tpa.paged_pool_write_plain(c["v"], c["v_new"], c["table"], c["lens"], li)

            def write_attend_plain():
                return tpa.paged_attention_write_plain(c["q"], c["k_new"], c["v_new"], c["k"],
                                                       c["v"], c["table"], c["lens"], None, None, li)

            t = {name_: dict(ms=time_ms(fn, iters=20), device_ms=device_ms(fn), host_us=host_us(fn))
                 for name_, fn in (("attend", attend), ("write", write), ("pair", pair),
                                   ("write_attend", write_attend))}
            ap_ms = time_ms(lambda: tpa.paged_attention_plain(c["q"], c["k"], c["v"], c["table"],
                                                              lens1, None, None, li), iters=5, warmup=1)
            fp_ms = time_ms(write_attend_plain, iters=5, warmup=1)
            table_l = c["table"].long()
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
            shape = f"b={b} nq={nq} nkv={nkv} hd={hd} ps={ps}, ~{keys // b} keys each, bf16" + \
                (" queries, int8 pools" if q8 else "")

            def stamp(k):
                return (f"{t[k]['ms']:.4f} ms (events), device {_ms(t[k]['device_ms'])}, host "
                        f"{t[k]['host_us']:.1f} us a call to enqueue")

            log(f"[TIME] paged_attention{suffix} {shape}: kernel {stamp('attend')} "
                f"({_rate(a_bytes, t['attend']['device_ms'], 'TB/s', 1e9)} of the bytes it must "
                f"move), "
                f"plain {ap_ms:.4f} ms, library page gather + SDPA {al_ms:.4f} ms, bound "
                f"{a_bound:.4f} ms ({a_by})")
            log(f"[TIME] paged_pool_write{suffix} {shape}: kernel {stamp('write')} (K and V in one "
                f"launch), plain {wp_ms:.4f} ms, library index_put_ "
                f"{'none for an int8 pool' if wl_ms is None else f'{wl_ms:.4f} ms'}, bound "
                f"{w_bound:.6f} ms ({w_by}; {w_bytes} bytes, far under a launch's latency)")
            log(f"[TIME] paged_attention_write{suffix} {shape}: one launch {stamp('write_attend')}; "
                f"the two calls it replaces (write, then attend) {stamp('pair')}; plain "
                f"{fp_ms:.4f} ms, bound {f_bound:.4f} ms ({f_by})")
            if geo["lens"][0] != 2047:
                continue  # the kernels line keeps the 2048-key shape
            common = dict(route="cuda", source=source, shape=shape, tol=tol)
            records["paged_attention" + suffix] = dict(
                common, name="paged_attention" + suffix,
                replaces="ssp_x_vit_tpu/ops/pallas/paged_attention.py:" + ("349" if q8 else "243"),
                tpu_kernel="_paged_pallas_grouped_q8" if q8 else "paged_attention_pallas",
                max_abs_err=err, scaled_err=rel, ms=t["attend"]["ms"], kernel_ms=t["attend"]["ms"],
                device_ms=t["attend"]["device_ms"], host_us=t["attend"]["host_us"], plain_ms=ap_ms,
                bound_ms=a_bound, bound_by=a_by, library_ms=al_ms, flops=a_flops, bytes=a_bytes)
            records["paged_pool_write" + suffix] = dict(
                common, name="paged_pool_write" + suffix,
                replaces="ssp_x_vit_tpu/ops/pallas/paged_attention.py:" + ("587" if q8 else "541"),
                tpu_kernel="_pool_write_pallas_q8" if q8 else "_pool_write_pallas_array",
                max_abs_err=0.0, scaled_err=0.0, ms=t["write"]["ms"], kernel_ms=t["write"]["ms"],
                device_ms=t["write"]["device_ms"], host_us=t["write"]["host_us"], plain_ms=wp_ms,
                bound_ms=w_bound, bound_by=w_by, library_ms=wl_ms, flops=0, bytes=w_bytes)
            records["paged_attention_write" + suffix] = dict(
                common, name="paged_attention_write" + suffix,
                replaces="ssp_x_vit_tpu/ops/pallas/paged_attention.py:" + ("587" if q8 else "541"),
                tpu_kernel=("_pool_write_pallas_q8 + _paged_pallas_grouped_q8" if q8 else
                            "_pool_write_pallas_array + paged_attention_pallas"),
                max_abs_err=f_err, scaled_err=f_rel, ms=t["write_attend"]["ms"],
                kernel_ms=t["write_attend"]["ms"], device_ms=t["write_attend"]["device_ms"],
                host_us=t["write_attend"]["host_us"], pair_device_ms=t["pair"]["device_ms"],
                pair_host_us=t["pair"]["host_us"], plain_ms=fp_ms, bound_ms=f_bound,
                bound_by=f_by, library_ms=None, flops=a_flops, bytes=f_bytes)
            del c
        torch.cuda.empty_cache()
    return records


def drive_paged_standalone(device) -> dict:
    """``paged_cache_write`` and ``paged_attention`` (bf16 and int8 pools) have
    no caller on the served path since the decode layer makes one
    ``paged_attention_write`` call; they stay for callers that write without
    attending (the JAX package's single-pool write) and are driven here at the
    served decode shape (8 slots of ~520 keys), against
    ``paged_attention_write`` from the same pools: the same pools bit for bit,
    outputs within the bf16 tolerance. Returns the launches this drive made."""
    import torch

    from ssp_x_vit_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from ssp_x_vit_tpu_torch.ops.kernels import paged_attention as tpa

    gen = torch.Generator(device=device)
    gen.manual_seed(10)
    reset_launch_counts()
    for kind in ("float", "int8"):
        c = _paged_setup(gen, device, torch.bfloat16, kind, nq=32, nkv=32, hd=128, ps=64,
                         lens=[519 + 3 * i for i in range(8)], mp=32)
        kf, vf = _clone_pool(c["k"]), _clone_pool(c["v"])
        tpa.paged_cache_write(c["k"], c["v"], c["k_new"], c["v_new"], c["table"], c["lens"])
        got = tpa.paged_attention(c["q"], c["k"], c["v"], c["table"], c["lens"] + 1)
        ref = tpa.paged_attention_write(c["q"], c["k_new"], c["v_new"], kf, vf, c["table"],
                                        c["lens"])
        torch.cuda.synchronize()
        err, rel = scaled_err(got, ref)
        same = _pools_differ(c["k"], kf) + _pools_differ(c["v"], vf) == 0
        log(f"[KERNEL] paged_cache_write + paged_attention ({kind} pools), the standalone "
            f"calls, vs paged_attention_write: pools identical {same}, max_abs_err={err:.3e} "
            f"scaled={rel:.3e} tol={TOL['bfloat16']}")
        if not same or rel > TOL["bfloat16"]:
            raise AssertionError(f"the standalone paged calls ({kind} pools) disagree with "
                                 "paged_attention_write")
    names = ("paged_attention", "paged_attention_q8", "paged_pool_write", "paged_pool_write_q8")
    return {name: launch_counts[name] for name in names}


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
        ("Llama-2-7B decode b=16", 16, 4096, 11008, True),
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
    check_fused_mlp_rows(device, gen)
    return records


def check_fused_mlp_rows(device, gen) -> None:
    """The bf16 weight stream (m <= 16) at every row count from 1 to 16, at the
    Llama-2-7B MLP (the TMA producer), a 2SSP-pruned f = 8253 and the
    ``code_llm_small`` width, x also one element off 16 bytes (the element-load
    producer): within the bf16 limit of the plain version, the same bits twice."""
    import torch

    from ssp_x_vit_tpu_torch.llm.quant import quantize_weight_int8
    from ssp_x_vit_tpu_torch.ops.kernels import quant_fused_mlp as tfm

    for label, d, f in (("Llama-2-7B", 4096, 11008), ("Llama-2-7B, 2SSP-pruned f", 4096, 8253),
                        ("code_llm_small", 384, 1024)):
        ws = [quantize_weight_int8(torch.randn(*shape, generator=gen, device=device)
                                   * shape[0] ** -0.5)
              for shape in ((d, f), (d, f), (f, d))]
        args = [t for pair in ws for t in pair]
        worst = 0.0
        for m in range(1, 17):
            x = torch.randn(m, d, generator=gen, device=device).bfloat16()
            x_off = torch.empty(m * d + 1, device=device, dtype=torch.bfloat16)[1:].view(m, d)
            x_off.copy_(x)
            got, again = tfm.fused_mlp_int8(x, *args), tfm.fused_mlp_int8(x, *args)
            off = tfm.fused_mlp_int8(x_off, *args)
            ref = tfm.fused_mlp_int8_plain(x, *args)
            torch.cuda.synchronize()
            if not (torch.isfinite(got.float()).all() and torch.equal(got, again)):
                raise AssertionError(f"fused_mlp_int8 {label} m={m}: non-finite or two runs differ")
            rel = max(scaled_err(got, ref)[1], scaled_err(off, ref)[1])
            if rel > TOL["bfloat16"]:
                raise AssertionError(f"fused_mlp_int8 {label} m={m} bf16: scaled error {rel:.3e}")
            worst = max(worst, rel)
        log(f"[KERNEL] fused_mlp_int8 weight stream {label} d={d} f={f} bf16, every m from 1 to 16 "
            f"(x aligned and off 16 bytes): worst scaled error {worst:.3e} tol {TOL['bfloat16']} ok "
            f"(same bits on a second run)")
        del ws, args
    torch.cuda.empty_cache()


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


FT_STEPS = 32  # one epoch of the CLI's 1024 synthetic training images at b=32


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def check_finetune_phase(model: str, report: dict, num_layers: int) -> None:
    """The CLI's finetune phase went through row 4 and nothing else: fused_ffn
    launched once per block and step, no fused block kernel; every step's
    loss finite."""
    import math

    ft = report["kernel_launches"]["finetune"]
    losses = report["finetune_losses"]
    seconds = report["phase_seconds"]["finetune"]
    log(f"[MAIN] {model} finetune: {seconds:.2f} s for {len(losses)} steps "
        f"({1e3 * seconds / max(1, len(losses)):.1f} ms a step, host clock, first step "
        f"included); losses {losses[0]:.4f} -> {losses[-1]:.4f}; launches "
        f"{json.dumps({k: n for k, n in ft.items() if n})}")
    if len(losses) != FT_STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{model}: finetune losses {losses}")
    if ft["fused_ffn"] != num_layers * FT_STEPS:
        raise AssertionError(f"{model}: fused_ffn launched {ft['fused_ffn']} times in the "
                             f"finetune phase, expected {num_layers} x {FT_STEPS}")
    for kernel in ("fused_attn_block_v2", "fused_attn_block", "fused_ffn_block"):
        if ft[kernel]:
            raise AssertionError(f"{model}: {kernel} launched in the finetune phase")


def check_adapter_run(report: dict, backbone: dict, params: dict, device) -> None:
    """--freeze-backbone left every backbone leaf as it was, bit for bit; the
    saved adapter.npz, loaded onto the final model's backbone
    (``load_cifar_adapter``, what --load-adapter calls), gives the finetuned
    head's logits on 4 images, bit for bit."""
    import torch

    from ssp_x_vit_tpu_torch.cli.common import resolve_dataset
    from ssp_x_vit_tpu_torch.models.adapter import load_cifar_adapter
    from ssp_x_vit_tpu_torch.models.vit import vit_forward_materialized

    changed = [p for p, t in _flat(params).items()
               if not p.startswith("head/") and not torch.equal(t, backbone[p])]
    if changed or len(backbone) != len(_flat(params)) - len(params["head"]):
        raise AssertionError(f"--freeze-backbone changed backbone leaves {changed[:4]}")
    final, cfg = report["model"]
    path = report["artifacts"]["adapter_path"]
    loaded, lcfg = load_cifar_adapter(path, {k: v for k, v in final.items() if k != "head"}, cfg)
    px = resolve_dataset("synthetic", cfg, device=device)[1].batches(1)[0]["pixel_values"][:4]
    with torch.inference_mode():
        want = vit_forward_materialized(final, px, cfg)
        got = vit_forward_materialized(loaded, px, lcfg)
    if lcfg != cfg or not torch.equal(got, want):
        raise AssertionError("the saved adapter does not reproduce the finetuned head's logits")
    log(f"[MAIN] vit-ti16 adapter: {len(backbone)} backbone leaves unchanged bit for bit; "
        f"{os.path.basename(path)} ({lcfg.head_type}, bottleneck {lcfg.adapter_bottleneck}) "
        f"loaded onto the pruned backbone gives the finetuned head's logits on 4 images, "
        f"bit for bit")


def phase_main(out_root: str, device) -> dict:
    """Full-width 2SSP CLI runs, with the recovery flags: ViT-B/16 finetunes
    the whole model (one epoch, 32 steps at b=32, bf16) and evaluates int8;
    ViT-Ti/16 trains an adapter head on a frozen backbone and saves it.
    Returns launches per kernel summed over the runs."""
    import torch

    from ssp_x_vit_tpu_torch.cli import auto_2ssp
    from ssp_x_vit_tpu_torch.cli.common import resolve_model
    from ssp_x_vit_tpu_torch.ops.kernels import KERNEL_NAMES, launch_counts, reset_launch_counts

    totals = {name: 0 for name in KERNEL_NAMES}
    gathered = watch_gather()
    runs = [
        ("vit-b16", "fused_attn_block_v2", ["--do-finetune", "--quantize", "int8"]),
        ("vit-ti16", "fused_attn_block", ["--use-adapter", "--do-finetune", "--freeze-backbone",
                                          "--save-adapter"]),
    ]
    for model, _, _ in runs:
        check_forward(model, device)
    for model, attn_kernel, flags in runs:
        argv = ["--model", model, "--dataset", "synthetic", "--target", "0.25",
                "--stage", "both", "--eval-batches", "2", "--min-remaining", "512",
                "--backend", "cuda", "--out-root", os.path.join(out_root, model), *flags]
        log(f"[MAIN] auto_2ssp {' '.join(argv)}")
        built = None
        if "--freeze-backbone" in flags:  # the model the CLI builds from its seed, kept to compare
            built = resolve_model(model, device=device)
            backbone = {p: t.clone() for p, t in _flat(built[0]).items()
                        if not p.startswith("head/")}
        reset_launch_counts()
        t0 = time.perf_counter()
        report = auto_2ssp.run(auto_2ssp.build_argparser().parse_args(argv), model=built)
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
        check_finetune_phase(model, report, report["model"][1].num_layers)
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
        if "--quantize" in flags:
            log(f"[MAIN] {model} int8: latency(b=1) {m['latency_int8_ms']} ms against the "
                f"pruned bf16 model's {m['latency_stage2_ms']} ms, top-1 {m['acc_int8']}; "
                f"{report['phase_seconds']['quantize']:.2f} s, launches "
                f"{json.dumps({k: n for k, n in by_phase['quantize'].items() if n})}")
            if not 0.0 <= m["acc_int8"] <= 1.0:
                raise AssertionError(f"{model}: acc_int8={m['acc_int8']}")
        if built is not None:
            check_adapter_run(report, backbone, built[0], device)
        del report, built
        torch.cuda.empty_cache()
    calls, images = gathered.stop()
    log(f"[MAIN] ViT batches: {calls} assembled by the native gather_batch "
        f"(native/dataloader.cc, g++-built), {images} images, each bit for bit the numpy "
        f"gather's on the same indices and flips")
    if calls == 0:
        raise AssertionError("the ViT CLI runs assembled no batch through gather_batch")
    profile_finetune_step(device)
    return totals


class watch_gather:
    """Wraps ``data.pipeline.gather_batch`` (the native gather every
    ``DataPipeline`` batch goes through) with a check: each batch it returns
    must be bit for bit ``gather_batch_plain`` (numpy) on the same indices and
    flips. ``stop()`` restores it and returns (calls, images)."""

    def __init__(self):
        import numpy as np

        from ssp_x_vit_tpu_torch.data import native_loader, pipeline

        self.pipeline, self.calls, self.images = pipeline, 0, 0
        real = pipeline.gather_batch

        def checked(images, idx, flips=None):
            out = real(images, idx, flips)
            if not np.array_equal(out, native_loader.gather_batch_plain(images, idx, flips)):
                raise AssertionError("gather_batch differs from the numpy gather")
            self.calls += 1
            self.images += len(out)
            return out

        self.real = real
        pipeline.gather_batch = checked

    def stop(self) -> tuple:
        self.pipeline.gather_batch = self.real
        return self.calls, self.images


def _vit_b16_batch(device, n: int):
    """ViT-B/16 with the CLI's random weights (its seed) and a batch of n images
    from the CLI's synthetic generator (n images only: the CLI's 1536 take
    seconds of host time to make)."""
    from ssp_x_vit_tpu_torch.cli.common import resolve_model
    from ssp_x_vit_tpu_torch.data.pipeline import DataPipeline, synthetic_dataset

    params, cfg = resolve_model("vit-b16", device=device)
    images, labels = synthetic_dataset(n, cfg.num_classes, image_size=cfg.image_size, seed=0)
    batch = next(iter(DataPipeline(images, labels, img_size=cfg.image_size, batch_size=n,
                                   device=device)))
    return params, cfg, batch


def _event_device_us(event) -> float:
    """Device time of a host-side profiler event and its children, in microseconds."""
    total = getattr(event, "device_time_total", None)
    return event.cuda_time_total if total is None else total


def profile_finetune_step(device) -> None:
    """Where one finetune step's time goes at the CLI's shape (ViT-B/16, b=32,
    bf16 compute over fp32 parameters, everything trainable): a warm-up step,
    3 steps on the host clock, then ``torch.profiler`` over one more. Device
    time by part: the fused_ffn kernels (the ``ssp::`` GEMMs, forward only),
    the FFN backward (the ``_FusedFFNBackward`` node: the plain FFN recomputed
    and differentiated), the rest of the backward (attention, projections,
    LayerNorms, embedding, head), AdamW (its ``apply``, a profiler range
    here) and the rest of the forward (attention, LayerNorms, embedding, head,
    loss). Prints "not measured" for what the trace does not show."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from ssp_x_vit_tpu_torch.pruning.finetune import make_optimizer, make_train_step

    params, cfg, batch = _vit_b16_batch(device, 32)
    optimizer = make_optimizer(params, trainable="all")
    state = optimizer.init(params)
    apply = optimizer.apply

    def ranged_apply(*args):
        with record_function("chip_smoke.adamw"):
            return apply(*args)

    optimizer.apply = ranged_apply
    step = make_train_step(cfg, optimizer)

    def run():
        step(params, state, batch["pixel_values"], batch["labels"])

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    # device rows without the range's own annotation on the device timeline
    rows = [e for e in prof.key_averages() if e.device_type == cuda and _device_us(e) > 0
            and e.key != "chip_smoke.adamw"]
    total = sum(_device_us(e) for e in rows) / 1e3
    if total <= 0:
        log(f"[PROFILE] finetune step ViT-B/16 b=32 bf16: {wall_ms:.1f} ms wall; the trace "
            f"holds no device time: split not measured")
        return
    ffn_kernel = sum(_device_us(e) for e in rows if "ssp::" in e.key) / 1e3
    adamw = ffn_bwd = backward = 0.0
    evaluate = "autograd::engine::evaluate_function"
    host_events = [e for e in prof.events() if e.device_type != cuda]
    ffn_nodes = [e for e in host_events
                 if e.name.startswith(evaluate) and "_FusedFFNBackward" in e.name]

    def in_ffn_node(e):
        # the backward nodes of the recomputed plain FFN run inside the
        # _FusedFFNBackward node, on its thread, whether or not the trace links
        # them to it as children
        return any(n is not e and n.thread == e.thread
                   and n.time_range.start <= e.time_range.start
                   and e.time_range.end <= n.time_range.end for n in ffn_nodes)

    for e in host_events:
        if e.name == "chip_smoke.adamw":
            adamw += _event_device_us(e) / 1e3
        elif e.name.startswith(evaluate):
            parent = e.cpu_parent
            while parent is not None and not parent.name.startswith(evaluate):
                parent = parent.cpu_parent
            if parent is None:  # not a child of another node (whose total holds it)
                backward += _event_device_us(e) / 1e3
                if "_FusedFFNBackward" in e.name or in_ffn_node(e):
                    ffn_bwd += _event_device_us(e) / 1e3
    ffn_nodes_ms = sum(_event_device_us(n) for n in ffn_nodes) / 1e3
    parts = {"fused_ffn kernels (forward)": ffn_kernel,
             "rest of the forward (attention, LN, embedding, head, loss)":
                 total - backward - adamw - ffn_kernel,
             "FFN backward (plain recompute + its autodiff)": ffn_bwd,
             "rest of the backward (attention, projections, LN, ...)": backward - ffn_bwd,
             "AdamW": adamw}
    if backward <= 0 or adamw <= 0:
        log(f"[PROFILE] finetune step: backward nodes or the AdamW range hold no device time "
            f"in the trace; split not measured beyond fused_ffn {ffn_kernel:.2f} ms of "
            f"{total:.2f} ms")
    log(f"[PROFILE] finetune step ViT-B/16 b=32 bf16 (trainable all): {wall_ms:.1f} ms wall "
        f"per step (host clock, no profiler), {total:.1f} ms of device activity in the trace "
        f"({100 * total / wall_ms:.0f}% of the wall time); by part: "
        + ", ".join(f"{k} {v:.2f} ms ({100 * v / total:.1f}%)" for k, v in parts.items())
        + f"; {len(ffn_nodes)} _FusedFFNBackward nodes hold {ffn_nodes_ms:.2f} ms themselves")
    for e in sorted(rows, key=_device_us, reverse=True)[:8]:
        ms = _device_us(e) / 1e3
        log(f"[PROFILE]   {ms:8.3f} ms {100 * ms / total:5.1f}%  x{e.count:<5d} {e.key[:90]}")


def _clone_tree(tree):
    return {k: _clone_tree(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


def _falling(label: str, losses) -> None:
    import math

    log(f"[ANCHOR] {label}: losses {', '.join(f'{x:.6f}' for x in losses)}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: losses not finite or not falling: {losses}")


def phase_anchor(device) -> None:
    """Trained checkpoint: dense top-1 >= pinned - 0.02, >= 0.9 after 25% 2SSP;
    int8 dense >= 0.97 (the JAX package's pin), the pruned int8 printed; the
    pruned model finetuned (everything trainable, 2 epochs over the 64
    calibration images at b=32, bf16, lr 5e-5) stays >= 0.9; 4 LoRA steps on
    the dense model (qkv and proj adapters, rank 8) and 4 KD steps (dense
    teacher, pruned student) on one calibration batch: losses finite and
    falling from the first to the last."""
    import torch

    from ssp_x_vit_tpu_torch.data.pipeline import DataPipeline, load_procgen_slice
    from ssp_x_vit_tpu_torch.evaluation.classify import evaluate_top1
    from ssp_x_vit_tpu_torch.llm.lora import init_lora
    from ssp_x_vit_tpu_torch.llm.optim import AdamW
    from ssp_x_vit_tpu_torch.models.persistence import load_pruned_model
    from ssp_x_vit_tpu_torch.models.quant import quantize_vit_params_int8
    from ssp_x_vit_tpu_torch.pruning import two_ssp_prune_vit
    from ssp_x_vit_tpu_torch.pruning.finetune import (
        VIT_LORA_TARGETS, finetune, make_distill_train_step, make_lora_train_step,
        make_optimizer,
    )

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

    dense_q = evaluate_top1(quantize_vit_params_int8(params, cfg), cfg, test)
    pruned_q = evaluate_top1(quantize_vit_params_int8(p2, c2), c2, test)
    log(f"[ANCHOR] vit_procgen int8 (weight-only): dense top-1 {dense_q:.4f} (pin >= 0.97), "
        f"after 25% 2SSP {pruned_q:.4f}")
    if dense_q < 0.97:
        raise AssertionError(f"int8 dense top-1 {dense_q} < 0.97")

    # The pruned tree shares leaves with the dense one, and finetuning updates in place.
    tuned = _clone_tree(p2)
    losses = []
    t0 = time.perf_counter()
    finetune(tuned, c2, lambda: calib, epochs=2, lr=5e-5, trainable="all", losses=losses)
    seconds = time.perf_counter() - t0
    after = evaluate_top1(tuned, c2, test)
    log(f"[ANCHOR] vit_procgen 2SSP + finetune (all, 2 epochs, 4 steps at b=32, bf16, lr 5e-5, "
        f"{seconds:.2f} s): top-1 {pruned:.4f} -> {after:.4f} (limit 0.9); losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}")
    if after < 0.9 or len(losses) != 4:
        raise AssertionError(f"top-1 after 2SSP + finetune {after} < 0.9")

    px, labels = calib[0]["pixel_values"], calib[0]["labels"]
    lora = init_lora(torch.Generator().manual_seed(0), params, rank=8, targets=VIT_LORA_TARGETS)
    opt = AdamW(1e-3)
    state, step, lora_losses = opt.init(lora), make_lora_train_step(cfg, opt), []
    for _ in range(4):
        lora, state, loss = step(params, lora, state, px, labels)
        lora_losses.append(loss.item())
    _falling("vit_procgen LoRA (qkv + proj, rank 8, AdamW 1e-3, bf16), 4 steps on one "
             "calibration batch", lora_losses)
    student = _clone_tree(p2)
    opt = make_optimizer(student, lr=1e-4, trainable="all")
    state = opt.init(student)
    step = make_distill_train_step(params, cfg, c2, opt)
    kd_losses = []
    for _ in range(4):
        student, state, loss = step(student, state, px, labels)
        kd_losses.append(loss.item())
    _falling("vit_procgen KD (dense teacher, 25% 2SSP student, alpha 0.5, T 2, lr 1e-4, bf16), "
             "4 steps on one calibration batch", kd_losses)
    if evaluate_top1(params, cfg, test) != dense:
        raise AssertionError("the KD steps changed the teacher")


def phase_finetune_host(device) -> None:
    """The finetune step on the card against the host CPU in fp32: ViT-B/16
    (random weights, the CLI's seed), b=4 synthetic images,
    ``make_train_step`` over ``make_optimizer(trainable="all")``: the first
    step's gradients within 1e-4 of max(1, max |cpu grad|), the losses of 3
    steps within 1e-4 relative."""
    import torch

    from ssp_x_vit_tpu_torch.models.vit import vit_forward
    from ssp_x_vit_tpu_torch.pruning.finetune import (
        cross_entropy_loss, make_optimizer, make_train_step,
    )

    params, cfg, batch = _vit_b16_batch(device, 4)
    px, labels = batch["pixel_values"], batch["labels"]
    host = _clone_tree({k: ({kk: vv.cpu() for kk, vv in v.items()} if isinstance(v, dict)
                            else v.cpu()) for k, v in params.items()})
    t0 = time.perf_counter()
    grads = {}
    for place, tree in (("card", params), ("host", host)):
        alias = {p: t.detach().requires_grad_(True) for p, t in _flat(tree).items()}
        nested = {}
        for path, t in alias.items():
            *parents, key = path.split("/")
            node = nested
            for p in parents:
                node = node.setdefault(p, {})
            node[key] = t
        dev = params["pos_embed"].device if place == "card" else torch.device("cpu")
        logits, _ = vit_forward(nested, px.to(dev), cfg, allow_fused_attn=False)
        cross_entropy_loss(logits, labels.to(dev)).backward()
        grads[place] = {p: t.grad.cpu() for p, t in alias.items()}
    scale = max(1.0, max(g.abs().max().item() for g in grads["host"].values()))
    gerr = max((grads["card"][p] - g).abs().max().item() for p, g in grads["host"].items()) / scale
    losses = {}
    for place, tree in (("card", params), ("host", host)):
        opt = make_optimizer(tree, lr=1e-4, trainable="all")
        state, step, losses[place] = opt.init(tree), make_train_step(cfg, opt, torch.float32), []
        for _ in range(3):
            _, state, loss = step(tree, state, px, labels)
            losses[place].append(loss.item())
    lerr = max(abs(a - b) / abs(b) for a, b in zip(losses["card"], losses["host"]))
    log(f"[ANCHOR] ViT-B/16 finetune step fp32 b=4, card vs host CPU: first-step gradients of "
        f"{len(grads['host'])} leaves scaled {gerr:.3e} (tol 1e-4); losses card "
        f"{losses['card']} host {losses['host']} (max rel {lerr:.3e}, tol 1e-4; "
        f"{time.perf_counter() - t0:.1f} s)")
    if gerr > 1e-4 or lerr > 1e-4:
        raise AssertionError("the finetune step on the card disagrees with the host")


def phase_anchor_lora_llm(device) -> None:
    """LLM LoRA on ``ckpts/code_llm_small`` in fp32 with remat, card against the
    host CPU from the same adapters (b nonzero, so both factors get
    gradients) and batches (b=4, s=512 of ``corpus_slice/train.bin``): the
    first step's adapter gradients within 1e-4 of max(1, max |cpu grad|), the
    losses of 3 steps within 1e-4 relative."""
    import numpy as np
    import torch

    from ssp_x_vit_tpu_torch.llm.checkpoints import load_llm_model
    from ssp_x_vit_tpu_torch.llm.lora import apply_lora, init_lora, make_lora_train_step
    from ssp_x_vit_tpu_torch.llm.optim import AdamW
    from ssp_x_vit_tpu_torch.llm.train import next_token_loss

    here = os.path.dirname(os.path.abspath(__file__))
    ckpt = os.path.join(here, "ckpts", "code_llm_small")
    params, cfg = load_llm_model(ckpt, device=device, dtype=torch.float32)
    s = 512
    ids = np.asarray(np.memmap(os.path.join(ckpt, "corpus_slice", "train.bin"), np.uint16, "r")
                     [:12 * (s + 1)], np.int32).reshape(12, s + 1)
    batches = [torch.from_numpy(ids[4 * i:4 * i + 4]).long() for i in range(3)]
    gen = torch.Generator().manual_seed(5)
    lora = init_lora(gen, params, rank=8)
    for ab in lora.values():
        ab["b"] = (0.01 * torch.randn(ab["b"].shape, generator=gen)).to(device)
    t0 = time.perf_counter()
    grads, losses = {}, {}
    for place, dev in (("card", device), ("host", torch.device("cpu"))):
        base = {k: ({kk: vv.to(dev, copy=True) for kk, vv in v.items()} if isinstance(v, dict)
                    else v.to(dev, copy=True)) for k, v in params.items()}
        ad = {t: {k: v.to(dev, copy=True).requires_grad_(True) for k, v in ab.items()}
              for t, ab in lora.items()}
        next_token_loss(apply_lora(base, ad), batches[0].to(dev), cfg,
                        compute_dtype=torch.float32, remat=True).backward()
        grads[place] = {f"{t}/{k}": v.grad.cpu() for t, ab in ad.items() for k, v in ab.items()}
        ad = {t: {k: v.detach() for k, v in ab.items()} for t, ab in ad.items()}
        opt = AdamW(1e-4)
        state, step, losses[place] = opt.init(ad), make_lora_train_step(
            cfg, opt, compute_dtype=torch.float32, remat=True), []
        for tokens in batches:
            ad, state, loss = step(base, ad, state, tokens)
            losses[place].append(loss.item())
    scale = max(1.0, max(g.abs().max().item() for g in grads["host"].values()))
    gerr = max((grads["card"][p] - g).abs().max().item() for p, g in grads["host"].items()) / scale
    lerr = max(abs(a - b) / abs(b) for a, b in zip(losses["card"], losses["host"]))
    log(f"[ANCHOR] code_llm_small LoRA fp32 remat (q/k/v/o, rank 8) b=4 s={s}, card vs host "
        f"CPU: first-step adapter gradients scaled {gerr:.3e} (tol 1e-4); losses card "
        f"{losses['card']} host {losses['host']} (max rel {lerr:.3e}, tol 1e-4; "
        f"{time.perf_counter() - t0:.1f} s)")
    if gerr > 1e-4 or lerr > 1e-4:
        raise AssertionError("LLM LoRA on the card disagrees with the host")


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
        n_fused = launch_counts["paged_attention_write"]
        n_apart = launch_counts["paged_attention"] + launch_counts["paged_pool_write"]
        log(f"[SERVE] Llama-2-7B width, 2 layers, prompts of 70 and 33 tokens, prefill + {steps} "
            f"decode steps: card kernels {dtype} vs host CPU plain fp32 ({host_s:.1f} s), worst "
            f"scaled logit error over {len(got)} logit rows {worst:.3e} tol={tol}; launches "
            f"paged_attention_write {n_fused}, paged_attention + paged_pool_write {n_apart}, "
            f"flash_attention {launch_counts['flash_attention']}")
        if worst > tol:
            raise AssertionError("the paged path on the card disagrees with the CPU plain path")
        if n_fused != 2 * steps or n_apart or launch_counts["flash_attention"] != 4:
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


def _alone_gaps(params, cfg, prompt, tokens, cache_dtype, device, routing=None,
                chunked=None) -> tuple:
    """The request run alone through the paged path (its prefill whole, or in
    chunks of ``chunked`` as a chunked server made it; then one-sequence
    decode steps) and fed the served tokens: at every step, how far the served
    token's logit lies below the alone run's best logit. ``routing``: a
    ``_ServedRouting`` of the served run, whose experts each MoE layer is
    routed to. Returns (steps where the served token is the alone argmax,
    worst gap, largest |logit|, MoE calls whose own choice differed from the
    served one). All gaps 0 means ``paged_generate`` on this prompt alone
    emits these tokens."""
    import torch

    from ssp_x_vit_tpu_torch.llm.paged import (
        init_paged_pools, paged_decode_step, paged_prefill, paged_prefill_chunked,
    )

    n = len(prompt)
    pages = -(-(n + len(tokens) + 1) // PAGE)
    kp, vp = init_paged_pools(cfg, 1 + pages, PAGE, cache_dtype, device)
    table = torch.arange(1, 1 + pages, dtype=torch.int32, device=device)
    toks = torch.as_tensor(tokens, dtype=torch.int64, device=device)
    with _Routing() as pinned:
        if routing is not None:
            key = tuple(prompt)
            steps = (len(tokens) - 1) * cfg.num_layers
            pinned.pins = list(routing.prefill[key]) + list(routing.decode.get(key, [])[:steps])
        if chunked:
            logits = paged_prefill_chunked(params, prompt, kp, vp, cfg, table,
                                           chunk_size=chunked)[0]
        else:
            logits = paged_prefill(params, torch.as_tensor([prompt], dtype=torch.int64,
                                                           device=device), kp, vp, cfg, table, n)[0]
        gaps, peaks = [], []
        for t in range(len(tokens)):
            gaps.append(logits.max() - logits[toks[t]])
            peaks.append(logits.abs().max())
            if t + 1 < len(tokens):
                lens = torch.full((1,), n + t, dtype=torch.int32, device=device)
                logits = paged_decode_step(params, toks[t:t + 1], kp, vp, cfg, table[None],
                                           lens)[0][0]
        if pinned.pins:
            raise AssertionError(f"{len(pinned.pins)} recorded routings were not used")
    gaps = torch.stack(gaps)
    return (int((gaps == 0).sum()), float(gaps.max()), float(torch.stack(peaks).max()),
            pinned.moved)


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
        same, gap, peak, _ = _alone_gaps(params, cfg, req["prompt"], r["tokens"], cache_dtype,
                                         device)
        exact, total = exact + same, total + len(r["tokens"])
        worst_rel = max(worst_rel, gap / max(1.0, peak))
    log(f"[SERVE] {label}: greedy tokens against each prompt run alone: {exact} of {total} are the "
        f"alone run's argmax; worst logit gap {worst_rel:.3e} of max(1, max |logit|), tol 5e-2")
    if worst_rel > 5e-2:
        raise AssertionError(f"{label}: a served greedy token is not the alone run's best token")


def _expect_decode_launches(label, run, cfg, names) -> None:
    """Each named kernel launched once per layer and batched decode step of the
    run, and the other paged kernels (the standalone write and attention, the
    other pool kind) not at all: the decode phase went through them and
    through nothing else."""
    want = run["decode_steps"] * cfg.num_layers
    paged = ("paged_attention", "paged_pool_write", "paged_attention_q8", "paged_pool_write_q8",
             "paged_attention_write", "paged_attention_write_q8")
    for name in paged:
        expect = want if name in names else 0
        if run["launches"][name] != expect or want <= 0:
            raise AssertionError(f"{label}: {name} launched {run['launches'][name]} times over "
                                 f"{run['decode_steps']} decode steps of {cfg.num_layers} layers, "
                                 f"expected {expect}")


def measure_decode(params, cfg, device) -> dict:
    """Eight live slots with 512-token prompts on a ``PagedServer`` of the
    served geometry: ms per decode step over blocks of 8 (host clock around
    each synchronized block), launches per step, and a ``torch.profiler`` split
    of one block. Returns those numbers."""
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
    blocks = []
    for _ in range(4):
        t0 = time.perf_counter()
        server.step_many(8)
        torch.cuda.synchronize()
        blocks.append((time.perf_counter() - t0) * 1e3 / 8)
    step_ms = sum(blocks) / len(blocks)
    ours = {k: v / (len(blocks) * 8) for k, v in launch_counts.items() if v}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        server.step_many(8)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and _device_us(e) > 0]
    total_ms = sum(_device_us(e) for e in kernels) / 1e3 / 8
    n_launch = sum(e.count for e in kernels) / 8
    weights_ms = sum(v.numel() * v.element_size() for v in params["blocks"].values()) / PEAK_BYTES * 1e3
    log(f"[SERVE] decode at 8 live slots (~520 cached tokens each), bf16 pools: {step_ms:.2f} ms "
        f"per step over {len(blocks)} blocks of 8 (host clock, no profiler; blocks "
        f"{', '.join(f'{x:.2f}' for x in blocks)}) = {8e3 / step_ms:.0f} tokens/s; hand-written "
        f"kernel launches per step {json.dumps(ours)}; reading the block weights once takes "
        f"{weights_ms:.2f} ms at the data-sheet rate")
    top = [(e.key[:90], _device_us(e) / 1e3 / 8, e.count // 8)
           for e in sorted(kernels, key=_device_us, reverse=True)[:8]]
    out = dict(step_ms=step_ms, block_step_ms=blocks, launches_per_step=ours,
               device_kernels_per_step=n_launch, device_ms_per_step=total_ms, top=top)
    if total_ms <= 0:
        log("[PROFILE] decode block: the trace holds no device time: not measured")
        return out
    log(f"[PROFILE] decode block of 8 steps: {n_launch:.0f} device kernels and {total_ms:.2f} ms "
        f"of device activity per step ({100 * total_ms / step_ms:.0f}% of the step's wall time; "
        f"the rest is the host dispatching)")
    for key, ms, count in top:
        log(f"[PROFILE]   {ms:8.3f} ms {100 * ms / total_ms:5.1f}%  x{count:<4d} {key}")
    return out


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
    _expect_decode_launches("run 1", run1, cfg, ("paged_attention_write",))
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
    _expect_decode_launches("run 2", run2, cfg, ("paged_attention_write_q8",))
    _check_greedy_alone(params, cfg, device, requests2, run2["responses"], torch.int8, "run 2")
    measure_decode(params, cfg, device)
    return {"paged_attention_write": run1["launches"]["paged_attention_write"],
            "paged_attention_write_q8": run2["launches"]["paged_attention_write_q8"]}


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


def _profile_decode(params, cfg, device, cache_dtype, prompts, lora_ids=None) -> dict:
    """The contiguous path split in its parts at b=8: prefill seconds, ms per
    decode step over 16 steps (host clock around synchronized work), and a
    ``torch.profiler`` split of 4 more steps. A step is ``decode_scan``'s loop
    body (``serve._decode_body``). ``lora_ids``: each row's adapter of the
    attached bank, checked and its slices gathered once, as ``generate_kv_scan``
    does."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ssp_x_vit_tpu_torch.llm import serve

    tokens, pad_lens, _, p_pad = serve._prepare_prompts(prompts, GEN_MAX_LENGTH)
    b = tokens.shape[0]
    ck, cv = serve.init_cache(cfg, b, GEN_MAX_LENGTH + 1, cache_dtype, device)
    ids = serve._lora_ids(params, lora_ids, b, device)
    layers = serve._gathered_layers(serve.split_layers(params, cfg), ids,
                                    serve.cache_compute_dtype(ck))
    pads = torch.as_tensor(pad_lens.astype(np.int64), device=device)
    toks = torch.as_tensor(tokens.astype(np.int64), device=device)
    kw = dict(layers=layers, lora_ids=ids)
    step = torch.no_grad()(serve._decode_body)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, ck, cv = serve.prefill(params, toks, ck, cv, cfg, pads, **kw)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    tok, pos = logits.argmax(-1), p_pad
    for _ in range(2):  # warm-up
        logits, ck, cv = step(params, tok, ck, cv, cfg, pos, pads, **kw)
        tok, pos = logits.argmax(-1), pos + 1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(16):
        logits, ck, cv = step(params, tok, ck, cv, cfg, pos, pads, **kw)
        tok, pos = logits.argmax(-1), pos + 1
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / 16
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            logits, ck, cv = step(params, tok, ck, cv, cfg, pos, pads, **kw)
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
    steps; then multi-LoRA on the int8 tree (``phase_lora``). Returns the
    launches of the two int8 runs and the multi-LoRA run."""
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
    for name, n in phase_lora(device, params, q8, cfg).items():
        launches[name] = launches.get(name, 0) + n
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


def train_cli_run(model_cfg: dict, what: str, tag: str, data=None,
                  updates: int = TRAIN_UPDATES) -> tuple:
    """The training CLI (``cli.train_llm``) on a fresh bf16 model of the
    ``LlamaConfig`` fields ``model_cfg`` (``--init-json``): b=1, s=2048, remat
    on, the synthetic stream (``data``: ``--data`` that corpus directory
    instead), ``updates`` updates, the counts set to 0 just before it. Losses (an MoE model's load-balance term included) finite
    at every update; flash forward launches = layers x updates x 2 (forward
    and remat recompute), each backward kernel = layers x updates. Returns
    (the run's result, its launches)."""
    import math

    import torch

    from ssp_x_vit_tpu_torch.cli import train_llm
    from ssp_x_vit_tpu_torch.ops.kernels import KERNEL_NAMES, launch_counts, reset_launch_counts

    source = ["--data", data] if data else ["--synthetic-data"]
    argv = ["--init-json", json.dumps(model_cfg), "--steps", str(updates),
            "--batch-size", "1", "--seq-len", "2048", *source, "--log-every", "1",
            "--backend", "cuda"]
    log(f"[{tag}] train_llm {' '.join(argv)}")
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
    n_params = sum(v.numel() for v in _flat(out["params"]).values())
    log(f"[{tag}] train_llm {what} ({n_params / 1e9:.3f} B bf16 parameters, bf16 AdamW "
        f"moments): {seconds:.1f} s for the CLI run, {out['seconds']:.1f} s in fit; losses "
        f"{[h['loss'] for h in hist]}; s/update {', '.join(f'{t:.3f}' for t in per_update)}; "
        f"{hist[-1]['tok_per_s']} tokens/s over the run ({2048 / per_update[-1]:.0f} at the last "
        f"update); peak {peak:.1f} GiB")
    log(f"[{tag}] train_llm launches {json.dumps({k: n for k, n in counts.items() if n})}")
    if len(hist) != updates or not all(math.isfinite(h["loss"]) for h in hist):
        raise AssertionError(f"train_llm {what}: losses {[h['loss'] for h in hist]}")
    layers = model_cfg["num_layers"]
    want = {"flash_attention": layers * updates * 2,
            "flash_attention_bwd_dq": layers * updates,
            "flash_attention_bwd_dkv": layers * updates}
    if any(counts[k] != n for k, n in want.items()):
        raise AssertionError(f"train_llm {what} launches {counts} != {want}")
    return out, counts


def phase_main_train(device) -> dict:
    """``train_cli_run`` at Llama-2-7B width and depth, then a profiler split
    of one update. Returns the run's launches."""
    out, counts = train_cli_run(LLAMA_2_7B, "Llama-2-7B width", "MAIN")
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


# ------------------------------------------------- HF directories and text ---

def _rss_bytes() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def _peak_rss_during(fn):
    """(fn(), RSS before, peak RSS while fn ran), sampling /proc/self/statm every 2 ms."""
    import threading

    before, peak, done = _rss_bytes(), [0], threading.Event()

    def sample():
        while not done.is_set():
            peak[0] = max(peak[0], _rss_bytes())
            time.sleep(0.002)

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    try:
        out = fn()
    finally:
        done.set()
        sampler.join()
    return out, before, max(peak[0], _rss_bytes())


def _same_tree(a: dict, b: dict, label: str) -> None:
    """The same leaves, bit for bit (dtype, shape and bytes)."""
    import torch

    fa, fb = _flat(a), _flat(b)
    if sorted(fa) != sorted(fb):
        raise AssertionError(f"{label}: leaves differ: {sorted(set(fa) ^ set(fb))}")
    for k, v in fa.items():
        w = fb[k]
        if v.dtype != w.dtype or v.shape != w.shape or not torch.equal(
                v.reshape(-1).view(torch.uint8), w.reshape(-1).view(torch.uint8)):
            raise AssertionError(f"{label}: leaf {k} differs")


def phase_hf_llama_7b(device) -> dict:
    """Llama-2-7B widths, depth cut to 2 layers (32 layers in F32 would be a
    27 GB file), random bf16 weights made on the card: export_hf_llama (F32),
    load_hf_llama back in bf16 (the parameters bit for bit: bf16 -> F32 -> bf16
    is exact; export and load seconds, GB/s, peak host RSS during the load),
    and one s=2048 forward of each with the same logits and a flash launch
    per layer. Returns the forwards' launches."""
    import dataclasses

    import torch

    from ssp_x_vit_tpu_torch.llm.checkpoints import export_hf_llama, load_hf_llama
    from ssp_x_vit_tpu_torch.llm.model import LlamaConfig, init_llama_params, llama_forward
    from ssp_x_vit_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    cfg = LlamaConfig(**dict(LLAMA_2_7B, num_layers=2))
    gen = torch.Generator(device=device)
    gen.manual_seed(2)
    params = init_llama_params(gen, cfg, dtype=torch.bfloat16, device=device)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        export_hf_llama(d, params, cfg)
        export_s = time.perf_counter() - t0
        size = os.path.getsize(os.path.join(d, "model.safetensors"))

        def load():
            out = load_hf_llama(d, device=device, dtype=torch.bfloat16)
            torch.cuda.synchronize()
            return out

        t0 = time.perf_counter()
        (loaded, lcfg), rss0, rss_peak = _peak_rss_during(load)
        load_s = time.perf_counter() - t0
    log(f"[HF] Llama-2-7B width, 2 layers: export_hf_llama {size / 1e9:.3f} GB F32 in "
        f"{export_s:.2f} s ({size / 1e9 / export_s:.2f} GB/s); load_hf_llama to bf16 on the card "
        f"in {load_s:.2f} s ({size / 1e9 / load_s:.2f} GB/s); host RSS {rss0 / 2 ** 30:.2f} GiB "
        f"before, peak {rss_peak / 2 ** 30:.2f} GiB during the load (+{(rss_peak - rss0) / 2 ** 20:.0f}"
        f" MiB; largest tensor {32000 * 4096 * 4 / 2 ** 20:.0f} MiB in F32)")
    if dataclasses.asdict(lcfg) != dataclasses.asdict(cfg):
        raise AssertionError(f"HF round trip changed the config: {lcfg} vs {cfg}")
    _same_tree(params, loaded, "Llama-2-7B width HF round trip")
    tokens = torch.randint(0, cfg.vocab_size, (1, 2048), generator=torch.Generator().manual_seed(3))
    tokens = tokens.to(device)
    reset_launch_counts()
    with torch.no_grad():
        a, _ = llama_forward(params, tokens, cfg, compute_dtype=torch.bfloat16)
        first = launch_counts["flash_attention"]
        b, _ = llama_forward(loaded, tokens, lcfg, compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    launches = dict(launch_counts)
    if first != cfg.num_layers or launches["flash_attention"] != 2 * cfg.num_layers:
        raise AssertionError(f"flash_attention launched {first} / {launches['flash_attention']} "
                             f"times over two forwards of {cfg.num_layers} layers")
    if not torch.equal(a, b) or not torch.isfinite(a).all():
        raise AssertionError("the HF-loaded model's logits differ from the source model's")
    log(f"[HF] Llama-2-7B width, 2 layers: s=2048 logits of the loaded model == the source "
        f"model's, bit for bit; flash_attention once per layer and forward")
    del params, loaded, a, b
    torch.cuda.empty_cache()
    return launches


def phase_hf_vit(out_root: str, device) -> dict:
    """ViT-B/16 (the CLI's random weights) exported with export_hf_vit, then
    the 2SSP CLI on that directory (``--save-pruned-model --save-format hf``:
    attention removed, so the native format with the JAX CLI's notice): the
    loaded parameters, the fp32 logits and their top-1 bit for bit the source
    model's, and the CLI's baseline top-1 the source's. Returns the CLI's launches."""
    import torch

    from ssp_x_vit_tpu_torch.cli import auto_2ssp
    from ssp_x_vit_tpu_torch.cli.common import resolve_dataset, resolve_model
    from ssp_x_vit_tpu_torch.evaluation import evaluate_top1
    from ssp_x_vit_tpu_torch.models.checkpoints import export_hf_vit
    from ssp_x_vit_tpu_torch.models.vit import vit_forward
    from ssp_x_vit_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    params, cfg = resolve_model("vit-b16", device=device)
    hf_dir = os.path.join(out_root, "vit-b16-hf")
    t0 = time.perf_counter()
    export_hf_vit(hf_dir, params, cfg)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded, lcfg = resolve_model(hf_dir, device=device)      # what the CLI loads
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    size = os.path.getsize(os.path.join(hf_dir, "model.safetensors"))
    log(f"[HF] ViT-B/16: export_hf_vit {size / 1e6:.1f} MB in {export_s:.2f} s, "
        f"resolve_model(<HF dir>) in {load_s:.2f} s")
    _same_tree(params, loaded, "ViT-B/16 HF round trip")
    _, test, _ = resolve_dataset("synthetic", cfg, device=device)
    batches = test.batches(2)
    with torch.inference_mode():
        for batch in batches:
            a, _ = vit_forward(params, batch["pixel_values"], cfg, compute_dtype=torch.float32)
            b, _ = vit_forward(loaded, batch["pixel_values"], lcfg, compute_dtype=torch.float32)
            if not torch.equal(a, b) or not torch.equal(a.argmax(-1), b.argmax(-1)):
                raise AssertionError("ViT-B/16: the HF-loaded fp32 logits differ")
    acc = evaluate_top1(params, cfg, batches)
    argv = ["--model", hf_dir, "--dataset", "synthetic", "--target", "0.25", "--stage", "both",
            "--eval-batches", "2", "--min-remaining", "512", "--backend", "cuda", "--out-root",
            os.path.join(out_root, "vit-b16-hf-run"), "--save-pruned-model", "--save-format", "hf"]
    log(f"[HF] auto_2ssp {' '.join(argv)}")
    reset_launch_counts()
    t0 = time.perf_counter()
    report = auto_2ssp.run(auto_2ssp.build_argparser().parse_args(argv))
    seconds = time.perf_counter() - t0
    launches = dict(launch_counts)
    m = report["metrics"]
    saved = report["artifacts"]["pruned_model_dir"]
    log(f"[HF] ViT-B/16 from its HF directory: fp32 logits == the source's on 2 batches, top-1 "
        f"{m['acc_baseline']} (source {acc:.4f}) -> {m['acc_stage2']} after 25% 2SSP; "
        f"{seconds:.1f} s; pruned model saved as "
        f"{'HF' if os.path.exists(os.path.join(saved, 'model.safetensors')) else 'native'} "
        f"(attention removed: {report['artifacts']['pruned_block_indices']})")
    if m["acc_baseline"] != round(acc, 4):
        raise AssertionError(f"CLI baseline top-1 {m['acc_baseline']} vs source {acc}")
    if report["artifacts"]["pruned_block_indices"] and not os.path.exists(
            os.path.join(saved, "model.npz")):
        raise AssertionError("attention removed, yet no native model was saved")
    return launches


def phase_anchor_tokenizer():
    """The native BPE engine built from native/bpe.cc; all of val.bin decoded
    and encoded again on it == the committed ids without the 39
    <|endoftext|>; the encode's seconds and tokens/s on this host's CPU."""
    import numpy as np

    from ssp_x_vit_tpu_torch.llm import tokenizer as ttok

    here = os.path.dirname(os.path.abspath(__file__))
    ckpt = os.path.join(here, "ckpts", "code_llm_small")
    t0 = time.perf_counter()
    ttok.native_library()
    build_s = time.perf_counter() - t0
    tok = ttok.load_tokenizer(ckpt)
    ids = np.fromfile(os.path.join(ckpt, "corpus_slice", "val.bin"), np.uint16).tolist()
    text = tok.decode(ids)
    t0 = time.perf_counter()
    got = tok.encode(text)
    enc_s = time.perf_counter() - t0
    plain = ttok.load_tokenizer(ckpt, engine="python")
    t0 = time.perf_counter()
    plain_got = plain.encode(text)
    plain_s = time.perf_counter() - t0
    want = [i for i in ids if i != 8191]
    if tok.engine != "native" or tok.native_batches < 1:
        raise AssertionError("the native BPE engine was not the one in use")
    if got != want or len(got) != 131_033 or plain_got != got:
        raise AssertionError("val.bin decoded and encoded again differs from the committed ids")
    log(f"[TOK] native BPE engine built in {build_s:.2f} s; val.bin ({len(ids)} ids, "
        f"{len(text.encode())} bytes of text) decoded and encoded again == the committed ids "
        f"without the {len(ids) - len(want)} <|endoftext|>; encode (first, cold word cache) "
        f"{enc_s:.3f} s = {len(got) / enc_s:.0f} tokens/s on this host's CPU "
        f"(plain Python merge loop {plain_s:.3f} s = {len(got) / plain_s:.0f} tokens/s)")


def phase_anchor_hf_llm(device, work: str):
    """ckpts/code_llm_small exported to HF (with its tokenizer.json), then
    ``main_llm.run --model <dir> --evaluate_perplexity --evaluate_qualitative
    --save-format hf`` on the card: perplexity within 1e-5 relative of the
    same run on the .npz directory; the qualitative answers as text; the saved
    HF directory loads back bit for bit; the HF-loaded model's val perplexity
    within 1e-5 of the .npz model's and 5% of the pinned value. Returns (HF
    directory, launches of the CLI runs)."""
    import math
    import shutil

    import numpy as np
    import torch

    from ssp_x_vit_tpu_torch.cli import main_llm
    from ssp_x_vit_tpu_torch.llm.checkpoints import export_hf_llama, load_hf_llama, load_llm_model
    from ssp_x_vit_tpu_torch.llm.evaluation import evaluate_perplexity
    from ssp_x_vit_tpu_torch.ops.kernels import KERNEL_NAMES, launch_counts, reset_launch_counts

    here = os.path.dirname(os.path.abspath(__file__))
    ckpt = os.path.join(here, "ckpts", "code_llm_small")
    params, cfg = load_llm_model(ckpt, device=device, dtype=torch.float32)
    hf_dir, saved = os.path.join(work, "code_llm_small_hf"), os.path.join(work, "saved_hf")
    export_hf_llama(hf_dir, params, cfg)
    shutil.copy(os.path.join(ckpt, "tokenizer.json"), hf_dir)
    flags = ["--synthetic-data", "--seq-len", "1024", "--num-calibration", "8", "--backend",
             "cuda", "--dense", "--evaluate_perplexity", "--logging", "WARNING"]
    totals = {name: 0 for name in KERNEL_NAMES}
    outs = []
    for argv in (["--model", ckpt, *flags],
                 ["--model", hf_dir, *flags, "--evaluate_qualitative", "--save-format", "hf",
                  "--save-model", saved]):
        log(f"[ANCHOR] main_llm {' '.join(argv)}")
        reset_launch_counts()
        t0 = time.perf_counter()
        outs.append(main_llm.run(main_llm.build_argparser().parse_args(argv)))
        log(f"[ANCHOR] main_llm: {time.perf_counter() - t0:.1f} s, seconds by phase "
            f"{json.dumps({k: round(v, 3) for k, v in outs[-1]['phase_seconds'].items()})}")
        for name in KERNEL_NAMES:
            totals[name] += launch_counts[name]
    ppl_npz, ppl_hf = outs[0]["dense"]["ppl"], outs[1]["dense"]["ppl"]
    qual = outs[1]["dense"]["qualitative"]
    for prompt, answer in qual or ():
        log(f"[ANCHOR] qualitative: {prompt!r} -> {answer[:160]!r}")
    if not qual or len(qual) != 2 or not all(isinstance(a, str) and a.startswith(p)
                                             for p, a in qual):
        raise AssertionError(f"qualitative results are not text: {qual!r}")
    if outs[1]["kernel_launches"]["evaluation"]["flash_attention"] <= 0:
        raise AssertionError("flash_attention not launched in the HF directory's evaluation")
    _same_tree(load_hf_llama(hf_dir, device=device)[0], load_hf_llama(saved, device=device)[0],
               "code_llm_small --save-format hf")
    hf32, _ = load_hf_llama(hf_dir, device=device, dtype=torch.float32)
    _same_tree(params, hf32, "code_llm_small HF export")
    with open(os.path.join(ckpt, "train_meta.json")) as f:
        pinned = json.load(f)["val_ppl_16k"]
    val = np.asarray(np.memmap(os.path.join(ckpt, "corpus_slice", "val.bin"), np.uint16, "r")[:16384],
                     np.int32)
    val_npz = evaluate_perplexity(params, cfg, val, seq_len=1024, batch_size=2)
    val_hf = evaluate_perplexity(hf32, cfg, val, seq_len=1024, batch_size=2)
    log(f"[ANCHOR] code_llm_small through its HF directory: main_llm ppl (synthetic stream, bf16 "
        f"load) {ppl_hf:.6f} vs the .npz directory's {ppl_npz:.6f}; val ppl (fp32, 16384 tokens) "
        f"{val_hf:.4f} vs .npz {val_npz:.4f}, pinned {pinned}; --save-format hf loads back bit "
        f"for bit")
    if not math.isfinite(ppl_hf) or abs(ppl_hf - ppl_npz) > 1e-5 * ppl_npz:
        raise AssertionError(f"HF directory ppl {ppl_hf} vs .npz {ppl_npz}")
    if abs(val_hf - val_npz) > 1e-5 * val_npz or abs(val_hf - pinned) > 0.05 * pinned:
        raise AssertionError(f"HF val ppl {val_hf} vs .npz {val_npz}, pinned {pinned}")
    return hf_dir, totals


def _post_text(port: int, path: str, body: dict) -> dict:
    """POST a text request; returns text, finish reason, token ids (completions,
    not streamed), and seconds to the first streamed chunk and to the end."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    t0 = time.perf_counter()
    conn.request("POST", path, json.dumps(body), {"Content-Type": "application/json"})
    resp = conn.getresponse()
    if resp.status != 200:
        raise AssertionError(f"HTTP {resp.status}: {resp.read()[:300]!r}")
    text, finish, tokens, first = "", None, None, None
    if body.get("stream"):
        tokens = []
        while True:
            line = resp.readline()
            if not line:
                break
            line = line.strip()
            if not line.startswith(b"data: ") or line == b"data: [DONE]":
                continue
            choice = json.loads(line[len(b"data: "):])["choices"][0]
            if first is None and choice["finish_reason"] is None:
                first = time.perf_counter() - t0
            text += choice["delta"].get("content", "") if "delta" in choice else choice["text"]
            tokens += choice.get("token_ids", [])
            finish = choice["finish_reason"] or finish
    else:
        choice = json.loads(resp.read())["choices"][0]
        text = choice["message"]["content"] if "message" in choice else choice["text"]
        finish, tokens = choice["finish_reason"], choice.get("token_ids")
    conn.close()
    return dict(text=text, finish=finish, tokens=tokens, first_s=first,
                total_s=time.perf_counter() - t0)


def _host_agrees(label, text, prompt_ids, ref, tok, host, cfg) -> None:
    """The served text against the host CPU's greedy tokens ``ref``: equal, or
    diverging first at a token where the host's own top-2 margin is below 1e-3."""
    import torch

    from ssp_x_vit_tpu_torch.llm.model import llama_forward

    if text == tok.decode(ref):
        return
    at = next((k for k in range(len(ref)) if not text.startswith(tok.decode(ref[:k + 1]))),
              len(ref))
    with torch.no_grad():
        logits, _ = llama_forward(host, torch.tensor([prompt_ids + ref[:at]]), cfg,
                                  compute_dtype=torch.float32)
    top2 = logits[0, -1].topk(2).values
    margin = float(top2[0] - top2[1])
    log(f"[ANCHOR] {label}: the served text leaves the host's at token {at}, where the host's "
        f"top-2 margin is {margin:.2e}")
    if margin > 1e-3:
        raise AssertionError(f"{label}: served text differs from the host CPU's")


def phase_anchor_text_serving(device, hf_dir: str) -> dict:
    """``serve_http`` on the exported code_llm_small directory (its
    tokenizer.json read by the CLI), fp32 weights and fp32 pools: a string
    prompt not streamed and streamed, a chat, a stop string that starts
    inside a token, and the same prompt as token ids (time to first token,
    text against ids). The served greedy text equals the host CPU's
    (``paged_generate`` on CPU copies, decoded), streamed equals not
    streamed, and paged_attention_write makes one launch per layer and decode
    step. Returns the run's launches."""
    import threading

    import torch

    from ssp_x_vit_tpu_torch.cli import serve_http
    from ssp_x_vit_tpu_torch.llm.checkpoints import load_hf_llama
    from ssp_x_vit_tpu_torch.llm.paged import paged_generate
    from ssp_x_vit_tpu_torch.llm.server_http import _render_chat, create_server
    from ssp_x_vit_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    params, cfg = load_hf_llama(hf_dir, device=device, dtype=torch.float32)
    host = _tree_to(params, "cpu", torch.float32)
    argv = ["--model", hf_dir, "--backend", "cuda", "--port", "0", "--kv-dtype", "fp32",
            "--page-size", "16", "--num-pages", "128", "--max-context", "512", "--max-batch", "4"]
    log(f"[SERVE] text: serve_http {' '.join(argv)}")
    args = serve_http.build_argparser().parse_args(argv)
    engine, eos = serve_http.build_engine(args, model=(params, cfg))
    kwargs = serve_http.server_kwargs(args, eos)
    tok = kwargs["tokenizer"]
    if tok is None or tok.engine != "native":
        raise AssertionError("serve_http did not load the directory's tokenizer.json")
    srv = create_server(engine, **kwargs)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    port = srv.server_address[1]
    new = 32
    prompt = "def fibonacci(n):\n    "
    messages = [{"role": "user", "content": "Write a function that reverses a list."}]
    try:
        reset_launch_counts()
        steps0 = engine.decode_steps
        once = _post_text(port, "/v1/completions", dict(prompt=prompt, max_tokens=new,
                                                        temperature=0))
        streamed = _post_text(port, "/v1/completions", dict(prompt=prompt, max_tokens=new,
                                                            temperature=0, stream=True))
        as_ids = _post_text(port, "/v1/completions", dict(prompt=tok.encode(prompt),
                                                          max_tokens=new, temperature=0,
                                                          stream=True))
        chat = _post_text(port, "/v1/chat/completions", dict(messages=messages, max_tokens=new,
                                                             temperature=0))
        text = once["text"]
        pieces = [tok.decode([i]) for i in once["tokens"]]
        at = next(k for k, p in enumerate(pieces) if k > 0 and len(p) >= 2 and "�" not in p)
        start = len("".join(pieces[:at])) + 1
        stop = text[start:start + 3]
        stopped = _post_text(port, "/v1/completions", dict(prompt=prompt, max_tokens=new,
                                                           temperature=0, stop=[stop]))
        torch.cuda.synchronize()
        run = dict(launches=dict(launch_counts), decode_steps=engine.decode_steps - steps0)
    finally:
        srv.shutdown()
        srv.server_close()
        engine.shutdown()
        thread.join(timeout=30)
    prompt_ids = tok.encode(prompt)
    chat_ids = tok.encode(_render_chat(messages))
    kw = dict(max_new_tokens=new, page_size=16, cache_dtype=torch.float32)
    ref = paged_generate(host, cfg, [prompt_ids], **kw)[0].tolist()[len(prompt_ids):]
    ref_chat = paged_generate(host, cfg, [chat_ids], **kw)[0].tolist()[len(chat_ids):]
    _host_agrees("text prompt", text, prompt_ids, ref, tok, host, cfg)
    _host_agrees("chat", chat["text"], chat_ids, ref_chat, tok, host, cfg)
    if streamed["text"] != text or as_ids["tokens"] != once["tokens"] or tok.decode(
            once["tokens"]) != text:
        raise AssertionError("streamed / token-id / not streamed answers differ")
    if stopped["text"] != text[:text.find(stop)] or stopped["finish"] != "stop":
        raise AssertionError(f"stop {stop!r}: {stopped['text']!r} vs {text[:text.find(stop)]!r}")
    _expect_decode_launches("text serving", run, cfg, ("paged_attention_write",))
    log(f"[SERVE] text (code_llm_small HF directory, fp32 pools): served text == host CPU text "
        f"for the string prompt and the chat; streamed == not streamed == token-id prompt; stop "
        f"{stop!r} (from inside a token) cuts at char {text.find(stop)} with finish 'stop'; "
        f"{run['decode_steps']} decode steps, paged_attention_write "
        f"{run['launches']['paged_attention_write']} launches")
    log(f"[SERVE] text: time to first token (client clock, one request at a time) text prompt "
        f"{streamed['first_s'] * 1e3:.2f} ms, the same prompt as token ids "
        f"{as_ids['first_s'] * 1e3:.2f} ms; answer {text[:120]!r}")
    return run["launches"]


# ------------------------------------------------------------------ A.7c ---
# The ViT mask-ensembling and SRP stack: SRP checkpoints in the AugReg layout
# and CIFAR-100 in its on-disk format (both synthesized from seeds: neither is
# in the repository), the mask grids, apply_mask_prune and token pruning.

SRP_SEEDS = {"B/16": 1, "Ti/16": 2}
SRP_WIDTHS = {"B/16": (768, 12, 3072), "Ti/16": (192, 3, 768)}   # hidden, heads, FFN
TOKEN_SCHEDULE = ((3, 139), (6, 98), (9, 69))   # ViT-B/16 at 224: 197 tokens at first
PROCGEN_SCHEDULE = ((3, 49), (6, 33))            # vit_procgen at 64 / 8: 65 tokens


def write_augreg_npz(path: str, model_type: str, classes: int, seed: int) -> None:
    """An AugReg (big_vision) ``.npz`` at the architecture's published widths
    (12 blocks, 224 pixels, patch 16) with random fp32 weights from ``seed``."""
    import numpy as np

    d, heads, f = SRP_WIDTHS[model_type]
    hd, patch = d // heads, 16
    rng = np.random.default_rng(seed)

    def w(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)

    def ones(n):
        return np.ones(n, np.float32)

    npz = {"embedding/kernel": w(patch, patch, 3, d), "embedding/bias": w(d), "cls": w(1, 1, d),
           "Transformer/posembed_input/pos_embedding": w(1, 197, d),
           "Transformer/encoder_norm/scale": ones(d), "Transformer/encoder_norm/bias": w(d),
           "head/kernel": w(d, classes), "head/bias": w(classes)}
    for i in range(12):
        pre = f"Transformer/encoderblock_{i}"
        att = f"{pre}/MultiHeadDotProductAttention_1"
        for name in ("query", "key", "value"):
            npz[f"{att}/{name}/kernel"], npz[f"{att}/{name}/bias"] = w(d, heads, hd), w(heads, hd)
        npz[f"{att}/out/kernel"], npz[f"{att}/out/bias"] = w(heads, hd, d), w(d)
        for ln in ("LayerNorm_0", "LayerNorm_2"):
            npz[f"{pre}/{ln}/scale"], npz[f"{pre}/{ln}/bias"] = ones(d), w(d)
        mlp = f"{pre}/MlpBlock_3"
        npz[f"{mlp}/Dense_0/kernel"], npz[f"{mlp}/Dense_0/bias"] = w(d, f), w(f)
        npz[f"{mlp}/Dense_1/kernel"], npz[f"{mlp}/Dense_1/bias"] = w(f, d), w(d)
    np.savez(path, **npz)


def write_cifar100(root: str, n_train: int, n_test: int, seed: int) -> None:
    """``root/cifar-100-python/{train,test}``: pickled dicts with ``data``
    [N, 3072] uint8 in CHW order and ``fine_labels`` / ``coarse_labels``, as
    torchvision's download unpacks them."""
    import pickle

    import numpy as np

    d = os.path.join(root, "cifar-100-python")
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    for name, n in (("train", n_train), ("test", n_test)):
        labels = rng.integers(0, 100, n)
        with open(os.path.join(d, name), "wb") as f:
            pickle.dump({"data": rng.integers(0, 256, (n, 3072), dtype=np.uint8),
                         "fine_labels": labels.tolist(),
                         "coarse_labels": (labels // 5).tolist(),
                         "filenames": [f"{name}_{i}.png" for i in range(n)]}, f)


def make_srp_work(work: str) -> str:
    """The SRP models directory (index.csv and the two AugReg files) and
    ``work/data`` with CIFAR-100 (5000 train, 1000 test images). Returns the
    models directory."""
    models = os.path.join(work, "models")
    os.makedirs(models, exist_ok=True)
    t0 = time.perf_counter()
    rows = ["name,ds,filename,final_val,adapt_ds,adapt_filename,adapt_final_val"]
    for arch in ("B/16", "Ti/16"):
        tag = arch.replace("/", "")
        rows += [f"{arch},i21k,augreg_{tag}_i21k,0.80,,,",
                 f"{arch},cifar100,augreg_{tag}_i21k,0,cifar100,augreg_{tag}_c100_224,0.90"]
        write_augreg_npz(os.path.join(models, f"augreg_{tag}_c100_224.npz"), arch, 100,
                         SRP_SEEDS[arch])
    with open(os.path.join(models, "index.csv"), "w") as f:
        f.write("\n".join(rows) + "\n")
    write_cifar100(os.path.join(work, "data"), 5000, 1000, seed=3)
    sizes = {n: os.path.getsize(os.path.join(models, n)) for n in sorted(os.listdir(models))}
    log(f"[SRP] synthesized {json.dumps(sizes)} and CIFAR-100 (5000 + 1000 images, python "
        f"pickles) in {time.perf_counter() - t0:.2f} s")
    return models


def watch_vit_blocks():
    """A context that counts calls of the plain ViT block paths with a CUDA
    tensor (there must be none on a kernel path) and records, per launch of
    rows 1-3, the sequence length and (for row 3) the FFN width."""
    import collections
    import contextlib

    import torch

    from ssp_x_vit_tpu_torch.models import vit
    from ssp_x_vit_tpu_torch.ops.kernels import fused_attn_block as fab
    from ssp_x_vit_tpu_torch.ops.kernels import fused_ffn as ff

    @contextlib.contextmanager
    def ctx():
        seen = {"plain_on_card": collections.Counter(), "attn": collections.Counter(),
                "ffn": collections.Counter()}
        patched = []

        def patch(mod, name, wrapper_of):
            orig = getattr(mod, name)
            patched.append((mod, name, orig))
            setattr(mod, name, wrapper_of(orig))

        def plain(name):
            def wrapper_of(orig):
                def wrapper(x, *a, **k):
                    if isinstance(x, torch.Tensor) and x.is_cuda:
                        seen["plain_on_card"][name] += 1
                    return orig(x, *a, **k)
                return wrapper
            return wrapper_of

        def record(kind, name):
            def wrapper_of(orig):
                def wrapper(x, *a, **k):
                    if x.is_cuda:
                        key = (name, x.shape[1]) if kind == "attn" else (x.shape[1], a[2].shape[1])
                        seen[kind][key] += 1
                    return orig(x, *a, **k)
                return wrapper
            return wrapper_of

        for mod, name in ((vit, "fused_attn_block_plain"), (vit, "ffn_forward"),
                          (vit, "_block_apply_quantized"), (fab, "fused_attn_block_v2_plain"),
                          (fab, "fused_attn_block_plain"), (ff, "fused_ffn_block_plain"),
                          (ff, "fused_ffn_plain")):
            patch(mod, name, plain(name))
        for name in ("fused_attn_block_v2", "fused_attn_block"):
            patch(vit, name, record("attn", name))
        patch(vit, "fused_ffn_block", record("ffn", "fused_ffn_block"))
        try:
            yield seen
        finally:
            for mod, name, orig in reversed(patched):
                setattr(mod, name, orig)

    return ctx()


def _check_launch_phases(label, report, attn_kernel, phases):
    by_phase = report["kernel_launches"]
    for phase in phases:
        for kernel in (attn_kernel, "fused_ffn_block"):
            if by_phase[phase][kernel] <= 0:
                raise AssertionError(f"{label}: {kernel} not launched in the {phase} phase")


def phase_srp(work: str, models: str, device) -> dict:
    """``auto_2ssp --use-srp-checkpoint --srp-model-type Ti/16 --dataset
    cifar100 --stage both --target 0.25 --export-framework-prefix
    --data-parallel`` on the card: row 2 (3 heads) and row 3 in every phase,
    the achieved sparsity within 0.02 of the plan, the export files at Ti/16's
    widths. Then the same CLI on the B/16 checkpoint (``--stage s1``), whose
    FFN importances are the grid's second score file. Returns the launches
    and the B/16 importances path."""
    from ssp_x_vit_tpu_torch.cli import auto_2ssp
    from ssp_x_vit_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    totals = {}
    fw = os.path.join(work, "framework", "ti16")
    base = ["--use-srp-checkpoint", "--srp-models-dir", models, "--srp-top10-idx", "1",
            "--dataset", "cifar100", "--eval-batches", "2", "--backend", "cuda"]
    runs = [("Ti/16", ["--stage", "both", "--target", "0.25", "--min-remaining", "512",
                       "--export-framework-prefix", fw, "--data-parallel"]),
            ("B/16", ["--stage", "s1", "--s1-sparsity", "0.25"])]
    b16_scores = None
    for arch, flags in runs:
        argv = [*base, "--srp-model-type", arch, "--out-root",
                os.path.join(work, "runs", arch.replace("/", "")), *flags]
        log(f"[SRP] auto_2ssp {' '.join(argv)}")
        reset_launch_counts()
        t0 = time.perf_counter()
        report = auto_2ssp.run(auto_2ssp.build_argparser().parse_args(argv))
        seconds = time.perf_counter() - t0
        for name, n in launch_counts.items():
            totals[name] = totals.get(name, 0) + n
        m = report["metrics"]
        log(f"[SRP] {arch}: {seconds:.1f} s; seconds by phase "
            f"{json.dumps({k: round(v, 3) for k, v in report['phase_seconds'].items()})}; "
            f"launches by phase {json.dumps(report['kernel_launches'])}")
        if report["config"]["dataset"] != "cifar100" or report["model"][1].image_size != 224:
            raise AssertionError(f"SRP {arch}: config {report['config']}")
        if arch == "B/16":
            _check_launch_phases(f"SRP {arch}", report, "fused_attn_block_v2",
                                 ("candidates", "stats", "stage1"))
            b16_scores = report["artifacts"]["ffn_importances_path"]
            log(f"[SRP] B/16 --stage s1: {m['params_before_stage1']} -> "
                f"{m['params_after_stage1']} parameters, top-1 {m['acc_baseline']} -> "
                f"{m['acc_stage1']}; FFN importances {b16_scores}")
            continue
        _check_launch_phases(f"SRP {arch}", report, "fused_attn_block",
                             ("candidates", "stats", "materialized"))
        for phase, by_kernel in report["kernel_launches"].items():
            if by_kernel["fused_attn_block_v2"]:
                raise AssertionError(f"SRP Ti/16 (3 heads) launched row 1 in {phase}")
        plan = report["plan"]
        est = plan["estimated_total_removed_params"] / m["params_before_stage1"]
        achieved = 1.0 - m["params_after_stage2"] / m["params_before_stage1"]
        log(f"[SRP] Ti/16: planned sparsity {est:.4f}, achieved {achieved:.4f}, top-1 "
            f"{m['acc_baseline']} -> {m['acc_stage2']} (random weights, 100 classes), latency "
            f"(b=1) {m['latency_baseline_ms']} -> {m['latency_stage2_ms']} ms")
        if abs(achieved - est) > 0.02:
            raise AssertionError(f"SRP Ti/16: achieved sparsity {achieved} vs plan {est}")
        with open(fw + "_scores.json") as f:
            scores = json.load(f)
        with open(fw + "_masks.json") as f:
            masks = json.load(f)
        pruned = set(report["artifacts"]["pruned_block_indices"])
        want = {"ffn": 12 * 768, "heads": 12 * 3, "qkv_dim": 12 * 192}
        got = {k: len(v) for k, v in scores.items()}
        if got != want or sorted(masks) != sorted(want) or any(
                len(v) != 768 for v in masks["ffn"].values()) or any(
                set(v) != {int(int(l) in pruned)} for l, v in masks["heads"].items()):
            raise AssertionError(f"SRP Ti/16 exports: {got}, pruned {pruned}")
        log(f"[SRP] Ti/16 exports {os.path.basename(fw)}_scores.json {got}, _masks.json "
            f"(ffn masks prune {sum(map(sum, masks['ffn'].values()))} neurons, heads of "
            f"blocks {sorted(pruned)})")
    return totals, b16_scores


def phase_mask_grid(work: str, models: str, score_files, device) -> dict:
    """normalize_scores on two ViT-B/16 score files (12 x 3072), then a
    summation and a consensus grid (sizes {2}, prune {20}), each one
    apply_mask_prune subprocess on the SRP B/16 checkpoint and CIFAR-100 on
    the card; both rows ok with a positive reduction, and a re-run adds no row.
    Then ``apply_mask_prune.run`` in-process on the summation mask: rows 1 and
    3 launched 12 times per forward (13 latency forwards + 2 evaluation
    batches per phase) at the mask's FFN widths, no plain block on the card.
    Returns the in-process run's launches."""
    import csv
    from pathlib import Path

    import numpy as np

    from ssp_x_vit_tpu_torch.cli import apply_mask_prune
    from ssp_x_vit_tpu_torch.cli.grid import run_cmd, run_grid
    from ssp_x_vit_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    scores = os.path.join(work, "scores")
    os.makedirs(scores, exist_ok=True)
    named = []
    for name, src in zip(("phase4_b16", "srp_b16"), score_files):
        dst = os.path.join(scores, f"{name}.json")
        with open(src, "rb") as f, open(dst, "wb") as g:
            g.write(f.read())
        named.append(dst)
    t0 = time.perf_counter()
    rc, out, err = run_cmd([sys.executable, "-m", "ssp_x_vit_tpu_torch.cli.normalize_scores",
                            *named, "--out-dir", os.path.join(work, "normalized")])
    if rc != 0:
        raise AssertionError(f"normalize_scores failed:\n{out}{err}")
    normalized = [os.path.join(work, "normalized", os.path.basename(p)) for p in named]
    log(f"[MASK] normalize_scores {len(named)} files ({os.path.getsize(named[0])} bytes each) "
        f"in {time.perf_counter() - t0:.2f} s")
    apply_args = ["--use-srp-checkpoint", "--srp-model-type", "B/16", "--srp-models-dir", models,
                  "--srp-top10-idx", "1", "--dataset", "cifar100", "--eval-batches", "2",
                  "--backend", "cuda"]
    masks = {}
    for mode in ("summation", "consensus"):
        out_dir = os.path.join(work, f"grid_{mode}")
        t0 = time.perf_counter()
        csv_path = run_grid(mode, [Path(p) for p in normalized], {2}, [20], Path(out_dir),
                            apply_args=apply_args)
        seconds = time.perf_counter() - t0
        with open(csv_path) as f:
            rows = list(csv.DictReader(f))
        if len(rows) != 1 or rows[0]["status"] != "ok" or \
                float(rows[0]["stage1_reduction_percent"]) <= 0:
            logs = os.path.join(out_dir, "logs")
            tails = {n: open(os.path.join(logs, n)).read()[-2000:] for n in os.listdir(logs)}
            raise AssertionError(f"{mode} grid rows {rows}; logs {tails}")
        run_grid(mode, [Path(p) for p in normalized], {2}, [20], Path(out_dir),
                 apply_args=apply_args)
        with open(csv_path) as f:
            again = list(csv.DictReader(f))
        if len(again) != 1:
            raise AssertionError(f"{mode} grid re-run added rows: {again}")
        r = rows[0]
        log(f"[MASK] {mode} grid {r['methods']} prune {r['prune']}: {seconds:.1f} s, status "
            f"{r['status']}, params {r['params_before_stage1']} -> {r['params_after_stage1']} "
            f"({r['stage1_reduction_percent']}%), top-1 {r['acc_baseline']} -> "
            f"{r['acc_stage1']}, latency(b=1) {r['latency_baseline_ms']} -> "
            f"{r['latency_stage1_ms']} ms; re-run added no row")
        masks[mode] = os.path.join(out_dir, "mask.json" if mode == "summation"
                                   else "mask_consensus.json")

    argv = ["--mask", masks["summation"], *apply_args,
            "--out-root", os.path.join(work, "apply_in_process")]
    reset_launch_counts()
    t0 = time.perf_counter()
    with watch_vit_blocks() as seen:
        report = apply_mask_prune.run(apply_mask_prune.build_argparser().parse_args(argv))
    seconds = time.perf_counter() - t0
    launches = dict(launch_counts)
    n_prune = report["artifacts"]["n_to_prune_per_block"]
    kept = [3072 - n for n in n_prune]
    padded = -(-max(kept) // 8) * 8
    forwards = 13 + 2          # measure_latency: 3 warm-up + 10 timed; 2 evaluation batches
    for phase in ("baseline", "stage1"):
        got = {k: n for k, n in report["kernel_launches"][phase].items() if n}
        if got != {"fused_attn_block_v2": 12 * forwards, "fused_ffn_block": 12 * forwards}:
            raise AssertionError(f"apply_mask_prune {phase}: launches {got}, expected rows "
                                 f"1 and 3 {12 * forwards} times each")
    if sum(seen["plain_on_card"].values()):
        raise AssertionError(f"plain ViT blocks ran on the card: {dict(seen['plain_on_card'])}")
    widths = {(s, f): n for (s, f), n in seen["ffn"].items()}
    if widths != {(197, 3072): 12 * forwards, (197, padded): 12 * forwards}:
        raise AssertionError(f"row 3 widths {widths}, expected 3072 and {padded}")
    m = report["metrics"]
    log(f"[MASK] apply_mask_prune.run in-process ({seconds:.1f} s): prune per block "
        f"{n_prune} (kept {min(kept)}-{max(kept)}, padded {padded}); rows 1 and 3 "
        f"{12 * forwards} launches each per phase = 12 per forward; row 3 widths "
        f"{json.dumps({f'{f}': n for (_, f), n in widths.items()})}; no plain block on the "
        f"card; params {m['params_before_stage1']} -> {m['params_after_stage1']} "
        f"({m['stage1_reduction_percent']}%), latency(b=1) {m['latency_baseline_ms']} -> "
        f"{m['latency_stage1_ms']} ms")
    with open(masks["consensus"]) as f:
        ones = sum(np.asarray(list(json.load(f)["ffn"].values())))
    log(f"[MASK] consensus mask: {int(ones)} neurons marked over 12 blocks")
    return launches


def profile_token_forward(params, cfg, px) -> None:
    """Where the device time of one ViT-B/16 forward at b=64 (bf16) goes,
    unpruned and under TOKEN_SCHEDULE: ``torch.profiler`` over one forward of
    each after a warm-up; the scoring and pruning (``cls_attention_scores``
    and ``prune_tokens``, profiler ranges here) apart from the blocks; the
    largest kernels by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from ssp_x_vit_tpu_torch.models import token_pruning as tp

    saved = tp.cls_attention_scores, tp.prune_tokens

    def ranged(name, fn):
        def wrapper(*a, **k):
            with record_function(name):
                return fn(*a, **k)
        return wrapper

    tp.cls_attention_scores = ranged("chip_smoke.scores", saved[0])
    tp.prune_tokens = ranged("chip_smoke.prune", saved[1])
    cuda = torch.autograd.DeviceType.CUDA
    try:
        for label, sched in (("unpruned", ()), ("pruned", TOKEN_SCHEDULE)):
            with torch.inference_mode():
                def run():
                    return tp.vit_forward_token_pruned(params, px, cfg, sched,
                                                       compute_dtype=torch.bfloat16)
                run()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    run()
                    torch.cuda.synchronize()
            rows = [e for e in prof.key_averages() if e.device_type == cuda and _device_us(e) > 0
                    and not e.key.startswith("chip_smoke.")]
            total = sum(_device_us(e) for e in rows) / 1e3
            if total <= 0:
                log(f"[PROFILE] token forward {label}: no device time in the trace; not measured")
                continue
            ranges = {name: sum(_event_device_us(e) for e in prof.events()
                                if e.device_type != cuda and e.name == f"chip_smoke.{name}") / 1e3
                      for name in ("scores", "prune")}
            blocks = sum(_device_us(e) for e in rows if "ssp::" in e.key) / 1e3
            rest = total - blocks - ranges["scores"] - ranges["prune"]
            log(f"[PROFILE] token forward ViT-B/16 b=64 bf16 {label}: {total:.3f} ms of device "
                f"time; block kernels (ssp::) {blocks:.3f} ms, scoring {ranges['scores']:.3f} "
                f"ms, pruning {ranges['prune']:.3f} ms, the rest {rest:.3f} ms")
            for e in sorted(rows, key=_device_us, reverse=True)[:10]:
                ms = _device_us(e) / 1e3
                log(f"[PROFILE]   {ms:8.3f} ms {100 * ms / total:5.1f}%  x{e.count:<5d} {e.key[:90]}")
    finally:
        tp.cls_attention_scores, tp.prune_tokens = saved


def phase_token_pruning(device) -> dict:
    """ViT-B/16 at 224 (the CLI's random weights), b=64, bf16, keep schedule
    ((3, 139), (6, 98), (9, 69)): logits of the kernel path within 5e-2 of
    max(1, max |logit|) of the plain blocks on the card; rows 1 and 3 launched
    12 times per forward at the schedule's lengths, no plain block on the
    card; latency with and without the schedule (``measure_latency``'s
    protocol, CUDA events) at b=1 and b=64. Then ``vit_procgen`` in fp32 under
    ((3, 49), (6, 33)): the card's top-1 equals the host CPU's (differences
    only where the host's top-2 margin is under 1e-3), beside the unpruned
    top-1. Returns the phase's launches (the plain comparisons launch none)."""
    import contextlib

    import torch

    from ssp_x_vit_tpu_torch.cli.common import resolve_model
    from ssp_x_vit_tpu_torch.data.pipeline import DataPipeline, load_procgen_slice
    from ssp_x_vit_tpu_torch.evaluation.latency import measure_latency_fn
    from ssp_x_vit_tpu_torch.models import vit
    from ssp_x_vit_tpu_torch.models.persistence import load_pruned_model
    from ssp_x_vit_tpu_torch.models.token_pruning import vit_forward_token_pruned
    from ssp_x_vit_tpu_torch.models.vit import cast_params
    from ssp_x_vit_tpu_torch.ops.kernels import fused_attn_block as fab
    from ssp_x_vit_tpu_torch.ops.kernels import fused_ffn as ff
    from ssp_x_vit_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    @contextlib.contextmanager
    def plain_blocks():
        saved = vit.fused_attn_block_v2, vit.fused_ffn_block
        vit.fused_attn_block_v2, vit.fused_ffn_block = (fab.fused_attn_block_v2_plain,
                                                        ff.fused_ffn_block_plain)
        try:
            yield
        finally:
            vit.fused_attn_block_v2, vit.fused_ffn_block = saved

    params, cfg = resolve_model("vit-b16", device=device)
    bf16 = cast_params(params, torch.bfloat16)
    gen = torch.Generator(device=device).manual_seed(13)
    px = torch.randn(64, 224, 224, 3, generator=gen, device=device)
    t0 = time.perf_counter()
    reset_launch_counts()
    with torch.inference_mode():
        with watch_vit_blocks() as seen:
            got = vit_forward_token_pruned(bf16, px, cfg, TOKEN_SCHEDULE,
                                           compute_dtype=torch.bfloat16)
        launches = dict(launch_counts)
        with plain_blocks():
            ref = vit_forward_token_pruned(bf16, px, cfg, TOKEN_SCHEDULE,
                                           compute_dtype=torch.bfloat16)
        dense = vit_forward_token_pruned(bf16, px, cfg, (), compute_dtype=torch.bfloat16)
    err, rel = scaled_err(got, ref)
    lens = sorted({s for (_, s) in seen["attn"]}, reverse=True)
    log(f"[TOKEN] ViT-B/16 b=64 bf16 schedule {TOKEN_SCHEDULE}: kernel path vs plain blocks "
        f"on the card max_abs_err={err:.3e} scaled={rel:.3e} tol=5e-2; top-1 agreement "
        f"{(got.argmax(-1) == ref.argmax(-1)).float().mean().item():.4f}, with the unpruned "
        f"forward {(got.argmax(-1) == dense.argmax(-1)).float().mean().item():.4f}; "
        f"sequence lengths {lens}; launches {json.dumps({k: n for k, n in launches.items() if n})}")
    if not torch.isfinite(got.float()).all() or rel > 5e-2:
        raise AssertionError("token-pruned logits disagree with the plain blocks")
    want_lens = {197: 3, 139: 3, 98: 3, 69: 3}
    if launches["fused_attn_block_v2"] != 12 or launches["fused_ffn_block"] != 12 or \
            {s: n for (_, s), n in seen["attn"].items()} != want_lens or \
            {s: n for (s, _), n in seen["ffn"].items()} != want_lens or \
            sum(seen["plain_on_card"].values()):
        raise AssertionError(f"token-pruned forward: launches {launches}, attention "
                             f"{dict(seen['attn'])}, FFN {dict(seen['ffn'])}, plain on the card "
                             f"{dict(seen['plain_on_card'])}")
    for b in (1, 64):
        x = px[:b].to(torch.bfloat16)
        times = {}
        for label, sched in (("dense", ()), ("pruned", TOKEN_SCHEDULE)):
            with torch.inference_mode():
                times[label] = measure_latency_fn(
                    lambda: vit_forward_token_pruned(bf16, x, cfg, sched,
                                                     compute_dtype=torch.bfloat16), device)
        log(f"[TOKEN] ViT-B/16 bf16 b={b} latency (3 warm-up + 10 timed, CUDA events): "
            f"{times['dense']:.4f} ms unpruned, {times['pruned']:.4f} ms with the schedule "
            f"({times['pruned'] / times['dense']:.3f}x)")
    profile_token_forward(bf16, cfg, px)

    here = os.path.dirname(os.path.abspath(__file__))
    pparams, pcfg = load_pruned_model(os.path.join(here, "ckpts", "vit_procgen"), device=device)
    host = load_pruned_model(os.path.join(here, "ckpts", "vit_procgen"), device="cpu")[0]
    sl = load_procgen_slice()
    tests = DataPipeline(sl["test_images"], sl["test_labels"], img_size=pcfg.image_size,
                         batch_size=64, device=device).batches()
    hits = {"pruned": 0, "dense": 0, "host": 0}
    near_ties = 0
    with torch.inference_mode():
        for batch in tests:
            card = vit_forward_token_pruned(pparams, batch["pixel_values"], pcfg,
                                            PROCGEN_SCHEDULE).cpu()
            ref = vit_forward_token_pruned(host, batch["pixel_values"].cpu(), pcfg,
                                           PROCGEN_SCHEDULE)
            dense = vit_forward_token_pruned(pparams, batch["pixel_values"], pcfg, ()).cpu()
            labels = batch["labels"].cpu()
            top2 = ref.topk(2, dim=-1).values
            differ = card.argmax(-1) != ref.argmax(-1)
            if (differ & ((top2[:, 0] - top2[:, 1]) >= 1e-3)).any():
                raise AssertionError("vit_procgen token-pruned top-1: card and host CPU differ "
                                     "beyond a near-tie")
            near_ties += int(differ.sum())
            hits["pruned"] += int((card.argmax(-1) == labels).sum())
            hits["host"] += int((ref.argmax(-1) == labels).sum())
            hits["dense"] += int((dense.argmax(-1) == labels).sum())
    n = len(sl["test_labels"])
    log(f"[TOKEN] vit_procgen fp32 schedule {PROCGEN_SCHEDULE}: top-1 card {hits['pruned'] / n:.4f}"
        f", host CPU {hits['host'] / n:.4f} ({near_ties} near-tie differences), unpruned "
        f"{hits['dense'] / n:.4f}; phase {time.perf_counter() - t0:.1f} s")
    return dict(launch_counts)


def check_resize(device) -> None:
    """A CIFAR batch (64 images, uint8) resized 32 -> 224 and normalized on the
    card (``preprocess_batch``: JAX's cubic weights, two fp32 products) against
    the host CPU: within 1e-5."""
    import numpy as np
    import torch

    from ssp_x_vit_tpu_torch.data.pipeline import preprocess_batch

    u8 = np.random.default_rng(17).integers(0, 256, (64, 32, 32, 3), dtype=np.uint8)
    host = preprocess_batch(torch.from_numpy(u8), 224)
    card = preprocess_batch(torch.from_numpy(u8).to(device), 224)
    err = (card.cpu() - host).abs().max().item()
    ms = time_ms(lambda: preprocess_batch(torch.from_numpy(u8).to(device), 224))
    log(f"[RESIZE] 64 x 32x32 uint8 -> 224 on the card vs host CPU (fp32): max_abs_err="
        f"{err:.3e} tol=1e-5; {ms:.4f} ms a batch incl. the host-to-card copy")
    if err > 1e-5:
        raise AssertionError("the card's cubic resize differs from the host's")


LLM_METHOD_CALIB = 16   # calibration windows of s=2048 for SliceGPT and EvoPress (CLI default 256)


def _llm_methods_argv(*flags, calibration=LLM_METHOD_CALIB):
    return ["--model", "llama-2-7b-width", "--synthetic-data", "--seq-len", "2048",
            "--num-calibration", str(calibration), "--num-calibration-2ssp", "4",
            "--backend", "cuda", "--logging", "WARNING", *flags]


def _run_llm_cli(label, argv, model) -> tuple:
    """One ``main_llm.run`` with the counts set to 0 just before it; returns
    (report, launches per kernel, seconds)."""
    import torch

    from ssp_x_vit_tpu_torch.cli import main_llm
    from ssp_x_vit_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    log(f"[METHODS] main_llm {' '.join(argv)}")
    reset_launch_counts()
    t0 = time.perf_counter()
    out = main_llm.run(main_llm.build_argparser().parse_args(argv), model=model)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(launch_counts)
    flash = {ph: n["flash_attention"] for ph, n in out["kernel_launches"].items()
             if n["flash_attention"]}
    log(f"[METHODS] {label}: {seconds:.1f} s; seconds by phase "
        f"{json.dumps({k: round(v, 3) for k, v in out['phase_seconds'].items()})}; "
        f"flash_attention launches by phase {json.dumps(flash)}")
    return out, launches, seconds


def phase_llm_methods(device) -> dict:
    """SliceGPT, EvoPress, the ablation suite and an offline task pack through
    ``cli.main_llm.run`` at Llama-2-7B widths (random bf16 weights made on the
    card; depth cut to 4 layers for SliceGPT, the ablations and the task
    pack, 8 for EvoPress; 16 calibration windows of s=2048 where the CLI
    defaults to 256). SliceGPT rotation-only (sparsity 0, "pca") through
    ``slicegpt`` itself: fp32 logits of one window within 5e-3 of max(1,
    |dense|) of the dense model's. Returns the launches of the CLI runs."""
    import math

    import numpy as np
    import torch

    from ssp_x_vit_tpu_torch.cli import main_llm
    from ssp_x_vit_tpu_torch.llm import datasets as D
    from ssp_x_vit_tpu_torch.llm.evopress import _logits, compute_kl_div
    from ssp_x_vit_tpu_torch.llm.model import LlamaConfig, init_llama_params, llama_forward
    from ssp_x_vit_tpu_torch.llm.slicegpt import slicegpt, sliced_llama_forward
    from ssp_x_vit_tpu_torch.llm.taskpack import build_code_cloze_pack
    from ssp_x_vit_tpu_torch.ops.kernels import KERNEL_NAMES

    t_phase = time.perf_counter()
    cfg8 = LlamaConfig(**dict(LLAMA_2_7B, num_layers=8))
    gen = torch.Generator(device=device)
    gen.manual_seed(4)
    params8 = init_llama_params(gen, cfg8, dtype=torch.bfloat16, device=device)
    cfg4 = LlamaConfig(**dict(LLAMA_2_7B, num_layers=4))
    params4 = dict(params8, blocks={k: v[:4] for k, v in params8["blocks"].items()})
    totals = {name: 0 for name in KERNEL_NAMES}

    def add(launches):
        for name in KERNEL_NAMES:
            totals[name] += launches[name]

    # SliceGPT, rotation only, against the dense model (fp32 on both sides)
    stream = D.synthetic_token_stream(2048 * (LLM_METHOD_CALIB + 8), cfg4.vocab_size, seed=4)
    calib = D.get_calibration(stream, LLM_METHOD_CALIB, seq_len=2048)
    t0 = time.perf_counter()
    parts = main_llm._Phases(device)   # seconds per part, synchronized where each ends
    sliced, scfg = slicegpt(params4, cfg4, 0.0, calib, final_orientation="pca",
                            on_phase=parts.start)
    rot_s = time.perf_counter() - t0
    seconds = parts.seconds
    tokens = torch.from_numpy(calib[0].astype(np.int64)).to(device)
    with torch.no_grad():
        dense, _ = llama_forward(params4, tokens, cfg4, compute_dtype=torch.float32)
        got = sliced_llama_forward(sliced, tokens, scfg)
    err = float((got - dense).abs().max()) / max(1.0, float(dense.abs().max()))
    log(f"[METHODS] SliceGPT rotation only (4 layers, {LLM_METHOD_CALIB} x 2048 tokens, sparsity 0, "
        f"pca): {rot_s:.1f} s (seconds by part {json.dumps({k: round(v, 3) for k, v in seconds.items()})}); "
        f"fp32 logits vs the dense model's: max abs err {err:.3e} of max(1, |dense|) (limit 5e-3)")
    if not err <= 5e-3 or scfg.new_dim != cfg4.hidden_size:
        raise AssertionError(f"rotation-only SliceGPT is not lossless: {err} (new_dim {scfg.new_dim})")
    del sliced, dense, got
    torch.cuda.empty_cache()

    # SliceGPT at 25% through the CLI
    out, launches, s_slice = _run_llm_cli("slicegpt", _llm_methods_argv(
        "--pruning_method", "slicegpt", "--sparsity_rate", "0.25", "--evaluate_perplexity"),
        (params4, cfg4))
    add(launches)
    (entry,) = out["runs"]
    log(f"[METHODS] slicegpt 25%: new_dim {entry['new_dim']}, sliced ppl {entry['ppl']:.3f}, "
        f"pruning {entry['pruning_seconds']:.1f} s; flash_attention {launches['flash_attention']}")
    if entry["new_dim"] != 3072 or not math.isfinite(entry["ppl"]):
        raise AssertionError(f"slicegpt 25%: new_dim {entry['new_dim']}, ppl {entry['ppl']}")
    for phase in ("capture", "evaluation"):
        if out["kernel_launches"][phase]["flash_attention"] <= 0:
            raise AssertionError(f"flash_attention not launched in slicegpt's {phase} phase")

    # EvoPress through the CLI, 8 layers, bf16
    out, launches, s_evo = _run_llm_cli("evopress", _llm_methods_argv(
        "--pruning_method", "evopress", "--sparsity_rate", "0.25", "--evopress-generations", "2",
        "--evaluate_perplexity"), (params8, cfg8))
    add(launches)
    (entry,) = out["runs"]
    records = entry["evopress"]
    tsb = 2
    attn, mlp = entry["attn_mask"], entry["mlp_mask"]
    if sum(attn) != tsb or sum(mlp) != tsb:
        raise AssertionError(f"evopress masks {attn} / {mlp} do not hold {tsb} blocks each")
    for gen_id in sorted({r["generation"] for r in records[1:]}):
        recs = [r for r in records[1:] if r["generation"] == gen_id]
        fwd = sum(r["candidates"] * len(r["minibatch_ids"]) for r in recs)
        log(f"[METHODS] evopress generation {gen_id}: {len(recs)} selection(s), {fwd} one-window "
            f"forwards, {sum(r['seconds'] for r in recs):.2f} s, best fitness "
            f"{recs[-1]['fitnesses'][0]:.6e}")
    log(f"[METHODS] evopress: target logits {records[0]['target_bytes'] / 1e9:.3f} GB fp32 on "
        f"{records[0]['target_device']}; masks attn {attn} mlp {mlp}; gated ppl {entry['ppl']:.3f}")
    # the last selection's minibatch is every window (32768 tokens): recompute
    # the chosen masks' fitness there, targets copied through pinned host memory
    last = records[-1]
    data = [calib[i] for i in last["minibatch_ids"]]
    with torch.no_grad():
        targets = [torch.empty((1, 2048, cfg8.vocab_size), pin_memory=True).copy_(
            _logits(params8, torch.from_numpy(np.asarray(c, np.int64)).to(device), None, None,
                    cfg8, torch.bfloat16)) for c in data]
    fit = compute_kl_div(params8, cfg8, data, targets, attn, mlp)
    del targets
    # both generations end on every window; generation 2's last selection holds
    # generation 1's best (elitism), so its best is no worse, up to the order
    # in which the windows were summed. The initial selection saw one window.
    gen1 = [r for r in records[1:] if r["generation"] == 1][-1]["fitnesses"][0]
    log(f"[METHODS] evopress: chosen masks' fitness recomputed {fit:.8e} vs recorded "
        f"{last['fitnesses'][0]:.8e}; generation 1's best {gen1:.8e}; the initial selection's "
        f"best {records[1]['fitnesses'][0]:.6e} (one window)")
    if abs(fit - last["fitnesses"][0]) > 1e-5 * abs(last["fitnesses"][0]):
        raise AssertionError(f"evopress fitness {fit} vs recorded {last['fitnesses'][0]}")
    if not last["fitnesses"][0] <= gen1 * (1 + 1e-9):
        raise AssertionError(f"evopress final best {last['fitnesses'][0]} > generation 1's {gen1}")
    for phase in ("targets", "selection", "evaluation"):
        if out["kernel_launches"][phase]["flash_attention"] <= 0:
            raise AssertionError(f"flash_attention not launched in evopress's {phase} phase")

    # the ablation suite (quick), 4 layers
    out, launches, s_abl = _run_llm_cli("ablation", _llm_methods_argv("--ablation", "--ablation-quick"),
                                        (params4, cfg4))
    add(launches)
    rows = out["ablation"]
    log(f"[METHODS] ablation --ablation-quick rows: {json.dumps(rows)}")
    if not all(math.isfinite(r["ppl"]) for key in rows for r in rows[key]) or not all(rows.values()):
        raise AssertionError(f"ablation rows missing or not finite: {rows}")
    if out["kernel_launches"]["ablation"]["flash_attention"] <= 0:
        raise AssertionError("flash_attention not launched in the ablation suite")

    # an offline task pack built from the port's own sources, byte ids
    here = os.path.dirname(os.path.abspath(__file__))
    sources = sorted(os.path.join(base, n) for base, _, names in
                     os.walk(os.path.join(here, "ssp_x_vit_tpu_torch")) for n in names
                     if n.endswith(".py"))
    with tempfile.TemporaryDirectory() as pack:
        build_code_cloze_pack(sources, pack, n_examples=32, seed=0)
        out, launches, s_pack = _run_llm_cli("task pack", _llm_methods_argv(
            "--dense", "--evaluate_downstream", "--task-pack", pack), (params4, cfg4))
    add(launches)
    res = out["dense"]["downstream"]["results"]["code_cloze"]
    log(f"[METHODS] task pack: {res['count']} code-cloze examples, acc {res['acc']:.4f} "
        f"(4 choices; chance 0.25), flash_attention {launches['flash_attention']}")
    if res["count"] != 32 or not np.isfinite(np.asarray(res["scores"])).all():
        raise AssertionError(f"task pack results {res}")
    if out["kernel_launches"]["evaluation"]["flash_attention"] < 32 * 4 * cfg4.num_layers:
        raise AssertionError("the task pack's scoring did not launch flash_attention per layer")
    log(f"[METHODS] phase: {time.perf_counter() - t_phase:.1f} s (slicegpt {rot_s:.1f} + "
        f"{s_slice:.1f}, evopress {s_evo:.1f}, ablation {s_abl:.1f}, task pack {s_pack:.1f})")
    del params8, params4
    torch.cuda.empty_cache()
    return totals


def phase_anchor_llm_methods(device) -> None:
    """``ckpts/code_llm_small`` at s=256, each method on the card against the
    same call on the host CPU, both in fp32: SliceGPT 25% (sliced perplexity,
    rtol 1e-4), EvoPress seed 0 with one generation (the same masks and
    fitnesses within rtol 1e-4; where a selection's top two lie within that,
    only the chosen fitness), ``run_ablations(quick=True)`` (each perplexity
    within rtol 1e-4) and a code-cloze task pack through the committed
    ``tokenizer.json`` (the same number correct, every choice's score within
    1e-3). EvoPress takes 2 of the 8 calibration windows, so its budgets are
    capped (the warning is expected and silenced); the ablations score 4
    windows with 2 calibration windows, to keep the host's side short."""
    import contextlib
    import io
    import warnings

    import numpy as np
    import torch

    from ssp_x_vit_tpu_torch.llm.ablations import run_ablations
    from ssp_x_vit_tpu_torch.llm.checkpoints import load_llm_model
    from ssp_x_vit_tpu_torch.llm.downstream import evaluation_downstream
    from ssp_x_vit_tpu_torch.llm.evopress import evopress
    from ssp_x_vit_tpu_torch.llm.slicegpt import evaluate_perplexity_sliced, slicegpt
    from ssp_x_vit_tpu_torch.llm.taskpack import build_code_cloze_pack

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    ckpt = os.path.join(here, "ckpts", "code_llm_small")
    params, cfg = load_llm_model(ckpt, device=device, dtype=torch.float32)
    host = _tree_to(params, "cpu", torch.float32)
    s = 256
    val = np.asarray(np.memmap(os.path.join(ckpt, "corpus_slice", "val.bin"), np.uint16, "r")[:8 * s],
                     np.int32)
    train = np.asarray(np.memmap(os.path.join(ckpt, "corpus_slice", "train.bin"), np.uint16,
                                 "r")[:16 * s], np.int32)
    calib = [train[i * s:(i + 1) * s].reshape(1, s) for i in range(8)]
    f32 = torch.float32
    both = ((params, "card"), (host, "host"))

    def close(a, b, rtol):
        return abs(a - b) <= rtol * abs(b)

    # SliceGPT 25%
    ppl = {}
    for p, where in both:
        t0 = time.perf_counter()
        sp, sc = slicegpt(p, cfg, 0.25, calib)
        ppl[where] = evaluate_perplexity_sliced(sp, sc, val, seq_len=s)
        log(f"[ANCHOR] code_llm_small SliceGPT 25% on the {where}: new_dim {sc.new_dim}, sliced ppl "
            f"{ppl[where]:.6f} ({time.perf_counter() - t0:.2f} s)")
    if not close(ppl["card"], ppl["host"], 1e-4):
        raise AssertionError(f"SliceGPT ppl card {ppl['card']} vs host {ppl['host']}")

    # EvoPress, seed 0, one generation, fp32
    runs = {}
    for p, where in both:
        hist = []
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")   # 8 windows: the budgets are capped, as expected
            masks = evopress(p, cfg, 2, calib[:2], seed=0, num_generations=1, verbose=False,
                             compute_dtype=f32, history=hist)
        runs[where] = (masks, hist)
        log(f"[ANCHOR] code_llm_small EvoPress (2 of 8 blocks, 1 generation, fp32) on the {where}: "
            f"attn {masks[0]} mlp {masks[1]}, best fitnesses "
            f"{[r['fitnesses'][0] for r in hist[1:]]} ({time.perf_counter() - t0:.2f} s)")
    (cm, ch), (hm, hh) = runs["card"], runs["host"]
    ties = [i for i, r in enumerate(hh[1:]) if len(r["fitnesses"]) > 1
            and close(r["fitnesses"][1], r["fitnesses"][0], 1e-4)]
    if cm == hm:
        for a, b in zip(ch[1:], hh[1:]):
            if not np.allclose(a["fitnesses"], b["fitnesses"], rtol=1e-4, atol=0):
                raise AssertionError(f"EvoPress fitnesses card {a['fitnesses']} vs host {b['fitnesses']}")
    elif ties:
        log(f"[ANCHOR] EvoPress: the host's selections {ties} hold top-two fitnesses within 1e-4; "
            f"masks differ, comparing the chosen fitness only")
        if not close(ch[-1]["fitnesses"][0], hh[-1]["fitnesses"][0], 1e-4):
            raise AssertionError("EvoPress chosen fitness card vs host")
    else:
        raise AssertionError(f"EvoPress masks card {cm} vs host {hm}")

    # the ablation suite, quick
    rows = {}
    for p, where in both:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):   # the suite's printed lines
            rows[where] = run_ablations(p, cfg, train.reshape(1, -1), val[:4 * s], calib[:2],
                                        seq_len=s, quick=True, compute_dtype=f32)
        log(f"[ANCHOR] code_llm_small run_ablations(quick) on the {where}: "
            f"{time.perf_counter() - t0:.2f} s")
    for key in rows["card"]:
        a = [r["ppl"] for r in rows["card"][key]]
        b = [r["ppl"] for r in rows["host"][key]]
        log(f"[ANCHOR] ablation {key}: card {np.round(a, 4).tolist()} host {np.round(b, 4).tolist()}")
        if len(a) != len(b) or not np.allclose(a, b, rtol=1e-4, atol=0):
            raise AssertionError(f"ablation {key} perplexities card {a} vs host {b}")

    # a code-cloze task pack through the committed tokenizer.json
    sources = sorted(os.path.join(here, "ssp_x_vit_tpu_torch", "llm", n)
                     for n in os.listdir(os.path.join(here, "ssp_x_vit_tpu_torch", "llm"))
                     if n.endswith(".py"))
    res = {}
    with tempfile.TemporaryDirectory() as pack:
        build_code_cloze_pack(sources, pack, n_examples=24, seed=0)
        for p, where in both:
            res[where] = evaluation_downstream(p, cfg, ckpt, task_pack=pack,
                                               compute_dtype=f32)["results"]["code_cloze"]
    a, b = np.asarray(res["card"]["scores"]), np.asarray(res["host"]["scores"])
    log(f"[ANCHOR] code_llm_small task pack (24 examples, tokenizer.json): acc card "
        f"{res['card']['acc']:.4f} host {res['host']['acc']:.4f}; max score difference "
        f"{float(np.abs(a - b).max()):.3e}")
    if res["card"]["acc"] != res["host"]["acc"] or not np.allclose(a, b, rtol=0, atol=1e-3):
        raise AssertionError("task pack on the card vs the host")
    log(f"[ANCHOR] LLM methods phase: {time.perf_counter() - t_phase:.1f} s")
    del params, host
    torch.cuda.empty_cache()


# ------------------------------------------------- DeepSeek-V3 family (MLA) ---

# HF deepseek-ai/DeepSeek-V3 config.json (the fields config_from_hf_deepseek
# reads), cut to 4 layers below: 3 dense and 1 MoE, so both groups exist.
DEEPSEEK_V3_HF = {
    "model_type": "deepseek_v3", "vocab_size": 129280, "hidden_size": 7168,
    "intermediate_size": 18432, "moe_intermediate_size": 2048, "num_hidden_layers": 61,
    "num_attention_heads": 128, "num_key_value_heads": 128, "q_lora_rank": 1536,
    "kv_lora_rank": 512, "qk_nope_head_dim": 128, "qk_rope_head_dim": 64, "v_head_dim": 128,
    "n_routed_experts": 256, "n_shared_experts": 1, "num_experts_per_tok": 8, "n_group": 8,
    "topk_group": 4, "routed_scaling_factor": 2.5, "norm_topk_prob": True,
    "first_k_dense_replace": 3, "rms_norm_eps": 1e-6, "rope_theta": 10000,
    "rope_scaling": {"type": "yarn", "factor": 40, "beta_fast": 32, "beta_slow": 1,
                     "mscale": 1.0, "mscale_all_dim": 1.0,
                     "original_max_position_embeddings": 4096},
    "tie_word_embeddings": False,
}
DEEPSEEK_LAYERS = 4      # depth cut: 3 dense + 1 MoE (the all-dense variant: 4 dense)
MLA_PAGE = 64            # page size of the served MLA runs


# scores of std 3: a few keys carry each head and max |plain| is ~2-4, so the
# limits below are relative to the outputs; scores much larger than this grow
# fp32's own rounding of the softmax toward its 1e-5 limit
MLA_Q_SCALE = 3.0


def _mla_setup(gen, device, kind, b, nq, D, ps, lens):
    """q [b, nq, D] (normal, times MLA_Q_SCALE), a 2-layer latent pool of
    normal rows (layer 1 used), shuffled distinct pages, int32 lengths: the
    decode layer's operands before the new row. Unscaled queries would spread
    each softmax over hundreds of keys and leave outputs of ~0.04, under the
    tolerance's floor of 1."""
    import torch

    from ssp_x_vit_tpu_torch.ops.kernels.paged_attention import quantize_token_kv

    mp = max(-(-(n + 1) // ps) for n in lens)
    num_pages = 1 + b * mp
    dtype = torch.float32 if kind == "float32" else torch.bfloat16
    rows = torch.randn((2, 1, num_pages, ps, D), generator=gen, device=device)
    if kind == "int8":
        codes, scales = quantize_token_kv(rows)
        pool = {"q": codes, "s": scales}
    else:
        pool = rows.to(dtype)
    perm = torch.randperm(num_pages - 1, generator=gen, device=device) + 1
    table = perm[: b * mp].reshape(b, mp).to(torch.int32).contiguous()
    q = (torch.randn((b, nq, D), generator=gen, device=device) * MLA_Q_SCALE).to(dtype)
    new = torch.randn((b, 1, D), generator=gen, device=device).to(dtype)
    return q, new, pool, table, torch.as_tensor(lens, dtype=torch.int32, device=device)


def _mla_planted_faults(q, pool, table, lens1, rope: int, ps: int):
    """What a faulty kernel would return, made by the plain version from
    altered operands: (what, output) for one page of keys left out (the
    middle page of every sequence that fills it; a 64-key tile at pages of
    64), the last ``rope`` columns left out of the scores, and one page read
    from another sequence's table."""
    import torch

    from ssp_x_vit_tpu_torch.ops.kernels import paged_mla as tpm

    mp = table.shape[1]
    j = mp // 2
    full = lens1 >= (j + 1) * ps
    shifted = torch.cat([table[:, :j], table[:, j + 1:], table[:, j:j + 1]], dim=1)
    dropped = tpm.paged_mla_attention_plain(
        q, pool, torch.where(full[:, None], shifted, table).contiguous(),
        torch.where(full, lens1 - ps, lens1), layer_idx=1)
    q_cut = q.clone()
    q_cut[..., -rope:] = 0
    no_rope = tpm.paged_mla_attention_plain(q_cut, pool, table, lens1, layer_idx=1)
    wrong = table.clone()
    wrong[:, j] = table[:, j].roll(1)
    misread = tpm.paged_mla_attention_plain(q, pool, wrong, lens1, layer_idx=1)
    return [(f"page {j} of the table left out", dropped),
            (f"the last {rope} columns left out of the scores", no_rope),
            (f"page {j} read from the previous sequence's table", misread)]


def _sdpa_backend(q, k) -> str:
    """The first SDPA backend that takes these operands (flash, memory
    efficient, cuDNN, math), in PyTorch's order of preference."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]):
                F.scaled_dot_product_attention(q, k, k)
            torch.cuda.synchronize()
            return backend.name
        except RuntimeError:
            continue
    return "none"


def phase_mla_kernels(device) -> dict:
    """paged_mla_attention (and _q8) against its plain version, with the new
    latent row written first by row 9's standalone write (the pools bit for bit
    the plain write's): DeepSeek-V3 decode (b=8, 128 heads, D=576, pages of 64,
    2048 keys), 16 heads over ~520 ragged keys in pages of 16 and 256, and the
    tiny D=40; fp32 within 1e-5, bf16 and int8 pools within 3e-2 of max(1,
    |plain|). The same limits reject the plain version's output with a page
    of keys left out, the rope columns left out of the scores, or a page read
    from another sequence (``_mla_planted_faults``). Timed at the V3 shape:
    kernel, plain, library (page gather + one SDPA over the gathered rows) and
    bound. Returns the kernels-line records."""
    import torch
    import torch.nn.functional as F

    from ssp_x_vit_tpu_torch.ops.kernels import launch_counts
    from ssp_x_vit_tpu_torch.ops.kernels import paged_attention as tpa
    from ssp_x_vit_tpu_torch.ops.kernels import paged_mla as tpm

    gen = torch.Generator(device=device)
    gen.manual_seed(15)
    tol = {"float32": 1e-5, "bfloat16": 3e-2, "int8": 3e-2}
    cases = [  # label, b, nq, D, ps, lens, timed
        ("DeepSeek-V3 decode, 2047 cached keys", 8, 128, 576, 64, [2047] * 8, True),
        ("16 heads, ~520 ragged keys, pages of 16", 8, 16, 576, 16,
         [519 + 3 * i for i in range(8)], False),
        ("16 heads, ~520 ragged keys, pages of 256", 8, 16, 576, 256,
         [519 + 3 * i for i in range(8)], False),
        ("tiny D=40 (kv_lora_rank 32 + rope 8)", 3, 4, 40, 16, [0, 17, 63], False),
    ]
    records = {}
    for label, b, nq, D, ps, lens, timed in cases:
        for kind in ("float32", "bfloat16", "int8"):
            q, new, pool, table, seq = _mla_setup(gen, device, kind, b, nq, D, ps, lens)
            plain_pool = _clone_pool(pool)
            tpa.paged_pool_write(pool, new, table, seq, layer_idx=1)
            tpa.paged_pool_write_plain(plain_pool, new, table, seq, layer_idx=1)
            if _pools_differ(pool, plain_pool):
                raise AssertionError(f"MLA {label} {kind}: the written pool differs from the plain write")
            lens1 = seq + 1
            suffix = "_q8" if kind == "int8" else ""
            before = launch_counts["paged_mla_attention" + suffix]
            got = tpm.paged_mla_attention(q, pool, table, lens1, layer_idx=1)
            again = tpm.paged_mla_attention(q, pool, table, lens1, layer_idx=1)
            if launch_counts["paged_mla_attention" + suffix] != before + 2:
                raise AssertionError(f"MLA {label} {kind}: not one launch per call")
            ref = tpm.paged_mla_attention_plain(q, pool, table, lens1, layer_idx=1)
            err, rel = scaled_err(got, ref)
            log(f"[KERNEL] paged_mla_attention{suffix} {label}: b={b} nq={nq} D={D} ps={ps} "
                f"{kind}: max abs err {err:.3e}, scaled {rel:.3e} (tol {tol[kind]}), "
                f"same bits twice {torch.equal(got, again)}")
            if rel > tol[kind] or not torch.equal(got, again):
                raise AssertionError(f"paged_mla_attention {label} {kind}: scaled err {rel}")
            planted = []
            for what, bad in _mla_planted_faults(q, pool, table, lens1, 8 if D == 40 else 64, ps):
                bad_rel = scaled_err(bad, ref)[1]
                if bad_rel <= tol[kind]:
                    raise AssertionError(f"MLA {label} {kind}: the limit {tol[kind]} accepts the "
                                         f"plain output with {what} (scaled err {bad_rel:.3e})")
                planted.append(f"{what} {bad_rel:.3e}")
            log(f"[KERNEL] paged_mla_attention{suffix} {label} {kind}: max |plain| "
                f"{ref.float().abs().max().item():.3f}; planted faults rejected, scaled err "
                f"{'; '.join(planted)}")
            if not timed or kind == "float32":
                continue
            keys = lens[0] + 1
            ms = time_ms(lambda: tpm.paged_mla_attention(q, pool, table, lens1, layer_idx=1),
                         iters=50)
            dev_ms = device_ms(lambda: tpm.paged_mla_attention(q, pool, table, lens1,
                                                               layer_idx=1))
            plain_ms = time_ms(lambda: tpm.paged_mla_attention_plain(q, pool, table, lens1,
                                                                     layer_idx=1), iters=5)
            codes = pool["q"] if kind == "int8" else pool
            mp = table.shape[1]

            def gathered():
                rows = codes[1, 0][table.long()].reshape(b, mp * ps, D)[:, :keys]
                if kind == "int8":
                    s = pool["s"][1, 0][table.long()].reshape(b, mp * ps)[:, :keys]
                    rows = (rows.float() * s[..., None]).to(torch.bfloat16)
                return rows[:, None].expand(b, nq, keys, D)

            q4 = q[:, :, None]
            backend = _sdpa_backend(q4, gathered())
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(q4, gathered(), gathered()),
                             iters=10)
            elem = 1 if kind == "int8" else 2
            nbytes = b * keys * D * elem + (b * keys * 4 if kind == "int8" else 0) + \
                2 * b * nq * D * 2 + b * mp * 4 + b * 4
            flops = 4 * b * nq * keys * D
            bound, by = _bound(flops, nbytes, "bfloat16")
            log(f"[TIME] paged_mla_attention{suffix} {label} ({kind} pool, bf16 queries): kernel "
                f"{ms:.4f} ms (events), device {_ms(dev_ms)} ({_rate(nbytes, dev_ms, 'TB/s', 1e9)}, "
                f"{_rate(flops, dev_ms, 'TFLOP/s', 1e9)}), plain {plain_ms:.4f} ms, "
                f"library page gather + SDPA ({backend}) {lib_ms:.4f} ms, bound {bound:.4f} ms "
                f"({by}; {nbytes} bytes, {flops} FLOPs)")
            records["paged_mla_attention" + suffix] = dict(
                name="paged_mla_attention" + suffix, route="cuda",
                source="ssp_x_vit_tpu_torch/ops/kernels/csrc/paged_mla.cu",
                replaces="ssp_x_vit_tpu/ops/pallas/paged_attention.py:" + ("349" if suffix else "243"),
                tpu_kernel=("_paged_pallas_grouped_q8" if suffix else "_paged_pallas_grouped") +
                           " as llm/paged_mla.py:290 calls it (nkv=1, the pool as K and V)",
                shape=f"b={b} nq={nq} D={D} ps={ps}, {keys} keys each, {kind} pool",
                tol=tol[kind], max_abs_err=err, scaled_err=rel, ms=ms, device_ms=dev_ms,
                plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=lib_ms,
                library=f"page gather + F.scaled_dot_product_attention ({backend})",
                flops=flops, bytes=nbytes)
            del q, new, pool, plain_pool, table, seq
        torch.cuda.empty_cache()
    return records


def _mla_write_setup(gen, device, kind, b, nq, D, ps, positions, mp=None):
    """The write-and-attend operands: q [b, nq, D] (normal, times
    MLA_Q_SCALE), a 2-layer latent pool of normal rows (layer 1 used) with
    shuffled distinct pages (``mp`` a row, at least the positions' pages; page
    0 is the trash page no table names), the new rows [b, 1, D] and int32
    positions (one past the table writes to trash page 0)."""
    import torch

    from ssp_x_vit_tpu_torch.ops.kernels.paged_attention import quantize_token_kv

    need = max(-(-(min(n, 1 << 30) + 1) // ps) for n in positions if n < (1 << 30))
    mp = max(mp or 1, need)
    num_pages = 1 + b * mp
    dtype = torch.float32 if kind == "float32" else torch.bfloat16
    rows = torch.randn((2, 1, num_pages, ps, D), generator=gen, device=device)
    if kind == "int8":
        codes, scales = quantize_token_kv(rows)
        pool = {"q": codes, "s": scales}
    else:
        pool = rows.to(dtype)
    perm = torch.randperm(num_pages - 1, generator=gen, device=device) + 1
    table = perm[: b * mp].reshape(b, mp).to(torch.int32).contiguous()
    q = (torch.randn((b, nq, D), generator=gen, device=device) * MLA_Q_SCALE).to(dtype)
    new = torch.randn((b, 1, D), generator=gen, device=device).to(dtype)
    pos = torch.as_tensor([min(n, mp * ps + 3) for n in positions], dtype=torch.int32,
                          device=device)
    return q, new, pool, table, pos


def _mla_write_cost(kind, b, nq, D, v_cols, keys) -> tuple:
    """(bytes, FLOPs) of one write-and-attend call: each live row read once
    (codes and scale for int8), q and the new rows read, the output and the
    written rows stored; 2 * nq * (D + v_cols) operations a live row."""
    row = D + 4 if kind == "int8" else D * (4 if kind == "float32" else 2)
    elem = 4 if kind == "float32" else 2
    keys_all = sum(keys)
    nbytes = keys_all * row + b * nq * D * elem + b * nq * v_cols * elem + b * D * elem + \
        b * row + b * 8
    return nbytes, 2 * nq * (D + v_cols) * keys_all


def phase_mla_write_kernels(device) -> dict:
    """The MLA decode layer's one launch, ``paged_mla_attention_write``, against
    its plain version (the row write, then the attention over positions + 1
    keys, the first v_cols columns): on the Hopper kernel (bf16 and int8
    pools, 128 heads, D=576, v_cols 512) at DeepSeek-V3 decode (b=8, 2047
    cached keys, pages of 64), at the served shape (8 slots of ~520 ragged
    keys, a 10-page table), with pages of 16 and 256 over ragged lengths from
    1 to 2048 and a slot past its table; on the mma.sync kernel (fp32 pools,
    16 and 4 heads, D=40) likewise. Outputs within 1e-5 (fp32) or 3e-2 (bf16,
    int8) of max(1, max |plain|), the same bits on a second call, one launch of
    the expected counter per call, the pools bit for bit the plain write's
    outside trash page 0, and the limits reject the planted faults. The
    Hopper kernel timed at both V3 shapes (events, device, host enqueue,
    plain, page gather + SDPA, bound), the mma.sync write-and-attend at the
    16-head shape. Returns the kernels-line records."""
    import torch
    import torch.nn.functional as F

    from ssp_x_vit_tpu_torch.ops.kernels import launch_counts
    from ssp_x_vit_tpu_torch.ops.kernels import paged_mla as tpm

    gen = torch.Generator(device=device)
    gen.manual_seed(16)
    tol = {"float32": 1e-5, "bfloat16": 3e-2, "int8": 3e-2}
    ragged = [0, 1, 63, 64, 520, 1000, 1500, 2047]
    cases = [  # label, b, nq, D, v_cols, ps, positions, mp, timed, kinds
        ("DeepSeek-V3 decode, 2047 cached keys", 8, 128, 576, 512, 64, [2047] * 8, None, True,
         ("bfloat16", "int8", "float32")),
        ("served shape, 8 slots of ~520 ragged keys", 8, 128, 576, 512, 64,
         [519 + 3 * i for i in range(8)], 10, True, ("bfloat16", "int8")),
        ("128 heads, ragged 1-2048 keys, pages of 16, a slot past its table", 8, 128, 576, 512,
         16, ragged[:7] + [1 << 30], None, False, ("bfloat16", "int8")),
        ("128 heads, ragged 1-2048 keys, pages of 256", 8, 128, 576, 512, 256, ragged, None,
         False, ("bfloat16", "int8")),
        ("16 heads, ~520 ragged keys, pages of 64", 8, 16, 576, 512, 64,
         [519 + 3 * i for i in range(8)], None, True, ("float32", "bfloat16", "int8")),
        ("tiny D=40 (kv_lora_rank 32 + rope 8), a slot past its table", 3, 4, 40, 32, 16,
         [0, 17, 1 << 30], None, False, ("float32", "bfloat16", "int8")),
    ]
    records = {}
    for label, b, nq, D, v_cols, ps, positions, mp, timed, kinds in cases:
        for kind in kinds:
            q, new, pool, table, pos = _mla_write_setup(gen, device, kind, b, nq, D, ps,
                                                        positions, mp)
            codes = pool["q"] if kind == "int8" else pool
            hopper = tpm.hopper_takes(nq, D, v_cols, ps, codes.dtype)
            q8 = "_q8" if kind == "int8" else ""
            counter = ("paged_mla_write_hopper" if hopper else "paged_mla_attention_write") + q8
            plain_pool = _clone_pool(pool)
            ref = tpm.paged_mla_attention_write_plain(q, new, plain_pool, table, pos, layer_idx=1,
                                                      v_cols=v_cols)
            before = dict(launch_counts)
            got = tpm.paged_mla_attention_write(q, new, pool, table, pos, layer_idx=1,
                                                v_cols=v_cols)
            again = tpm.paged_mla_attention_write(q, new, pool, table, pos, layer_idx=1,
                                                  v_cols=v_cols)
            moved = {k: launch_counts[k] - before[k] for k in launch_counts
                     if launch_counts[k] != before[k]}
            if moved != {counter: 2}:
                raise AssertionError(f"MLA write {label} {kind}: launches {moved}, expected "
                                     f"{counter} twice")
            differ = sum(_pools_differ(x, y) for x, y in zip(_without_trash(pool, True),
                                                             _without_trash(plain_pool, True)))
            err, rel = scaled_err(got, ref)
            log(f"[KERNEL] {counter} {label}: b={b} nq={nq} D={D} v_cols={v_cols} ps={ps} "
                f"{kind}: max abs err {err:.3e}, scaled {rel:.3e} (tol {tol[kind]}), same bits "
                f"twice {torch.equal(got, again)}, pool elements unlike the plain write's "
                f"outside trash page 0: {differ}")
            if rel > tol[kind] or not torch.equal(got, again) or differ:
                raise AssertionError(f"{counter} {label} {kind}: scaled err {rel}, pools differ "
                                     f"in {differ}")
            planted = []
            for what, bad in _mla_planted_faults(q, plain_pool, table, pos + 1,
                                                 8 if D == 40 else 64, ps):
                bad_rel = scaled_err(bad[..., :v_cols], ref)[1]
                if bad_rel <= tol[kind]:
                    raise AssertionError(f"MLA write {label} {kind}: the limit {tol[kind]} "
                                         f"accepts the plain output with {what} ({bad_rel:.3e})")
                planted.append(f"{what} {bad_rel:.3e}")
            log(f"[KERNEL] {counter} {label} {kind}: max |plain| "
                f"{ref.float().abs().max().item():.3f}; planted faults rejected, scaled err "
                f"{'; '.join(planted)}")
            if not timed or kind == "float32":
                continue
            call = lambda: tpm.paged_mla_attention_write(q, new, pool, table, pos, layer_idx=1,
                                                         v_cols=v_cols)
            ms = time_ms(call, iters=50)
            dev_ms = device_ms(call)
            host = host_us(call)
            plain_ms = time_ms(lambda: tpm.paged_mla_attention_write_plain(
                q, new, plain_pool, table, pos, layer_idx=1, v_cols=v_cols), iters=5)
            keys = [int(n) + 1 for n in pos.tolist()]
            mpt = table.shape[1]

            def gathered():
                rows = codes[1, 0][table.long()].reshape(b, mpt * ps, D)[:, :max(keys)]
                if kind == "int8":
                    s = pool["s"][1, 0][table.long()].reshape(b, mpt * ps)[:, :max(keys)]
                    rows = (rows.float() * s[..., None]).to(torch.bfloat16)
                return rows[:, None].expand(b, nq, max(keys), D)

            q4 = q[:, :, None]
            mask = None  # ragged lengths: the keys past each length masked
            if min(keys) < max(keys):
                mask = (torch.arange(max(keys), device=device)[None, :] <
                        torch.as_tensor(keys, device=device)[:, None])[:, None, None]
            backend = _sdpa_backend(q4, gathered())
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(q4, gathered(), gathered(),
                                                                    attn_mask=mask), iters=10)
            nbytes, flops = _mla_write_cost(kind, b, nq, D, v_cols, keys)
            bound, by = _bound(flops, nbytes, "bfloat16")
            log(f"[TIME] {counter} {label} ({kind} pool, bf16 queries): kernel {ms:.4f} ms "
                f"(events), device {_ms(dev_ms)} ({_rate(nbytes, dev_ms, 'TB/s', 1e9)}, "
                f"{_rate(flops, dev_ms, 'TFLOP/s', 1e9)}), host enqueue {host:.1f} us a call, "
                f"plain {plain_ms:.4f} ms, library page gather + SDPA ({backend}) "
                f"{lib_ms:.4f} ms, bound {bound:.4f} ms ({by}; {nbytes} bytes, {flops} FLOPs)")
            if counter in records:
                records[counter]["served_shape"] = dict(
                    shape=f"b={b} nq={nq} ps={ps}, {min(keys)}-{max(keys)} keys", ms=ms,
                    device_ms=dev_ms, host_us=host, plain_ms=plain_ms, library_ms=lib_ms,
                    bound_ms=bound, bound_by=by)
                continue
            src = "paged_mla_hopper.cu" if hopper else "paged_mla.cu"
            records[counter] = dict(
                name=counter, route="cuda", source="ssp_x_vit_tpu_torch/ops/kernels/csrc/" + src,
                replaces="ssp_x_vit_tpu/ops/pallas/paged_attention.py:" + ("349" if q8 else "243"),
                tpu_kernel=("_paged_pallas_grouped_q8" if q8 else "_paged_pallas_grouped") +
                           " as llm/paged_mla.py:290 calls it, after paged_pool_write (:280; "
                           "Pallas :541 / :587)",
                shape=f"b={b} nq={nq} D={D} v_cols={v_cols} ps={ps}, {min(keys)}-{max(keys)} "
                      f"keys, {kind} pool",
                tol=tol[kind], max_abs_err=err, scaled_err=rel, ms=ms, device_ms=dev_ms,
                host_us=host, plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=lib_ms,
                library=f"page gather + F.scaled_dot_product_attention ({backend})",
                flops=flops, bytes=nbytes)
            del call
        del q, new, pool, plain_pool, table, pos
        torch.cuda.empty_cache()
    return records


def drive_mla_standalone(device) -> dict:
    """The served MLA decode layer makes one ``paged_mla_attention_write`` call;
    the standalone ``paged_mla_attention`` (and ``_q8``) stays for direct
    calls, and the mma.sync write-and-attend serves fp32 pools and head counts
    that are not a multiple of 64 (the tiny models). Both are driven here at
    DeepSeek-V2-Lite's 16 heads over ~520 keys, pages of 64: the row write
    then the standalone attention against the write-and-attend call from the
    same pools (the same pools bit for bit, outputs within the dtype's limit).
    Returns the launches this drive made."""
    import torch

    from ssp_x_vit_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from ssp_x_vit_tpu_torch.ops.kernels import paged_attention as tpa
    from ssp_x_vit_tpu_torch.ops.kernels import paged_mla as tpm

    gen = torch.Generator(device=device)
    gen.manual_seed(17)
    tol = {"float32": 1e-5, "bfloat16": 3e-2, "int8": 3e-2}
    reset_launch_counts()
    for kind in ("float32", "bfloat16", "int8"):
        q, new, pool, table, pos = _mla_write_setup(gen, device, kind, 8, 16, 576, 64,
                                                    [519 + 3 * i for i in range(8)])
        fused = _clone_pool(pool)
        tpa.paged_pool_write(pool, new, table, pos, layer_idx=1)
        got = tpm.paged_mla_attention(q, pool, table, pos + 1, layer_idx=1)
        ref = tpm.paged_mla_attention_write(q, new, fused, table, pos, layer_idx=1)
        torch.cuda.synchronize()
        err, rel = scaled_err(got, ref)
        same = _pools_differ(pool, fused) == 0
        log(f"[KERNEL] paged_pool_write + paged_mla_attention ({kind} pool), the standalone "
            f"calls, vs paged_mla_attention_write: pools identical {same}, max_abs_err={err:.3e} "
            f"scaled={rel:.3e} tol={tol[kind]}")
        if not same or rel > tol[kind]:
            raise AssertionError(f"the standalone MLA calls ({kind} pool) disagree with "
                                 "paged_mla_attention_write")
    names = ("paged_mla_attention", "paged_mla_attention_q8", "paged_mla_attention_write",
             "paged_mla_attention_write_q8")
    return {name: launch_counts[name] for name in names}


def make_deepseek_v3(device, dense: bool = False):
    """(params, cfg) at DeepSeek-V3's published widths (``config_from_hf_deepseek``
    of its config.json), depth cut to 4 layers: 3 dense + 1 MoE, or all 4
    dense (``n_routed_experts`` 0, the 2SSP target). Random bf16 weights made
    on the card from a seed."""
    import dataclasses

    import torch

    from ssp_x_vit_tpu_torch.llm.deepseek import config_from_hf_deepseek, init_deepseek_params

    cfg = dataclasses.replace(config_from_hf_deepseek(DEEPSEEK_V3_HF), num_layers=DEEPSEEK_LAYERS)
    if dense:
        cfg = dataclasses.replace(cfg, n_routed_experts=0, n_shared_experts=0)
    gen = torch.Generator(device=device)
    gen.manual_seed(3)
    t0 = time.perf_counter()
    params = init_deepseek_params(gen, cfg, dtype=torch.bfloat16, device=device)
    torch.cuda.synchronize()
    n = sum(v.numel() for v in _flat(params).values())
    experts = sum(params["moe_blocks"][k].numel() for k in ("gate_kernel", "up_kernel",
                                                              "down_kernel")) if not dense else 0
    log(f"[DEEPSEEK] DeepSeek-V3 widths, {cfg.num_layers} layers ({cfg.n_dense_layers} dense, "
        f"{cfg.n_moe_layers} MoE): {n / 1e9:.3f} B parameters ({experts / 1e9:.3f} B in the routed "
        f"experts) in bf16 made on the card in {time.perf_counter() - t0:.2f} s "
        f"({torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB allocated)")
    return params, cfg


def _main_llm_run(label, argv, model, tag: str = "DEEPSEEK") -> tuple:
    """One ``cli.main_llm.run`` (a DeepSeek model, or any other the ``[tag]``
    lines name) with the counts set to 0 just before it; returns (result,
    launches, seconds, peak GiB)."""
    import torch

    from ssp_x_vit_tpu_torch.cli import main_llm
    from ssp_x_vit_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    log(f"[{tag}] {label}: main_llm {' '.join(argv)}")
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = main_llm.run(main_llm.build_argparser().parse_args(argv), model=model)
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = {k: v for k, v in launch_counts.items() if v}
    log(f"[{tag}] {label}: {seconds:.1f} s, peak {peak:.1f} GiB; seconds by phase "
        f"{json.dumps({k: round(v, 3) for k, v in out['phase_seconds'].items()})}; launches "
        f"{json.dumps(launches)}")
    return out, dict(launch_counts), seconds, peak


class _ExpertRouting:
    """While ``armed``, wraps ``deepseek._deepseek_route``: each call's chosen
    experts ([T, E] bool) go to ``seen``; with ``pins`` holding masks, each
    call takes the next one and routes to those experts instead, weighted as
    the router weights its own choice (the un-biased scores, renormalized,
    times routed_scaling_factor); ``moved`` counts the calls whose own choice
    differed."""

    def __init__(self):
        self.armed, self.seen, self.pins, self.moved = False, [], [], 0

    def __enter__(self):
        from ssp_x_vit_tpu_torch.llm import deepseek as ds

        self._ds, self._orig = ds, ds._deepseek_route
        ds._deepseek_route = self._route
        return self

    def __exit__(self, *exc):
        self._ds._deepseek_route = self._orig

    def _route(self, xt, bp, cfg):
        import torch

        w = self._orig(xt, bp, cfg)
        if not self.armed:
            return w
        own = w > 0
        if not self.pins:
            self.seen.append(own)
            return w
        pin = self.pins.pop(0)
        if torch.equal(own, pin):
            return w
        self.moved += 1
        scores = torch.sigmoid(xt.float() @ bp["router"].float())
        w = torch.where(pin, scores, torch.zeros_like(scores))
        if cfg.norm_topk_prob:
            w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
        return w * cfg.routed_scaling_factor


def _mla_prefill(params, cfg, pool, prompt, table, device, chunked):
    """One prompt's paged MLA prefill as the served run made it: whole, or in
    chunks of ``chunked`` tokens. Returns the next-token logits."""
    import torch

    from ssp_x_vit_tpu_torch.llm import paged_mla as tpm

    if chunked:
        return tpm.mla_paged_prefill_chunked(params, prompt, pool, cfg, table,
                                             chunk_size=chunked)[0]
    return tpm.mla_paged_prefill(params, torch.as_tensor([prompt], device=device), pool, cfg,
                                 table, len(prompt))[0]


def _mla_replay(params, cfg, device, prompts, served, cache_dtype, chunked) -> tuple:
    """The served computation again: each prompt prefilled as served, then
    all decoded together at the served batch's 8 rows and fed the served
    tokens, the MoE layers' expert choices recorded. Returns (steps where the
    served token is the replay's argmax, worst gap over max(1, max |logit|),
    per decode step the choices [8, E] of each MoE layer)."""
    import torch

    from ssp_x_vit_tpu_torch.llm import paged_mla as tpm

    b, steps = len(prompts), len(served[0])
    pages = max(-(-(len(p) + steps + 1) // MLA_PAGE) for p in prompts)
    pool = tpm.init_mla_pool(cfg, 1 + b * pages, MLA_PAGE, cache_dtype, device)
    tables = (1 + torch.arange(b * pages, dtype=torch.int32, device=device)).reshape(b, pages)
    logits = torch.stack([_mla_prefill(params, cfg, pool, p, tables[i], device, chunked)
                          for i, p in enumerate(prompts)])
    toks = torch.as_tensor(served, dtype=torch.int64, device=device)       # [b, steps]
    lens = torch.as_tensor([len(p) for p in prompts], dtype=torch.int32, device=device)
    gaps, peaks, experts = [], [], []
    with _ExpertRouting() as routing:
        for t in range(steps):
            gaps.append(logits.max(dim=-1).values - logits.gather(-1, toks[:, t:t + 1])[:, 0])
            peaks.append(logits.abs().max())
            if t + 1 < steps:
                routing.armed, routing.seen = True, []
                logits = tpm.mla_paged_decode_step(params, toks[:, t], pool, cfg, tables,
                                                   lens + t)[0]
                routing.armed = False
                experts.append(routing.seen)
    gaps = torch.stack(gaps)
    return (int((gaps == 0).sum()), float(gaps.max()) / max(1.0, float(torch.stack(peaks).max())),
            experts)


def _mla_alone_gaps(params, cfg, prompt, tokens, cache_dtype, device, chunked=None,
                    experts=None) -> tuple:
    """The request alone through the paged MLA path (the served run's
    prefill, then one-sequence decode steps fed the served tokens), its MoE
    layers routed at each decode step to ``experts`` (the served batch's
    choices for this request, ``[1, E]`` per MoE layer) when given: (steps
    where the served token is the alone argmax, worst logit gap, largest
    |logit|, decode steps whose router chose other experts)."""
    import torch

    from ssp_x_vit_tpu_torch.llm import paged_mla as tpm

    n = len(prompt)
    pages = -(-(n + len(tokens) + 1) // MLA_PAGE)
    pool = tpm.init_mla_pool(cfg, 1 + pages, MLA_PAGE, cache_dtype, device)
    table = torch.arange(1, 1 + pages, dtype=torch.int32, device=device)
    toks = torch.as_tensor(tokens, dtype=torch.int64, device=device)
    logits = _mla_prefill(params, cfg, pool, prompt, table, device, chunked)
    gaps, peaks, moved = [], [], 0
    with _ExpertRouting() as routing:
        for t in range(len(tokens)):
            gaps.append(logits.max() - logits[toks[t]])
            peaks.append(logits.abs().max())
            if t + 1 < len(tokens):
                before = routing.moved
                routing.armed, routing.pins = experts is not None, list(experts[t]) if experts else []
                lens = torch.full((1,), n + t, dtype=torch.int32, device=device)
                logits = tpm.mla_paged_decode_step(params, toks[t:t + 1], pool, cfg, table[None],
                                                   lens)[0][0]
                routing.armed = False
                moved += routing.moved > before
    gaps = torch.stack(gaps)
    return int((gaps == 0).sum()), float(gaps.max()), float(torch.stack(peaks).max()), moved


def _mla_prompts(cfg, seed: int = 31) -> list:
    """8 prompts of 64-512 tokens from the synthetic stream of ``seed``."""
    from ssp_x_vit_tpu_torch.llm.datasets import synthetic_token_stream

    stream = synthetic_token_stream(8 * 512, cfg.vocab_size, seed=seed).reshape(-1)
    return [stream[i * 512: i * 512 + n].tolist() for i, n in
            enumerate((64, 512, 130, 257, 320, 77, 448, 200))]


def _mla_served(params, cfg, device, prompts, cache_dtype, chunked) -> tuple:
    """The prompts (16 greedy tokens each) through ``ServingEngine`` over
    ``MLAPagedServer`` (8 slots, pages of 64), the counts set to 0 just
    before: (served tokens, decode steps, launches, seconds)."""
    import torch

    from ssp_x_vit_tpu_torch.llm.engine import ServingEngine
    from ssp_x_vit_tpu_torch.llm.paged_mla import MLAPagedServer
    from ssp_x_vit_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    t0 = time.perf_counter()
    with ServingEngine(params, cfg, max_batch=8, num_pages=8 * 10 + 1, page_size=MLA_PAGE,
                       max_context=640, cache_dtype=cache_dtype, chunked_prefill=chunked) as eng:
        if not isinstance(eng._server, MLAPagedServer):
            raise AssertionError("the engine did not pick MLAPagedServer for a DeepSeek model")
        handles = [eng.submit(p, max_new_tokens=16) for p in prompts]
        served = [h.result(timeout=600) for h in handles]
        steps = eng._server.decode_steps
    torch.cuda.synchronize()
    return served, steps, dict(launch_counts), time.perf_counter() - t0


def _mla_serve(params, cfg, device, label, cache_dtype, chunked) -> dict:
    """8 requests (``_mla_prompts``) through ``_mla_served``; the Hopper
    write-and-attend kernel (``paged_mla_write_hopper`` / ``_q8``) launched
    once per layer and decode step, no other paged kernel (no standalone row
    write or MLA attention); each served token within 5e-2 of
    max(1, max |logit|) of the best logit of the served batch replayed
    (``_mla_replay``) and of the same prompt run alone with the same prefill
    and, at each decode step, the batch's experts (``_mla_alone_gaps``). The
    router's top-8 of 256 is a near-tie that the batch's other bf16 rounding
    flips at ~10-15% of steps (``scripts/torch_mla_served_gap.py``): with other
    experts a step's logits are another model's. Returns the launches."""
    import torch

    prompts = _mla_prompts(cfg)
    torch.cuda.reset_peak_memory_stats()
    served, steps, launches, seconds = _mla_served(params, cfg, device, prompts, cache_dtype,
                                                   chunked)
    q8 = "_q8" if cache_dtype == torch.int8 else ""
    want = steps * cfg.num_layers
    for name in ("paged_mla_write_hopper", "paged_mla_write_hopper_q8",
                 "paged_mla_attention_write", "paged_mla_attention_write_q8",
                 "paged_mla_attention", "paged_mla_attention_q8", "paged_pool_write",
                 "paged_pool_write_q8", "paged_attention", "paged_attention_q8",
                 "paged_attention_write", "paged_attention_write_q8"):
        expect = want if name == "paged_mla_write_hopper" + q8 else 0
        if launches[name] != expect or want <= 0:
            raise AssertionError(f"MLA {label}: {name} launched {launches[name]} times over "
                                 f"{steps} decode steps of {cfg.num_layers} layers, expected {expect}")
    tokens = sum(len(s) for s in served)
    log(f"[DEEPSEEK] served {label}: {len(prompts)} requests, {tokens} tokens in {seconds:.1f} s "
        f"({tokens / seconds:.1f} tokens/s over the run, prefills included), {steps} decode steps, "
        f"paged_mla_write_hopper{q8} launches {launches['paged_mla_write_hopper' + q8]} = layers x "
        f"steps (one write-and-attend launch a layer; no standalone row write or attention), "
        f"peak {torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB")
    if any(len(s) != 16 for s in served):
        raise AssertionError(f"MLA {label}: a request ended early: {[len(s) for s in served]}")
    r_exact, r_worst, experts = _mla_replay(params, cfg, device, prompts, served, cache_dtype,
                                            chunked)
    exact = total = moved = 0
    worst = 0.0
    for i, (p, s) in enumerate(zip(prompts, served)):
        mine = [[m[i:i + 1] for m in step] for step in experts] if cfg.n_moe_layers else None
        same, gap, peak, k = _mla_alone_gaps(params, cfg, p, s, cache_dtype, device, chunked, mine)
        exact, total, moved = exact + same, total + len(s), moved + k
        worst = max(worst, gap / max(1.0, peak))
    log(f"[DEEPSEEK] served {label}: the served batch replayed (8 rows, the served tokens fed): "
        f"{r_exact} of {total} served tokens are its argmax, worst gap {r_worst:.3e}; each prompt "
        f"alone (the same prefill; at each decode step the MoE routed to the batch's experts, "
        f"which its own router left at {moved} of {total - len(served)} steps): {exact} of {total} "
        f"are the alone argmax; worst logit gap {worst:.3e} of max(1, max |logit|), tol 5e-2")
    if max(worst, r_worst) > 5e-2:
        raise AssertionError(f"MLA {label}: a served token is not the best token of its replay "
                             f"({r_worst:.3e}) or of its prompt run alone ({worst:.3e})")
    return launches


def measure_mla_decode(params, cfg, device) -> None:
    """Eight live slots of 512-token prompts on an ``MLAPagedServer`` (bf16
    pools): ms per decode step over blocks of 8 steps, tokens/s, and a
    ``torch.profiler`` split of one block."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ssp_x_vit_tpu_torch.llm.datasets import synthetic_token_stream
    from ssp_x_vit_tpu_torch.llm.paged_mla import MLAPagedServer

    server = MLAPagedServer(params, cfg, max_batch=8, num_pages=8 * 10 + 1, page_size=MLA_PAGE,
                            max_context=640)
    stream = synthetic_token_stream(8 * 512, cfg.vocab_size, seed=22).reshape(-1)
    for i in range(8):
        server.add_request(np.asarray(stream[i * 512:(i + 1) * 512]), max_new_tokens=100)
    server.step_many(8)  # warm-up
    torch.cuda.synchronize()
    blocks = []
    for _ in range(3):
        t0 = time.perf_counter()
        server.step_many(8)
        torch.cuda.synchronize()
        blocks.append((time.perf_counter() - t0) * 1e3 / 8)
    step_ms = sum(blocks) / len(blocks)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        server.step_many(8)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and _device_us(e) > 0]
    total_ms = sum(_device_us(e) for e in kernels) / 1e3 / 8
    weights = sum(v.numel() * v.element_size() for k, v in _flat(params).items()
                  if k.startswith(("dense_blocks", "moe_blocks")) or k == "lm_head")
    log(f"[DEEPSEEK] MLA decode at 8 live slots (~520 cached tokens each), bf16 pools: "
        f"{step_ms:.2f} ms per step over {len(blocks)} blocks of 8 (host clock; blocks "
        f"{', '.join(f'{x:.2f}' for x in blocks)}) = {8e3 / step_ms:.1f} tokens/s; the dense "
        f"all-expert MoE reads every weight each step: {weights / 1e9:.1f} GB, "
        f"{weights / PEAK_BYTES * 1e3:.2f} ms at the data-sheet rate")
    if total_ms <= 0:
        log("[PROFILE] MLA decode block: the trace holds no device time: not measured")
        return
    log(f"[PROFILE] MLA decode block of 8 steps: {sum(e.count for e in kernels) / 8:.0f} device "
        f"kernels and {total_ms:.2f} ms of device activity per step ({100 * total_ms / step_ms:.0f}% "
        f"of the step's wall time)")
    for e in sorted(kernels, key=_device_us, reverse=True)[:8]:
        ms = _device_us(e) / 1e3 / 8
        log(f"[PROFILE]   {ms:8.3f} ms {100 * ms / total_ms:5.1f}%  x{e.count // 8:<4d} {e.key[:90]}")


def profile_moe_forward(params, cfg, device) -> None:
    """Where the time of one bf16 forward of 512 tokens goes (the 3 dense
    layers, the MoE layer, the lm_head): a ``torch.profiler`` split."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ssp_x_vit_tpu_torch.llm.deepseek import deepseek_forward

    toks = torch.randint(0, cfg.vocab_size, (1, 512), device=device,
                         generator=torch.Generator(device=device).manual_seed(5))
    deepseek_forward(params, toks, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    deepseek_forward(params, toks, cfg)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        deepseek_forward(params, toks, cfg)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and _device_us(e) > 0]
    total = sum(_device_us(e) for e in kernels) / 1e3
    log(f"[PROFILE] DeepSeek-V3-width bf16 forward, 512 tokens, 4 layers (dense all-expert MoE): "
        f"{wall:.1f} ms wall, {total:.1f} ms device")
    for e in sorted(kernels, key=_device_us, reverse=True)[:8]:
        ms = _device_us(e) / 1e3
        log(f"[PROFILE]   {ms:8.3f} ms {100 * ms / max(total, 1e-9):5.1f}%  x{e.count:<4d} "
            f"{e.key[:90]}")


def phase_deepseek(device) -> dict:
    """The DeepSeek-V3 family at its published widths (4 layers): through
    ``cli.main_llm.run`` dense perplexity, shortGPT 25%, ``--quantize int4``
    (row 10 must launch) on the MoE model; ``deepseek_generate`` at b=8; the
    model served through ``ServingEngine`` / ``MLAPagedServer`` with bf16 pools
    and with int8 pools and chunked prefill, with a decode-step measurement;
    then 25% 2SSP on the all-dense variant. Returns launches per kernel."""
    import math

    import numpy as np
    import torch

    from ssp_x_vit_tpu_torch.llm.datasets import synthetic_token_stream
    from ssp_x_vit_tpu_torch.llm.deepseek import deepseek_generate
    from ssp_x_vit_tpu_torch.ops.kernels import KERNEL_NAMES, launch_counts, reset_launch_counts

    totals = {name: 0 for name in KERNEL_NAMES}

    def add(counts):
        for k in KERNEL_NAMES:
            totals[k] += counts.get(k, 0)

    parts = {}
    t0 = time.perf_counter()
    params, cfg = make_deepseek_v3(device)
    parts["make MoE model"] = time.perf_counter() - t0
    common = ["--model", "deepseek-v3-width", "--synthetic-data", "--seq-len", "256",
              "--num-calibration", "2", "--backend", "cuda", "--evaluate_perplexity",
              "--logging", "WARNING"]
    t0 = time.perf_counter()
    out, counts, _, _ = _main_llm_run("dense", common + ["--dense"], (params, cfg))
    dense = out["dense"]["ppl"]
    add(counts)
    out, counts, _, _ = _main_llm_run("shortgpt 25%", common + ["--pruning_method", "shortgpt",
                                                               "--sparsity_rate", "0.25"],
                                      (params, cfg))
    (entry,) = out["runs"]
    add(counts)
    log(f"[DEEPSEEK] dense ppl {dense:.2f} (fp32, 10 windows of 256); shortGPT 25% drops blocks "
        f"{[i for i, m in enumerate(entry['attn_mask']) if m]}: ppl {entry['ppl']:.2f}")
    if not (math.isfinite(dense) and math.isfinite(entry["ppl"])) or sum(entry["attn_mask"]) != 1:
        raise AssertionError(f"DeepSeek dense {dense} / shortgpt {entry}")
    out, counts, _, _ = _main_llm_run("int4", common + ["--dense", "--quantize", "int4"],
                                      (params, cfg))
    add(counts)
    ppl4 = out["dense"]["ppl"]
    log(f"[DEEPSEEK] int4 ppl {ppl4:.2f} (bf16 weights {dense:.2f}); quant4_matmul launches "
        f"{counts['quant4_matmul']}")
    if counts["quant4_matmul"] <= 0:
        raise AssertionError("quant4_matmul (row 10) did not launch in the DeepSeek int4 run")
    if not math.isfinite(ppl4) or abs(math.log(ppl4) - math.log(dense)) > 0.05 * math.log(dense):
        raise AssertionError(f"DeepSeek int4 perplexity {ppl4} vs dense {dense}")
    parts["main_llm: dense, shortgpt, int4"] = time.perf_counter() - t0
    profile_moe_forward(params, cfg, device)

    t0 = time.perf_counter()
    stream = synthetic_token_stream(8 * 64, cfg.vocab_size, seed=41).reshape(8, 64)
    torch.cuda.reset_peak_memory_stats()
    gen = deepseek_generate(params, cfg, stream, max_new_tokens=16)
    torch.cuda.synchronize()
    g_s = time.perf_counter() - t0
    if any(len(g) != 80 or not ((0 <= g) & (g < cfg.vocab_size)).all() for g in gen):
        raise AssertionError("deepseek_generate gave malformed sequences")
    log(f"[DEEPSEEK] deepseek_generate b=8, prompts of 64, 16 new tokens: {g_s:.2f} s "
        f"({8 * 16 / g_s:.1f} tokens/s, prefill and compile-free eager steps included), peak "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB")
    parts["deepseek_generate"] = g_s

    t0 = time.perf_counter()
    add(_mla_serve(params, cfg, device, "bf16 pools", torch.bfloat16, None))
    add(_mla_serve(params, cfg, device, "int8 pools, chunked prefill 128", torch.int8, 128))
    measure_mla_decode(params, cfg, device)
    parts["served (engine, bf16 and int8 pools) + decode measurement"] = time.perf_counter() - t0
    del params
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    params, cfg = make_deepseek_v3(device, dense=True)
    out, counts, _, _ = _main_llm_run("2ssp 25% (all-dense variant)",
                                      common + ["--pruning_method", "2ssp", "--sparsity_rate",
                                                "0.25", "--num-calibration-2ssp", "2"],
                                      (params, cfg))
    add(counts)
    (entry,) = out["runs"]
    log(f"[DEEPSEEK] 2SSP 25% on the all-dense variant: pruned attention "
        f"{entry['pruned_attention_blocks']}, kept FFN width {entry['num_preserve_mlp']} of "
        f"{cfg.intermediate_size}, achieved sparsity {entry['achieved_sparsity']:.4f}, ppl "
        f"{entry['ppl']:.2f}")
    if abs(entry["achieved_sparsity"] - 0.25) > 0.02 or not math.isfinite(entry["ppl"]):
        raise AssertionError(f"DeepSeek 2SSP: {entry}")
    parts["all-dense variant: make + 2SSP"] = time.perf_counter() - t0
    del params
    torch.cuda.empty_cache()
    log(f"[DEEPSEEK] seconds by part {json.dumps({k: round(v, 1) for k, v in parts.items()})}")
    return totals


def phase_anchor_deepseek(device) -> None:
    """The tiny DeepSeek models in fp32, card against the host CPU, through
    ``cli.main_llm.run``: dense perplexity, shortGPT / window_based /
    blockpruner on the MoE model (the same masks), 2SSP on the all-dense
    variant (the same pruned blocks and width), perplexities within rtol 1e-4;
    EvoPress with a small search (the CLI's 64 distinct initial candidates are
    more than 4 layers hold) gives the same masks; paged MLA greedy tokens on
    the card equal contiguous ``deepseek_generate`` tokens."""
    import numpy as np
    import torch

    from ssp_x_vit_tpu_torch.cli import main_llm
    from ssp_x_vit_tpu_torch.llm import evopress as tevo
    from ssp_x_vit_tpu_torch.llm import datasets as D
    from ssp_x_vit_tpu_torch.llm.deepseek import deepseek_generate
    from ssp_x_vit_tpu_torch.llm.paged_mla import mla_paged_generate

    base = ["--synthetic-data", "--seq-len", "64", "--num-calibration", "3",
            "--num-calibration-2ssp", "2", "--evaluate_perplexity", "--logging", "WARNING"]
    runs = [("tiny-random-deepseek", ["--dense"]),
            ("tiny-random-deepseek", ["--pruning_method", "shortgpt", "--sparsity_rate", "0.25"]),
            ("tiny-random-deepseek", ["--pruning_method", "window_based", "--sparsity_rate", "0.5"]),
            ("tiny-random-deepseek", ["--pruning_method", "blockpruner", "--sparsity_rate", "0.25"]),
            ("tiny-random-deepseek-dense", ["--pruning_method", "2ssp", "--sparsity_rate", "0.25"])]
    models = {}
    for name, flags in runs:
        if name not in models:
            host = main_llm.load_model(main_llm.build_argparser().parse_args(
                ["--model", name, "--backend", "cpu"]), torch.device("cpu"))
            models[name] = (host, (_tree_to(host[0], device), host[1]))
        host, card = models[name]
        res = {}
        for where, model in (("cpu", host), (device.type, card)):
            args = main_llm.build_argparser().parse_args(["--model", name, "--backend", where,
                                                          *base, *flags])
            res[where] = main_llm.run(args, model=model)
        c, h = res[device.type], res["cpu"]
        if "--dense" in flags:
            pc, ph, same = c["dense"]["ppl"], h["dense"]["ppl"], True
        else:
            (ec,), (eh,) = c["runs"], h["runs"]
            pc, ph = ec["ppl"], eh["ppl"]
            keys = ("pruned_attention_blocks", "num_preserve_mlp") if "2ssp" in flags else \
                ("attn_mask", "mlp_mask")
            same = all(ec[k] == eh[k] for k in keys)
        log(f"[ANCHOR] {name} {' '.join(flags)}: ppl card {pc:.6f}, host CPU {ph:.6f}, "
            f"same choices {same}")
        if not same or abs(pc - ph) > 1e-4 * ph:
            raise AssertionError(f"{name} {flags}: card {pc} vs host {ph}, same choices {same}")
    host, card = models["tiny-random-deepseek"]
    stream = D.synthetic_token_stream(8 * 64, host[1].vocab_size, seed=4)
    calib = D.get_calibration(stream, 3, seq_len=64)
    args = dict(initially_generated=4, offspring=3, initial_tokens=64,
                tokens_per_selection=(64, 192))
    masks = [tevo.evopress(p, c, 1, calib, args=args, seed=3, num_generations=2, verbose=False,
                           compute_dtype=torch.float32) for p, c in (host, card)]
    log(f"[ANCHOR] tiny-random-deepseek EvoPress (small search, fp32): card {masks[1]}, host "
        f"{masks[0]}")
    if masks[0] != masks[1]:
        raise AssertionError("EvoPress on the card chose other masks than on the host")
    prompts = [np.arange(5) % 500 + 1, np.asarray([7, 9]), np.arange(40) * 7 % 500]
    paged = mla_paged_generate(card[0], card[1], prompts, max_new_tokens=12, page_size=16,
                               cache_dtype=torch.float32)
    contiguous = [deepseek_generate(card[0], card[1], p, max_new_tokens=12,
                                    compute_dtype=torch.float32) for p in prompts]
    same = all(a.tolist() == b.tolist() for a, b in zip(paged, contiguous))
    log(f"[ANCHOR] tiny-random-deepseek paged MLA greedy tokens on the card == contiguous "
        f"deepseek_generate: {same}")
    if not same:
        raise AssertionError("paged MLA tokens differ from deepseek_generate's on the card")


# ------------------------------------------- mixture of experts and training ---

# mistralai/Mixtral-8x7B-v0.1 config.json (the fields the loader reads)
MIXTRAL_HF = {
    "model_type": "mixtral", "vocab_size": 32000, "hidden_size": 4096, "num_hidden_layers": 32,
    "num_attention_heads": 32, "num_key_value_heads": 8, "intermediate_size": 14336,
    "num_local_experts": 8, "num_experts_per_tok": 2, "rms_norm_eps": 1e-5, "rope_theta": 1e6,
    "sliding_window": None, "router_aux_loss_coef": 0.02, "max_position_embeddings": 32768,
    "tie_word_embeddings": False,
}
MOE_SERVE_LAYERS = 8     # Mixtral depth cut of the served and generated runs (11.87 B parameters)
MOE_CLI_LAYERS = 4       # ... of the main_llm runs (the served model's first 4 layers)
MOE_TRAIN_LAYERS = 2     # ... of the training run (3.16 B parameters, bf16 AdamW moments)
DEEPSEEK_TRAIN_EXPERTS = 32   # V3's 256 routed experts cut so weights, grads and moments fit
def make_mixtral(device, layers: int):
    """(params, cfg) at Mixtral-8x7B's published widths (``config_from_hf_dict``
    of its config.json), depth cut to ``layers``; random bf16 weights made on
    the card from a seed."""
    import dataclasses

    import torch

    from ssp_x_vit_tpu_torch.llm.checkpoints import config_from_hf_dict
    from ssp_x_vit_tpu_torch.llm.model import init_llama_params

    cfg = dataclasses.replace(config_from_hf_dict(MIXTRAL_HF), num_layers=layers)
    gen = torch.Generator(device=device)
    gen.manual_seed(4)
    t0 = time.perf_counter()
    params = init_llama_params(gen, cfg, dtype=torch.bfloat16, device=device)
    torch.cuda.synchronize()
    n = sum(v.numel() for v in _flat(params).values())
    experts = sum(params["blocks"][k].numel() for k in ("gate_kernel", "up_kernel", "down_kernel"))
    log(f"[MOE] Mixtral-8x7B widths, {layers} layers (8 experts, top-2): {n / 1e9:.3f} B "
        f"parameters ({experts / 1e9:.3f} B in the experts) in bf16 made on the card in "
        f"{time.perf_counter() - t0:.2f} s ({torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB "
        f"allocated)")
    return params, cfg


def _first_layers(params, cfg, n: int):
    """The first ``n`` layers of a stacked llama tree (views) and their config."""
    import dataclasses

    out = {k: v for k, v in params.items() if k != "blocks"}
    out["blocks"] = {k: v[:n] for k, v in params["blocks"].items()}
    return out, dataclasses.replace(cfg, num_layers=n)


class _Routing:
    """Wraps ``parallel.moe._top_k`` (the top-k of the dropless MoE) while
    entered. ``rows``: when set, a callable that files each call's chosen
    experts ``[T, k]``. ``pins``: a list of ``[T, k]`` expert tensors that
    the next calls take in order instead of their own choice, weighted as the
    router weights its own (its probabilities at the pinned experts,
    renormalized); ``moved`` counts the calls whose own choice differed."""

    def __init__(self):
        self.rows, self.pins, self.moved = None, [], 0

    def __enter__(self):
        from ssp_x_vit_tpu_torch.parallel import moe

        self._moe, self._orig = moe, moe._top_k
        moe._top_k = self._top_k
        return self

    def __exit__(self, *exc):
        self._moe._top_k = self._orig

    def _top_k(self, probs, k):
        import torch

        gates, experts = self._orig(probs, k)
        if self.rows is not None:
            self.rows(experts)
        if not self.pins:
            return gates, experts
        pin = self.pins.pop(0)
        if torch.equal(experts.sort(dim=-1).values, pin.sort(dim=-1).values):
            return gates, experts
        self.moved += 1
        gates = torch.gather(probs, 1, pin)
        return gates / gates.sum(dim=-1, keepdim=True), pin


class _ServedRouting(_Routing):
    """``_Routing`` that files what a ``PagedServer`` chose, by request: while
    entered, the server's prefills and decode blocks are watched; ``prefill``
    maps a prompt (a tuple) to its prefill's per-call choices, ``decode`` a
    prompt to its slot's row ``[1, k]`` of every decode call (layer by layer,
    step by step; the steps of a block after the request ended come last)."""

    def __enter__(self):
        from ssp_x_vit_tpu_torch.llm import paged

        self.prefill, self.decode = {}, {}
        cls = self._cls = paged.PagedServer
        self._saved = {n: getattr(cls, n) for n in ("_prefill", "_decode", "_decode_multi")}
        watcher = self

        def prefill(srv, prompt, pt, m):
            key = tuple(int(t) for t in prompt)
            watcher.prefill[key] = []
            watcher.rows = watcher.prefill[key].append
            try:
                return watcher._saved["_prefill"](srv, prompt, pt, m)
            finally:
                watcher.rows = None

        def decoding(name):
            def run(srv, tokens, *rest):
                keys = [tuple(s.prompt) if s.active else None for s in srv.slots]

                def file(experts):
                    for i, key in enumerate(keys):
                        if key is not None:
                            watcher.decode.setdefault(key, []).append(experts[i:i + 1])

                watcher.rows = file
                try:
                    return watcher._saved[name](srv, tokens, *rest)
                finally:
                    watcher.rows = None
            return run

        cls._prefill, cls._decode, cls._decode_multi = (
            prefill, decoding("_decode"), decoding("_decode_multi"))
        return super().__enter__()

    def __exit__(self, *exc):
        for n, f in self._saved.items():
            setattr(self._cls, n, f)
        return super().__exit__(*exc)


def _moe_check_alone(params, cfg, device, requests, responses, routing, cache_dtype, chunked,
                     label) -> None:
    """Each served greedy request against its prompt run alone, routed as the
    served run routed it (``_alone_gaps``): the served token within 5e-2
    of max(1, max |logit|) of the alone run's best logit at every step. The
    batch of 8 rounds bf16 elsewhere than a run alone, which can flip a
    near-tie of the top-2 router; the flips are counted."""
    exact = total = moved = calls = 0
    worst = 0.0
    for req, r in zip(requests, responses):
        same, gap, peak, k = _alone_gaps(params, cfg, req["prompt"], r["tokens"], cache_dtype,
                                         device, routing, chunked)
        exact, total, moved = exact + same, total + len(r["tokens"]), moved + k
        calls += (len(r["tokens"]) - 1) * cfg.num_layers
        worst = max(worst, gap / max(1.0, peak))
    log(f"[SERVE] {label}: each prompt alone, routed as served ({moved} of {calls} decode-step "
        f"MoE calls would have picked other experts alone): {exact} of {total} served tokens are "
        f"the alone argmax; worst logit gap {worst:.3e} of max(1, max |logit|), tol 5e-2")
    if worst > 5e-2:
        raise AssertionError(f"{label}: a served token is not the best token of its prompt alone")


def _moe_generate_alone(params, cfg, device, outs, lens, p_pad, routing, limit: int) -> tuple:
    """The first ``limit`` tokens of each row of a b=8 ``generate_kv_scan``
    alone at b=1 (``serve.prefill`` of the unpadded prompt, then
    ``decode_step`` fed the batch's tokens), each MoE layer routed as the
    batch routed that row: the prefill's choices at the row's unpadded
    positions, each decode call's choice for the row. Returns (exact, total,
    worst gap over max(1, max |logit|), moved calls)."""
    import torch

    from ssp_x_vit_tpu_torch.llm import serve

    L = cfg.num_layers
    calls = routing.calls
    b = len(outs)
    exact = total = moved = 0
    worst = 0.0
    for i, (seq, n) in enumerate(zip(outs, lens)):
        gen = min(len(seq) - n, limit)
        pins = [calls[l].reshape(b, p_pad, -1)[i, p_pad - n:] for l in range(L)]
        pins += [calls[L + j][i:i + 1] for j in range((gen - 1) * L)]
        toks = torch.as_tensor(seq.astype("int64"), device=device)
        ck, cv = serve.init_cache(cfg, 1, len(seq), torch.bfloat16, device)
        pads = torch.zeros(1, dtype=torch.int64, device=device)
        with _Routing() as pinned:
            pinned.pins = pins
            logits = serve.prefill(params, toks[None, :n], ck, cv, cfg, pads)[0][0]
            for t in range(gen):
                chosen = toks[n + t]
                gap = float(logits.max() - logits[chosen]) / max(1.0, float(logits.abs().max()))
                exact, total, worst = exact + (gap == 0), total + 1, max(worst, gap)
                if t + 1 < gen:
                    logits = serve.decode_step(params, chosen[None], ck, cv, cfg, n + t, pads)[0][0]
            moved += pinned.moved
        del ck, cv
    return exact, total, worst, moved


def _moe_generate(params, cfg, device) -> dict:
    """``generate_kv_scan`` at b=8 on left-padded prompts of 64-512 tokens, up
    to max_length 528 (16 new tokens on the longest prompt, 463 decode steps
    for the shortest; greedy, bf16 cache); the first 32 tokens of every row
    held to the same sequence run alone at b=1, routed as the batch routed it
    (``_moe_generate_alone``; within 5e-2 of max(1, max |logit|) of the best
    logit). Returns the launches."""
    import numpy as np
    import torch

    from ssp_x_vit_tpu_torch.llm.datasets import synthetic_token_stream
    from ssp_x_vit_tpu_torch.llm.serve import bucket_prompt_pad, generate_kv_scan
    from ssp_x_vit_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    rng = np.random.default_rng(37)
    lo, hi = GEN_PROMPTS
    lens = [lo, hi] + sorted(rng.integers(lo + 1, hi, 6).tolist())
    stream = synthetic_token_stream(sum(lens), cfg.vocab_size, seed=39).reshape(-1)
    cuts = np.cumsum([0] + lens)
    prompts = [stream[cuts[i]:cuts[i + 1]].astype(np.int64) for i in range(len(lens))]
    max_length = hi + 16
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    with _Routing() as routing:
        routing.calls = []
        routing.rows = routing.calls.append
        t0 = time.perf_counter()
        outs = generate_kv_scan(params, cfg, prompts, max_length=max_length,
                                cache_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = dict(launch_counts)
    steps = max_length - lo - 1
    n_gen = sum(len(o) - n for o, n in zip(outs, lens))
    log(f"[MOE] generate_kv_scan b=8, prompts of {lo}-{hi} tokens (left-padded), max_length "
        f"{max_length}: {steps} decode steps, {n_gen} tokens kept in {seconds:.2f} s = "
        f"{n_gen / seconds:.1f} tokens/s ({8 * (steps + 1) / seconds:.1f} counting every row's "
        f"step; the b=8 prefill of 8 x {hi} tokens included); peak "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB; launches "
        f"{json.dumps({k: v for k, v in launches.items() if v})}")
    for o, p in zip(outs, prompts):
        if len(o) != max_length or not (o[:len(p)] == p).all() or \
                not ((0 <= o) & (o < cfg.vocab_size)).all():
            raise AssertionError("MoE generate_kv_scan: a row is not its prompt + tokens")
    exact, total, worst, moved = _moe_generate_alone(params, cfg, device, outs, lens,
                                                     bucket_prompt_pad(hi), routing, 32)
    log(f"[MOE] generate_kv_scan b=8: the first 32 tokens of each row alone at b=1, routed as "
        f"the batch routed it ({moved} of {8 * 31 * cfg.num_layers} decode-step MoE calls would "
        f"have picked other experts alone): {exact} of {total} tokens are the alone argmax; "
        f"worst logit gap "
        f"{worst:.3e} of max(1, max |logit|), tol 5e-2")
    if worst > 5e-2:
        raise AssertionError("MoE generate_kv_scan: a batch token is not the best token alone")
    return launches


def _deepseek_train(device) -> None:
    """``Trainer`` on DeepSeek-V3 widths cut to 4 layers (3 dense + 1 MoE) and
    ``DEEPSEEK_TRAIN_EXPERTS`` routed experts, params made on the card (the
    e_score_correction biases nonzero): b=1, s=2048, remat, bf16,
    ``TRAIN_UPDATES`` updates with weight decay; every loss finite and every
    ``e_bias`` bit for bit unchanged. Then ``cli.train_llm`` on
    ``tiny-random-deepseek`` on the card."""
    import dataclasses
    import math

    import torch

    from ssp_x_vit_tpu_torch.cli import train_llm
    from ssp_x_vit_tpu_torch.llm.datasets import synthetic_token_stream
    from ssp_x_vit_tpu_torch.llm.deepseek import config_from_hf_deepseek, init_deepseek_params
    from ssp_x_vit_tpu_torch.llm.trainer import TrainConfig, Trainer

    cfg = dataclasses.replace(config_from_hf_deepseek(DEEPSEEK_V3_HF), num_layers=DEEPSEEK_LAYERS,
                              n_routed_experts=DEEPSEEK_TRAIN_EXPERTS)
    gen = torch.Generator(device=device)
    gen.manual_seed(6)
    params = init_deepseek_params(gen, cfg, dtype=torch.bfloat16, device=device)
    bias = params["moe_blocks"]["e_bias"]
    bias.copy_((torch.rand(bias.shape, generator=gen, device=device) - 0.5) * 0.1)
    before = bias.clone()
    n = sum(v.numel() for v in _flat(params).values())
    stream = synthetic_token_stream(TRAIN_UPDATES * 2049, cfg.vocab_size, seed=8)
    batches = list(stream.reshape(TRAIN_UPDATES, 1, 2049))
    tc = TrainConfig(total_steps=TRAIN_UPDATES, weight_decay=0.1, log_every=1)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, hist = Trainer(cfg, tc).fit(params, batches, verbose=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    elapsed = [h["tokens_seen"] / h["tok_per_s"] for h in hist]
    per_update = [b - a for a, b in zip([0.0] + elapsed[:-1], elapsed)]
    same = torch.equal(params["moe_blocks"]["e_bias"], before)
    log(f"[MOE] DeepSeek-V3 widths trained through Trainer: {cfg.num_layers} layers "
        f"({cfg.n_dense_layers} dense + {cfg.n_moe_layers} MoE), {cfg.n_routed_experts} routed "
        f"experts of 256, {n / 1e9:.3f} B bf16 parameters, bf16 AdamW moments, b=1 s=2048 remat: "
        f"{seconds:.1f} s; losses {[h['loss'] for h in hist]}; s/update "
        f"{', '.join(f'{t:.3f}' for t in per_update)}; {2048 / per_update[-1]:.0f} tokens/s at "
        f"the last update; peak {torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB; e_bias "
        f"unchanged bit for bit: {same}")
    if len(hist) != TRAIN_UPDATES or not all(math.isfinite(h["loss"]) for h in hist) or not same:
        raise AssertionError(f"DeepSeek training: losses {[h['loss'] for h in hist]}, e_bias "
                             f"unchanged {same}")
    del params, batches
    torch.cuda.empty_cache()

    argv = ["--model", "tiny-random-deepseek", "--steps", str(TRAIN_UPDATES), "--batch-size", "2",
            "--seq-len", "64", "--synthetic-data", "--log-every", "1", "--backend", "cuda"]
    before = train_llm._load_any("tiny-random-deepseek", 0, device)[0]["moe_blocks"]["e_bias"]
    out = train_llm.run(train_llm.build_argparser().parse_args(argv))
    losses = [h["loss"] for h in out["history"] if "loss" in h]
    same = torch.equal(out["params"]["moe_blocks"]["e_bias"], before)
    log(f"[MOE] train_llm {' '.join(argv)}: losses {losses}, e_bias unchanged {same}")
    if len(losses) != TRAIN_UPDATES or not all(math.isfinite(x) for x in losses) or not same:
        raise AssertionError("train_llm on tiny-random-deepseek on the card")


def phase_moe(device) -> dict:
    """Mixtral-8x7B widths (random bf16 weights made on the card): through
    ``cli.main_llm.run`` on the first 4 layers dense perplexity and
    ``--quantize int4`` (row 10 must launch); the 8-layer model served over
    HTTP with bf16 pools and with int8 pools and chunked prefill (12 requests,
    prompts of 64-512 tokens, 16 greedy tokens each; the write-and-attend
    kernel once per layer and decode step, no other paged kernel; each token
    held to its prompt run alone and routed as served), a decode-step
    measurement, and
    ``generate_kv_scan`` at b=8; then training: ``train_llm`` at Mixtral
    widths and ``Trainer`` at DeepSeek-V3 widths. Returns launches per kernel."""
    import dataclasses
    import math

    import torch

    from ssp_x_vit_tpu_torch.llm.checkpoints import config_from_hf_dict, config_to_dict
    from ssp_x_vit_tpu_torch.llm.datasets import synthetic_token_stream
    from ssp_x_vit_tpu_torch.ops.kernels import KERNEL_NAMES

    totals = {name: 0 for name in KERNEL_NAMES}

    def add(counts):
        for k in KERNEL_NAMES:
            totals[k] += counts.get(k, 0)

    parts = {}
    t0 = time.perf_counter()
    params, cfg = make_mixtral(device, MOE_SERVE_LAYERS)
    cli_model = _first_layers(params, cfg, MOE_CLI_LAYERS)
    common = ["--model", "mixtral-8x7b-width", "--synthetic-data", "--seq-len", "256",
              "--num-calibration", "2", "--backend", "cuda", "--evaluate_perplexity",
              "--logging", "WARNING"]
    out, counts, _, _ = _main_llm_run(f"dense, {MOE_CLI_LAYERS} layers", common + ["--dense"],
                                cli_model, "MOE")
    dense = out["dense"]["ppl"]
    add(counts)
    if not math.isfinite(dense) or counts["flash_attention"] <= 0:
        raise AssertionError(f"MoE dense ppl {dense}, flash launches {counts['flash_attention']}")
    out, counts, _, _ = _main_llm_run(f"int4, {MOE_CLI_LAYERS} layers",
                                common + ["--dense", "--quantize", "int4"], cli_model, "MOE")
    add(counts)
    ppl4 = out["dense"]["ppl"]
    log(f"[MOE] Mixtral-8x7B widths ({MOE_CLI_LAYERS} layers): dense ppl {dense:.2f}, int4 ppl "
        f"{ppl4:.2f} (10 windows of 256); quant4_matmul launches {counts['quant4_matmul']}")
    if counts["quant4_matmul"] <= 0:
        raise AssertionError("quant4_matmul (row 10) did not launch in the Mixtral int4 run")
    if not math.isfinite(ppl4) or abs(math.log(ppl4) - math.log(dense)) > 0.05 * math.log(dense):
        raise AssertionError(f"Mixtral int4 perplexity {ppl4} vs dense {dense}")
    del cli_model
    torch.cuda.empty_cache()
    parts["make + main_llm dense, int4"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    stream = [int(t) for t in synthetic_token_stream(8192, cfg.vocab_size, seed=13).reshape(-1)]
    lens = (64, 512, 130, 257, 320, 77, 448, 200, 96, 384, 150, 500)
    requests = [dict(prompt=stream[600 * i:600 * i + n], max_tokens=16, temperature=0)
                for i, n in enumerate(lens)]
    for flags, label, cache_dtype, chunked, kernel in (
            ([], "bf16 pools", torch.bfloat16, None, "paged_attention_write"),
            (["--kv-dtype", "int8", "--chunked-prefill", "128"], "int8 pools, chunked prefill 128",
             torch.int8, 128, "paged_attention_write_q8")):
        label = f"Mixtral-8x7B widths, {MOE_SERVE_LAYERS} layers, {label}"
        with _ServedRouting() as routing:
            run = _serve(params, cfg, device, flags, requests, label)
        _expect_decode_launches(label, run, cfg, (kernel,))
        log(f"[SERVE] {label}: {kernel} launches {run['launches'][kernel]} = {cfg.num_layers} "
            f"layers x {run['decode_steps']} decode steps; no other paged kernel")
        add(run["launches"])
        _moe_check_alone(params, cfg, device, requests, run["responses"], routing, cache_dtype,
                         chunked, label)
    log(f"[SERVE] Mixtral-8x7B widths, {MOE_SERVE_LAYERS} layers, decode measurement:")
    measure_decode(params, cfg, device)
    parts["served (bf16, int8 pools) + decode measurement"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    add(_moe_generate(params, cfg, device))
    parts["generate_kv_scan b=8"] = time.perf_counter() - t0
    del params
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    mixtral = dataclasses.replace(config_from_hf_dict(MIXTRAL_HF), num_layers=MOE_TRAIN_LAYERS)
    out, counts = train_cli_run(config_to_dict(mixtral),
                                f"Mixtral-8x7B widths, {MOE_TRAIN_LAYERS} layers", "MOE")
    add(counts)
    del out
    torch.cuda.empty_cache()
    parts["train_llm, Mixtral widths"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _deepseek_train(device)
    parts["Trainer, DeepSeek-V3 widths + train_llm tiny"] = time.perf_counter() - t0
    log(f"[MOE] seconds by part {json.dumps({k: round(v, 1) for k, v in parts.items()})}")
    return totals


def _served_margin_check(label, got, ref, start, host, cfg) -> int:
    """Tokens of ``got`` from ``start`` equal to ``ref`` before the first
    difference; at a difference the host's own top-2 logit margin (fp32,
    ``full_logits``, any family) must be under 1e-3, else it raises."""
    import torch

    from ssp_x_vit_tpu_torch.llm.generate import full_logits

    if list(got) == list(ref):
        return len(ref) - start
    at = next(i for i, (x, y) in enumerate(zip(got, ref)) if x != y)
    with torch.no_grad():
        logits = full_logits(host, torch.tensor([list(ref[:at])]), cfg, torch.float32)[0, -1]
    top2 = logits.topk(2).values
    margin = float(top2[0] - top2[1])
    log(f"[ANCHOR] {label}: token {at - start} differs from the host's where the host's top-2 "
        f"margin is {margin:.2e}")
    if margin > 1e-3:
        raise AssertionError(f"{label}: served tokens differ from the host CPU's")
    return at - start


def phase_anchor_moe(device) -> None:
    """Tiny llama-MoE models (top-1 and top-2) and ``tiny-random-deepseek`` /
    ``-dense`` in fp32, card against the host CPU: the first update's
    gradients (1e-4 of max(1, max |grad|)), three ``Trainer`` updates' losses
    (1e-4 relative) and greedy tokens served with fp32 pools (``paged_generate``
    / ``mla_paged_generate``) token for token, except after a host top-2 logit
    margin under 1e-3."""
    import numpy as np
    import torch

    from ssp_x_vit_tpu_torch.cli import main_llm
    from ssp_x_vit_tpu_torch.llm.model import LlamaConfig, init_llama_params
    from ssp_x_vit_tpu_torch.llm.paged import paged_generate
    from ssp_x_vit_tpu_torch.llm.paged_mla import mla_paged_generate
    from ssp_x_vit_tpu_torch.llm.train import next_token_loss, trainable_tree
    from ssp_x_vit_tpu_torch.llm.trainer import TrainConfig, Trainer

    models = {}
    for top_k in (1, 2):
        cfg = LlamaConfig(vocab_size=512, hidden_size=64, num_layers=4, num_heads=4,
                          num_kv_heads=2, intermediate_size=96, num_experts=4, moe_top_k=top_k)
        gen = torch.Generator().manual_seed(10 + top_k)
        models[f"tiny MoE top-{top_k}"] = (init_llama_params(gen, cfg, device="cpu"), cfg)
    for name in ("tiny-random-deepseek", "tiny-random-deepseek-dense"):
        models[name] = main_llm.load_model(main_llm.build_argparser().parse_args(
            ["--model", name, "--backend", "cpu"]), torch.device("cpu"))
    rng = np.random.default_rng(12)
    prompts = [rng.integers(1, 500, n).tolist() for n in (5, 17, 40)]
    for name, (host, cfg) in models.items():
        card = _tree_to(host, device)
        toks = rng.integers(0, cfg.vocab_size, (4, 65)).astype(np.int32)
        grads = {}
        for place, tree in (("card", card), ("host", host)):
            t, leaves = trainable_tree(_clone_tree(tree))
            next_token_loss(t, torch.from_numpy(toks).long().to(tree["embed"].device), cfg,
                            compute_dtype=torch.float32).backward()
            grads[place] = [(leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)).cpu()
                            for leaf in leaves]
        scale = max(1.0, max(g.abs().max().item() for g in grads["host"]))
        gerr = max((a - b).abs().max().item()
                   for a, b in zip(grads["card"], grads["host"])) / scale
        losses = {}
        batches = [rng.integers(0, cfg.vocab_size, (4, 65)).astype(np.int32) for _ in range(3)]
        for place, tree in (("card", card), ("host", host)):
            tc = TrainConfig(learning_rate=1e-3, total_steps=3, compute_dtype="float32",
                             log_every=1)
            _, hist = Trainer(cfg, tc).fit(_clone_tree(tree), batches,
                                           verbose=False)
            losses[place] = [h["loss"] for h in hist]
        lerr = max(abs(a - b) / abs(b) for a, b in zip(losses["card"], losses["host"]))
        if name.startswith("tiny-random-deepseek"):
            gen_fn = lambda p: mla_paged_generate(p, cfg, prompts, max_new_tokens=16,
                                                  page_size=16, cache_dtype=torch.float32)
        else:
            gen_fn = lambda p: paged_generate(p, cfg, prompts, max_new_tokens=16, page_size=16,
                                              cache_dtype=torch.float32)
        served = [list(map(int, o)) for o in gen_fn(card)]
        ref = [list(map(int, o)) for o in gen_fn(host)]
        checked = sum(_served_margin_check(name, g, r, len(p), host, cfg)
                      for g, r, p in zip(served, ref, prompts))
        log(f"[ANCHOR] {name} fp32: first-update grads card vs host CPU scaled {gerr:.3e} (tol "
            f"1e-4); 3 updates' losses card {losses['card']} host {losses['host']} (max rel "
            f"{lerr:.3e}, tol 1e-4); served tokens (fp32 pools) equal on {checked} of "
            f"{16 * len(prompts)}")
        if gerr > 1e-4 or lerr > 1e-4 or len(losses["card"]) != 3:
            raise AssertionError(f"{name}: training on the card disagrees with the host CPU")


# ------------------------------------------------- local corpora, multi-LoRA ---

LORA_RANK = 16
LORA_IDS = (0, 1, 2, 3, 0, 1, 2, 3)       # 3 adapters and the base model, twice
LORA_STEPS = 64
LORA_PROMPTS = (448, 480)   # 64 decode steps keep 33-65 tokens per row (max_length 513)
LOCAL_LAYERS = 4            # Llama-2-7B widths cut to 4 layers for main_llm --local_datasets
CORPUS_NAMES = ("wikitext2", "c4_val", "fineweb_edu", "c4_train")


def _arrow_corpus():
    """``scripts/arrow_corpus.py``: the plain-Python ``save_to_disk`` writer."""
    import importlib.util

    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        "arrow_corpus", os.path.join(here, "scripts", "arrow_corpus.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _code_llm_small() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "ckpts", "code_llm_small")


def _decoded_documents(split: str, start: int = 0, stop=None) -> list:
    """Committed ids ``corpus_slice/<split>.bin[start:stop]`` decoded with the
    code tokenizer and cut into documents at blank lines."""
    import numpy as np

    from ssp_x_vit_tpu_torch.llm.tokenizer import load_tokenizer

    ids = np.fromfile(os.path.join(_code_llm_small(), "corpus_slice", f"{split}.bin"), np.uint16)
    text = load_tokenizer(_code_llm_small()).decode(ids[start:stop].tolist())
    return _arrow_corpus().documents(text)


def write_corpora(work: str, corpora: dict) -> float:
    """``corpora`` (name -> texts) as ``save_to_disk`` directories under
    ``work/data``; returns the seconds."""
    writer = _arrow_corpus()
    t0 = time.perf_counter()
    for name, texts in corpora.items():
        writer.write_dataset(os.path.join(work, "data", name), texts)
    return time.perf_counter() - t0


def phase_corpus(work: str) -> dict:
    """[CORPUS]: ``corpus_slice/val.bin`` and ``train.bin`` (131072 ids each)
    decoded with ``ckpts/code_llm_small/tokenizer.json`` and cut into documents
    at blank lines; wikitext2, c4_val and fineweb_edu take the val documents,
    c4_train the train documents, written under ``work/data`` by
    ``scripts/arrow_corpus.py`` and read back through ``llm/datasets.py``
    (``llm/arrow_ipc.py``): the texts must equal what was written. Returns
    name -> texts."""
    from ssp_x_vit_tpu_torch.llm import datasets as D

    t0 = time.perf_counter()
    docs = {split: _decoded_documents(split) for split in ("val", "train")}
    decode_s = time.perf_counter() - t0
    corpora = {"wikitext2": docs["val"], "c4_val": docs["val"], "fineweb_edu": docs["val"],
               "c4_train": docs["train"]}
    write_s = write_corpora(work, corpora)
    loaders = {"wikitext2": D.load_wikitext2, "c4_val": D.load_c4,
               "fineweb_edu": D.load_fineweb_edu,
               "c4_train": lambda d: D.load_c4(d, split="train")}
    for name, texts in corpora.items():
        path = os.path.join(work, "data", name)
        nbytes = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
        t0 = time.perf_counter()
        got = loaders[name](path)
        read_s = time.perf_counter() - t0
        log(f"[CORPUS] {name}: {len(texts)} documents, {nbytes / 1e6:.3f} MB on disk, read by "
            f"llm/datasets.py in {read_s:.4f} s ({nbytes / 1e6 / read_s:.1f} MB/s)")
        if got != texts:
            raise AssertionError(f"{name}: the texts read back differ from those written")
    log(f"[CORPUS] val.bin and train.bin decoded and cut into documents at blank lines in "
        f"{decode_s:.2f} s ({len(docs['val'])} / {len(docs['train'])} documents); 4 directories "
        f"written by scripts/arrow_corpus.py in {write_s:.2f} s; every text read back equal")
    return corpora


def _phase_seconds(out) -> str:
    return json.dumps({k: round(v, 3) for k, v in out["phase_seconds"].items()})


def phase_local(device, work: str) -> dict:
    """[LOCAL]: random bf16 weights at Llama-2-7B widths cut to 4 layers,
    saved as a native directory with the code tokenizer's ``tokenizer.json``
    beside them (its ids lie below 8192, the vocabulary is 32000), then
    ``main_llm --local_datasets`` 25% 2SSP with dense and pruned perplexity
    (s=2048, 16 calibration windows, 8 for 2SSP, as the synthetic CLI run)
    from ``work`` (the current directory, holding ./data): the run must
    report the local corpora, reach 25% within 0.02 and launch flash in every
    phase that runs attention. Returns the run's launches."""
    import math
    import shutil

    import torch

    from ssp_x_vit_tpu_torch.cli import main_llm
    from ssp_x_vit_tpu_torch.llm.checkpoints import save_llm_model
    from ssp_x_vit_tpu_torch.llm.model import LlamaConfig, init_llama_params
    from ssp_x_vit_tpu_torch.ops.kernels import KERNEL_NAMES, launch_counts, reset_launch_counts

    cfg = LlamaConfig(**dict(LLAMA_2_7B, num_layers=LOCAL_LAYERS))
    gen = torch.Generator(device=device)
    gen.manual_seed(5)
    params = init_llama_params(gen, cfg, dtype=torch.bfloat16, device=device)
    model_dir = os.path.join(work, "llama-2-7b-width-4-layers")
    t0 = time.perf_counter()
    save_llm_model(model_dir, params, cfg)
    shutil.copy(os.path.join(_code_llm_small(), "tokenizer.json"), model_dir)
    save_s = time.perf_counter() - t0
    nbytes = os.path.getsize(os.path.join(model_dir, "model.npz"))
    del params
    torch.cuda.empty_cache()
    argv = ["--model", model_dir, "--local_datasets", "--seq-len", "2048", "--num-calibration",
            "16", "--num-calibration-2ssp", "8", "--backend", "cuda", "--evaluate_perplexity",
            "--dense", "--pruning_method", "2ssp", "--sparsity_rate", "0.25", "--logging",
            "WARNING"]
    log(f"[LOCAL] Llama-2-7B widths, {LOCAL_LAYERS} layers: save_llm_model {nbytes / 1e9:.3f} GB "
        f"bf16 in {save_s:.2f} s; main_llm {' '.join(argv)}")
    reset_launch_counts()
    t0 = time.perf_counter()
    out = main_llm.run(main_llm.build_argparser().parse_args(argv))
    seconds = time.perf_counter() - t0
    counts = {name: launch_counts[name] for name in KERNEL_NAMES}
    (entry,) = out["runs"]
    dense, pruned = out["dense"]["ppl"], entry["ppl"]
    flash = {ph: c["flash_attention"] for ph, c in out["kernel_launches"].items()
             if c["flash_attention"]}
    log(f"[LOCAL] main_llm --local_datasets: {seconds:.1f} s, corpora {out['corpora']}; seconds "
        f"by phase {_phase_seconds(out)}; flash_attention launches by phase {json.dumps(flash)}")
    log(f"[LOCAL] dense ppl {dense:.3f}, after 25% 2SSP {pruned:.3f}; pruned attention "
        f"{entry['pruned_attention_blocks']}, kept FFN width {entry['num_preserve_mlp']} of "
        f"{cfg.intermediate_size}, achieved sparsity {entry['achieved_sparsity']:.4f}")
    if out["corpora"] != "local":
        raise AssertionError(f"main_llm --local_datasets used the {out['corpora']} streams")
    if not (math.isfinite(dense) and math.isfinite(pruned)):
        raise AssertionError(f"non-finite perplexity: dense {dense}, pruned {pruned}")
    if abs(entry["achieved_sparsity"] - 0.25) > 0.02:
        raise AssertionError(f"achieved sparsity {entry['achieved_sparsity']} vs 0.25")
    for phase in ("stats", "candidates", "evaluation"):
        if out["kernel_launches"][phase]["flash_attention"] <= 0:
            raise AssertionError(f"flash_attention not launched in the {phase} phase")
    return counts


def phase_train_data(work: str, corpora: dict) -> dict:
    """[TRAIN]: ``train_llm --data <dir>`` at Llama-2-7B width and depth (b=1,
    s=2048, remat, 4 updates; ``train_cli_run``'s checks: finite losses, flash
    / dq / dk-dv launches 32 x updates x 2 / x 1 / x 1) on the c4_train
    documents with the code tokenizer beside them; the first microbatch the
    CLI cuts must equal the host tokenization of the directory's text.
    Returns the run's launches."""
    import shutil

    import numpy as np

    from ssp_x_vit_tpu_torch.cli import train_llm
    from ssp_x_vit_tpu_torch.llm.datasets import tokenize_corpus
    from ssp_x_vit_tpu_torch.llm.model import LlamaConfig
    from ssp_x_vit_tpu_torch.llm.tokenizer import load_tokenizer

    data = os.path.join(work, "train_corpus")
    _arrow_corpus().write_dataset(data, corpora["c4_train"])
    shutil.copy(os.path.join(_code_llm_small(), "tokenizer.json"), data)
    args = train_llm.build_argparser().parse_args(
        ["--data", data, "--steps", str(TRAIN_UPDATES), "--batch-size", "1", "--seq-len", "2048"])
    t0 = time.perf_counter()
    batches, stream = train_llm._token_batches(args, LlamaConfig(**LLAMA_2_7B))
    cut_s = time.perf_counter() - t0
    want = tokenize_corpus(corpora["c4_train"], load_tokenizer(data)).reshape(-1)[:2049]
    if not np.array_equal(np.asarray(batches[0]).reshape(-1), want):
        raise AssertionError("train_llm --data: the first microbatch is not the host "
                             "tokenization of the directory's text")
    log(f"[TRAIN] --data {len(corpora['c4_train'])} documents -> {stream.size} tokens, "
        f"{len(batches)} microbatches of 1 x 2049 in {cut_s:.2f} s (read + tokenize); the "
        f"first == the host tokenization of the texts")
    _, counts = train_cli_run(LLAMA_2_7B, "Llama-2-7B width on --data (local corpus)", "TRAIN",
                              data=data)
    return counts


# ------------------------------------------------------------------ A.10f ---
# SentencePiece-style and Split-pattern tokenizers (llm/hf_tokenizer.py,
# llm/spm_model.py): the committed fixtures of tests/fixtures/tokenizers
# reproduced on this host, which has no tokenizers library, then the text
# paths on the Llama-2-style one.

SPM_FIXTURES = ("llama2", "qwen_split", "unigram")
SPM_TRAIN_UPDATES = 2
SPM_SERVE_TOKENS = 24
SPM_QUALITATIVE_LENGTH = 48


def _fixture_dir(name: str) -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures",
                        "tokenizers", name)


def check_tokenizer_fixtures() -> None:
    """[SPM] host fixtures: every committed fixture (``expected.json``, written
    by ``scripts/make_tokenizer_fixtures.py`` from the ``tokenizers`` library)
    encodes its fixed texts, with and without special tokens, to the committed
    ids and decodes them to the committed text; the whole decoded ``val.bin``
    text (one string) goes to the committed length and sha256 of the ids; then
    a 1,000,000-character string through the Llama-2-style fixture (no
    pre-tokenizer: one word for the heap merge). Seconds and tokens/s on this
    host's CPU."""
    import hashlib

    import numpy as np

    from ssp_x_vit_tpu_torch.llm.hf_tokenizer import HFTokenizer
    from ssp_x_vit_tpu_torch.llm.tokenizer import load_tokenizer

    ids = np.fromfile(os.path.join(_code_llm_small(), "corpus_slice", "val.bin"), np.uint16)
    text = load_tokenizer(_code_llm_small()).decode(ids.tolist())
    for name in SPM_FIXTURES:
        d = _fixture_dir(name)
        with open(os.path.join(d, "expected.json"), encoding="utf-8") as f:
            want = json.load(f)
        t0 = time.perf_counter()
        tok = load_tokenizer(d)
        load_s = time.perf_counter() - t0
        if not isinstance(tok, HFTokenizer):
            raise AssertionError(f"[SPM] {name}: load_tokenizer gave {type(tok).__name__}")
        for i, t in enumerate(want["texts"]):
            got = (tok(t)["input_ids"], tok(t, add_special_tokens=False)["input_ids"],
                   tok.decode(want["ids"][i]), tok.decode(want["ids"][i], skip_special_tokens=True))
            ref = (want["ids"][i], want["ids_plain"][i], want["decoded"][i],
                   want["decoded_skip"][i])
            if got != ref:
                raise AssertionError(f"[SPM] {name}: fixed text {i} ({t[:40]!r}) differs from "
                                     "the committed ids or text")
        specials = (tok.bos_token_id, tok.eos_token_id, tok.all_special_ids, tok.vocab_size)
        if specials != (want["bos_token_id"], want["eos_token_id"], want["all_special_ids"],
                        want["vocab_size"]):
            raise AssertionError(f"[SPM] {name}: special ids {specials}")
        t0 = time.perf_counter()
        val = tok(text, add_special_tokens=False)["input_ids"]
        enc_s = time.perf_counter() - t0
        digest = hashlib.sha256(np.asarray(val, "<i4").tobytes()).hexdigest()
        if len(val) != want["val"]["tokens"] or digest != want["val"]["sha256"]:
            raise AssertionError(f"[SPM] {name}: val text -> {len(val)} ids, sha256 {digest}")
        log(f"[SPM] fixture {name}: loaded in {load_s:.3f} s; {len(want['texts'])} fixed texts == "
            f"the committed ids (with / without special tokens) and text (skipping / keeping "
            f"them); val text ({len(text)} chars, one string) -> {len(val)} ids == the committed "
            f"length and sha256 in {enc_s:.3f} s = {len(val) / enc_s:.0f} tokens/s (host CPU)")
    tok = load_tokenizer(_fixture_dir("llama2"))
    big = (text * 3)[:1_000_000]
    t0 = time.perf_counter()
    n = len(tok.encode(big, add_special_tokens=False))
    big_s = time.perf_counter() - t0
    merger = tok.model.merger
    if merger.engine != "native" or merger.native_batches < 1:
        raise AssertionError("[SPM] the native heap merge was not the one in use")
    log(f"[SPM] llama2 fixture: a 1,000,000-character string (one word) -> {n} ids in "
        f"{big_s:.3f} s = {n / big_s:.0f} tokens/s by the heap merge (native/bpe_heap.cc)")


def _beam_tie_gap(host, cfg, prompt, a, b) -> float:
    """How far apart, on the host CPU, the two continuations' summed log
    probabilities lie up to and including their first differing token (the
    beam search's own bf16 compute)."""
    import torch

    from ssp_x_vit_tpu_torch.llm.generate import full_logits

    k = next((j for j in range(min(len(a), len(b))) if a[j] != b[j]), min(len(a), len(b)) - 1)

    def score(seq):
        with torch.no_grad():
            logits = full_logits(host, torch.tensor([prompt + seq[:k + 1]]), cfg, torch.bfloat16)
        logp = torch.log_softmax(logits[0].float(), dim=-1)
        return sum(float(logp[len(prompt) - 1 + j, seq[j]]) for j in range(k + 1))
    return abs(score(a) - score(b))


def phase_spm(device, work: str, corpora: dict) -> dict:
    """[SPM]: the fixtures (``check_tokenizer_fixtures``), then the text paths
    on the Llama-2-style fixture (``Prepend`` + ``Replace``, byte fallback,
    ``LlamaTokenizerFast``'s BOS) as the tokenizer of the ``[LOCAL]``
    directory (Llama-2-7B widths, 4 layers, random bf16 weights):

    - ``main_llm --local_datasets`` 25% 2SSP as ``[LOCAL]`` runs it: corpora
      ``local``, sparsity within 0.02, flash launched in every phase that
      runs attention;
    - ``serve_http`` on that directory (8 slots, bf16 pools): 4 text prompts
      cut from the val documents, each streamed and not, all at once: the
      prompt ids the engine gets are the tokenizer's, BOS first; streamed text
      == not streamed (all eight reach the engine at once, so twins decode in
      the same batched steps); ``paged_attention_write`` = 4 layers x decode steps
      and no other paged kernel; each token within 5e-2 of max(1, max
      |logit|) of its prompt run alone; the text is the incremental decode of
      the ids (``_StreamState``, as the JAX server decodes);
    - ``train_llm --data`` at Llama-2-7B width and depth (b=1, s=2048, remat,
      2 updates) on the ``[TRAIN]`` documents with that tokenizer: the first
      microbatch == the host tokenization; flash / dq / dk-dv = 32 x updates
      x 2 / x 1 / x 1;
    - ``qualitative_results`` on ``code_llm_small``'s weights (fp32) with the
      Qwen-style ``Split`` fixture (ids under its vocabulary of 8192): each
      answer is the decoded beam (5 beams, as the JAX package generates),
      which ends at ``max_length`` or at ``eos_token_id``, and equals the host
      CPU's, but where the two beams' host scores lie within 1e-3.

    Returns the kernel launches of the four runs."""
    import shutil
    import threading

    import numpy as np
    import torch

    from ssp_x_vit_tpu_torch.cli import main_llm, serve_http, train_llm
    from ssp_x_vit_tpu_torch.llm.checkpoints import load_llm_model
    from ssp_x_vit_tpu_torch.llm.datasets import tokenize_corpus
    from ssp_x_vit_tpu_torch.llm.generate import beam_generate, qualitative_results
    from ssp_x_vit_tpu_torch.llm.hf_tokenizer import HFTokenizer
    from ssp_x_vit_tpu_torch.llm.model import LlamaConfig
    from ssp_x_vit_tpu_torch.llm.server_http import _StreamState, create_server
    from ssp_x_vit_tpu_torch.llm.tokenizer import load_tokenizer
    from ssp_x_vit_tpu_torch.ops.kernels import KERNEL_NAMES, launch_counts, reset_launch_counts

    launches = {name: 0 for name in KERNEL_NAMES}

    def add(counts):
        for k in KERNEL_NAMES:
            launches[k] += counts[k]

    t0 = time.perf_counter()
    check_tokenizer_fixtures()
    log(f"[SPM] fixtures: {time.perf_counter() - t0:.1f} s")
    llama2 = _fixture_dir("llama2")
    model_dir = os.path.join(work, "llama-2-7b-width-4-layers")      # saved by phase_local
    for name in ("tokenizer.json", "tokenizer_config.json"):
        shutil.copy(os.path.join(llama2, name), model_dir)
    tok = load_tokenizer(model_dir)
    if not isinstance(tok, HFTokenizer) or tok.bos_token_id != 1 or tok.eos_token_id != 2:
        raise AssertionError("[SPM] the model directory's tokenizer is not the Llama-2-style one")

    # main_llm --local_datasets
    argv = ["--model", model_dir, "--local_datasets", "--seq-len", "2048", "--num-calibration",
            "16", "--num-calibration-2ssp", "8", "--backend", "cuda", "--evaluate_perplexity",
            "--dense", "--pruning_method", "2ssp", "--sparsity_rate", "0.25", "--logging",
            "WARNING"]
    reset_launch_counts()
    t0 = time.perf_counter()
    out = main_llm.run(main_llm.build_argparser().parse_args(argv))
    seconds = time.perf_counter() - t0
    add(launch_counts)
    (entry,) = out["runs"]
    flash = {ph: c["flash_attention"] for ph, c in out["kernel_launches"].items()
             if c["flash_attention"]}
    log(f"[SPM] main_llm --local_datasets (Llama-2-style tokenizer.json): {seconds:.1f} s, corpora "
        f"{out['corpora']}; seconds by phase {_phase_seconds(out)}; flash_attention launches by "
        f"phase {json.dumps(flash)}; dense ppl {out['dense']['ppl']:.3f}, after 25% 2SSP "
        f"{entry['ppl']:.3f}, achieved sparsity {entry['achieved_sparsity']:.4f}")
    if out["corpora"] != "local":
        raise AssertionError(f"[SPM] main_llm --local_datasets used the {out['corpora']} streams")
    if abs(entry["achieved_sparsity"] - 0.25) > 0.02:
        raise AssertionError(f"[SPM] achieved sparsity {entry['achieved_sparsity']} vs 0.25")
    for phase in ("stats", "candidates", "evaluation"):
        if out["kernel_launches"][phase]["flash_attention"] <= 0:
            raise AssertionError(f"[SPM] flash_attention not launched in the {phase} phase")

    # serve_http on the same directory: text prompts, streamed and not
    params, cfg = load_llm_model(model_dir, device=device, dtype=torch.bfloat16)
    texts = [d for d in corpora["wikitext2"] if 400 <= len(d) <= 1600][:4]
    argv = ["--model", model_dir, "--backend", "cuda", "--port", "0", "--max-batch", "8",
            "--page-size", str(PAGE), "--num-pages", "512", "--max-context", "2048"]
    log(f"[SPM] serve_http {' '.join(argv)}")
    args = serve_http.build_argparser().parse_args(argv)
    engine, eos = serve_http.build_engine(args, model=(params, cfg))
    kwargs = serve_http.server_kwargs(args, eos)
    if not isinstance(kwargs["tokenizer"], HFTokenizer):
        raise AssertionError("[SPM] serve_http did not load the directory's tokenizer.json")
    requests = [dict(prompt=t, max_tokens=SPM_SERVE_TOKENS, temperature=0, stream=s)
                for t in texts for s in (True, False)]
    # every request reaches the engine at once, so all are admitted in one round
    # and decode in the same batched steps: a streamed twin and its plain one
    # then see the same bf16 products, and their tokens must be equal
    seen, together = [], threading.Barrier(len(requests))
    submit = engine.submit

    def recording_submit(prompt_ids, **kw):
        seen.append(list(prompt_ids))
        together.wait(timeout=300)
        return submit(prompt_ids, **kw)
    engine.submit = recording_submit
    srv = create_server(engine, **kwargs)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    responses = [None] * len(requests)
    errors = []

    def client(i):
        try:
            responses[i] = _post_text(srv.server_address[1], "/v1/completions", requests[i])
        except Exception as e:   # re-raised below, in the main thread
            errors.append((i, e))

    try:
        reset_launch_counts()
        steps0 = engine.decode_steps
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(requests))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        run = dict(launches=dict(launch_counts), decode_steps=engine.decode_steps - steps0)
    finally:
        srv.shutdown()
        srv.server_close()
        engine.shutdown()
        thread.join(timeout=30)
    if errors or any(r is None for r in responses):
        raise AssertionError(f"[SPM] serve_http: a request failed: {errors[:1]}")
    add(run["launches"])
    prompt_ids = [tok.encode(t) for t in texts]
    if sorted(seen) != sorted(prompt_ids * 2) or any(p[0] != tok.bos_token_id for p in seen):
        raise AssertionError("[SPM] the served prompt ids are not the tokenizer's with BOS first")
    for i in range(len(texts)):
        streamed, once = responses[2 * i], responses[2 * i + 1]
        # the text is the incremental decode of the served ids (the JAX server's
        # _StreamState: each token decodes all ids so far), streamed or not
        replay = _StreamState(tok, [])
        want = "".join(replay.push(t) for t in once["tokens"]) + replay.finalize()
        if streamed["text"] != once["text"] or once["text"] != want:
            raise AssertionError(f"[SPM] prompt {i}: streamed {streamed['text']!r} / not "
                                 f"streamed {once['text']!r} / replayed {want!r}; ids "
                                 f"{once['tokens']}, streamed ids {streamed['tokens']}")
        if once["finish"] != "length" or len(once["tokens"]) != SPM_SERVE_TOKENS:
            raise AssertionError(f"[SPM] prompt {i} ended {once['finish']} after "
                                 f"{len(once['tokens'])} tokens")
    _expect_decode_launches("[SPM] serve_http", run, cfg, ("paged_attention_write",))
    alone_requests = [dict(prompt=p, temperature=0) for p in prompt_ids]
    _check_greedy_alone(params, cfg, device, alone_requests, responses[1::2], torch.bfloat16,
                        "[SPM] text prompts")
    n_tokens = sum(len(r["tokens"]) for r in responses[1::2]) * 2
    firsts = ", ".join("no text" if r["first_s"] is None else f"{r['first_s']:.3f}"
                       for r in responses[0::2])
    log(f"[SPM] serve_http: {len(requests)} text requests (prompts of "
        f"{[len(p) for p in prompt_ids]} ids, BOS first) in {serve_s:.2f} s = "
        f"{n_tokens / serve_s:.1f} tokens/s; time to first token of the streamed ones "
        f"{firsts} s; streamed == not "
        f"streamed; {run['decode_steps']} decode steps, paged_attention_write "
        f"{run['launches']['paged_attention_write']} launches")
    del params, engine
    torch.cuda.empty_cache()

    # train_llm --data with the Llama-2-style tokenizer
    data = os.path.join(work, "train_corpus_spm")
    _arrow_corpus().write_dataset(data, corpora["c4_train"])
    for name in ("tokenizer.json", "tokenizer_config.json"):
        shutil.copy(os.path.join(llama2, name), data)
    args = train_llm.build_argparser().parse_args(
        ["--data", data, "--steps", str(SPM_TRAIN_UPDATES), "--batch-size", "1", "--seq-len",
         "2048"])
    t0 = time.perf_counter()
    batches, stream = train_llm._token_batches(args, LlamaConfig(**LLAMA_2_7B))
    cut_s = time.perf_counter() - t0
    want = tokenize_corpus(corpora["c4_train"], tok).reshape(-1)[:2049]
    if not np.array_equal(np.asarray(batches[0]).reshape(-1), want):
        raise AssertionError("[SPM] train_llm --data: the first microbatch is not the host "
                             "tokenization of the directory's text")
    log(f"[SPM] train_llm --data: {len(corpora['c4_train'])} documents -> {stream.size} ids "
        f"(the byte-level tokenizer made 131072 of the same text) in {cut_s:.2f} s; the first "
        f"microbatch == the host tokenization")
    _, counts = train_cli_run(LLAMA_2_7B, "Llama-2-7B width on --data, Llama-2-style tokenizer",
                              "SPM", data=data, updates=SPM_TRAIN_UPDATES)
    add(counts)
    torch.cuda.empty_cache()

    # qualitative_results with the Qwen-style Split fixture on code_llm_small
    qwen = _fixture_dir("qwen_split")
    qtok = load_tokenizer(qwen)
    params, cfg = load_llm_model(_code_llm_small(), device=device, dtype=torch.float32)
    host = _tree_to(params, "cpu", torch.float32)
    reset_launch_counts()
    t0 = time.perf_counter()
    answers = qualitative_results(params, cfg, qwen, max_length=SPM_QUALITATIVE_LENGTH)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    add(launch_counts)
    flash = launch_counts["flash_attention"]
    if qtok.eos_token_id is None or qtok.eos_token_id >= cfg.vocab_size:
        raise AssertionError("[SPM] the Qwen-style fixture has no EOS inside the vocabulary")
    for prompt, answer in answers:
        ids = qtok(prompt)["input_ids"]
        kw = dict(max_length=SPM_QUALITATIVE_LENGTH, num_beams=5, eos_token_id=qtok.eos_token_id)
        card = beam_generate(params, cfg, np.asarray(ids), **kw).tolist()
        t0 = time.perf_counter()
        ref = beam_generate(host, cfg, np.asarray(ids), **kw).tolist()
        host_s = time.perf_counter() - t0
        if qtok.decode(card, skip_special_tokens=True) != answer:
            raise AssertionError(f"[SPM] qualitative_results: {prompt!r} is not its decoded beam")
        if len(card) != SPM_QUALITATIVE_LENGTH and card[-1] != qtok.eos_token_id:
            raise AssertionError(f"[SPM] {prompt!r}: {len(card)} ids, neither max_length nor EOS")
        gap = 0.0 if card == ref else _beam_tie_gap(host, cfg, ids, card[len(ids):],
                                                    ref[len(ids):])
        log(f"[SPM] qualitative_results {prompt!r} (Qwen-style Split tokenizer, code_llm_small, "
            f"5 beams): {len(card)} ids, "
            f"{'EOS' if card[-1] == qtok.eos_token_id else 'max_length'}; card "
            f"{'==' if card == ref else '!='} host CPU ({host_s:.2f} s on the host)"
            + ("" if card == ref else f", host score gap at the first difference {gap:.2e}")
            + f"; answer {answer[:100]!r}")
        if card != ref and gap > 1e-3:
            raise AssertionError(f"[SPM] {prompt!r}: the card's beam differs from the host's")
    log(f"[SPM] qualitative_results on the card: {card_s:.2f} s, flash_attention {flash} "
        f"launches (the beams replayed for the checks not counted)")
    return launches


def make_adapters(shapes_tree, n: int, rank: int, scale: float, seed: int) -> list:
    """``n`` LoRA adapters on q/k/v/o for the stacked kernels of
    ``shapes_tree`` (``init_lora``'s a, and b ~ N(0, scale) so each one binds),
    on the kernels' device."""
    import torch

    from ssp_x_vit_tpu_torch.llm.lora import init_lora

    out = []
    for i in range(n):
        ad = init_lora(torch.Generator().manual_seed(seed + i), shapes_tree, rank=rank)
        g = torch.Generator().manual_seed(seed + 1000 + i)
        for ab in ad.values():
            ab["b"] = (scale * torch.randn(ab["b"].shape, generator=g)).to(ab["b"].device)
        out.append(ad)
    return out


def _lora_alone_gaps(params, cfg, seqs, starts, ids, cache_dtype, device) -> tuple:
    """``_extend_gaps`` with each sequence's adapter: every sequence alone at
    b=1 through one cached forward over prompt + generated tokens with its
    row's ``lora_ids`` (the serving layers, logits at every position)."""
    import torch

    from ssp_x_vit_tpu_torch.llm import serve
    from ssp_x_vit_tpu_torch.llm.model import _embed_tokens

    same = total = 0
    worst = 0.0
    with torch.no_grad():
        for seq, start, lid in zip(seqs, starts, ids):
            toks = torch.as_tensor(seq[None].astype("int64"), device=device)
            ck, cv = serve.init_cache(cfg, 1, len(seq), cache_dtype, device)
            dt = serve.cache_compute_dtype(ck)
            pos = torch.arange(len(seq), device=device)[None]
            x, _, _ = serve._run_layers(
                params, _embed_tokens(params, toks, cfg, dt), ck, cv, cfg, global_positions=pos,
                rope_positions=pos, pad_lens=torch.zeros(1, dtype=torch.int64, device=device),
                write_pos=0, compute_dtype=dt,
                lora_ids=torch.tensor([lid], dtype=torch.int64, device=device))
            logits = serve._final_logits(params, x, cfg, dt)[0, start - 1:len(seq) - 1]
            chosen = logits.gather(1, toks[0, start:, None])[:, 0]
            gaps = logits.max(dim=-1).values - chosen
            same += int((gaps == 0).sum())
            total += len(seq) - start
            worst = max(worst, float(gaps.max()) / max(1.0, float(logits.abs().max())))
            del ck, cv, logits
    return same, total, worst


def phase_lora(device, params, q8, cfg) -> dict:
    """[LORA]: multi-LoRA on the Llama-2-7B-width int8 tree: 3 adapters of
    rank 16 on q/k/v/o (b ~ N(0, 0.01)) in a bank as ``build_lora_bank(alpha=16)``
    (fp32), b=8 left-padded prompts of 448-480 tokens with ``lora_ids``
    (0, 1, 2, 3, 0, 1, 2, 3), 64 decode steps of ``generate_kv_scan`` (bf16
    cache; prompts of 64-512 tokens cannot give 64 steps: every row decodes
    max_length - shortest - 1 steps and a prompt must be shorter than
    max_length). Checks: (a) the id-0 rows bit for bit the same batch without
    ``lora_ids``; (b) every token within 5e-2 of max(1, max |logit|) of the
    best logit of its prompt run alone at b=1 with its id; (c)
    ``fused_mlp_int8`` launches 32 x (1 + steps). Then ms per decode step,
    host clock and device time, with and without ``lora_ids``. Returns the
    multi-LoRA run's launches."""
    import numpy as np
    import torch

    from ssp_x_vit_tpu_torch.llm.datasets import synthetic_token_stream
    from ssp_x_vit_tpu_torch.llm.multilora import attach_lora_bank, build_lora_bank
    from ssp_x_vit_tpu_torch.llm.serve import generate_kv_scan
    from ssp_x_vit_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    t0 = time.perf_counter()
    adapters = make_adapters(params, 3, LORA_RANK, 0.01, seed=40)
    bank = build_lora_bank(adapters, alpha=16.0)
    served = attach_lora_bank(q8, bank)
    torch.cuda.synchronize()
    bank_bytes = sum(v.numel() * v.element_size() for v in bank.values())
    n_layers, slots = bank["q_kernel_lora_a"].shape[:2]
    log(f"[LORA] 3 adapters of rank {LORA_RANK} on q/k/v/o, bank {bank_bytes / 2 ** 20:.1f} MiB "
        f"fp32 ({len(bank)} tensors [{n_layers}, {slots}, d, r] / [{n_layers}, {slots}, r, n]) "
        f"made in {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(41)
    lo, hi = LORA_PROMPTS
    lens = [lo, hi] + sorted(rng.integers(lo + 1, hi, 6).tolist())
    stream = synthetic_token_stream(sum(lens), cfg.vocab_size, seed=42).reshape(-1)
    cuts = np.cumsum([0] + lens)
    prompts = [stream[cuts[i]:cuts[i + 1]].astype(np.int64) for i in range(len(lens))]
    max_length = lo + LORA_STEPS + 1
    runs = {}
    for label, ids in (("lora_ids", list(LORA_IDS)), ("no lora_ids", None)):
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = generate_kv_scan(served, cfg, prompts, max_length=max_length,
                                cache_dtype=torch.bfloat16, lora_ids=ids)
        torch.cuda.synchronize()
        runs[label] = (outs, time.perf_counter() - t0, dict(launch_counts))
    outs, seconds, launches = runs["lora_ids"]
    run = {k: v for k, v in launches.items() if v}
    log(f"[LORA] b=8 generate_kv_scan, prompts of {lo}-{hi} tokens, lora_ids {list(LORA_IDS)}, "
        f"max_length {max_length}: {LORA_STEPS} decode steps in {seconds:.2f} s (without "
        f"lora_ids {runs['no lora_ids'][1]:.2f} s); launches {json.dumps(run)}")
    want = cfg.num_layers * (1 + LORA_STEPS)
    if run.get("fused_mlp_int8", 0) != want:
        raise AssertionError(f"[LORA] fused_mlp_int8 launched {run.get('fused_mlp_int8')} times, "
                             f"expected {cfg.num_layers} x (1 + {LORA_STEPS}) = {want}")
    base = runs["no lora_ids"][0]
    zero_rows = [i for i, lid in enumerate(LORA_IDS) if lid == 0]
    if any(not np.array_equal(outs[i], base[i]) for i in zero_rows):
        raise AssertionError("[LORA] an id-0 row differs from the batch served without lora_ids")
    bound = [i for i, lid in enumerate(LORA_IDS) if lid and not np.array_equal(outs[i], base[i])]
    same, total, worst = _lora_alone_gaps(served, cfg, outs, lens, LORA_IDS, torch.bfloat16,
                                          device)
    log(f"[LORA] (a) id-0 rows {zero_rows} == the batch without lora_ids, bit for bit; adapter "
        f"rows whose tokens differ from the base rows: {bound}; (b) each token against its "
        f"prompt run alone at b=1 with its id: {same} of {total} are the alone run's argmax, "
        f"worst logit gap {worst:.3e} of max(1, max |logit|), tol 5e-2; (c) fused_mlp_int8 "
        f"launches {run['fused_mlp_int8']} = {cfg.num_layers} x (1 + {LORA_STEPS})")
    if worst > 5e-2:
        raise AssertionError("[LORA] a batch token is not the alone run's best token")
    if not bound:
        raise AssertionError("[LORA] no adapter changed any token: the deltas are not applied")
    for label, ids in (("with lora_ids", list(LORA_IDS)), ("without lora_ids", None)):
        part = _profile_decode(served, cfg, device, torch.bfloat16, prompts, lora_ids=ids)
        busy = (f"{part['busy_ms']:.2f} ms of device activity and {part['n_launch']:.0f} device "
                f"kernels per step" if part["busy_ms"] > 0 else "device time not measured")
        log(f"[LORA] decode step b=8 {label}: {part['step_ms']:.2f} ms host clock (16 steps), "
            f"{busy}; prefill {part['prefill_s']:.3f} s")
        for key, ms, count in part["top"][:4]:
            log(f"[PROFILE]   {ms:8.3f} ms x{count:<4d} {key}")
    del served, bank, runs, outs
    torch.cuda.empty_cache()
    return run


def phase_anchor_local(device, work: str) -> None:
    """[LOCAL] anchor: ``ckpts/code_llm_small`` (fp32 tree; the CLI computes in
    bf16) as ``--model`` with ``--local_datasets``, on the card and on the
    host CPU, from ``work`` holding ./data cut from the committed ids
    (wikitext2: val[:16384] decoded, c4_val and fineweb_edu: val[16384:20480],
    c4_train: train[:16384], each cut into documents at blank lines): the
    same token streams, equal to the host tokenization of the texts, and the
    dense perplexities within 1e-4 relative. The pinned 115.5756 is printed
    for information only: the documents are joined with blank lines, so this
    is not the pinned stream."""
    import numpy as np
    import torch

    from ssp_x_vit_tpu_torch.cli import main_llm
    from ssp_x_vit_tpu_torch.llm.checkpoints import load_llm_model
    from ssp_x_vit_tpu_torch.llm.datasets import tokenize_corpus
    from ssp_x_vit_tpu_torch.llm.tokenizer import load_tokenizer

    ckpt = _code_llm_small()
    corpora = {"wikitext2": _decoded_documents("val", 0, 16384),
               "c4_val": _decoded_documents("val", 16384, 20480),
               "c4_train": _decoded_documents("train", 0, 16384)}
    corpora["fineweb_edu"] = corpora["c4_val"]
    write_corpora(work, corpora)
    params, cfg = load_llm_model(ckpt, device=device, dtype=torch.float32)
    host = _tree_to(params, "cpu", torch.float32)
    tok = load_tokenizer(ckpt)
    out, streams = {}, {}
    for backend, tree in (("cuda", params), ("cpu", host)):
        args = main_llm.build_argparser().parse_args(
            ["--model", ckpt, "--local_datasets", "--dense", "--evaluate_perplexity",
             "--seq-len", "1024", "--num-calibration", "8", "--backend", backend,
             "--logging", "WARNING"])
        streams[backend] = main_llm.load_corpora(args, cfg)
        t0 = time.perf_counter()
        out[backend] = main_llm.run(args, model=(tree, cfg))
        log(f"[LOCAL] anchor code_llm_small --local_datasets on {backend}: "
            f"{time.perf_counter() - t0:.1f} s, corpora {out[backend]['corpora']}, dense ppl "
            f"{out[backend]['dense']['ppl']:.6f}")
    direct = [tokenize_corpus(corpora[name], tok) for name in
              ("wikitext2", "c4_val", "fineweb_edu", "c4_train")]
    direct[2] = tokenize_corpus(corpora["fineweb_edu"][:500], tok)
    for a, b, c in zip(streams["cuda"], streams["cpu"], direct):
        if not (np.array_equal(a, b) and np.array_equal(a, c)):
            raise AssertionError("[LOCAL] anchor: the token streams differ")
    card, cpu = out["cuda"]["dense"]["ppl"], out["cpu"]["dense"]["ppl"]
    rel = abs(card - cpu) / cpu
    log(f"[LOCAL] anchor: streams of {[s.shape[1] for s in streams['cuda']]} ids equal on both "
        f"and to the host tokenization of the texts; dense ppl card {card:.6f}, host CPU "
        f"{cpu:.6f} (relative {rel:.2e}, tol 1e-4); pinned 115.5756 on the .bin stream, for "
        f"information only")
    if any(o["corpora"] != "local" for o in out.values()):
        raise AssertionError("[LOCAL] anchor: a run did not use the local corpora")
    if rel > 1e-4:
        raise AssertionError(f"[LOCAL] anchor: ppl on the card {card} vs the host CPU {cpu}")


def phase_anchor_lora_serving(device) -> None:
    """[LORA] anchor: ``ckpts/code_llm_small`` in fp32 with 2 adapters of rank
    8 (b ~ N(0, 0.05)) through ``generate_kv_scan``: 4 val prompts x 32 greedy
    tokens with ``lora_ids`` (0, 1, 2, 1) on the card against the host CPU,
    token for token; a token may differ only where the host's top-2 margin (of
    the row's adapter merged into the host model) is under 1e-3."""
    import numpy as np
    import torch

    from ssp_x_vit_tpu_torch.llm.checkpoints import load_llm_model
    from ssp_x_vit_tpu_torch.llm.lora import merge_lora
    from ssp_x_vit_tpu_torch.llm.multilora import attach_lora_bank, build_lora_bank
    from ssp_x_vit_tpu_torch.llm.serve import generate_kv_scan

    ckpt = _code_llm_small()
    params, cfg = load_llm_model(ckpt, device=device, dtype=torch.float32)
    host = _tree_to(params, "cpu", torch.float32)
    adapters = make_adapters(host, 2, 8, 0.05, seed=60)
    bank = build_lora_bank(adapters, alpha=16.0)
    served_host = attach_lora_bank(host, bank)
    served_card = attach_lora_bank(params, {k: v.to(device) for k, v in bank.items()})
    val = np.asarray(np.memmap(os.path.join(ckpt, "corpus_slice", "val.bin"), np.uint16, "r")[:4096],
                     np.int32)
    prompts = [val[a:a + n].tolist() for a, n in ((0, 48), (500, 100), (1000, 160), (2000, 200))]
    ids, new = [0, 1, 2, 1], 32
    kw = dict(max_length=max(len(p) for p in prompts) + new, cache_dtype=torch.float32,
              lora_ids=ids)
    got = generate_kv_scan(served_card, cfg, prompts, **kw)
    ref = generate_kv_scan(served_host, cfg, prompts, **kw)
    base = generate_kv_scan(params, cfg, prompts, **dict(kw, lora_ids=None))
    checked = 0
    for p, g, r, lid in zip(prompts, got, ref, ids):
        tree = host if lid == 0 else merge_lora(host, adapters[lid - 1], alpha=16.0)
        checked += _first_divergence(g[:len(p) + new].tolist(), r[:len(p) + new].tolist(),
                                     len(p), tree, cfg, torch.float32, 1e-3)
    moved = [i for i, lid in enumerate(ids) if lid and not np.array_equal(got[i], base[i])]
    log(f"[LORA] anchor code_llm_small fp32, lora_ids {ids}: card == host CPU on {checked} of "
        f"{4 * new} tokens (the rest follow a near-tie); rows whose adapter changed the tokens: "
        f"{moved}")
    if not np.array_equal(got[0], base[0]):
        raise AssertionError("[LORA] anchor: the id-0 row differs from the base model's")


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
    records["fused_ffn"].update(check_vit_block_gradients(device))
    records.update(phase_llm_kernels(device))
    records.update(phase_flash_backward(device))
    records.update(phase_paged_kernels(device))
    records.update(phase_fused_mlp(device))
    records.update(phase_mla_kernels(device))
    records.update(phase_mla_write_kernels(device))
    for b, dtype in ((64, torch.bfloat16), (64, torch.float32), (1, torch.float32)):
        time_kernel_parts(device, b, dtype)
    time_llm_parts(device)
    # Driven paths, each with the counts set to 0 just before it and read just
    # after. The CLI runs (two ViT, two LLM) are the main paths: fused_ffn is
    # launched there by the ViT finetune phases, and driven through its public
    # op-level entry too; quant_matmul has no caller in either package, so it
    # is driven through its wrapper and its record says so.
    direct = {"fused_ffn": ("cli runs (the finetune phases) + ops.ffn.ffn_forward called "
                            "directly", drive_ffn_forward(device)),
              "quant_matmul": ("direct wrapper call, no caller in the package",
                               drive_quant_matmul(device))}
    for name, n in drive_paged_standalone(device).items():
        direct[name] = ("direct wrapper calls; the served llama decode layer makes one "
                        "paged_attention_write call instead", n)
    for name, n in drive_mla_standalone(device).items():
        direct[name] = ("direct wrapper calls at 16 heads; the served DeepSeek-V3 decode layer makes "
                        "one paged_mla_attention_write call, on the Hopper kernel" +
                        ("" if "write" in name else ", instead of the row write and this"), n)
    phase_done("kernels (phase 3)")
    cli_launches = {name: 0 for name in KERNEL_NAMES}
    a7c_work = tempfile.TemporaryDirectory()
    with tempfile.TemporaryDirectory() as out_root:
        for name, n in phase_main(out_root, device).items():
            cli_launches[name] += n
        b16_scores = os.path.join(a7c_work.name, "phase4_b16_ffn_importances.json")
        found = [os.path.join(base, n)
                 for base, _, names in os.walk(os.path.join(out_root, "vit-b16"))
                 for n in names if n == "iterative_vit_b16_ffn_importances.json"]
        os.replace(found[0], b16_scores)   # the mask grids' first score file
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
    with tempfile.TemporaryDirectory() as out_root:
        for name, n in phase_hf_vit(out_root, device).items():
            cli_launches[name] += n
    for name, n in phase_hf_llama_7b(device).items():
        cli_launches[name] += n
    phase_done("main, HF round trips: ViT-B/16, Llama-2-7B width (phase 4)")
    cwd = os.getcwd()
    os.chdir(a7c_work.name)          # the CLIs look for CIFAR under ./data
    try:
        t0 = time.perf_counter()
        models = make_srp_work(a7c_work.name)
        launches, srp_b16_scores = phase_srp(a7c_work.name, models, device)
        for name, n in launches.items():
            cli_launches[name] += n
        log(f"[SRP] phase: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        for name, n in phase_mask_grid(a7c_work.name, models, (b16_scores, srp_b16_scores),
                                       device).items():
            cli_launches[name] += n
        log(f"[MASK] phase: {time.perf_counter() - t0:.1f} s")
    finally:
        os.chdir(cwd)
        a7c_work.cleanup()
    t0 = time.perf_counter()
    for name, n in phase_token_pruning(device).items():
        cli_launches[name] += n
    check_resize(device)
    log(f"[TOKEN] phase (with the resize check): {time.perf_counter() - t0:.1f} s")
    phase_done("main, SRP checkpoints, mask grids, token pruning (phase 4)")
    for name, n in phase_llm_methods(device).items():
        cli_launches[name] += n
    phase_done("main, SliceGPT, EvoPress, ablations, task pack at Llama-2-7B width (phase 4)")
    for name, n in phase_deepseek(device).items():
        cli_launches[name] += n
    phase_done("main, DeepSeek-V3 widths: main_llm, generation, MLA serving (phase 4)")
    for name, n in phase_moe(device).items():
        cli_launches[name] += n
    phase_done("main, Mixtral-8x7B widths: main_llm, HTTP serving, generation, training; "
               "DeepSeek-V3 widths trained (phase 4)")
    corpus_work = tempfile.TemporaryDirectory()
    os.chdir(corpus_work.name)       # main_llm --local_datasets reads ./data
    try:
        corpora = phase_corpus(corpus_work.name)
        for name, n in phase_local(device, corpus_work.name).items():
            cli_launches[name] += n
        for name, n in phase_train_data(corpus_work.name, corpora).items():
            cli_launches[name] += n
        torch.cuda.empty_cache()
        phase_done("main, local corpora: save_to_disk directories, main_llm --local_datasets at "
                   "Llama-2-7B widths, train_llm --data (phase 4)")
        for name, n in phase_spm(device, corpus_work.name, corpora).items():
            cli_launches[name] += n
    finally:
        os.chdir(cwd)
        corpus_work.cleanup()
    torch.cuda.empty_cache()
    phase_done("main, SentencePiece and Split tokenizers: fixtures, main_llm --local_datasets, "
               "serve_http text prompts, train_llm --data, qualitative_results (phase 4)")
    phase_anchor(device)
    phase_finetune_host(device)
    phase_anchor_lora_llm(device)
    phase_anchor_llm(device)
    phase_anchor_serving(device)
    phase_anchor_contiguous(device)
    phase_anchor_train(device)
    phase_done("anchors (phase 5)")
    phase_anchor_tokenizer()
    with tempfile.TemporaryDirectory() as work:
        hf_dir, launches = phase_anchor_hf_llm(device, work)
        for name, n in launches.items():
            cli_launches[name] += n
        for name, n in phase_anchor_text_serving(device, hf_dir).items():
            cli_launches[name] += n
    phase_done("anchors: tokenizer, HF directory, text serving (phase 5)")
    phase_anchor_llm_methods(device)
    phase_done("anchors: SliceGPT, EvoPress, ablations, task pack (phase 5)")
    phase_anchor_deepseek(device)
    phase_done("anchors: tiny DeepSeek models, card against host CPU (phase 5)")
    phase_anchor_moe(device)
    phase_done("anchors: tiny MoE and DeepSeek models trained and served, card against host "
               "CPU (phase 5)")
    with tempfile.TemporaryDirectory() as work:
        os.chdir(work)
        try:
            phase_anchor_local(device, work)
        finally:
            os.chdir(cwd)
    phase_anchor_lora_serving(device)
    phase_done("anchors: code_llm_small on local corpora and with multi-LoRA, card against "
               "host CPU (phase 5)")

    missing = [name for name in KERNEL_NAMES
               if (direct[name][1] if name in direct else cli_launches[name]) <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on a driven path: {missing}")
    kernels = []
    for name in KERNEL_NAMES:
        driven_by, n_direct = direct.get(name, (
            "ServingEngine over MLAPagedServer at DeepSeek-V3 widths" if name.startswith("paged_mla")
            else "served runs over HTTP" if name.startswith("paged_")
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
