#!/usr/bin/env python3
"""``chip_smoke.py``'s [PARALLEL] phase: the port's data and tensor parallelism
on the card, one process per visible card over NCCL.

    python3 -m torch.distributed.run --nnodes=1 --nproc_per_node=N \\
        --master_addr=127.0.0.1 --master_port=PORT scripts/torch_parallel_phase.py \\
        --out parallel.json

``chip_smoke.py`` starts it so (N = the visible cards) after building the kernel
libraries; it runs on its own too. Every rank:

1. (rank 0) holds the on-path kernels at the shapes a rank of tp = 2 and
   tp = 4 gets against their plain versions, on shards cut by
   ``vit_shard`` / ``llama_shard`` (what ``shard_vit_params`` /
   ``shard_llama_params`` give those ranks): rows 1-3 at 6 and 3 heads and FFN
   width 3072 / tp (the first rank with the residual and biases, the others
   without), row 5 at 16 and 8 heads of the Llama-2-7B shard's projections,
   row 11 at f = 5504 and 2752, row 10 on the replicated int4 down projection
   and a column-cut int4 gate; bf16, within 3e-2 (rows 1-3: of the branch's
   own max |plain|, ``chip_smoke.branch_err``, so the residual cannot widen
   the limit; rows 10-11 of max(1, |plain|); flash: its own criteria). Rows
   1-3 also show that the limit has teeth: a zeroed branch and the branch
   of another rank's heads or columns each fail it. These launches are not
   counted.
2. runs the parallel paths, the launch counts summed over them only:
   ``auto_2ssp --data-parallel`` at ViT-B/16 (12 layers, synthetic data) and
   a tensor-parallel top-1 (ViT-Ti/16 at tp = 1 on one card, ViT-B/16 at
   tp = N where 12 heads split); at Llama-2-7B widths cut to 2 layers (random
   bf16 weights from a seed) ``evaluate_perplexity_sharded`` over 4 windows
   of 2048, ``tp_generate_kv_scan`` on the int8 tree with the int8 cache (b=8,
   32 new tokens) and on the int4 tree (b=8, 8 new tokens), one dp x tp step
   (``make_sharded_llama_train_step``) and one FSDP step, on every mesh of
   the world (1 x 1 on one card; 1 x 4 and 2 x 2 on four).
3. holds each against the single-process path run in the same process: on
   one card the same plan, pruned blocks, kept neurons and top-1, perplexity
   within 1e-6 relative, the same tokens, loss and parameters within 1e-6;
   on more cards the same plan, pruned blocks and kept widths, kept neurons
   that differ in at most 1% (importances summed in another order may swap
   neurons at the cut), top-1 within 2 of the 128 test images, perplexity
   within 2e-2, each served token's logit within 5e-2 of max(1, |max|) of
   the single-process run's best, train loss within 2e-2.

Rank 0 writes ``--out``: world size, NCCL version, seconds per part, launches
per kernel, every comparison with its limit. Any failure raises, so the rank
exits non-zero and the world with it.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (helpers and constants; imports no JAX)

BF16_TOL = 3e-2       # the bf16 rule of chip_smoke.py: 3e-2 of max(1, |plain|)
EXACT_TOL = 1e-6      # one card: the sharded path is the single path + size-1 collectives
MULTI_PPL_RTOL = 2e-2
MULTI_TOKEN_TOL = 5e-2
MULTI_LOSS_RTOL = 2e-2
PPL_WINDOWS = 4
SEQ = 2048
EVAL_BATCHES = 2
EVAL_IMAGES = 64 * EVAL_BATCHES   # the synthetic test batches are 64 images (cli/common.py)
MULTI_TOP1 = 2 / EVAL_IMAGES      # more cards: top-1 within 2 images
MULTI_NEURON_SHARE = 1e-2


class Run:
    """Per-part seconds, launch counts over the parallel paths, comparisons."""

    def __init__(self, rank: int):
        self.rank, self.seconds, self.checks = rank, {}, []
        from ssp_x_vit_tpu_torch.ops.kernels import KERNEL_NAMES

        self.launches = {name: 0 for name in KERNEL_NAMES}

    def log(self, msg: str) -> None:
        if self.rank == 0:
            cs.log(f"[PARALLEL] {msg}")

    def check(self, name: str, value: float, limit: float, what: str = "<=") -> None:
        ok = {"<=": value <= limit, "==": value == limit, ">": value > limit}[what]
        self.checks.append({"name": name, "value": value, "limit": limit, "rule": what, "ok": ok})
        self.log(f"{name}: {value!r} ({what} {limit!r}) {'ok' if ok else 'FAILED'}")
        if not ok:
            raise AssertionError(f"rank {self.rank}: {name} = {value!r}, limit {what} {limit!r}")

    def counted(self, fn):
        """Run ``fn`` with the launch counts set to 0 before and added up after."""
        import torch

        from ssp_x_vit_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

        reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        for name in self.launches:
            self.launches[name] += launch_counts[name]
        return out

    @contextlib.contextmanager
    def timed(self, part: str):
        """Seconds of a part, the device synchronized at both ends."""
        import torch

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        self.seconds[part] = round(time.perf_counter() - t0, 3)
        self.log(f"{part}: {self.seconds[part]} s")


# ------------------------------------------------------- kernels at shard shapes ---

def shard_kernels(run: Run, device) -> None:
    """Rank 0: each on-path kernel at the shapes a tp = 2 and tp = 4 rank gets."""
    import torch

    from ssp_x_vit_tpu_torch.llm.model import LlamaConfig, init_llama_params, rms_norm
    from ssp_x_vit_tpu_torch.llm.quant import quantize_llm_params_int4, quantize_llm_params_int8
    from ssp_x_vit_tpu_torch.models.vit import ViTConfig, cast_params, init_vit_params
    from ssp_x_vit_tpu_torch.ops.kernels import fused_attn_block as fab
    from ssp_x_vit_tpu_torch.ops.kernels import fused_ffn as ffn
    from ssp_x_vit_tpu_torch.ops.kernels.flash_attention import flash_attention, \
        flash_attention_plain
    from ssp_x_vit_tpu_torch.ops.kernels.quant_fused_mlp import fused_mlp_int8, \
        fused_mlp_int8_plain
    from ssp_x_vit_tpu_torch.ops.kernels.quant_matmul import quant4_matmul, quant4_matmul_plain
    from ssp_x_vit_tpu_torch.parallel.llm_sharding import llama_shard
    from ssp_x_vit_tpu_torch.parallel.vit_sharding import vit_shard

    gen = torch.Generator(device=device)
    gen.manual_seed(21)
    vcfg = ViTConfig(num_classes=10)   # ViT-B/16
    vit = cast_params(init_vit_params(vcfg, seed=21, device=device), torch.bfloat16)
    x = torch.randn(64, vcfg.seq_len, vcfg.hidden_size, generator=gen, device=device).to(
        torch.bfloat16)
    gate = torch.full((), 0.5, dtype=torch.float32, device=device)
    def blocks(r, tp):
        return {k: v[0].contiguous() for k, v in vit_shard(vit, vcfg, r, tp)["blocks"].items()}

    def attn_args(bp, lead, heads):
        return (x, bp["ln1_scale"], bp["ln1_bias"], bp["qkv_kernel"], bp["qkv_bias"],
                bp["proj_kernel"], bp["proj_bias"] if lead else None, heads)

    def ffn_args(bp, lead):
        return (x, bp["ln2_scale"], bp["ln2_bias"], bp["fc1_kernel"], bp["fc1_bias"],
                bp["fc2_kernel"], bp["fc2_bias"] if lead else None)

    with torch.no_grad():
        for tp in (2, 4):
            for r in (0, tp - 1):
                bp, other = blocks(r, tp), blocks((r + 1) % tp, tp)
                lead, heads = r == 0, vcfg.num_heads // tp
                resid = x if lead else None   # branch_err's residual: the branch alone on the others
                kernel = fab.fused_attn_block_v2 if heads % 2 == 0 else fab.fused_attn_block
                akw = dict(eps=vcfg.layernorm_eps, gate=gate, residual=lead)
                got = kernel(*attn_args(bp, lead, heads), **akw)
                ref = fab.fused_attn_block_plain(*attn_args(bp, lead, heads), **akw)
                wrong = fab.fused_attn_block_plain(*attn_args(other, lead, heads), **akw)
                what = (f"row {1 if heads % 2 == 0 else 2} {kernel.__name__} tp={tp} rank={r} "
                        f"({heads} heads, residual={lead})")
                run.check(f"{what} branch error", cs.branch_err(got, ref, resid)[1], BF16_TOL)
                run.check(f"{what} the limit fails a zeroed branch",
                          cs.branch_err(x if lead else torch.zeros_like(ref), ref, resid)[1],
                          BF16_TOL, ">")
                run.check(f"{what} the limit fails rank {(r + 1) % tp}'s heads",
                          cs.branch_err(wrong, ref, resid)[1], BF16_TOL, ">")
                fkw = dict(gate=gate, collect_stats=True, eps=vcfg.layernorm_eps, residual=lead)
                got, got_stats = ffn.fused_ffn_block(*ffn_args(bp, lead), **fkw)
                ref, ref_stats = ffn.fused_ffn_block_plain(*ffn_args(bp, lead), **fkw)
                wrong = ffn.fused_ffn_block_plain(*ffn_args(other, lead), **fkw)[0]
                what = (f"row 3 fused_ffn_block tp={tp} rank={r} "
                        f"(f={bp['fc1_kernel'].shape[-1]}, residual={lead})")
                run.check(f"{what} branch error", cs.branch_err(got, ref, resid)[1], BF16_TOL)
                run.check(f"{what} stats error over their max",
                          float((got_stats - ref_stats).abs().max() / ref_stats.abs().max()),
                          BF16_TOL)
                run.check(f"{what} the limit fails a zeroed branch",
                          cs.branch_err(x if lead else torch.zeros_like(ref), ref, resid)[1],
                          BF16_TOL, ">")
                run.check(f"{what} the limit fails rank {(r + 1) % tp}'s columns",
                          cs.branch_err(wrong, ref, resid)[1], BF16_TOL, ">")

        lcfg = LlamaConfig(**dict(cs.LLAMA_2_7B, num_layers=1))
        params = init_llama_params(gen, lcfg, dtype=torch.bfloat16, device=device)
        h = rms_norm(torch.randn(1, SEQ, lcfg.hidden_size, generator=gen, device=device).to(
            torch.bfloat16), params["blocks"]["ln1"][0], lcfg.rms_eps)
        q8, q4 = quantize_llm_params_int8(params, lcfg), quantize_llm_params_int4(params, lcfg)
        xm = torch.randn(8, lcfg.hidden_size, generator=gen, device=device).to(torch.bfloat16)
        for tp in (2, 4):
            blk = {k: v[0] for k, v in llama_shard(params, lcfg, 0, tp)["blocks"].items()}
            qkv = [(h @ blk[k]).reshape(1, SEQ, -1, lcfg.head_dim).transpose(1, 2).contiguous()
                   for k in ("q_kernel", "k_kernel", "v_kernel")]
            got = flash_attention(*qkv, causal=True)
            ref = flash_attention_plain(*qkv, causal=True)
            whole, tile = cs.flash_check(f"[PARALLEL] row 5 tp={tp}", got, ref, "bfloat16")
            run.check(f"row 5 flash_attention tp={tp} ({qkv[0].shape[1]} heads) RMS error "
                      "(flash criteria)", whole, 1e-2)
            run.check(f"row 5 flash_attention tp={tp} worst 64-row tile", tile, 3e-2)
            b8 = {k: v[0] for k, v in llama_shard(q8, lcfg, 0, tp)["blocks"].items()}
            margs = (xm, b8["gate_kernel_q"], b8["gate_kernel_scale"], b8["up_kernel_q"],
                     b8["up_kernel_scale"], b8["down_kernel_q"], b8["down_kernel_scale"])
            run.check(f"row 11 fused_mlp_int8 tp={tp} (f={b8['gate_kernel_q'].shape[-1]}) "
                      "scaled error",
                      cs.scaled_err(fused_mlp_int8(*margs), fused_mlp_int8_plain(*margs))[1],
                      BF16_TOL)
        b4 = {k: v[0] for k, v in llama_shard(q4, lcfg, 0, 2)["blocks"].items()}
        xf = torch.randn(8, lcfg.intermediate_size, generator=gen, device=device).to(
            torch.bfloat16)
        for name, xin in (("down_kernel", xf), ("gate_kernel", xm)):
            w, s = b4[name + "_q4"].contiguous(), b4[name + "_scale"].contiguous()
            run.check(f"row 10 quant4_matmul tp=2 {name} {tuple(w.shape)} "
                      f"({'replicated' if name == 'down_kernel' else 'column-cut'}) scaled error",
                      cs.scaled_err(quant4_matmul(xin, w, s), quant4_matmul_plain(xin, w, s))[1],
                      BF16_TOL)
    torch.cuda.synchronize()


# ------------------------------------------------------------------ parallel paths ---

def vit_parts(run: Run, device, world: int, work: str) -> None:
    import torch

    from ssp_x_vit_tpu_torch.cli import auto_2ssp
    from ssp_x_vit_tpu_torch.cli.common import resolve_model
    from ssp_x_vit_tpu_torch.evaluation.classify import evaluate_top1
    from ssp_x_vit_tpu_torch.models.vit import cast_params, vit_forward
    from ssp_x_vit_tpu_torch.parallel import mesh as M
    from ssp_x_vit_tpu_torch.parallel.vit_sharding import evaluate_top1_sharded, \
        shard_vit_params

    argv = ["--model", "vit-b16", "--dataset", "synthetic", "--target", "0.25", "--stage",
            "both", "--eval-batches", str(EVAL_BATCHES), "--min-remaining", "512",
            "--backend", "cuda"]
    with run.timed("vit-b16 auto_2ssp single process"):
        single = auto_2ssp.run(auto_2ssp.build_argparser().parse_args(
            argv + ["--out-root", os.path.join(work, "single")]))
    with run.timed("vit-b16 auto_2ssp --data-parallel"):
        dp = run.counted(lambda: auto_2ssp.run(auto_2ssp.build_argparser().parse_args(
            argv + ["--data-parallel", "--out-root", os.path.join(work, "dp")])))
    (sp, sc), (dpp, dc) = single["model"], dp["model"]
    run.check("auto_2ssp plan equal", int(dp["plan"] == single["plan"]), 1, "==")
    same_blocks = int(dc.pruned_attention_blocks == sc.pruned_attention_blocks)
    same_neurons = int(dc.block_intermediate_sizes == sc.block_intermediate_sizes and bool(
        torch.equal(dpp["blocks"]["fc1_kernel"], sp["blocks"]["fc1_kernel"])))
    accs = {k: (dp["metrics"][k], single["metrics"][k])
            for k in ("acc_baseline", "acc_stage1", "acc_stage2")}
    run.log(f"auto_2ssp top-1 (data-parallel, single) {accs}; pruned blocks "
            f"{list(dc.pruned_attention_blocks)}; kept widths {dc.block_intermediate_sizes}")
    run.check("auto_2ssp pruned blocks equal", same_blocks, 1, "==")
    run.check("auto_2ssp kept widths equal",
              int(dc.block_intermediate_sizes == sc.block_intermediate_sizes), 1, "==")
    if world == 1:
        run.check("auto_2ssp kept neurons equal (fc1 of the pruned model bit for bit)",
                  same_neurons, 1, "==")
    elif run.rank == 0:   # rank 0 wrote the data-parallel run's artifacts
        def pruned(root):
            (path,) = glob.glob(os.path.join(work, root, "artifacts", "*", "ffn_prune_masks.json"))
            with open(path) as f:
                return [set(ix) for ix in json.load(f)["indices"]]

        swapped = sum(len(a - b) for a, b in zip(pruned("dp"), pruned("single")))
        kept = sum(dc.block_intermediate_sizes)
        run.log(f"auto_2ssp kept neurons differing from the single process: {swapped} of {kept}")
        run.check("auto_2ssp share of kept neurons differing from the single process",
                  swapped / kept, MULTI_NEURON_SHARE)
    for k, (a, b) in accs.items():
        run.check(f"auto_2ssp {k} |data-parallel - single|", abs(a - b),
                  0.0 if world == 1 else MULTI_TOP1)
    del single, dp, sp, dpp
    torch.cuda.empty_cache()

    # tensor-parallel top-1: ViT-Ti/16 (3 heads, row 2) on one card; ViT-B/16 at
    # every model size that splits its 12 heads on more
    models = [("vit-ti16", 1)] if world == 1 else [("vit-b16", t) for t in (2, 4) if world % t == 0]
    gen = torch.Generator(device=device)
    gen.manual_seed(5)
    px = torch.rand(2, EVAL_IMAGES // 2, 224, 224, 3, generator=gen, device=device) * 2 - 1
    labels = torch.randint(0, 10, (2, EVAL_IMAGES // 2), generator=gen, device=device)
    for name, tp in models:
        params, cfg = resolve_model(name, seed=0, device=device)
        mesh = M.make_mesh(model=tp)
        batches = [{"pixel_values": px[i], "labels": labels[i]} for i in range(2)]
        local = [M.shard_batch(mesh, b) for b in batches]
        single_acc = evaluate_top1(params, cfg, batches)
        shard = shard_vit_params(params, mesh, cfg)
        with run.timed(f"{name} tensor-parallel top-1 (mesh {M.axis_size(mesh, 'data')}x{tp})"):
            acc = run.counted(lambda: evaluate_top1_sharded(shard, cfg, local, mesh))
            with torch.inference_mode():
                logits = run.counted(lambda: vit_forward(
                    cast_params(shard, torch.bfloat16), px[0], cfg, compute_dtype=torch.bfloat16,
                    tp_group=mesh.get_group("model"))[0])
        with torch.inference_mode():
            ref = vit_forward(cast_params(params, torch.bfloat16), px[0], cfg,
                              compute_dtype=torch.bfloat16)[0]
        run.check(f"{name} tp={tp} logits scaled error against the single forward",
                  cs.scaled_err(logits, ref)[1], EXACT_TOL if world == 1 else BF16_TOL)
        run.check(f"{name} tp={tp} top-1 |sharded - single|", abs(acc - single_acc),
                  0.0 if world == 1 else MULTI_TOP1)
        del params, shard
        torch.cuda.empty_cache()


def llm_meshes(world: int):
    from ssp_x_vit_tpu_torch.parallel import mesh as M

    return [M.make_mesh(model=t) for t in ((1,) if world == 1 else (world, 2)) if world % t == 0]


def _mesh_name(mesh) -> str:
    from ssp_x_vit_tpu_torch.parallel.mesh import axis_size

    return f"{axis_size(mesh, 'data')}x{axis_size(mesh, 'model')}"


def _token_margin(params, cfg, prompts, outs, start) -> float:
    """The largest shortfall, over every generated token, of its logit under the
    single-process forward below that step's best, over max(1, |best|)."""
    import torch

    from ssp_x_vit_tpu_torch.llm.model import llama_forward

    worst = 0.0
    with torch.no_grad():
        for prompt, seq in zip(prompts, outs):
            toks = torch.as_tensor(seq[None].astype("int64"), device=params["embed"].device)
            logits, _ = llama_forward(params, toks[:, :-1], cfg)
            for pos in range(len(prompt), len(seq)):
                row = logits[0, pos - 1]
                best = float(row.max())
                worst = max(worst, (best - float(row[int(seq[pos])])) / max(1.0, abs(best)))
    return worst


def llm_parts(run: Run, device, world: int) -> None:
    import numpy as np
    import torch

    from ssp_x_vit_tpu_torch.llm.evaluation import evaluate_perplexity
    from ssp_x_vit_tpu_torch.llm.model import LlamaConfig, init_llama_params
    from ssp_x_vit_tpu_torch.llm.optim import AdamW, tree_leaves
    from ssp_x_vit_tpu_torch.llm.quant import quantize_llm_params_int4, quantize_llm_params_int8
    from ssp_x_vit_tpu_torch.llm.serve import generate_kv_scan
    from ssp_x_vit_tpu_torch.llm.train import make_llama_train_step
    from ssp_x_vit_tpu_torch.parallel import llm_sharding as S
    from ssp_x_vit_tpu_torch.parallel import mesh as M

    cfg = LlamaConfig(**dict(cs.LLAMA_2_7B, num_layers=2))
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = init_llama_params(gen, cfg, dtype=torch.bfloat16, device=device)
    meshes = llm_meshes(world)
    rng = np.random.default_rng(0)

    ids = rng.integers(0, cfg.vocab_size, PPL_WINDOWS * SEQ + 100)
    with run.timed(f"perplexity {PPL_WINDOWS} x {SEQ} single process"):
        single = evaluate_perplexity(params, cfg, ids, seq_len=SEQ)
    for mesh in meshes:
        shard = S.shard_llama_params(params, mesh, cfg)
        with run.timed(f"perplexity {PPL_WINDOWS} x {SEQ} mesh {_mesh_name(mesh)}"):
            ppl = run.counted(lambda: S.evaluate_perplexity_sharded(shard, cfg, mesh, ids,
                                                                    seq_len=SEQ))
        run.log(f"perplexity mesh {_mesh_name(mesh)} {ppl!r}, single process {single!r}")
        run.check(f"perplexity mesh {_mesh_name(mesh)} relative difference",
                  abs(ppl - single) / single, EXACT_TOL if world == 1 else MULTI_PPL_RTOL)
        del shard

    for label, tree, cache, plen, new in (
            ("int8 tree, int8 cache", quantize_llm_params_int8(params, cfg), torch.int8, 96, 32),
            ("int4 tree, bf16 cache", quantize_llm_params_int4(params, cfg), torch.bfloat16, 32,
             8)):
        prompts = [rng.integers(0, cfg.vocab_size, plen).tolist() for _ in range(8)]
        kw = dict(max_length=plen + new, cache_dtype=cache)
        with run.timed(f"generate_kv_scan {label} b=8 +{new} single process"):
            ref = generate_kv_scan(tree, cfg, prompts, **kw)
        for mesh in meshes:
            with run.timed(f"tp_generate_kv_scan {label} b=8 +{new} mesh {_mesh_name(mesh)}"):
                outs = run.counted(lambda: S.tp_generate_kv_scan(tree, cfg, mesh, prompts, **kw))
            if world == 1:
                run.check(f"served tokens ({label}) differing from the single process",
                          sum(int((a != b).sum()) for a, b in zip(outs, ref)), 0, "==")
            else:
                run.check(f"served tokens ({label}, mesh {_mesh_name(mesh)}) worst logit "
                          "shortfall from the single process's best",
                          _token_margin(tree, cfg, prompts, outs, plen), MULTI_TOKEN_TOL)
        del tree

    tokens = rng.integers(0, cfg.vocab_size, (4, 1025)).astype(np.int64)
    base = {k: ({kk: vv.clone() for kk, vv in v.items()} if isinstance(v, dict) else v.clone())
            for k, v in params.items()}
    del params
    torch.cuda.empty_cache()

    def clone():
        return {k: ({kk: vv.clone() for kk, vv in v.items()} if isinstance(v, dict)
                    else v.clone()) for k, v in base.items()}

    opt = AdamW(1e-4, grad_clip=1.0)
    ref_params = clone()
    ref_state = opt.init(ref_params)
    with run.timed("train step b=4 s=1024 single process"):
        _, _, ref_loss = make_llama_train_step(cfg, opt)(ref_params, ref_state, tokens)
    del ref_state
    for kind in ("dp x tp", "fsdp"):
        for mesh in (meshes if kind == "dp x tp" else [M.make_mesh(model=1)]):
            full = clone()
            if kind == "dp x tp":
                shard = S.shard_llama_params(full, mesh, cfg)
                step = S.make_sharded_llama_train_step(mesh, cfg, opt)
                want = S.shard_llama_params(ref_params, mesh, cfg)
            else:
                specs = S.fsdp_llama_param_specs_like(full, M.axis_size(mesh, "data"))
                shard = S.shard_llama_params_fsdp(full, mesh)
                step = S.make_fsdp_llama_train_step(mesh, cfg, opt, specs=specs)
                want = S.shard_llama_params_fsdp(ref_params, mesh)
            del full
            state = opt.init(shard)
            with run.timed(f"{kind} train step b=4 s=1024 mesh {_mesh_name(mesh)}"):
                shard, state, loss = run.counted(lambda: step(shard, state, tokens))
            loss, rl = float(loss), float(ref_loss)
            run.log(f"{kind} mesh {_mesh_name(mesh)} loss {loss!r}, single process {rl!r}; "
                    f"moments {sum(t.numel() for t in tree_leaves(state['mu']))} elements")
            run.check(f"{kind} mesh {_mesh_name(mesh)} loss relative difference",
                      abs(loss - rl) / abs(rl), EXACT_TOL if world == 1 else MULTI_LOSS_RTOL)
            if world == 1:
                diff = max(float((a.float() - b.float()).abs().max())
                           for a, b in zip(tree_leaves(shard), tree_leaves(want)))
                run.check(f"{kind} mesh {_mesh_name(mesh)} parameters max |difference|",
                          diff, EXACT_TOL)
            del shard, state, want
            torch.cuda.empty_cache()


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", required=True, help="JSON written by rank 0")
    args = p.parse_args()

    import torch
    import torch.distributed as dist

    from ssp_x_vit_tpu_torch.parallel import mesh as M

    t0 = time.perf_counter()
    rank, world = M.init_distributed("cuda")
    device = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = Run(rank)
    nccl = ".".join(str(v) for v in torch.cuda.nccl.version())
    run.log(f"world {world} over NCCL {nccl} ({torch.cuda.get_device_name(device)}); "
            f"joined in {time.perf_counter() - t0:.1f} s")
    if rank == 0:
        with run.timed("kernels at tp=2 / tp=4 shard shapes"):
            shard_kernels(run, device)
    dist.barrier()
    with tempfile.TemporaryDirectory() as work:
        vit_parts(run, device, world, work)
    llm_parts(run, device, world)
    dist.barrier()
    if rank == 0:
        with open(args.out, "w") as f:
            json.dump({"world": world, "nccl": nccl, "device": torch.cuda.get_device_name(device),
                       "seconds": run.seconds, "launches": run.launches, "checks": run.checks,
                       "total_seconds": round(time.perf_counter() - t0, 3)}, f, indent=1)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
