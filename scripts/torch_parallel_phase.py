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
        self.part_launches, self.hop_times = {}, {}

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


# ------------------------------------------ pipeline, ring, expert, DeepSeek ---

# The ring's attention shapes: Llama-2-7B (32 heads, head_dim 128) and
# Gemma-2-9B's published config.json (16 heads over 8 KV heads, head_dim 256,
# sliding window 4096, attention softcap 50), s = 8192 cut into 4 chunks.
RING_SHAPES = {
    "Llama-2-7B": dict(h=32, hkv=32, hd=128, window=None, softcap=None),
    "Gemma-2-9B": dict(h=16, hkv=8, hd=256, window=4096, softcap=50.0),
}
RING_S, RING_N = 8192, 4
LSE_TOL = 1e-3          # absolute, a hop's fp32 lse against the plain version's
OFFSETS = ((4096, 4096), (2048, 3000), (1000, None))   # (q_offset, window) at Gemma-2 widths
PIPE_LAYERS, PIPE_M, PIPE_B, PIPE_S = 4, 4, 4, 2048
SP_WINDOWS, SP_SEQ = 2, 8192
MICRO_RMS = 1e-2        # bf16 where microbatching changes the GEMMs' row counts
LOSS_RTOL = 1e-5
DS_LAYERS, DS_EXPERTS, DS_SEQ = 2, 32, 2048


def rel_rms(got, ref) -> float:
    d = (got.float() - ref.float()).pow(2).mean().sqrt()
    return float(d / ref.float().pow(2).mean().sqrt().clamp_min(1e-30))


def _plain_hop(q, k, v, **kw):
    """flash_attention_plain(with_lse=True) a KV head group at a time (the
    fp32 [s, s] logits of every head at once would not fit)."""
    import torch

    from ssp_x_vit_tpu_torch.ops.kernels.flash_attention import flash_attention_plain

    rep = q.shape[1] // k.shape[1]
    outs, lses = [], []
    for j in range(k.shape[1]):
        o, lse = flash_attention_plain(q[:, j * rep:(j + 1) * rep], k[:, j:j + 1],
                                       v[:, j:j + 1], with_lse=True, **kw)
        outs.append(o)
        lses.append(lse)
    return torch.cat(outs, 1), torch.cat(lses, 1)


def _virtual_ring(q, k, v, c, *, shift=0, drop=None):
    """The ring's hops over RING_N chunks in one process (``ring_hop`` /
    ``merge_hop``); ``shift`` chunks added to every hop's offset (the diagonal
    hop then sees its own chunk's later keys) and ``drop`` = (p, src) a hop
    left out make the teeth."""
    import torch

    from ssp_x_vit_tpu_torch.parallel.ring_attention import merge_hop, ring_hop

    qs, ks, vs = (t.chunk(RING_N, dim=2) for t in (q, k, v))
    outs = []
    for p in range(RING_N):
        acc = None
        for src in range(p, -1, -1):
            if (p, src) == drop:
                continue
            acc = merge_hop(acc, ring_hop(qs[p].contiguous(), ks[src].contiguous(),
                                          vs[src].contiguous(), p + shift, src,
                                          window=c["window"],
                                          softcap=c["softcap"]))
        outs.append(acc[0].to(q.dtype))
    return torch.cat(outs, 2)


def _hop_bound(b, h, hkv, sl, hd, pairs, elem=2):
    """(bound ms, bound_by) of one hop: 4 hd operations a kept (query, key) pair;
    q, k, v read and out written once, the fp32 lse written once."""
    nbytes = (2 * b * h * sl * hd + 2 * b * hkv * sl * hd) * elem + 4 * b * h * sl
    return cs._bound(4 * hd * pairs * b * h, nbytes, "bfloat16")


def ring_kernels(run: Run, device) -> None:
    """Rank 0 (not counted): the virtual ring on the flash kernel at both ring
    shapes against the unsharded kernel and the plain version (``flash_errors``
    within ``FLASH_LIMITS``), each hop's lse against the plain lse, and the
    teeth (every off-diagonal hop one chunk further, a dropped hop); row 5 at
    query offsets against its plain version with the same teeth; the hops'
    times beside their bound and SDPA's."""
    import torch
    import torch.nn.functional as F

    from ssp_x_vit_tpu_torch.ops.kernels.flash_attention import (
        FLASH_LIMITS, flash_agrees, flash_attention_forward, flash_errors,
    )
    from ssp_x_vit_tpu_torch.parallel.ring_attention import hop_mask

    gen = torch.Generator(device=device)
    gen.manual_seed(22)
    rel_lim, tile_lim, _ = FLASH_LIMITS[torch.bfloat16]
    sl = RING_S // RING_N
    hops = {}
    for name, c in RING_SHAPES.items():
        q = torch.randn(1, c["h"], RING_S, c["hd"], generator=gen, device=device).bfloat16()
        k, v = (torch.randn(1, c["hkv"], RING_S, c["hd"], generator=gen, device=device)
                .bfloat16() for _ in range(2))
        kw = dict(causal=True, window=c["window"], softcap=c["softcap"])
        whole = flash_attention_forward(q, k, v, **kw)[0]
        plain = _plain_hop(q, k, v, **kw)[0]
        ring = _virtual_ring(q, k, v, c)
        for ref, what in ((plain, "plain version"), (whole, "unsharded kernel")):
            rel, tile = flash_errors(ring, ref)
            run.check(f"virtual ring {name} s={RING_S} N={RING_N} vs the {what}: relative "
                      "RMS error", rel, rel_lim)
            run.check(f"virtual ring {name} vs the {what}: worst 64-row tile", tile, tile_lim)
        worst = 0.0
        for p in range(RING_N):
            qc = q[:, :, p * sl:(p + 1) * sl].contiguous()
            for src in range(p + 1):
                mask = hop_mask(p, src, sl, window=c["window"])
                if mask is None:
                    continue
                off, hc, hw = mask
                kc, vc = (t[:, :, src * sl:(src + 1) * sl].contiguous() for t in (k, v))
                got = flash_attention_forward(qc, kc, vc, causal=hc, window=hw,
                                              softcap=c["softcap"], with_lse=True, q_offset=off)
                want = _plain_hop(qc, kc, vc, causal=hc, window=hw, softcap=c["softcap"],
                                  q_offset=off)
                same_inf = bool(torch.equal(torch.isinf(got[1]), torch.isinf(want[1])))
                run.check(f"hop {name} ({p}, {src}) lse -inf on the same rows", int(same_inf),
                          1, "==")
                fin = torch.isfinite(want[1])
                worst = max(worst, float((got[1] - want[1])[fin].abs().max()))
        run.check(f"hops {name}: max |lse - plain lse|", worst, LSE_TOL)
        for what, bad in (("every hop's offset one chunk further",
                           _virtual_ring(q, k, v, c, shift=1)),
                          ("hop (3, 2) dropped", _virtual_ring(q, k, v, c, drop=(3, 2)))):
            run.check(f"virtual ring {name} with {what} rejected by the flash criteria",
                      int(flash_agrees(bad, plain)), 0, "==")
        hops[name] = (q[:, :, 3 * sl:].contiguous(), k[:, :, :sl].contiguous(),
                      v[:, :, :sl].contiguous(), k[:, :, 2 * sl:3 * sl].contiguous(),
                      v[:, :, 2 * sl:3 * sl].contiguous())
        del q, k, v, whole, plain, ring
        torch.cuda.empty_cache()

    q, k0, v0, _, _ = hops["Gemma-2-9B"]
    cap = RING_SHAPES["Gemma-2-9B"]["softcap"]
    for off, window in OFFSETS:
        got = flash_attention_forward(q, k0, v0, causal=True, window=window, softcap=cap,
                                      with_lse=True, q_offset=off)[0]
        want = _plain_hop(q, k0, v0, causal=True, window=window, softcap=cap, q_offset=off)[0]
        rel, tile = flash_errors(got, want)
        run.check(f"row 5 at q_offset {off}, window {window}, Gemma-2-9B widths: relative "
                  "RMS error", rel, rel_lim)
        run.check(f"row 5 at q_offset {off}, window {window}: worst 64-row tile", tile,
                  tile_lim)
        shifted = flash_attention_forward(q, k0, v0, causal=True, window=window, softcap=cap,
                                          q_offset=off + sl)[0]
        run.check(f"row 5 at q_offset {off + sl} against the plain version at {off} rejected",
                  int(flash_agrees(shifted, want)), 0, "==")

    timings = {}
    for label, name, kw, sdpa in (
            ("diagonal", "Llama-2-7B", dict(causal=True), dict(is_causal=True)),
            ("full off-diagonal", "Llama-2-7B", dict(causal=False), dict(is_causal=False)),
            ("windowed off-diagonal (q_offset 4096)", "Gemma-2-9B",
             dict(causal=True, window=4096, softcap=cap, q_offset=2 * sl), None)):
        c = RING_SHAPES[name]
        q, k0, v0, k2, v2 = hops[name]
        kk, vv = (k2, v2) if label == "diagonal" else (k0, v0)   # values do not matter here
        ms = cs.time_ms(lambda: flash_attention_forward(q, kk, vv, with_lse=True, **kw), 20)
        if label == "diagonal":
            pairs = sl * (sl + 1) // 2
        elif label.startswith("full"):
            pairs = sl * sl
        else:
            pairs = sum(max(0, min(sl, r + 2 * sl + 1) - max(0, r + 2 * sl - 4096 + 1))
                        for r in range(sl))
        bound, by = _hop_bound(1, c["h"], c["hkv"], sl, c["hd"], pairs)
        sdpa_ms = None
        if sdpa is not None:
            sdpa_ms = cs.time_ms(lambda: F.scaled_dot_product_attention(q, kk, vv, **sdpa), 20)
        timings[f"{label} {name}"] = dict(ms=round(ms, 4), bound_ms=round(bound, 4),
                                          bound_by=by,
                                          sdpa_ms=None if sdpa_ms is None else round(sdpa_ms, 4),
                                          shape=[1, c["h"], c["hkv"], sl, c["hd"]])
        run.log(f"hop {label} {name} [1, {c['h']}/{c['hkv']}, {sl}, {c['hd']}] bf16 with lse: "
                f"{ms:.4f} ms (bound {bound:.4f} ms, {by}; SDPA "
                f"{'n/a' if sdpa_ms is None else f'{sdpa_ms:.4f} ms'})")
    run.hop_times = timings
    del hops
    torch.cuda.empty_cache()


def _parallel_launches(run: Run, part: str, fn, need=()):
    """``run.counted(fn)`` with the launches of this part kept apart; each
    kernel of ``need`` must have launched."""
    before = dict(run.launches)
    out = run.counted(fn)
    mine = {k: run.launches[k] - before[k] for k in run.launches if run.launches[k] - before[k]}
    run.part_launches[part] = mine
    for name in need:
        run.check(f"{part}: {name} launches", mine.get(name, 0), 0, ">")
    return out


def seq_parts(run: Run, device, world: int) -> None:
    """Sequence-parallel perplexity at Llama-2-7B widths (2 layers, bf16), 2
    windows of 8192, against ``evaluate_perplexity``; on more cards also the
    world's ring at both ring shapes against the unsharded kernel."""
    import numpy as np
    import torch

    from ssp_x_vit_tpu_torch.llm.evaluation import evaluate_perplexity
    from ssp_x_vit_tpu_torch.llm.model import LlamaConfig, init_llama_params
    from ssp_x_vit_tpu_torch.ops.kernels.flash_attention import (
        FLASH_LIMITS, flash_attention_forward, flash_errors,
    )
    from ssp_x_vit_tpu_torch.parallel import mesh as M
    from ssp_x_vit_tpu_torch.parallel.collectives import gather_along
    from ssp_x_vit_tpu_torch.parallel.ring_attention import (
        evaluate_perplexity_seq_parallel, ring_attention,
    )

    cfg = LlamaConfig(**dict(cs.LLAMA_2_7B, num_layers=2))
    gen = torch.Generator(device=device)
    gen.manual_seed(23)
    params = init_llama_params(gen, cfg, dtype=torch.bfloat16, device=device)
    ids = np.random.default_rng(23).integers(0, cfg.vocab_size, SP_WINDOWS * SP_SEQ)
    with run.timed(f"perplexity {SP_WINDOWS} x {SP_SEQ} single process"):
        single = evaluate_perplexity(params, cfg, ids, seq_len=SP_SEQ, enable_tqdm=False)
    shapes = [(1, 1)] if world == 1 else [(1, world), (2, world // 2)]
    for shape in shapes:
        mesh = M.make_seq_mesh(*shape)
        with run.timed(f"seq-parallel perplexity {SP_WINDOWS} x {SP_SEQ} mesh {shape}"):
            ppl = _parallel_launches(
                run, f"seq-parallel perplexity mesh {shape}",
                lambda: evaluate_perplexity_seq_parallel(params, cfg, mesh, ids, seq_len=SP_SEQ,
                                                         compute_dtype=torch.bfloat16),
                need=("flash_attention",))
        run.log(f"seq-parallel perplexity mesh {shape} {ppl!r}, single process {single!r}")
        run.check(f"seq-parallel perplexity mesh {shape} relative difference",
                  abs(ppl - single) / single, EXACT_TOL if world == 1 else MULTI_PPL_RTOL)
    del params
    torch.cuda.empty_cache()
    if world == 1:
        return
    rel_lim, tile_lim, _ = FLASH_LIMITS[torch.bfloat16]
    for name, c in RING_SHAPES.items():
        q = torch.randn(1, c["h"], RING_S, c["hd"], generator=gen, device=device).bfloat16()
        k, v = (torch.randn(1, c["hkv"], RING_S, c["hd"], generator=gen, device=device)
                .bfloat16() for _ in range(2))
        whole = flash_attention_forward(q, k, v, causal=True, window=c["window"],
                                        softcap=c["softcap"])[0]
        for shape in shapes:
            mesh = M.make_seq_mesh(*shape)
            g, n, r = mesh.get_group("seq"), M.axis_size(mesh, "seq"), M.axis_index(mesh, "seq")
            sl = RING_S // n
            local = [t[:, :, r * sl:(r + 1) * sl].contiguous() for t in (q, k, v)]
            with run.timed(f"ring attention {name} s={RING_S} mesh {shape}"):
                out = _parallel_launches(run, f"ring attention {name} mesh {shape}",
                                         lambda: ring_attention(*local, g, n_chunks=n,
                                                                window=c["window"],
                                                                softcap=c["softcap"]),
                                         need=("flash_attention",))
            full = gather_along(out, 2, g)
            rel, tile = flash_errors(full, whole)
            run.check(f"ring {name} mesh {shape} vs the unsharded kernel: relative RMS", rel,
                      rel_lim)
            run.check(f"ring {name} mesh {shape}: worst 64-row tile", tile, tile_lim)


def _grad_leaves(tree, leaves):
    """{(key, block key, layer): gradient} of a ``trainable_tree``'s leaves."""
    out, i = {}, 0
    for k, v in tree.items():
        if isinstance(v, dict):
            for bk, layers in v.items():
                for j in range(len(layers)):
                    out[(k, bk, j)] = leaves[i].grad
                    i += 1
        else:
            out[(k,)] = leaves[i].grad
            i += 1
    return out


def _single_reference(params, cfg, toks):
    """(logits, loss, {(key, block key, layer): gradient}) of the single
    process: ``llama_forward`` and the train step's forward and backward."""
    import torch

    from ssp_x_vit_tpu_torch.llm.model import llama_forward
    from ssp_x_vit_tpu_torch.llm.train import next_token_loss, trainable_tree

    with torch.no_grad():
        logits = llama_forward(params, toks, cfg)[0]
    tree, leaves = trainable_tree(params)
    loss = next_token_loss(tree, toks, cfg)   # make_llama_train_step's forward
    loss.backward()
    return logits, float(loss.detach()), _grad_leaves(tree, leaves)


def _grad_keys(shard, layers):
    """(key, block key, global layer) or (key,) of each leaf of a pipeline
    shard, in ``optim.tree_leaves`` order."""
    keys = []
    for k, v in shard.items():
        if isinstance(v, dict):
            keys += [(k, bk, layers[j]) for bk in v for j in range(v[bk].shape[0])]
        else:
            keys.append((k,))
    return keys


def pipeline_parts(run: Run, device, world: int) -> None:
    """The pipeline at Llama-2-7B widths cut to 4 layers (bf16), M = 4, b = 4,
    s = 2048: the forward's logits, one GPipe and one 1F1B step's loss and
    gradients (before the update), then each step's update. One card: each
    against the single process. More cards: the logits against the
    tensor-parallel forward on the same ``model`` cut (the same arithmetic),
    the loss and gradients against the same pipeline at M = 1 (what
    microbatching changes: the GEMMs' row counts), the loss also against the
    single process."""
    import numpy as np
    import torch

    from ssp_x_vit_tpu_torch.llm.model import LlamaConfig, init_llama_params, llama_forward
    from ssp_x_vit_tpu_torch.llm.optim import AdamW
    from ssp_x_vit_tpu_torch.parallel import mesh as M
    from ssp_x_vit_tpu_torch.parallel import pipeline as PP
    from ssp_x_vit_tpu_torch.parallel.llm_sharding import shard_llama_params

    cfg = LlamaConfig(**dict(cs.LLAMA_2_7B, num_layers=PIPE_LAYERS))
    gen = torch.Generator(device=device)
    gen.manual_seed(24)
    params = init_llama_params(gen, cfg, dtype=torch.bfloat16, device=device)
    tokens = np.random.default_rng(24).integers(0, cfg.vocab_size, (PIPE_B, PIPE_S))
    toks = torch.from_numpy(tokens).to(device)
    with run.timed("pipeline reference forward, loss and gradients single process"):
        single_logits, single_loss, single_grads = _single_reference(params, cfg, toks)
    shapes = [(1, 1, 1)] if world == 1 else [(1, 2, 2), (1, 4, 1)]
    for shape in shapes:
        mesh = M.make_pipeline_mesh(*shape)
        tp = shape[2]
        layers = PP._stage_layers(mesh, cfg.num_layers)
        shard = PP.shard_llama_params_pipeline(params, mesh, cfg)
        ref_logits = single_logits
        if tp > 1:
            tpm = M.make_mesh(model=tp)
            with torch.no_grad():
                ref_logits = llama_forward(shard_llama_params(params, tpm, cfg), toks, cfg,
                                           tp_group=tpm.get_group("model"))[0]
        fwd = PP.make_pipeline_forward(mesh, cfg, num_microbatches=PIPE_M,
                                       compute_dtype=torch.bfloat16)
        with run.timed(f"pipeline forward mesh {shape}"):
            logits = _parallel_launches(run, f"pipeline forward mesh {shape}",
                                        lambda: fwd(shard, tokens), need=("flash_attention",))
        run.log(f"pipeline forward mesh {shape} logits relative RMS against the single "
                f"process: {rel_rms(logits, single_logits)!r}")
        run.check(f"pipeline forward mesh {shape} logits relative RMS against "
                  f"{'the single process' if world == 1 else f'the tp={tp} forward'}",
                  rel_rms(logits, ref_logits), MICRO_RMS)
        del logits, ref_logits
        ref_loss, want = single_loss, single_grads
        if world > 1:
            with run.timed(f"pipeline M=1 loss and gradients mesh {shape}"):
                ref_loss, ref = PP.make_pipeline_train_step(
                    mesh, cfg, num_microbatches=1, compute_dtype=torch.bfloat16).grads(
                        shard, tokens)
            ref_loss = float(ref_loss)
            want = dict(zip(_grad_keys(shard, layers), ref))
        for sched in PP.SCHEDULES:
            opt = AdamW(1e-4)
            step = PP.make_pipeline_train_step(mesh, cfg, opt, num_microbatches=PIPE_M,
                                               compute_dtype=torch.bfloat16, schedule=sched)
            with run.timed(f"pipeline {sched} loss and gradients mesh {shape}"):
                loss, grads = _parallel_launches(
                    run, f"pipeline {sched} gradients mesh {shape}",
                    lambda: step.grads(shard, tokens),
                    need=("flash_attention", "flash_attention_bwd_dq", "flash_attention_bwd_dkv"))
            loss = float(loss)
            what = "the single process" if world == 1 else "the pipeline at M=1"
            run.log(f"pipeline {sched} mesh {shape} loss {loss!r}, {what} {ref_loss!r}, single "
                    f"process {single_loss!r}; 1F1B held at most {step.schedule.held_max} stage "
                    "inputs")
            run.check(f"pipeline {sched} mesh {shape} loss relative difference from {what}",
                      abs(loss - ref_loss) / abs(ref_loss), LOSS_RTOL)
            if world > 1:
                run.check(f"pipeline {sched} mesh {shape} loss relative difference from the "
                          "single process", abs(loss - single_loss) / abs(single_loss),
                          MULTI_LOSS_RTOL)
            pairs = [(g, want[key]) for g, key in zip(grads, _grad_keys(shard, layers))]
            worst = max(rel_rms(g, w) for g, w in pairs)
            whole = rel_rms(torch.cat([g.float().reshape(-1) for g, _ in pairs]),
                            torch.cat([w.float().reshape(-1) for _, w in pairs]))
            run.log(f"pipeline {sched} mesh {shape} gradients relative RMS against {what}: all "
                    f"leaves {whole!r}, worst leaf {worst!r}")
            if world == 1:
                run.check(f"pipeline {sched} mesh {shape} worst leaf gradient relative RMS "
                          f"against {what}", worst, MICRO_RMS)
            else:   # the gradients' relative RMS where microbatching changes the GEMMs' rows
                run.check(f"pipeline {sched} mesh {shape} gradients relative RMS against {what}",
                          whole, MICRO_RMS)
            del grads, pairs
            fresh = PP.shard_llama_params_pipeline(
                {k: ({kk: vv.clone() for kk, vv in v.items()} if isinstance(v, dict)
                     else v.clone()) for k, v in params.items()}, mesh, cfg)
            state = opt.init(fresh)
            with run.timed(f"pipeline {sched} train step mesh {shape}"):
                _, _, loss2 = _parallel_launches(run, f"pipeline {sched} step mesh {shape}",
                                                 lambda: step(fresh, state, tokens))
            run.check(f"pipeline {sched} step mesh {shape} loss as before the update",
                      abs(float(loss2) - loss) / abs(loss), LOSS_RTOL)
            del fresh, state
            torch.cuda.empty_cache()
        del shard, want
        torch.cuda.empty_cache()
    del params, single_logits, single_grads
    torch.cuda.empty_cache()


def _v3(layers: int, dense: bool = False):
    import dataclasses

    from ssp_x_vit_tpu_torch.llm.deepseek import config_from_hf_deepseek

    cfg = dataclasses.replace(config_from_hf_deepseek(cs.DEEPSEEK_V3_HF), num_layers=layers,
                              first_k_dense_replace=1, n_routed_experts=DS_EXPERTS)
    if dense:
        cfg = dataclasses.replace(cfg, n_routed_experts=0, n_shared_experts=0)
    return cfg


def deepseek_parts(run: Run, device, world: int) -> None:
    """DeepSeek-V3 widths cut to 2 layers (1 dense + 1 MoE of 32 routed
    experts; bf16 weights): ``deepseek_generate`` on ``shard_deepseek_params``
    (tp = the world), the MLA ring perplexity at s = 2048, one FSDP step; the
    dense variant's pipeline forward."""
    import numpy as np
    import torch

    from ssp_x_vit_tpu_torch.llm.deepseek import (
        deepseek_forward, deepseek_generate, init_deepseek_params,
    )
    from ssp_x_vit_tpu_torch.llm.evaluation import evaluate_perplexity
    from ssp_x_vit_tpu_torch.llm.optim import AdamW, tree_leaves
    from ssp_x_vit_tpu_torch.llm.train import make_llama_train_step
    from ssp_x_vit_tpu_torch.parallel import deepseek_parallel as DP
    from ssp_x_vit_tpu_torch.parallel import llm_sharding as S
    from ssp_x_vit_tpu_torch.parallel import mesh as M
    from ssp_x_vit_tpu_torch.parallel.ring_attention import evaluate_perplexity_seq_parallel

    cfg = _v3(DS_LAYERS)
    gen = torch.Generator(device=device)
    gen.manual_seed(25)
    params = init_deepseek_params(gen, cfg, dtype=torch.bfloat16, device=device)
    bias = params["moe_blocks"]["e_bias"]
    bias.copy_((torch.rand(bias.shape, generator=gen, device=device) - 0.5) * 0.1)
    rng = np.random.default_rng(25)
    prompts = rng.integers(0, cfg.vocab_size, (2, 64))
    with run.timed("deepseek_generate b=2 +16 single process"):
        ref = deepseek_generate(params, cfg, prompts, max_new_tokens=16)
    tpm = M.make_mesh(model=world)
    shard = S.shard_deepseek_params(params, tpm, cfg)
    with run.timed(f"deepseek_generate b=2 +16 tp={world}"):
        outs = _parallel_launches(run, f"deepseek_generate tp={world}",
                                  lambda: deepseek_generate(shard, cfg, prompts,
                                                            max_new_tokens=16,
                                                            tp_group=tpm.get_group("model")))
    del shard
    if world == 1:
        run.check("deepseek tp=1 tokens differing from the single process",
                  sum(int((a != b).sum()) for a, b in zip(outs, ref)), 0, "==")
    else:
        worst = 0.0
        with torch.no_grad():
            for prompt, seq in zip(prompts, outs):
                toks = torch.as_tensor(seq[None].astype("int64"), device=device)
                logits = deepseek_forward(params, toks[:, :-1], cfg)
                for pos in range(len(prompt), len(seq)):
                    row = logits[0, pos - 1]
                    best = float(row.max())
                    worst = max(worst, (best - float(row[int(seq[pos])])) / max(1.0, abs(best)))
        run.check(f"deepseek tp={world} served tokens' worst logit shortfall", worst,
                  MULTI_TOKEN_TOL)

    del outs, ref
    torch.cuda.empty_cache()
    ids = rng.integers(0, cfg.vocab_size, 2 * DS_SEQ)
    with run.timed(f"deepseek perplexity 2 x {DS_SEQ} single process"):
        single = evaluate_perplexity(params, cfg, ids, seq_len=DS_SEQ, enable_tqdm=False)
    mesh = M.make_seq_mesh(1, world)
    with run.timed(f"MLA ring perplexity 2 x {DS_SEQ} mesh (1, {world})"):
        ppl = _parallel_launches(run, f"MLA ring perplexity mesh (1, {world})",
                                 lambda: evaluate_perplexity_seq_parallel(params, cfg, mesh, ids,
                                                                          seq_len=DS_SEQ))
    run.log(f"MLA ring perplexity {ppl!r}, single process {single!r}")
    run.check(f"MLA ring perplexity mesh (1, {world}) relative difference",
              abs(ppl - single) / single, EXACT_TOL if world == 1 else MULTI_PPL_RTOL)

    tokens = rng.integers(0, cfg.vocab_size, (max(2, world), 257))

    def clone():
        return {k: ({kk: vv.clone() for kk, vv in v.items()} if isinstance(v, dict)
                    else v.clone()) for k, v in params.items()}

    opt = AdamW(1e-4)
    ref_params = clone()
    state = opt.init(ref_params)
    with run.timed("deepseek train step single process"):
        _, _, ref_loss = make_llama_train_step(cfg, opt)(ref_params, state, tokens)
    # the updated reference waits on the host: the FSDP step below holds the
    # tree, its gradients, both moments and AdamW's fp32 copies of a leaf
    ref_leaves = [t.cpu() for t in tree_leaves(ref_params)]
    del state, ref_params
    dpm = M.make_mesh(model=1)
    specs = S.fsdp_llama_param_specs_like(params, M.axis_size(dpm, "data"))
    fsdp = S.shard_llama_params_fsdp(params, dpm)   # params is not used after this step
    bias = fsdp["moe_blocks"]["e_bias"].clone()
    del params
    torch.cuda.empty_cache()
    state = opt.init(fsdp)
    with run.timed(f"deepseek FSDP step dp={world}"):
        fsdp, state, loss = _parallel_launches(
            run, f"deepseek FSDP step dp={world}",
            lambda: S.make_fsdp_llama_train_step(dpm, cfg, opt, specs=specs)(fsdp, state, tokens))
    loss, rl = float(loss), float(ref_loss)
    run.check(f"deepseek FSDP dp={world} loss relative difference", abs(loss - rl) / abs(rl),
              EXACT_TOL if world == 1 else MULTI_LOSS_RTOL)
    run.check(f"deepseek FSDP dp={world} e_bias changed elements",
              int((fsdp["moe_blocks"]["e_bias"] != bias).sum()), 0, "==")
    if world == 1:
        diff = max(float((a.float() - b.to(a.device).float()).abs().max())
                   for a, b in zip(tree_leaves(fsdp), ref_leaves))
        run.check("deepseek FSDP dp=1 parameters max |difference|", diff, EXACT_TOL)
    del fsdp, state, ref_leaves
    torch.cuda.empty_cache()

    dcfg = _v3(DS_LAYERS, dense=True)
    dparams = init_deepseek_params(gen, dcfg, dtype=torch.bfloat16, device=device)
    tokens = rng.integers(0, dcfg.vocab_size, (2, 512))
    shape = (1, 1, 1) if world == 1 else (1, 2, 2)
    with torch.no_grad():   # the same work without the pipeline on the same model cut
        if shape[2] == 1:
            want = deepseek_forward(dparams, torch.from_numpy(tokens).to(device), dcfg)
        else:
            tpm = M.make_mesh(model=shape[2])
            want = deepseek_forward(S.shard_deepseek_params(dparams, tpm, dcfg),
                                    torch.from_numpy(tokens).to(device), dcfg,
                                    tp_group=tpm.get_group("model"))
    pm = M.make_pipeline_mesh(*shape)
    sh = DP.shard_deepseek_params_pipeline(dparams, pm, dcfg)
    fwd = DP.make_deepseek_pipeline_forward(pm, dcfg, num_microbatches=2,
                                            compute_dtype=torch.bfloat16)
    with run.timed(f"deepseek dense pipeline forward mesh {shape}"):
        got = _parallel_launches(run, f"deepseek dense pipeline forward mesh {shape}",
                                 lambda: fwd(sh, tokens))
    run.check(f"deepseek dense pipeline mesh {shape} logits relative RMS against tp="
              f"{shape[2]} without the pipeline", rel_rms(got, want), MICRO_RMS)
    del dparams, sh, got, want
    torch.cuda.empty_cache()


def expert_parts(run: Run, device, world: int) -> None:
    """Mixtral-8x7B widths cut to 2 layers: ``shard_moe_llama_params`` on the
    (1, world) expert mesh (8 / world experts a card) against ``llama_forward``.
    Both runs' top-2 choices are recorded (``parallel.moe._top_k``): a token
    whose second-layer choice differs (the experts' bf16 sums over the cards
    move a near-tie) is counted, and the logits of the tokens routed alike in
    both layers are held to the single process's."""
    import numpy as np
    import torch

    from ssp_x_vit_tpu_torch.llm.model import llama_forward
    from ssp_x_vit_tpu_torch.parallel import mesh as M
    from ssp_x_vit_tpu_torch.parallel import moe as MO
    from ssp_x_vit_tpu_torch.parallel.llm_sharding import shard_moe_llama_params

    params, cfg = cs.make_mixtral(device, 2)
    toks = torch.from_numpy(np.random.default_rng(26).integers(0, cfg.vocab_size, (2, 512))
                            ).to(device)
    chosen, top_k = [], MO._top_k

    def recording(probs, k):
        out = top_k(probs, k)
        chosen.append(out[1].sort(dim=-1).values)
        return out

    MO._top_k = recording
    try:
        with torch.no_grad():
            want = llama_forward(params, toks, cfg)[0]
            em = M.make_expert_mesh(1, world)
            shard = shard_moe_llama_params(params, em)
            with run.timed(f"MoE-llama expert forward mesh (1, {world})"):
                got = _parallel_launches(
                    run, f"MoE-llama expert forward mesh (1, {world})",
                    lambda: llama_forward(shard, toks, cfg,
                                          expert_group=em.get_group("expert"))[0],
                    need=("flash_attention",))
    finally:
        MO._top_k = top_k
    layers = cfg.num_layers
    alike = torch.stack([(chosen[i] == chosen[layers + i]).all(-1) for i in range(layers)]
                        ).all(0).reshape(toks.shape)
    moved = int((~alike).sum())
    run.log(f"MoE-llama expert mesh (1, {world}): {moved} of {alike.numel()} tokens routed to "
            f"other experts than the single process; logits relative RMS over every token "
            f"{rel_rms(got, want)!r}")
    run.check(f"MoE-llama expert mesh (1, {world}) logits relative RMS over the tokens routed "
              "alike", rel_rms(got[alike], want[alike]), EXACT_TOL if world == 1 else MULTI_LOSS_RTOL)
    if world == 1:
        run.check("MoE-llama expert mesh (1, 1) tokens routed to other experts", moved, 0, "==")
    del params, shard, got, want
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
        with run.timed("virtual ring and row 5 at offsets"):
            ring_kernels(run, device)
    dist.barrier()
    seq_parts(run, device, world)
    pipeline_parts(run, device, world)
    deepseek_parts(run, device, world)
    expert_parts(run, device, world)
    dist.barrier()
    if rank == 0:
        with open(args.out, "w") as f:
            json.dump({"world": world, "nccl": nccl, "device": torch.cuda.get_device_name(device),
                       "seconds": run.seconds, "launches": run.launches, "checks": run.checks,
                       "part_launches": run.part_launches, "hop_times": run.hop_times,
                       "total_seconds": round(time.perf_counter() - t0, 3)}, f, indent=1)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
