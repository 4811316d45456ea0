"""Auto-2SSP ViT driver CLI on PyTorch (counterpart of
``ssp_x_vit_tpu/cli/auto_2ssp.py``): the same flags, stages, artifact formats,
[PLAN]/[PLAN-LOG]/[S1-LOG]/[ARTIFACT]/[SUMMARY] output and report schema.

Usage (on the card; ``--backend cpu`` runs the plain PyTorch path instead):
  python -m ssp_x_vit_tpu_torch.cli.auto_2ssp --model vit-b16 --dataset synthetic \
      --target 0.25 --stage both --eval-batches 2

The recovery flow is the JAX CLI's: ``--use-adapter`` / ``--replace-classifier``
/ ``--load-adapter`` set the head, ``--do-finetune [--freeze-backbone]`` trains
it (or the whole model) before the baseline metrics, ``--save-adapter`` writes
the head, ``--quantize int8`` evaluates the int8 weight-only model.
``--model`` also takes a local HF ViT directory, ``--checkpoint`` an AugReg
``.npz`` or an HF state dict, and ``--save-pruned-model --save-format hf``
writes the pruned model as an HF directory where it has an HF form (else the
native one, with the JAX CLI's notice). ``--use-srp-checkpoint`` loads a local
SRP AugReg checkpoint chosen from ``index.csv`` (``data/srp.py``; nothing is
downloaded), ``--dataset cifar10|cifar100`` (``--load-cifar``) reads CIFAR
from its on-disk batch files, ``--export-framework-prefix`` writes the
Pures-framework score and mask files.

``--data-parallel`` splits every test and calibration batch over the ranks
of a data mesh (``parallel/mesh.py``), one process per card: the top-1
counts, the candidates' scores and the FFN importance sums are summed over
the ranks, so every rank makes the same decisions; rank 0 alone prints,
measures latency and writes the report and artifacts. From the command line
with more than one visible card the CLI starts one worker per card itself,
under ``torch.distributed.run`` (:func:`launcher_argv`); under ``torchrun``
each process joins the world from its environment (``--backend cpu``: gloo
over CPU processes). In one
process with one device it is a no-op, as the JAX CLI on one chip; ``run()``
in one process with more than one card raises, since the workers are
processes.

``run(args, model=None)`` runs on ``model=(params, cfg)`` when the caller built
one (the CLI's setup otherwise), and also returns, beside the report, under
"kernel_launches" and "phase_seconds", the kernel launches and the wall seconds
of each phase of the run (setup, finetune, baseline, candidates, stats, stage1,
materialized, quantize; finetune and quantize only with their flags), under
"finetune_losses" each finetune step's loss, and under "model" the final
(params, cfg); none of these is saved in the report files.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from pathlib import Path
from typing import Any, Dict

import numpy as np


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Auto 2SSP for ViT with single TARGET sparsity (PyTorch/CUDA).")
    p.add_argument("--model", type=str, default="google/vit-base-patch16-224",
                   help="Framework or HF model dir, named arch (vit-b16/s16/ti16), or 'tiny'")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="Optional weights: framework or AugReg .npz, or an HF state dict "
                        "(.safetensors/.bin/.pt)")
    p.add_argument("--target", type=float, default=None, help="Global target sparsity (0..1); used when --stage both")
    p.add_argument("--stage", type=str, default="both", choices=["both", "s1", "s2"])
    p.add_argument("--s1-sparsity", type=float, default=None, help="FFN fraction per block (stage s1)")
    p.add_argument("--s2-sparsity", type=float, default=None, help="Attention/blocks fraction (stage s2)")
    p.add_argument("--min-remaining", type=int, default=512)
    p.add_argument("--dataset", type=str, default="synthetic", choices=["cifar10", "cifar100", "synthetic"])
    p.add_argument("--load-cifar", action="store_true", help="(compat) same as --dataset cifar10")
    p.add_argument("--calib-per-class", type=int, default=2)
    p.add_argument("--cifar-train-pct", type=float, default=0.25)
    p.add_argument("--cifar-test-pct", type=float, default=0.25)
    p.add_argument("--num-classes", type=int, default=None)
    p.add_argument("--do-finetune", action="store_true")
    p.add_argument("--ft-epochs", type=int, default=1)
    p.add_argument("--ft-lr", type=float, default=5e-5)
    p.add_argument("--freeze-backbone", action="store_true")
    p.add_argument("--replace-classifier", action="store_true")
    p.add_argument("--use-adapter", action="store_true")
    p.add_argument("--adapter-reduction", type=int, default=4)
    p.add_argument("--save-adapter", action="store_true")
    p.add_argument("--load-adapter", type=str, default=None)
    p.add_argument("--eval-batches", type=int, default=5)
    p.add_argument("--depth-importance", type=str, default="copy", choices=["copy", "heuristic"])
    p.add_argument("--force-depth-blocks", type=int, default=None)
    p.add_argument("--save-pruned-model", action="store_true")
    p.add_argument("--save-format", type=str, default="native", choices=["native", "hf"],
                   help="native = npz + config.json (save_pruned_model); hf = HF ViT "
                        "(export_hf_vit), native where the model has no HF form")
    p.add_argument("--quantize", type=str, default="none", choices=["none", "int8"])
    p.add_argument("--out-root", type=str, default=None,
                   help="Root for reports/ artifacts/ pruned_models/ (default: ./runs/auto_2ssp)")
    p.add_argument("--export-framework-prefix", type=str, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--backend", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="Device to run on; cuda raises when no GPU is present")
    p.add_argument("--use-srp-checkpoint", action="store_true")
    p.add_argument("--srp-model-type", type=str, default="B/16", choices=["Ti/16", "S/16", "B/16"])
    p.add_argument("--srp-dataset", type=str, default="cifar100",
                   choices=["cifar100", "oxford-iiit-pet"])
    p.add_argument("--srp-index-csv", type=str, default=None)
    p.add_argument("--srp-models-dir", type=str, default="models")
    p.add_argument("--srp-checkpoint-npz", type=str, default=None)
    p.add_argument("--srp-top10-idx", type=int, default=8)
    p.add_argument("--data-parallel", action="store_true")
    p.add_argument("--ffn-masks-json", type=str, default=None,
                   help="ffn_prune_masks.json from a previous run: reuse its "
                        "per-block masks for stage-1 instead of importance")
    p.add_argument("--attn-indices-json", type=str, default=None,
                   help="attention_pruned_indices.json from a previous run: "
                        "prune exactly those blocks in stage-2 (no search)")
    return p


def _data_parallel_mesh(args):
    """The data mesh of ``--data-parallel`` (under a distributed environment,
    a world of one included), or None where the flag is a no-op (one process
    outside one, one device)."""
    import torch

    from ssp_x_vit_tpu_torch.parallel import mesh as pmesh

    if not args.data_parallel:
        return None
    if pmesh.distributed_env() or torch.distributed.is_initialized():
        pmesh.init_distributed(args.backend)
        return pmesh.make_mesh(model=1)
    if args.backend == "cuda" and torch.cuda.is_available() and torch.cuda.device_count() > 1:
        raise ValueError(
            f"--data-parallel over {torch.cuda.device_count()} CUDA devices runs one process per "
            "device: start it as `python -m ssp_x_vit_tpu_torch.cli.auto_2ssp` (which starts "
            "them under torch.distributed.run) or under torchrun; run() is one process")
    return None


def run(args, model=None) -> Dict[str, Any]:
    """One process of the CLI (a rank of the data mesh under ``--data-parallel``)."""
    import torch

    mesh = _data_parallel_mesh(args)
    lead = mesh is None or torch.distributed.get_rank() == 0
    with contextlib.ExitStack() as stack:
        if not lead:   # rank 0 alone prints
            stack.enter_context(contextlib.redirect_stdout(stack.enter_context(
                open(os.devnull, "w"))))
        return _run(args, model, mesh, lead)


def _run(args, model, mesh, lead: bool) -> Dict[str, Any]:
    import torch

    from ssp_x_vit_tpu_torch.cli.common import resolve_dataset, resolve_model
    from ssp_x_vit_tpu_torch.device import resolve_device
    from ssp_x_vit_tpu_torch.utils.seeding import set_seed
    from ssp_x_vit_tpu_torch.evaluation import evaluate_top1, measure_latency, save_report
    from ssp_x_vit_tpu_torch.models.adapter import load_cifar_adapter, save_cifar_adapter
    from ssp_x_vit_tpu_torch.models.vit import init_head_params, params_device
    from ssp_x_vit_tpu_torch.ops.kernels import launch_counts
    from ssp_x_vit_tpu_torch.pruning import (
        compute_actual_sparsity, count_total_params, materialize_depth_pruning,
        materialize_width_pruning, plan_2ssp_allocation, select_keep_indices,
    )
    from ssp_x_vit_tpu_torch.pruning.depth import select_attention_blocks_to_prune
    from ssp_x_vit_tpu_torch.pruning.interface import Auto2SSPInterface
    import dataclasses

    device = resolve_device(args.backend)
    data_group = None if mesh is None else mesh.get_group("data")

    def from_lead(value: float) -> float:
        """Rank 0's number on every rank (latency is measured there alone)."""
        if mesh is None:
            return value
        t = torch.tensor([value if lead else 0.0], dtype=torch.float64, device=device)
        torch.distributed.broadcast(t, src=0)
        return float(t)

    def latency(p, c) -> float:
        return from_lead(measure_latency(p, c, batch_size=1) if lead else 0.0)

    set_seed(args.seed)
    run_id = time.strftime("%Y%m%d-%H%M%S")
    print(f"[INFO] Using backend: {device.type}"
          + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))

    launches: Dict[str, Dict[str, int]] = {}
    seconds: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(name):
        """Record the kernel launches and the wall seconds of one phase
        (the device is synchronized at its end, so its work is inside)."""
        before, t0 = dict(launch_counts), time.perf_counter()
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds[name] = time.perf_counter() - t0
        launches[name] = {k: launch_counts[k] - before[k] for k in launch_counts}

    ds_name = "cifar10" if args.load_cifar and args.dataset == "synthetic" else args.dataset
    num_classes = args.num_classes or {"cifar10": 10, "cifar100": 100, "synthetic": 10}[ds_name]
    with phase("setup"):
        if args.use_srp_checkpoint:
            from ssp_x_vit_tpu_torch.data.srp import load_srp_model

            params, cfg = load_srp_model(
                args.srp_model_type, args.srp_dataset,
                top10_idx=args.srp_top10_idx, index_csv=args.srp_index_csv,
                models_dir=args.srp_models_dir, checkpoint_npz=args.srp_checkpoint_npz,
                num_classes=num_classes, verbose=True, device=device,
            )
            # SRP models skip head/adapter changes + finetuning (reference :536-539)
            args.use_adapter = args.replace_classifier = args.do_finetune = False
            args.load_adapter = None
            print("[INFO] Using SRP checkpoint; skipping head/adapter changes.")
        elif model is None:
            params, cfg = resolve_model(args.model, num_classes=num_classes,
                                        checkpoint=args.checkpoint, seed=args.seed, device=device)
        else:
            params, cfg = model
            if params_device(params).type != device.type:
                raise ValueError(f"the model is on {params_device(params)}, "
                                 f"--backend is {device.type}")
        # Head config, in the JAX CLI's order
        if args.load_adapter:
            params, cfg = load_cifar_adapter(args.load_adapter, params, cfg)
            print(f"[INFO] Loaded adapter from: {args.load_adapter} "
                  f"(num_labels={cfg.num_classes}, type={cfg.head_type})")
        elif args.use_adapter:
            bottleneck = max(cfg.hidden_size // args.adapter_reduction, 32)
            cfg = dataclasses.replace(cfg, head_type="adapter", adapter_bottleneck=bottleneck)
            params = dict(params)
            params["head"] = init_head_params(cfg, seed=args.seed + 1, device=device)
            print(f"[INFO] Using adapter head with bottleneck={bottleneck}")
        elif args.replace_classifier:
            cfg = dataclasses.replace(cfg, head_type="linear", num_classes=num_classes)
            params = dict(params)
            params["head"] = init_head_params(cfg, seed=args.seed + 1, device=device)
            print(f"[INFO] Replaced classifier for {num_classes} classes")

        train, test, calib = resolve_dataset(
            ds_name, cfg, train_pct=args.cifar_train_pct, test_pct=args.cifar_test_pct,
            calib_per_class=args.calib_per_class, seed=args.seed, device=device)
        test_batches = test.batches(args.eval_batches)
        calib_batches = calib.batches()

    ft_losses = []
    if args.do_finetune:
        # Before the baseline metrics, as the JAX CLI: the evaluations run
        # under torch.inference_mode(), which finetuning cannot follow.
        from ssp_x_vit_tpu_torch.pruning.finetune import finetune

        trainable = "head" if args.freeze_backbone else "all"
        with phase("finetune"):
            params = finetune(params, cfg, lambda: iter(train), epochs=args.ft_epochs,
                              lr=args.ft_lr, trainable=trainable, losses=ft_losses)

    if mesh is not None:
        from ssp_x_vit_tpu_torch.parallel.mesh import replicate, shard_batch

        replicate(mesh, params)
        test_batches = [shard_batch(mesh, b) for b in test_batches]
        calib_batches = [shard_batch(mesh, b) for b in calib_batches]
        if mesh.size(0) > 1:
            print(f"[INFO] Data-parallel eval over {mesh.size(0)} devices")

    # Baseline metrics
    params_before = count_total_params(cfg)
    with phase("baseline"):
        latency_baseline = latency(params, cfg)
        acc_baseline = evaluate_top1(params, cfg, test_batches, data_group=data_group)

    plan = None
    if args.stage == "both":
        if args.target is None:
            raise ValueError("--target required when --stage both")
        plan = plan_2ssp_allocation(cfg, args.target, min_remaining=args.min_remaining,
                                    forced_blocks=args.force_depth_blocks)
        print(f"[PLAN] target={plan.target_sparsity:.3f}, blocks_to_prune={plan.blocks_to_prune}, "
              f"per_block_neurons_to_prune={plan.per_block_neurons_to_prune}")

    # Artifact resume: reuse a previous run's decisions instead of importance.
    reapply_attn = None
    if args.attn_indices_json:
        with open(args.attn_indices_json) as f:
            reapply_attn = [int(i) for i in json.load(f)["indices"]]
        print(f"[INFO] Re-applying attention pruning from artifact: {reapply_attn}")
    reapply_mlp_imp = None
    if args.ffn_masks_json:
        with open(args.ffn_masks_json) as f:
            masks = json.load(f)["masks"]  # list of per-block 0/1 lists (1=prune)
        reapply_mlp_imp = np.where(np.asarray(masks, np.float32) == 1, -1.0, 1.0)
        print(f"[INFO] Re-applying FFN masks from artifact "
              f"({int((reapply_mlp_imp < 0).sum())} neurons marked)")

    # Importances once, on the dense model; skipped for the parts covered by artifacts.
    if reapply_attn is not None and reapply_mlp_imp is not None:
        att_imp = np.zeros((cfg.num_layers,), np.float32)
        mlp_imp_arr = reapply_mlp_imp
        mlp_imp = list(mlp_imp_arr)
    else:
        iface = Auto2SSPInterface(
            params, cfg, calib_batches or test_batches,
            importance_mode=args.depth_importance,
            batch_limit=args.eval_batches, min_remaining=args.min_remaining,
            data_group=data_group,
        )
        with phase("candidates"):
            att_imp = iface.fit_attention()
        with phase("stats"):
            mlp_imp = iface.fit_mlp()
        mlp_imp_arr = np.stack([np.asarray(x) for x in mlp_imp])
        if reapply_mlp_imp is not None:
            mlp_imp_arr = reapply_mlp_imp

    B = cfg.num_layers
    ffn_masks = ffn_indices = None
    work_params, work_cfg = params, cfg

    if args.stage in ("both", "s1"):
        if reapply_mlp_imp is not None:
            n_to_prune = [int((reapply_mlp_imp[i] < 0).sum()) for i in range(B)]
            print(f"[S1] Re-applying artifact masks: n_to_prune_per_block={n_to_prune}")
        elif args.stage == "both":
            n_to_prune = [plan.per_block_neurons_to_prune] * B
        else:
            if args.s1_sparsity is None:
                raise ValueError("When --stage s1, you must provide --s1-sparsity")
            n_to_prune = []
            for i in range(B):
                inter = cfg.logical_block_intermediate(i)
                t = int(round(args.s1_sparsity * inter))
                n_to_prune.append(max(0, min(t, max(0, inter - args.min_remaining))))
            print(f"[S1] Using per-component sparsity: s1_sparsity={args.s1_sparsity}, "
                  f"n_to_prune_per_block[0]={n_to_prune[0]}")
        width = select_keep_indices(mlp_imp_arr, n_to_prune_per_block=n_to_prune,
                                    min_remaining=args.min_remaining)
        work_params, work_cfg = materialize_width_pruning(work_params, work_cfg, width.keep_indices)
        ffn_masks, ffn_indices = width.prune_masks, width.pruned_indices

    params_after_stage1 = count_total_params(work_cfg) if args.stage != "s2" else params_before
    with phase("stage1"):
        latency_stage1 = latency(work_params, work_cfg)
        acc_stage1 = evaluate_top1(work_params, work_cfg, test_batches, data_group=data_group)

    pruned_indices = []
    if args.stage in ("both", "s2"):
        if args.stage == "both":
            k = args.force_depth_blocks if args.force_depth_blocks is not None else plan.blocks_to_prune
        else:
            if args.s2_sparsity is None:
                raise ValueError("When --stage s2, you must provide --s2-sparsity")
            k = max(0, min(B - 1, int(round(B * args.s2_sparsity))))
            print(f"[S2] Using per-component sparsity: s2_sparsity={args.s2_sparsity} -> K={k}/{B} blocks")
        if reapply_attn is not None:
            pruned_indices = sorted(set(reapply_attn))[: max(0, cfg.num_layers - 1)]
            work_params, work_cfg = materialize_depth_pruning(work_params, work_cfg, pruned_indices)
            print(f"Re-applied blocks to remove attention: {pruned_indices}")
        elif k > 0:
            pruned_indices = select_attention_blocks_to_prune(att_imp, k)
            work_params, work_cfg = materialize_depth_pruning(work_params, work_cfg, pruned_indices)
            print(f"Selected blocks to remove attention: {pruned_indices}")

    params_after_stage2 = count_total_params(work_cfg)
    with phase("materialized"):
        latency_stage2 = latency(work_params, work_cfg)
        acc_stage2 = evaluate_top1(work_params, work_cfg, test_batches, data_group=data_group)

    quant_params = None
    quant_metrics: Dict[str, Any] = {}
    if args.quantize == "int8":
        from ssp_x_vit_tpu_torch.models.quant import quantize_vit_params_int8

        with phase("quantize"):
            quant_params = quantize_vit_params_int8(work_params, work_cfg)
            quant_metrics = {
                "latency_int8_ms": round(latency(quant_params, work_cfg), 2),
                "acc_int8": round(evaluate_top1(quant_params, work_cfg, test_batches,
                                                data_group=data_group), 4),
            }
        print(f"[QUANT] int8: latency {quant_metrics['latency_int8_ms']} ms, "
              f"top-1 {quant_metrics['acc_int8']}")

    s1 = compute_actual_sparsity(params_before, params_after_stage1)
    s2_local = compute_actual_sparsity(params_after_stage1, params_after_stage2)
    s_total = compute_actual_sparsity(params_before, params_after_stage2)

    # --- artifacts ---
    out_root = Path(args.out_root or "runs/auto_2ssp")
    reports_dir = out_root / "reports"

    def write_artifacts() -> Dict[str, Any]:
        """The artifact files (rank 0 alone under --data-parallel)."""
        artifacts_dir = out_root / "artifacts" / run_id
        artifacts_dir.mkdir(parents=True, exist_ok=True)

        ffn_map = {f"{b}:{j}": float(v) for b, vec in enumerate(mlp_imp_arr) for j, v in enumerate(vec)}
        ffn_importances_path = artifacts_dir / "iterative_vit_b16_ffn_importances.json"
        with open(ffn_importances_path, "w", encoding="utf-8") as f:
            json.dump({"ffn": ffn_map}, f, ensure_ascii=False, indent=2)
        print(f"[ARTIFACT] FFN importances saved to: {ffn_importances_path}")

        artifacts: Dict[str, Any] = {"pruned_block_indices": pruned_indices,
                                     "ffn_importances_path": str(ffn_importances_path)}

        if ffn_masks is not None:
            ffn_masks_path = artifacts_dir / "ffn_prune_masks.json"
            with open(ffn_masks_path, "w", encoding="utf-8") as f:
                json.dump({
                    "format_version": 1,
                    "stage": "s1",
                    "strategy": "act_l2",
                    "min_remaining": args.min_remaining,
                    "s1_sparsity": args.s1_sparsity,
                    "block_inter_sizes": [work_cfg.logical_block_intermediate(i) for i in range(B)],
                    "masks": ffn_masks,
                    "indices": ffn_indices,
                }, f, indent=2)
            print(f"[ARTIFACT] FFN prune masks saved to: {ffn_masks_path}")
            artifacts["ffn_prune_masks_path"] = str(ffn_masks_path)

        if pruned_indices:
            attn_indices_path = artifacts_dir / "attention_pruned_indices.json"
            with open(attn_indices_path, "w", encoding="utf-8") as f:
                json.dump({"format_version": 1, "stage": "s2", "indices": pruned_indices}, f, indent=2)
            print(f"[ARTIFACT] Attention pruned indices saved to: {attn_indices_path}")
            artifacts["attn_pruned_indices_path"] = str(attn_indices_path)

        if args.save_adapter:
            artifacts["adapter_path"] = save_cifar_adapter(
                work_params, work_cfg, str(artifacts_dir),
                extra={"model_name": args.model, "target_sparsity": args.target,
                       "use_adapter": args.use_adapter, "replace_classifier": args.replace_classifier},
            )

        if args.save_pruned_model:
            from ssp_x_vit_tpu_torch.models.persistence import save_pruned_model

            def save(path, p_, c_):
                """HF when asked and the model has an HF form; else native, with a notice
                (stage-2 attention removal and adapter heads have no HF ViT form)."""
                if args.save_format == "hf":
                    from ssp_x_vit_tpu_torch.models.checkpoints import export_hf_vit
                    try:
                        return export_hf_vit(path, p_, c_)
                    except ValueError as e:
                        print(f"[INFO] hf export skipped ({e}); saving native")
                return save_pruned_model(path, p_, c_)

            pruned_dir = out_root / "pruned_models" / run_id
            save(str(pruned_dir), work_params, work_cfg)
            artifacts["pruned_model_dir"] = str(pruned_dir)
            if quant_params is not None:
                qdir = out_root / "pruned_models" / f"{run_id}-int8"
                save_pruned_model(str(qdir), quant_params, work_cfg)
                artifacts["pruned_model_int8_dir"] = str(qdir)

        if args.export_framework_prefix:
            from ssp_x_vit_tpu_torch.masks.export import build_framework_exports

            build_framework_exports(args.export_framework_prefix, cfg, mlp_imp,
                                    att_imp, ffn_masks, pruned_indices)
            artifacts["framework_export_prefix"] = args.export_framework_prefix
        return artifacts

    artifacts = write_artifacts() if lead else {"pruned_block_indices": pruned_indices}

    report = {
        "config": {
            "model": args.model,
            "target_sparsity": args.target,
            "stage": args.stage,
            "s1_sparsity": args.s1_sparsity,
            "s2_sparsity": args.s2_sparsity,
            "freeze_backbone": args.freeze_backbone,
            "replace_classifier": args.replace_classifier,
            "use_adapter": args.use_adapter,
            "adapter_reduction": args.adapter_reduction if args.use_adapter else None,
            "eval_batches": args.eval_batches,
            "min_remaining": args.min_remaining,
            "dataset": ds_name,
            "backend": device.type,
        },
        "metrics": {
            "params_before_stage1": params_before,
            "params_after_stage1": params_after_stage1,
            "params_after_stage2": params_after_stage2,
            "params_before_stage1_millions": round(params_before / 1e6, 2),
            "params_after_stage1_millions": round(params_after_stage1 / 1e6, 2),
            "params_after_stage2_millions": round(params_after_stage2 / 1e6, 2),
            "stage1_reduction_percent": round(s1 * 100, 1),
            "stage2_reduction_percent": round(s2_local * 100, 1),
            "total_reduction_percent": round(s_total * 100, 1),
            "latency_baseline_ms": round(latency_baseline, 2),
            "latency_stage1_ms": round(latency_stage1, 2),
            "latency_stage2_ms": round(latency_stage2, 2),
            "latency_stage1_change_percent": round((latency_stage1 / max(1e-12, latency_baseline) - 1) * 100, 1),
            "latency_stage2_change_percent": round((latency_stage2 / max(1e-12, latency_stage1) - 1) * 100, 1),
            "latency_total_change_percent": round((latency_stage2 / max(1e-12, latency_baseline) - 1) * 100, 1),
            "acc_baseline": round(acc_baseline, 4),
            "acc_stage1": round(acc_stage1, 4),
            "acc_stage2": round(acc_stage2, 4),
            "acc_drop_stage1_percent": round(((acc_baseline - acc_stage1) / max(1e-12, acc_baseline)) * 100, 2),
            "acc_drop_stage2_percent": round(((acc_stage1 - acc_stage2) / max(1e-12, acc_stage1)) * 100, 2),
            "acc_total_drop_percent": round(((acc_baseline - acc_stage2) / max(1e-12, acc_baseline)) * 100, 2),
            **quant_metrics,
        },
        "artifacts": artifacts,
    }
    if plan is not None:
        report["plan"] = {
            "target_sparsity": plan.target_sparsity,
            "num_blocks_total": plan.num_blocks_total,
            "blocks_to_prune": plan.blocks_to_prune,
            "per_block_neurons_to_prune": plan.per_block_neurons_to_prune,
            "stage2_fraction": plan.stage2_fraction,
            "estimated_total_removed_params": plan.estimated_total_removed_params,
            "est_error_params": plan.est_error_params,
        }

    print("[SUMMARY]")
    print(json.dumps(report["metrics"], indent=2))
    if lead:
        saved = save_report(report, out_dir=str(reports_dir), run_id=run_id)
        print(f"[INFO] Report saved to: {saved['json']} and {saved['md']}")
    report["kernel_launches"] = launches
    report["phase_seconds"] = seconds
    report["finetune_losses"] = ft_losses
    report["model"] = (work_params, work_cfg)
    return report


def launcher_argv(nprocs: int, argv) -> list:
    """The command that runs this CLI with ``argv`` as a world of ``nprocs``
    local workers under ``torch.distributed.run`` (which picks the port)."""
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            f"--nproc_per_node={nprocs}", "-m", "ssp_x_vit_tpu_torch.cli.auto_2ssp", *argv]


def main():
    import torch

    from ssp_x_vit_tpu_torch.parallel.mesh import distributed_env

    args = build_argparser().parse_args()
    if (args.data_parallel and args.backend == "cuda" and not distributed_env()
            and torch.cuda.is_available() and torch.cuda.device_count() > 1):
        # One worker per visible card. The kernel libraries are built once
        # here first, so the workers do not run nvcc side by side.
        from ssp_x_vit_tpu_torch.ops.kernels import build

        build.build_all()
        cmd = launcher_argv(torch.cuda.device_count(), sys.argv[1:])
        os.execv(cmd[0], cmd)
    run(args)


if __name__ == "__main__":
    main()
