"""Apply a binary FFN mask JSON to a ViT and evaluate it (counterpart of
``ssp_x_vit_tpu/cli/apply_mask_prune.py``; reference
experiments/vit_pruning/apply_mask_prune.py:206-463): the same flags but
``--backend cuda|cpu``, the same mask discovery (any nesting of 'i:j'
leaves), +/-1 pseudo-importance, ``min_remaining`` adjustment with its
``[WARN]`` line, ``--dry-run``, report and the multi-line ``[SUMMARY]`` JSON
that the grid runners parse.

Usage (on the card; ``--backend cpu`` runs the plain PyTorch path instead):
  python -m ssp_x_vit_tpu_torch.cli.apply_mask_prune --mask mask.json \
      --use-srp-checkpoint --srp-model-type B/16 --dataset cifar100 --eval-batches 2

``run(args)`` also returns, beside the report and unsaved, under
"kernel_launches" and "phase_seconds" the kernel launches and wall seconds of
its evaluations: "baseline" (the dense model) and "stage1" (the masked one;
absent with ``--dry-run``).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np


def load_mask(path: Path) -> Dict[int, Dict[int, int]]:
    """Mask JSON (any nesting of 'i:j' leaves) -> {block: {neuron: 0/1}}."""
    from ssp_x_vit_tpu_torch.masks.codec import KEY_RE, find_leaf_ij_dicts, load_json

    data = load_json(path)
    leaves = find_leaf_ij_dicts(data)
    if not leaves:
        raise RuntimeError(f"Mask file has no ij-leaf dicts: {path}")
    blocks: Dict[int, Dict[int, int]] = {}
    for _pth, leaf in leaves:
        for k, v in leaf.items():
            m = KEY_RE.match(k)
            if not m:
                continue
            blocks.setdefault(int(m.group(1)), {})[int(m.group(2))] = 1 if int(round(float(v))) else 0
    return blocks


def build_importance_and_counts(
    blocks_mask: Dict[int, Dict[int, int]], inter_sizes: List[int]
) -> Tuple[np.ndarray, List[int]]:
    """(+1 keep / -1 prune) pseudo-importance [B, d_int] and per-block prune counts.

    Missing indices count as keep (reference :259-280)."""
    B = len(inter_sizes)
    imp = np.ones((B, max(inter_sizes)), np.float32)
    n_prune = []
    for i in range(B):
        bm = blocks_mask.get(i, {})
        cnt = 0
        for j, bit in bm.items():
            if bit == 1 and 0 <= j < inter_sizes[i]:
                imp[i, j] = -1.0
                cnt += 1
        n_prune.append(cnt)
    return imp, n_prune


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Apply binary FFN pruning mask (equal-per-block) to a ViT and evaluate metrics.")
    p.add_argument("--mask", type=str, required=True, help="Path to 0/1 JSON mask with 'i:j' keys")
    p.add_argument("--model", type=str, default="vit-b16")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--dataset", type=str, default="cifar100",
                   choices=["cifar10", "cifar100", "synthetic"])
    p.add_argument("--min-remaining", type=int, default=512)
    p.add_argument("--cifar-train-pct", type=float, default=0.25)
    p.add_argument("--cifar-test-pct", type=float, default=0.25)
    p.add_argument("--eval-batches", type=int, default=5)
    p.add_argument("--eval-on", type=str, default="test", choices=["test", "train"])
    p.add_argument("--dry-run", action="store_true")
    p.add_argument("--calib-per-class", type=int, default=0)
    p.add_argument("--out-root", type=str, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--backend", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="Device to run on; cuda raises when no GPU is present")
    # SRP checkpoint (the reference applier hard-codes SRP B/16 cifar100
    # top10_idx=8 @224, apply_mask_prune.py:284-300; here it is opt-in)
    p.add_argument("--use-srp-checkpoint", action="store_true")
    p.add_argument("--srp-model-type", type=str, default="B/16",
                   choices=["Ti/16", "S/16", "B/16"])
    p.add_argument("--srp-index-csv", type=str, default=None)
    p.add_argument("--srp-models-dir", type=str, default="models")
    p.add_argument("--srp-checkpoint-npz", type=str, default=None)
    p.add_argument("--srp-top10-idx", type=int, default=8)
    return p


def run(args):
    import torch

    from ssp_x_vit_tpu_torch.cli.common import resolve_dataset, resolve_model
    from ssp_x_vit_tpu_torch.device import resolve_device
    from ssp_x_vit_tpu_torch.evaluation import evaluate_top1, measure_latency, save_report
    from ssp_x_vit_tpu_torch.ops.kernels import launch_counts
    from ssp_x_vit_tpu_torch.pruning import (
        compute_actual_sparsity, count_total_params, materialize_width_pruning,
        select_keep_indices,
    )

    device = resolve_device(args.backend)
    print(f"[INFO] Using backend: {device.type}"
          + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))

    launches: Dict[str, Dict[str, int]] = {}
    seconds: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(name):
        """Record the kernel launches and the wall seconds of one phase."""
        before, t0 = dict(launch_counts), time.perf_counter()
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds[name] = time.perf_counter() - t0
        launches[name] = {k: launch_counts[k] - before[k] for k in launch_counts}

    num_classes = {"cifar10": 10, "cifar100": 100, "synthetic": 10}[args.dataset]
    if args.use_srp_checkpoint:
        from ssp_x_vit_tpu_torch.data.srp import load_srp_model

        params, cfg = load_srp_model(
            args.srp_model_type, "cifar100",
            top10_idx=args.srp_top10_idx, index_csv=args.srp_index_csv,
            models_dir=args.srp_models_dir, checkpoint_npz=args.srp_checkpoint_npz,
            num_classes=num_classes, verbose=True, device=device,
        )
    else:
        params, cfg = resolve_model(args.model, num_classes=num_classes,
                                    checkpoint=args.checkpoint, seed=args.seed, device=device)
    train, test, _ = resolve_dataset(
        args.dataset, cfg, train_pct=args.cifar_train_pct, test_pct=args.cifar_test_pct,
        calib_per_class=max(1, args.calib_per_class), seed=args.seed, device=device,
    )
    eval_pipe = test if args.eval_on == "test" else train
    eval_batches = eval_pipe.batches(args.eval_batches)

    out_root = Path(args.out_root or "runs/apply_mask_prune")
    reports_dir = out_root / "reports"

    params_before = count_total_params(cfg)
    with phase("baseline"):
        latency_baseline = measure_latency(params, cfg, batch_size=1)
        acc_baseline = evaluate_top1(params, cfg, eval_batches)
    print(f"[BASE] params={params_before}, latency={latency_baseline:.2f} ms, acc={acc_baseline:.4f}")

    def finish(report):
        saved = save_report(report, out_dir=str(reports_dir))
        print("[SUMMARY]")
        print(json.dumps(report["metrics"], indent=2))
        print(f"[INFO] Report saved to: {saved['json']} and {saved['md']}")
        report["kernel_launches"] = launches
        report["phase_seconds"] = seconds
        return report

    if args.dry_run:
        print("[DRY] Skipping pruning; baseline measured only.")
        metrics = {
            "params_before_stage1": params_before,
            "params_after_stage1": params_before,
            "params_before_stage1_millions": round(params_before / 1e6, 2),
            "params_after_stage1_millions": round(params_before / 1e6, 2),
            "stage1_reduction_percent": 0.0,
            "latency_baseline_ms": round(latency_baseline, 2),
            "latency_stage1_ms": round(latency_baseline, 2),
            "latency_stage1_change_percent": 0.0,
            "acc_baseline": round(acc_baseline, 4),
            "acc_stage1": round(acc_baseline, 4),
            "acc_drop_stage1_percent": 0.0,
        }
        return finish({"config": {"mode": "dry-run", "mask_path": args.mask,
                                  "dataset": args.dataset, "eval_batches": args.eval_batches,
                                  "min_remaining": args.min_remaining},
                       "metrics": metrics})

    blocks_mask = load_mask(Path(args.mask))
    inter_sizes = [cfg.logical_block_intermediate(i) for i in range(cfg.num_layers)]
    imp, n_to_prune = build_importance_and_counts(blocks_mask, inter_sizes)

    for i, (d_int, k) in enumerate(zip(inter_sizes, n_to_prune)):
        if d_int - k < args.min_remaining:
            adj = max(0, d_int - args.min_remaining)
            if k > adj:
                print(f"[WARN] Block {i}: requested prune {k} exceeds min_remaining "
                      f"constraint ({args.min_remaining}). Adjusting to {adj}.")
                n_to_prune[i] = adj

    width = select_keep_indices(imp, n_to_prune_per_block=n_to_prune,
                                min_remaining=args.min_remaining)
    pruned_params, pruned_cfg = materialize_width_pruning(params, cfg, width.keep_indices)

    params_after = count_total_params(pruned_cfg)
    with phase("stage1"):
        latency_after = measure_latency(pruned_params, pruned_cfg, batch_size=1)
        acc_after = evaluate_top1(pruned_params, pruned_cfg, eval_batches)
    s1 = compute_actual_sparsity(params_before, params_after)

    metrics = {
        "params_before_stage1": params_before,
        "params_after_stage1": params_after,
        "params_before_stage1_millions": round(params_before / 1e6, 2),
        "params_after_stage1_millions": round(params_after / 1e6, 2),
        "stage1_reduction_percent": round(s1 * 100, 1),
        "latency_baseline_ms": round(latency_baseline, 2),
        "latency_stage1_ms": round(latency_after, 2),
        "latency_stage1_change_percent": round((latency_after / max(1e-12, latency_baseline) - 1) * 100, 1),
        "acc_baseline": round(acc_baseline, 4),
        "acc_stage1": round(acc_after, 4),
        "acc_drop_stage1_percent": round(((acc_baseline - acc_after) / max(1e-12, acc_baseline)) * 100, 2),
    }
    return finish({
        "config": {"mode": "apply-mask", "mask_path": args.mask, "dataset": args.dataset,
                   "eval_batches": args.eval_batches, "min_remaining": args.min_remaining},
        "metrics": metrics,
        "artifacts": {"mask_path": args.mask, "n_to_prune_per_block": n_to_prune,
                      "inter_sizes": inter_sizes},
    })


def main():
    run(build_argparser().parse_args())


if __name__ == "__main__":
    main()
