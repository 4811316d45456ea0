"""Mask-ensembling grid runner — shared engine for the summation and consensus
grids (reference manual-experiments/run_summation_grid.py and
run_consensus_grid.py:298-409, which differ only in mask tool / sizes /
prune-level ranges).

Pipeline per (method-combo, prune-level), strictly sequential:
  1. build mask via the summation or consensus CLI (subprocess)
  2. run apply_mask_prune (subprocess), capture stdout
  3. regex-extract the multi-line ``[SUMMARY]`` JSON
  4. append a CSV row (fixed column order) with status; per-run logs kept

Resume: (methods, prune) rows already ``ok`` in the CSV are skipped unless
``--no-resume``.

The port's copy of ``ssp_x_vit_tpu/cli/grid.py``: the same CSV schema, resume
rule and failure rows; the subprocesses run the port's CLIs
(``ssp_x_vit_tpu_torch.cli.*``). Before the first subprocess it resolves the
device that ``apply_mask_prune`` will be asked for (``--backend`` in the apply
arguments, ``cuda`` by default), so without a GPU a grid meant for the card
raises at once instead of writing one failure row per combination.
"""

from __future__ import annotations

import argparse
import csv
import itertools
import json
import re
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

SUMMARY_MARK_RE = re.compile(r"\[SUMMARY\]\s*\n(\{.*?\})", re.S)

CSV_COLS = [
    "methods", "prune",
    "params_before_stage1", "params_after_stage1",
    "params_before_stage1_millions", "params_after_stage1_millions",
    "stage1_reduction_percent",
    "latency_baseline_ms", "latency_stage1_ms", "latency_stage1_change_percent",
    "acc_baseline", "acc_stage1", "acc_drop_stage1_percent",
    "status",
]


def sanitize_token(token: str) -> str:
    return re.sub(r"[^A-Za-z0-9_\-\+]+", "_", token)


def combo_key(files: Sequence[Path]) -> str:
    return "+".join(sorted(p.stem for p in files))


def ensure_csv_header(path: Path) -> None:
    if path.exists():
        return
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(",".join(CSV_COLS) + "\n", encoding="utf-8")


def load_completed_ok(path: Path) -> Set[Tuple[str, int]]:
    done: Set[Tuple[str, int]] = set()
    if not path.exists():
        return done
    try:
        with path.open("r", encoding="utf-8") as f:
            for row in csv.DictReader(f):
                try:
                    methods = (row.get("methods") or "").strip()
                    prune_s = (row.get("prune") or "").strip()
                    if methods and prune_s and (row.get("status") or "").strip() == "ok":
                        done.add((methods, int(prune_s)))
                except Exception:
                    continue
    except Exception:
        pass
    return done


def append_csv_row(path: Path, row: Dict[str, object]) -> None:
    values = [str(row.get(c, "")) for c in CSV_COLS]
    with path.open("a", encoding="utf-8") as f:
        f.write(",".join(values) + "\n")


def extract_summary(stdout_text: str) -> Optional[Dict[str, object]]:
    m = SUMMARY_MARK_RE.search(stdout_text)
    if not m:
        return None
    try:
        return json.loads(m.group(1))
    except Exception:
        return None


def apply_backend(apply_args: Optional[List[str]]) -> str:
    """The ``--backend`` that the apply arguments ask for (``cuda`` if none)."""
    args = list(apply_args or [])
    for i, a in enumerate(args):
        if a == "--backend" and i + 1 < len(args):
            return args[i + 1]
        if a.startswith("--backend="):
            return a.split("=", 1)[1]
    return "cuda"


def run_cmd(cmd: List[str]) -> Tuple[int, str, str]:
    import os

    env = dict(os.environ)
    repo_root = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env)
    return proc.returncode, proc.stdout, proc.stderr


def run_grid(
    mode: str,
    score_files: List[Path],
    sizes: Set[int],
    prune_levels: List[int],
    out_dir: Path,
    *,
    apply_args: Optional[List[str]] = None,
    first_n_combos: int = 0,
    no_resume: bool = False,
) -> Path:
    assert mode in ("summation", "consensus")
    out_dir.mkdir(parents=True, exist_ok=True)
    logs_dir = out_dir / "logs"
    logs_dir.mkdir(parents=True, exist_ok=True)
    csv_path = out_dir / "results.csv"
    mask_path = out_dir / ("mask_consensus.json" if mode == "consensus" else "mask.json")

    missing = [str(p) for p in score_files if not p.exists()]
    if missing:
        raise FileNotFoundError("Missing input normalized score files:\n  " + "\n  ".join(missing))

    ensure_csv_header(csv_path)
    completed = set() if no_resume else load_completed_ok(csv_path)

    combos = [c for n in sorted(sizes)
              for c in itertools.combinations(score_files, n)]
    combos = sorted(combos, key=combo_key)
    if first_n_combos > 0:
        combos = combos[:first_n_combos]

    total = 0
    device_checked = False
    for files_combo in combos:
        ckey = combo_key(files_combo)
        ckey_safe = sanitize_token(ckey)
        print(f"\n=== COMBO: {ckey} ===")
        for prune in prune_levels:
            if (ckey, prune) in completed:
                print(f"[SKIP] already done (ok): {ckey}, prune={prune}")
                continue
            if not device_checked:
                from ssp_x_vit_tpu_torch.device import resolve_device

                resolve_device(apply_backend(apply_args))
                device_checked = True
            total += 1
            print(f"\n--- [{total}] prune={prune} ---")

            if mode == "consensus":
                mask_cmd = [sys.executable, "-m", "ssp_x_vit_tpu_torch.cli.consensus_mask",
                            *[str(p) for p in files_combo],
                            "--prune", str(prune), "--mask-out", str(mask_path)]
            else:
                mask_cmd = [sys.executable, "-m", "ssp_x_vit_tpu_torch.cli.aggregate_and_mask_summation",
                            *[str(p) for p in files_combo],
                            "--prune", str(prune), "--mask-out", str(mask_path),
                            "--aggregate-out", str(out_dir / "aggregated_sums.json")]
            print("[RUN] ", " ".join(mask_cmd))
            rc1, out1, err1 = run_cmd(mask_cmd)
            if rc1 != 0:
                print(f"[ERROR] {mode} mask build failed (rc={rc1}).")
                append_csv_row(csv_path, {"methods": ckey, "prune": prune,
                                          "status": f"{mode}_failed_rc_{rc1}"})
                (logs_dir / f"{ckey_safe}_p{prune}.{mode}.stderr.txt").write_text(err1 or "", encoding="utf-8")
                (logs_dir / f"{ckey_safe}_p{prune}.{mode}.stdout.txt").write_text(out1 or "", encoding="utf-8")
                continue

            apply_cmd = [sys.executable, "-m", "ssp_x_vit_tpu_torch.cli.apply_mask_prune",
                         "--mask", str(mask_path), "--out-root", str(out_dir / "apply_runs"),
                         *(apply_args or [])]
            print("[RUN] ", " ".join(apply_cmd))
            rc2, out2, err2 = run_cmd(apply_cmd)
            (logs_dir / f"{ckey_safe}_p{prune}.stdout.txt").write_text(out2 or "", encoding="utf-8")
            (logs_dir / f"{ckey_safe}_p{prune}.stderr.txt").write_text(err2 or "", encoding="utf-8")
            if rc2 != 0:
                print(f"[ERROR] apply_mask_prune failed (rc={rc2}).")
                append_csv_row(csv_path, {"methods": ckey, "prune": prune,
                                          "status": f"apply_failed_rc_{rc2}"})
                continue

            summary = extract_summary(out2)
            if not summary:
                print("[ERROR] Could not find/parse the [SUMMARY] block in apply stdout.")
                append_csv_row(csv_path, {"methods": ckey, "prune": prune,
                                          "status": "summary_parse_failed"})
                continue

            row = {c: summary.get(c, "") for c in CSV_COLS if c not in ("methods", "prune", "status")}
            row.update(methods=ckey, prune=prune, status="ok")
            append_csv_row(csv_path, row)

    print("\nDone. Results:", csv_path)
    return csv_path


def build_argparser(mode: str) -> argparse.ArgumentParser:
    default_prune = "5:51:5" if mode == "summation" else "5:71:5"
    default_sizes = "1-4" if mode == "summation" else "2-4"
    p = argparse.ArgumentParser(description=f"Run the {mode} mask-ensembling grid.")
    p.add_argument("--score-files", nargs="+", required=True,
                   help="Normalized score JSON files to combine")
    p.add_argument("--sizes", type=str, default=default_sizes, help="Combo sizes, e.g. '2-4' or '1,3'")
    p.add_argument("--prune-levels", type=str, default=default_prune,
                   help="Prune percents: 'start:stop:step' or comma list")
    p.add_argument("--out-dir", type=str, default=f"runs/grid_{mode}")
    p.add_argument("--first-n-combos", type=int, default=0)
    p.add_argument("--no-resume", action="store_true")
    p.add_argument("--apply-args", type=str, default="",
                   help="Extra args forwarded to apply_mask_prune (quoted string)")
    return p


def parse_sizes(spec: str) -> Set[int]:
    out: Set[int] = set()
    for part in spec.split(","):
        part = part.strip()
        if "-" in part:
            a, b = part.split("-")
            out.update(range(int(a), int(b) + 1))
        elif part:
            out.add(int(part))
    return out


def parse_prune_levels(spec: str) -> List[int]:
    if ":" in spec:
        a, b, s = (int(x) for x in spec.split(":"))
        return list(range(a, b, s))
    return [int(x) for x in spec.split(",") if x.strip()]


def grid_main(mode: str):
    args = build_argparser(mode).parse_args()
    run_grid(
        mode,
        [Path(p) for p in args.score_files],
        parse_sizes(args.sizes),
        parse_prune_levels(args.prune_levels),
        Path(args.out_dir),
        apply_args=args.apply_args.split() if args.apply_args else None,
        first_n_combos=args.first_n_combos,
        no_resume=args.no_resume,
    )
