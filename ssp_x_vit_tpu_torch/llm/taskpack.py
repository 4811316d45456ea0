"""Offline downstream task packs (own copy of ``ssp_x_vit_tpu/llm/taskpack.py``:
``build_code_cloze_pack`` writes the same bytes for the same sources and seed).

- a task-pack format: a directory of ``<task>.jsonl`` files, one
  ``{"context", "choices", "label"}`` record per line (the multiple-choice
  shape the lm-eval harness's loglikelihood tasks reduce to), plus an optional
  ``meta.json`` ({task: {"length_normalized": bool}});
- ``build_code_cloze_pack``, a real offline task, code-cloze: given K consecutive lines of
  a local Python file, pick the true next line among distractors drawn from
  other files (matched by indentation and length, so surface statistics do
  not give the answer away);
- an evaluator driving the zero-shot core (``llm/zeroshot.py``) on the
  parameters' device.

Scores compare checkpoints and pruning levels of one tokenizer: the offline
stand-in for the reference's winogrande / arc / ... table.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

__all__ = ["build_code_cloze_pack", "load_task_pack", "evaluate_task_pack"]


def _usable_lines(text: str) -> List[str]:
    """Indexable cloze candidates: non-blank, non-comment, reasonably sized."""
    out = []
    for ln in text.splitlines():
        s = ln.strip()
        if 8 <= len(s) <= 120 and not s.startswith("#"):
            out.append(ln.rstrip())
    return out


def _indent(ln: str) -> int:
    return len(ln) - len(ln.lstrip())


def build_code_cloze_pack(
    files: Sequence[str],
    out_dir: str,
    *,
    n_examples: int = 200,
    context_lines: int = 8,
    n_choices: int = 4,
    seed: int = 0,
    task_name: str = "code_cloze",
) -> str:
    """Build a next-line multiple-choice task from local source files.

    Distractors are lines from OTHER files with the same indentation depth
    and similar length as the answer. Deterministic in (files order, seed).
    Returns the jsonl path.
    """
    rng = np.random.default_rng(seed)
    texts = []
    for p in files:
        try:
            with open(p, encoding="utf-8", errors="ignore") as f:
                t = f.read()
        except OSError:
            continue
        lines = t.splitlines()
        if len(lines) > context_lines + 2:
            texts.append(lines)
    if len(texts) < 2:
        raise ValueError("need at least 2 readable files")

    # distractor pool: (indent_bucket, len_bucket) -> [(file_idx, line)]
    pool: Dict[tuple, List[tuple]] = {}
    for fi, lines in enumerate(texts):
        for ln in _usable_lines("\n".join(lines)):
            key = (min(_indent(ln) // 4, 4), min(len(ln.strip()) // 20, 4))
            pool.setdefault(key, []).append((fi, ln))

    examples = []
    attempts = 0
    while len(examples) < n_examples and attempts < n_examples * 20:
        attempts += 1
        fi = int(rng.integers(0, len(texts)))
        lines = texts[fi]
        start = int(rng.integers(0, max(1, len(lines) - context_lines - 1)))
        ctx_lines = lines[start:start + context_lines]
        answer = lines[start + context_lines]
        s = answer.strip()
        if not (8 <= len(s) <= 120) or s.startswith("#"):
            continue
        key = (min(_indent(answer) // 4, 4), min(len(s) // 20, 4))
        cands = [c for c in pool.get(key, ()) if c[0] != fi
                 and c[1].strip() != s]
        if len(cands) < n_choices - 1:
            continue
        picks = rng.choice(len(cands), size=n_choices - 1, replace=False)
        choices = [cands[int(i)][1] for i in picks]
        label = int(rng.integers(0, n_choices))
        choices.insert(label, answer)
        examples.append({
            "context": "\n".join(ctx_lines) + "\n",
            "choices": choices,
            "label": label,
        })

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{task_name}.jsonl")
    with open(path, "w") as f:
        for ex in examples:
            f.write(json.dumps(ex) + "\n")
    meta_path = os.path.join(out_dir, "meta.json")
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    # code lines vary in token length: length-normalize like hellaswag/arc
    meta[task_name] = {"length_normalized": True}
    with open(meta_path, "w") as f:
        json.dump(meta, f, indent=1)
    return path


def load_task_pack(pack_dir: str) -> Dict[str, dict]:
    """{task: {"examples": [...], "length_normalized": bool}}."""
    meta = {}
    meta_path = os.path.join(pack_dir, "meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    tasks = {}
    for fn in sorted(os.listdir(pack_dir)):
        if not fn.endswith(".jsonl"):
            continue
        name = fn[:-6]
        with open(os.path.join(pack_dir, fn)) as f:
            examples = [json.loads(ln) for ln in f if ln.strip()]
        tasks[name] = {
            "examples": examples,
            "length_normalized": bool(
                meta.get(name, {}).get("length_normalized", False)),
        }
    if not tasks:
        raise FileNotFoundError(f"no *.jsonl tasks under {pack_dir}")
    return tasks


def evaluate_task_pack(
    params, cfg, pack_dir: str,
    encode: Callable[[str], List[int]],
    *,
    limit: Optional[int] = None,
    bucket: int = 128,
    compute_dtype=torch.bfloat16,
) -> Dict[str, Dict[str, float]]:
    """Run every task in the pack through the standalone zero-shot core.

    Returns {task: {"acc": float, "count": int, "scores": [...]}}: the
    offline analogue of the harness's results table (reference
    src/evaluation.py:110-116). ``compute_dtype`` is the forwards' (the
    JAX package always runs bf16).
    """
    from ssp_x_vit_tpu_torch.llm.zeroshot import evaluate_multiple_choice

    tasks = load_task_pack(pack_dir)
    results = {}
    for name, t in tasks.items():
        ex = t["examples"][:limit] if limit else t["examples"]
        results[name] = evaluate_multiple_choice(
            params, cfg, ex, encode,
            length_normalized=t["length_normalized"], bucket=bucket,
            compute_dtype=compute_dtype)
    return results
