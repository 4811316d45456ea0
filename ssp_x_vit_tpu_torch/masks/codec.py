"""'i:j' JSON interchange codec for importance scores and masks.

The reference toolchain exchanges FFN neuron scores/masks as JSON trees whose
leaves map "block:neuron" keys to numbers (manual-experiments/*.py,
adaptation-for-Pures-framework exports). This module provides the shared
discovery/reconstruction helpers plus converters between those leaves and
dense (block-grouped) numpy arrays, which is what the vectorized mask algebra
operates on.

The port's copy of ``ssp_x_vit_tpu/masks/codec.py`` (host code, numpy only):
the same results and, where it writes JSON, the same bytes.
"""

from __future__ import annotations

import json
import math
import os
import re
from pathlib import Path
from typing import Any, Dict, List, Tuple

import numpy as np

KEY_RE = re.compile(r"^(\d+):(\d+)$")
PathTuple = Tuple[str, ...]


def is_number(x: Any) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, bool)


def looks_like_leaf_ij_dict(d: Any) -> bool:
    if not isinstance(d, dict) or not d:
        return False
    return all(
        isinstance(k, str) and KEY_RE.match(k) and is_number(v) for k, v in d.items()
    )


def find_leaf_ij_dicts(obj: Any, path: List[str] | None = None,
                       out: List[Tuple[PathTuple, Dict[str, float]]] | None = None):
    """Collect all {'i:j': number} leaves anywhere in a JSON tree."""
    if path is None:
        path = []
    if out is None:
        out = []
    if isinstance(obj, dict):
        if looks_like_leaf_ij_dict(obj):
            out.append((tuple(path), {k: float(v) for k, v in obj.items()}))
            return out
        for k, v in obj.items():
            find_leaf_ij_dicts(v, path + [str(k)], out)
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            find_leaf_ij_dicts(v, path + [f"[{i}]"], out)
    return out


def key_to_tuple(k: str) -> Tuple[int, int]:
    m = KEY_RE.match(k)
    if not m:
        return (1 << 30, 1 << 30)
    return (int(m.group(1)), int(m.group(2)))


def reconstruct_tree(path_to_leaf: Dict[PathTuple, Dict[str, Any]]) -> Dict[str, Any]:
    """Assemble a JSON tree from per-path leaves (insertion order preserved)."""
    root: Dict[str, Any] = {}
    for path, leaf in path_to_leaf.items():
        cur = root
        for key in path:
            cur = cur.setdefault(key, {})
        cur.update(leaf)
    return root


def leaf_to_arrays(leaf: Dict[str, float]) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
    """{'i:j': v} -> {block: (neuron_ids sorted asc, values aligned)}."""
    blocks: Dict[int, List[Tuple[int, float]]] = {}
    for k, v in leaf.items():
        m = KEY_RE.match(k)
        if not m:
            continue
        blocks.setdefault(int(m.group(1)), []).append((int(m.group(2)), float(v)))
    out = {}
    for i, items in blocks.items():
        items.sort()
        ids = np.asarray([j for j, _ in items], np.int64)
        vals = np.asarray([v for _, v in items], np.float64)
        out[i] = (ids, vals)
    return out


def arrays_to_leaf(blocks: Dict[int, Tuple[np.ndarray, np.ndarray]], as_int: bool = False) -> Dict[str, Any]:
    """Inverse of leaf_to_arrays, emitting stable (i, j)-sorted key order."""
    leaf: Dict[str, Any] = {}
    for i in sorted(blocks):
        ids, vals = blocks[i]
        order = np.argsort(ids, kind="stable")
        for j, v in zip(ids[order], vals[order]):
            leaf[f"{i}:{int(j)}"] = int(v) if as_int else float(v)
    return leaf


def dense_scores_to_leaf(scores: np.ndarray) -> Dict[str, float]:
    """[L, F] array -> {'i:j': v} over all entries (framework export format)."""
    L, F = scores.shape
    return {f"{i}:{j}": float(scores[i, j]) for i in range(L) for j in range(F)}


def parse_fraction(p: float) -> float:
    """Percent (>1) or fraction -> [0,1] (reference semantics)."""
    if p < 0:
        return 0.0
    return p / 100.0 if p > 1.0 else p


def rounding_fn(name: str):
    if name == "floor":
        return math.floor
    if name == "ceil":
        return math.ceil
    return lambda x: int(round(x))


def load_json(path) -> Any:
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def dump_json_atomic(data: Any, out_path, compact: bool = True) -> None:
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    tmp = out_path.with_suffix(out_path.suffix + ".tmp")
    with tmp.open("w", encoding="utf-8") as f:
        if compact:
            json.dump(data, f, ensure_ascii=False, allow_nan=False, separators=(",", ":"))
        else:
            json.dump(data, f, ensure_ascii=False, allow_nan=False, indent=2)
    os.replace(tmp, out_path)
