"""Global min-max normalization of score JSONs
(reference manual-experiments/normalize_scores.py:44-185).

All numeric values anywhere in the tree participate in one global (min, max)
and are mapped to [0,1]; structure, keys and non-numeric values are preserved.

The port's copy of ``ssp_x_vit_tpu/masks/normalize.py`` (host code, numpy only):
the same results and, where it writes JSON, the same bytes.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Any, Optional, Tuple

from ssp_x_vit_tpu_torch.masks.codec import dump_json_atomic, is_number, load_json


def scan_min_max(obj: Any) -> Tuple[Optional[float], Optional[float]]:
    lo, hi = math.inf, -math.inf
    stack = [obj]
    while stack:
        cur = stack.pop()
        if is_number(cur):
            v = float(cur)
            lo, hi = min(lo, v), max(hi, v)
        elif isinstance(cur, list):
            stack.extend(cur)
        elif isinstance(cur, dict):
            stack.extend(cur.values())
    if lo is math.inf:
        return None, None
    return lo, hi


def normalize_structure(obj: Any, lo: float, hi: float) -> Any:
    if is_number(obj):
        return 0.0 if hi == lo else (float(obj) - lo) / (hi - lo)
    if isinstance(obj, list):
        return [normalize_structure(x, lo, hi) for x in obj]
    if isinstance(obj, dict):
        return {k: normalize_structure(v, lo, hi) for k, v in obj.items()}
    return obj


def normalize_file(src, dst, *, dry_run: bool = False) -> bool:
    """Returns True if processed (False when no numerics found)."""
    data = load_json(src)
    lo, hi = scan_min_max(data)
    if lo is None:
        print(f"[skip] {src} — no numeric values found")
        return False
    if dry_run:
        print(f"[dry]  {src}  min_val={lo:.6g}, max_val={hi:.6g}  => {dst}")
        return True
    dump_json_atomic(normalize_structure(data, lo, hi), Path(dst))
    print(f"[ok]   {src}  ->  {dst}  (min_val={lo:.6g}, max_val={hi:.6g})")
    return True
