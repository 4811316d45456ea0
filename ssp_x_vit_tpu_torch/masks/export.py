"""Pures-framework exchange format exports
(reference adaptation-for-Pures-framework/auto_2ssp.py:71-185).

`{prefix}_scores.json`: {"ffn"/"heads"/"qkv_dim": {"layer:idx": score}}
`{prefix}_masks.json`:  {"ffn"/"heads"/"qkv_dim": {"layer": [0/1,...]}}

Head/qkv-dim scores broadcast the per-block attention importance; blocks whose
attention was stage-2 pruned map to all-1 head and qkv masks.

The port's copy of ``ssp_x_vit_tpu/masks/export.py`` (host code, numpy only):
the same results and, where it writes JSON, the same bytes.
"""

from __future__ import annotations

import json
import os
from typing import TYPE_CHECKING, Dict, Optional, Sequence

import numpy as np

if TYPE_CHECKING:  # the mask tools stay host code that never imports torch
    from ssp_x_vit_tpu_torch.models.vit import ViTConfig


def build_framework_exports(
    prefix: str,
    cfg: ViTConfig,
    mlp_importance: Sequence[np.ndarray],
    att_importance: Optional[np.ndarray],
    ffn_masks: Optional[Sequence[Sequence[int]]],
    pruned_attn_block_indices: Sequence[int],
) -> Dict[str, dict]:
    B = cfg.num_layers
    hidden = cfg.hidden_size
    num_heads = cfg.num_heads

    att_vals = [0.0] * B
    if att_importance is not None:
        vals = [float(x) for x in np.asarray(att_importance).ravel().tolist()]
        att_vals = (vals + [0.0] * B)[:B]

    ffn_imp = {
        f"{l}:{i}": float(s)
        for l, vec in enumerate(mlp_importance or [])
        for i, s in enumerate(np.asarray(vec).ravel().tolist())
    }
    head_imp = {f"{l}:{h}": att_vals[l] for l in range(B) for h in range(num_heads)}
    qkv_dim_imp = {f"{l}:{d}": att_vals[l] for l in range(B) for d in range(hidden)}

    if ffn_masks is not None and len(ffn_masks) == B:
        ffn_mask = {str(l): [int(x) for x in m] for l, m in enumerate(ffn_masks)}
    else:
        ffn_mask = {
            str(l): [0] * (len(mlp_importance[l]) if mlp_importance is not None and l < len(mlp_importance) else hidden * 4)
            for l in range(B)
        }

    pruned = set(pruned_attn_block_indices or [])
    head_mask = {str(l): [1 if l in pruned else 0] * num_heads for l in range(B)}
    qkv_dim_mask = {str(l): [1 if l in pruned else 0] * hidden for l in range(B)}

    d = os.path.dirname(prefix)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(prefix + "_scores.json", "w") as f:
        json.dump({"ffn": ffn_imp, "heads": head_imp, "qkv_dim": qkv_dim_imp}, f, indent=2)
    with open(prefix + "_masks.json", "w") as f:
        json.dump({"ffn": ffn_mask, "heads": head_mask, "qkv_dim": qkv_dim_mask}, f, indent=2)

    return {
        "ffn_imp": ffn_imp, "head_imp": head_imp, "qkv_dim_imp": qkv_dim_imp,
        "ffn_mask": ffn_mask, "head_mask": head_mask, "qkv_dim_mask": qkv_dim_mask,
    }
