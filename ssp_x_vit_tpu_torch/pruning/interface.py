"""Importance-score interface layer (counterpart of
``ssp_x_vit_tpu/pruning/interface.py``; reference
pruning_srp-main/mask_conjunction.py:32-96, 236-362).

``PruningInterface.fit()`` contract (shapes as in the reference spec):
- DEPTH  att/mlp importance: array [n_blocks]
- WIDTH  att importance: per block [qk_rows], [vp_rows] pairs;
         mlp importance: per block [d_int]
- HEAD   att importance: per block [n_heads]
Lower importance = prune earlier. Interrelated weight groups:
DEPTH: [q,k,v,proj], [fc1,fc2]; WIDTH: [q,k], [v,proj], [fc1,fc2]; HEAD: [q,k],[v,proj].

``Auto2SSPInterface`` adapts 2SSP to this contract for the PyTorch ViT:
- att importance (DEPTH): skip-gate top-1 impact ("copy" mode — no
  deepcopies) or position heuristic. Failures always surface (the JAX
  package's ``error_policy="heuristic"`` fallback is not ported: a failing
  kernel on the card must never be hidden).
- mlp importance (WIDTH): fused activation-L2 side-output, weight-L1 fallback.
- ``data_group``: the batches are this rank's rows (data parallelism); both
  importances are summed over the group, so every rank decides the same.
"""

from __future__ import annotations

import enum
from typing import List, Tuple

import numpy as np

from ssp_x_vit_tpu_torch.models.vit import Params, ViTConfig
from ssp_x_vit_tpu_torch.pruning.width import (
    compute_ffn_activation_importance,
    weight_l1_importance,
)
from ssp_x_vit_tpu_torch.pruning.depth import (
    copy_replace_attention_importance,
    heuristic_attention_importance,
)


class PruningTypes(enum.Enum):
    DEPTH = 0
    WIDTH = 1
    HEAD = 2   # valid only for attention
    NONE = 3   # pruning this structure is unsupported


class PruningInterface:
    """Base contract; subclasses set prune types and implement fit()."""

    def __init__(self, params: Params, cfg: ViTConfig, pruning_batches=None):
        self.params = params
        self.cfg = cfg
        self.batches = pruning_batches
        self.att_prune_type = PruningTypes.DEPTH
        self.mlp_prune_type = PruningTypes.WIDTH
        self.att_importance = None
        self.mlp_importance = None

    def fit(self) -> Tuple[object, object]:
        raise NotImplementedError


class Auto2SSPInterface(PruningInterface):
    def __init__(
        self,
        params: Params,
        cfg: ViTConfig,
        pruning_batches=None,
        *,
        importance_mode: str = "copy",
        batch_limit: int = 5,
        min_remaining: int = 256,
        data_group=None,
    ):
        super().__init__(params, cfg, pruning_batches)
        self.data_group = data_group
        self.att_prune_type = PruningTypes.DEPTH
        self.mlp_prune_type = PruningTypes.WIDTH
        self.importance_mode = importance_mode
        self.batch_limit = batch_limit
        self.min_remaining = min_remaining

    def _compute_mlp_importance(self) -> List[np.ndarray]:
        if self.batches is not None:
            imp = compute_ffn_activation_importance(
                self.params, self.cfg, self.batches, batch_limit=self.batch_limit,
                data_group=self.data_group)
        else:
            imp = weight_l1_importance(self.params)
        return [imp[i] for i in range(self.cfg.num_layers)]

    def _compute_att_depth_importance(self) -> np.ndarray:
        L = self.cfg.num_layers
        if self.importance_mode.lower() == "heuristic" or self.batches is None:
            return heuristic_attention_importance(L)
        impacts, _ = copy_replace_attention_importance(
            self.params, self.cfg, self.batches, batch_limit=self.batch_limit, verbose=False,
            data_group=self.data_group)
        return impacts

    def fit_attention(self) -> np.ndarray:
        """Attention (DEPTH) importance alone: the skip-gate candidate search."""
        self.att_importance = self._compute_att_depth_importance()
        return self.att_importance

    def fit_mlp(self) -> List[np.ndarray]:
        """FFN (WIDTH) importance alone: the stats-collecting forward."""
        self.mlp_importance = self._compute_mlp_importance()
        return self.mlp_importance

    def fit(self):
        self.fit_attention()
        self.fit_mlp()
        return self.att_importance, self.mlp_importance
