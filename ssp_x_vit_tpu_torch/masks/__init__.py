"""Mask ensembling and exchange formats (counterpart of ``ssp_x_vit_tpu/masks``)."""

from ssp_x_vit_tpu_torch.masks.codec import (
    find_leaf_ij_dicts,
    reconstruct_tree,
    leaf_to_arrays,
    arrays_to_leaf,
    parse_fraction,
    rounding_fn,
    dump_json_atomic,
)
from ssp_x_vit_tpu_torch.masks.normalize import normalize_file, normalize_structure
from ssp_x_vit_tpu_torch.masks.summation import aggregate_leaves, make_mask_for_leaf
from ssp_x_vit_tpu_torch.masks.consensus import consensus_for_path
from ssp_x_vit_tpu_torch.masks.conjunction import (
    DepthPruning,
    WidthPruning,
    HeadPruning,
    mask_conjunction,
    count_pruned,
    conjunction,
)

__all__ = [
    "find_leaf_ij_dicts", "reconstruct_tree", "leaf_to_arrays", "arrays_to_leaf",
    "parse_fraction", "rounding_fn", "dump_json_atomic",
    "normalize_file", "normalize_structure",
    "aggregate_leaves", "make_mask_for_leaf",
    "consensus_for_path",
    "DepthPruning", "WidthPruning", "HeadPruning",
    "mask_conjunction", "count_pruned", "conjunction",
]
