"""Tensor-parallel sharding rules for the ViT (counterpart of
``ssp_x_vit_tpu/parallel/vit_sharding.py``).

Column-parallel fused QKV / fc1, row-parallel proj / fc2, batch data
parallelism for pixels. The specs are the JAX package's ``PartitionSpec``s
as tuples of axis names. A shard is this rank's plain tensors under the
unsharded tree's keys.

One layout differs from an equal split. The fused ``qkv_kernel`` is
``[q | k | v]`` along its last axis, so an equal split of that axis does not
give a rank its heads (GSPMD reshuffles the pieces for the JAX package).
Each rank takes its heads out of q, k and v and packs them again, so its
block kernels run whole heads: 12 heads over 4 ranks are 3 a rank, which
``models/vit.py`` sends to ``fused_attn_block``, as any odd head count.
"""

from __future__ import annotations

from typing import Any, Dict

from ssp_x_vit_tpu_torch.models.vit import Params, ViTConfig
from ssp_x_vit_tpu_torch.parallel.llm_sharding import _cut, _cut_packed
from ssp_x_vit_tpu_torch.parallel.mesh import axis_index, axis_size


def vit_param_specs(cfg: ViTConfig) -> Dict[str, Any]:
    blocks = {
        "ln1_scale": (None, None), "ln1_bias": (None, None),
        "qkv_kernel": (None, None, "model"),
        "qkv_bias": (None, "model"),
        "proj_kernel": (None, "model", None),  # row-parallel -> all-reduce
        "proj_bias": (None, None),
        "ln2_scale": (None, None), "ln2_bias": (None, None),
        "fc1_kernel": (None, None, "model"),
        "fc1_bias": (None, "model"),
        "fc2_kernel": (None, "model", None),
        "fc2_bias": (None, None),
    }
    head = ({"kernel": (None, None), "bias": (None,)}
            if cfg.head_type == "linear"
            else {"w0": (None, None), "w2": (None, None), "b2": (None,)})
    return {
        "patch_embed": {"kernel": (None, None), "bias": (None,)},
        "cls_token": (None, None, None),
        "pos_embed": (None, None, None),
        "blocks": blocks,
        "ln_final_scale": (None,), "ln_final_bias": (None,),
        "head": head,
    }


def shard_vit_params(params: Params, mesh, cfg: ViTConfig) -> Params:
    """This rank's shard of a dense float ViT tree over the mesh's ``model``
    axis (replicated leaves are the same tensors). Refuses a head count or an
    FFN width that ``model`` does not divide."""
    return vit_shard(params, cfg, axis_index(mesh, "model"), axis_size(mesh, "model"))


def vit_shard(params: Params, cfg: ViTConfig, r: int, tp: int) -> Params:
    """The shard of model rank ``r`` of ``tp`` (what :func:`shard_vit_params`
    gives that rank; in one process, any rank's)."""
    if cfg.num_heads % tp:
        raise ValueError(f"num_heads {cfg.num_heads} not divisible by model-axis size {tp}")
    if cfg.pruned_attention_blocks or "fc1_kernel" not in params["blocks"]:
        raise ValueError("shard_vit_params takes a dense float tree")
    if params["blocks"]["fc1_kernel"].shape[-1] % tp:
        raise ValueError(f"FFN width {params['blocks']['fc1_kernel'].shape[-1]} not divisible "
                         f"by model-axis size {tp}")
    specs = vit_param_specs(cfg)["blocks"]
    blocks = {}
    for k, v in params["blocks"].items():
        spec = specs[k]
        if "model" not in spec:
            blocks[k] = v
        elif k.startswith("qkv_"):
            # [q | k | v]: this rank's heads of each, packed again
            blocks[k] = _cut_packed(v, v.shape[-1] // 3, r, tp)
        else:
            blocks[k] = _cut(v, spec.index("model"), r, tp)
    return dict(params, blocks=blocks)


def evaluate_top1_sharded(shard: Params, cfg: ViTConfig, batches, mesh, **kw) -> float:
    """Top-1 of a ``shard_vit_params`` shard over ``shard_batch`` batches:
    tensor parallel over ``model``, the counts summed over ``data``."""
    from ssp_x_vit_tpu_torch.evaluation.classify import evaluate_top1

    return evaluate_top1(shard, cfg, batches, data_group=mesh.get_group("data"),
                         tp_group=mesh.get_group("model"), **kw)
