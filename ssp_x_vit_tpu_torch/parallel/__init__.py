"""Parallelism of the port (counterpart of ``ssp_x_vit_tpu/parallel/``). Only the
single-device semantics of the mixture-of-experts FFN (``moe.py``) are here;
meshes, sharding and expert parallelism are ROADMAP.md A.11d."""

from ssp_x_vit_tpu_torch.parallel.moe import (
    MoEConfig,
    init_moe_params,
    moe_ffn,
    moe_ffn_dropless,
    shard_moe_params,
)

__all__ = ["MoEConfig", "init_moe_params", "moe_ffn", "moe_ffn_dropless", "shard_moe_params"]
