"""Parallelism of the port (counterpart of ``ssp_x_vit_tpu/parallel/``), on
``torch.distributed`` with one process per card: meshes and batch placement
(``mesh.py``), the collectives written by hand (``collectives.py``), ViT and LLM
data / tensor parallelism and FSDP training (``vit_sharding.py``,
``llm_sharding.py``), and the single-device mixture-of-experts FFN (``moe.py``).
Pipeline, ring-attention, expert and DeepSeek parallelism are ROADMAP.md
A.11d.2. Importing the package creates no process group."""

from ssp_x_vit_tpu_torch.parallel.mesh import (
    batch_sharding,
    init_distributed,
    make_hybrid_mesh,
    make_mesh,
    replicate,
    shard_batch,
)
from ssp_x_vit_tpu_torch.parallel.moe import (
    MoEConfig,
    init_moe_params,
    moe_ffn,
    moe_ffn_dropless,
    shard_moe_params,
)

__all__ = ["MoEConfig", "batch_sharding", "init_distributed", "init_moe_params",
           "make_hybrid_mesh", "make_mesh", "moe_ffn", "moe_ffn_dropless", "replicate",
           "shard_batch", "shard_moe_params"]
