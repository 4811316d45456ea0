"""Parallelism of the port (counterpart of ``ssp_x_vit_tpu/parallel/``), on
``torch.distributed`` with one process per card: meshes and batch placement
(``mesh.py``), the collectives written by hand (``collectives.py``), ViT and LLM
data / tensor parallelism, FSDP training and the MoE-llama / DeepSeek
placements (``vit_sharding.py``, ``llm_sharding.py``), the mixture-of-experts
FFN and its expert parallelism (``moe.py``), the pipeline (``pipeline.py``),
ring-attention sequence parallelism (``ring_attention.py``) and DeepSeek's
latent ring and pipeline (``deepseek_parallel.py``). Importing the package
creates no process group."""

from ssp_x_vit_tpu_torch.parallel.mesh import (
    batch_sharding,
    init_distributed,
    make_expert_mesh,
    make_hybrid_mesh,
    make_mesh,
    make_pipeline_mesh,
    make_seq_mesh,
    replicate,
    shard_batch,
)
from ssp_x_vit_tpu_torch.parallel.moe import (
    MoEConfig,
    init_moe_params,
    moe_ffn,
    moe_ffn_dropless,
    moe_param_specs,
    shard_moe_params,
)

__all__ = ["MoEConfig", "batch_sharding", "init_distributed", "init_moe_params",
           "make_expert_mesh", "make_hybrid_mesh", "make_mesh", "make_pipeline_mesh",
           "make_seq_mesh", "moe_ffn", "moe_ffn_dropless", "moe_param_specs", "replicate",
           "shard_batch", "shard_moe_params"]
