"""Hand-written CUDA kernels (the ViT block, flash attention forward and
backward, paged decode attention and its pool write, alone and as one
write-and-attend launch, the int8/int4 dequant GEMMs and the fused int8 SwiGLU
MLP, and decode attention over an MLA latent pool, alone and as one
write-and-attend launch, on mma.sync and on Hopper's wgmma: rows 1-11 of the
TPU kernel table in PERF.md), their plain PyTorch
versions and their launch counters.

``launch_counts`` maps each wrapper name to the number of times it launched
its kernel in this process; only a wrapper called on a CUDA tensor adds to it.
"""

from __future__ import annotations

from typing import Dict

KERNEL_NAMES = ("fused_attn_block_v2", "fused_attn_block", "fused_ffn_block", "fused_ffn",
                "flash_attention", "quant4_matmul", "quant_matmul",
                "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
                "paged_mla_attention", "paged_mla_attention_q8",
                "paged_mla_attention_write", "paged_mla_attention_write_q8",
                "paged_mla_write_hopper", "paged_mla_write_hopper_q8",
                "paged_attention", "paged_attention_q8", "paged_pool_write", "paged_pool_write_q8",
                "paged_attention_write", "paged_attention_write_q8", "fused_mlp_int8")

launch_counts: Dict[str, int] = {name: 0 for name in KERNEL_NAMES}


def reset_launch_counts() -> None:
    for name in KERNEL_NAMES:
        launch_counts[name] = 0
