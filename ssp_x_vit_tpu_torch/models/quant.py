"""Weight-only int8 quantization of ViT trees (counterpart of
``ssp_x_vit_tpu/models/quant.py``).

Per-output-channel symmetric int8 through ``llm/quant.py``'s
``quantize_weight_int8`` (bit-identical to the JAX quantizer): ``w ~= w_q *
scale[out]``. The scale is applied to the product's output
(``ops.common.mm_quant``), so no dequantized weight is stored. On the card the
int8 product is a plain product with a convert of the whole weight per call,
as the JAX package left it to XLA.

Composes with 2SSP: width- and depth-materialized trees quantize the same
way (zero-padded FFN columns get scale 1 and all-zero codes).
"""

from __future__ import annotations

from ssp_x_vit_tpu_torch.llm.quant import _quantize_stacked, quantize_weight_int8
from ssp_x_vit_tpu_torch.models.vit import Params, ViTConfig

# Stacked [L, K, N] projection kernels in blocks.
_VIT_BLOCK_KEYS = ("qkv_kernel", "proj_kernel", "fc1_kernel", "fc2_kernel")
# 2-D [K, N] kernels elsewhere: (container key, kernel name).
_VIT_FLAT_KEYS = (("patch_embed", "kernel"), ("head", "kernel"),
                  ("head", "w0"), ("head", "w2"))


def quantize_vit_params_int8(params: Params, cfg: ViTConfig) -> Params:
    """A tree with every projection kernel ``k`` replaced by ``k + "_q"`` (int8)
    and ``k + "_scale"`` (fp32 per output channel): the four stacked block
    kernels, the patch embedding and the head's kernels. Norms, biases and the
    cls / position embeddings are shared with ``params``."""
    out: Params = {}
    for k, v in params.items():
        if k == "blocks":
            blocks = {}
            for bk, bv in v.items():
                if bk in _VIT_BLOCK_KEYS:
                    blocks[bk + "_q"], blocks[bk + "_scale"] = _quantize_stacked(
                        bv, quantize_weight_int8)
                else:
                    blocks[bk] = bv
            out["blocks"] = blocks
        elif isinstance(v, dict):
            sub = dict(v)
            for ck, kk in _VIT_FLAT_KEYS:
                if ck == k and kk in sub:
                    sub[kk + "_q"], sub[kk + "_scale"] = quantize_weight_int8(sub.pop(kk))
            out[k] = sub
        else:
            out[k] = v
    return out
