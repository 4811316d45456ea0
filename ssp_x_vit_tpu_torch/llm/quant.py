"""Weight-only int8 / int4 quantization of LLM parameter trees (counterpart of
``ssp_x_vit_tpu/llm/quant.py``).

Symmetric per-output-channel: ``w ~= w_q * scale[out]`` with
``scale = max|w[:, out]| / 127`` (int8) or ``/ 7`` (int4). The scale is
applied to the matmul output, never to the weight, so no dequantised copy of a
weight exists in device memory: int8 projections are a product with a convert
(``ops.common.mm_quant``), packed int4 projections go through the hand-written
dequant GEMM (``ops/kernels/quant_matmul.py``). Norms, biases and embeddings
keep their dtype; a tied lm_head (``embed.T``) stays unquantized, an untied
one becomes int8 in both variants. The quantized tree keeps the stacked
``[L, ...]`` layout, so every forward works on it unchanged.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ssp_x_vit_tpu_torch.llm.model import LlamaConfig, Params
from ssp_x_vit_tpu_torch.ops.kernels.quant_matmul import quantize_weight_int4

# Projection kernels worth quantizing: [.., d_in, d_out] with the scale over
# the last axis. Per-key presence is optional (llama layout has gate/up/down,
# phi layout fc1/fc2).
QUANT_KEYS = ("q_kernel", "k_kernel", "v_kernel", "o_kernel",
              "gate_kernel", "up_kernel", "down_kernel",
              "fc1_kernel", "fc2_kernel",
              "qkv_kernel", "gateup_kernel")


def quantize_weight_int8(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8. ``w`` [..., d_in, d_out]; returns
    (w_q int8 of the same shape, scale fp32 with the d_in axis reduced away)."""
    w32 = w.float()
    absmax = w32.abs().amax(dim=-2)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    w_q = torch.round(w32 / scale[..., None, :])
    return torch.clamp(w_q, -127, 127).to(torch.int8), scale


def dequantize_weight(w_q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return (w_q.float() * scale[..., None, :]).to(dtype)


def _quantize_stacked(v: torch.Tensor, quantize) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize a stacked [L, (E,) K, N] kernel one [K, N] matrix at a time,
    which bounds the fp32 temporaries to one matrix of a full-size model."""
    if v.dim() < 3:
        return quantize(v)
    parts = [_quantize_stacked(v[i], quantize) for i in range(v.shape[0])]
    return torch.stack([p[0] for p in parts]), torch.stack([p[1] for p in parts])


def _quantize_tree(params: Params, quantize, suffix: str) -> Params:
    out = {k: v for k, v in params.items() if k != "blocks"}
    blocks = {}
    for k, v in params["blocks"].items():
        if k in QUANT_KEYS:
            blocks[k + suffix], blocks[k + "_scale"] = _quantize_stacked(v, quantize)
        else:
            blocks[k] = v
    out["blocks"] = blocks
    if "lm_head" in out:  # untied head only; a tied embed.T stays unquantized
        out["lm_head_q"], out["lm_head_scale"] = quantize_weight_int8(out.pop("lm_head"))
    return out


def quantize_llm_params_int8(params: Params, cfg: LlamaConfig) -> Params:
    """A tree where every projection kernel ``k`` is replaced by ``k + "_q"``
    (int8) and ``k + "_scale"`` (fp32 per output channel); the original
    kernels are dropped. Works on dense, width-pruned, depth-materialized and
    MoE trees (expert stacks ``[L, E, d_in, d_out]`` per (expert, out-channel);
    the router stays float: it is tiny and decides the routing)."""
    return _quantize_tree(params, quantize_weight_int8, "_q")


def quantize_llm_params_int4(params: Params, cfg: LlamaConfig) -> Params:
    """int4 variant: projection kernels become ``k + "_q4"`` (packed [K/2, N]
    int8 nibbles, ``pack_int4`` layout) and ``k + "_scale"``; MoE expert stacks
    pack per (layer, expert, out-channel) and unpack inside the expert
    product (``parallel/moe.py``). The lm_head stays int8: the 15-level grid
    is coarse and the head is a small share of the weight bytes."""
    return _quantize_tree(params, quantize_weight_int4, "_q4")


# DeepSeek/MLA projection kernels: the low-rank a / b projections, kv_b, o,
# the dense and shared-expert GLUs and the routed expert stacks ([L, E, K, N],
# per (expert, out-channel)); router, e_bias and norms stay float.
DS_QUANT_KEYS = ("q_kernel", "q_a_kernel", "q_b_kernel", "kv_a_kernel",
                 "kv_b_kernel", "o_kernel", "gate_kernel", "up_kernel",
                 "down_kernel", "shared_gate", "shared_up", "shared_down")


def _quantize_deepseek_tree(params: Params, quantize, suffix: str) -> Params:
    out = {k: v for k, v in params.items() if k not in ("dense_blocks", "moe_blocks")}
    for grp in ("dense_blocks", "moe_blocks"):
        if grp not in params:
            continue
        blocks = {}
        for k, v in params[grp].items():
            if k in DS_QUANT_KEYS:
                blocks[k + suffix], blocks[k + "_scale"] = _quantize_stacked(v, quantize)
            else:
                blocks[k] = v
        out[grp] = blocks
    if "lm_head" in out:  # untied head only; a tied embed.T stays float
        out["lm_head_q"], out["lm_head_scale"] = quantize_weight_int8(out.pop("lm_head"))
    return out


def quantize_deepseek_params_int8(params: Params, cfg) -> Params:
    """int8 weights for the DeepSeek/MLA family: every projection kernel of
    ``dense_blocks`` / ``moe_blocks`` becomes ``k + "_q"`` and ``k + "_scale"``
    (the codes and scales of the JAX quantizer, bit for bit); the lm_head int8."""
    return _quantize_deepseek_tree(params, quantize_weight_int8, "_q")


def quantize_deepseek_params_int4(params: Params, cfg) -> Params:
    """int4 weights for the DeepSeek/MLA family: projections and the routed
    expert stacks become ``k + "_q4"`` packed nibbles and ``k + "_scale"``
    (projections through the dequant GEMM, expert stacks unpacked in the
    expert product, ``kv_b`` unpacked in the absorbed paths); the lm_head
    stays int8, as in the llama family."""
    return _quantize_deepseek_tree(params, quantize_weight_int4, "_q4")


def quantized_param_bytes(params: Params) -> int:
    """Actual weight footprint in bytes (integer codes + scales + the rest)."""
    total = 0
    for v in params.values():
        if isinstance(v, dict):
            total += quantized_param_bytes(v)
        else:
            total += v.numel() * v.element_size()
    return total
