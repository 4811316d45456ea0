"""LLM checkpoints (counterpart of ``ssp_x_vit_tpu/llm/checkpoints.py``) and
the JAX -> torch carry-across.

``save_llm_model`` / ``load_llm_model`` read and write the framework's own
``model.npz`` + ``config.json`` (dense, 2SSP-materialized or int8/int4
quantized trees; bf16 leaves as raw 2-byte words), the same files the JAX
package writes, so a model saved by either package loads in the other.

``load_hf_llama`` / ``export_hf_llama`` read and write local HF causal-LM
directories (``config.json`` + ``*.safetensors``) of the families the model
runs: llama, mistral, qwen2, qwen3, gemma, gemma2, phi, phi3 (loaded as
llama), opt and the mixtures of experts mixtral and qwen3_moe (router
``[L, d, E]`` and expert stacks ``[L, E, d, f]`` / ``[L, E, f, d]``). The
loader reads one tensor at a time and converts it on the target device; the
exporter writes F32, byte for byte the JAX exporter's file for the same
parameters. DeepSeek-V3 directories load through
``llm/deepseek.py`` (``load_hf_deepseek``), and ``config_from_hf_dict``
refuses ``deepseek_v3`` as the JAX package's does.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ssp_x_vit_tpu_torch.device import DeviceLike, resolve_device
from ssp_x_vit_tpu_torch.llm.model import LlamaConfig, Params
from ssp_x_vit_tpu_torch.llm.rope import RopeScaling, export_rope_scaling, parse_rope_scaling
from ssp_x_vit_tpu_torch.models.checkpoints import (
    SafetensorsFiles, _fp32, _stack, _t, _write_safetensors, load_params_npz, save_params_npz,
    to_tensor,
)

# HF MoE naming per model_type: (submodule, ((leaf, expert projection), ...))
_MOE_NAMES = {
    "mixtral": ("block_sparse_moe", (("gate_kernel", "w1"), ("up_kernel", "w3"),
                                     ("down_kernel", "w2"))),
    "qwen3_moe": ("mlp", (("gate_kernel", "gate_proj"), ("up_kernel", "up_proj"),
                          ("down_kernel", "down_proj"))),
}


def llm_params_from_jax(tree: Dict[str, Any], *, device: DeviceLike = None,
                        dtype=torch.float32) -> Params:
    """The JAX package's LLM parameter tree (nested dict of numpy arrays, any
    of the family layouts; plain, ``_q`` int8, ``_q4`` packed int4 and
    ``_scale`` leaves) -> the same nested dict of tensors on ``device``.
    ``dtype`` applies to the float weights; integer codes keep their dtype and
    the per-channel ``_scale`` leaves stay float32, as the quantizers make them.
    Multi-LoRA banks (``<target>_lora_a`` / ``_lora_b`` leaves) and LoRA
    adapter trees (``{target: {"a", "b"}}``) keep their own float dtype: a
    bank stays float on any base (``llm/multilora.py``)."""
    dev = resolve_device(device)

    def convert(node):
        out: Params = {}
        adapter = set(node) == {"a", "b"}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = convert(v)
            else:
                leaf_dtype = (torch.float32 if k.endswith("_scale") else
                              None if adapter or k.endswith(("_lora_a", "_lora_b")) else dtype)
                out[k] = to_tensor(np.asarray(v), dev, leaf_dtype)
        return out

    return convert(tree)


def deepseek_params_from_jax(tree: Dict[str, Any], *, device: DeviceLike = None,
                             dtype=torch.float32) -> Params:
    """The JAX package's DeepSeek tree (``embed``, ``ln_final``, ``lm_head``
    and the ``dense_blocks`` / ``moe_blocks`` groups of stacked leaves;
    plain, ``_q``, ``_q4`` and ``_scale``) -> the same nested dict of tensors
    on ``device``, converted as :func:`llm_params_from_jax` converts a llama
    tree."""
    return llm_params_from_jax(tree, device=device, dtype=dtype)


def sliced_params_from_jax(tree: Dict[str, Any], *, device: DeviceLike = None,
                           dtype=torch.float32) -> Params:
    """The JAX package's SliceGPT tree (``embed``, OPT's ``pos_embed``, the
    list ``layers`` of per-layer dicts with their shortcut matrices,
    ``lm_head`` and phi-2 / OPT's ``lm_head_bias``) -> the same tree of
    tensors on ``device`` in ``dtype``, as ``llm.slicegpt.slicegpt`` returns it."""
    dev = resolve_device(device)
    out: Params = {k: to_tensor(np.asarray(v), dev, dtype) for k, v in tree.items()
                   if k != "layers"}
    out["layers"] = [{k: to_tensor(np.asarray(v), dev, dtype) for k, v in lp.items()}
                     for lp in tree["layers"]]
    return out


def pools_from_jax(pool, *, device: DeviceLike = None):
    """A paged KV pool of the JAX package (an array, or the int8 pool
    ``{"q": int8 codes, "s": fp32 scales}``) -> the port's pool on ``device``,
    every leaf in its own dtype (fp32, bf16, int8)."""
    dev = resolve_device(device)
    if isinstance(pool, dict):
        return {k: to_tensor(np.asarray(v), dev, None) for k, v in pool.items()}
    return to_tensor(np.asarray(pool), dev, None)


def caches_from_jax(cache_k, cache_v, *, device: DeviceLike = None):
    """A contiguous KV cache pair of the JAX package (``serve.init_cache``:
    arrays ``[A, b, max_len, nkv, hd]``, or the int8 caches ``{"q": int8
    codes, "s": fp32 scales}``) -> the port's caches on ``device``, every leaf
    in its own dtype."""
    return pools_from_jax(cache_k, device=device), pools_from_jax(cache_v, device=device)


def config_to_dict(cfg: LlamaConfig) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


def config_from_dict(d: Dict[str, Any]) -> LlamaConfig:
    """Inverse of :func:`config_to_dict` after a JSON round trip: lists back
    to tuples (the config is frozen and hashable), the nested ``rope_scaling``
    dict back to a ``RopeScaling``."""
    d = dict(d)
    for k, v in d.items():
        if isinstance(v, list):
            d[k] = tuple(v)
    if isinstance(d.get("rope_scaling"), dict):
        d["rope_scaling"] = RopeScaling(**d["rope_scaling"])
    return LlamaConfig(**d)


def save_llm_model(out_dir: str, params: Params, cfg: LlamaConfig) -> str:
    """Persist an LLM (dense, 2SSP-materialized or quantized tree) as
    ``model.npz`` + ``config.json``."""
    os.makedirs(out_dir, exist_ok=True)
    save_params_npz(os.path.join(out_dir, "model.npz"), params)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(config_to_dict(cfg), f, indent=2)
    return out_dir


def load_llm_model(model_dir: str, *, device: DeviceLike = None,
                   dtype=torch.bfloat16) -> Tuple[Params, LlamaConfig]:
    """Inverse of :func:`save_llm_model`, onto ``device`` (``cuda`` by
    default). ``dtype`` applies to float leaves only: int8 codes keep their
    dtype, so quantized models round-trip losslessly."""
    with open(os.path.join(model_dir, "config.json")) as f:
        cfg = config_from_dict(json.load(f))
    params = load_params_npz(os.path.join(model_dir, "model.npz"), device=device, dtype=dtype)
    return params, cfg


# ------------------------------------------------------------ HF directories ---

def config_from_hf_dict(d: Dict[str, Any]) -> LlamaConfig:
    """An HF ``config.json`` dict -> LlamaConfig, as the JAX package reads it."""
    mt = d.get("model_type", "llama")
    if mt not in ("llama", "mistral", "qwen2", "phi3", "phi", "opt", "gemma", "gemma2", "qwen3",
                  "mixtral", "qwen3_moe"):
        raise ValueError(f"unsupported model_type {mt}")
    heads = d["num_attention_heads"]
    head_dim = d.get("head_dim", d["hidden_size"] // heads)
    rotary_dim = None
    if mt == "phi":
        rotary_dim = int(d.get("partial_rotary_factor", 0.4) * head_dim)
    if mt == "opt":
        # 125m-class layout only: pre-LN, no embedding projection
        if not d.get("do_layer_norm_before", True):
            raise ValueError("post-LN OPT variants unsupported")
        if d.get("word_embed_proj_dim", d["hidden_size"]) != d["hidden_size"]:
            raise ValueError("OPT word_embed_proj_dim != hidden_size unsupported")
        return LlamaConfig(
            vocab_size=d["vocab_size"], hidden_size=d["hidden_size"],
            num_layers=d["num_hidden_layers"], num_heads=heads, num_kv_heads=heads,
            intermediate_size=d["ffn_dim"], tie_embeddings=d.get("tie_word_embeddings", True),
            model_type="opt", qkv_bias=d.get("enable_bias", True), layer_norm_eps=1e-5,
            max_position_embeddings=d.get("max_position_embeddings", 2048))
    # Sliding windows as HF applies them: mistral, phi3 and mixtral whenever
    # set; qwen2 and qwen3(_moe) only under use_sliding_window and only for the
    # layers from max_window_layers on (a mixed stack keeps per-layer bounds);
    # gemma-2 on the even layers.
    sliding_window, window_layers = None, None
    if d.get("sliding_window") is not None:
        if mt in ("mistral", "phi3", "mixtral"):
            sliding_window = d["sliding_window"]
        elif mt in ("qwen2", "qwen3", "qwen3_moe") and d.get("use_sliding_window", False):
            mwl = d.get("max_window_layers", d["num_hidden_layers"])
            L = d["num_hidden_layers"]
            if mwl < L:
                sliding_window = d["sliding_window"]
                if mwl > 0:
                    window_layers = tuple(range(mwl, L))
        elif mt == "gemma2":
            sliding_window = d["sliding_window"]
            window_layers = tuple(range(0, d["num_hidden_layers"], 2))
    num_experts, moe_top_k, aux_coef = 0, 1, 0.01
    intermediate = d["intermediate_size"]
    if mt == "qwen3_moe":
        # HF Qwen3Moe: softmax -> top-k -> renormalize (norm_topk_prob) is the
        # dropless top-k gate; the expert width is moe_intermediate_size. The
        # JAX package's refusals, with its messages.
        if not d.get("norm_topk_prob", True):
            raise ValueError("qwen3_moe with norm_topk_prob=False keeps "
                             "un-renormalized gates; the dropless top-k "
                             "path here renormalizes — refusing instead of "
                             "silently diverging")
        if d.get("decoder_sparse_step", 1) != 1 or d.get("mlp_only_layers"):
            raise ValueError("qwen3_moe with dense-MLP layers interleaved "
                             "(decoder_sparse_step/mlp_only_layers) is not "
                             "representable in the uniform MoE block stack")
        num_experts = d["num_experts"]
        moe_top_k = d.get("num_experts_per_tok", 8)
        aux_coef = d.get("router_aux_loss_coef", 0.001)
        intermediate = d["moe_intermediate_size"]
    if mt == "mixtral":
        # HF MixtralSparseMoeBlock: softmax over all experts -> top-k ->
        # renormalize over the k. Top-1 would renormalize to a unit gate where
        # the switch path keeps the raw probability, so it is refused.
        num_experts = d["num_local_experts"]
        moe_top_k = d.get("num_experts_per_tok", 2)
        aux_coef = d.get("router_aux_loss_coef", 0.02)
        if moe_top_k < 2:
            raise ValueError(
                "mixtral with num_experts_per_tok=1 renormalizes the single "
                "gate to 1.0 (HF semantics); the switch-MoE path here keeps "
                "the raw router probability — refusing instead of silently "
                "diverging")
    gemma = mt in ("gemma", "gemma2")
    qwen3 = mt in ("qwen3", "qwen3_moe")
    return LlamaConfig(
        vocab_size=d["vocab_size"],
        hidden_size=d["hidden_size"],
        num_layers=d["num_hidden_layers"],
        num_heads=heads,
        num_kv_heads=d.get("num_key_value_heads", heads),
        intermediate_size=intermediate,
        num_experts=num_experts,
        moe_top_k=moe_top_k,
        router_aux_coef=aux_coef,
        rms_eps=d.get("rms_norm_eps", 1e-5),
        rope_theta=d.get("rope_theta", 10000.0),
        rope_scaling=parse_rope_scaling(d.get("rope_scaling")),
        tie_embeddings=d.get("tie_word_embeddings", gemma),
        model_type=mt,
        max_position_embeddings=d.get("max_position_embeddings", 2048),
        sliding_window=sliding_window,
        qkv_bias=(mt == "qwen2" or (qwen3 and d.get("attention_bias", False))),
        rotary_dim=rotary_dim,
        layer_norm_eps=d.get("layer_norm_eps", 1e-5),
        explicit_head_dim=d.get("head_dim") if gemma or qwen3 else None,
        qk_norm=qwen3,
        hidden_act="gelu_tanh" if gemma else "silu",
        scale_embeddings=gemma,
        window_layers=window_layers,
        attn_softcap=d.get("attn_logit_softcapping", 50.0) if mt == "gemma2" else None,
        final_softcap=d.get("final_logit_softcapping", 30.0) if mt == "gemma2" else None,
    )


# How a leaf maps onto an HF tensor: copied, transposed ([out, in] <-> [in, out]),
# or a gemma RMSNorm scale (HF stores w, the tree 1 + w).
_ID, _T, _NORM = "id", "t", "norm"


def _layer_names(cfg: LlamaConfig) -> Tuple[str, List[Tuple[str, str, str]]]:
    """(HF layer prefix, [(leaf, HF suffix, kind)]) in the JAX exporter's order."""
    if cfg.is_opt:
        return "model.decoder.layers.{i}.", [
            ("ln1", "self_attn_layer_norm.weight", _ID), ("ln1_bias", "self_attn_layer_norm.bias", _ID),
            ("q_kernel", "self_attn.q_proj.weight", _T), ("q_bias", "self_attn.q_proj.bias", _ID),
            ("k_kernel", "self_attn.k_proj.weight", _T), ("k_bias", "self_attn.k_proj.bias", _ID),
            ("v_kernel", "self_attn.v_proj.weight", _T), ("v_bias", "self_attn.v_proj.bias", _ID),
            ("o_kernel", "self_attn.out_proj.weight", _T), ("o_bias", "self_attn.out_proj.bias", _ID),
            ("ln2", "final_layer_norm.weight", _ID), ("ln2_bias", "final_layer_norm.bias", _ID),
            ("fc1_kernel", "fc1.weight", _T), ("fc1_bias", "fc1.bias", _ID),
            ("fc2_kernel", "fc2.weight", _T), ("fc2_bias", "fc2.bias", _ID)]
    if cfg.is_phi:
        return "model.layers.{i}.", [
            ("ln1", "input_layernorm.weight", _ID), ("ln1_bias", "input_layernorm.bias", _ID),
            ("q_kernel", "self_attn.q_proj.weight", _T), ("q_bias", "self_attn.q_proj.bias", _ID),
            ("k_kernel", "self_attn.k_proj.weight", _T), ("k_bias", "self_attn.k_proj.bias", _ID),
            ("v_kernel", "self_attn.v_proj.weight", _T), ("v_bias", "self_attn.v_proj.bias", _ID),
            ("o_kernel", "self_attn.dense.weight", _T), ("o_bias", "self_attn.dense.bias", _ID),
            ("fc1_kernel", "mlp.fc1.weight", _T), ("fc1_bias", "mlp.fc1.bias", _ID),
            ("fc2_kernel", "mlp.fc2.weight", _T), ("fc2_bias", "mlp.fc2.bias", _ID)]
    names = [("ln1", "input_layernorm.weight", _NORM),
             ("q_kernel", "self_attn.q_proj.weight", _T), ("k_kernel", "self_attn.k_proj.weight", _T),
             ("v_kernel", "self_attn.v_proj.weight", _T), ("o_kernel", "self_attn.o_proj.weight", _T)]
    if not cfg.num_experts:  # the expert stacks are _moe_tensor_names'
        names += [("gate_kernel", "mlp.gate_proj.weight", _T),
                  ("up_kernel", "mlp.up_proj.weight", _T),
                  ("down_kernel", "mlp.down_proj.weight", _T)]
    if cfg.is_gemma2:  # ln2 is the PRE-feedforward norm; the post norms are their own leaves
        names += [("ln1_post", "post_attention_layernorm.weight", _NORM),
                  ("ln2", "pre_feedforward_layernorm.weight", _NORM),
                  ("ln2_post", "post_feedforward_layernorm.weight", _NORM)]
    else:
        names.append(("ln2", "post_attention_layernorm.weight", _NORM))
    if cfg.qkv_bias:
        names += [("q_bias", "self_attn.q_proj.bias", _ID), ("k_bias", "self_attn.k_proj.bias", _ID),
                  ("v_bias", "self_attn.v_proj.bias", _ID)]
    if cfg.qk_norm:
        names += [("q_norm", "self_attn.q_norm.weight", _ID),
                  ("k_norm", "self_attn.k_norm.weight", _ID)]
    return "model.layers.{i}.", names


def _moe_tensor_names(cfg: LlamaConfig, i: int) -> List[Tuple[str, str, Any]]:
    """[(leaf, HF name, expert index or None)] of layer ``i``'s router and expert
    projections, in the JAX exporter's order: the router (HF ``gate``, [E, d]),
    then each projection for every expert ([out, in])."""
    pre, names = _MOE_NAMES[cfg.model_type]
    out = [("router", f"model.layers.{i}.{pre}.gate.weight", None)]
    for ours, theirs in names:
        out += [(ours, f"model.layers.{i}.{pre}.experts.{e}.{theirs}.weight", e)
                for e in range(cfg.num_experts)]
    return out


def _top_names(cfg: LlamaConfig) -> List[Tuple[str, str, str]]:
    """[(leaf, HF name, kind)] outside the blocks, in the JAX exporter's order;
    ``lm_head`` is left out of tied models (and out of a load without one)."""
    if cfg.is_opt:
        names = [("embed", "model.decoder.embed_tokens.weight", _ID),
                 ("pos_embed", "model.decoder.embed_positions.weight", _ID),
                 ("ln_final", "model.decoder.final_layer_norm.weight", _ID),
                 ("ln_final_bias", "model.decoder.final_layer_norm.bias", _ID)]
    elif cfg.is_phi:
        return [("embed", "model.embed_tokens.weight", _ID),
                ("ln_final", "model.final_layernorm.weight", _ID),
                ("ln_final_bias", "model.final_layernorm.bias", _ID),
                ("lm_head", "lm_head.weight", _T), ("lm_head_bias", "lm_head.bias", _ID)]
    else:
        names = [("embed", "model.embed_tokens.weight", _ID),
                 ("ln_final", "model.norm.weight", _NORM)]
    if not cfg.tie_embeddings:
        names.append(("lm_head", "lm_head.weight", _T))
    return names


def _gemma(cfg: LlamaConfig) -> bool:
    return cfg.model_type in ("gemma", "gemma2")


def load_hf_llama(model_dir: str, *, device: DeviceLike = None,
                  dtype=torch.bfloat16) -> Tuple[Params, LlamaConfig]:
    """A local HF causal-LM directory (``config.json`` + ``*.safetensors``
    shards) -> (params, cfg) on ``device`` (``cuda`` by default), every leaf in
    ``dtype``. Each tensor is read alone, moved to the device in its file
    dtype and turned there into fp32 (where the family's transform applies:
    the transpose, gemma's 1 + w, gemma-2's query_pre_attn_scalar folded into
    q_proj, phi3's fused projections split) and then into ``dtype``, so the
    values are those of the JAX loader."""
    dev = resolve_device(device)
    with open(os.path.join(model_dir, "config.json")) as f:
        raw_cfg = json.load(f)
    cfg = config_from_hf_dict(raw_cfg)
    shards = sorted(glob.glob(os.path.join(model_dir, "*.safetensors")))
    if not shards:
        raise FileNotFoundError(f"no safetensors shards in {model_dir}")
    sd = SafetensorsFiles(shards)
    L = cfg.num_layers
    phi3 = cfg.model_type == "phi3"
    if phi3:  # phi-3 loads as the llama layout (its fused projections split below)
        cfg = dataclasses.replace(cfg, model_type="llama")
    gemma = _gemma(cfg)

    def convert(x, kind):
        if kind == _T:
            return _t(x)
        return x + 1.0 if kind == _NORM and gemma else x

    prefix, names = _layer_names(cfg)
    blocks: Dict[str, torch.Tensor] = {}
    if phi3:
        hq, hkv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
        f = cfg.intermediate_size
        splits = {"q_kernel": ("self_attn.qkv_proj.weight", 0, hq),
                  "k_kernel": ("self_attn.qkv_proj.weight", hq, hq + hkv),
                  "v_kernel": ("self_attn.qkv_proj.weight", hq + hkv, hq + 2 * hkv),
                  "gate_kernel": ("mlp.gate_up_proj.weight", 0, f),
                  "up_kernel": ("mlp.gate_up_proj.weight", f, 2 * f)}
    for ours, theirs, kind in names:
        if phi3 and ours in splits:
            fused, a, b = splits[ours]
            get = lambda i, fused=fused, a=a, b=b: _t(_fp32(sd, prefix.format(i=i) + fused, dev))[:, a:b]
        else:
            get = lambda i, theirs=theirs, kind=kind: convert(
                _fp32(sd, prefix.format(i=i) + theirs, dev), kind)
        if cfg.is_gemma2 and ours == "q_kernel":
            # the query_pre_attn_scalar attention scale folded into q_proj
            qps = float(raw_cfg.get("query_pre_attn_scalar", cfg.head_dim))
            scale = float(cfg.head_dim ** 0.5 / qps ** 0.5)
            get = lambda i, get=get, scale=scale: get(i) * scale
        blocks[ours] = _stack(L, get, dev, dtype)
    if cfg.num_experts:
        moe = [_moe_tensor_names(cfg, i) for i in range(L)]

        def moe_leaf(i, ours):
            hf = [name for leaf, name, _ in moe[i] if leaf == ours]
            if ours == "router":
                return _t(_fp32(sd, hf[0], dev))
            return _stack(len(hf), lambda e: _t(_fp32(sd, hf[e], dev)), dev, torch.float32)

        for ours in ("router",) + tuple(leaf for leaf, _ in _MOE_NAMES[cfg.model_type][1]):
            blocks[ours] = _stack(L, lambda i, ours=ours: moe_leaf(i, ours), dev, dtype)
    params: Params = {"blocks": blocks}
    for ours, theirs, kind in _top_names(cfg):
        if ours == "lm_head" and not cfg.is_phi and theirs not in sd:
            continue
        params[ours] = convert(_fp32(sd, theirs, dev), kind).to(dtype).contiguous()
    return params, cfg


def hf_dict_from_config(cfg: LlamaConfig) -> Dict[str, Any]:
    """Inverse of :func:`config_from_hf_dict`: the HF config.json dict of
    ``cfg``, as the JAX package writes it. Raises ValueError where the config
    has no HF encoding."""
    if cfg.is_opt:
        return {
            "model_type": "opt", "architectures": ["OPTForCausalLM"],
            "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
            "num_hidden_layers": cfg.num_layers,
            "num_attention_heads": cfg.num_heads, "ffn_dim": cfg.intermediate_size,
            "max_position_embeddings": cfg.max_position_embeddings,
            "do_layer_norm_before": True, "enable_bias": True,
            "word_embed_proj_dim": cfg.hidden_size,
            "tie_word_embeddings": cfg.tie_embeddings,
            "activation_function": "relu",
        }
    if cfg.is_phi:
        return {
            "model_type": "phi", "architectures": ["PhiForCausalLM"],
            "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
            "num_hidden_layers": cfg.num_layers,
            "num_attention_heads": cfg.num_heads,
            "num_key_value_heads": cfg.num_kv_heads,
            "intermediate_size": cfg.effective_intermediate,
            "partial_rotary_factor": (cfg.rotary_dim or cfg.head_dim) / cfg.head_dim,
            "rope_theta": cfg.rope_theta,
            "layer_norm_eps": cfg.layer_norm_eps,
            "tie_word_embeddings": False,
            "hidden_act": "gelu_new",
            **({"rope_scaling": export_rope_scaling(cfg.rope_scaling)}
               if cfg.rope_scaling is not None else {}),
        }
    d: Dict[str, Any] = {
        "model_type": cfg.model_type,
        "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads,
        "intermediate_size": cfg.effective_intermediate,
        "rms_norm_eps": cfg.rms_eps, "rope_theta": cfg.rope_theta,
        "tie_word_embeddings": cfg.tie_embeddings,
        "max_position_embeddings": cfg.max_position_embeddings,
    }
    if cfg.rope_scaling is not None:
        d["rope_scaling"] = export_rope_scaling(cfg.rope_scaling)
    arch = {"llama": "LlamaForCausalLM", "mistral": "MistralForCausalLM",
            "qwen2": "Qwen2ForCausalLM", "gemma": "GemmaForCausalLM",
            "gemma2": "Gemma2ForCausalLM", "mixtral": "MixtralForCausalLM",
            "qwen3": "Qwen3ForCausalLM",
            "qwen3_moe": "Qwen3MoeForCausalLM"}.get(cfg.model_type)
    if arch is None:
        raise ValueError(f"model_type {cfg.model_type!r} has no HF export "
                         "encoding (phi3 loads normalize to llama layout)")
    d["architectures"] = [arch]
    if cfg.model_type == "mixtral":
        d["num_local_experts"] = cfg.num_experts
        d["num_experts_per_tok"] = cfg.moe_top_k
        d["router_aux_loss_coef"] = cfg.router_aux_coef
    if cfg.model_type in ("qwen3", "qwen3_moe"):
        d["head_dim"] = cfg.head_dim
        d["attention_bias"] = cfg.qkv_bias
    if cfg.model_type == "qwen3_moe":
        d["num_experts"] = cfg.num_experts
        d["num_experts_per_tok"] = cfg.moe_top_k
        d["router_aux_loss_coef"] = cfg.router_aux_coef
        d["norm_topk_prob"] = True
        d["decoder_sparse_step"] = 1
        d["mlp_only_layers"] = []
        # the loader read moe_intermediate_size into intermediate_size; every
        # layer is sparse, so the dense width is unused
        d["moe_intermediate_size"] = cfg.effective_intermediate
    if _gemma(cfg):
        d["head_dim"] = cfg.head_dim
        d["hidden_activation"] = "gelu_pytorch_tanh"
    if cfg.model_type == "gemma2":
        # the loader folded query_pre_attn_scalar into q_proj: exact under qps == head_dim
        d["query_pre_attn_scalar"] = cfg.head_dim
        d["attn_logit_softcapping"] = cfg.attn_softcap
        d["final_logit_softcapping"] = cfg.final_softcap
        d["sliding_window"] = cfg.sliding_window
        if cfg.sliding_window is not None and cfg.window_layers != tuple(
                range(0, cfg.num_layers, 2)):
            raise ValueError("HF gemma-2 windows even layers only; this config's "
                             f"window_layers {cfg.window_layers} cannot round-trip")
    elif cfg.sliding_window is None:
        if cfg.model_type == "mistral":
            # MistralConfig defaults sliding_window to 4096 when the key is absent
            d["sliding_window"] = None
    else:
        if cfg.model_type in ("mistral", "mixtral") and cfg.uniform_window:
            d["sliding_window"] = cfg.sliding_window
        elif cfg.model_type == "qwen2":
            wl = cfg.window_layers
            if wl is not None and wl != tuple(range(min(wl), cfg.num_layers)):
                raise ValueError(f"qwen2 window_layers {wl} is not a [mwl, L) suffix — "
                                 "not representable as max_window_layers")
            d["use_sliding_window"] = True
            d["sliding_window"] = cfg.sliding_window
            d["max_window_layers"] = min(wl) if wl else 0
        else:
            raise ValueError(f"{cfg.model_type} with sliding_window has no HF encoding")
    return d


def export_hf_llama(out_dir: str, params: Params, cfg: LlamaConfig) -> str:
    """Export a dense or width-pruned (materialized) LLM tree as an HF
    checkpoint, ``config.json`` + ``model.safetensors`` in F32: the inverse of
    :func:`load_hf_llama` (kernels transposed back, gemma's 1 + w taken off,
    gemma-2 with the folded q_proj under query_pre_attn_scalar == head_dim).
    The tensors are converted and written one at a time. Quantized trees,
    depth-materialized attention removal and windows without an HF encoding
    raise ValueError before anything is written. MoE trees export the router
    and expert stacks of mixtral / qwen3_moe configs (other model types raise)."""
    blocks = params["blocks"]
    if any(k.endswith(("_q", "_q4", "_scale")) for k in blocks) or "lm_head_q" in params:
        raise ValueError("quantized pytrees have no HF encoding — export the "
                         "dense params and quantize after from_pretrained")
    if cfg.num_experts and cfg.model_type not in _MOE_NAMES:
        raise ValueError("MoE export to HF needs an HF MoE layout "
                         "(model_type 'mixtral' or 'qwen3_moe'); native "
                         "MoE-llama configs use save_llm_model")
    if cfg.pruned_attention_blocks:
        raise ValueError("depth-materialized attention removal is not "
                         "representable in vanilla HF blocks; use save_llm_model")
    hf_cfg = hf_dict_from_config(cfg)   # every refusal before any write
    unbake = -1.0 if _gemma(cfg) else 0.0

    def convert(x, kind):
        if kind == _T:
            return _t(x)
        return x.float() + unbake if kind == _NORM and unbake else x

    prefix, names = _layer_names(cfg)
    tensors: Dict[str, torch.Tensor] = {}
    if cfg.num_experts:  # the JAX exporter writes every layer's experts first
        for i in range(cfg.num_layers):
            for ours, theirs, e in _moe_tensor_names(cfg, i):
                tensors[theirs] = _t(blocks[ours][i] if e is None else blocks[ours][i][e])
    for i in range(cfg.num_layers):
        for ours, theirs, kind in names:
            tensors[prefix.format(i=i) + theirs] = convert(blocks[ours][i], kind)
    for ours, theirs, kind in _top_names(cfg):
        if ours in params:
            tensors[theirs] = convert(params[ours], kind)
    os.makedirs(out_dir, exist_ok=True)
    _write_safetensors(os.path.join(out_dir, "model.safetensors"), tensors,
                       metadata={"format": "pt"})
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(hf_cfg, f, indent=2)
    return out_dir
