"""HF causal-LM directories in the port (``llm/checkpoints.py``: ``load_hf_llama``,
``export_hf_llama``, ``config_from_hf_dict``, ``hf_dict_from_config``; the
safetensors reader and writer of ``models/checkpoints.py``) against the JAX
package, on the CPU, tiny configs.

For each family the JAX package runs (llama with GQA, mistral with its window,
qwen2 with a mixed window, qwen3, gemma, gemma2, phi, opt, a width-pruned
llama, and phi3 from a hand-written directory with fused projections):
- a directory written by the JAX ``export_hf_llama`` loads through the port's
  ``load_hf_llama`` into the JAX loader's values, bit for bit, in bf16 and fp32;
- the port's export of the same parameters is byte-identical to the JAX
  export, and its ``config.json`` is equal;
- one fp32 forward of the loaded model against the JAX one (atol 1e-4, as the
  other LLM parity tests).
The refusals (quantized trees, attention removal, windows without an HF
encoding, MoE) raise before anything is written.
"""

import dataclasses
import filecmp
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssp_x_vit_tpu.llm import checkpoints as jckpt
from ssp_x_vit_tpu.llm import model as jmodel
from ssp_x_vit_tpu.llm import pruning as jprune
from ssp_x_vit_tpu.models.checkpoints import _write_safetensors as jwrite
from ssp_x_vit_tpu_torch.llm import checkpoints as tckpt
from ssp_x_vit_tpu_torch.llm import model as tmodel
from ssp_x_vit_tpu_torch.llm.quant import quantize_llm_params_int8

BASE = dict(vocab_size=96, hidden_size=32, num_layers=3, num_heads=4, num_kv_heads=4,
            intermediate_size=48)
FAMILIES = {
    "llama_gqa": dict(num_kv_heads=2),
    "mistral": dict(model_type="mistral", num_kv_heads=2, sliding_window=5),
    "qwen2_mixed_window": dict(model_type="qwen2", qkv_bias=True, sliding_window=5,
                               window_layers=(1, 2)),
    "qwen3": dict(model_type="qwen3", qk_norm=True, explicit_head_dim=16, num_kv_heads=2),
    "gemma": dict(model_type="gemma", hidden_act="gelu_tanh", scale_embeddings=True,
                  tie_embeddings=True, explicit_head_dim=16),
    "gemma2": dict(model_type="gemma2", hidden_act="gelu_tanh", scale_embeddings=True,
                   tie_embeddings=True, sliding_window=5, window_layers=(0, 2),
                   attn_softcap=50.0, final_softcap=30.0),
    "phi": dict(model_type="phi", qkv_bias=True, rotary_dim=4),
    "opt": dict(model_type="opt", qkv_bias=True, tie_embeddings=True,
                max_position_embeddings=64),
    "width_pruned": dict(num_kv_heads=2),
}
TOKENS = np.random.default_rng(3).integers(0, BASE["vocab_size"], (2, 12)).astype(np.int32)


def jax_model(name, seed=0):
    """A numpy-seeded JAX tree of the family (norm scales ~1 + noise, so gemma's
    1 + w bake and every transform are visible)."""
    cfg = jmodel.LlamaConfig(**{**BASE, **FAMILIES[name]})
    shapes = jax.eval_shape(lambda: jmodel.init_llama_params(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(seed)

    def leaf(key, shape):
        scale = 0.1 if key.startswith(("ln", "q_norm", "k_norm")) else 0.2
        base = 1.0 if key.startswith(("ln", "q_norm", "k_norm")) and "bias" not in key else 0.0
        return jnp.asarray((base + scale * rng.normal(size=shape)).astype(np.float32))

    params = {k: ({kk: leaf(kk, vv.shape) for kk, vv in v.items()} if isinstance(v, dict)
                  else leaf(k, v.shape)) for k, v in shapes.items()}
    if name == "width_pruned":
        keep = [np.sort(rng.choice(cfg.intermediate_size, 20, replace=False))
                for _ in range(cfg.num_layers)]
        params, cfg = jprune.materialize_llm_width_pruning(params, cfg, keep)
    return params, cfg


def leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def assert_same_leaves(jtree, ttree):
    jl, tl = leaves(jtree), leaves(ttree)
    assert sorted(jl) == sorted(tl)
    for k, v in jl.items():
        t = tl[k]
        assert str(t.dtype).split(".")[-1] == str(v.dtype), k
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(v.astype(jnp.float32)),
                                      err_msg=k)


def check_directory(d, jcfg_expected=None):
    """Both loaders on one directory: same config, same leaves in bf16 and fp32;
    returns the fp32 trees and configs."""
    out = {}
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)):
        jp, jc = jckpt.load_hf_llama(d, dtype=jdt)
        tp, tc = tckpt.load_hf_llama(d, device="cpu", dtype=tdt)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert_same_leaves(jp, tp)
        out[tdt] = (jp, jc, tp, tc)
    return out[torch.float32]


def check_forward(jp, jc, tp, tc):
    if jc.pruned_attention_blocks:
        raise AssertionError("not a materialized-attention case")
    ref, _ = jmodel.llama_forward(jp, jnp.asarray(TOKENS), jc, compute_dtype=jnp.float32)
    got, _ = tmodel.llama_forward(tp, torch.from_numpy(TOKENS).long(), tc,
                                  compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_jax_export_loads_into_the_same_values_and_exports_back_byte_for_byte(tmp_path, name):
    params, cfg = jax_model(name)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jckpt.export_hf_llama(jdir, params, cfg)
    jp, jc, tp, tc = check_directory(jdir)
    tckpt.export_hf_llama(tdir, tp, tc)
    assert filecmp.cmp(os.path.join(jdir, "model.safetensors"),
                       os.path.join(tdir, "model.safetensors"), shallow=False)
    with open(os.path.join(jdir, "config.json")) as f, open(os.path.join(tdir, "config.json")) as g:
        jtext, ttext = f.read(), g.read()
    assert json.loads(jtext) == json.loads(ttext) and jtext == ttext
    assert json.loads(ttext) == tckpt.hf_dict_from_config(tc) == jckpt.hf_dict_from_config(jc)
    check_forward(jp, jc, tp, tc)


def test_phi3_fused_projections_load_as_llama(tmp_path):
    """phi3 directories carry qkv_proj [hq + 2 hkv, d] and gate_up_proj [2f, d];
    both loaders split them and return a llama-layout model."""
    params, cfg = jax_model("llama_gqa", seed=5)
    blocks = {k: np.asarray(v) for k, v in params["blocks"].items()}
    tensors = {"model.embed_tokens.weight": np.asarray(params["embed"]),
               "model.norm.weight": np.asarray(params["ln_final"]),
               "lm_head.weight": np.ascontiguousarray(np.asarray(params["lm_head"]).T)}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        tensors[p + "input_layernorm.weight"] = blocks["ln1"][i]
        tensors[p + "post_attention_layernorm.weight"] = blocks["ln2"][i]
        tensors[p + "self_attn.qkv_proj.weight"] = np.ascontiguousarray(np.concatenate(
            [blocks["q_kernel"][i], blocks["k_kernel"][i], blocks["v_kernel"][i]], 1).T)
        tensors[p + "self_attn.o_proj.weight"] = np.ascontiguousarray(blocks["o_kernel"][i].T)
        tensors[p + "mlp.gate_up_proj.weight"] = np.ascontiguousarray(np.concatenate(
            [blocks["gate_kernel"][i], blocks["up_kernel"][i]], 1).T)
        tensors[p + "mlp.down_proj.weight"] = np.ascontiguousarray(blocks["down_kernel"][i].T)
    d = tmp_path / "phi3"
    d.mkdir()
    jwrite(str(d / "model.safetensors"), tensors, metadata={"format": "pt"})
    hf = {"model_type": "phi3", "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
          "num_hidden_layers": cfg.num_layers, "num_attention_heads": cfg.num_heads,
          "num_key_value_heads": cfg.num_kv_heads, "intermediate_size": cfg.intermediate_size,
          "rms_norm_eps": 1e-5, "tie_word_embeddings": False}
    (d / "config.json").write_text(json.dumps(hf))
    jp, jc, tp, tc = check_directory(str(d))
    assert tc.model_type == "llama"
    assert_same_leaves(params, tp)
    check_forward(jp, jc, tp, tc)


def test_sharded_bf16_and_f16_files_load_as_jax_reads_them(tmp_path):
    """Two shards, BF16 and F16 tensors: the reader widens them as the JAX one
    (BF16 by its 16-bit shift), on the target dtype."""
    import safetensors.torch

    params, cfg = jax_model("llama_gqa", seed=7)
    jdir = str(tmp_path / "jax")
    jckpt.export_hf_llama(jdir, params, cfg)
    full = safetensors.torch.load_file(os.path.join(jdir, "model.safetensors"))
    names = sorted(full)
    d = tmp_path / "sharded"
    d.mkdir()
    half = len(names) // 2
    safetensors.torch.save_file({k: full[k].to(torch.bfloat16) for k in names[:half]},
                                str(d / "model-00001-of-00002.safetensors"))
    safetensors.torch.save_file({k: full[k].to(torch.float16) for k in names[half:]},
                                str(d / "model-00002-of-00002.safetensors"))
    (d / "config.json").write_text(open(os.path.join(jdir, "config.json")).read())
    check_directory(str(d))


def test_refusals_leave_no_partial_directory(tmp_path):
    params, cfg = jax_model("llama_gqa")
    tp = tckpt.llm_params_from_jax(jax.device_get(params), device="cpu")
    tc = tmodel.LlamaConfig(**dataclasses.asdict(cfg))
    cases = [
        (quantize_llm_params_int8(tp, tc), tc, ValueError, "quantized"),
        (tp, dataclasses.replace(tc, pruned_attention_blocks=(1,)), ValueError, "attention removal"),
        (tp, dataclasses.replace(tc, sliding_window=4), ValueError, "no HF encoding"),
        (tp, dataclasses.replace(tc, model_type="mistral", sliding_window=4, window_layers=(0,)),
         ValueError, "no HF encoding"),
        (tp, dataclasses.replace(tc, model_type="qwen2", sliding_window=4, window_layers=(0, 2)),
         ValueError, "suffix"),
        (tp, dataclasses.replace(tc, model_type="gemma2", sliding_window=4, window_layers=(1,)),
         ValueError, "even layers"),
        (tp, dataclasses.replace(tc, model_type="phi3"), ValueError, "no HF export"),
        (tp, dataclasses.replace(tc, num_experts=4), ValueError, "HF MoE layout"),
    ]
    for i, (p, c, err, match) in enumerate(cases):
        out = tmp_path / f"refused{i}"
        with pytest.raises(err, match=match):
            tckpt.export_hf_llama(str(out), p, c)
        assert not out.exists(), match
    # the MoE types load (tests/test_torch_moe_io.py) but keep the JAX package's
    # three refusals, with its exception type
    moe = dict(num_attention_heads=4, hidden_size=32, vocab_size=64, num_hidden_layers=2,
               intermediate_size=48, num_local_experts=4, num_experts=4, moe_intermediate_size=24)
    for bad, match in ((dict(model_type="mixtral", num_experts_per_tok=1), "num_experts_per_tok=1"),
                       (dict(model_type="qwen3_moe", norm_topk_prob=False), "norm_topk_prob"),
                       (dict(model_type="qwen3_moe", decoder_sparse_step=2), "interleaved"),
                       (dict(model_type="qwen3_moe", mlp_only_layers=[1]), "interleaved")):
        for reader in (tckpt.config_from_hf_dict, jckpt.config_from_hf_dict):
            with pytest.raises(ValueError, match=match):
                reader({**moe, **bad})
    # deepseek_v3 directories load through llm/deepseek.py; the llama reader
    # refuses the type as the JAX package's does
    for reader in (tckpt.config_from_hf_dict, jckpt.config_from_hf_dict):
        with pytest.raises(ValueError, match="unsupported model_type deepseek_v3"):
            reader({"model_type": "deepseek_v3", "num_attention_heads": 4, "hidden_size": 32})
    with pytest.raises(ValueError, match="unsupported model_type"):
        tckpt.config_from_hf_dict({"model_type": "bert", "num_attention_heads": 4,
                                   "hidden_size": 32})
    with pytest.raises(FileNotFoundError, match="no safetensors"):
        (tmp_path / "empty").mkdir()
        (tmp_path / "empty" / "config.json").write_text(json.dumps(jckpt.hf_dict_from_config(cfg)))
        tckpt.load_hf_llama(str(tmp_path / "empty"), device="cpu")


def test_config_from_hf_dict_matches_jax_on_rope_and_window_forms():
    base = {"vocab_size": 64, "hidden_size": 32, "num_hidden_layers": 4,
            "num_attention_heads": 4, "intermediate_size": 48}
    variants = [
        {"model_type": "llama", "rope_scaling": {"rope_type": "llama3", "factor": 8.0,
                                                 "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                                                 "original_max_position_embeddings": 8192}},
        {"model_type": "llama", "rope_scaling": {"type": "linear", "factor": 2.0}},
        {"model_type": "qwen2", "rope_scaling": {"rope_type": "yarn", "factor": 4.0,
                                                 "original_max_position_embeddings": 4096,
                                                 "beta_fast": 32, "beta_slow": 1, "mscale": 1.0}},
        {"model_type": "llama", "rope_scaling": {"rope_type": "default"}},
        {"model_type": "qwen2", "sliding_window": 8, "use_sliding_window": True,
         "max_window_layers": 0},
        {"model_type": "qwen2", "sliding_window": 8, "use_sliding_window": False},
        {"model_type": "qwen3", "sliding_window": 8, "use_sliding_window": True,
         "max_window_layers": 2, "head_dim": 16, "attention_bias": True},
        {"model_type": "phi3", "sliding_window": 8},
        {"model_type": "phi", "partial_rotary_factor": 0.5},
        {"model_type": "gemma2", "sliding_window": 8, "head_dim": 8,
         "query_pre_attn_scalar": 8},
        {"model_type": "opt", "ffn_dim": 48},
    ]
    for v in variants:
        d = {**base, **v}
        assert dataclasses.asdict(tckpt.config_from_hf_dict(d)) == dataclasses.asdict(
            jckpt.config_from_hf_dict(d)), v
    for bad in ({"model_type": "opt", "ffn_dim": 48, "do_layer_norm_before": False},
                {"model_type": "opt", "ffn_dim": 48, "word_embed_proj_dim": 16}):
        with pytest.raises(ValueError):
            tckpt.config_from_hf_dict({**base, **bad})
