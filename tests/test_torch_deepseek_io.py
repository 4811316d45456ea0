"""DeepSeek checkpoints and quantization in the port against the JAX package:
the HF export byte for byte the JAX exporter's files, the HF load into the
same trees in both packages, native ``model.npz`` directories across the two
packages (dense and quantized), the int8 / int4 quantizers' codes and scales
bit for bit, the quantized models' perplexities within rtol 1e-5 of JAX's
(fp32), and
``main_llm.load_model``'s dispatch of every DeepSeek model form.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import main_llm as jcli
from ssp_x_vit_tpu.llm import deepseek as J
from ssp_x_vit_tpu.llm import evaluation as jeval
from ssp_x_vit_tpu.llm import quant as JQ
from ssp_x_vit_tpu.models.checkpoints import load_params_npz as jload_npz
from ssp_x_vit_tpu_torch.cli import main_llm as tcli
from ssp_x_vit_tpu_torch.llm import deepseek as T
from ssp_x_vit_tpu_torch.llm import evaluation as teval
from ssp_x_vit_tpu_torch.llm import quant as TQ
from ssp_x_vit_tpu_torch.llm.checkpoints import config_from_hf_dict, deepseek_params_from_jax

KW = dict(vocab_size=64, hidden_size=32, num_layers=3, num_heads=4, q_lora_rank=12,
          kv_lora_rank=16, qk_nope_head_dim=8, qk_rope_head_dim=4, v_head_dim=8,
          intermediate_size=48, moe_intermediate_size=16, n_routed_experts=4,
          n_shared_experts=1, num_experts_per_tok=2, n_group=2, topk_group=1,
          routed_scaling_factor=1.5, first_k_dense_replace=1)
TOKENS = (np.arange(16)[None] * 5 + 1) % 64


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's tiny tensors: the suite runs six
    workers on the host's cores, where a pool per worker only contends."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = J.DeepseekConfig(**KW), T.DeepseekConfig(**KW)
    jp = np_params(tcfg, 3)
    return jp, jcfg, deepseek_params_from_jax(jp, device="cpu"), tcfg


def np_params(tcfg, seed):
    """A parameter tree in the JAX layout made from a numpy seed (normal, std
    0.02; norms at one; small e_score_correction biases)."""
    rng = np.random.default_rng(seed)
    shapes = T.init_deepseek_params(None, tcfg, device="cpu")

    def fill(name, t):
        if isinstance(t, dict):
            return {k: fill(k, v) for k, v in t.items()}
        if name.startswith("ln") or name.endswith("norm"):
            return np.ones(tuple(t.shape), np.float32)
        if name == "e_bias":
            return rng.uniform(-0.05, 0.05, tuple(t.shape)).astype(np.float32)
        return (rng.standard_normal(tuple(t.shape)) * 0.02).astype(np.float32)

    return {k: fill(k, v) for k, v in shapes.items()}


def _same_tree(t, j, exact=True):
    assert set(t) == set(j), sorted(set(t) ^ set(j))
    for k, v in j.items():
        if isinstance(v, dict):
            _same_tree(t[k], v, exact)
            continue
        got = t[k].float().numpy() if t[k].dtype == torch.bfloat16 else t[k].numpy()
        ref = np.asarray(v, np.float32 if got.dtype == np.float32 else None)
        assert got.dtype == ref.dtype and got.shape == ref.shape, k
        if exact:
            np.testing.assert_array_equal(got, ref, err_msg=k)
        else:
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6, err_msg=k)


def test_hf_export_is_the_jax_exporters_file_and_loads_back(model, tmp_path):
    jp, jcfg, tp, tcfg = model
    J.export_hf_deepseek(str(tmp_path / "jax"), jax.tree.map(jnp.asarray, jp), jcfg)
    T.export_hf_deepseek(str(tmp_path / "port"), tp, tcfg)
    for name in ("model.safetensors", "config.json"):
        assert (tmp_path / "jax" / name).read_bytes() == (tmp_path / "port" / name).read_bytes()
    tl, tc = T.load_hf_deepseek(str(tmp_path / "jax"), device="cpu")
    jl, jc = J.load_hf_deepseek(str(tmp_path / "port"))
    assert dataclasses_equal(tc, jc)
    _same_tree(tl, jax.tree.map(np.asarray, jl))
    _same_tree(tl, jp)
    # a dense-only model exports first_k_dense_replace = num_layers
    dense = T.DeepseekConfig(**dict(KW, n_routed_experts=0))
    T.export_hf_deepseek(str(tmp_path / "dense"),
                         T.init_deepseek_params(None, dense, device="cpu"), dense)
    cfg = json.loads((tmp_path / "dense" / "config.json").read_text())
    assert cfg["first_k_dense_replace"] == 3 and cfg["n_shared_experts"] == 0
    with pytest.raises(ValueError, match="quantized"):
        T.export_hf_deepseek(str(tmp_path / "q"), TQ.quantize_deepseek_params_int8(tp, tcfg), tcfg)
    with pytest.raises(ValueError, match="attention-materialized"):
        import dataclasses

        T.export_hf_deepseek(str(tmp_path / "m"), tp,
                             dataclasses.replace(tcfg, pruned_attention_blocks=(1,)))
    assert not (tmp_path / "q").exists() and not (tmp_path / "m").exists()
    # the llama reader refuses deepseek_v3 as JAX's does
    with pytest.raises(ValueError, match="unsupported model_type deepseek_v3"):
        config_from_hf_dict(cfg)


def dataclasses_equal(tcfg, jcfg):
    import dataclasses

    a, b = dataclasses.asdict(tcfg), dataclasses.asdict(jcfg)
    return a == b


@pytest.mark.parametrize("bits", [8, 4])
def test_quantizers_are_jaxs_bit_for_bit(model, bits):
    jp, jcfg, tp, tcfg = model
    jq_fn = JQ.quantize_deepseek_params_int8 if bits == 8 else JQ.quantize_deepseek_params_int4
    tq_fn = TQ.quantize_deepseek_params_int8 if bits == 8 else TQ.quantize_deepseek_params_int4
    jq = jax.tree.map(np.asarray, jq_fn(jax.tree.map(jnp.asarray, jp), jcfg))
    tq = tq_fn(tp, tcfg)
    _same_tree(tq, jq)
    suffix = "_q" if bits == 8 else "_q4"
    assert tq["moe_blocks"]["gate_kernel" + suffix].shape[:2] == (2, 4)   # expert stacks
    assert "router" in tq["moe_blocks"] and "lm_head_q" in tq
    # the perplexity of the quantized tree (the fp32 forward over its _mm,
    # expert and lm_head epilogues) against JAX's evaluate_perplexity
    ids = (np.arange(4 * 32) * 11 + 5) % 64
    ref = jeval.evaluate_perplexity(jax.tree.map(jnp.asarray, jq), jcfg, ids, seq_len=32,
                                    enable_tqdm=False)
    assert teval.evaluate_perplexity(tq, tcfg, ids, seq_len=32) == pytest.approx(ref, rel=1e-5)
    # the absorbed decode reads kv_b through _kv_b_matrix (int8 / int4 unpack):
    # its greedy tokens are the full recompute's
    seq = T.deepseek_generate(tq, tcfg, np.asarray([3, 9, 27, 17], np.int32), max_new_tokens=4,
                              compute_dtype=torch.float32)
    full = T.deepseek_forward(tq, torch.as_tensor(seq[None]), tcfg, compute_dtype=torch.float32)
    assert full[0, 3:-1].argmax(dim=-1).tolist() == seq[4:].tolist()


def test_native_directories_cross_the_two_packages(model, tmp_path):
    jp, jcfg, tp, tcfg = model
    tq = TQ.quantize_deepseek_params_int8(tp, tcfg)
    T.save_deepseek_model(str(tmp_path / "port"), tq, tcfg)
    jl, jc = J.load_deepseek_model(str(tmp_path / "port"), dtype=jnp.float32)
    assert dataclasses_equal(tcfg, jc)
    _same_tree(tq, jax.tree.map(np.asarray, jl))
    assert np.asarray(jl["moe_blocks"]["gate_kernel_q"]).dtype == np.int8
    J.save_deepseek_model(str(tmp_path / "jax"), jax.tree.map(jnp.asarray, jp), jcfg)
    tl, tc = T.load_deepseek_model(str(tmp_path / "jax"), device="cpu", dtype=torch.float32)
    assert dataclasses_equal(tc, jcfg)
    _same_tree(tl, jp)
    # bf16 by default, as JAX's loader
    assert T.load_deepseek_model(str(tmp_path / "jax"), device="cpu")[0]["embed"].dtype == \
        torch.bfloat16
    assert set(jload_npz(str(tmp_path / "port" / "model.npz"))) == set(tq)


def test_main_llm_loads_every_deepseek_form(model, tmp_path, monkeypatch):
    jp, jcfg, tp, tcfg = model
    T.export_hf_deepseek(str(tmp_path / "hf"), tp, tcfg)
    T.save_deepseek_model(str(tmp_path / "native"), tp, tcfg)
    for form in ("hf", "native"):
        args = tcli.build_argparser().parse_args(["--model", str(tmp_path / form),
                                                  "--backend", "cpu"])
        p, c = tcli.load_model(args, torch.device("cpu"))
        jargs = tcli.build_argparser().parse_args(["--model", str(tmp_path / form)])
        jpp, jc = jcli.load_model(jargs)
        assert isinstance(c, T.DeepseekConfig) and dataclasses_equal(c, jc)
        _same_tree({k: v.float() if v.is_floating_point() else v for k, v in _flat(p).items()},
                   {k: np.asarray(v, np.float32) for k, v in _flat(jpp).items()})
    # the JAX CLI's test models: the same configs (JAX's initializer is
    # swapped for one that makes nothing: its random draws are JAX's own)
    monkeypatch.setattr(J, "init_deepseek_params", lambda rng, cfg: None)
    for name in ("tiny-random-deepseek", "tiny-random-deepseek-dense"):
        args = tcli.build_argparser().parse_args(["--model", name, "--backend", "cpu"])
        p, c = tcli.load_model(args, torch.device("cpu"))
        _, jc = jcli.load_model(args)
        assert dataclasses_equal(c, jc)
        assert {k: tuple(v.shape) for k, v in _flat(p).items()} == \
            {k: v.shape for k, v in _flat(np_params(c, 0)).items()}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out
