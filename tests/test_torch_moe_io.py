"""MoE models in and out of the port: HF mixtral and qwen3_moe directories
(``llm/checkpoints.py``), native save and load, and the CLIs that read them
(``cli/main_llm.py``, ``cli/serve_http.py``, ``cli/train_llm.py``), against the
JAX package on the CPU, tiny configs.

- A directory written by the JAX ``export_hf_llama`` from numpy-seeded weights
  loads through the port's ``load_hf_llama`` into the JAX loader's values, bit
  for bit, in bf16 and fp32; the port's export of the same parameters is byte
  for byte the JAX export, its ``config.json`` equal; one fp32 forward of the
  loaded model within 1e-4 of the JAX one. ``config_from_hf_dict`` reads hand
  written mixtral / qwen3_moe dicts (windows, expert counts, widths) as the
  JAX package does.
- Native ``model.npz`` + ``config.json`` of float, int8 and int4 MoE trees go
  both ways between the packages unchanged.
- ``main_llm`` on the mixtral directory: dense and ``--quantize int4``
  perplexity against the JAX forward's (rel 2e-2, bf16 as the other CLI
  tests; the JAX ``evaluate_perplexity`` refuses MoE models, an accepted
  difference), shortGPT's mask as the JAX package picks it, 2SSP refused as
  the JAX package refuses it; ``serve_http``'s engine over the directory serves
  the greedy tokens of ``generate_kv_scan``; ``train_llm`` trains the
  directory, a fresh ``--init-json`` MoE model, and distils against it.
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
from ssp_x_vit_tpu.llm import datasets as jdata
from ssp_x_vit_tpu.llm import evaluation as jeval
from ssp_x_vit_tpu.llm import model as jmodel
from ssp_x_vit_tpu.llm import pruning as jprune
from ssp_x_vit_tpu.llm import quant as jquant
from ssp_x_vit_tpu_torch.cli import main_llm as tcli
from ssp_x_vit_tpu_torch.cli import serve_http as tserve_cli
from ssp_x_vit_tpu_torch.cli import train_llm as ttrain_cli
from ssp_x_vit_tpu_torch.llm import checkpoints as tckpt
from ssp_x_vit_tpu_torch.llm import model as tmodel
from ssp_x_vit_tpu_torch.llm import quant as tquant
from ssp_x_vit_tpu_torch.llm.serve import generate_kv_scan

BASE = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2,
            intermediate_size=24, num_experts=4, moe_top_k=2)
FAMILIES = {
    "mixtral": dict(model_type="mixtral", router_aux_coef=0.02, sliding_window=6),
    "qwen3_moe": dict(model_type="qwen3_moe", qk_norm=True, explicit_head_dim=16,
                      router_aux_coef=0.001),
}
TOKENS = np.random.default_rng(3).integers(0, BASE["vocab_size"], (2, 12)).astype(np.int32)
CLI = ["--backend", "cpu", "--synthetic-data", "--seq-len", "32", "--num-calibration", "3",
       "--num-calibration-2ssp", "2", "--logging", "WARNING"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's tiny tensors: the suite runs six
    workers on the host's cores, where a pool per worker only contends."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_model(name, seed=0):
    cfg = jmodel.LlamaConfig(**{**BASE, **FAMILIES[name]})
    shapes = jax.eval_shape(lambda: jmodel.init_llama_params(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(seed)

    def leaf(key, shape):
        norm = key.startswith(("ln", "q_norm", "k_norm"))
        scale = 0.5 if key == "router" else 0.1 if norm else 0.2
        return jnp.asarray(((1.0 if norm else 0.0) + scale * rng.normal(size=shape))
                           .astype(np.float32))

    return {k: ({kk: leaf(kk, vv.shape) for kk, vv in v.items()} if isinstance(v, dict)
                else leaf(k, v.shape)) for k, v in shapes.items()}, cfg


def leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(leaves(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
    return out


def assert_same_leaves(jtree, ttree):
    jl, tl = leaves(jtree), leaves(ttree)
    assert sorted(jl) == sorted(tl)
    for k, v in jl.items():
        assert str(tl[k].dtype).split(".")[-1] == str(v.dtype), k
        np.testing.assert_array_equal(tl[k].float().numpy(), np.asarray(v.astype(jnp.float32)),
                                      err_msg=k)


def exported(tmp_path, name):
    params, cfg = jax_model(name)
    d = str(tmp_path / name)
    jckpt.export_hf_llama(d, params, cfg)
    return d


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_hf_directory_loads_as_jax_and_exports_byte_for_byte(tmp_path, name):
    jdir = exported(tmp_path, name)
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)):
        jp, jc = jckpt.load_hf_llama(jdir, dtype=jdt)
        tp, tc = tckpt.load_hf_llama(jdir, device="cpu", dtype=tdt)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert tc.num_experts == 4 and tc.moe_top_k == 2 and tc.model_type == name
        assert_same_leaves(jp, tp)
    tdir = str(tmp_path / "torch")
    tckpt.export_hf_llama(tdir, tp, tc)
    assert filecmp.cmp(os.path.join(jdir, "model.safetensors"),
                       os.path.join(tdir, "model.safetensors"), shallow=False)
    with open(os.path.join(jdir, "config.json")) as f, open(os.path.join(tdir, "config.json")) as g:
        assert f.read() == g.read()
    ref, _ = jmodel.llama_forward(jp, jnp.asarray(TOKENS), jc, compute_dtype=jnp.float32)
    got, _ = tmodel.llama_forward(tp, torch.from_numpy(TOKENS).long(), tc,
                                  compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


def test_config_from_hf_dict_reads_moe_dicts_as_jax():
    common = dict(vocab_size=64, hidden_size=32, num_hidden_layers=4, num_attention_heads=4,
                  num_key_value_heads=2, intermediate_size=96)
    dicts = [
        dict(common, model_type="mixtral", num_local_experts=8, num_experts_per_tok=2,
             sliding_window=None, rope_theta=1e6, router_aux_loss_coef=0.02),
        dict(common, model_type="mixtral", num_local_experts=4, sliding_window=16),
        dict(common, model_type="qwen3_moe", num_experts=8, num_experts_per_tok=4,
             moe_intermediate_size=24, head_dim=16),
        dict(common, model_type="qwen3_moe", num_experts=8, moe_intermediate_size=24,
             head_dim=8, use_sliding_window=True, sliding_window=8, max_window_layers=2,
             attention_bias=True),
    ]
    for d in dicts:
        tc, jc = tckpt.config_from_hf_dict(d), jckpt.config_from_hf_dict(d)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc), d["model_type"]
        if tc.sliding_window is not None and tc.model_type == "qwen3_moe":
            for c, pkg in ((tc, tckpt), (jc, jckpt)):   # no HF encoding, in both packages
                with pytest.raises(ValueError, match="no HF encoding"):
                    pkg.hf_dict_from_config(c)
            continue
        assert tckpt.hf_dict_from_config(tc) == jckpt.hf_dict_from_config(jc)


@pytest.mark.parametrize("tree", ["float", "int8", "int4"])
def test_native_directories_go_both_ways(tmp_path, tree):
    params, cfg = jax_model("mixtral", seed=1)
    if tree != "float":
        params = getattr(jquant, f"quantize_llm_params_{tree}")(params, cfg)
    jckpt.save_llm_model(str(tmp_path / "jax"), params, cfg)
    tp, tc = tckpt.load_llm_model(str(tmp_path / "jax"), device="cpu", dtype=torch.float32)
    assert dataclasses.asdict(tc) == dataclasses.asdict(cfg)
    assert_same_leaves(params, tp)
    tckpt.save_llm_model(str(tmp_path / "torch"), tp, tc)
    back, bc = jckpt.load_llm_model(str(tmp_path / "torch"), dtype=jnp.float32)
    assert bc == cfg
    assert_same_leaves(back, tp)
    carried = tckpt.llm_params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    assert_same_leaves(params, carried)


def jax_ppl(params, cfg, ids, seq_len=32):
    """Perplexity of the JAX forward (bf16, as ``evaluate_perplexity``) over
    ``seq_len`` windows. The JAX ``evaluate_perplexity`` hands ``llama_forward``
    a neuron mask of ones, which the MoE guard refuses (tested below), so the
    windows go through the forward directly."""
    ids = np.asarray(ids).reshape(-1)
    total, count = 0.0, 0
    for i in range(ids.size // seq_len):
        tok = jnp.asarray(ids[i * seq_len:(i + 1) * seq_len][None], jnp.int32)
        logits, _ = jmodel.llama_forward(params, tok, cfg)
        logp = jax.nn.log_softmax(logits[:, :-1].astype(jnp.float32), axis=-1)
        nll = -jnp.take_along_axis(logp, tok[:, 1:, None], axis=-1)
        total, count = total + float(nll.sum()), count + nll.size
    return float(np.exp(total / count))


def test_main_llm_on_a_mixtral_directory_matches_jax(tmp_path):
    d = exported(tmp_path, "mixtral")
    jp, jc = jckpt.load_hf_llama(d, dtype=jnp.float32)

    def parse(*flags):
        return tcli.build_argparser().parse_args(["--model", d, *CLI, *flags])

    args = parse("--dense", "--evaluate_perplexity")
    out = tcli.run(args)
    wik, _, _, c4t = tcli.load_corpora(args, jc)
    assert out["dense"]["ppl"] == pytest.approx(jax_ppl(jp, jc, wik), rel=2e-2)
    with pytest.raises(ValueError, match="dense MLPs"):   # the accepted difference
        jeval.evaluate_perplexity(jp, jc, wik, seq_len=32, enable_tqdm=False)
    out = tcli.run(parse("--dense", "--evaluate_perplexity", "--quantize", "int4"))
    assert out["dense"]["ppl"] == pytest.approx(
        jax_ppl(jquant.quantize_llm_params_int4(jp, jc), jc, wik), rel=2e-2)
    out = tcli.run(parse("--pruning_method", "shortgpt", "--sparsity_rate", "0.5",
                         "--evaluate_perplexity"))
    calib = jdata.get_calibration(c4t, 3, seq_len=32)
    mask = jprune.shortgpt(jp, jc, 1, calib)   # one whole block of two
    (entry,) = out["runs"]
    assert entry["attn_mask"] == entry["mlp_mask"] == list(mask)
    for pkg in (tmodel, jmodel):   # 2SSP's stage 1 needs dense MLPs, in both packages
        with pytest.raises(ValueError, match="dense MLPs"):
            if pkg is tmodel:
                tcli.run(parse("--pruning_method", "2ssp", "--sparsity_rate", "0.4"))
            else:
                jprune.two_stage_2ssp(jp, jc, calib[:2], 0.4, seq_len=32)


def test_serve_http_engine_over_a_qwen3_moe_directory(tmp_path):
    d = exported(tmp_path, "qwen3_moe")
    args = tserve_cli.build_argparser().parse_args(
        ["--model", d, "--backend", "cpu", "--kv-dtype", "fp32", "--max-batch", "2",
         "--num-pages", "32", "--page-size", "4", "--max-context", "64"])
    engine, _ = tserve_cli.build_engine(args)
    params, cfg = tckpt.load_hf_llama(d, device="cpu", dtype=torch.bfloat16)
    prompts = [[3, 5, 7, 9], [2, 4]]
    with engine:
        handles = [engine.submit(p, max_new_tokens=6) for p in prompts]
        served = [h.result(timeout=120) for h in handles]
    for p, s in zip(prompts, served):
        ref = generate_kv_scan(engine._server.params, cfg, p, max_length=len(p) + 6,
                               cache_dtype=torch.float32)
        assert list(s) == ref[len(p):].tolist()


def test_train_llm_on_moe_models(tmp_path):
    d = exported(tmp_path, "mixtral")
    run = ["--backend", "cpu", "--steps", "2", "--batch-size", "2", "--seq-len", "16",
           "--log-every", "1", "--synthetic-data", "--compute-dtype", "float32"]
    out = ttrain_cli.run(ttrain_cli.build_argparser().parse_args(
        ["--model", d, *run, "--save-model", str(tmp_path / "trained")]))
    assert [h["update"] for h in out["history"]] == [1, 2]
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    back, cfg = tckpt.load_llm_model(str(tmp_path / "trained"), device="cpu")
    assert cfg.num_experts == 4 and back["blocks"]["gate_kernel"].shape == (2, 4, 32, 24)
    fresh = {k: v for k, v in BASE.items()}
    out = ttrain_cli.run(ttrain_cli.build_argparser().parse_args(
        ["--init-json", json.dumps(fresh), *run]))
    assert out["cfg"] == tmodel.LlamaConfig(**fresh)
    assert out["params"]["blocks"]["router"].dtype == torch.bfloat16
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    out = ttrain_cli.run(ttrain_cli.build_argparser().parse_args(
        ["--model", d, "--teacher", d, *run]))
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    assert out["params"]["blocks"]["router"].shape == (2, 32, 4)
    # quantized expert stacks stay as they are: a quantized tree cannot train
    q = tquant.quantize_llm_params_int8(out["params"], out["cfg"])
    assert q["blocks"]["gate_kernel_q"].dtype == torch.int8
