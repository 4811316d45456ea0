"""The port's LLM CLI (``ssp_x_vit_tpu_torch.cli.main_llm``) on the CPU against
the functions of the repository's ``main_llm.py``.

The tiny-random model is built by ``main_llm.load_model`` (JAX) and handed to
the port's ``run(args, model=...)``, so both CLIs see the same weights; the
token streams are bit-identical. Perplexities at the bf16 default agree to
rtol 2e-2. On random weights the candidates of the greedy search lie closer
together than that, so the pruned model itself is compared by saving it from
the port and evaluating the saved files with the JAX package.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import main_llm as jcli
from ssp_x_vit_tpu.llm import checkpoints as jckpt
from ssp_x_vit_tpu.llm import datasets as jdata
from ssp_x_vit_tpu.llm import evaluation as jeval
from ssp_x_vit_tpu.llm import pruning as jprune
from ssp_x_vit_tpu.llm import quant as jquant
from ssp_x_vit_tpu_torch.cli import main_llm as tcli
from ssp_x_vit_tpu_torch.llm import checkpoints as tckpt
from ssp_x_vit_tpu_torch.llm import model as tmodel

TOL = 2e-2
BASE = ["--backend", "cpu", "--synthetic-data", "--seq-len", "128", "--num-calibration", "6",
        "--num-calibration-2ssp", "3", "--logging", "WARNING"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's tiny tensors: the suite runs six
    workers on the host's cores, where a pool per worker only contends."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def parse(*flags, model="tiny-random"):
    return tcli.build_argparser().parse_args(["--model", model, *BASE, *flags])


def shared_model(args):
    """The model main_llm.py builds for these flags, in both frameworks."""
    jparams, jcfg = jcli.load_model(args)
    tree = jax.tree.map(np.asarray, jparams)
    tcfg = tmodel.LlamaConfig(**dataclasses.asdict(jcfg))
    return jparams, jcfg, tckpt.llm_params_from_jax(tree, device="cpu"), tcfg


def test_flags_defaults_and_tiny_models_match_main_llm(monkeypatch):
    monkeypatch.setattr("sys.argv", ["main_llm.py", "--model", "tiny-random"])
    jargs = vars(jcli.parse_args())
    targs = vars(tcli.build_argparser().parse_args(["--model", "tiny-random"]))
    assert set(targs) == set(jargs)
    assert {k for k in jargs if jargs[k] != targs[k]} == {"backend"}
    assert tcli.TINY_RANDOM == jcli.TINY_RANDOM
    for name in tcli._TINY_VARIANTS:
        args = parse(model=name)
        _, jcfg = jcli.load_model(args)
        tparams, tcfg = tcli.load_model(args, torch.device("cpu"))
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg), name
        assert tparams["embed"].dtype == torch.float32
    jstreams = jcli.load_corpora(args, jcfg)
    tstreams = tcli.load_corpora(args, tcfg)
    for a, b in zip(tstreams, jstreams):
        np.testing.assert_array_equal(a, b)


def test_run_2ssp_matches_main_llm_functions(tmp_path):
    args = parse("--pruning_method", "2ssp", "--sparsity_rate", "0.375", "--dense",
                 "--evaluate_perplexity", "--save-model", str(tmp_path / "out"))
    jparams, jcfg, tparams, tcfg = shared_model(args)
    out = tcli.run(args, model=(tparams, tcfg))

    wik, _, _, c4t = jcli.load_corpora(args, jcfg)
    calib = jdata.get_calibration(c4t, args.num_calibration, seq_len=args.seq_len)
    dense = jeval.evaluate_perplexity(jparams, jcfg, wik, seq_len=args.seq_len, enable_tqdm=False)
    assert out["dense"]["ppl"] == pytest.approx(dense, rel=TOL)
    _, rcfg, rinfo = jprune.two_stage_2ssp(jparams, jcfg, calib[:args.num_calibration_2ssp], 0.375,
                                           seq_len=args.seq_len)
    (entry,) = out["runs"]
    assert entry["num_preserve_mlp"] == rinfo["num_preserve_mlp"]
    assert len(entry["pruned_attention_blocks"]) == rinfo["num_attn_pruned"]
    main_before = jprune.count_main_params(jcfg)[0]
    assert entry["achieved_sparsity"] == pytest.approx(
        1.0 - jprune.count_main_params(rcfg)[0] / main_before, abs=1e-12)
    assert abs(entry["achieved_sparsity"] - 0.375) < 0.02

    # the dense and the pruned model as saved by the port, evaluated by the JAX package
    sp, sc = jckpt.load_llm_model(str(tmp_path / "out"), dtype=jnp.float32)
    assert sc.pruned_attention_blocks == tuple(entry["pruned_attention_blocks"])
    assert sc.pruned_intermediate_size == entry["num_preserve_mlp"]
    saved = jeval.evaluate_perplexity(sp, sc, wik, seq_len=args.seq_len, enable_tqdm=False)
    assert entry["ppl"] == pytest.approx(saved, rel=TOL)

    for phase in ("setup", "stats", "stage1", "candidates", "materialize", "evaluation"):
        assert out["phase_seconds"][phase] >= 0.0
    # on the CPU every wrapper takes its plain version: no kernel launch is counted
    assert all(n == 0 for counts in out["kernel_launches"].values() for n in counts.values())


@pytest.mark.parametrize("quantize", ["int4", "int8"])
def test_run_quantized_dense_matches_main_llm_functions(quantize):
    args = parse("--dense", "--evaluate_perplexity", "--quantize", quantize)
    jparams, jcfg, tparams, tcfg = shared_model(args)
    out = tcli.run(args, model=(tparams, tcfg))
    wik = jcli.load_corpora(args, jcfg)[0]
    q = jquant.quantize_llm_params_int4 if quantize == "int4" else jquant.quantize_llm_params_int8
    ref = jeval.evaluate_perplexity(q(jparams, jcfg), jcfg, wik, seq_len=args.seq_len,
                                    enable_tqdm=False)
    assert out["dense"]["ppl"] == pytest.approx(ref, rel=TOL)
    assert out["quantize"] == quantize and out["runs"] == []


def test_run_w8a8_and_sweep_and_depth_baselines(tmp_path):
    from ssp_x_vit_tpu_torch.ops import dispatch

    out = tcli.run(parse("--dense", "--evaluate_perplexity", "--quantize", "int8", "--w8a8"))
    assert np.isfinite(out["dense"]["ppl"]) and not dispatch.use_w8a8()
    sweep = tcli.run(parse("--pruning_method", "2ssp", "--sparsity_rate", "-2",
                           "--evaluate_perplexity", "--save-model", str(tmp_path / "sweep")))
    assert [r["target_sparsity"] for r in sweep["runs"]] == [0.25, 0.375, 0.5]
    for r in sweep["runs"]:
        assert abs(r["achieved_sparsity"] - r["target_sparsity"]) < 0.02 and np.isfinite(r["ppl"])
        cfg = tckpt.load_llm_model(r["saved"], device="cpu")[1]
        assert cfg.pruned_intermediate_size == r["num_preserve_mlp"]
    for method in ("window_based", "shortgpt", "blockpruner"):
        res = tcli.run(parse("--pruning_method", method, "--sparsity_rate", "0.3",
                             "--evaluate_perplexity", "--main_table_results",
                             "--evaluate_inference", "--save-model", str(tmp_path / method)))
        (entry,) = res["runs"]
        assert entry["target_sparsity"] == pytest.approx(2 / 6)  # rounded up to whole blocks
        assert sum(entry["attn_mask"]) == 2 and np.isfinite(entry["ppl"])
        assert set(entry["main_table"]) == {"wikitext2", "c4", "fineweb-edu"}
        assert entry["inference_ms"] > 0.0
        if method != "blockpruner" or entry["attn_mask"] == entry["mlp_mask"]:
            assert tckpt.load_llm_model(entry["saved"], device="cpu")[1].num_layers == 4


def test_main_parses_argv_and_runs_a_native_directory(tmp_path):
    tparams, tcfg = tcli.load_model(parse(), torch.device("cpu"))
    tckpt.save_llm_model(str(tmp_path / "m"), tparams, tcfg)
    out = tcli.main(["--model", str(tmp_path / "m"), *BASE, "--dense", "--evaluate_perplexity"])
    ref = tcli.run(parse("--dense", "--evaluate_perplexity"), model=(tparams, tcfg))
    # the directory loads in bf16 (load_llm_model's default, as in the JAX package)
    assert out["dense"]["ppl"] == pytest.approx(ref["dense"]["ppl"], rel=TOL)
    # an HF directory (no model.npz) loads through load_hf_llama, also in bf16
    tckpt.export_hf_llama(str(tmp_path / "hf"), tparams, tcfg)
    out_hf = tcli.run(parse("--dense", "--evaluate_perplexity", model=str(tmp_path / "hf")))
    assert out_hf["dense"]["ppl"] == out["dense"]["ppl"]
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        tcli.run(parse(model=str(tmp_path / "empty")))
    with pytest.raises(SystemExit):
        tcli.run(parse(model="no-such-model"))
