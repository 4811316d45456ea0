"""The port's LLM CLI on the tiny DeepSeek models, on the CPU against the JAX
package's functions with the same weights (the port's tiny model carried to
JAX) and the same token streams.

DeepSeek perplexities run in fp32 in both packages (JAX's
``_window_nll_deepseek*``), so they agree within rtol 1e-5: dense, after each
depth method (the same masks as JAX's ``shortgpt`` / ``window_based`` /
``blockpruner``) and after 2SSP on the all-dense variant (see its test for
the bf16 statistics); int8 / int4 quantized runs evaluate the quantizer's
tree, which ``tests/test_torch_deepseek_io.py`` holds to JAX's. EvoPress
runs its bf16 fitness forwards in fp32 in both packages for the comparison
(the same masks).
``--save-model`` writes both formats, read back by the JAX loaders; the JAX
CLI's refusals (SliceGPT, 2SSP on a MoE config, the ablation suite) keep its
message.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssp_x_vit_tpu.llm import datasets as jdata
from ssp_x_vit_tpu.llm import deepseek as J
from ssp_x_vit_tpu.llm import evaluation as jeval
from ssp_x_vit_tpu.llm import pruning as jprune
from ssp_x_vit_tpu_torch.cli import main_llm as tcli
from ssp_x_vit_tpu_torch.models.checkpoints import to_numpy

RTOL = 1e-5
BASE = ["--backend", "cpu", "--synthetic-data", "--seq-len", "32", "--num-calibration", "3",
        "--num-calibration-2ssp", "2", "--logging", "WARNING"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's tiny tensors: the suite runs six
    workers on the host's cores, where a pool per worker only contends."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def parse(model, *flags):
    return tcli.build_argparser().parse_args(["--model", model, *BASE, *flags])


_MODELS = {}


def shared(model):
    """(port params, port cfg, JAX params, JAX cfg, wikitext, calibration) of
    the port's tiny model (seed 0), built once per model name."""
    if model not in _MODELS:
        args = parse(model)
        tp, tcfg = tcli.load_model(args, torch.device("cpu"))
        jcfg = J.DeepseekConfig(**{k: getattr(tcfg, k) for k in tcfg.__dataclass_fields__})
        jp = jax.tree.map(lambda t: jnp.asarray(to_numpy(t)), tp)
        wik, _, _, c4t = tcli.load_corpora(args, tcfg)
        calib = jdata.get_calibration(c4t, args.num_calibration, seq_len=args.seq_len)
        _MODELS[model] = (tp, tcfg, jp, jcfg, wik, calib)
    return _MODELS[model]


def jppl(jp, jcfg, wik, **gates):
    return jeval.evaluate_perplexity(jp, jcfg, wik, seq_len=32, enable_tqdm=False, **gates)


def test_dense_and_depth_methods_match_jax():
    tp, tcfg, jp, jcfg, wik, calib = shared("tiny-random-deepseek")
    out = tcli.run(parse("tiny-random-deepseek", "--dense", "--evaluate_perplexity"),
                   model=(tp, tcfg))
    assert out["model_type"] == "deepseek_v3"
    assert out["dense"]["ppl"] == pytest.approx(jppl(jp, jcfg, wik), rel=RTOL)
    refs = {"shortgpt": lambda: [jprune.shortgpt(jp, jcfg, 1, calib)] * 2,
            "window_based": lambda: [jprune.window_based(jp, jcfg, 1, calib)] * 2,
            "blockpruner": lambda: jprune.blockpruner(jp, jcfg, 1, calib[0], seq_len=32)}
    for method, ref in refs.items():
        out = tcli.run(parse("tiny-random-deepseek", "--pruning_method", method,
                             "--sparsity_rate", "0.25", "--evaluate_perplexity"),
                       model=(tp, tcfg))
        (entry,) = out["runs"]
        am, mm = ref()
        assert entry["attn_mask"] == list(am) and entry["mlp_mask"] == list(mm), method
        ga, gm = 1.0 - np.asarray(am, np.float32), 1.0 - np.asarray(mm, np.float32)
        assert entry["ppl"] == pytest.approx(jppl(jp, jcfg, wik, attn_gate=ga, mlp_gate=gm),
                                             rel=RTOL), method


def test_evopress_search_matches_jax_in_fp32(monkeypatch):
    """EvoPress on the MoE model with a small search (the CLI's defaults ask for
    64 distinct initial candidates, more than 4 layers hold: the JAX loop and
    the port's wait forever alike). Both packages' forwards in fp32 (JAX's
    module global ``deepseek_forward`` swapped for the duration): the same
    masks, for dropped submodules and whole blocks."""
    import functools

    from ssp_x_vit_tpu.llm import evopress as jevo
    from ssp_x_vit_tpu_torch.llm import evopress as tevo

    tp, tcfg, jp, jcfg, wik, calib = shared("tiny-random-deepseek")
    args = dict(initially_generated=4, offspring=3, initial_tokens=32,
                tokens_per_selection=(32, 96))
    monkeypatch.setattr(J, "deepseek_forward",
                        functools.partial(J.deepseek_forward, compute_dtype=jnp.float32))
    jevo._logits.clear_cache()
    jevo._kl_sum.clear_cache()
    for drop in (False, True):
        ref = jevo.evopress(jp, jcfg, 1, calib, args=args, seed=3, num_generations=2,
                            drop_entire_block=drop, verbose=False)
        got = tevo.evopress(tp, tcfg, 1, calib, args=args, seed=3, num_generations=2,
                            drop_entire_block=drop, verbose=False, compute_dtype=torch.float32)
        assert got == ref, drop
    jevo._logits.clear_cache()
    jevo._kl_sum.clear_cache()


def test_2ssp_on_the_dense_variant_matches_jax(tmp_path, monkeypatch):
    """2SSP's stage-1 statistics run in bf16 in both CLIs, where the frameworks
    round at other places and near-tied neurons may swap: the CLI run keeps
    JAX's pruned blocks and width, its perplexity is the JAX evaluation of the
    model it saved (rtol 1e-5) and within 2e-2 of JAX's run. With the
    statistics in fp32 in both (JAX's ``deepseek_forward`` swapped for the
    duration) the whole run is JAX's: the same kept neurons, blocks and
    perplexity within rtol 1e-5."""
    import functools

    from ssp_x_vit_tpu_torch.llm import pruning as tprune

    tp, tcfg, jp, jcfg, wik, calib = shared("tiny-random-deepseek-dense")
    out = tcli.run(parse("tiny-random-deepseek-dense", "--pruning_method", "2ssp",
                         "--sparsity_rate", "0.25", "--evaluate_perplexity",
                         "--save-model", str(tmp_path / "native")), model=(tp, tcfg))
    (entry,) = out["runs"]
    rp, rcfg, rinfo = jprune.two_stage_2ssp(jp, jcfg, calib[:2], 0.25, seq_len=32)
    assert entry["pruned_attention_blocks"] == rinfo["pruned_attention_blocks"]
    assert entry["num_preserve_mlp"] == rinfo["num_preserve_mlp"]
    assert abs(entry["achieved_sparsity"] - 0.25) < 0.02
    assert entry["ppl"] == pytest.approx(jppl(rp, rcfg, wik), rel=2e-2)
    sp, sc = J.load_deepseek_model(str(tmp_path / "native"), dtype=jnp.float32)
    assert sc == rcfg
    assert entry["ppl"] == pytest.approx(jppl(sp, sc, wik), rel=RTOL)

    monkeypatch.setattr(J, "deepseek_forward",
                        functools.partial(J.deepseek_forward, compute_dtype=jnp.float32))
    jprune._mlp_stats_batch.clear_cache()
    rp, rcfg, rinfo = jprune.two_stage_2ssp(jp, jcfg, calib[:2], 0.25, seq_len=32)
    jprune._mlp_stats_batch.clear_cache()
    gp, gcfg, ginfo = tprune.two_stage_2ssp(tp, tcfg, calib[:2], 0.25, seq_len=32,
                                            compute_dtype=torch.float32)
    assert ginfo["pruned_attention_blocks"] == rinfo["pruned_attention_blocks"]
    assert gcfg.effective_intermediate == rcfg.effective_intermediate
    np.testing.assert_array_equal(gp["dense_blocks"]["down_kernel"].numpy(),
                                  np.asarray(rp["dense_blocks"]["down_kernel"]))
    monkeypatch.undo()
    assert jppl(rp, rcfg, wik) == pytest.approx(
        tcli.run(parse("tiny-random-deepseek-dense", "--dense", "--evaluate_perplexity"),
                 model=(gp, gcfg))["dense"]["ppl"], rel=RTOL)


@pytest.mark.parametrize("quantize", ["int8", "int4"])
def test_quantized_dense_matches_jax(quantize, tmp_path):
    """The CLI evaluates the port's DeepSeek quantizer's tree (bit for bit
    JAX's, and its perplexity JAX's within rtol 1e-5:
    ``tests/test_torch_deepseek_io.py``) and saves the dense model."""
    from ssp_x_vit_tpu_torch.llm import evaluation as teval
    from ssp_x_vit_tpu_torch.llm import quant as tquant

    tp, tcfg, jp, jcfg, wik, _ = shared("tiny-random-deepseek")
    out = tcli.run(parse("tiny-random-deepseek", "--dense", "--evaluate_perplexity",
                         "--quantize", quantize, "--save-model", str(tmp_path / "hf"),
                         "--save-format", "hf"), model=(tp, tcfg))
    q = (tquant.quantize_deepseek_params_int8 if quantize == "int8"
         else tquant.quantize_deepseek_params_int4)
    assert out["dense"]["ppl"] == teval.evaluate_perplexity(q(tp, tcfg), tcfg, wik, seq_len=32)
    assert out["kernel_launches"]["evaluation"]["quant4_matmul"] == 0   # the CPU: plain
    # the artifact is the dense model, as the JAX CLI saves it
    hp, hc = J.load_hf_deepseek(str(tmp_path / "hf"))
    assert hc == jcfg
    np.testing.assert_array_equal(np.asarray(hp["moe_blocks"]["gate_kernel"]),
                                  np.asarray(jp["moe_blocks"]["gate_kernel"]))


def test_refusals_keep_the_jax_message():
    tp, tcfg = shared("tiny-random-deepseek")[:2]
    dense = shared("tiny-random-deepseek-dense")[:2]
    for model, flags, what in (
            ((tp, tcfg), ["--pruning_method", "slicegpt", "--sparsity_rate", "0.25"],
             "--pruning_method slicegpt"),
            (dense, ["--pruning_method", "slicegpt", "--sparsity_rate", "0.25"],
             "--pruning_method slicegpt"),
            ((tp, tcfg), ["--pruning_method", "2ssp", "--sparsity_rate", "0.25"],
             "2ssp on a MoE deepseek"),
            ((tp, tcfg), ["--ablation"], "'--ablation'")):
        with pytest.raises(SystemExit, match="unsupported for deepseek models") as e:
            tcli.run(parse("tiny-random-deepseek", *flags), model=model)
        assert what in str(e.value)
