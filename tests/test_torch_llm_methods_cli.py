"""The port's LLM CLI (``ssp_x_vit_tpu_torch.cli.main_llm``) with SliceGPT,
EvoPress, the ablation suite and an offline task pack, on the CPU against the
JAX package's functions, as ``tests/test_torch_llm_cli.py`` does for 2SSP.

The tiny-random model is built by the repository's ``main_llm.load_model``
(JAX) and handed to the port's ``run(args, model=...)``; the token streams
are bit-identical. SliceGPT runs in fp32 in both packages: perplexity within
1e-6 relative. The rest runs the bf16 default, where the frameworks round at
other places (rtol 2e-2, TOL); on random weights the EvoPress candidates lie
closer together than that, so the CLI's EvoPress search is held to its own
records (``tests/test_torch_evopress.py`` holds the search to JAX's in fp32)
and the gated perplexity of its masks to JAX's ``evaluate_perplexity``; the
ablation rows that run 2SSP are held to the JAX functions' perplexities, the
others to the attention budgets JAX's accounting allows; the task pack's
scores to the port's fp32 scores within TOL and its accuracy to JAX's where
no example's top two choices lie within TOL of each other.
"""

import dataclasses
import glob
import os

import jax
import numpy as np
import pytest
import torch

import main_llm as jcli
from ssp_x_vit_tpu.llm import ablations as jabl
from ssp_x_vit_tpu.llm import datasets as jdata
from ssp_x_vit_tpu.llm import evaluation as jeval
from ssp_x_vit_tpu.llm import pruning as jprune
from ssp_x_vit_tpu.llm import slicegpt as jslice
from ssp_x_vit_tpu.llm import taskpack as jpack
from ssp_x_vit_tpu_torch.cli import main_llm as tcli
from ssp_x_vit_tpu_torch.llm import checkpoints as tckpt
from ssp_x_vit_tpu_torch.llm import evopress as tevo
from ssp_x_vit_tpu_torch.llm import model as tmodel
from ssp_x_vit_tpu_torch.llm import taskpack as tpack

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-2
BASE = ["--model", "tiny-random", "--backend", "cpu", "--synthetic-data", "--seq-len", "64",
        "--num-calibration", "4", "--num-calibration-2ssp", "2", "--logging", "WARNING"]
FLAGS = {
    "slicegpt": ["--pruning_method", "slicegpt", "--sparsity_rate", "0.25", "--evaluate_perplexity",
                 "--save-model", "unused"],
    "evopress": ["--pruning_method", "evopress", "--sparsity_rate", "0.25",
                 "--evopress-generations", "1", "--evaluate_perplexity", "--num-calibration", "1",
                 "--seq-len", "32"],
    "ablation": ["--ablation", "--ablation-quick", "--num-calibration", "1", "--seq-len", "32"],
    "task-pack": ["--dense", "--evaluate_downstream", "--task-pack"],
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's tiny tensors: the suite runs six
    workers on the host's cores, where a pool per worker only contends."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bytes(s):
    return [int(b) for b in s.encode("utf-8")]


@pytest.mark.parametrize("method", list(FLAGS))
def test_run_matches_main_llm_functions(method, tmp_path):
    flags = list(FLAGS[method])
    if method == "task-pack":
        flags.append(str(tmp_path / "pack"))
        tpack.build_code_cloze_pack(
            sorted(glob.glob(os.path.join(ROOT, "ssp_x_vit_tpu_torch", "llm", "*.py"))),
            str(tmp_path / "pack"), n_examples=4)
    args = tcli.build_argparser().parse_args(BASE + flags)
    jparams, jcfg = jcli.load_model(args)
    tparams = tckpt.llm_params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    tcfg = tmodel.LlamaConfig(**dataclasses.asdict(jcfg))
    out = tcli.run(args, model=(tparams, tcfg))
    wik, _, _, c4t = jcli.load_corpora(args, jcfg)
    calib = jdata.get_calibration(c4t, args.num_calibration, seq_len=args.seq_len)
    launches = [n for counts in out["kernel_launches"].values() for n in counts.values()]
    assert not any(launches)   # on the CPU every wrapper takes its plain version

    if method == "slicegpt":
        (entry,) = out["runs"]
        sp, sc = jslice.slicegpt(jparams, jcfg, 0.25, calib)
        assert entry["new_dim"] == sc.new_dim == 48 and entry["saved"] is None
        ref = jslice.evaluate_perplexity_sliced(sp, sc, wik, seq_len=args.seq_len)
        assert entry["ppl"] == pytest.approx(ref, rel=1e-6)
        assert {"capture", "covariance", "eigh", "rotation"} <= set(out["phase_seconds"])
    elif method == "evopress":
        (entry,) = out["runs"]
        assert entry["target_sparsity"] == pytest.approx(2 / 6)   # rounded up to whole blocks
        masks = entry["attn_mask"], entry["mlp_mask"]
        assert sum(masks[0]) == sum(masks[1]) == 2
        ref = jeval.evaluate_perplexity(jparams, jcfg, wik, seq_len=args.seq_len,
                                        attn_gate=1.0 - np.asarray(masks[0], np.float32),
                                        mlp_gate=1.0 - np.asarray(masks[1], np.float32),
                                        enable_tqdm=False)
        assert entry["ppl"] == pytest.approx(ref, rel=TOL)
        records = entry["evopress"]
        assert [r.get("generation") for r in records] == [None, 0, 1, 1]
        assert records[0]["target_device"] == "cpu" and [r["candidates"] for r in records[1:]] \
            == [64, 32, 3]
        # the chosen masks' fitness, recomputed over the last selection's minibatch
        last = records[-1]
        data = [calib[i] for i in last["minibatch_ids"]]
        targets = [tevo._logits(tparams, torch.from_numpy(np.asarray(c, np.int64)), None, None,
                                tcfg, torch.bfloat16) for c in data]
        fit = tevo.compute_kl_div(tparams, tcfg, data, targets, *masks)
        assert fit == pytest.approx(last["fitnesses"][0], rel=1e-6)
        assert {"targets", "selection"} <= set(out["phase_seconds"])
    elif method == "ablation":
        rows, sl = out["ablation"], args.seq_len
        cal2 = calib[:args.num_calibration_2ssp]
        ref = jabl.ablation_calibration_dataset(jparams, jcfg, 0.5, c4t, wik, [2, 4], seq_len=sl,
                                                seeds=(0,))
        assert [r["calibration_size"] for r in rows["calibration"]] == \
            [r["calibration_size"] for r in ref]
        np.testing.assert_allclose([r["ppl"] for r in rows["calibration"]],
                                   [r["ppl"] for r in ref], rtol=TOL)
        p2, c2 = jabl.one_stage_2ssp(jparams, jcfg, cal2, 0.25)
        (stage1,) = rows["stage1"]
        assert stage1["ppl"] == pytest.approx(
            jeval.evaluate_perplexity(p2, c2, wik, seq_len=sl, enable_tqdm=False), rel=TOL)
        assert [r["rate"] for r in rows["inverted"]] == [r["rate"] for r in rows["l1"]] == [0.25]
        main, attn, mlp = jprune.count_main_params(jcfg)
        budgets = [(i / 6, n) for i in (1, 2) for n in range(6)
                   if n * attn / main <= i / 6 <= (n * attn + 6 * mlp) / main]
        assert [(r["sparsity"], r["n_attn"]) for r in rows["balancing"]] == budgets
        assert all(np.isfinite(r["ppl"]) for key in rows for r in rows[key])
        assert out["runs"] == [] and out["phase_seconds"]["ablation"] > 0.0
    else:
        ref = jpack.evaluate_task_pack(jparams, jcfg, flags[-1], _bytes)["code_cloze"]
        got = out["dense"]["downstream"]["results"]["code_cloze"]
        assert got["count"] == ref["count"] == 4
        port = tpack.evaluate_task_pack(tparams, tcfg, flags[-1], _bytes,
                                        compute_dtype=torch.float32)["code_cloze"]
        np.testing.assert_allclose(got["scores"], port["scores"], rtol=0, atol=TOL)
        top2 = np.sort(np.asarray(port["scores"]), axis=1)[:, -2:]
        if (top2[:, 1] - top2[:, 0]).min() > 2 * TOL:
            assert got["acc"] == ref["acc"]
