"""Local corpora through the port's CLIs against the JAX package on the CPU.

- ``main_llm``'s ``load_corpora`` in a working directory with
  ``./data/{wikitext2,c4_val,fineweb_edu,c4_train}`` (``datasets.save_to_disk``
  directories of documents cut at blank lines from text decoded out of
  ``ckpts/code_llm_small/corpus_slice``), on a model directory that holds
  ``code_llm_small``'s byte-level ``tokenizer.json``: the four id streams of
  the port and of the repository's ``main_llm.py`` are equal; the fallbacks
  to the synthetic streams agree too.
- One tiny ``main_llm --local_datasets --backend cpu`` 2SSP run against the JAX
  package's functions on the same weights: the CLI's bf16 perplexity within
  rtol 2e-2 (``tests/test_torch_llm_cli.py``'s tolerance), the same kept FFN
  width and pruned attention blocks.
- ``train_llm --data <dir>``: the port's ``_token_batches`` against the JAX
  CLI's, which tokenizes with ``transformers.AutoTokenizer`` (the directory
  holds ``tokenizer.json`` and a ``tokenizer_config.json`` naming
  ``PreTrainedTokenizerFast``; the port reads the same ``tokenizer.json``
  with its own byte-level BPE): the same ids, microbatches and eval stream.

``datasets.load_dataset`` (the hub, which the JAX loaders reach for without a
local directory) is replaced by a function that raises ``ConnectionError``.
"""

import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

datasets = pytest.importorskip("datasets")

import main_llm as jcli  # noqa: E402
from ssp_x_vit_tpu.cli import train_llm as jtrain  # noqa: E402
from ssp_x_vit_tpu.llm import datasets as jdata  # noqa: E402
from ssp_x_vit_tpu.llm import evaluation as jeval  # noqa: E402
from ssp_x_vit_tpu.llm import model as jmodel  # noqa: E402
from ssp_x_vit_tpu.llm import pruning as jprune  # noqa: E402
from ssp_x_vit_tpu_torch.cli import main_llm as tcli  # noqa: E402
from ssp_x_vit_tpu_torch.cli import train_llm as ttrain  # noqa: E402
from ssp_x_vit_tpu_torch.llm import checkpoints as tckpt  # noqa: E402
from ssp_x_vit_tpu_torch.llm import model as tmodel  # noqa: E402
from ssp_x_vit_tpu_torch.llm.tokenizer import load_tokenizer  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "ckpts", "code_llm_small")
TOKENIZER = os.path.join(CKPT, "tokenizer.json")
TINY = dict(jcli.TINY_RANDOM, vocab_size=8192)
TOL = 2e-2
CORPORA = {"wikitext2": ("val", 0), "c4_val": ("val", 3000), "fineweb_edu": ("val", 6000),
           "c4_train": ("train", 0)}
BASE = ["--backend", "cpu", "--seq-len", "128", "--num-calibration", "6",
        "--num-calibration-2ssp", "3", "--logging", "WARNING"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's tiny tensors: the suite runs six
    workers on the host's cores, where a pool per worker only contends."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def offline(monkeypatch):
    def no_hub(*args, **kwargs):
        raise ConnectionError("no network in tests")

    monkeypatch.setattr(datasets, "load_dataset", no_hub)
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")


def documents(split: str, start: int, n: int = 3000):
    """Text decoded from ``n`` committed ids of ``corpus_slice/<split>.bin``,
    cut into documents at blank lines."""
    ids = np.fromfile(os.path.join(CKPT, "corpus_slice", f"{split}.bin"), np.uint16)
    text = load_tokenizer(CKPT).decode(ids[start:start + n].tolist())
    return [d for d in text.split("\n\n") if d.strip()]


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """A working directory with ./data/<corpus> and a model directory holding
    the tokenizer and a tiny config."""
    root = tmp_path_factory.mktemp("work")
    for name, (split, start) in CORPORA.items():
        datasets.Dataset.from_dict({"text": documents(split, start)}).save_to_disk(
            str(root / "data" / name))
    model = root / "model"
    model.mkdir()
    shutil.copy(TOKENIZER, model)
    (model / "config.json").write_text(json.dumps(TINY))
    return root


def parse(model, *flags):
    return tcli.build_argparser().parse_args(["--model", str(model), *BASE, *flags])


def test_load_corpora_matches_main_llm(work, monkeypatch):
    monkeypatch.chdir(work)
    jcfg, tcfg = jmodel.LlamaConfig(**TINY), tmodel.LlamaConfig(**TINY)
    args = parse(work / "model", "--local_datasets")
    report = {}
    got = tcli.load_corpora(args, tcfg, report)
    want = jcli.load_corpora(args, jcfg)
    assert report["corpora"] == "local"
    for g, w in zip(got, want):
        assert g.dtype == np.int32 and g.shape[0] == 1 and g.shape[1] > 768
        np.testing.assert_array_equal(g, w)
    assert not np.array_equal(got[0], jdata.synthetic_token_stream(got[0].shape[1], 8192, 1))
    # without --local_datasets nothing is read (the JAX loaders' hub fails offline),
    # with --synthetic-data nothing is tried: both take the synthetic streams
    for flags in ((), ("--local_datasets", "--synthetic-data")):
        args = parse(work / "model", *flags)
        report = {}
        got = tcli.load_corpora(args, tcfg, report)
        assert report["corpora"] == "synthetic"
        for g, w in zip(got, jcli.load_corpora(args, jcfg)):
            np.testing.assert_array_equal(g, w)


def test_a_corpus_with_a_null_or_missing_falls_back_in_both(work, tmp_path, monkeypatch):
    """One corpus with a null row (the join fails) or missing: all four fall
    back to the synthetic streams in both CLIs."""
    for case in ("null", "missing"):
        shutil.copytree(work / "data", tmp_path / case / "data")
        c4t = tmp_path / case / "data" / "c4_train"
        shutil.rmtree(c4t)
        if case == "null":
            datasets.Dataset.from_dict({"text": ["a", None]}).save_to_disk(str(c4t))
        monkeypatch.chdir(tmp_path / case)
        args = parse(work / "model", "--local_datasets")
        report = {}
        got = tcli.load_corpora(args, tmodel.LlamaConfig(**TINY), report)
        assert report["corpora"] == "synthetic"
        for g, w in zip(got, jcli.load_corpora(args, jmodel.LlamaConfig(**TINY))):
            np.testing.assert_array_equal(g, w)


def test_local_datasets_2ssp_run_matches_main_llm_functions(work, monkeypatch):
    monkeypatch.chdir(work)
    args = parse(work / "model", "--local_datasets", "--pruning_method", "2ssp",
                 "--sparsity_rate", "0.375", "--dense", "--evaluate_perplexity")
    jcfg = jmodel.LlamaConfig(**TINY)
    jparams = jmodel.init_llama_params(jax.random.PRNGKey(3), jcfg, dtype=jnp.float32)
    tparams = tckpt.llm_params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    tcfg = tmodel.LlamaConfig(**dataclasses.asdict(jcfg))
    out = tcli.run(args, model=(tparams, tcfg))
    assert out["corpora"] == "local"

    wik, _, _, c4t = jcli.load_corpora(args, jcfg)
    calib = jdata.get_calibration(c4t, args.num_calibration, seq_len=args.seq_len)
    assert len(calib) == args.num_calibration
    dense = jeval.evaluate_perplexity(jparams, jcfg, wik, seq_len=args.seq_len, enable_tqdm=False)
    assert out["dense"]["ppl"] == pytest.approx(dense, rel=TOL)
    _, rcfg, rinfo = jprune.two_stage_2ssp(jparams, jcfg, calib[:args.num_calibration_2ssp],
                                           0.375, seq_len=args.seq_len)
    (entry,) = out["runs"]
    assert entry["num_preserve_mlp"] == rinfo["num_preserve_mlp"]
    assert sorted(entry["pruned_attention_blocks"]) == sorted(rcfg.pruned_attention_blocks)
    assert abs(entry["achieved_sparsity"] - 0.375) < 0.02 and np.isfinite(entry["ppl"])


def _train_args(module, data, *flags):
    argv = ["--data", str(data), "--steps", "3", "--batch-size", "2", "--seq-len", "64",
            "--eval-every", "1", *flags]
    if module is ttrain:
        argv = ["--backend", "cpu", *argv]
    return module.build_argparser().parse_args(argv)


def test_train_llm_data_matches_the_jax_cli(tmp_path, caplog):
    """``--data`` on a corpus directory with the tokenizer beside it: the port's
    microbatches and eval stream are the JAX CLI's (AutoTokenizer); a run
    trains on them; a directory without a corpus falls back in both; a corpus
    whose tokenizer.json is not byte-level BPE (a Metaspace pre-tokenizer over
    the byte-level vocabulary) cuts the JAX CLI's microbatches too."""
    data = tmp_path / "corpus"
    datasets.Dataset.from_dict({"text": documents("train", 0, 4000)}).save_to_disk(str(data))
    shutil.copy(TOKENIZER, data)
    (data / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "PreTrainedTokenizerFast"}))
    cfg = tmodel.LlamaConfig(**TINY)
    tb, ts = ttrain._token_batches(_train_args(ttrain, data), cfg)
    jb, js = jtrain._token_batches(_train_args(jtrain, data), jmodel.LlamaConfig(**TINY))
    np.testing.assert_array_equal(np.stack(tb), np.asarray(jb))
    np.testing.assert_array_equal(ts, np.asarray(js).reshape(-1))
    assert len(tb) == 3 and ts.size > 3000
    want = load_tokenizer(str(data))("\n\n".join(documents("train", 0, 4000)))["input_ids"]
    np.testing.assert_array_equal(tb[0].reshape(-1), np.asarray(want[:2 * 65]))

    out = ttrain.run(_train_args(ttrain, data, "--init-json", json.dumps(TINY), "--log-every",
                                 "1"))
    losses = [h["loss"] for h in out["history"] if "loss" in h]
    assert len(losses) == 3 and all(np.isfinite(losses))

    empty = tmp_path / "empty"
    empty.mkdir()
    shutil.copy(TOKENIZER, empty)
    with caplog.at_level("WARNING"):
        tb, ts = ttrain._token_batches(_train_args(ttrain, empty), cfg)
    assert "synthetic fallback" in caplog.text
    jb, js = jtrain._token_batches(_train_args(jtrain, empty), jmodel.LlamaConfig(**TINY))
    np.testing.assert_array_equal(np.stack(tb), np.asarray(jb))

    sentencepiece = tmp_path / "sp"
    shutil.copytree(data, sentencepiece)
    spec = json.loads((data / "tokenizer.json").read_text())
    spec["pre_tokenizer"] = {"type": "Metaspace", "replacement": "▁"}
    (sentencepiece / "tokenizer.json").write_text(json.dumps(spec))
    tb, ts = ttrain._token_batches(_train_args(ttrain, sentencepiece), cfg)
    jb, js = jtrain._token_batches(_train_args(jtrain, sentencepiece),
                                   jmodel.LlamaConfig(**TINY))
    np.testing.assert_array_equal(np.stack(tb), np.asarray(jb))
    np.testing.assert_array_equal(ts, np.asarray(js).reshape(-1))
    assert ts.size > 3000
