"""The port's training CLI (``ssp_x_vit_tpu_torch.cli.train_llm``) on the CPU.

- ``--init-json`` makes a fresh bf16 model of the given shape and trains it
  on the synthetic stream; the microbatches are the JAX CLI's, element for
  element, and ``--save-model`` writes a native model that loads back.
- ``--data-bin`` on a tiny uint16 corpus with a sibling ``val.bin``: the port
  and the JAX CLI (``ssp_x_vit_tpu.cli.train_llm``) train the same native model
  (bf16 weights, ``--compute-dtype float32``) and log the same updates: the
  first loss within 1e-5 relative (same weights, fp32 arithmetic), the later
  losses and the eval perplexity within 1e-3 relative (the two round the bf16
  parameter update at other places), the learning rates exactly.
- ``--save-format hf`` writes an HF directory that loads back to the trained
  values; a ``--data`` directory without a corpus, or a missing one, falls
  back to the synthetic stream (a corpus directory is read:
  ``tests/test_torch_local_corpora.py``).
"""

import json

import numpy as np
import pytest
import torch

from ssp_x_vit_tpu.cli import train_llm as jcli
from ssp_x_vit_tpu_torch.cli import train_llm as tcli
from ssp_x_vit_tpu_torch.llm.checkpoints import load_hf_llama, load_llm_model, save_llm_model
from ssp_x_vit_tpu_torch.llm.model import LlamaConfig, init_llama_params

TINY = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2,
            intermediate_size=48)


def _args(*argv):
    return tcli.build_argparser().parse_args(["--backend", "cpu", *argv])


def test_init_json_trains_a_fresh_bf16_model(tmp_path):
    cfg_file = tmp_path / "cfg.json"
    cfg_file.write_text(json.dumps(TINY))
    argv = ["--steps", "2", "--batch-size", "2", "--seq-len", "16", "--log-every", "1",
            "--synthetic-data", "--warmup", "1", "--seed", "3"]
    out = tcli.run(_args("--init-json", str(cfg_file), "--save-model", str(tmp_path / "m"), *argv))
    assert [h["update"] for h in out["history"]] == [1, 2]
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    assert out["params"]["embed"].dtype == torch.bfloat16
    params, cfg = load_llm_model(str(tmp_path / "m"), device="cpu")
    assert cfg == out["cfg"] == LlamaConfig(**TINY)
    assert torch.equal(params["blocks"]["q_kernel"], out["params"]["blocks"]["q_kernel"])
    # an inline JSON dict gives the same model and the same run
    again = tcli.run(_args("--init-json", json.dumps(TINY), *argv))
    assert again["history"][-1]["loss"] == out["history"][-1]["loss"]

    jargs = jcli.build_argparser().parse_args(argv)
    jbatches, jstream = jcli._token_batches(jargs, LlamaConfig(**TINY))
    tbatches, tstream = tcli._token_batches(_args(*argv), LlamaConfig(**TINY))
    assert np.array_equal(np.stack(tbatches), np.asarray(jbatches))
    assert np.array_equal(tstream, np.asarray(jstream).reshape(-1))


def test_data_bin_run_matches_the_jax_cli(tmp_path, capsys):
    rng = np.random.default_rng(7)
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    rng.integers(0, 128, size=5 * 2 * 17).astype(np.uint16).tofile(corpus / "train.bin")
    rng.integers(0, 128, size=64 * 17).astype(np.uint16).tofile(corpus / "val.bin")
    gen = torch.Generator().manual_seed(0)
    save_llm_model(str(tmp_path / "model"),
                   init_llama_params(gen, LlamaConfig(**TINY), device="cpu"), LlamaConfig(**TINY))
    argv = ["--model", str(tmp_path / "model"), "--data-bin", str(corpus / "train.bin"),
            "--steps", "3", "--batch-size", "2", "--seq-len", "16", "--log-every", "1",
            "--eval-every", "3", "--compute-dtype", "float32", "--lr", "1e-3", "--warmup", "1"]

    capsys.readouterr()
    jcli.main(argv)
    jlog = [json.loads(line.split(" ", 1)[1]) for line in capsys.readouterr().out.splitlines()
            if line.startswith("[TRAIN-LOG] ")]
    got = tcli.run(_args(*argv))["history"]
    assert [sorted(h) for h in got] == [sorted(h) for h in jlog]
    for i, (t, j) in enumerate(zip(got, jlog)):
        if "loss" in t:
            tol = 1e-5 if i == 0 else 1e-3
            assert abs(t["loss"] - j["loss"]) <= tol * j["loss"]
            assert t["lr"] == j["lr"] and t["tokens_seen"] == j["tokens_seen"]
        else:
            assert abs(t["eval_ppl"] - j["eval_ppl"]) <= 1e-3 * j["eval_ppl"]


def test_unported_flags_and_the_offline_fallback(tmp_path):
    base = ["--model", "tiny-random", "--steps", "1", "--batch-size", "1", "--seq-len", "8"]
    # --save-format hf writes the trained model as an HF directory that loads back
    out = tcli.run(_args(*base, "--save-model", str(tmp_path / "hf"), "--save-format", "hf"))
    back, cfg = load_hf_llama(str(tmp_path / "hf"), device="cpu", dtype=torch.float32)
    assert cfg == out["cfg"]
    for k, v in out["params"]["blocks"].items():
        assert torch.equal(back["blocks"][k], v.float()), k
    # a --data directory that holds no corpus (once refused naming ROADMAP.md A.10a)
    # falls back to the synthetic stream, as the JAX CLI does
    out = tcli.run(_args(*base, "--data", str(tmp_path), "--log-every", "1"))
    assert np.isfinite(out["final_loss"])
    out = tcli.run(_args(*base, "--data", str(tmp_path / "missing"), "--log-every", "1"))
    assert np.isfinite(out["final_loss"])
    with pytest.raises(SystemExit, match="--model or --init-json"):
        tcli.run(_args("--steps", "1"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcli.run(tcli.build_argparser().parse_args(base))
