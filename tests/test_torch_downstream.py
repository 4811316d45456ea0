"""Offline downstream evaluation of the PyTorch port (``llm/zeroshot.py``,
``llm/taskpack.py``, ``llm/downstream.py``) against the JAX package on the CPU.

A tiny llama (vocabulary 8192, so that both byte ids and the committed
``ckpts/code_llm_small/tokenizer.json`` fit; hidden 32, 2 layers) carried
across by ``llm_params_from_jax``. The JAX scorer runs its forwards in bf16;
for the exact comparisons ``ssp_x_vit_tpu.llm.generate.full_logits`` is
swapped, for the duration of the reference computations only, for the same
function in fp32 (the scorer's jit caches cleared before and after), and the
port runs with ``compute_dtype=torch.float32``. Tolerances: log-likelihoods
within 1e-4 absolute in fp32 (sums of a few dozen fp32 log-probabilities of
magnitude ~9) and 2e-2 of max(1, |ll|) at the bf16 default; ``is_greedy``,
accuracies and counts equal; the task-pack files byte for byte.

The JAX byte fallback is never called here with a name that is not a
directory: it would try ``transformers.AutoTokenizer`` first.
"""

import dataclasses
import glob
import logging
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssp_x_vit_tpu.llm import downstream as jdown
from ssp_x_vit_tpu.llm import generate as jgen
from ssp_x_vit_tpu.llm import model as jmodel
from ssp_x_vit_tpu.llm import taskpack as jpack
from ssp_x_vit_tpu.llm import zeroshot as jzs
from ssp_x_vit_tpu_torch.llm import checkpoints as tckpt
from ssp_x_vit_tpu_torch.llm import downstream as tdown
from ssp_x_vit_tpu_torch.llm import model as tmodel
from ssp_x_vit_tpu_torch.llm import taskpack as tpack
from ssp_x_vit_tpu_torch.llm import zeroshot as tzs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOKENIZER = os.path.join(ROOT, "ckpts", "code_llm_small", "tokenizer.json")
CFG = dict(vocab_size=8192, hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2,
           intermediate_size=64)
F32 = dict(compute_dtype=torch.float32)
SOURCES = sorted(glob.glob(os.path.join(ROOT, "ssp_x_vit_tpu_torch", "llm", "*.py")))


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


def _clear_jax_caches():
    jzs._token_logprobs.clear_cache()
    jzs._token_logprobs_and_argmax.clear_cache()


@pytest.fixture(scope="module")
def model():
    jcfg = jmodel.LlamaConfig(**CFG)
    tree = jax.tree.map(np.asarray, jmodel.init_llama_params(jax.random.PRNGKey(0), jcfg,
                                                             dtype=jnp.float32))
    return (jax.tree.map(jnp.asarray, tree), jcfg, tckpt.llm_params_from_jax(tree, device="cpu"),
            tmodel.LlamaConfig(**dataclasses.asdict(jcfg)))


@pytest.fixture(scope="module")
def pack(tmp_path_factory):
    out = tmp_path_factory.mktemp("pack")
    tpack.build_code_cloze_pack(SOURCES, str(out), n_examples=5, seed=1, context_lines=2)
    return str(out)


@pytest.fixture(scope="module")
def tok_dir(tmp_path_factory):
    """A model directory that holds only the committed tokenizer.json."""
    out = tmp_path_factory.mktemp("tok")
    shutil.copy(TOKENIZER, out / "tokenizer.json")
    return str(out)


@pytest.fixture(scope="module")
def ref(model, pack, tok_dir):
    """The JAX scorer's results, fp32 (forward swapped) and bf16 (as it is)."""
    jp, jc = model[:2]
    ctx, cont = _bytes("def main(args):\n    return "), _bytes("run(args)\n")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jgen, "full_logits",
                   lambda p, t, c, dtype, **kw: jmodel.llama_forward(
                       p, t, c, compute_dtype=jnp.float32)[0])
        _clear_jax_caches()
        out["ll"] = jzs.sequence_loglikelihood(jp, jc, ctx, cont, pad_to=64)
        out["greedy"] = jzs.sequence_loglikelihood_greedy(jp, jc, ctx, cont, pad_to=64)
        out["pack"] = jpack.evaluate_task_pack(jp, jc, pack, _bytes)
        out["downstream"] = jdown.evaluation_downstream(jp, jc, tok_dir, task_pack=pack)
        _clear_jax_caches()
    out["ll_bf16"] = jzs.sequence_loglikelihood(jp, jc, ctx, cont, pad_to=64)
    _clear_jax_caches()
    return out, ctx, cont


def test_sequence_loglikelihood_matches_jax(model, ref):
    _, _, tp, tc = model
    out, ctx, cont = ref
    assert tzs.sequence_loglikelihood(tp, tc, ctx, cont, pad_to=64, **F32) == \
        pytest.approx(out["ll"], abs=1e-4)
    ll, greedy = tzs.sequence_loglikelihood_greedy(tp, tc, ctx, cont, pad_to=64, **F32)
    assert ll == pytest.approx(out["greedy"][0], abs=1e-4) and greedy == out["greedy"][1]
    bf16 = tzs.sequence_loglikelihood(tp, tc, ctx, cont, pad_to=64)
    assert bf16 == pytest.approx(out["ll_bf16"], abs=2e-2 * max(1.0, abs(out["ll_bf16"])))
    # padding is inert, and a continuation made of the model's own argmax tokens is greedy
    assert tzs.sequence_loglikelihood(tp, tc, ctx, cont, **F32) == pytest.approx(ll, abs=1e-5)
    logits, _ = tmodel.llama_forward(tp, torch.tensor([ctx]), tc, compute_dtype=torch.float32)
    nxt = [int(logits[0, -1].argmax())]
    assert tzs.sequence_loglikelihood_greedy(tp, tc, ctx, nxt, **F32)[1]


def test_code_cloze_pack_is_byte_identical_to_jax(pack, tmp_path):
    jdir = str(tmp_path / "jax")
    jpack.build_code_cloze_pack(SOURCES, jdir, n_examples=5, seed=1, context_lines=2)
    for name in ("code_cloze.jsonl", "meta.json"):
        with open(os.path.join(pack, name), "rb") as a, open(os.path.join(jdir, name), "rb") as b:
            assert a.read() == b.read(), name
    # a second task into the same directory: meta.json gains it, in both packages alike
    tdir = str(tmp_path / "port")
    shutil.copytree(pack, tdir)
    for build, out in ((tpack.build_code_cloze_pack, tdir), (jpack.build_code_cloze_pack, jdir)):
        build(SOURCES[:3], out, n_examples=3, seed=2, context_lines=4, task_name="short")
    for name in ("short.jsonl", "meta.json"):
        with open(os.path.join(tdir, name), "rb") as a, open(os.path.join(jdir, name), "rb") as b:
            assert a.read() == b.read(), name
    assert tpack.load_task_pack(tdir) == jpack.load_task_pack(jdir)
    assert set(tpack.load_task_pack(tdir)) == {"code_cloze", "short"}
    with pytest.raises(ValueError, match="at least 2"):
        tpack.build_code_cloze_pack(SOURCES[:1], str(tmp_path / "one"))
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="no \\*.jsonl"):
        tpack.load_task_pack(str(tmp_path / "empty"))


def test_evaluate_task_pack_matches_jax(model, pack, ref):
    _, _, tp, tc = model
    out = ref[0]["pack"]
    got = tpack.evaluate_task_pack(tp, tc, pack, _bytes, **F32)
    assert set(got) == set(out) == {"code_cloze"}
    assert got["code_cloze"]["count"] == out["code_cloze"]["count"] == 5
    assert got["code_cloze"]["acc"] == out["code_cloze"]["acc"]
    scores = np.asarray(got["code_cloze"]["scores"])
    assert scores.shape == (5, 4) and np.isfinite(scores).all()
    limited = tpack.evaluate_task_pack(tp, tc, pack, _bytes, limit=2, **F32)
    np.testing.assert_array_equal(limited["code_cloze"]["scores"], scores[:2])


def test_evaluation_downstream_task_pack_leg_and_warnings(model, pack, tok_dir, ref, caplog,
                                                          monkeypatch):
    _, _, tp, tc = model
    monkeypatch.delenv("SSP_X_VIT_TASK_PACK", raising=False)
    want = ref[0]["downstream"]
    got = tdown.evaluation_downstream(tp, tc, tok_dir, task_pack=pack, **F32)
    assert got["backend"] == want["backend"] == "taskpack"
    r, w = got["results"]["code_cloze"], want["results"]["code_cloze"]
    assert (r["acc"], r["count"]) == (w["acc"], w["count"])
    # the directory's tokenizer.json is what encodes the text
    from ssp_x_vit_tpu_torch.llm.tokenizer import ByteLevelBPETokenizer
    text = "    return self.forward(x)\n"
    assert tdown._make_offline_encode(tok_dir)(text) == \
        ByteLevelBPETokenizer.from_file(TOKENIZER).encode(text) != _bytes(text)
    # a name that is no directory: raw bytes, with the JAX module's warning
    with caplog.at_level(logging.WARNING):
        assert tdown._make_offline_encode("tiny-random")(text) == _bytes(text)
    assert "falling back to raw UTF-8 byte ids" in caplog.text
    # no pack at all: the warning, and None, in both packages
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        assert tdown.evaluation_downstream(tp, tc, tok_dir) is None
        assert jdown.evaluation_downstream(*model[:2], tok_dir) is None
    assert caplog.text.count("downstream evaluation unavailable") == 2
    monkeypatch.setenv("SSP_X_VIT_TASK_PACK", pack)
    assert tdown.evaluation_downstream(tp, tc, tok_dir, **F32)["results"]["code_cloze"]["acc"] == \
        w["acc"]
    # the lm-eval harness leg is not ported
    assert tdown.lm_eval_available() is False and jdown.lm_eval_available() is False
    for call in (lambda: tdown.make_jax_lm(tp, tc, None),
                 lambda: tdown.eval_zero_shot("m", tp, tc, None)):
        with pytest.raises(NotImplementedError, match=r"ROADMAP\.md A\.10e"):
            call()
