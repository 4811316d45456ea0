"""The port's text paths on a SentencePiece-style directory (the committed
``llama2`` fixture: ``Prepend`` + ``Replace``, byte fallback,
``LlamaTokenizerFast``'s BOS) against the JAX package's CLIs and functions,
which read it through ``transformers.AutoTokenizer``, on the CPU.

- ``main_llm --local_datasets``: ``load_corpora``'s four id streams equal
  the repository's ``main_llm.py``'s.
- ``train_llm --data``: the microbatches and the eval stream equal
  ``ssp_x_vit_tpu.cli.train_llm._token_batches``'s.
- ``serve_http --tokenizer``: the prompt ids the server hands the engine for
  text and chat prompts are JAX's ``tokenizer.encode`` (BOS first); the port's
  server and the JAX server with fp32 weights and pools give the same text,
  streamed and not.
- ``qualitative_results``: the port's answers are JAX's ``generate_response``
  with the JAX tokenizer (BOS in, ``skip_special_tokens``), and both stop at
  ``eos_token_id`` when the config names the model's first choice as EOS.
- ``downstream._make_offline_encode``: the port reads the directory through
  ``load_tokenizer`` without special tokens (JAX's ``AutoTokenizer`` ids);
  JAX's own function raises ``ValueError`` there (it hands any
  ``tokenizer.json`` to its byte-level class): the accepted difference.
"""

import importlib.util
import json
import logging
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import main_llm as jcli
import torch_tokenizer_dirs as dirs
from ssp_x_vit_tpu.cli import train_llm as jtrain
from ssp_x_vit_tpu.llm import downstream as jdown
from ssp_x_vit_tpu.llm import generate as jgen
from ssp_x_vit_tpu.llm import model as jmodel
from ssp_x_vit_tpu.llm import server_http as jserver
from ssp_x_vit_tpu.llm.engine import ServingEngine as JaxEngine
from ssp_x_vit_tpu.llm.tokenizer import load_tokenizer as jax_load_tokenizer
from ssp_x_vit_tpu_torch.cli import main_llm as tcli
from ssp_x_vit_tpu_torch.cli import serve_http as tserve
from ssp_x_vit_tpu_torch.cli import train_llm as ttrain
from ssp_x_vit_tpu_torch.llm import checkpoints as tckpt
from ssp_x_vit_tpu_torch.llm import downstream as tdown
from ssp_x_vit_tpu_torch.llm import generate as tgen
from ssp_x_vit_tpu_torch.llm import model as tmodel
from ssp_x_vit_tpu_torch.llm import server_http as tserver
from ssp_x_vit_tpu_torch.llm.hf_tokenizer import HFTokenizer
from ssp_x_vit_tpu_torch.llm.tokenizer import load_tokenizer

CKPT = os.path.join(dirs.ROOT, "ckpts", "code_llm_small")
LLAMA2 = dirs.fixture_dir("llama2")
SMALL = dict(vocab_size=8192, hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2,
             intermediate_size=48)
TINY = dict(jcli.TINY_RANDOM, vocab_size=8192)
CORPORA = {"wikitext2": ("val", 0), "c4_val": ("val", 2000), "fineweb_edu": ("val", 4000),
           "c4_train": ("train", 0)}


@pytest.fixture(autouse=True)
def offline(monkeypatch):
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrow_corpus():
    spec = importlib.util.spec_from_file_location(
        "arrow_corpus", os.path.join(dirs.ROOT, "scripts", "arrow_corpus.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def documents(split: str, start: int, n: int = 2000):
    ids = np.fromfile(os.path.join(CKPT, "corpus_slice", f"{split}.bin"), np.uint16)
    return _arrow_corpus().documents(load_tokenizer(CKPT).decode(ids[start:start + n].tolist()))


def with_tokenizer(d):
    os.makedirs(d, exist_ok=True)
    for name in ("tokenizer.json", "tokenizer_config.json"):
        shutil.copy(os.path.join(LLAMA2, name), d)
    return str(d)


@pytest.fixture(scope="module")
def toks():
    return load_tokenizer(LLAMA2), jax_load_tokenizer(LLAMA2)


@pytest.fixture(scope="module")
def model():
    """(jax params, jax cfg, torch params, torch cfg) from one numpy seed."""
    jcfg = jmodel.LlamaConfig(**SMALL)
    shapes = jax.eval_shape(lambda: jmodel.init_llama_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(19)

    def leaf(name, shape):
        if name.startswith("ln"):
            return (1 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        return ((0.6 if name == "lm_head" else 0.25) * rng.normal(size=shape)).astype(np.float32)

    tree = {k: ({kk: leaf(kk, vv.shape) for kk, vv in v.items()} if isinstance(v, dict)
                else leaf(k, v.shape)) for k, v in shapes.items()}
    return tree, jcfg, tmodel.LlamaConfig(**SMALL)


def _both(tree, jcfg, tcfg):
    return (jax.tree.map(jnp.asarray, tree), jcfg, tckpt.llm_params_from_jax(tree, device="cpu"),
            tcfg)


def test_main_llm_local_datasets_streams_match(tmp_path, monkeypatch):
    writer = _arrow_corpus()
    for name, (split, start) in CORPORA.items():
        writer.write_dataset(str(tmp_path / "data" / name), documents(split, start))
    model_dir = with_tokenizer(tmp_path / "model")
    (tmp_path / "model" / "config.json").write_text(json.dumps(TINY))
    monkeypatch.chdir(tmp_path)
    args = tcli.build_argparser().parse_args(
        ["--model", model_dir, "--backend", "cpu", "--seq-len", "128", "--local_datasets"])
    report = {}
    got = tcli.load_corpora(args, tmodel.LlamaConfig(**TINY), report)
    want = jcli.load_corpora(args, jmodel.LlamaConfig(**TINY))
    assert report["corpora"] == "local"
    for g, w in zip(got, want):
        assert g.shape[1] > 500
        np.testing.assert_array_equal(g, w)
    assert got[0][0, 0] != 1          # tokenize_corpus adds no BOS


def test_train_llm_data_batches_match(tmp_path):
    data = with_tokenizer(tmp_path / "corpus")
    texts = documents("train", 0, 4000)
    _arrow_corpus().write_dataset(data, texts)

    def parse(module, extra=()):
        argv = ["--data", data, "--steps", "3", "--batch-size", "2", "--seq-len", "64", *extra]
        return module.build_argparser().parse_args(
            (["--backend", "cpu"] if module is ttrain else []) + argv)

    tb, ts = ttrain._token_batches(parse(ttrain), tmodel.LlamaConfig(**TINY))
    jb, js = jtrain._token_batches(parse(jtrain), jmodel.LlamaConfig(**TINY))
    np.testing.assert_array_equal(np.stack(tb), np.asarray(jb))
    np.testing.assert_array_equal(ts, np.asarray(js).reshape(-1))
    want = load_tokenizer(data)("\n\n".join(texts), add_special_tokens=False)["input_ids"]
    np.testing.assert_array_equal(tb[0].reshape(-1), np.asarray(want[:2 * 65]))
    # a corpus directory without any tokenizer: both fall back to the synthetic stream
    bare = tmp_path / "bare"
    _arrow_corpus().write_dataset(str(bare), texts)
    args = ttrain.build_argparser().parse_args(["--backend", "cpu", "--data", str(bare),
                                                "--steps", "3", "--batch-size", "2",
                                                "--seq-len", "64"])
    tb, _ = ttrain._token_batches(args, tmodel.LlamaConfig(**TINY))
    jargs = jtrain.build_argparser().parse_args(["--data", str(bare), "--steps", "3",
                                                 "--batch-size", "2", "--seq-len", "64"])
    jb, _ = jtrain._token_batches(jargs, jmodel.LlamaConfig(**TINY))
    np.testing.assert_array_equal(np.stack(tb), np.asarray(jb))


def _post(port, path, body):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", path, json.dumps(body), {"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 200, resp.read()
    if not body.get("stream"):
        choice = json.loads(resp.read())["choices"][0]
        conn.close()
        return choice["message"]["content"] if "message" in choice else choice["text"]
    text = ""
    for line in resp.read().decode().splitlines():
        if line.startswith("data: ") and line != "data: [DONE]":
            choice = json.loads(line[len("data: "):])["choices"][0]
            text += choice["delta"].get("content", "") if "delta" in choice else choice["text"]
    conn.close()
    return text


def _serve(engine, tokenizer, server_module, requests):
    import threading

    srv = server_module.create_server(engine, tokenizer=tokenizer, port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        return [_post(srv.server_address[1], path, body) for path, body in requests]
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)


def test_serve_http_text_and_chat_prompts_match_jax(model, toks, monkeypatch):
    jparams, jcfg, tparams, tcfg = _both(*model)
    _, jax_tok = toks
    args = tserve.build_argparser().parse_args(
        ["--model", "mine", "--backend", "cpu", "--kv-dtype", "fp32", "--page-size", "16",
         "--num-pages", "64", "--max-context", "256", "--max-batch", "2", "--tokenizer", LLAMA2])
    engine, eos = tserve.build_engine(args, model=(tparams, tcfg))
    tokenizer = tserve.server_kwargs(args, eos)["tokenizer"]
    assert isinstance(tokenizer, HFTokenizer)
    seen = []
    submit = engine.submit

    def recording_submit(prompt_ids, **kw):
        seen.append(list(prompt_ids))
        return submit(prompt_ids, **kw)
    monkeypatch.setattr(engine, "submit", recording_submit)
    prompt = "def add(a, b):\n    return ü"
    messages = [{"role": "user", "content": "Hallo, wie geht's? 漢字"}]
    requests = [("/v1/completions", {"prompt": prompt, "max_tokens": 10, "temperature": 0}),
                ("/v1/completions", {"prompt": prompt, "max_tokens": 10, "temperature": 0,
                                     "stream": True}),
                ("/v1/chat/completions", {"messages": messages, "max_tokens": 8,
                                          "temperature": 0}),
                ("/v1/chat/completions", {"messages": messages, "max_tokens": 8,
                                          "temperature": 0, "stream": True})]
    jengine = JaxEngine(jparams, jcfg, max_batch=2, num_pages=64, page_size=16, max_context=256,
                        cache_dtype=jnp.float32)
    try:
        got = _serve(engine, tokenizer, tserver, requests)
        ref = _serve(jengine, jax_tok, jserver, requests)
    finally:
        engine.shutdown()
        jengine.shutdown()
    chat = jax_tok.encode(tserver._render_chat(messages))
    assert seen == [jax_tok.encode(prompt)] * 2 + [chat] * 2
    assert seen[0][0] == jax_tok.bos_token_id == 1
    assert got == ref and got[0] == got[1] and got[2] == got[3] and got[0]


def test_qualitative_results_match_jax_and_stop_at_eos(model, toks, tmp_path, caplog):
    """Both prompts answered as JAX answers them; then with a config whose
    ``eos_token`` is the token the model picks first for the first prompt,
    that answer stops at once (the EOS dropped from the text), in both."""
    jparams, jcfg, tparams, tcfg = _both(*model)
    port_tok, _ = toks
    first = "Who is Albert Einstein?"
    ids = port_tok(first)["input_ids"]
    assert ids[0] == port_tok.bos_token_id
    nxt = int(np.argmax(np.asarray(jmodel.llama_forward(
        jparams, jnp.asarray([ids]), jcfg, compute_dtype=jnp.float32)[0][0, -1])))
    stop_dir = with_tokenizer(tmp_path / "stop")
    config = json.loads((tmp_path / "stop" / "tokenizer_config.json").read_text())
    config["eos_token"] = port_tok.id_to_token(nxt)
    (tmp_path / "stop" / "tokenizer_config.json").write_text(json.dumps(config))
    for d in (LLAMA2, stop_dir):
        port, ref = load_tokenizer(d), jax_load_tokenizer(d)
        assert port.eos_token_id == ref.eos_token_id == (nxt if d == stop_dir else 2)
        caplog.clear()
        with caplog.at_level(logging.INFO):
            out = tgen.qualitative_results(tparams, tcfg, d, max_length=14)
        assert [p for p, _ in out] == [first, "The theory of relativity"]
        for prompt, answer in out:
            assert answer == jgen.generate_response(prompt, jparams, jcfg, ref, 14)
            assert answer.startswith(prompt) and answer in caplog.text
        assert (out[0][1] == first) == (d == stop_dir)


def test_make_offline_encode_reads_the_directory(toks, tmp_path, caplog):
    port_tok, jax_tok = toks
    encode = tdown._make_offline_encode(LLAMA2)
    for text in dirs.texts("llama2"):
        assert encode(text) == jax_tok(text, add_special_tokens=False)["input_ids"]
    # accepted difference: the JAX function reads any tokenizer.json with its byte-level class
    with pytest.raises(ValueError, match="ByteLevel"):
        jdown._make_offline_encode(LLAMA2)
    # a byte-level directory: both give the byte-level class's ids
    for text in ("def f(x):\n    return x", "ü 漢字"):
        assert tdown._make_offline_encode(CKPT)(text) == jdown._make_offline_encode(CKPT)(text)
    # no tokenizer in the directory, or no directory: raw UTF-8 bytes with the warning
    with caplog.at_level(logging.WARNING):
        for where in (str(tmp_path), "tiny-random"):
            assert tdown._make_offline_encode(where)("hé") == [104, 195, 169]
    assert "raw UTF-8 byte ids" in caplog.text
