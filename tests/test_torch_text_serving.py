"""Text in and text out on the CPU: ``generate_response`` /
``qualitative_results`` (``llm/generate.py``), ``tokenize_corpus``
(``llm/datasets.py``) and the HTTP server with a tokenizer
(``cli/serve_http.py`` ``--tokenizer`` / the model directory's
``tokenizer.json``; ``llm/server_http.py``'s text, chat and ``stop`` paths and
its UTF-8 tail guard), against the JAX package with the same weights and
``ckpts/code_llm_small/tokenizer.json``.

Greedy tokens are compared exactly in fp32 (fp32 pools); the JAX forward's own
top-2 logit margin over every compared continuation is asserted above 1e-3,
so token equality is the claim. Accepted difference: the port's byte-level
tokenizer adds no BOS and has no ``eos_token_id`` where the JAX
``qualitative_results`` goes through ``transformers.AutoTokenizer``.
"""

import http.client
import json
import logging
import os
import shutil
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssp_x_vit_tpu.llm import datasets as jdata
from ssp_x_vit_tpu.llm import generate as jgen
from ssp_x_vit_tpu.llm import model as jmodel
from ssp_x_vit_tpu.llm import server_http as jserver
from ssp_x_vit_tpu.llm import tokenizer as jtok
from ssp_x_vit_tpu.llm.engine import ServingEngine as JaxEngine
from ssp_x_vit_tpu_torch.cli import serve_http as tcli
from ssp_x_vit_tpu_torch.llm import checkpoints as tckpt
from ssp_x_vit_tpu_torch.llm import datasets as tdata
from ssp_x_vit_tpu_torch.llm import generate as tgen
from ssp_x_vit_tpu_torch.llm import model as tmodel
from ssp_x_vit_tpu_torch.llm import server_http as tserver
from ssp_x_vit_tpu_torch.llm import tokenizer as ttok

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOKENIZER_DIR = os.path.join(ROOT, "ckpts", "code_llm_small")
SMALL = dict(vocab_size=8192, hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2,
             intermediate_size=48)


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
    """(jax params, jax cfg, torch params, torch cfg) from one numpy seed; a
    wide logit spread, so greedy choices are far from ties."""
    jcfg = jmodel.LlamaConfig(**SMALL)
    shapes = jax.eval_shape(lambda: jmodel.init_llama_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(12)

    def leaf(name, shape):
        if name.startswith("ln"):
            return (1 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        return ((0.6 if name == "lm_head" else 0.25) * rng.normal(size=shape)).astype(np.float32)

    tree = {k: ({kk: leaf(kk, vv.shape) for kk, vv in v.items()} if isinstance(v, dict)
                else leaf(k, v.shape)) for k, v in shapes.items()}
    return (jax.tree.map(jnp.asarray, tree), jcfg,
            tckpt.llm_params_from_jax(tree, device="cpu"), tmodel.LlamaConfig(**SMALL))


@pytest.fixture(scope="module")
def toks():
    return ttok.load_tokenizer(TOKENIZER_DIR), jtok.load_tokenizer(TOKENIZER_DIR)


def assert_margins(jparams, jcfg, seq, start):
    """The JAX fp32 forward's top-2 margin at every position that chose a token
    of ``seq`` from ``start`` on."""
    logits = np.asarray(jmodel.llama_forward(jparams, jnp.asarray([seq]), jcfg,
                                             compute_dtype=jnp.float32)[0][0])
    top2 = np.sort(logits[start - 1:len(seq) - 1], axis=-1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0]).min() > 1e-3


def test_generate_response_matches_jax(model, toks):
    jparams, jcfg, tparams, tcfg = model
    port, jax_tok = toks
    prompt = "def add(a, b):\n    return"
    got = tgen.generate_response(prompt, tparams, tcfg, port, max_length=24, num_beams=1)
    ref = jgen.generate_response(prompt, jparams, jcfg, jax_tok, max_length=24, num_beams=1)
    ids = port.encode(prompt)
    seq = tgen.greedy_generate(tparams, tcfg, np.asarray(ids), max_length=24).tolist()
    assert_margins(jparams, jcfg, seq, len(ids))
    assert got == ref == port.decode(seq) and got.startswith(prompt)
    beams = tgen.generate_response(prompt, tparams, tcfg, port, max_length=16, num_beams=3)
    assert beams == port.decode(tgen.beam_generate(tparams, tcfg, np.asarray(ids),
                                                   max_length=16, num_beams=3).tolist())
    text = ["first text", "second ü text"]
    np.testing.assert_array_equal(tdata.tokenize_corpus(text, port),
                                  jdata.tokenize_corpus(text, jax_tok))
    assert tdata.tokenize_corpus(text, port).dtype == np.int32


def test_qualitative_results_reads_the_directory_tokenizer(model, tmp_path, caplog):
    """With a tokenizer.json: both prompts answered as text that starts with the
    prompt (no BOS is added: the encoding is the plain one, and there is no eos
    id to stop at). Without one: the JAX warning and None."""
    _, _, tparams, tcfg = model
    port = ttok.load_tokenizer(TOKENIZER_DIR)
    assert port("Who", add_special_tokens=True)["input_ids"] == port.encode("Who")
    assert not hasattr(port, "eos_token_id")
    shutil.copy(os.path.join(TOKENIZER_DIR, "tokenizer.json"), tmp_path / "tokenizer.json")
    with caplog.at_level(logging.INFO):
        out = tgen.qualitative_results(tparams, tcfg, str(tmp_path), max_length=12)
    assert [p for p, _ in out] == ["Who is Albert Einstein?", "The theory of relativity"]
    for prompt, response in out:
        assert response.startswith(prompt) and response in caplog.text
        assert response == tgen.generate_response(prompt, tparams, tcfg, port, 12)
    with caplog.at_level(logging.WARNING):
        assert tgen.qualitative_results(tparams, tcfg, str(tmp_path / "none")) is None
    assert "Tokenizer unavailable" in caplog.text and "skipping qualitative results" in caplog.text


def test_stream_state_tail_guard_and_stop_strings_match_jax(toks):
    """A multi-byte character split across tokens is never emitted half; a stop
    string that starts inside a token truncates there; every delta as the JAX
    server's detokenizer gives it."""
    port, jax_tok = toks
    text = "ok 🙂 über 漢字 done; end"
    ids = port.encode(text)
    pieces = [port.decode([i]) for i in ids]
    assert any("�" in p for p in pieces)        # the emoji spans several tokens
    for stop in ([], ["字 d"], ["ber 漢"], ["🙂"], ["not there"]):
        ts, js = tserver._StreamState(port, stop), jserver._StreamState(jax_tok, stop)
        got, ref = [], []
        for i in ids:
            got.append(ts.push(i))
            ref.append(js.push(i))
            if ts.stopped:
                break
        got.append(ts.finalize())
        ref.append(js.finalize())
        assert got == ref and ts.stopped == js.stopped
        assert not any("�" in d for d in got)
        joined = "".join(got)
        assert joined == (text[:text.find(stop[0])] if stop and stop[0] in text else text)
    assert tserver._render_chat([{"role": "system", "content": "s"},
                                 {"role": "user", "content": "ü"}]) == jserver._render_chat(
        [{"role": "system", "content": "s"}, {"role": "user", "content": "ü"}])


def _post(port, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", path, json.dumps(body), {"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 200, resp.read()
    if not body.get("stream"):
        choice = json.loads(resp.read())["choices"][0]
        conn.close()
        return (choice["message"]["content"] if "message" in choice else choice["text"],
                choice["finish_reason"])
    text, finish = "", None
    for line in resp.read().decode().splitlines():
        if not line.startswith("data: ") or line == "data: [DONE]":
            continue
        choice = json.loads(line[len("data: "):])["choices"][0]
        text += choice["delta"].get("content", "") if "delta" in choice else choice["text"]
        finish = choice["finish_reason"] or finish
    conn.close()
    return text, finish


def _serve(engine, tokenizer, server_module, requests):
    srv = server_module.create_server(engine, tokenizer=tokenizer, port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        return [_post(srv.server_address[1], path, body) for path, body in requests]
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)


def test_text_serving_matches_the_jax_server(model, toks, tmp_path):
    """The port's CLI on a native directory holding a tokenizer.json (the
    tokenizer comes from the directory; the fp32 weights are handed in) against the JAX server with the JAX
    tokenizer: string prompts streamed and not, a chat, a stop string that
    starts inside a token (streamed and not)."""
    jparams, jcfg, tparams, tcfg = model
    port_tok, jax_tok = toks
    tckpt.save_llm_model(str(tmp_path), tparams, tcfg)
    shutil.copy(os.path.join(TOKENIZER_DIR, "tokenizer.json"), tmp_path / "tokenizer.json")
    args = tcli.build_argparser().parse_args(
        ["--model", str(tmp_path), "--backend", "cpu", "--kv-dtype", "fp32", "--page-size", "16",
         "--num-pages", "64", "--max-context", "256", "--max-batch", "2"])
    engine, eos = tcli.build_engine(args, model=(tparams, tcfg))   # fp32 weights
    kwargs = tcli.server_kwargs(args, eos)
    assert isinstance(kwargs["tokenizer"], ttok.ByteLevelBPETokenizer)
    assert engine._server.k_pools.dtype == torch.float32
    prompt = "def add(a, b):\n    return"
    chat = {"messages": [{"role": "user", "content": "Hallo, wie geht's? ü"}],
            "max_tokens": 10, "temperature": 0}
    base = [("/v1/completions", {"prompt": prompt, "max_tokens": 14, "temperature": 0}),
            ("/v1/completions", {"prompt": prompt, "max_tokens": 14, "temperature": 0,
                                 "stream": True}),
            ("/v1/chat/completions", chat),
            ("/v1/chat/completions", dict(chat, stream=True))]
    jengine = JaxEngine(jparams, jcfg, max_batch=2, num_pages=64, page_size=16, max_context=256,
                        cache_dtype=jnp.float32)
    try:
        got = _serve(engine, kwargs["tokenizer"], tserver, base)
        ref = _serve(jengine, jax_tok, jserver, base)
        assert got == ref
        assert got[0] == got[1] and got[2] == got[3]
        ids = port_tok.encode(prompt)
        seq = ids + port_tok.encode(got[0][0])
        assert port_tok.decode(seq) == prompt + got[0][0]
        assert_margins(jparams, jcfg, seq, len(ids))
        # a stop string starting one character into a multi-character token
        text = got[0][0]
        pieces = [port_tok.decode([i]) for i in port_tok.encode(text)]
        at = next(k for k, p in enumerate(pieces) if len(p) >= 2 and k > 0)
        start = len("".join(pieces[:at])) + 1
        stop = text[start:start + 3]
        stopped = [("/v1/completions", {"prompt": prompt, "max_tokens": 14, "temperature": 0,
                                        "stop": [stop], "stream": s}) for s in (False, True)]
        got_stop = _serve(engine, kwargs["tokenizer"], tserver, stopped)
        assert got_stop[0] == got_stop[1] == (text[:text.find(stop)], "stop")
        # Fault of the JAX server, repaired in the port: its detokenizer goes on
        # with the tokens the engine delivers after the stop (the rest of the
        # decode block that held it), so its answer runs on past the stop with
        # the stop's own characters cut out.
        ref_stop = _serve(jengine, jax_tok, jserver, stopped)
        assert ref_stop[0] == ref_stop[1] and ref_stop[0][1] == "stop"
        assert ref_stop[0][0].startswith(got_stop[0][0])
        assert len(ref_stop[0][0]) > len(got_stop[0][0]) and stop not in ref_stop[0][0]
    finally:
        engine.shutdown()
        jengine.shutdown()
