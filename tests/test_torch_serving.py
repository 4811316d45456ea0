"""The port's sampler, serving engine and HTTP frontend on the CPU backend
(``llm/sampling.py``, ``llm/engine.py``, ``llm/server_http.py``,
``cli/serve_http.py``) against the JAX package and the port's own
``paged_generate``.

The penalty and filter transforms and the greedy rows are the same numbers in
both frameworks (compared exactly; the filters by their -inf pattern and the
surviving values). The random streams differ, so sampled tokens are held to
same-seed reproducibility within the port and to the filtered support. Every
token that leaves the engine or the HTTP API must equal ``paged_generate``'s
greedy continuation (fp32 pools, same process, same arithmetic: exact).
"""

import http.client
import json
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssp_x_vit_tpu.llm import sampling as jsamp
from ssp_x_vit_tpu_torch.cli import serve_http as tcli
from ssp_x_vit_tpu_torch.llm import sampling as tsamp
from ssp_x_vit_tpu_torch.llm.engine import ServingEngine
from ssp_x_vit_tpu_torch.llm.model import LlamaConfig, init_llama_params
from ssp_x_vit_tpu_torch.llm.paged import PagedServer, paged_generate
from ssp_x_vit_tpu_torch.llm.server_http import _sampling_from_request, create_server

B, V = 4, 50


def logits_and_state(seed=0):
    rng = np.random.default_rng(seed)
    logits = (3 * rng.normal(size=(B, V))).astype(np.float32)
    prompt_mask = (rng.random((B, V)) < 0.2).astype(np.float32)
    counts = rng.integers(0, 3, (B, V)).astype(np.float32) * (rng.random((B, V)) < 0.3)
    return logits, prompt_mask, counts.astype(np.float32)


PENALTIES = [dict(repetition_penalty=1.3), dict(presence_penalty=0.7), dict(frequency_penalty=0.4),
             dict(repetition_penalty=0.8, presence_penalty=-0.2, frequency_penalty=0.3), dict()]


@pytest.mark.parametrize("kw", PENALTIES, ids=[",".join(k) or "none" for k in PENALTIES])
def test_apply_penalties_matches_jax_exactly(kw):
    logits, pm, counts = logits_and_state()
    ref = jsamp.apply_penalties(jnp.asarray(logits), jnp.asarray(pm), jnp.asarray(counts),
                                jsamp.SamplingParams(**kw))
    got = tsamp.apply_penalties(torch.from_numpy(logits), torch.from_numpy(pm),
                                torch.from_numpy(counts), tsamp.SamplingParams(**kw))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


FILTERS = [dict(top_k=5), dict(top_p=0.8), dict(min_p=0.1), dict(top_k=12, top_p=0.9, min_p=0.02),
           dict(top_k=1), dict(top_p=1.0), dict()]


@pytest.mark.parametrize("kw", FILTERS, ids=[",".join(f"{k}={v}" for k, v in f.items()) or "none"
                                             for f in FILTERS])
def test_filter_logits_matches_jax_exactly(kw):
    logits, _, _ = logits_and_state(1)
    scaled = logits / 0.7
    ref = jsamp.filter_logits(jnp.asarray(scaled), jsamp.SamplingParams(temperature=0.7, **kw))
    got = tsamp.filter_logits(torch.from_numpy(scaled), tsamp.SamplingParams(temperature=0.7, **kw))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))     # -inf pattern and survivors


def test_sampling_params_validation_matches_jax():
    for kw in (dict(top_p=0.0), dict(top_p=1.5), dict(min_p=-0.1), dict(repetition_penalty=0.0)):
        with pytest.raises(ValueError) as je:
            jsamp.SamplingParams(**kw)
        with pytest.raises(ValueError) as te:
            tsamp.SamplingParams(**kw)
        assert str(je.value) == str(te.value)
    sp = tsamp.SamplingParams(temperature=0.5, presence_penalty=0.1)
    assert sp.needs_counts and not sp.greedy and tsamp.SamplingParams().greedy


def make_states(rows):
    """The same per-slot knobs in a JAX and a port SamplerState."""
    jstate = jsamp.init_sampler_state(B, V)
    tstate = tsamp.init_sampler_state(B, V)
    for i, (kw, prompt, seed) in enumerate(rows):
        jstate = jsamp.slot_state_row(jstate, i, jsamp.SamplingParams(**kw), prompt, V, seed)
        tstate = tsamp.slot_state_row(tstate, i, tsamp.SamplingParams(**kw), prompt, V, seed)
    return jstate, tstate


def test_vectorized_sample_thresholds_and_greedy_rows_match_jax():
    """Row knobs one at a time: the port's per-row filtered logits equal the
    JAX package's ``filter_logits`` for that row's knobs; state rows equal
    field for field; greedy rows pick the JAX package's token; counts update
    alike."""
    rows = [(dict(temperature=0.7, top_k=6, repetition_penalty=1.2), [1, 2, 3], 11),
            (dict(temperature=1.3, top_p=0.85, frequency_penalty=0.3), [4], 12),
            (dict(temperature=0.5, min_p=0.05, presence_penalty=0.5), [5, 6], 13),
            (dict(repetition_penalty=1.5), [7, 8, 9], None)]          # greedy with a penalty
    logits, _, counts = logits_and_state(2)
    jstate, tstate = make_states(rows)
    for name in ("temperature", "top_k", "top_p", "min_p", "repetition", "presence", "frequency",
                 "prompt_mask", "counts"):
        np.testing.assert_array_equal(getattr(tstate, name).numpy(),
                                      np.asarray(getattr(jstate, name)), err_msg=name)
    tstate.counts.copy_(torch.from_numpy(counts))
    jstate = jsamp.dataclasses.replace(jstate, counts=jnp.asarray(counts))

    z = tsamp.penalized_logits(torch.from_numpy(logits), tstate)
    filtered = tsamp.filtered_logits(z, tstate)
    for i, (kw, _, _) in enumerate(rows):
        sp = jsamp.SamplingParams(**kw)
        zr = jsamp.apply_penalties(jnp.asarray(logits[i:i + 1]), jstate.prompt_mask[i:i + 1],
                                   jstate.counts[i:i + 1], sp)
        np.testing.assert_array_equal(z[i].numpy(), np.asarray(zr[0]))
        if not sp.greedy:
            fr = jsamp.filter_logits(zr / sp.temperature, sp)
            np.testing.assert_array_equal(filtered[i].numpy(), np.asarray(fr[0]))

    jtok, jnew = jsamp.vectorized_sample(jnp.asarray(logits), jstate)
    ttok, tnew = tsamp.vectorized_sample(torch.from_numpy(logits), tstate)
    assert int(ttok[3]) == int(jtok[3]) == int(z[3].argmax())          # the greedy row
    for i in range(3):                                                 # sampled rows: in the support
        assert torch.isfinite(filtered[i, ttok[i]])
    np.testing.assert_array_equal(tnew.counts[3].numpy(), np.asarray(jnew.counts[3]))
    assert float(tnew.counts.sum()) == float(counts.sum()) + B


def test_same_seed_same_tokens_and_neutral_rows_are_argmax():
    logits, _, _ = logits_and_state(3)
    rows = [(dict(temperature=1.0, top_k=20), [1], 5), (dict(temperature=1.0, top_k=20), [1], 5),
            (dict(temperature=1.0, top_k=20), [1], 6), (dict(), [2], None)]

    def run():
        _, state = make_states(rows)
        x = torch.from_numpy(np.tile(logits[:1] / 6, (B, 1)))    # flat enough to vary
        return torch.stack([tsamp.vectorized_sample(x, state)[0] for _ in range(12)])

    a, b = run(), run()
    assert torch.equal(a, b)                                 # reproducible
    assert torch.equal(a[:, 0], a[:, 1])                     # same seed, same stream
    assert not torch.equal(a[:, 0], a[:, 2])                 # another seed, another stream
    assert (a[:, 3] == int(logits[0].argmax())).all()        # neutral row == argmax
    # an all-neutral state is exactly argmax on every row
    tok, _ = tsamp.vectorized_sample(torch.from_numpy(logits), tsamp.init_sampler_state(B, V))
    assert tok.tolist() == logits.argmax(-1).tolist()


def test_sampling_from_request_matches_jax():
    from ssp_x_vit_tpu.llm.server_http import _sampling_from_request as jfn

    for body in ({}, {"temperature": 0}, {"temperature": 0.8, "top_p": 0.9, "seed": 7},
                 {"temperature": 0, "repetition_penalty": 1.2}, {"top_k": 0, "min_p": 0.0},
                 {"temperature": 1.0, "top_k": 5, "min_p": 0.1, "presence_penalty": 0.3}):
        (jsp, jseed), (tsp, tseed) = jfn(dict(body)), _sampling_from_request(dict(body))
        assert jseed == tseed
        assert (jsp is None) == (tsp is None)
        if jsp is not None:
            assert jsamp.dataclasses.asdict(jsp) == tsamp.dataclasses.asdict(tsp)


# ------------------------------------------------------------ engine and HTTP ---

CFG = LlamaConfig(vocab_size=512, hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2,
                  intermediate_size=64)
PAGE = 16


@pytest.fixture(scope="module")
def params():
    return init_llama_params(torch.Generator().manual_seed(0), CFG, device="cpu")


@pytest.fixture(scope="module")
def greedy_ref(params):
    cache = {}

    def ref(prompt, n):
        key = (tuple(prompt), n)
        if key not in cache:
            out = paged_generate(params, CFG, [np.asarray(prompt, np.int32)], max_new_tokens=n,
                                 page_size=PAGE, cache_dtype=torch.float32)[0]
            cache[key] = [int(t) for t in out[len(prompt):]]
        return cache[key]

    return ref


@pytest.fixture(scope="module")
def served(params):
    engine = ServingEngine(params, CFG, max_batch=3, num_pages=64, page_size=PAGE,
                           max_context=256, cache_dtype=torch.float32, decode_block=4)
    srv = create_server(engine, tokenizer=None, port=0, model_name="tiny-test")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield srv.server_address[1], engine
    srv.shutdown()
    engine.shutdown()
    thread.join(timeout=10)


def post(port, path, body, stream=False):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", path, json.dumps(body), {"Content-Type": "application/json"})
    resp = conn.getresponse()
    raw = resp.read()
    conn.close()
    if stream:
        events = [json.loads(block[len("data: "):]) for block in raw.decode().split("\n\n")
                  if block.startswith("data: ") and block != "data: [DONE]"]
        return resp.status, events
    return resp.status, json.loads(raw)


def get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("GET", path)
    resp = conn.getresponse()
    out = resp.status, json.loads(resp.read())
    conn.close()
    return out


def test_engine_parity_with_paged_generate_five_requests_over_three_slots(served, greedy_ref):
    _, engine = served
    prompts = [[3, 5, 7, 11], [2, 4], [9, 10, 11, 12, 13, 14], [100], [20, 21, 22]]
    handles = [engine.submit(p, max_new_tokens=9) for p in prompts]
    for p, h in zip(prompts, handles):
        assert h.result(timeout=120) == greedy_ref(p, 9)
        assert h.finish_reason == "length" and h.tokens == greedy_ref(p, 9)
    # events arrive as tokens, then one terminal event
    events = list(engine.submit(prompts[0], max_new_tokens=3))
    assert [e.kind for e in events] == ["token"] * 3 + ["done"]
    assert [e.token for e in events[:3]] == greedy_ref(prompts[0], 3)


def test_engine_rejects_empty_and_oversized_and_cancels(served):
    _, engine = served
    with pytest.raises(RuntimeError, match="empty prompt"):
        engine.submit([]).result(timeout=10)
    with pytest.raises(RuntimeError, match="max_context allows"):
        engine.submit([1] * 300, max_new_tokens=8).result(timeout=30)
    h = engine.submit([1, 2, 3], max_new_tokens=200)
    engine.cancel(h)
    h.result(timeout=60)
    assert h.finish_reason == "cancelled" and len(h.tokens) < 200


def test_health_and_models(served):
    port, _ = served
    assert get(port, "/health") == (200, {"status": "ok"})
    status, models = get(port, "/v1/models")
    assert status == 200 and models["data"][0]["id"] == "tiny-test"
    assert get(port, "/nope")[0] == 404


def test_completion_ids_greedy_matches_paged_generate(served, greedy_ref):
    port, _ = served
    prompt = [3, 5, 7, 11]
    status, out = post(port, "/v1/completions", {"prompt": prompt, "max_tokens": 8,
                                                 "temperature": 0})
    assert status == 200 and out["object"] == "text_completion"
    assert out["choices"][0]["finish_reason"] == "length"
    assert out["choices"][0]["token_ids"] == greedy_ref(prompt, 8)
    assert out["usage"] == {"prompt_tokens": 4, "completion_tokens": 8, "total_tokens": 12}


def test_streaming_matches_nonstream(served, greedy_ref):
    port, _ = served
    prompt = [2, 4, 6]
    status, events = post(port, "/v1/completions", {"prompt": prompt, "max_tokens": 6,
                                                    "temperature": 0, "stream": True}, stream=True)
    toks = [e["choices"][0]["token_ids"][0] for e in events
            if e["choices"][0]["finish_reason"] is None]
    assert status == 200 and toks == greedy_ref(prompt, 6)
    assert events[-1]["choices"][0]["finish_reason"] == "length"
    _, once = post(port, "/v1/completions", {"prompt": prompt, "max_tokens": 6, "temperature": 0})
    assert once["choices"][0]["token_ids"] == toks


def test_concurrent_mixed_sampling_keeps_greedy_exact_and_seeds_reproduce(served, greedy_ref):
    port, _ = served
    results = {}

    def run(name, body):
        results[name] = post(port, "/v1/completions", body)

    sampled = {"prompt": [20, 21], "max_tokens": 10, "temperature": 0.9, "top_p": 0.9, "seed": 7}
    threads = [threading.Thread(target=run, args=("greedy", {"prompt": [9, 10, 11],
                                                             "max_tokens": 10, "temperature": 0})),
               threading.Thread(target=run, args=("s1", sampled)),
               threading.Thread(target=run, args=("s2", dict(sampled)))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    assert all(results[k][0] == 200 for k in results)
    assert results["greedy"][1]["choices"][0]["token_ids"] == greedy_ref([9, 10, 11], 10)
    s1, s2 = (results[k][1]["choices"][0]["token_ids"] for k in ("s1", "s2"))
    assert len(s1) == 10 and all(0 <= t < CFG.vocab_size for t in s1)
    assert s1 == s2                                       # same seed, same tokens, any slot


def test_stop_token_ids_and_eos(served, greedy_ref):
    port, _ = served
    prompt = [3, 5, 7, 11]
    ref = greedy_ref(prompt, 8)
    _, out = post(port, "/v1/completions", {"prompt": prompt, "max_tokens": 8, "temperature": 0,
                                            "stop_token_ids": [ref[3]]})
    assert out["choices"][0]["finish_reason"] == "stop"
    assert out["choices"][0]["token_ids"] == ref[: ref.index(ref[3])]
    _, out = post(port, "/v1/completions", {"prompt": prompt, "max_tokens": 8, "temperature": 0,
                                            "eos_token_id": ref[2]})
    assert out["choices"][0]["finish_reason"] == "stop"
    assert out["choices"][0]["token_ids"] == ref[: ref.index(ref[2])]


def test_error_surface(served):
    port, _ = served
    for body, fragment in (({"prompt": "text"}, "require a tokenizer"),
                           ({"prompt": []}, "non-empty"),
                           ({"prompt": [1], "max_tokens": 0}, "max_tokens"),
                           ({"prompt": [1], "stop": ["x"]}, "require a tokenizer"),
                           ({"prompt": [1], "stop_token_ids": "x"}, "list of ints"),
                           ({"prompt": [1], "temperature": 1, "top_p": 0}, "top_p"),
                           ({"prompt": [1] * 300, "max_tokens": 8}, "max_context")):
        status, out = post(port, "/v1/completions", body)
        assert status == 400 and fragment in out["error"]["message"], (body, out)
    status, out = post(port, "/v1/chat/completions", {"messages": [{"role": "user", "content": "x"}]})
    assert status == 400 and "requires a tokenizer" in out["error"]["message"]
    assert post(port, "/v1/other", {})[0] == 404
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("POST", "/v1/completions", "{not json", {"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 400 and "valid JSON" in json.loads(resp.read())["error"]["message"]
    conn.close()


def test_cli_builds_an_engine_on_the_cpu_backend(greedy_ref, params):
    """``cli.serve_http`` from parsed arguments: a ``tiny-random`` model of
    its own, and a model handed in; int8 KV and chunked prefill flags reach
    the server."""
    parser = tcli.build_argparser()
    args = parser.parse_args(["--model", "tiny-random", "--backend", "cpu", "--max-batch", "2",
                              "--num-pages", "16", "--page-size", "8", "--max-context", "64",
                              "--kv-dtype", "int8", "--chunked-prefill", "4", "--prefix-cache",
                              "--eos-token-id", "5"])
    engine, eos = tcli.build_engine(args)
    try:
        server = engine._server
        assert eos == 5 and isinstance(server, PagedServer) and len(server.slots) == 2
        assert isinstance(server.k_pools, dict) and server.k_pools["q"].shape[2:4] == (16, 8)
        assert server.chunked_prefill == 4 and server.prefix_cache and server.device.type == "cpu"
        assert len(engine.submit([1, 2, 3], max_new_tokens=5).result(timeout=120)) == 5
    finally:
        engine.shutdown()
    args = parser.parse_args(["--model", "mine", "--backend", "cpu", "--page-size", str(PAGE),
                              "--num-pages", "32", "--max-context", "128"])
    assert tcli.server_kwargs(args, None)["model_name"] == "mine"
    engine, eos = tcli.build_engine(args, model=(params, CFG))
    try:
        assert eos is None and engine._server.k_pools.dtype == torch.bfloat16
        assert len(engine.submit([3, 5, 7, 11], max_new_tokens=4).result(timeout=120)) == 4
    finally:
        engine.shutdown()
    # a --tokenizer directory without a byte-level tokenizer.json raises (A.10f)
    with pytest.raises(NotImplementedError, match="ROADMAP.md A.10"):
        tcli.server_kwargs(parser.parse_args(["--model", "tiny-random", "--backend", "cpu",
                                              "--tokenizer", "somewhere"]), None)
    assert tcli.server_kwargs(parser.parse_args(["--model", "tiny-random"]), None)[
        "tokenizer"] is None
