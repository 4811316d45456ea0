"""The port's paged MLA serving (``ssp_x_vit_tpu_torch/llm/paged_mla.py``)
against the JAX package on the CPU, mirroring ``tests/test_paged_mla.py``.

Weights are drawn with numpy in the JAX tree layout and carried across. In
fp32 the served greedy tokens equal JAX's ``mla_paged_generate`` and the
port's own ``deepseek_generate`` (ragged prompts, continuous batching);
chunked prefill and prefix-cached prefill equal the whole-prompt prefill;
``step_many`` equals ``step``; ``ServingEngine`` serves an MLA model. The
int8 latent pool holds JAX's codes and scales bit for bit for the same
latents, and decodes within JAX's own bound of the bf16 pool. The server
refuses what JAX's refuses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssp_x_vit_tpu.llm import deepseek as J
from ssp_x_vit_tpu.llm import paged_mla as JP
from ssp_x_vit_tpu.ops.pallas import paged_attention as jpa
from ssp_x_vit_tpu_torch.llm import deepseek as T
from ssp_x_vit_tpu_torch.llm import paged_mla as TP
from ssp_x_vit_tpu_torch.llm.checkpoints import deepseek_params_from_jax
from ssp_x_vit_tpu_torch.llm.engine import ServingEngine
from ssp_x_vit_tpu_torch.llm.rope import RopeScaling as TRopeScaling
from ssp_x_vit_tpu.llm.rope import RopeScaling as JRopeScaling

BASE = dict(vocab_size=64, hidden_size=16, num_layers=3, num_heads=2, kv_lora_rank=8,
            qk_nope_head_dim=4, qk_rope_head_dim=8, v_head_dim=4, intermediate_size=24,
            n_routed_experts=0)
VARIANTS = {
    "yarn": dict(rope_scaling=dict(rope_type="yarn", factor=4.0, mscale=1.2,
                                   mscale_all_dim=0.8, original_max_position_embeddings=16)),
    "moe_qlora": dict(n_routed_experts=4, n_shared_experts=1, num_experts_per_tok=2,
                      first_k_dense_replace=1, moe_intermediate_size=12, q_lora_rank=8,
                      routed_scaling_factor=1.5),
}
PROMPTS = [np.arange(5) % 64 + 1, np.asarray([7, 9]), np.arange(9) % 64 + 1]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's tiny tensors: the suite runs six
    workers on the host's cores, where a pool per worker only contends."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_params(tcfg, seed):
    """A parameter tree in the JAX layout made from a numpy seed (normal, std
    0.02 but 0.3 for the embedding and lm_head, so greedy margins are wide;
    norms at one; small e_score_correction biases)."""
    rng = np.random.default_rng(seed)
    shapes = T.init_deepseek_params(None, tcfg, device="cpu")

    def fill(name, t):
        if isinstance(t, dict):
            return {k: fill(k, v) for k, v in t.items()}
        if name.startswith("ln") or name.endswith("norm"):
            return np.ones(tuple(t.shape), np.float32)
        if name == "e_bias":
            return rng.uniform(-0.05, 0.05, tuple(t.shape)).astype(np.float32)
        std = 0.3 if name in ("embed", "lm_head") else 0.02
        return (rng.standard_normal(tuple(t.shape)) * std).astype(np.float32)

    return {k: fill(k, v) for k, v in shapes.items()}


def _cfgs(name):
    kw = dict(BASE, **VARIANTS[name])
    rs = kw.pop("rope_scaling", None)
    return (J.DeepseekConfig(**kw, rope_scaling=JRopeScaling(**rs) if rs else None),
            T.DeepseekConfig(**kw, rope_scaling=TRopeScaling(**rs) if rs else None))


@pytest.fixture(scope="module", params=list(VARIANTS))
def model(request):
    """(JAX params, JAX cfg, port params, port cfg, JAX's paged tokens of PROMPTS)."""
    jcfg, tcfg = _cfgs(request.param)
    tree = np_params(tcfg, 0)
    jp = jax.tree.map(jnp.asarray, tree)
    ref = JP.mla_paged_generate(jp, jcfg, PROMPTS, max_new_tokens=7, page_size=4,
                                cache_dtype=jnp.float32)
    return jp, jcfg, deepseek_params_from_jax(tree, device="cpu"), tcfg, ref


def test_paged_generate_matches_jax_and_contiguous(model):
    _, _, tp, tcfg, ref = model
    got = TP.mla_paged_generate(tp, tcfg, PROMPTS, max_new_tokens=7, page_size=4,
                                cache_dtype=torch.float32)
    assert [g.tolist() for g in got] == [r.tolist() for r in ref]
    for p, g in zip(PROMPTS, got):
        assert T.deepseek_generate(tp, tcfg, p, max_new_tokens=7,
                                   compute_dtype=torch.float32).tolist() == g.tolist()


def test_server_batching_page_reuse_and_eos(model):
    _, _, tp, tcfg, ref = model
    srv = TP.MLAPagedServer(tp, tcfg, max_batch=2, num_pages=12, page_size=4, max_context=32,
                            cache_dtype=torch.float32)
    free0 = len(srv.free_pages)
    ids = [srv.add_request(p, max_new_tokens=7) for p in PROMPTS[:2]]
    srv.step()
    outs = srv.run()
    assert len(srv.free_pages) == free0
    for rid, r in zip(ids, ref[:2]):
        assert outs[rid].tolist() == r.tolist()
    eos = int(ref[0][len(PROMPTS[0]) + 1])
    rid = srv.add_request(PROMPTS[0], max_new_tokens=7, eos_token_id=eos)
    assert srv.run()[rid].tolist() == ref[0][: len(PROMPTS[0]) + 2].tolist()


def test_chunked_and_prefix_cached_prefill_equal_whole(model):
    _, _, tp, tcfg, _ = model
    prompts = [np.arange(11) % 64 + 1, np.asarray([9, 3]), np.arange(8) % 64 + 1]
    outs = []
    for kw in ({}, {"chunked_prefill": 4}):
        srv = TP.MLAPagedServer(tp, tcfg, max_batch=4, num_pages=32, page_size=4,
                                max_context=64, cache_dtype=torch.float32, **kw)
        rids = [srv.add_request(p, max_new_tokens=8) for p in prompts]
        res = srv.run()
        outs.append([res[r].tolist() for r in rids])
    assert outs[0] == outs[1]
    shared = (np.arange(16) % 64 + 1).tolist()
    p1, p2 = shared + [7, 8, 9], shared + [11, 12]
    srv = TP.MLAPagedServer(tp, tcfg, max_batch=2, num_pages=48, page_size=4, max_context=64,
                            cache_dtype=torch.float32, prefix_cache=True)
    r1 = srv.add_request(p1, max_new_tokens=8)
    r2 = srv.add_request(p2, max_new_tokens=8)
    assert srv.prefix_hit_pages == 4
    res = srv.run()
    for p, rid in ((p1, r1), (p2, r2)):
        whole = TP.mla_paged_generate(tp, tcfg, [p], max_new_tokens=8, page_size=4,
                                      cache_dtype=torch.float32)[0]
        assert res[rid].tolist() == whole.tolist()


def test_step_many_matches_step(model):
    _, _, tp, tcfg, _ = model
    budgets = [11, 3, 7]
    outs = []
    for many in (False, True):
        srv = TP.MLAPagedServer(tp, tcfg, max_batch=3, num_pages=24, page_size=4,
                                max_context=32, cache_dtype=torch.float32)
        rids = [srv.add_request(p, max_new_tokens=n) for p, n in zip(PROMPTS, budgets)]
        while any(s.active for s in srv.slots):
            srv.step_many(4) if many else srv.step()
        outs.append([srv.finished[r].tolist() for r in rids])
        assert len(srv.free_pages) == 23
    assert outs[0] == outs[1]


def test_engine_serves_mla(model):
    _, _, tp, tcfg, ref = model
    with ServingEngine(tp, tcfg, max_batch=2, num_pages=16, page_size=4, max_context=32,
                       cache_dtype=torch.float32) as eng:
        assert isinstance(eng._server, TP.MLAPagedServer)
        toks = eng.submit(PROMPTS[2], max_new_tokens=7).result(timeout=300)
    assert toks == ref[2][len(PROMPTS[2]):].tolist()


def test_int8_pool_holds_jaxs_codes_and_decodes_near_bf16():
    """The int8 latent pool: for the same latents (JAX's, rounded to bf16),
    the port's prefill write gives JAX's codes and scales bit for bit, whole
    rows under one scale; one decode step over it lands within JAX's own
    bound (0.08) of the bf16 pool's logits."""
    jcfg, tcfg = _cfgs("moe_qlora")
    tree = np_params(tcfg, 1)
    jp, tp = jax.tree.map(jnp.asarray, tree), deepseek_params_from_jax(tree, device="cpu")
    toks = np.asarray([[5, 1, 2, 9, 11, 4]])
    _, (c, kr) = J.deepseek_forward(jp, jnp.asarray(toks), jcfg, compute_dtype=jnp.float32,
                                    return_caches=True)
    cat = jnp.concatenate([c, kr], axis=-1)[:, 0].astype(jnp.bfloat16)     # [L, s, D]
    codes, scales = jpa._quantize_token_kv(cat)
    pt = np.asarray([1, 2, 0, 0], np.int32)
    pool = TP.init_mla_pool(tcfg, 4, 4, torch.int8)
    assert pool["q"].shape == (3, 1, 4, 4, 16) and pool["s"].shape == (3, 1, 4, 4)
    tcat = torch.from_numpy(np.array(cat.astype(jnp.float32))).to(torch.bfloat16)
    for layer in range(3):
        TP.paged_pool_write_many(pool, tcat[layer][:, None], torch.as_tensor(pt), 0,
                                 layer_idx=layer)
    pos = np.arange(6)
    np.testing.assert_array_equal(pool["q"][:, 0, pt[pos // 4], pos % 4].numpy(),
                                  np.asarray(codes))
    np.testing.assert_array_equal(pool["s"][:, 0, pt[pos // 4], pos % 4].numpy(),
                                  np.asarray(scales))
    out = {}
    for dtype in (torch.bfloat16, torch.int8):
        pool = TP.init_mla_pool(tcfg, 8, 4, dtype)
        table = torch.as_tensor([1, 2, 3, 0], dtype=torch.int32)
        TP.mla_paged_prefill(tp, torch.as_tensor(toks), pool, tcfg, table, 6)
        lg, _ = TP.mla_paged_decode_step(tp, torch.as_tensor([3]), pool, tcfg, table[None],
                                         torch.as_tensor([6], dtype=torch.int32))
        out[dtype] = lg.float().numpy()
    np.testing.assert_allclose(out[torch.int8], out[torch.bfloat16], atol=0.08)
    srv = TP.MLAPagedServer(tp, tcfg, max_batch=1, num_pages=32, page_size=4, max_context=64,
                            cache_dtype=torch.int8, chunked_prefill=4)
    rid = srv.add_request(np.arange(10) % 64 + 1, max_new_tokens=6)
    res = srv.run()[rid]
    assert res.shape == (16,) and np.all((0 <= res) & (res < tcfg.vocab_size))


def test_server_refusals():
    _, tcfg = _cfgs("yarn")
    tp = deepseek_params_from_jax(np_params(tcfg, 2), device="cpu")
    with pytest.raises(ValueError, match="ONE latent pool"):
        TP.MLAPagedServer(tp, tcfg, cache_dtype={"k": torch.int8, "v": torch.int8})
    import dataclasses

    with pytest.raises(ValueError, match="attention-materialized"):
        TP.MLAPagedServer(tp, dataclasses.replace(tcfg, pruned_attention_blocks=(1,)))


def test_serve_http_serves_a_deepseek_model():
    """``serve_http`` builds its engine over ``MLAPagedServer`` for a DeepSeek
    model loaded by ``main_llm.load_model`` (the tiny MoE model) and answers a
    greedy token-id request over HTTP with ``mla_paged_generate``'s tokens."""
    import http.client
    import json
    import threading

    from ssp_x_vit_tpu_torch.cli import serve_http
    from ssp_x_vit_tpu_torch.llm.server_http import create_server

    args = serve_http.build_argparser().parse_args(
        ["--model", "tiny-random-deepseek", "--backend", "cpu", "--port", "0", "--kv-dtype",
         "fp32", "--max-batch", "2", "--page-size", "8", "--num-pages", "16",
         "--max-context", "64"])
    engine, eos = serve_http.build_engine(args)
    assert isinstance(engine._server, TP.MLAPagedServer)
    srv = create_server(engine, **serve_http.server_kwargs(args, eos))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1], timeout=120)
        conn.request("POST", "/v1/completions", json.dumps(
            {"prompt": [3, 5, 7, 11], "max_tokens": 6, "temperature": 0}),
            {"Content-Type": "application/json"})
        body = json.loads(conn.getresponse().read())
        conn.close()
    finally:
        srv.shutdown()
        engine.shutdown()
        thread.join(timeout=10)
    ref = TP.mla_paged_generate(engine._server.params, engine.cfg, [[3, 5, 7, 11]],
                                max_new_tokens=6, page_size=8, cache_dtype=torch.float32)[0]
    assert body["choices"][0]["token_ids"] == ref[4:].tolist()
    assert body["choices"][0]["finish_reason"] == "length"
