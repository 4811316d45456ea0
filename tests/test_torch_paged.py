"""The port's paged serving path (``llm/serve.py``, ``llm/paged.py``) against
the JAX package on the CPU.

Weights and tokens come from a numpy seed and are carried across by
``llm_params_from_jax``; pools by ``pools_from_jax``. With fp32 pools the two
frameworks run the same arithmetic in another summation order: logits atol
1e-4. bf16 and int8 pools round at other places: error scaled by
max(1, max |reference|) <= 5e-2. Greedy tokens are compared while the JAX
package's own top-2 logit margin exceeds 1e-3 (a near-tie in random weights
may flip on a 1e-5 difference); the tests assert that this never cuts a
comparison short here. The page accounting is plain Python in both packages:
same page ids, same exceptions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssp_x_vit_tpu.llm import model as jmodel
from ssp_x_vit_tpu.llm import paged as jpaged
from ssp_x_vit_tpu.llm import pruning as jprune
from ssp_x_vit_tpu.llm import quant as jquant
from ssp_x_vit_tpu.llm import serve as jserve
from ssp_x_vit_tpu_torch.cli.main_llm import _TINY_VARIANTS
from ssp_x_vit_tpu_torch.llm import checkpoints as tckpt
from ssp_x_vit_tpu_torch.llm import model as tmodel
from ssp_x_vit_tpu_torch.llm import paged as tpaged
from ssp_x_vit_tpu_torch.llm import serve as tserve

SMALL = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2,
             intermediate_size=48)
PS = 4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's tiny tensors: the suite runs six
    workers on the host's cores, where a pool per worker only contends."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_model(family="tiny-random", seed=0, **overrides):
    """(jax params, jax cfg, torch params, torch cfg) with numpy-seeded weights:
    kernels ~ N(0, 0.08), norm scales ~ 1 + N(0, 0.1), biases ~ N(0, 0.1)."""
    kw = dict(SMALL, **_TINY_VARIANTS[family])
    if "window_layers" in kw:
        kw.update(window_layers=(0,), sliding_window=6)
    kw.update(overrides)
    jcfg, tcfg = jmodel.LlamaConfig(**kw), tmodel.LlamaConfig(**kw)
    shapes = jax.eval_shape(lambda: jmodel.init_llama_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(seed)

    def leaf(name, shape):
        if name.endswith("bias"):
            return (0.1 * rng.normal(size=shape)).astype(np.float32)
        if name.startswith("ln") or name.endswith("_norm"):
            return (1 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        return (0.08 * rng.normal(size=shape)).astype(np.float32)

    tree = {k: ({kk: leaf(kk, vv.shape) for kk, vv in v.items()} if isinstance(v, dict)
                else leaf(k, v.shape)) for k, v in shapes.items()}
    return (jax.tree.map(jnp.asarray, tree), jcfg,
            tckpt.llm_params_from_jax(tree, device="cpu"), tcfg)


def carry(jparams):
    return tckpt.llm_params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def scaled_err(got, ref):
    ref = np.asarray(ref, np.float32)
    return np.abs(got.float().numpy() - ref).max() / max(1.0, np.abs(ref).max())


def test_prompt_buckets_and_helpers_match_jax():
    assert tserve.PROMPT_BUCKETS == jserve.PROMPT_BUCKETS
    for n in (1, 32, 33, 2048, 2049, 5000):
        assert tserve.bucket_prompt_pad(n) == jserve.bucket_prompt_pad(n)
    assert tserve._LLAMA_ATTN_KEYS == jserve._LLAMA_ATTN_KEYS
    for key in ("q_kernel_q", "qkv_kernel_scale", "gate_kernel_q4", "ln1", "o_kernel_lora_a"):
        assert tserve._base_key(key) == jserve._base_key(key)
    _, jcfg, _, tcfg = make_model(pruned_attention_blocks=(1,))
    assert tserve.num_attn_layers(tcfg) == jserve.num_attn_layers(jcfg) == 1
    # the contiguous cache has one row per surviving attention layer, as the JAX package's
    for t, j in zip(tserve.init_cache(tcfg, 2, 5, torch.float32, device="cpu"),
                    jserve.init_cache(jcfg, 2, 5, jnp.float32)):
        assert tuple(t.shape) == j.shape == (1, 2, 5, 2, 8)


@pytest.mark.parametrize("family", ["tiny-random", "tiny-random-phi", "tiny-random-qwen3"])
def test_block_qkv_at_ragged_positions_matches_jax(family):
    """Per-sequence rotary positions [b, s] (phi: partial rotary + biases;
    qwen3: qk_norm), separate and fused projections."""
    jparams, jcfg, tparams, tcfg = make_model(family, seed=1)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 2, 32)).astype(np.float32)
    pos = np.array([[0, 1], [17, 18], [5, 300]], np.int32)
    for pack in (False, True):
        jp = jserve.pack_llm_params_for_serving(jparams, jcfg) if pack else jparams
        tp = tserve.pack_llm_params_for_serving(tparams, tcfg) if pack else tparams
        jbp = {k: v[1] for k, v in jp["blocks"].items()}
        tbp = {k: v[1] for k, v in tp["blocks"].items()}
        ref = jserve._block_qkv(jnp.asarray(x), jbp, jcfg, jnp.asarray(pos), jnp.float32)
        got = tserve._block_qkv(torch.from_numpy(x), tbp, tcfg, torch.from_numpy(pos),
                                torch.float32)
        for g, r in zip(got, ref):
            assert tuple(g.shape) == r.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5, rtol=0)


def test_pack_llm_params_for_serving_matches_jax_leaf_for_leaf():
    jparams, jcfg, tparams, tcfg = make_model(seed=3)
    cases = [(jparams, tparams),
             (jquant.quantize_llm_params_int8(jparams, jcfg), None),
             (jquant.quantize_llm_params_int4(jparams, jcfg), None)]
    for jp, tp in cases:
        tp = carry(jp) if tp is None else tp
        ref = jserve.pack_llm_params_for_serving(jp, jcfg)
        got = tserve.pack_llm_params_for_serving(tp, tcfg)
        assert set(got["blocks"]) == set(ref["blocks"])
        for k, v in ref["blocks"].items():
            np.testing.assert_array_equal(got["blocks"][k].numpy(), np.asarray(v), err_msg=k)
        assert "q_kernel" in tp["blocks"] or "q_kernel_q" in tp["blocks"] \
            or "q_kernel_q4" in tp["blocks"]                      # the input tree is untouched


def jax_prefill_decode(jparams, jcfg, prompts, cache_dtype, num_pages=16):
    """Prefill each prompt into its own pages, then one decode step of the
    batch: (prefill logits per prompt, decode logits, pools, tables, lens, firsts)."""
    b = len(prompts)
    mp = 4
    kp, vp = jpaged.init_paged_pools(jcfg, num_pages, PS, cache_dtype)
    tables = (1 + np.arange(b * mp).reshape(b, mp)).astype(np.int32)
    pre = []
    for i, p in enumerate(prompts):
        pad = min(jserve.bucket_prompt_pad(len(p)), mp * PS)
        toks = np.zeros((1, pad), np.int32)
        toks[0, :len(p)] = p
        lg, kp, vp = jpaged.paged_prefill(jparams, jnp.asarray(toks), kp, vp, jcfg,
                                          jnp.asarray(tables[i]), jnp.asarray(len(p), jnp.int32))
        pre.append(np.asarray(lg))
    lens = np.array([len(p) for p in prompts], np.int32)
    firsts = np.array([int(np.argmax(lg)) for lg in pre], np.int32)
    dec, kp, vp = jpaged.paged_decode_step(jparams, jnp.asarray(firsts), kp, vp, jcfg,
                                           jnp.asarray(tables), jnp.asarray(lens))
    return pre, np.asarray(dec), (kp, vp), tables, lens, firsts


def torch_prefill_decode(tparams, tcfg, prompts, cache_dtype, tables, firsts, num_pages=16):
    kp, vp = tpaged.init_paged_pools(tcfg, num_pages, PS, cache_dtype)
    pre = []
    for i, p in enumerate(prompts):
        lg, kp, vp = tpaged.paged_prefill(tparams, torch.tensor([p]), kp, vp, tcfg,
                                          torch.from_numpy(tables[i]), len(p))
        pre.append(lg)
    lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32)
    dec, kp, vp = tpaged.paged_decode_step(tparams, torch.from_numpy(firsts).long(), kp, vp, tcfg,
                                           torch.from_numpy(tables), lens)
    return pre, dec, (kp, vp)


def live_rows(pool, tables, lens):
    """The rows of a [A, nkv, P, ps, hd] pool that hold a sequence's tokens."""
    pool = np.asarray(pool, np.float32) if not isinstance(pool, torch.Tensor) \
        else pool.float().numpy()
    out = []
    for i, n in enumerate(lens):
        for pos in range(int(n)):
            out.append(pool[:, :, tables[i, pos // PS], pos % PS])
    return np.stack(out)


FAMILY_CASES = ["tiny-random", "tiny-random-phi", "tiny-random-gemma2", "tiny-random-qwen3",
                "depth-materialized"]


@pytest.mark.parametrize("family", FAMILY_CASES)
def test_paged_prefill_and_decode_step_logits_match_jax(family):
    """fp32 pools: prefill logits of two ragged prompts and the logits of one
    batched decode step, atol 1e-4; the pools' live rows agree too. gemma-2
    has a window of 6 on layer 0 only and both softcaps; the depth-materialized
    model has no attention in block 0 (one pool row for two layers)."""
    if family == "depth-materialized":
        jparams, jcfg, _, tcfg = make_model(seed=4)
        jparams, jcfg = jprune.materialize_llm_depth_pruning(jparams, jcfg, [0])
        tparams = carry(jparams)
        tcfg = dataclasses.replace(tcfg, pruned_attention_blocks=(0,))
    else:
        jparams, jcfg, tparams, tcfg = make_model(family, seed=4)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 128, n).tolist() for n in (11, 5)]
    rpre, rdec, rpools, tables, lens, firsts = jax_prefill_decode(jparams, jcfg, prompts,
                                                                  jnp.float32)
    gpre, gdec, gpools = torch_prefill_decode(tparams, tcfg, prompts, torch.float32, tables, firsts)
    for g, r in zip(gpre, rpre):
        np.testing.assert_allclose(g.numpy(), r, atol=1e-4, rtol=0)
    np.testing.assert_allclose(gdec.numpy(), rdec, atol=1e-4, rtol=0)
    assert gpools[0].shape[0] == tserve.num_attn_layers(tcfg)
    for g, r in zip(gpools, rpools):
        assert tuple(g.shape) == r.shape
        np.testing.assert_allclose(live_rows(g, tables, lens + 1), live_rows(r, tables, lens + 1),
                                   atol=1e-5, rtol=0)
        # the JAX pools carried across are the port's pools
        np.testing.assert_allclose(live_rows(tckpt.pools_from_jax(r, device="cpu"), tables, lens + 1),
                                   live_rows(r, tables, lens + 1), atol=0, rtol=0)


@pytest.mark.parametrize("cache", ["bf16", "int8"])
def test_paged_logits_with_bf16_and_int8_pools_match_jax(cache):
    jparams, jcfg, tparams, tcfg = make_model(seed=6)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 128, n).tolist() for n in (9, 14)]
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if cache == "bf16" else (jnp.int8, torch.int8)
    rpre, rdec, rpools, tables, lens, firsts = jax_prefill_decode(jparams, jcfg, prompts, jdt)
    gpre, gdec, gpools = torch_prefill_decode(tparams, tcfg, prompts, tdt, tables, firsts)
    for g, r in zip(gpre, rpre):
        assert scaled_err(g, r) <= 5e-2
    assert scaled_err(gdec, rdec) <= 5e-2
    carried = tckpt.pools_from_jax(rpools[0], device="cpu")
    if cache == "int8":
        assert carried["q"].dtype == torch.int8 and carried["s"].dtype == torch.float32
        assert gpools[0]["q"].shape == carried["q"].shape
        # codes of the same activations, rounded to bf16 at other places, differ by a few
        # steps at most (page 0 holds the JAX package's padded prompt positions: left out)
        assert np.abs(live_rows(gpools[0]["q"], tables, lens + 1)
                      - live_rows(carried["q"], tables, lens + 1)).max() <= 3
    else:
        assert carried.dtype == torch.bfloat16 and carried.shape == gpools[0].shape


def greedy_prefix(ref_tokens, margins, floor=1e-3):
    """How many generated tokens to compare: up to the first step whose JAX
    top-2 margin is below ``floor``."""
    n = 0
    for m in margins:
        if m < floor:
            break
        n += 1
    return min(n, len(ref_tokens))


@pytest.fixture(scope="module")
def generation():
    """One model, three ragged prompts, and the JAX package's greedy
    continuation of each (``paged_generate``, fp32 pools) with the top-2
    margins of every step, computed once for the tests below."""
    jparams, jcfg, tparams, tcfg = make_model(seed=8)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, 128, n).tolist() for n in (9, 3, 6)]
    new = 7
    ref = jpaged.paged_generate(jparams, jcfg, prompts, max_new_tokens=new, page_size=PS,
                                cache_dtype=jnp.float32)
    margins = []
    for p, out in zip(prompts, ref):
        logits, _ = jmodel.llama_forward(jparams, jnp.asarray(out[None, :-1]), jcfg,
                                         compute_dtype=jnp.float32)
        top2 = np.sort(np.asarray(logits[0, len(p) - 1:]), axis=-1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
    return dict(jparams=jparams, jcfg=jcfg, tparams=tparams, tcfg=tcfg, prompts=prompts, new=new,
                ref=[np.asarray(r) for r in ref], margins=margins)


def assert_same_greedy(gen, got_by_prompt):
    for p, ref, margins, got in zip(gen["prompts"], gen["ref"], gen["margins"], got_by_prompt):
        n = greedy_prefix(ref[len(p):], margins)
        assert n == gen["new"], "a near-tie cut the comparison short: pick another seed"
        np.testing.assert_array_equal(np.asarray(got)[: len(p) + n], ref[: len(p) + n])


def test_paged_generate_tokens_match_jax(generation):
    g = generation
    got = tpaged.paged_generate(g["tparams"], g["tcfg"], g["prompts"], max_new_tokens=g["new"],
                                page_size=PS, cache_dtype=torch.float32)
    assert all(o.dtype == np.int32 for o in got)
    assert_same_greedy(g, got)
    # eos trims the continuation after its first occurrence, as in the JAX package
    eos = int(g["ref"][0][len(g["prompts"][0]) + 2])
    cut = tpaged.paged_generate(g["tparams"], g["tcfg"], g["prompts"][:1], max_new_tokens=g["new"],
                                eos_token_id=eos, page_size=PS, cache_dtype=torch.float32)[0]
    ref = jpaged.paged_generate(g["jparams"], g["jcfg"], g["prompts"][:1],
                                max_new_tokens=g["new"], eos_token_id=eos, page_size=PS,
                                cache_dtype=jnp.float32)[0]
    np.testing.assert_array_equal(cut, np.asarray(ref))
    assert tpaged.paged_generate(g["tparams"], g["tcfg"], g["prompts"][:1],
                                 max_new_tokens=0)[0].tolist() == g["prompts"][0]


SERVER_KW = dict(max_batch=2, num_pages=24, page_size=PS, max_context=32)


def serve_all(server, prompts, new, block, **req):
    """Three requests over two slots: two admitted at once, the third when a
    slot frees; returns the finished sequences in prompt order."""
    ids = [server.add_request(p, max_new_tokens=new, **req) for p in prompts[:2]]
    while all(s.active for s in server.slots):
        server.step_many(block) if block > 1 else server.step()
    ids.append(server.add_request(prompts[2], max_new_tokens=new, **req))
    out = server.run(block)
    return [out[i] for i in ids]


def test_paged_server_run_matches_jax_server_and_generate(generation):
    g = generation
    jsrv = jpaged.PagedServer(g["jparams"], g["jcfg"], cache_dtype=jnp.float32, **SERVER_KW)
    ref = serve_all(jsrv, g["prompts"], g["new"], 4)
    tsrv = tpaged.PagedServer(g["tparams"], g["tcfg"], cache_dtype=torch.float32, **SERVER_KW)
    got = serve_all(tsrv, g["prompts"], g["new"], 4)
    assert_same_greedy(g, got)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, np.asarray(b))
    # the accounting is the same plain Python: same pages handed out, same free list
    assert tsrv.free_pages == jsrv.free_pages and not any(s.active for s in tsrv.slots)
    assert tsrv.decode_steps > 0


@pytest.mark.parametrize("variant", ["step", "chunked", "prefix-miss-then-hit", "int8-step-many"])
def test_paged_server_variants_give_the_same_tokens(generation, variant):
    """``step`` == ``step_many``; chunked == whole prefill; a prefix-cache hit
    == a miss; int8 pools: ``step`` == ``step_many`` (same quantizer, same codes)."""
    g = generation
    if variant == "int8-step-many":
        a = serve_all(tpaged.PagedServer(g["tparams"], g["tcfg"], cache_dtype=torch.int8,
                                         **SERVER_KW), g["prompts"], g["new"], 1)
        b = serve_all(tpaged.PagedServer(g["tparams"], g["tcfg"], cache_dtype=torch.int8,
                                         **SERVER_KW), g["prompts"], g["new"], 3)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        return
    kw = dict(SERVER_KW, cache_dtype=torch.float32)
    if variant == "step":
        got = serve_all(tpaged.PagedServer(g["tparams"], g["tcfg"], **kw), g["prompts"], g["new"], 1)
    elif variant == "chunked":
        got = serve_all(tpaged.PagedServer(g["tparams"], g["tcfg"], chunked_prefill=4, **kw),
                        g["prompts"], g["new"], 4)
    else:
        srv = tpaged.PagedServer(g["tparams"], g["tcfg"], prefix_cache=True, **kw)
        got = serve_all(srv, g["prompts"], g["new"], 4)
        assert srv.prefix_hit_pages == 0
        again = serve_all(srv, g["prompts"], g["new"], 4)      # every full page now cached
        assert srv.prefix_hit_pages == sum((len(p) - 1) // PS for p in g["prompts"])
        for x, y in zip(got, again):
            np.testing.assert_array_equal(x, y)
    assert_same_greedy(g, got)


def test_admission_reserve_eviction_and_cancel_match_jax(generation):
    """The same requests against both servers: page ids, the free list, the
    prefix registry and every refusal agree step by step."""
    g = generation
    kw = dict(max_batch=3, num_pages=9, page_size=PS, max_context=24, prefix_cache=True)
    jsrv = jpaged.PagedServer(g["jparams"], g["jcfg"], cache_dtype=jnp.float32, **kw)
    tsrv = tpaged.PagedServer(g["tparams"], g["tcfg"], cache_dtype=torch.float32, **kw)

    def both(fn):
        out = []
        for srv in (jsrv, tsrv):
            try:
                out.append(("ok", fn(srv)))
            except (RuntimeError, ValueError) as e:
                out.append((type(e).__name__, str(e)))
        assert out[0] == out[1], out
        return out[1]

    def same_state():
        assert tsrv.free_pages == jsrv.free_pages
        assert [s.pages for s in tsrv.slots] == [s.pages for s in jsrv.slots]
        assert [s.reserved for s in tsrv.slots] == [s.reserved for s in jsrv.slots]
        assert tsrv._registry == jsrv._registry and list(tsrv._lru) == list(jsrv._lru)
        assert tsrv._page_refs == jsrv._page_refs
        assert tsrv.prefix_hit_pages == jsrv.prefix_hit_pages

    long = list(range(1, 10))
    assert both(lambda s: s.add_request(long, max_new_tokens=40))[0] == "ValueError"   # max_context
    assert both(lambda s: s.add_request(long, max_new_tokens=6)) == ("ok", 0)          # 4 pages
    same_state()
    assert both(lambda s: s.add_request(long[:5] + [99], max_new_tokens=10)) == ("ok", 1)  # shares page 1
    same_state()
    # 8 usable pages, 4 + 3 (one shared) reserved: a third request of 2 pages does not fit
    assert both(lambda s: s.add_request([7, 8, 9], max_new_tokens=5)) == \
        ("RuntimeError", "page pool exhausted")
    both(lambda s: s.step_many(3))
    same_state()
    assert both(lambda s: s.cancel(0)) == ("ok", True)
    assert both(lambda s: s.cancel(0)) == ("ok", False)
    same_state()
    assert both(lambda s: s.add_request([7, 8, 9], max_new_tokens=5)) == ("ok", 2)
    both(lambda s: (s.run(4), None)[1])
    same_state()
    # the cached prefix pages are evicted, oldest first, once the free list runs dry
    assert both(lambda s: s.add_request(list(range(50, 70)), max_new_tokens=4)) == ("ok", 3)
    same_state()
    both(lambda s: (s.run(2), None)[1])
    same_state()
    for a in jsrv.finished:
        np.testing.assert_array_equal(tsrv.finished[a], np.asarray(jsrv.finished[a]))
    three = [tsrv.add_request([1, 2], max_new_tokens=5) for _ in range(3)]
    assert len(three) == 3
    with pytest.raises(RuntimeError, match="no free slot"):
        tsrv.add_request([1, 2], max_new_tokens=2)


def test_unsupported_configs_raise():
    _, _, tparams, tcfg = make_model()
    with pytest.raises(ValueError, match="llama-layout and phi"):
        tpaged.init_paged_pools(dataclasses.replace(tcfg, model_type="opt"), 4, PS)
    with pytest.raises(TypeError, match="LlamaConfig"):
        tpaged.paged_generate(tparams, object(), [[1, 2]])
    # MoE configs (once refused naming ROADMAP.md A.11c) serve: a top-2 model's
    # paged tokens are the JAX package's
    jp, jc, tp, tc = make_model(seed=4, num_experts=4, moe_top_k=2)
    prompts = [np.asarray([3, 5, 7], np.int32), np.asarray([2, 4, 6, 8, 10], np.int32)]
    want = jpaged.paged_generate(jp, jc, prompts, max_new_tokens=6, cache_dtype=jnp.float32,
                                 page_size=PS)
    got = tpaged.paged_generate(tp, tc, prompts, max_new_tokens=6, cache_dtype=torch.float32,
                                page_size=PS)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
