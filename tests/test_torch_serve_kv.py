"""The port's contiguous KV serving path (``llm/serve.py``: ``init_cache``,
``prefill``, ``decode_step``, the rolling and int8 caches,
``generate_kv_scan`` / ``decode_while`` / ``greedy_generate_kv``) against the
JAX package on the CPU.

Weights come from a numpy seed and cross over through ``llm_params_from_jax``,
caches through ``caches_from_jax``. fp32 runs the same arithmetic in another
summation order: logits atol 1e-4, cache rows atol 1e-5. An int8 cache
computes in bf16, which the two frameworks round at other places: logits
and the dequantized cache within 5e-2 of max(1, max |reference|); the int8
write itself is bit for bit on the same inputs. Greedy tokens are compared
token for token; the tests assert that the JAX package's own top-2 logit
margin exceeds 1e-3 wherever a token is chosen, so no near-tie decides a
comparison. Sampled rows draw from another random
stream than JAX's: they are held to same-seed reproducibility and to the
filtered support, as ``tests/test_torch_serving.py`` holds the server's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssp_x_vit_tpu.llm import model as jmodel
from ssp_x_vit_tpu.llm import pruning as jprune
from ssp_x_vit_tpu.llm import quant as jquant
from ssp_x_vit_tpu.llm import serve as jserve
from ssp_x_vit_tpu_torch.cli.main_llm import _TINY_VARIANTS
from ssp_x_vit_tpu_torch.llm import checkpoints as tckpt
from ssp_x_vit_tpu_torch.llm import model as tmodel
from ssp_x_vit_tpu_torch.llm import sampling as tsamp
from ssp_x_vit_tpu_torch.llm import serve as tserve

SMALL = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2,
             intermediate_size=48)


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


def model_for(case, seed):
    if case == "depth-materialized":
        jparams, jcfg, _, tcfg = make_model(seed=seed)
        jparams, jcfg = jprune.materialize_llm_depth_pruning(jparams, jcfg, [0])
        return jparams, jcfg, carry(jparams), dataclasses.replace(tcfg, pruned_attention_blocks=(0,))
    if case == "rolling":
        return make_model(seed=seed, sliding_window=5)
    if case == "int8-weights":
        jparams, jcfg, _, tcfg = make_model(seed=seed)
        jparams = jquant.quantize_llm_params_int8(jparams, jcfg)
        return jparams, jcfg, carry(jparams), tcfg
    family = "tiny-random" if case in ("int8-cache",) else case
    return make_model(family, seed=seed)


def cache_rows(cache):
    """A cache (array, tensor or int8 dict) as float32 numpy leaves."""
    if isinstance(cache, dict):
        return {k: cache_rows(v) for k, v in cache.items()}
    if isinstance(cache, torch.Tensor):
        return cache.numpy()
    return np.asarray(cache)


CASES = ["tiny-random", "tiny-random-phi", "tiny-random-opt", "tiny-random-gemma2",
         "tiny-random-qwen3", "depth-materialized", "int8-cache", "rolling", "int8-weights"]


@pytest.mark.parametrize("case", CASES)
def test_prefill_and_decode_step_logits_match_jax(case):
    """Two left-padded prompts (lengths 9 and 4, padded to 12), a prefill and
    three decode steps fed the same tokens: logits and the caches after every
    call, at the tolerances of the module docstring. gemma-2 has a
    window of 6 on layer 0 only and both softcaps; the rolling cache holds 5
    slots of a window-5 model; the depth-materialized tree has no attention in
    block 0; the int8-weight tree runs its MLPs through ``fused_mlp_int8``."""
    jparams, jcfg, tparams, tcfg = model_for(case, seed=4)
    rng = np.random.default_rng(5)
    b, p_pad = 2, 12
    lens = np.array([9, 4])
    tokens = np.zeros((b, p_pad), np.int32)
    for i, n in enumerate(lens):
        tokens[i, p_pad - n:] = rng.integers(0, 128, n)
    pad_lens = (p_pad - lens).astype(np.int32)
    rolling = 5 if case == "rolling" else None
    cache_dtype = jnp.int8 if case == "int8-cache" else jnp.float32
    if rolling:
        jk, jv = jserve.init_rolling_cache(jcfg, b, cache_dtype)
        tk, tv = tserve.init_rolling_cache(tcfg, b, torch.float32, device="cpu")
    else:
        jk, jv = jserve.init_cache(jcfg, b, p_pad + 4, cache_dtype)
        tk, tv = tserve.init_cache(tcfg, b, p_pad + 4,
                                   torch.int8 if case == "int8-cache" else torch.float32,
                                   device="cpu")
    ck, cv = tckpt.caches_from_jax(jax.tree.map(np.asarray, jk), jax.tree.map(np.asarray, jv),
                                   device="cpu")
    for a, r in ((ck, tk), (cv, tv)):
        for x, y in zip(jax.tree.leaves(cache_rows(a)), jax.tree.leaves(cache_rows(r))):
            np.testing.assert_array_equal(x, y)           # the port's fresh cache == JAX's

    def check_caches(jcaches, tcaches):
        for jc, tc in zip(jcaches, tcaches):
            jr, tr = cache_rows(jc), cache_rows(tc)
            if isinstance(jr, dict):   # from bf16 k/v that round at other places
                deq_t, deq_j = tr["q"] * tr["s"][..., None], jr["q"] * jr["s"][..., None]
                assert np.abs(deq_t - deq_j).max() / max(1.0, np.abs(deq_j).max()) <= 5e-2
            else:
                np.testing.assert_allclose(tr, jr, atol=1e-5, rtol=0)

    def check_logits(got, ref):
        ref = np.asarray(ref)
        if case == "int8-cache":
            assert np.abs(got.float().numpy() - ref).max() / max(1.0, np.abs(ref).max()) <= 5e-2
        else:
            np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=0)

    ref, jk, jv = jserve.prefill(jparams, jnp.asarray(tokens), jk, jv, jcfg,
                                 jnp.asarray(pad_lens), rolling=rolling)
    got, ck2, cv2 = tserve.prefill(tparams, torch.from_numpy(tokens).long(), ck, cv, tcfg,
                                   torch.from_numpy(pad_lens).long(), rolling=rolling)
    assert ck2 is ck and cv2 is cv                                  # written in place
    check_logits(got, ref)
    check_caches((jk, jv), (ck, cv))
    feed = rng.integers(0, 128, (3, b))
    for t in range(3):
        pos = p_pad + t
        ref, jk, jv = jserve.decode_step(jparams, jnp.asarray(feed[t], jnp.int32), jk, jv, jcfg,
                                         jnp.asarray(pos, jnp.int32), jnp.asarray(pad_lens),
                                         rolling=rolling)
        got, ck, cv = tserve.decode_step(tparams, torch.from_numpy(feed[t]).long(), ck, cv, tcfg,
                                         pos, torch.from_numpy(pad_lens).long(), rolling=rolling)
        check_logits(got, ref)
        check_caches((jk, jv), (ck, cv))


@pytest.mark.parametrize("layer_idx", [None, 1])
def test_int8_cache_write_is_bit_identical_to_jax(layer_idx):
    """The same bf16 k/v rows written into int8 caches (4D, and row 1 of 5D
    caches) at position 3: codes and scales bit for bit, the rest untouched."""
    rng = np.random.default_rng(11)
    shape = (2, 2, 9, 2, 8) if layer_idx is not None else (2, 9, 2, 8)
    k = rng.normal(size=(2, 4, 2, 8)).astype(np.float32)
    v = (3 * rng.normal(size=(2, 4, 2, 8))).astype(np.float32)
    v[0, 1, 1] = 0.0                                   # an all-zero row: scale 1, codes 0

    def empty():
        return {"q": np.zeros(shape, np.int8), "s": np.ones(shape[:-1], np.float32)}

    jk, jv = jax.tree.map(jnp.asarray, (empty(), empty()))
    jk, jv = jserve._write_cache(jk, jv, jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16),
                                 3, None if layer_idx is None else jnp.asarray(layer_idx))
    tk, tv = tckpt.caches_from_jax(empty(), empty(), device="cpu")
    out = tserve._write_cache(tk, tv, torch.from_numpy(k).bfloat16(),
                              torch.from_numpy(v).bfloat16(), 3, layer_idx)
    assert out[0] is tk and out[1] is tv
    for j, t in ((jk, tk), (jv, tv)):
        np.testing.assert_array_equal(t["q"].numpy(), np.asarray(j["q"]))
        np.testing.assert_array_equal(t["s"].numpy(), np.asarray(j["s"]))


def top2_margins(jparams, jcfg, seq_tokens, prompt_len):
    """The JAX full forward's top-2 logit margin at every generated position."""
    logits = np.asarray(jmodel.llama_forward(jparams, jnp.asarray([seq_tokens]), jcfg,
                                             compute_dtype=jnp.float32)[0][0])
    srt = np.sort(logits[prompt_len - 1:len(seq_tokens) - 1], axis=-1)
    return srt[:, -1] - srt[:, -2]


@pytest.fixture(scope="module")
def llama():
    return make_model(seed=7)


@pytest.fixture(scope="module")
def ragged_prompts():
    rng = np.random.default_rng(8)
    return [rng.integers(1, 128, n).tolist() for n in (7, 3, 12)]


@pytest.mark.parametrize("tree", ["float", "int8-weights"])
def test_generate_kv_scan_greedy_tokens_match_jax(llama, ragged_prompts, tree, monkeypatch):
    """Ragged left-padded prompts, fp32 cache, greedy: the port's tokens equal
    the JAX package's token for token (and ``greedy_generate_kv``'s). The
    int8-weight tree takes the fused route: ``fused_mlp_int8`` runs once per
    layer and forward (its plain version here, on CPU tensors)."""
    jparams, jcfg, tparams, tcfg = llama
    if tree == "int8-weights":
        jparams = jquant.quantize_llm_params_int8(jparams, jcfg)
        tparams = carry(jparams)
    calls = []
    real = tserve.fused_mlp_int8
    monkeypatch.setattr(tserve, "fused_mlp_int8", lambda *a: calls.append(1) or real(*a))
    kw = dict(max_length=20)
    ref = jserve.generate_kv_scan(jparams, jcfg, ragged_prompts, cache_dtype=jnp.float32, **kw)
    got = tserve.generate_kv_scan(tparams, tcfg, ragged_prompts, cache_dtype=torch.float32, **kw)
    per_step = tserve.greedy_generate_kv(tparams, tcfg, ragged_prompts, cache_dtype=torch.float32,
                                         **kw)
    for g, r, s, p in zip(got, ref, per_step, ragged_prompts):
        np.testing.assert_array_equal(g, np.asarray(r))
        np.testing.assert_array_equal(s, np.asarray(r))
        assert len(g) == 20
        if tree == "float":
            assert top2_margins(jparams, jcfg, np.asarray(r).tolist(), len(p)).min() > 1e-3
    steps = 20 - 3 - 1                  # decode steps: max_length - shortest prompt - 1
    fused = 2 * tcfg.num_layers * (1 + steps)           # both generators, prefill included
    assert len(calls) == (fused if tree == "int8-weights" else 0)


def test_decode_while_stops_at_eos_and_matches_jax(llama, ragged_prompts, monkeypatch):
    """An eos that the greedy continuation emits early: ``decode_while``
    (every sync interval) trims to the same outputs as the JAX package's
    in-graph while loop and the port's own ``decode_scan``; the rolling cache
    and a single 1-D prompt too."""
    jparams, jcfg, tparams, tcfg = llama
    full = tserve.generate_kv_scan(tparams, tcfg, ragged_prompts, max_length=20,
                                   cache_dtype=torch.float32)
    eos = int(full[0][len(ragged_prompts[0]) + 2])       # row 0's third generated token
    ref = jserve.generate_kv_scan(jparams, jcfg, ragged_prompts, max_length=20,
                                  eos_token_id=eos, cache_dtype=jnp.float32)
    for early_stop in (True, False):
        got = tserve.generate_kv_scan(tparams, tcfg, ragged_prompts, max_length=20,
                                      eos_token_id=eos, cache_dtype=torch.float32,
                                      early_stop=early_stop)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, np.asarray(r))
    assert got[0][-1] == eos and len(got[0]) <= len(ragged_prompts[0]) + 3
    b, p_pad = 3, 12
    tokens, pad_lens, lens, _ = tserve._prepare_prompts(ragged_prompts, 20)
    pads = torch.from_numpy(pad_lens).long()
    outs = []
    for every in (1, 3, 64):
        monkeypatch.setattr(tserve, "DECODE_WHILE_SYNC_EVERY", every)
        ck, cv = tserve.init_cache(tcfg, b, 24, torch.float32, device="cpu")
        logits, ck, cv = tserve.prefill(tparams, torch.from_numpy(tokens).long(), ck, cv, tcfg, pads)
        toks, _, _ = tserve.decode_while(tparams, logits.argmax(-1), ck, cv, tcfg, p_pad, pads, 10,
                                         eos)
        outs.append(toks.numpy())
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], outs[2])
    single = tserve.generate_kv_scan(tparams, tcfg, np.asarray(ragged_prompts[2]), max_length=16,
                                     cache_dtype=torch.float32)
    np.testing.assert_array_equal(single, np.asarray(jserve.generate_kv_scan(
        jparams, jcfg, np.asarray(ragged_prompts[2]), max_length=16, cache_dtype=jnp.float32)))


def test_rolling_generation_matches_jax_and_the_full_cache():
    """A window-5 model: ``rolling=True`` (5-slot cache) gives the JAX
    package's tokens and the same tokens as the full cache."""
    jparams, jcfg, tparams, tcfg = make_model(seed=9, sliding_window=5)
    prompts = [[5, 9, 2, 77, 31, 8, 100], [3, 4]]
    ref = jserve.generate_kv_scan(jparams, jcfg, prompts, max_length=18, rolling=True,
                                  cache_dtype=jnp.float32)
    got = tserve.generate_kv_scan(tparams, tcfg, prompts, max_length=18, rolling=True,
                                  cache_dtype=torch.float32)
    full = tserve.generate_kv_scan(tparams, tcfg, prompts, max_length=18,
                                   cache_dtype=torch.float32)
    for g, r, f in zip(got, ref, full):
        np.testing.assert_array_equal(g, np.asarray(r))
        np.testing.assert_array_equal(g, f)
    with pytest.raises(ValueError, match="uniform"):
        tserve.generate_kv_scan(*make_model("tiny-random-gemma2")[2:], prompts, rolling=True)


def test_sampled_rows_reproduce_per_seed_and_stay_in_the_filtered_support(llama, ragged_prompts):
    """Sampling (top-k 3, repetition penalty): the same seed gives the same
    tokens, every sampled token lies among the top 3 of the penalized logits
    at its step (recomputed with ``decode_step``), and greedy sampling with the
    penalty equals the JAX package's greedy-with-penalty tokens."""
    jparams, jcfg, tparams, tcfg = llama
    from ssp_x_vit_tpu.llm import sampling as jsamp

    sp = tsamp.SamplingParams(temperature=0.9, top_k=3, repetition_penalty=1.3)
    a = tserve.generate_kv_scan(tparams, tcfg, ragged_prompts, max_length=16, sampling=sp,
                                rng=5, cache_dtype=torch.float32)
    b = tserve.generate_kv_scan(tparams, tcfg, ragged_prompts, max_length=16, sampling=sp,
                                rng=5, cache_dtype=torch.float32)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    for p, seq in zip(ragged_prompts, a):
        seq = seq.tolist()
        ck, cv = tserve.init_cache(tcfg, 1, 16, torch.float32, device="cpu")
        logits, ck, cv = tserve.prefill(tparams, torch.tensor([p]), ck, cv, tcfg, torch.zeros(1).long())
        for t in range(len(p), len(seq)):
            seen = torch.zeros(tcfg.vocab_size, dtype=torch.bool)
            seen[torch.tensor(seq[:t])] = True
            z = logits[0]
            z = torch.where(seen, torch.where(z > 0, z / 1.3, z * 1.3), z)
            assert seq[t] in z.topk(3).indices.tolist()
            if t + 1 < len(seq):
                logits, ck, cv = tserve.decode_step(tparams, torch.tensor([seq[t]]), ck, cv, tcfg,
                                                    t, torch.zeros(1).long())
    greedy = tsamp.SamplingParams(repetition_penalty=1.3)
    got = tserve.generate_kv_scan(tparams, tcfg, ragged_prompts, max_length=16, sampling=greedy,
                                  cache_dtype=torch.float32)
    ref = jserve.generate_kv_scan(jparams, jcfg, ragged_prompts, max_length=16,
                                  sampling=jsamp.SamplingParams(repetition_penalty=1.3),
                                  cache_dtype=jnp.float32)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, np.asarray(r))


def test_helpers_and_unported_parts():
    """Prompt preparation and trimming equal the JAX package's; init_cache
    refuses to place a cache without a GPU unless asked for the CPU; lora_ids
    (once refused naming ROADMAP.md A.10) select each row's adapter of an
    attached bank, and without a bank serve the base model; an MoE model
    generates the JAX tokens."""
    for prompts in ([[1, 2, 3], [4]], np.arange(5), [7, 8]):
        for x, y in zip(tserve._prepare_prompts(prompts, 40), jserve._prepare_prompts(prompts, 40)):
            np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError, match="max_length"):
        tserve._prepare_prompts([[1] * 10], 10)
    _, _, tparams, tcfg = make_model(seed=1)
    from ssp_x_vit_tpu_torch.llm.lora import init_lora, merge_lora
    from ssp_x_vit_tpu_torch.llm.multilora import attach_lora_bank, build_lora_bank

    adapter = init_lora(torch.Generator().manual_seed(4), tparams, rank=2)
    for ab in adapter.values():
        ab["b"] = 0.5 * torch.randn(ab["b"].shape, generator=torch.Generator().manual_seed(5))
    served = attach_lora_bank(tparams, build_lora_bank([adapter]))
    kw = dict(max_length=10, cache_dtype=torch.float32)
    got = tserve.generate_kv_scan(served, tcfg, [[1, 2], [1, 2]], lora_ids=[1, 0], **kw)
    np.testing.assert_array_equal(got[0], tserve.generate_kv_scan(
        merge_lora(tparams, adapter), tcfg, [1, 2], **kw))
    np.testing.assert_array_equal(got[1], tserve.generate_kv_scan(tparams, tcfg, [1, 2], **kw))
    np.testing.assert_array_equal(
        tserve.generate_kv_scan(tparams, tcfg, [1, 2], lora_ids=[0], **kw), got[1])
    # MoE configs (once refused naming ROADMAP.md A.11c) generate: a top-1
    # model's greedy tokens are the JAX package's
    jp, jc, tp, tc = make_model(seed=2, num_experts=2)
    want = jserve.generate_kv_scan(jp, jc, np.asarray([1, 2, 3], np.int32), max_length=10,
                                   cache_dtype=jnp.float32)
    got = tserve.generate_kv_scan(tp, tc, [1, 2, 3], max_length=10, cache_dtype=torch.float32)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    with pytest.raises(ValueError, match="sliding_window"):
        tserve.init_rolling_cache(tcfg, 1, device="cpu")
