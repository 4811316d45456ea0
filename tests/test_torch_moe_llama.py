"""The port's llama-family mixture of experts (mixtral / qwen3_moe layout:
``llm/model.py`` ``_moe_mlp`` over ``parallel/moe.py``) against the JAX package
on the CPU, mirroring ``tests/test_moe_llama.py``'s single-device cases.

Tiny models (2 layers, hidden 32, 4 query heads over 2 KV heads, 4 experts of
width 48) with numpy-seeded weights in the JAX tree layout, carried across by
``llm_params_from_jax``:

- fp32 logits and the per-layer ``moe_aux_loss`` at top-1, 2 and 3 (1e-4 of
  max(1, max |JAX|)), gated, with int8 and packed-int4 expert stacks, and
  the bf16 forward (scaled error 5e-2); E = 1 equals the dense model.
- the JAX guards with JAX's exception types: phi / opt, neuron masks and MLP
  statistics, the materialized forward and depth materialization.
- generation token for token against the JAX package in fp32: contiguous
  ``generate_kv_scan`` (fp32 and int8 caches; float, int8, int4 and packed
  int8 trees), paged, beam search over the cache, and speculative decoding
  with the model as its own draft (acceptance 1.0).
- the train step: three updates' losses (1e-5 relative) and gradients (1e-4
  of max(1, max |grad|)) against ``jax.value_and_grad``, remat on and off
  the same bits, the ``Trainer`` loop.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ssp_x_vit_tpu.llm import generate as jgen
from ssp_x_vit_tpu.llm import model as jmodel
from ssp_x_vit_tpu.llm import paged as jpaged
from ssp_x_vit_tpu.llm import pruning as jprune
from ssp_x_vit_tpu.llm import quant as jquant
from ssp_x_vit_tpu.llm import serve as jserve
from ssp_x_vit_tpu.llm import speculative as jspec
from ssp_x_vit_tpu.llm import train as jtrain
from ssp_x_vit_tpu.llm import trainer as jtrainer
from ssp_x_vit_tpu_torch.llm import checkpoints as tckpt
from ssp_x_vit_tpu_torch.llm import generate as tgen
from ssp_x_vit_tpu_torch.llm import model as tmodel
from ssp_x_vit_tpu_torch.llm import paged as tpaged
from ssp_x_vit_tpu_torch.llm import pruning as tprune
from ssp_x_vit_tpu_torch.llm import quant as tquant
from ssp_x_vit_tpu_torch.llm import serve as tserve
from ssp_x_vit_tpu_torch.llm import speculative as tspec
from ssp_x_vit_tpu_torch.llm import train as ttrain
from ssp_x_vit_tpu_torch.llm import trainer as ttrainer
from ssp_x_vit_tpu_torch.llm.optim import AdamW, tree_leaves

BASE = dict(vocab_size=96, hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2,
            intermediate_size=48, num_experts=4)
TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's tiny tensors: the suite runs six
    workers on the host's cores, where a pool per worker only contends."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_model(seed=0, **overrides):
    """(jax params, jax cfg, torch params, torch cfg): kernels ~ N(0, 0.1), the
    router ~ N(0, 0.5) (decisive routing), norm scales ~ 1 + N(0, 0.1)."""
    kw = dict(BASE, **overrides)
    jcfg, tcfg = jmodel.LlamaConfig(**kw), tmodel.LlamaConfig(**kw)
    shapes = jax.eval_shape(lambda: jmodel.init_llama_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(seed)

    def leaf(name, shape):
        if name.startswith("ln") or name.endswith("_norm"):
            return (1 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        return ((0.5 if name == "router" else 0.1) * rng.normal(size=shape)).astype(np.float32)

    tree = {k: ({kk: leaf(kk, vv.shape) for kk, vv in v.items()} if isinstance(v, dict)
                else leaf(k, v.shape)) for k, v in shapes.items()}
    return (jax.tree.map(jnp.asarray, tree), jcfg,
            tckpt.llm_params_from_jax(tree, device="cpu"), tcfg)


def carry(jtree):
    return tckpt.llm_params_from_jax(jax.tree.map(np.asarray, jtree), device="cpu")


def tokens(seed, b=2, s=20):
    return np.random.default_rng(seed).integers(0, BASE["vocab_size"], (b, s)).astype(np.int32)


def scaled(got, ref):
    ref = np.asarray(ref, np.float32)
    return float(np.abs(got.float().detach().numpy() - ref).max()) / max(1.0, np.abs(ref).max())


def forward_both(jp, jc, tp, tc, ids, **kw):
    ref, jaux = jmodel.llama_forward(jp, jnp.asarray(ids), jc, compute_dtype=jnp.float32,
                                     **{k: jnp.asarray(v) for k, v in kw.items()})
    got, taux = tmodel.llama_forward(tp, torch.from_numpy(ids).long(), tc,
                                     compute_dtype=torch.float32,
                                     **{k: torch.from_numpy(v) for k, v in kw.items()})
    return (got, taux["moe_aux_loss"]), (ref, jaux["moe_aux_loss"])


@pytest.mark.parametrize("top_k", [1, 2, 3])
@pytest.mark.parametrize("tree", ["float", "int8", "int4"])
def test_logits_and_aux_loss_match_jax(top_k, tree):
    jp, jc, tp, tc = make_model(seed=top_k, moe_top_k=top_k)
    if tree != "float":
        quantize = getattr(jquant, f"quantize_llm_params_{tree}")
        jp = quantize(jp, jc)
        tp = carry(jp)
        assert "router" in tp["blocks"] and tp["blocks"]["gate_kernel_scale"].shape == (2, 4, 48)
    (got, got_aux), (ref, ref_aux) = forward_both(jp, jc, tp, tc, tokens(top_k))
    assert scaled(got, ref) <= TOL and scaled(got_aux, ref_aux) <= TOL
    assert got_aux.shape == (2,)


def test_gated_and_bf16_forwards_match_jax():
    jp, jc, tp, tc = make_model(seed=7, moe_top_k=2)
    ids = tokens(8)
    gates = dict(attn_gate=np.asarray([1.0, 0.0], np.float32),
                 mlp_gate=np.asarray([0.5, 1.0], np.float32))
    (got, got_aux), (ref, ref_aux) = forward_both(jp, jc, tp, tc, ids, **gates)
    assert scaled(got, ref) <= TOL and scaled(got_aux, ref_aux) <= TOL
    ref16, _ = jmodel.llama_forward(jp, jnp.asarray(ids), jc)
    got16, _ = tmodel.llama_forward(tp, torch.from_numpy(ids).long(), tc)
    assert scaled(got16, ref16) <= 5e-2


def test_single_expert_equals_the_dense_model():
    _, _, dense, dcfg = make_model(seed=9, num_experts=0)
    moe = {k: v for k, v in dense.items() if k != "blocks"}
    moe["blocks"] = dict(dense["blocks"])
    for k in ("gate_kernel", "up_kernel", "down_kernel"):
        moe["blocks"][k] = dense["blocks"][k][:, None]
    moe["blocks"]["router"] = torch.zeros(2, 32, 1)
    ids = torch.from_numpy(tokens(10)).long()
    ld, _ = tmodel.llama_forward(dense, ids, dcfg, compute_dtype=torch.float32)
    lm, aux = tmodel.llama_forward(moe, ids, dataclasses.replace(dcfg, num_experts=1),
                                   compute_dtype=torch.float32)
    torch.testing.assert_close(lm, ld, rtol=1e-5, atol=1e-5)
    assert aux["moe_aux_loss"].shape == (2,)


def test_guards_raise_as_the_jax_package_does():
    jp, jc, tp, tc = make_model(seed=11)
    ids = tokens(12, b=1, s=8)
    cases = [
        (lambda p, c, m: m.llama_forward(p, ids if m is jmodel else torch.from_numpy(ids).long(),
                                         dataclasses.replace(c, model_type="phi")),
         "llama block layout"),
        (lambda p, c, m: m.llama_forward(p, ids if m is jmodel else torch.from_numpy(ids).long(),
                                         c, collect_mlp_stats=True), "dense MLPs"),
        (lambda p, c, m: m.llama_forward(
            p, ids if m is jmodel else torch.from_numpy(ids).long(), c,
            neuron_mask=(jnp if m is jmodel else torch).ones((2, 48))), "dense MLPs"),
        (lambda p, c, m: m.llama_forward_materialized(
            p, ids if m is jmodel else torch.from_numpy(ids).long(),
            dataclasses.replace(c, pruned_attention_blocks=(1,))), "depth materialization"),
    ]
    for fn, match in cases:
        for p, c, m in ((jp, jc, jmodel), (tp, tc, tmodel)):
            with pytest.raises(ValueError, match=match):
                fn(p, c, m)
    for p, c, m in ((jp, jc, jprune), (tp, tc, tprune)):
        with pytest.raises(ValueError, match="2SSP targets"):
            m.materialize_llm_depth_pruning(p, c, [1])


PROMPT = np.asarray([3, 5, 7, 11, 13], np.int32)


@pytest.mark.parametrize("case", ["top1", "top2", "int8_cache", "int8_tree", "int4_tree",
                                  "packed_int8"])
def test_contiguous_generation_matches_jax(case):
    top_k = 1 if case == "top1" else 2
    jp, jc, tp, tc = make_model(seed=20 + top_k, moe_top_k=top_k)
    jdt, tdt = (jnp.int8, torch.int8) if case == "int8_cache" else (jnp.float32, torch.float32)
    if case in ("int8_tree", "int4_tree", "packed_int8"):
        jp = getattr(jquant, "quantize_llm_params_" + ("int4" if case == "int4_tree" else "int8"))(
            jp, jc)
        if case == "packed_int8":
            jp = jserve.pack_llm_params_for_serving(jp, jc)
            assert "qkv_kernel_q" in jp["blocks"] and "gate_kernel_q" in jp["blocks"]
        tp = carry(jp)
    want = jserve.generate_kv_scan(jp, jc, PROMPT, max_length=16, cache_dtype=jdt)
    got = tserve.generate_kv_scan(tp, tc, PROMPT, max_length=16, cache_dtype=tdt)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    if tdt == torch.float32 and case != "packed_int8":  # the cached decode == a full recompute
        full = tgen.greedy_generate(tp, tc, PROMPT, max_length=16, no_repeat_ngram_size=0,
                                    compute_dtype=torch.float32)
        np.testing.assert_array_equal(np.asarray(got), full)


def test_packing_leaves_the_expert_stacks_unfused():
    _, _, tp, tc = make_model(seed=25, moe_top_k=2)
    for tree in (tp, tquant.quantize_llm_params_int8(tp, tc)):
        packed = tserve.pack_llm_params_for_serving(tree, tc)
        assert any(k.startswith("qkv_kernel") for k in packed["blocks"])
        assert not any(k.startswith("gateup") for k in packed["blocks"])
        a = tserve.generate_kv_scan(tree, tc, PROMPT, max_length=12, cache_dtype=torch.float32)
        b = tserve.generate_kv_scan(packed, tc, PROMPT, max_length=12, cache_dtype=torch.float32)
        np.testing.assert_array_equal(a, b)
    assert not tserve._fused_int8_route(tquant.quantize_llm_params_int8(tp, tc)["blocks"], tc)


@pytest.mark.parametrize("cache", ["fp32", "int8"])
def test_paged_generation_matches_jax_and_contiguous(cache):
    jp, jc, tp, tc = make_model(seed=30, moe_top_k=2)
    jdt, tdt = (jnp.int8, torch.int8) if cache == "int8" else (jnp.float32, torch.float32)
    prompts = [np.asarray([3, 5, 7], np.int32), np.asarray([2, 4, 6, 8, 10, 12, 14], np.int32)]
    want = jpaged.paged_generate(jp, jc, prompts, max_new_tokens=8, cache_dtype=jdt,
                                 page_size=4)
    got = tpaged.paged_generate(tp, tc, prompts, max_new_tokens=8, cache_dtype=tdt, page_size=4)
    for p, a, b in zip(prompts, got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        if cache == "fp32":
            ref = tserve.generate_kv_scan(tp, tc, p, max_length=len(p) + 8,
                                          cache_dtype=torch.float32)
            np.testing.assert_array_equal(np.asarray(a), ref)


def test_paged_server_matches_generate():
    _, _, tp, tc = make_model(seed=31, moe_top_k=2)
    prompts = [[3, 5, 7], [2, 4, 6, 8, 10], [9] * 6]
    server = tpaged.PagedServer(tp, tc, max_batch=2, num_pages=24, page_size=4, max_context=32,
                                cache_dtype=torch.float32)
    ids = [server.add_request(p, max_new_tokens=6) for p in prompts[:2]]
    done = server.run(decode_block=2)
    ids.append(server.add_request(prompts[2], max_new_tokens=6))
    done.update(server.run(decode_block=2))
    for rid, p in zip(ids, prompts):
        ref = tserve.generate_kv_scan(tp, tc, p, max_length=len(p) + 6, cache_dtype=torch.float32)
        np.testing.assert_array_equal(np.asarray(done[rid]), ref)


def test_beam_and_speculative_generation_match_jax():
    jp, jc, tp, tc = make_model(seed=40, moe_top_k=2)
    want = jgen.beam_generate_kv(jp, jc, PROMPT, max_length=12, num_beams=3,
                                 cache_dtype=jnp.float32)
    got = tgen.beam_generate_kv(tp, tc, PROMPT, max_length=12, num_beams=3,
                                cache_dtype=torch.float32)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    ref = tserve.generate_kv_scan(tp, tc, PROMPT, max_length=16, cache_dtype=torch.float32)
    out, stats = tspec.speculative_generate(tp, tc, tp, tc, PROMPT, max_length=16, k=3,
                                            cache_dtype=torch.float32)
    jout, jstats = jspec.speculative_generate(jp, jc, jp, jc, PROMPT, max_length=16, k=3,
                                              cache_dtype=jnp.float32)
    np.testing.assert_array_equal(np.asarray(out), ref)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(jout))
    assert stats["acceptance_rate"] == jstats["acceptance_rate"] == 1.0


def batch(seed, b=2, s=16):
    return np.random.default_rng(seed).integers(0, BASE["vocab_size"], (b, s + 1)).astype(np.int32)


def grads_of(params, loss_fn):
    tree, leaves = ttrain.trainable_tree(params)
    loss = loss_fn(tree)
    loss.backward()
    return loss.detach(), [leaf.grad for leaf in leaves]


def jax_leaves(tree):
    return tree_leaves(jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree))


@pytest.mark.parametrize("top_k", [1, 2])
def test_loss_and_gradients_match_jax_with_and_without_remat(top_k):
    jp, jc, tp, tc = make_model(seed=50 + top_k, moe_top_k=top_k, router_aux_coef=0.3)
    toks = batch(51)
    loss_j, grads_j = jax.value_and_grad(jtrain.next_token_loss)(
        jp, jnp.asarray(toks), jc, compute_dtype=jnp.float32, remat=True)
    runs = {remat: grads_of(tp, lambda tree: ttrain.next_token_loss(
        tree, torch.from_numpy(toks).long(), tc, compute_dtype=torch.float32, remat=remat))
        for remat in (True, False)}
    loss, grads = runs[True]
    assert abs(loss.item() - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    want = jax_leaves(grads_j)
    scale = max(1.0, max(g.abs().max().item() for g in want))
    assert max((a - b).abs().max().item() for a, b in zip(grads, want)) <= 1e-4 * scale
    assert torch.equal(runs[False][0], loss)
    assert all(torch.equal(a, b) for a, b in zip(runs[False][1], grads))


def test_three_updates_and_the_trainer_match_jax():
    jp, jc, tp, tc = make_model(seed=60, moe_top_k=2)
    toks = batch(61)
    jstep = jtrain.make_llama_train_step(jc, optax.adamw(1e-3), compute_dtype=jnp.float32)
    jstate = optax.adamw(1e-3).init(jp)
    opt = AdamW(1e-3)
    tstep = ttrain.make_llama_train_step(tc, opt, compute_dtype=torch.float32)
    tstate = opt.init(tp)
    for _ in range(3):
        jp, jstate, jl = jstep(jp, jstate, jnp.asarray(toks))
        tp, tstate, tl = tstep(tp, tstate, toks)
        assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    jp, jc, tp, tc = make_model(seed=62, moe_top_k=2)
    kw = dict(learning_rate=1e-3, total_steps=2, warmup_steps=1, accum_steps=2,
              compute_dtype="float32", log_every=1)
    batches = [batch(70 + i) for i in range(4)]
    _, jhist = jtrainer.Trainer(jc, jtrainer.TrainConfig(**kw)).fit(jp, batches, verbose=False)
    _, thist = ttrainer.Trainer(tc, ttrainer.TrainConfig(**kw)).fit(tp, batches, verbose=False)
    assert [h["update"] for h in thist] == [h["update"] for h in jhist] == [1, 2]
    for t, j in zip(thist, jhist):
        assert abs(t["loss"] - j["loss"]) <= 1e-5 * abs(j["loss"])
