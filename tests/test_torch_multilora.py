"""Multi-LoRA serving (``ssp_x_vit_tpu_torch/llm/multilora.py`` and the
``lora_ids`` threading of ``llm/serve.py``) against the JAX package on the CPU.

The JAX package's ``tests/test_multilora.py`` run in both packages on the
same numpy adapters (its ``CFG``; a ~ N(0, 1) / r, b ~ N(0, 0.05)): the bank
(slot 0 zero, alpha / r folded into b) equal to JAX's; ``lora_delta`` within
1e-6 in fp32; batched greedy generation with per-row adapter ids token for
token equal to JAX's and to each ``merge_lora`` model served alone; packed
and int8-quantized bases; the refusals. Also the eos loop (``decode_while``),
``greedy_generate_kv``, a rolling cache, and an int8 cache (bf16 compute:
logits within 5e-2 of max(1, max |reference|), as in
``tests/test_torch_serve_kv.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssp_x_vit_tpu.llm import model as jmodel
from ssp_x_vit_tpu.llm import multilora as jml
from ssp_x_vit_tpu.llm import quant as jquant
from ssp_x_vit_tpu.llm import serve as jserve
from ssp_x_vit_tpu_torch.llm import checkpoints as tckpt
from ssp_x_vit_tpu_torch.llm import lora as tlora
from ssp_x_vit_tpu_torch.llm import model as tmodel
from ssp_x_vit_tpu_torch.llm import multilora as tml
from ssp_x_vit_tpu_torch.llm import quant as tquant
from ssp_x_vit_tpu_torch.llm import serve as tserve

CFG = dict(vocab_size=96, hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2,
           intermediate_size=64)
RANK = 4
PROMPT = [3, 1, 4, 1, 5]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's tiny tensors: the suite runs six
    workers on the host's cores, where a pool per worker only contends."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def numpy_adapter(seed, tree, rank=RANK, targets=tlora.DEFAULT_TARGETS):
    rng = np.random.default_rng(seed)
    out = {}
    for t in targets:
        n_layers, d, n = tree["blocks"][t].shape
        out[t] = {"a": (rng.normal(size=(n_layers, d, rank)) / rank).astype(np.float32),
                  "b": (0.05 * rng.normal(size=(n_layers, rank, n))).astype(np.float32)}
    return out


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = jmodel.LlamaConfig(**CFG), tmodel.LlamaConfig(**CFG)
    jparams = jmodel.init_llama_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, jparams)
    tparams = tckpt.llm_params_from_jax(tree, device="cpu")
    adapters = [numpy_adapter(1, tree), numpy_adapter(2, tree)]
    jad = [jax.tree.map(jnp.asarray, a) for a in adapters]
    tad = [tckpt.llm_params_from_jax(a, device="cpu") for a in adapters]
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tparams=tparams, jad=jad, tad=tad,
                jbank=jml.build_lora_bank(jad, alpha=16.0),
                tbank=tml.build_lora_bank(tad, alpha=16.0))


def test_bank_matches_jax_and_crosses_over(setup):
    """Slot 0 zero, the scale folded into b in fp32: the port's bank is the
    JAX package's bit for bit; a JAX bank carried across keeps fp32 on a bf16
    tree, and an adapter tree keeps its dtype."""
    jbank, tbank = setup["jbank"], setup["tbank"]
    assert sorted(jbank) == sorted(tbank)
    for k in jbank:
        assert tbank[k].dtype == torch.float32
        np.testing.assert_array_equal(tbank[k].numpy(), np.asarray(jbank[k]), err_msg=k)
    assert tbank["q_kernel_lora_a"].shape[1] == 3
    assert float(tbank["q_kernel_lora_a"][:, 0].abs().max()) == 0.0
    tree = jax.tree.map(np.asarray, jml.attach_lora_bank(setup["jparams"], jbank))
    carried = tckpt.llm_params_from_jax(tree, device="cpu", dtype=torch.bfloat16)
    assert carried["blocks"]["q_kernel"].dtype == torch.bfloat16
    for k in jbank:
        assert carried["blocks"][k].dtype == torch.float32
        np.testing.assert_array_equal(carried["blocks"][k].numpy(), np.asarray(jbank[k]))
    assert setup["tad"][0]["q_kernel"]["a"].dtype == torch.float32
    ad16 = tckpt.llm_params_from_jax(jax.tree.map(np.asarray, setup["jad"][0]), device="cpu",
                                     dtype=torch.bfloat16)
    assert ad16["o_kernel"]["b"].dtype == torch.float32


def test_lora_delta_matches_jax(setup):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 5, CFG["hidden_size"])).astype(np.float32)
    ids = np.asarray([2, 0, 1], np.int32)
    jbp = {k: v[1] for k, v in setup["jbank"].items()}
    tbp = {k: v[1] for k, v in setup["tbank"].items()}
    for t in tml.SERVABLE_TARGETS:
        want = jml.lora_delta(jnp.asarray(x), jbp, t, jnp.asarray(ids), jnp.float32)
        got = tml.lora_delta(torch.from_numpy(x), tbp, t, torch.from_numpy(ids).long(),
                             torch.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
        rows = tml.gather_lora_rows(tbp, torch.from_numpy(ids).long(), torch.float32)
        assert torch.equal(tml.lora_delta(torch.from_numpy(x), rows, t, ids, torch.float32), got)
    assert tml.lora_delta(torch.from_numpy(x), tbp, "q_kernel", None, torch.float32) is None
    assert tml.lora_delta(torch.from_numpy(x), {}, "q_kernel", ids, torch.float32) is None


def test_batch_matches_jax_and_merged_singles(setup):
    """ids [0 (base), 1, 2] in one batch == JAX's batch == the base model,
    merge_lora(adapter 0) and merge_lora(adapter 1), each served alone."""
    tcfg = setup["tcfg"]
    served = tml.attach_lora_bank(setup["tparams"], setup["tbank"])
    prompts = [np.asarray(PROMPT, np.int32)] * 3
    got = tserve.generate_kv_scan(served, tcfg, prompts, max_length=16,
                                  cache_dtype=torch.float32, lora_ids=[0, 1, 2])
    want = jserve.generate_kv_scan(jml.attach_lora_bank(setup["jparams"], setup["jbank"]),
                                   setup["jcfg"], prompts, max_length=16,
                                   cache_dtype=jnp.float32,
                                   lora_ids=np.asarray([0, 1, 2], np.int32))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    base = tserve.generate_kv_scan(setup["tparams"], tcfg, prompts[0], max_length=16,
                                   cache_dtype=torch.float32)
    np.testing.assert_array_equal(got[0], base)
    for i, ad in enumerate(setup["tad"]):
        merged = tlora.merge_lora(setup["tparams"], ad, alpha=16.0)
        alone = tserve.generate_kv_scan(merged, tcfg, prompts[0], max_length=16,
                                        cache_dtype=torch.float32)
        np.testing.assert_array_equal(got[i + 1], alone)
    assert not np.array_equal(got[1], got[0])


def test_packed_and_quantized_bases_match_jax(setup):
    """Deltas add after the packed qkv split (packed == unpacked == JAX's
    packed); the bank rides an int8 base (row 0 == the int8 base alone, the
    tokens == JAX's)."""
    tcfg, jcfg = setup["tcfg"], setup["jcfg"]
    served = tml.attach_lora_bank(setup["tparams"], setup["tbank"])
    packed = tserve.pack_llm_params_for_serving(served, tcfg)
    assert any(k.startswith("qkv_kernel") for k in packed["blocks"])
    prompts = [np.asarray([7, 2, 9], np.int32)] * 2
    a = tserve.generate_kv_scan(served, tcfg, prompts, max_length=14,
                                cache_dtype=torch.float32, lora_ids=[1, 2])
    b = tserve.generate_kv_scan(packed, tcfg, prompts, max_length=14,
                                cache_dtype=torch.float32, lora_ids=[1, 2])
    jpacked = jserve.pack_llm_params_for_serving(
        jml.attach_lora_bank(setup["jparams"], setup["jbank"]), jcfg)
    want = jserve.generate_kv_scan(jpacked, jcfg, prompts, max_length=14,
                                   cache_dtype=jnp.float32, lora_ids=np.asarray([1, 2]))
    for x, y, w in zip(a, b, want):
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(y, np.asarray(w))

    tq = tml.attach_lora_bank(tquant.quantize_llm_params_int8(setup["tparams"], tcfg),
                              setup["tbank"])
    assert tq["blocks"]["q_kernel_lora_a"].dtype == torch.float32
    prompts = [np.asarray([5, 6, 7], np.int32)] * 2
    got = tserve.generate_kv_scan(tq, tcfg, prompts, max_length=12,
                                  cache_dtype=torch.float32, lora_ids=[0, 1])
    jq = jml.attach_lora_bank(jquant.quantize_llm_params_int8(setup["jparams"], jcfg),
                              setup["jbank"])
    want = jserve.generate_kv_scan(jq, jcfg, prompts, max_length=12,
                                   cache_dtype=jnp.float32, lora_ids=np.asarray([0, 1]))
    base = tserve.generate_kv_scan(tquant.quantize_llm_params_int8(setup["tparams"], tcfg),
                                   tcfg, prompts[0], max_length=12, cache_dtype=torch.float32)
    np.testing.assert_array_equal(got[0], base)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert not np.array_equal(got[1], got[0])


def test_refusals(setup):
    """An empty adapter list, MLP targets and a bank target missing from the
    blocks are refused, with the JAX package's messages; ids outside the bank
    or of the wrong count are refused before any work."""
    with pytest.raises(ValueError, match="at least one adapter"):
        tml.build_lora_bank([])
    tree = jax.tree.map(np.asarray, setup["jparams"])
    mlp = tckpt.llm_params_from_jax(numpy_adapter(9, tree, 2, ("gate_kernel", "up_kernel")),
                                    device="cpu")
    with pytest.raises(ValueError, match="silently ignored"):
        tml.build_lora_bank([mlp])
    with pytest.raises(ValueError, match="different key sets"):
        tml.build_lora_bank([setup["tad"][0], {"q_kernel": setup["tad"][0]["q_kernel"]}])
    with pytest.raises(ValueError, match="not in params blocks"):
        tml.attach_lora_bank({"blocks": {"zz_kernel": torch.zeros(2, 4, 4)}}, setup["tbank"])
    with pytest.raises(ValueError, match="not in params blocks"):
        jml.attach_lora_bank({"blocks": {"zz_kernel": jnp.zeros((2, 4, 4))}}, setup["jbank"])
    served = tml.attach_lora_bank(setup["tparams"], setup["tbank"])
    with pytest.raises(ValueError, match="outside the bank"):
        tserve.generate_kv_scan(served, setup["tcfg"], [PROMPT], max_length=8, lora_ids=[3],
                                cache_dtype=torch.float32)
    with pytest.raises(ValueError, match="2 lora_ids for a batch of 1"):
        tserve.generate_kv_scan(served, setup["tcfg"], [PROMPT], max_length=8,
                                lora_ids=[0, 1], cache_dtype=torch.float32)


def test_eos_loop_and_host_loop_match_jax(setup):
    """``decode_while`` (eos) and ``greedy_generate_kv`` with ids: JAX's
    tokens; the eos is the token JAX's base row emits third."""
    tcfg, jcfg = setup["tcfg"], setup["jcfg"]
    served = tml.attach_lora_bank(setup["tparams"], setup["tbank"])
    jserved = jml.attach_lora_bank(setup["jparams"], setup["jbank"])
    prompts = [PROMPT, [8, 8, 2], [1, 2, 3, 4, 5, 6, 7]]
    ids = [2, 0, 1]
    ref = tserve.generate_kv_scan(served, tcfg, prompts, max_length=20,
                                  cache_dtype=torch.float32, lora_ids=ids)
    eos = int(ref[1][len(prompts[1]) + 2])
    got = tserve.generate_kv_scan(served, tcfg, prompts, max_length=20, eos_token_id=eos,
                                  cache_dtype=torch.float32, lora_ids=ids)
    want = jserve.generate_kv_scan(jserved, jcfg, prompts, max_length=20, eos_token_id=eos,
                                   cache_dtype=jnp.float32, lora_ids=np.asarray(ids))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert len(got[1]) <= len(prompts[1]) + 3
    host = tserve.greedy_generate_kv(served, tcfg, prompts, max_length=20, eos_token_id=eos,
                                     cache_dtype=torch.float32, lora_ids=ids)
    jhost = jserve.greedy_generate_kv(jserved, jcfg, prompts, max_length=20, eos_token_id=eos,
                                      cache_dtype=jnp.float32, lora_ids=np.asarray(ids))
    for g, w, x in zip(host, jhost, got):
        np.testing.assert_array_equal(g, np.asarray(w))
        np.testing.assert_array_equal(g, x)


def test_rolling_cache_matches_jax(setup):
    """A uniform-window model (window 6) on its rolling cache with ids: JAX's
    tokens, and each row that of its merged adapter alone on the rolling cache."""
    kw = dict(CFG, sliding_window=6)
    jcfg, tcfg = jmodel.LlamaConfig(**kw), tmodel.LlamaConfig(**kw)
    served = tml.attach_lora_bank(setup["tparams"], setup["tbank"])
    prompts = [PROMPT + [2, 7, 1, 8], [9, 3]]
    got = tserve.generate_kv_scan(served, tcfg, prompts, max_length=24, rolling=True,
                                  cache_dtype=torch.float32, lora_ids=[1, 2])
    want = jserve.generate_kv_scan(jml.attach_lora_bank(setup["jparams"], setup["jbank"]),
                                   jcfg, prompts, max_length=24, rolling=True,
                                   cache_dtype=jnp.float32, lora_ids=np.asarray([1, 2]))
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, np.asarray(w))
        merged = tlora.merge_lora(setup["tparams"], setup["tad"][i], alpha=16.0)
        alone = tserve.generate_kv_scan(merged, tcfg, prompts[i], max_length=24, rolling=True,
                                        cache_dtype=torch.float32)
        np.testing.assert_array_equal(g, alone)


def test_int8_cache_logits_match_jax(setup):
    """int8 cache (bf16 compute) with ids: the prefill logits and one decode
    step's within 5e-2 of max(1, max |JAX's|); row 0 bit for bit the batch
    served without ids."""
    tcfg, jcfg = setup["tcfg"], setup["jcfg"]
    served = tml.attach_lora_bank(setup["tparams"], setup["tbank"])
    jserved = jml.attach_lora_bank(setup["jparams"], setup["jbank"])
    tokens = np.asarray([[0, 0, 3, 1, 4], [1, 5, 9, 2, 6], [0, 5, 3, 5, 8]], np.int32)
    pads = np.asarray([2, 0, 1], np.int32)
    ids = np.asarray([0, 1, 2], np.int32)
    outs = {}
    for name, lora in (("ids", ids), ("none", None)):
        ck, cv = tserve.init_cache(tcfg, 3, 8, torch.int8, device="cpu")
        tp = torch.from_numpy(pads).long()
        logits, ck, cv = tserve.prefill(served, torch.from_numpy(tokens).long(), ck, cv, tcfg,
                                        tp, lora_ids=lora)
        step, _, _ = tserve.decode_step(served, logits.argmax(-1), ck, cv, tcfg, 5, tp,
                                        lora_ids=lora)
        outs[name] = (logits, step)
    assert torch.equal(outs["ids"][0][0], outs["none"][0][0])
    assert torch.equal(outs["ids"][1][0], outs["none"][1][0])
    jk, jv = jserve.init_cache(jcfg, 3, 8, jnp.int8)
    jpads = jnp.asarray(pads)
    jl, jk, jv = jserve.prefill(jserved, jnp.asarray(tokens), jk, jv, jcfg, jpads,
                               lora_ids=jnp.asarray(ids))
    jstep, _, _ = jserve.decode_step(jserved, jnp.asarray(outs["ids"][0].argmax(-1).numpy()),
                                     jk, jv, jcfg, 5, jpads, lora_ids=jnp.asarray(ids))
    for got, want in ((outs["ids"][0], jl), (outs["ids"][1], jstep)):
        want = np.asarray(want, np.float32)
        err = np.abs(got.float().numpy() - want).max()
        assert err <= 5e-2 * max(1.0, np.abs(want).max()), err

