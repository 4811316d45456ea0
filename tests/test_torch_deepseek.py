"""The port's DeepSeek-V3 family (``ssp_x_vit_tpu_torch/llm/deepseek.py``,
``llm/pruning_deepseek.py``) against the JAX package on the CPU.

Weights are drawn with numpy from a seed in the JAX tree layout (the
e_score_correction biases small and nonzero, so the biased selection is in
play) and carried across with ``deepseek_params_from_jax``. Every comparison runs in
fp32 and holds the port within 1e-4 of max(1, max |JAX|): dense, MoE (grouped
sigmoid routing, shared experts, routed scaling), ``q_lora_rank``,
non-interleaved rope and deepseek-style yarn configs, mirroring
``tests/test_deepseek.py``; gates and MLP statistics; the materialized
forward after each pruning surgery; absorbed-decode generation (the same
greedy tokens as JAX's, eos trim included, and as a full recompute); the
router on tied choices, where both must pick the lower expert index, and
masked groups under a negative bias.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssp_x_vit_tpu.llm import deepseek as J
from ssp_x_vit_tpu.llm import pruning_deepseek as JPD
from ssp_x_vit_tpu.llm.rope import RopeScaling as JRopeScaling
from ssp_x_vit_tpu_torch.llm import deepseek as T
from ssp_x_vit_tpu_torch.llm import pruning as TP
from ssp_x_vit_tpu_torch.llm import pruning_deepseek as TPD
from ssp_x_vit_tpu_torch.llm.checkpoints import deepseek_params_from_jax
from ssp_x_vit_tpu_torch.llm.rope import RopeScaling as TRopeScaling

TOL = 1e-4
BASE = dict(vocab_size=96, hidden_size=32, num_layers=3, num_heads=4, kv_lora_rank=16,
            qk_nope_head_dim=8, qk_rope_head_dim=4, v_head_dim=8, intermediate_size=48,
            moe_intermediate_size=16, n_shared_experts=1, num_experts_per_tok=2,
            n_group=4, topk_group=2, routed_scaling_factor=2.5)
YARN = dict(rope_type="yarn", factor=4.0, beta_fast=8.0, beta_slow=1.0, mscale=1.2,
            mscale_all_dim=0.8, original_max_position_embeddings=16)
CONFIGS = {
    "dense": dict(n_routed_experts=0),
    "moe": dict(n_routed_experts=8, first_k_dense_replace=1),
    "q_lora": dict(n_routed_experts=8, first_k_dense_replace=1, q_lora_rank=12),
    "no_interleave": dict(n_routed_experts=0, rope_interleave=False),
    "yarn": dict(n_routed_experts=0, rope_scaling="yarn"),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's tiny tensors: the suite runs six
    workers on the host's cores, where a pool per worker only contends."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make(name, seed=0, **over):
    """(JAX params as jnp arrays, JAX cfg, port params, port cfg)."""
    kw = dict(BASE, **CONFIGS[name], **over)
    rs = kw.pop("rope_scaling", None)
    jcfg = J.DeepseekConfig(**kw, rope_scaling=JRopeScaling(**YARN) if rs else None)
    tcfg = T.DeepseekConfig(**kw, rope_scaling=TRopeScaling(**YARN) if rs else None)
    jp = np_params(tcfg, seed)
    return (jax.tree.map(jnp.asarray, jp), jcfg, deepseek_params_from_jax(jp, device="cpu"),
            tcfg)


def np_params(tcfg, seed):
    """A parameter tree in the JAX layout made from a numpy seed (normal, std
    0.02; norms at one; small e_score_correction biases)."""
    rng = np.random.default_rng(seed)
    shapes = T.init_deepseek_params(None, tcfg, device="cpu")

    def fill(name, t):
        if isinstance(t, dict):
            return {k: fill(k, v) for k, v in t.items()}
        if name.startswith("ln") or name.endswith("norm"):
            return np.ones(tuple(t.shape), np.float32)
        if name == "e_bias":
            return rng.uniform(-0.05, 0.05, tuple(t.shape)).astype(np.float32)
        return (rng.standard_normal(tuple(t.shape)) * 0.02).astype(np.float32)

    return {k: fill(k, v) for k, v in shapes.items()}


def close(got, ref, tol=TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max() / max(1.0, np.abs(ref).max())
    assert err <= tol, err


TOKENS = (np.arange(20)[None] * 7 + 3) % 96


@pytest.mark.parametrize("name", list(CONFIGS))
def test_logits_match_jax(name):
    jp, jcfg, tp, tcfg = make(name, seed=len(name))
    ref, (jc, jkr) = J.deepseek_forward(jp, jnp.asarray(TOKENS), jcfg,
                                        compute_dtype=jnp.float32, return_caches=True)
    got = T.deepseek_forward(tp, torch.as_tensor(TOKENS), tcfg, compute_dtype=torch.float32)
    close(got, ref)
    # the serving-cache side outputs and a single logit position
    last, (tc, tkr) = T.deepseek_forward(tp, torch.as_tensor(TOKENS), tcfg,
                                         compute_dtype=torch.float32, return_caches=True,
                                         logit_position=7)
    close(tc, jc)
    close(tkr, jkr)
    close(last[:, 0], np.asarray(ref)[:, 7])


def test_gates_and_mlp_statistics_match_jax():
    jp, jcfg, tp, tcfg = make("dense", seed=3)
    ga = np.asarray([1.0, 0.0, 0.5], np.float32)
    gm = np.asarray([0.0, 1.0, 1.0], np.float32)
    jl, jaux = J.deepseek_forward(jp, jnp.asarray(TOKENS), jcfg, compute_dtype=jnp.float32,
                                  attn_gate=jnp.asarray(ga), mlp_gate=jnp.asarray(gm),
                                  collect_mlp_stats=True, return_block_outputs=True)
    tl, taux = T.deepseek_forward(tp, torch.as_tensor(TOKENS), tcfg,
                                  compute_dtype=torch.float32, attn_gate=ga, mlp_gate=gm,
                                  collect_mlp_stats=True, return_block_outputs=True)
    close(tl, jl)
    close(taux["mlp_stats"], jaux["mlp_stats"])
    close(taux["block_outputs"], jaux["block_outputs"])
    # per-row gates ([L, b, 1, 1]: the candidate batches) give each row its own gates
    rows = torch.as_tensor(np.stack([np.ones(3), ga]).T[:, :, None, None], dtype=torch.float32)
    both = T.deepseek_forward(tp, torch.as_tensor(np.repeat(TOKENS, 2, 0)), tcfg,
                              compute_dtype=torch.float32, attn_gate=rows)
    close(both[1], T.deepseek_forward(tp, torch.as_tensor(TOKENS), tcfg,
                                      compute_dtype=torch.float32, attn_gate=ga)[0])
    _, _, mp, mcfg = make("moe")
    with pytest.raises(ValueError, match="dense GLU"):
        T.deepseek_forward(mp, torch.as_tensor(TOKENS), mcfg, collect_mlp_stats=True)


def test_materialized_forward_after_each_surgery_matches_jax():
    jp, jcfg, tp, tcfg = make("moe", seed=5)
    toks = jnp.asarray(TOKENS)
    # attention removal in both groups, then block removal, on the MoE model
    jq, jc = JPD.materialize_deepseek_attention_pruning(jp, jcfg, [0, 2])
    tq, tc = TP.materialize_llm_depth_pruning(tp, tcfg, [0, 2])
    assert tc.pruned_attention_blocks == jc.pruned_attention_blocks == (0, 2)
    assert tc.attn_store_index == jc.attn_store_index
    close(T.deepseek_forward_materialized(tq, torch.as_tensor(TOKENS), tc,
                                          compute_dtype=torch.float32),
          J.deepseek_forward_materialized(jq, toks, jc, compute_dtype=jnp.float32))
    jq, jc = JPD.materialize_deepseek_block_removal(jp, jcfg, [0, 2])
    tq, tc = TP.materialize_llm_block_removal(tp, tcfg, [0, 2])
    assert (tc.num_layers, tc.first_k_dense_replace) == (jc.num_layers, jc.first_k_dense_replace)
    assert "dense_blocks" not in tq and "dense_blocks" not in jq
    assert set(tq["moe_blocks"]) == set(jq["moe_blocks"])
    for k, v in jq["moe_blocks"].items():
        close(tq["moe_blocks"][k], v, 0)
    # width pruning on the dense model, then attention removal on top
    jp, jcfg, tp, tcfg = make("dense", seed=6)
    keep = [np.sort(np.random.default_rng(i).permutation(48)[:30]) for i in range(3)]
    jq, jc = JPD.materialize_deepseek_width_pruning(jp, jcfg, keep)
    tq, tc = TP.materialize_llm_width_pruning(tp, tcfg, keep)
    assert tc.effective_intermediate == jc.effective_intermediate == 30
    close(tq["dense_blocks"]["down_kernel"], jq["dense_blocks"]["down_kernel"], 0)
    assert TP.count_main_params(tc) == TPD.count_main_params_deepseek(tc) == \
        JPD.count_main_params_deepseek(jc)
    jq, jc = JPD.materialize_deepseek_attention_pruning(jq, jc, [1])
    tq, tc = TPD.materialize_deepseek_attention_pruning(tq, tc, [1])
    assert TP.count_main_params(tc) == JPD.count_main_params_deepseek(jc)
    close(T.deepseek_forward_materialized(tq, torch.as_tensor(TOKENS), tc,
                                          compute_dtype=torch.float32),
          J.deepseek_forward_materialized(jq, toks, jc, compute_dtype=jnp.float32))
    for fn, arg in ((TPD.materialize_deepseek_attention_pruning, [0]),
                    (TPD.materialize_deepseek_block_removal, [0])):
        with pytest.raises(ValueError, match="materializ"):
            fn(tq, tc, arg)
    with pytest.raises(ValueError, match="MoE"):
        TPD.count_main_params_deepseek(make("moe")[3])


@pytest.mark.parametrize("name", ["moe", "yarn"])
def test_generate_matches_jax_and_full_recompute(name):
    """Absorbed decode over the compressed cache: JAX's greedy tokens, batched
    (a row alone gives the same tokens, and trims at an eos), and the argmax of
    a full recompute at every step; attention-materialized models too."""
    jp, jcfg, tp, tcfg = make(name, seed=7)
    prompts = np.asarray([[1, 5, 9, 20], [30, 2, 17, 4]], np.int32)
    ref = J.deepseek_generate(jp, jcfg, prompts, max_new_tokens=6, compute_dtype=jnp.float32)
    got = T.deepseek_generate(tp, tcfg, prompts, max_new_tokens=6, compute_dtype=torch.float32)
    assert [g.tolist() for g in got] == [r.tolist() for r in ref]
    seq = got[0]
    for t in range(4, len(seq)):
        logits = T.deepseek_forward(tp, torch.as_tensor(seq[None, :t]), tcfg,
                                    compute_dtype=torch.float32)
        assert int(logits[0, -1].argmax()) == seq[t]
    solo = T.deepseek_generate(tp, tcfg, prompts[1], max_new_tokens=6,
                               compute_dtype=torch.float32)
    assert solo.tolist() == got[1].tolist()
    eos = int(solo[5])
    trimmed = T.deepseek_generate(tp, tcfg, prompts[1], max_new_tokens=6, eos_token_id=eos,
                                  compute_dtype=torch.float32)
    assert trimmed.tolist() == solo[:6].tolist() == ref[1][:6].tolist()
    # an attention-materialized model decodes over the surviving layers' cache:
    # the argmax of its materialized forward (held to JAX's in the surgery test)
    tq, tc = TPD.materialize_deepseek_attention_pruning(tp, tcfg, [1])
    seq = T.deepseek_generate(tq, tc, prompts[0], max_new_tokens=5, compute_dtype=torch.float32)
    full = T.deepseek_forward_materialized(tq, torch.as_tensor(seq[None]), tc,
                                           compute_dtype=torch.float32)
    assert full[0, 3:-1].argmax(dim=-1).tolist() == seq[4:].tolist()


def test_router_ties_and_masked_groups_match_jax():
    """Equal choices: the lower expert index wins in both (``lax.top_k``'s
    rule, a stable descending sort in the port). A negative bias: the masked
    groups' 0.0 outranks the kept groups' negative choices, as in JAX and HF."""
    cfg_kw = dict(BASE, n_routed_experts=8, first_k_dense_replace=0, num_experts_per_tok=3)
    jcfg, tcfg = J.DeepseekConfig(**cfg_kw), T.DeepseekConfig(**cfg_kw)
    d = cfg_kw["hidden_size"]
    rng = np.random.default_rng(0)
    xt = rng.normal(size=(6, d)).astype(np.float32)
    router = np.zeros((d, 8), np.float32)
    router[:, 4:] = rng.normal(size=(d, 4)) * 0.1          # experts 0-3 tie at 0.5
    router[:, 1] = router[:, 0]                            # and a tie across groups
    for bias in (np.zeros(8, np.float32), np.full(8, -0.75, np.float32),
                 np.asarray([0.1, 0.1, -1, -1, 0, 0, 0.2, 0.2], np.float32)):
        bp = {"router": router, "e_bias": bias}
        ref = np.asarray(J._deepseek_route(jnp.asarray(xt), jax.tree.map(jnp.asarray, bp), jcfg))
        got = T._deepseek_route(torch.as_tensor(xt), {k: torch.as_tensor(v)
                                                      for k, v in bp.items()}, tcfg).numpy()
        np.testing.assert_array_equal(got != 0, ref != 0)
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    assert (np.asarray(got != 0).sum(axis=1) == 3).all()


def test_config_checks_and_cache_footprint():
    with pytest.raises(ValueError, match="deepseek_v3"):
        T.config_from_hf_deepseek({"model_type": "llama"})
    with pytest.raises(ValueError, match="topk_group"):
        T.DeepseekConfig(n_routed_experts=8, n_group=2, topk_group=4)
    with pytest.raises(ValueError, match="silu"):
        T.DeepseekConfig(hidden_act="gelu")
    small = T.DeepseekConfig(num_heads=4, kv_lora_rank=512, qk_rope_head_dim=64)
    large = dataclasses.replace(small, num_heads=128)
    assert T.mla_cache_bytes_per_token(small) == T.mla_cache_bytes_per_token(large) == \
        J.mla_cache_bytes_per_token(J.DeepseekConfig(num_heads=128)) == (512 + 64) * 2
    for name in CONFIGS:
        _, jcfg, _, tcfg = make(name)
        assert T.mla_softmax_scale(tcfg) == J.mla_softmax_scale(jcfg)
        assert tcfg.attn_store_index == jcfg.attn_store_index
