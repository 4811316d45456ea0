"""The port's generation loops (``llm/generate.py``: ``greedy_generate``,
``beam_generate``, ``beam_generate_kv``; ``llm/speculative.py``:
``speculative_generate``) against the JAX package on the CPU.

Weights come from a numpy seed and cross over through ``llm_params_from_jax``;
everything runs in fp32, where the two frameworks differ only in summation
order (~1e-6), and the tests assert that the JAX package's own top-2 margin
exceeds 1e-3 at every greedy choice, so token-for-token equality is the claim.
Beam scores are compared to 1e-4. Speculative decoding must equal the port's
own greedy ``generate_kv_scan`` exactly and return the JAX package's tokens and
stats.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssp_x_vit_tpu.llm import generate as jgen
from ssp_x_vit_tpu.llm import model as jmodel
from ssp_x_vit_tpu.llm import pruning as jprune
from ssp_x_vit_tpu.llm import serve as jserve
from ssp_x_vit_tpu.llm import speculative as jspec
from ssp_x_vit_tpu_torch.llm import checkpoints as tckpt
from ssp_x_vit_tpu_torch.llm import generate as tgen
from ssp_x_vit_tpu_torch.llm import model as tmodel
from ssp_x_vit_tpu_torch.llm import serve as tserve
from ssp_x_vit_tpu_torch.llm import speculative as tspec

SMALL = dict(vocab_size=96, hidden_size=32, num_layers=3, num_heads=4, num_kv_heads=2,
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
    """(jax params, jax cfg, torch params, torch cfg): numpy-seeded weights,
    kernels ~ N(0, 0.15) so greedy continuations vary."""
    jcfg, tcfg = jmodel.LlamaConfig(**SMALL), tmodel.LlamaConfig(**SMALL)
    shapes = jax.eval_shape(lambda: jmodel.init_llama_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(21)

    def leaf(name, shape):
        if name.startswith("ln"):
            return (1 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        return (0.15 * rng.normal(size=shape)).astype(np.float32)

    tree = {k: ({kk: leaf(kk, vv.shape) for kk, vv in v.items()} if isinstance(v, dict)
                else leaf(k, v.shape)) for k, v in shapes.items()}
    return (jax.tree.map(jnp.asarray, tree), jcfg, tckpt.llm_params_from_jax(tree, device="cpu"),
            tcfg)


PROMPT = [5, 17, 3, 44, 9, 61]


def assert_margins(jparams, jcfg, seq, start):
    """The JAX forward's top-2 logit margin at every position from ``start``."""
    logits = np.asarray(jmodel.llama_forward(jparams, jnp.asarray([seq]), jcfg,
                                             compute_dtype=jnp.float32)[0][0])
    srt = np.sort(logits[start - 1:len(seq) - 1], axis=-1)
    assert (srt[:, -1] - srt[:, -2]).min() > 1e-3


def test_greedy_generate_matches_jax(model):
    """Full-recompute greedy with the 3-gram ban and an eos, fp32."""
    jparams, jcfg, tparams, tcfg = model
    kw = dict(max_length=16, no_repeat_ngram_size=3)
    ref = jgen.greedy_generate(jparams, jcfg, np.asarray(PROMPT), compute_dtype=jnp.float32, **kw)
    got = tgen.greedy_generate(tparams, tcfg, np.asarray(PROMPT), compute_dtype=torch.float32,
                               **kw)
    np.testing.assert_array_equal(got, np.asarray(ref))
    eos = int(ref[len(PROMPT) + 3])
    ref = jgen.greedy_generate(jparams, jcfg, np.asarray(PROMPT), eos_token_id=eos,
                               compute_dtype=jnp.float32, **kw)
    got = tgen.greedy_generate(tparams, tcfg, np.asarray(PROMPT), eos_token_id=eos,
                               compute_dtype=torch.float32, **kw)
    np.testing.assert_array_equal(got, np.asarray(ref))
    assert got[-1] == eos
    for ids in ([1, 2, 3, 1, 2], [4], []):
        assert tgen._banned_next_tokens(ids, 3) == jgen._banned_next_tokens(ids, 3)


@pytest.mark.parametrize("eos_at", [None, 2])
def test_beam_generate_and_beam_generate_kv_match_jax(model, eos_at):
    """5-beam search with the 3-gram ban: the port's full-recompute and
    KV-cached searches return the JAX package's beam, fp32; with an eos that a
    beam emits early, early stopping too."""
    jparams, jcfg, tparams, tcfg = model
    kw = dict(max_length=14, num_beams=5)
    eos = None
    if eos_at is not None:
        eos = int(jgen.beam_generate(jparams, jcfg, np.asarray(PROMPT), compute_dtype=jnp.float32,
                                     **kw)[len(PROMPT) + eos_at])
    ref = jgen.beam_generate(jparams, jcfg, np.asarray(PROMPT), eos_token_id=eos,
                             compute_dtype=jnp.float32, **kw)
    ref_kv = jgen.beam_generate_kv(jparams, jcfg, np.asarray(PROMPT), eos_token_id=eos,
                                   cache_dtype=jnp.float32, **kw)
    got = tgen.beam_generate(tparams, tcfg, np.asarray(PROMPT), eos_token_id=eos,
                             compute_dtype=torch.float32, **kw)
    got_kv = tgen.beam_generate_kv(tparams, tcfg, np.asarray(PROMPT), eos_token_id=eos,
                                   cache_dtype=torch.float32, **kw)
    np.testing.assert_array_equal(got, np.asarray(ref))
    np.testing.assert_array_equal(got_kv, np.asarray(ref_kv))
    np.testing.assert_array_equal(got_kv, got)
    if eos is not None:
        assert eos in got.tolist()


@pytest.fixture(scope="module")
def draft(model):
    """A depth-materialized draft of the same model (attention of block 1 pruned)."""
    jparams, jcfg, _, tcfg = model
    dp, dcfg = jprune.materialize_llm_depth_pruning(jparams, jcfg, [1])
    tdp = tckpt.llm_params_from_jax(jax.tree.map(np.asarray, dp), device="cpu")
    return dp, dcfg, tdp, tmodel.LlamaConfig(**dict(SMALL, pruned_attention_blocks=(1,)))


@pytest.mark.parametrize("k", [1, 3])
def test_speculative_generate_equals_greedy_and_matches_jax(model, draft, k):
    """Draft-k / verify-1 with a depth-pruned draft: the tokens equal the
    port's own greedy ``generate_kv_scan`` exactly, and the JAX package's
    ``speculative_generate`` tokens and stats (rounds, accepted drafts)."""
    jparams, jcfg, tparams, tcfg = model
    dp, dcfg, tdp, tdcfg = draft
    kw = dict(max_length=20, k=k)
    ref, ref_stats = jspec.speculative_generate(jparams, jcfg, dp, dcfg, PROMPT,
                                                cache_dtype=jnp.float32, **kw)
    got, stats = tspec.speculative_generate(tparams, tcfg, tdp, tdcfg, PROMPT,
                                            cache_dtype=torch.float32, **kw)
    greedy = tserve.generate_kv_scan(tparams, tcfg, PROMPT, max_length=20,
                                     cache_dtype=torch.float32)
    np.testing.assert_array_equal(got, greedy)
    np.testing.assert_array_equal(got, np.asarray(ref))
    assert stats == ref_stats
    assert stats["rounds"] > 0 and 0.0 <= stats["acceptance_rate"] <= 1.0
    assert_margins(jparams, jcfg, np.asarray(ref).tolist(), len(PROMPT))
    # the draft is the dense model itself: every draft accepted
    same, same_stats = tspec.speculative_generate(tparams, tcfg, tparams, tcfg, PROMPT,
                                                  cache_dtype=torch.float32, **kw)
    np.testing.assert_array_equal(same, greedy)
    assert same_stats["acceptance_rate"] == 1.0
    np.testing.assert_array_equal(
        np.asarray(jserve.generate_kv_scan(jparams, jcfg, PROMPT, max_length=20,
                                           cache_dtype=jnp.float32)), greedy)


def test_text_generation_needs_the_tokenizer(model, tmp_path):
    """Text generation goes through a tokenizer (a toy byte tokenizer here:
    the model's vocabulary is 96): ``generate_response`` gives the JAX
    package's text; ``qualitative_results`` on a directory without a
    ``tokenizer.json`` warns and returns None, as the JAX package does."""
    jparams, jcfg, tparams, tcfg = model

    class Bytes:
        def __call__(self, text, add_special_tokens=False):
            return {"input_ids": [b % 96 for b in text.encode()]}

        def decode(self, ids, skip_special_tokens=True):
            return bytes(32 + int(i) for i in ids).decode("latin-1")

    prompt = "hello"
    got = tgen.generate_response(prompt, tparams, tcfg, Bytes(), max_length=14, num_beams=1)
    ref = jgen.generate_response(prompt, jparams, jcfg, Bytes(), max_length=14, num_beams=1)
    seq = tgen.greedy_generate(tparams, tcfg, np.asarray(Bytes()(prompt)["input_ids"]),
                               max_length=14).tolist()
    assert_margins(jparams, jcfg, seq, len(prompt))
    assert got == ref == Bytes().decode(seq)
    assert tgen.qualitative_results(tparams, tcfg, str(tmp_path)) is None
