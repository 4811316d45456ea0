"""The port's ahead-of-time serving artifacts (``ssp_x_vit_tpu_torch/llm/aot.py``,
``torch.export``) on the CPU, one case for each JAX test in
``tests/test_aot.py`` at its tiny configurations, and the port's own.

- Port against port (fp32): greedy tokens driven through the artifacts alone
  equal ``generate_kv_scan`` exactly; ViT logits within rtol = atol = 1e-6
  of the live forward (``tests/test_aot.py``'s tolerance), dense and
  width-materialized; decode at a 0-d tensor position gives the same cache
  rows and logits, bit for bit, as at a host integer.
- Port against JAX (weights carried by ``llm_params_from_jax`` /
  ``params_from_jax``): the port's artifact tokens equal the JAX artifact's,
  driven as ``tests/test_aot.py`` drives them, where JAX's own top-2 logit
  margin exceeds 1e-3 at every chosen token (asserted, so no near-tie decides
  the comparison); ViT artifact logits within rtol = atol = 1e-4 of the JAX
  artifact's, the tolerance of the ViT forward parity tests
  (``tests/test_torch_vit.py``: the same arithmetic in another summation order).
- In place of JAX's TPU cross-lowering (torch for the CPU cannot make a CUDA
  tensor, so no CUDA artifact is made here): a CPU artifact holds no ``ssp``
  operator and refuses inputs on another device; the kernel path traced with
  ``dispatch.use_kernel`` forced on holds one operator node per kernel call,
  and survives ``torch.export.save`` / ``load``.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssp_x_vit_tpu.llm import aot as jaot
from ssp_x_vit_tpu.llm import model as jmodel
from ssp_x_vit_tpu.llm import serve as jserve
from ssp_x_vit_tpu_torch.llm import aot
from ssp_x_vit_tpu_torch.llm import checkpoints as tckpt
from ssp_x_vit_tpu_torch.llm import model as tmodel
from ssp_x_vit_tpu_torch.llm import serve as tserve
from ssp_x_vit_tpu_torch.ops import dispatch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(vocab_size=96, hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2,
           intermediate_size=64)
PROMPT = [3, 1, 4, 1, 5, 9]
STEPS, P_PAD = 8, 32
MAX_LEN = P_PAD + STEPS


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
    """(jax params, jax cfg, torch params, torch cfg): tests/test_aot.py's model."""
    jcfg = jmodel.LlamaConfig(**CFG)
    jparams = jmodel.init_llama_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    tparams = tckpt.llm_params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jparams, jcfg, tparams, tmodel.LlamaConfig(**CFG)


@pytest.fixture(scope="module")
def bundle(model):
    _, _, params, cfg = model
    return aot.export_serving_bundle(params, cfg, batch=1, prompt_buckets=[P_PAD],
                                     max_len=MAX_LEN, cache_dtype=torch.float32)


def drive(artifacts, params, cfg, prompt, steps, p_pad, max_len, cache_dtype):
    """Greedy generation through loaded artifacts only (the port's form of
    ``tests/test_aot.py:_drive_artifacts``): the position a 0-d tensor."""
    pre, dec = artifacts[f"prefill_{p_pad}"], artifacts["decode"]
    ck, cv = tserve.init_cache(cfg, 1, max_len, cache_dtype, device="cpu")
    toks = torch.zeros((1, p_pad), dtype=torch.int64)
    toks[0, p_pad - len(prompt):] = torch.as_tensor(prompt)
    pads = torch.tensor([p_pad - len(prompt)])
    logits, ck, cv = pre.call(params, toks, ck, cv, pads)
    out = [int(logits.argmax())]
    pos = torch.tensor(p_pad)
    for _ in range(steps - 1):
        logits, ck, cv = dec.call(params, torch.tensor(out[-1:]), ck, cv, pos, pads)
        out.append(int(logits.argmax()))
        pos = pos + 1
    return np.asarray(list(prompt) + out, np.int32)


def drive_jax(artifacts, params, cfg, prompt, steps, p_pad, max_len, cache_dtype):
    """``tests/test_aot.py:_drive_artifacts``, also returning JAX's top-2
    logit margin at every chosen token."""
    pre, dec = artifacts[f"prefill_{p_pad}"], artifacts["decode"]
    ck, cv = jserve.init_cache(cfg, 1, max_len, cache_dtype)
    toks = np.zeros((1, p_pad), np.int32)
    toks[0, p_pad - len(prompt):] = prompt
    pads = np.asarray([p_pad - len(prompt)], np.int32)
    logits, ck, cv = pre.call(params, jnp.asarray(toks), ck, cv, jnp.asarray(pads))
    out, margins = [], []

    def pick(lg):
        lg = np.asarray(lg)[0]
        top2 = np.sort(lg)[-2:]
        out.append(int(np.argmax(lg)))
        margins.append(float(top2[1] - top2[0]))

    pick(logits)
    pos = p_pad
    for _ in range(steps - 1):
        logits, ck, cv = dec.call(params, jnp.asarray(out[-1:], np.int32), ck, cv,
                                  jnp.asarray(pos, jnp.int32), jnp.asarray(pads))
        pick(logits)
        pos += 1
    return np.asarray(list(prompt) + out, np.int32), min(margins)


def test_artifact_generation_matches_live_path(model, bundle, tmp_path):
    """Export -> save to disk -> load -> greedy generation through the
    artifacts alone == generate_kv_scan, token for token."""
    _, _, params, cfg = model
    aot.save_bundle(bundle, str(tmp_path / "art"))
    assert sorted(os.listdir(tmp_path / "art")) == ["decode.pt2", f"prefill_{P_PAD}.pt2"]
    loaded = aot.load_bundle(str(tmp_path / "art"))
    assert set(loaded) == {f"prefill_{P_PAD}", "decode"}
    got = drive(loaded, params, cfg, PROMPT, STEPS, P_PAD, MAX_LEN, torch.float32)
    ref = tserve.generate_kv_scan(params, cfg, np.asarray(PROMPT), max_length=len(PROMPT) + STEPS,
                                  cache_dtype=torch.float32)
    np.testing.assert_array_equal(got, ref)


def test_artifact_tokens_equal_the_jax_artifacts(model, bundle):
    jparams, jcfg, params, cfg = model
    jbundle = jaot.export_serving_bundle(jparams, jcfg, batch=1, prompt_buckets=[P_PAD],
                                         max_len=MAX_LEN, cache_dtype=jnp.float32)
    want, margin = drive_jax({k: jaot.load_artifact(v) for k, v in jbundle.items()}, jparams,
                             jcfg, PROMPT, STEPS, P_PAD, MAX_LEN, jnp.float32)
    assert margin > 1e-3, margin
    got = drive({k: aot.load_artifact(v) for k, v in bundle.items()}, params, cfg, PROMPT, STEPS,
                P_PAD, MAX_LEN, torch.float32)
    np.testing.assert_array_equal(got, want)


def test_artifact_int8_cache_pytree_signature(model):
    """Quantized {q, s} caches export / load / call; the returned caches are
    the ones given, holding the new rows (written in place)."""
    _, _, params, cfg = model
    art = aot.load_artifact(aot.export_decode_step(params, cfg, batch=1, max_len=16,
                                                   cache_dtype=torch.int8))
    ck, cv = tserve.init_cache(cfg, 1, 16, torch.int8, device="cpu")
    logits, ck2, cv2 = art.call(params, torch.tensor([5]), ck, cv, torch.tensor(3),
                                torch.tensor([0]))
    assert logits.shape == (1, cfg.vocab_size) and logits.dtype == torch.float32
    assert isinstance(ck2, dict) and ck2["q"].dtype == torch.int8
    assert ck2["s"].dtype == torch.float32
    assert ck2["q"] is ck["q"] and cv2["s"] is cv["s"]
    ref_k, ref_v = tserve.init_cache(cfg, 1, 16, torch.int8, device="cpu")
    ref, _, _ = tserve.decode_step(params, torch.tensor([5]), ref_k, ref_v, cfg, 3,
                                   torch.tensor([0]))
    torch.testing.assert_close(logits, ref, rtol=0, atol=0)
    for got, want in ((ck, ref_k), (cv, ref_v)):
        for key in ("q", "s"):
            torch.testing.assert_close(got[key], want[key], rtol=0, atol=0)
    assert ck["q"][:, :, 3].abs().sum() > 0 and not ck["q"][:, :, 4:].any()


@pytest.mark.parametrize("case", ["contiguous", "rolling", "int8-cache"])
def test_tensor_position_decode_equals_host_integer(case):
    """decode_step at a 0-d tensor position (no host read) writes the same
    cache rows and gives the same logits, bit for bit, as at the host
    integer; the rolling cache across its wrap; and the cache write at a
    tensor offset (index_copy_ at pos + arange(s)) equals the slice copy at
    a host integer."""
    extra = dict(sliding_window=5) if case == "rolling" else {}
    cfg = tmodel.LlamaConfig(**CFG, **extra)
    params = tmodel.init_llama_params(None, cfg, device="cpu")
    rolling = 5 if case == "rolling" else None
    dtype = torch.int8 if case == "int8-cache" else torch.float32
    slots = rolling or 12
    pads = torch.tensor([0, 2])
    caches = [tserve.init_cache(cfg, 2, slots, dtype, device="cpu") for _ in range(2)]
    for pos in range(9 if rolling else 12):
        token = torch.tensor([pos % 7, (3 * pos) % 11])
        a = tserve.decode_step(params, token, *caches[0], cfg, pos, pads, rolling=rolling)
        b = tserve.decode_step(params, token, *caches[1], cfg, torch.tensor(pos), pads,
                               rolling=rolling)
        torch.testing.assert_close(b[0], a[0], rtol=0, atol=0)
        caches = [a[1:], b[1:]]
        for got, want in zip(caches[1], caches[0]):
            for g, w in (zip(got.values(), want.values()) if isinstance(got, dict)
                         else [(got, want)]):
                torch.testing.assert_close(g, w, rtol=0, atol=0)
    with pytest.raises(ValueError, match="0-d int64"):
        tserve.decode_step(params, token, *caches[1], cfg, torch.tensor([pos]), pads,
                           rolling=rolling)
    # the cache write itself: a host-integer offset (slice copy) and a 0-d tensor
    # (index_copy_) put the same bits in the same rows, several rows at once
    k = torch.randn(2, 3, cfg.num_kv_heads, cfg.head_dim)
    v = torch.randn(2, 3, cfg.num_kv_heads, cfg.head_dim)
    by_int = tserve._write_cache(*tserve.init_cache(cfg, 2, slots, dtype, device="cpu"), k, v,
                                 1, 0)
    by_tensor = tserve._write_cache(*tserve.init_cache(cfg, 2, slots, dtype, device="cpu"), k,
                                    v, torch.tensor(1), 0)
    for got, want in zip(by_tensor, by_int):
        for g, w in (zip(got.values(), want.values()) if isinstance(got, dict)
                     else [(got, want)]):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_decode_artifact_past_the_cache_end_raises(model, bundle):
    """pos < max_len is the decode artifact's contract for a contiguous cache
    (``export_decode_step``): at pos = max_len the CPU program raises, and
    the caches keep their rows."""
    _, _, params, cfg = model
    art = aot.load_artifact(bundle["decode"])
    ck, cv = tserve.init_cache(cfg, 1, MAX_LEN, torch.float32, device="cpu")
    with pytest.raises((IndexError, RuntimeError)):
        art.call(params, torch.tensor([7]), ck, cv, torch.tensor(MAX_LEN),
                 torch.tensor([P_PAD - 6]))
    assert not ck.any() and not cv.any()


def test_parameter_tree_in_another_key_order_is_accepted(model, bundle):
    _, _, params, cfg = model
    art = aot.load_artifact(bundle["decode"])
    reordered = {k: (dict(reversed(list(v.items()))) if isinstance(v, dict) else v)
                 for k, v in reversed(list(params.items()))}
    assert list(reordered) != sorted(reordered)
    args = (torch.tensor([7]), *tserve.init_cache(cfg, 1, MAX_LEN, torch.float32, device="cpu"),
            torch.tensor(P_PAD), torch.tensor([P_PAD - 6]))
    want = art.call(params, *args)[0]
    args = (torch.tensor([7]), *tserve.init_cache(cfg, 1, MAX_LEN, torch.float32, device="cpu"),
            torch.tensor(P_PAD), torch.tensor([P_PAD - 6]))
    torch.testing.assert_close(art.call(reordered, *args)[0], want, rtol=0, atol=0)


def _program_tensors(art):
    from torch.export.graph_signature import InputKind

    kinds = [s.kind for s in art.program.graph_signature.input_specs]
    users = sum(k == InputKind.USER_INPUT for k in kinds)
    const_bytes = [t.numel() * t.element_size() for t in art.program.constants.values()]
    return kinds, users, const_bytes


def test_no_weight_sized_constant_in_the_program(model, bundle):
    """Every parameter and cache leaf is a user input of the program; its
    lifted constants (the rotary frequencies) are smaller than the smallest
    weight, no parameter or buffer is lifted, and the archive stores no
    example inputs (``torch.export.save`` would store the parameters and
    caches themselves there)."""
    import io
    import zipfile

    from torch.export.graph_signature import InputKind

    _, _, params, _ = model
    leaves = len(torch.utils._pytree.tree_leaves(params))
    smallest = min(t.numel() * t.element_size()
                   for t in torch.utils._pytree.tree_leaves(params) if t.dim() >= 2)
    for name, n_args in ((f"prefill_{P_PAD}", 4), ("decode", 5)):
        art = aot.load_artifact(bundle[name])
        kinds, users, const_bytes = _program_tensors(art)
        assert set(kinds) <= {InputKind.USER_INPUT, InputKind.CONSTANT_TENSOR}, (name, kinds)
        assert users == leaves + n_args, (name, users)
        assert all(b < smallest for b in const_bytes), (name, const_bytes, smallest)
        assert sum(const_bytes) <= 1024, (name, const_bytes)
        assert art.program.example_inputs is None
        sizes = {i.filename: i.file_size
                 for i in zipfile.ZipFile(io.BytesIO(bundle[name])).infolist()}
        stored = {f: n for f, n in sizes.items() if "/data/" in f and not f.endswith(".json")}
        assert any("sample_inputs" in f for f in stored), sizes
        assert all(n < smallest for n in stored.values()), (name, stored, smallest)


def test_programs_hold_no_nodes_that_do_nothing(bundle):
    """The dtype asserts export adds before each ``.to`` and the ``.to`` calls
    to the dtype a tensor already has are dropped before saving (each would
    be one more dispatched call a step), and no grad-mode switch is traced."""
    aten = torch.ops.aten
    for blob in bundle.values():
        nodes = [n for n in aot.load_artifact(blob).program.graph.nodes
                 if n.op == "call_function"]
        assert not [n for n in nodes if n.target is aten._assert_tensor_metadata.default]
        assert all(n.args[0].meta["val"].dtype != n.meta["val"].dtype
                   for n in nodes if n.target is aten.to.dtype)
        assert not [n for n in nodes if "grad" in str(n.target)]


def _vit_pair(width_pruned: bool):
    """(jax params, jax cfg, torch params, torch cfg): tests/test_aot.py's
    ViT, and its width-materialized tree (64 of 128 neurons pruned a block)."""
    from ssp_x_vit_tpu.models import vit as jvit
    from ssp_x_vit_tpu.pruning import materialize_width_pruning as jwidth
    from ssp_x_vit_tpu.pruning import select_keep_indices, weight_l1_importance
    from ssp_x_vit_tpu_torch.models import vit as tvit
    from ssp_x_vit_tpu_torch.models.checkpoints import params_from_jax
    from ssp_x_vit_tpu_torch.pruning import materialize_width_pruning as twidth

    jcfg = jvit.ViTConfig(image_size=32, patch_size=8, hidden_size=64, num_layers=2,
                          num_heads=4, intermediate_size=128, num_classes=10)
    jparams = jvit.init_vit_params(jax.random.PRNGKey(0), jcfg)
    tcfg = tvit.ViTConfig(**dataclasses.asdict(jcfg))
    tparams = params_from_jax(jax.device_get(jparams), device="cpu")
    if width_pruned:
        keep = select_keep_indices(weight_l1_importance(jparams),
                                   n_to_prune_per_block=[64] * jcfg.num_layers,
                                   min_remaining=32, verbose=False).keep_indices
        jparams, jcfg = jwidth(jparams, jcfg, keep)
        tparams, tcfg = twidth(tparams, tcfg, keep)
    return jparams, jcfg, tparams, tcfg


@pytest.mark.parametrize("width_pruned", [False, True], ids=["dense", "width-materialized"])
def test_vit_artifact_matches_live_and_jax(tmp_path, width_pruned):
    """ViT classify artifact through disk == the live forward (1e-6), and
    within 1e-4 of the JAX artifact on the same weights and pixels."""
    from ssp_x_vit_tpu_torch.models import vit as tvit

    jparams, jcfg, params, cfg = _vit_pair(width_pruned)
    px = np.random.default_rng(1).normal(size=(2, 32, 32, 3)).astype(np.float32)
    (tmp_path / "vit.pt2").write_bytes(aot.export_vit_classify(params, cfg, batch=2,
                                                               compute_dtype=torch.float32))
    art = aot.load_artifact((tmp_path / "vit.pt2").read_bytes())
    got = art.call(params, torch.from_numpy(px))
    ref, _ = tvit.vit_forward(params, torch.from_numpy(px), cfg, compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-6, atol=1e-6)
    jart = jaot.load_artifact(jaot.export_vit_classify(jparams, jcfg, batch=2,
                                                       compute_dtype=jnp.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(jart.call(jparams, jnp.asarray(px))),
                               rtol=1e-4, atol=1e-4)


def test_cpu_artifact_holds_no_operator_and_refuses_other_devices(model, bundle):
    """In place of the TPU cross-lowering: an artifact exported from CPU
    tensors traced the plain versions (no ``ssp`` node) and runs on the CPU
    only; an input on another device raises, nothing is moved."""
    _, _, params, cfg = model
    art = aot.load_artifact(bundle["decode"])
    assert art.device == torch.device("cpu") and art.operator_counts() == {}
    ck, cv = tserve.init_cache(cfg, 1, MAX_LEN, torch.float32, device="cpu")
    with pytest.raises(ValueError, match="runs on cpu; an input is on meta"):
        art.call(params, torch.tensor([5]), ck, cv, torch.tensor(P_PAD, device="meta"),
                 torch.tensor([0]))


def _traced_kernel_path(monkeypatch, export):
    """``export()`` with the wrappers' kernel path forced on CPU tensors: the
    trace sees the operators' fake implementations; the artifact round-trips
    through ``torch.export.save`` / ``load`` with its ``ssp`` nodes."""
    monkeypatch.setattr(dispatch, "use_kernel", lambda x: x.device.type in ("cpu", "cuda"))
    blob = export()
    monkeypatch.undo()
    return aot.load_artifact(blob)


@pytest.mark.parametrize("heads,row", [(4, "fused_attn_block_v2"), (3, "fused_attn_block")])
def test_vit_kernel_path_traces_one_operator_a_block(monkeypatch, heads, row):
    """The ViT forward's graph holds one attention operator (row 1 for an even
    head count, row 2 for an odd one) and one ``fused_ffn_block`` a block;
    calling it on the CPU raises (the operators are registered for CUDA only)."""
    from ssp_x_vit_tpu_torch.models import vit as tvit

    cfg = tvit.ViTConfig(image_size=32, patch_size=8, hidden_size=48, num_layers=2,
                         num_heads=heads, intermediate_size=96, num_classes=10)
    params = tvit.init_vit_params(cfg, seed=0, device="cpu")
    art = _traced_kernel_path(monkeypatch, lambda: aot.export_vit_classify(
        params, cfg, batch=2, compute_dtype=torch.float32))
    assert art.operator_counts() == {row: 2, "fused_ffn_block": 2}
    with pytest.raises(NotImplementedError, match="ssp::"):
        art.call(params, torch.zeros(2, 32, 32, 3))


@pytest.mark.parametrize("tree,kind,want", [("int8", "prefill", {"fused_mlp_int8": 2}),
                                            ("int4", "decode", {"quant4_matmul": 14})])
def test_llm_kernel_path_traces_one_operator_a_call(monkeypatch, tree, kind, want):
    """The 2-layer LLM graphs: one ``fused_mlp_int8`` a layer on an unpacked
    int8 tree, seven ``quant4_matmul`` a layer on an int4 tree."""
    from ssp_x_vit_tpu_torch.llm.quant import quantize_llm_params_int4, quantize_llm_params_int8

    cfg = tmodel.LlamaConfig(**CFG)
    params = tmodel.init_llama_params(None, cfg, device="cpu")
    params = (quantize_llm_params_int8 if tree == "int8" else quantize_llm_params_int4)(params,
                                                                                        cfg)
    art = _traced_kernel_path(monkeypatch, lambda: (
        aot.export_prefill(params, cfg, batch=2, p_pad=8, max_len=12) if kind == "prefill"
        else aot.export_decode_step(params, cfg, batch=2, max_len=12)))
    assert art.operator_counts() == want


def test_loaded_bundle_runs_without_model_code(model, bundle, tmp_path):
    """A fresh process loads the bundle and the parameters (``torch.save``),
    drives 8 greedy tokens through the artifacts, and has imported neither
    ``llm.serve``, ``llm.model`` nor ``models.vit``; its tokens are the live
    path's."""
    _, _, params, cfg = model
    aot.save_bundle(bundle, str(tmp_path / "art"))
    torch.save(params, str(tmp_path / "params.pt"))
    shape = (cfg.num_layers, 1, MAX_LEN, cfg.num_kv_heads, cfg.head_dim)
    code = textwrap.dedent(f"""
        import sys, torch
        torch.set_num_threads(1)
        from ssp_x_vit_tpu_torch.llm.aot import load_bundle
        arts = load_bundle({str(tmp_path / "art")!r})
        params = torch.load({str(tmp_path / "params.pt")!r})
        prompt, p_pad = {PROMPT!r}, {P_PAD}
        ck, cv = torch.zeros({shape!r}), torch.zeros({shape!r})
        toks = torch.zeros((1, p_pad), dtype=torch.int64)
        toks[0, p_pad - len(prompt):] = torch.tensor(prompt)
        pads = torch.tensor([p_pad - len(prompt)])
        logits, ck, cv = arts["prefill_" + str(p_pad)].call(params, toks, ck, cv, pads)
        out, pos = [int(logits.argmax())], torch.tensor(p_pad)
        for _ in range({STEPS - 1}):
            logits, ck, cv = arts["decode"].call(params, torch.tensor(out[-1:]), ck, cv, pos,
                                                 pads)
            out.append(int(logits.argmax()))
            pos = pos + 1
        loaded = sorted(m for m in sys.modules if m in (
            "ssp_x_vit_tpu_torch.llm.serve", "ssp_x_vit_tpu_torch.llm.model",
            "ssp_x_vit_tpu_torch.models.vit"))
        print(prompt + out, loaded)
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=ROOT), timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    ref = tserve.generate_kv_scan(params, cfg, np.asarray(PROMPT), max_length=len(PROMPT) + STEPS,
                                  cache_dtype=torch.float32)
    assert res.stdout.strip().splitlines()[-1] == f"{ref.tolist()} []"
