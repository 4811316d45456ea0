"""Gradients through the ported ViT block kernels against the JAX package on
the CPU, fp32.

- ``fused_ffn`` / ``fused_ffn_block``: every input's gradient against
  ``jax.grad`` through the Pallas kernels in interpret mode (their
  ``custom_vjp``), with and without biases, neuron mask and gate.
- ``vit_forward(..., allow_fused_attn=False)``: logits and a loss gradient
  against the JAX forward with the same switch on a 2-layer tiny ViT.
- The routing of the wrappers under autograd (the kernel forward in a
  ``torch.autograd.Function``, the attention blocks raising) with the kernel
  launch replaced by its plain version, since the CPU has no card.
- ``evaluate_top1``'s ``token_keep_schedule``.

Inputs are made with numpy from a seed and handed to both packages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ssp_x_vit_tpu.models import vit as jvit
from ssp_x_vit_tpu.ops.pallas import fused_ffn as jfused
from ssp_x_vit_tpu_torch.evaluation.classify import evaluate_top1
from ssp_x_vit_tpu_torch.models import vit as tvit
from ssp_x_vit_tpu_torch.models.checkpoints import params_from_jax
from ssp_x_vit_tpu_torch.ops import dispatch
from ssp_x_vit_tpu_torch.ops.kernels import fused_attn_block as tfab
from ssp_x_vit_tpu_torch.ops.kernels import fused_ffn as tfused

ATOL = 1e-5  # fp32: the same autodiff of the same math, other summation orders


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's tiny tensors: the suite runs six
    workers on the host's cores, where a pool per worker only contends."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ffn_arrays(seed, b, s, d, f, with_bias, with_mask):
    rng = np.random.default_rng(seed)
    arrays = {"x": rng.normal(size=(b, s, d)), "w1": rng.normal(size=(d, f)) * 0.2,
              "w2": rng.normal(size=(f, d)) * 0.1, "ct": rng.normal(size=(b, s, d))}
    if with_bias:
        arrays["b1"] = rng.normal(size=f) * 0.1
        arrays["b2"] = rng.normal(size=d) * 0.1
    mask = (rng.random(f) > 0.3).astype(np.float32) if with_mask else None
    return {k: v.astype(np.float32) for k, v in arrays.items()}, mask, rng


def _torch_grads(fn, arrays, names):
    leaves = {k: torch.from_numpy(v).requires_grad_(k in names) for k, v in arrays.items()}
    out = fn(leaves)
    assert out.grad_fn is not None
    (out * leaves["ct"]).sum().backward()
    return {k: leaves[k].grad.numpy() for k in names}


def _jax_grads(fn, arrays, names):
    def loss(diff):
        return jnp.sum(fn({**arrays, **diff}) * arrays["ct"])

    grads = jax.grad(loss)({k: jnp.asarray(arrays[k]) for k in names})
    return {k: np.asarray(v) for k, v in grads.items()}


def _assert_grads(got, ref):
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=ATOL, err_msg=f"d{k}")


@pytest.mark.parametrize("with_bias,with_mask", [(True, True), (True, False), (False, True),
                                                 (False, False)])
def test_fused_ffn_grads_match_jax_custom_vjp(with_bias, with_mask):
    arrays, mask, _ = _ffn_arrays(10, 2, 24, 16, 48, with_bias, with_mask)
    names = ["x", "w1", "w2"] + (["b1", "b2"] if with_bias else [])

    def port(t):
        out, stats = tfused.fused_ffn(t["x"], t["w1"], t.get("b1"), t["w2"], t.get("b2"),
                                      neuron_mask=None if mask is None else torch.from_numpy(mask),
                                      collect_stats=True)
        assert stats.grad_fn is None  # no gradient through the stats side output
        return out

    def ref(a):
        with pltpu.force_tpu_interpret_mode():
            out, _ = jfused.fused_ffn(a["x"], a["w1"], a.get("b1"), a["w2"], a.get("b2"),
                                      neuron_mask=None if mask is None else jnp.asarray(mask),
                                      collect_stats=True)
        return out

    _assert_grads(_torch_grads(port, arrays, names), _jax_grads(ref, arrays, names))


@pytest.mark.parametrize("with_bias,with_mask,gate", [(True, True, 0.7), (True, False, None),
                                                      (False, True, None), (False, False, 0.3)])
def test_fused_ffn_block_grads_match_jax_custom_vjp(with_bias, with_mask, gate):
    """Gradients of x, the LayerNorm, the weights and (a tensor) gate."""
    arrays, mask, rng = _ffn_arrays(11, 2, 20, 16, 40, with_bias, with_mask)
    arrays["lns"] = (1 + 0.1 * rng.normal(size=16)).astype(np.float32)
    arrays["lnb"] = (0.1 * rng.normal(size=16)).astype(np.float32)
    if gate is not None:
        arrays["gate"] = np.array(gate, np.float32)
    names = ["x", "lns", "lnb", "w1", "w2"] + (["b1", "b2"] if with_bias else []) + \
        (["gate"] if gate is not None else [])

    def port(t):
        out, stats = tfused.fused_ffn_block(
            t["x"], t["lns"], t["lnb"], t["w1"], t.get("b1"), t["w2"], t.get("b2"),
            neuron_mask=None if mask is None else torch.from_numpy(mask), gate=t.get("gate"),
            collect_stats=True, eps=1e-6)
        assert stats.grad_fn is None
        return out

    def ref(a):
        with pltpu.force_tpu_interpret_mode():
            out, _ = jfused.fused_ffn_block(
                a["x"], a["lns"], a["lnb"], a["w1"], a.get("b1"), a["w2"], a.get("b2"),
                neuron_mask=None if mask is None else jnp.asarray(mask),
                gate=a.get("gate", 1.0), collect_stats=True, eps=1e-6)
        return out

    _assert_grads(_torch_grads(port, arrays, names), _jax_grads(ref, arrays, names))


def _tiny_vit():
    cfg = jvit.ViTConfig(image_size=16, patch_size=8, hidden_size=32, num_layers=2,
                         num_heads=2, intermediate_size=64, num_classes=5)
    params = jax.device_get(jvit.init_vit_params(jax.random.PRNGKey(5), cfg))
    rng = np.random.default_rng(12)
    px = rng.normal(size=(3, 16, 16, 3)).astype(np.float32)
    ct = rng.normal(size=(3, 5)).astype(np.float32)
    return cfg, params, px, ct


def test_vit_forward_without_fused_blocks_matches_jax():
    """Logits (atol 1e-5) and the gradient of sum(logits * ct) with respect to
    every parameter (atol 1e-5), gates and a neuron mask on."""
    cfg, params, px, ct = _tiny_vit()
    gate = np.array([1.0, 0.5], np.float32)
    nmask = (np.random.default_rng(13).random((2, 64)) > 0.3).astype(np.float32)

    def jloss(p):
        logits, _ = jvit.vit_forward(p, jnp.asarray(px), cfg, attn_gate=jnp.asarray(gate),
                                     neuron_mask=jnp.asarray(nmask), allow_fused_attn=False)
        return jnp.sum(logits * ct), logits

    (_, jlogits), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    tparams = params_from_jax(params, device="cpu")
    leaves = [t.requires_grad_() for t in jax.tree_util.tree_leaves(tparams)]
    logits, _ = tvit.vit_forward(tparams, torch.from_numpy(px),
                                 tvit.ViTConfig(**dataclasses.asdict(cfg)),
                                 attn_gate=torch.from_numpy(gate),
                                 neuron_mask=torch.from_numpy(nmask), allow_fused_attn=False)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), rtol=0, atol=1e-5)
    (logits * torch.from_numpy(ct)).sum().backward()
    ref = jax.tree_util.tree_leaves(jgrads)
    assert len(ref) == len(leaves)
    for got, want in zip(leaves, ref):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_vit_forward_materialized_without_fused_blocks_equals_the_fused_path():
    """On the CPU both switches run plain math: the same logits bit for bit."""
    cfg, params, px, _ = _tiny_vit()
    tcfg = dataclasses.replace(tvit.ViTConfig(**dataclasses.asdict(cfg)),
                               pruned_attention_blocks=(1,))
    tparams = params_from_jax(params, device="cpu")
    tparams["blocks"] = {k: (v[:1] if k in ("ln1_scale", "ln1_bias", "qkv_kernel", "qkv_bias",
                                            "proj_kernel", "proj_bias") else v)
                         for k, v in tparams["blocks"].items()}
    fused = tvit.vit_forward_materialized(tparams, torch.from_numpy(px), tcfg)
    plain = tvit.vit_forward_materialized(tparams, torch.from_numpy(px), tcfg,
                                          allow_fused_attn=False)
    torch.testing.assert_close(plain, fused, rtol=0, atol=0)


@pytest.fixture
def kernel_path_on_the_cpu(monkeypatch):
    """Take the wrappers' kernel path on CPU tensors, the launch replaced by
    the plain version; counts the launches."""
    launches = []

    def fake_ffn_cuda(x, ln, w1, b1, w2, b2, mask, gate, collect_stats, eps, residual=True):
        launches.append(ln is not None)
        if ln is None:
            return tfused.fused_ffn_plain(x, w1, b1, w2, b2, neuron_mask=mask,
                                          collect_stats=collect_stats)
        return tfused.fused_ffn_block_plain(x, ln[0], ln[1], w1, b1, w2, b2, neuron_mask=mask,
                                            gate=gate, collect_stats=collect_stats, eps=eps,
                                            residual=residual)

    monkeypatch.setattr(dispatch, "use_kernel", lambda x: True)
    monkeypatch.setattr(tfused, "_ffn_cuda", fake_ffn_cuda)
    monkeypatch.setattr(dispatch, "gate_tensor", lambda gate, device: gate)
    return launches


def test_ffn_kernel_path_under_autograd_has_a_grad_fn(kernel_path_on_the_cpu):
    """Under autograd the kernel runs inside the Function and the backward is
    the plain version's; without a gradient the kernel runs as before."""
    arrays, _, rng = _ffn_arrays(14, 1, 12, 8, 24, True, False)
    lns, lnb = torch.ones(8), torch.zeros(8)
    t = {k: torch.from_numpy(v) for k, v in arrays.items()}
    out, _ = tfused.fused_ffn_block(t["x"], lns, lnb, t["w1"], t["b1"], t["w2"], t["b2"])
    assert out.grad_fn is None and kernel_path_on_the_cpu == [True]
    x = t["x"].clone().requires_grad_()
    out, _ = tfused.fused_ffn_block(x, lns, lnb, t["w1"], t["b1"], t["w2"], t["b2"])
    assert out.grad_fn is not None and kernel_path_on_the_cpu == [True, True]
    out.sum().backward()
    x_ref = t["x"].clone().requires_grad_()
    ref, _ = tfused.fused_ffn_block_plain(x_ref, lns, lnb, t["w1"], t["b1"], t["w2"], t["b2"])
    ref.sum().backward()
    torch.testing.assert_close(x.grad, x_ref.grad, rtol=0, atol=0)
    with torch.no_grad():
        out, _ = tfused.fused_ffn(x, t["w1"], t["b1"], t["w2"], t["b2"])
    assert out.grad_fn is None and kernel_path_on_the_cpu == [True, True, False]


@pytest.mark.parametrize("row", ["fused_attn_block_v2", "fused_attn_block"])
def test_attention_block_kernels_raise_under_autograd(monkeypatch, row):
    monkeypatch.setattr(dispatch, "use_kernel", lambda x: True)
    rng = np.random.default_rng(15)
    d = 8
    x = torch.from_numpy(rng.normal(size=(1, 4, d)).astype(np.float32)).requires_grad_()
    w = [torch.ones(d), torch.zeros(d), torch.zeros(d, 3 * d), torch.zeros(3 * d),
         torch.zeros(d, d), torch.zeros(d)]
    with pytest.raises(RuntimeError, match="allow_fused_attn=False"):
        getattr(tfab, row)(x, *w, 2)


def test_evaluate_top1_token_keep_schedule(tiny_batches):
    """A token-pruned evaluation is the top-1 of the token-pruned forward's
    logits (the schedule used to raise before token pruning was ported); an
    empty schedule is the plain evaluation."""
    from ssp_x_vit_tpu_torch.models.token_pruning import vit_forward_token_pruned

    cfg, params, _, _ = _tiny_vit()
    tcfg = dataclasses.replace(tvit.ViTConfig(**dataclasses.asdict(cfg)), image_size=32)
    tparams = tvit.init_vit_params(tcfg, seed=1, device="cpu")
    batches = [{"pixel_values": torch.tensor(np.asarray(b["pixel_values"])),
                "labels": torch.tensor(np.asarray(b["labels"]))} for b in tiny_batches[:2]]
    sched = ((1, 8),)
    hits = sum(int((vit_forward_token_pruned(tparams, b["pixel_values"], tcfg, sched)
                    .argmax(-1) == b["labels"]).sum()) for b in batches)
    total = sum(len(b["labels"]) for b in batches)
    assert evaluate_top1(tparams, tcfg, batches, token_keep_schedule=sched) == hits / total
    assert evaluate_top1(tparams, tcfg, batches, token_keep_schedule=()) == \
        evaluate_top1(tparams, tcfg, batches)
