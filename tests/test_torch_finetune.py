"""The port's ViT finetuning, distillation and LoRA steps against the JAX
package on the CPU, fp32.

A tiny ViT (hidden 48, 3 layers, 4 heads, FFN 96, 32x32 images in patches of
8) and a tiny llama carry numpy-seeded weights into both packages
(``params_from_jax`` / ``llm_params_from_jax``); LoRA adapters are carried the
same way, since JAX's random stream cannot be reproduced. The JAX side runs
its own XLA path (``allow_fused_attn=False``, no Pallas), as its tests do.

Tolerances: losses and gradients within 1e-5 relative (of max(1, max |grad|)
for gradients); parameters after AdamW steps within 1e-5 of max(1, |jax|);
frozen leaves (the backbone in head mode, the LoRA base, a teacher) bit for
bit. One exception, pinned here: the gradient of the key part of
``qkv_bias`` is zero in exact arithmetic (a key bias adds the same q . b to
every logit of a row, which the softmax ignores), so both frameworks hand
Adam rounding noise there (|grad| <= 1e-6, asserted) and Adam scales it to
+-lr per step; those elements are held within 2 * lr * steps.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ssp_x_vit_tpu.llm import lora as jlora
from ssp_x_vit_tpu.llm import model as jllm
from ssp_x_vit_tpu.models import vit as jvit
from ssp_x_vit_tpu.pruning import depth as jdepth
from ssp_x_vit_tpu.pruning import finetune as jft
from ssp_x_vit_tpu.pruning import width as jwidth
from ssp_x_vit_tpu_torch.llm import checkpoints as tllm_ckpt
from ssp_x_vit_tpu_torch.llm import lora as tlora
from ssp_x_vit_tpu_torch.llm import model as tllm
from ssp_x_vit_tpu_torch.llm.optim import AdamW
from ssp_x_vit_tpu_torch.models import vit as tvit
from ssp_x_vit_tpu_torch.models.checkpoints import params_from_jax
from ssp_x_vit_tpu_torch.ops.kernels import fused_ffn as tfused
from ssp_x_vit_tpu_torch.pruning import depth as tdepth
from ssp_x_vit_tpu_torch.pruning import finetune as tft
from ssp_x_vit_tpu_torch.pruning import width as twidth

KW = dict(image_size=32, patch_size=8, hidden_size=48, num_layers=3, num_heads=4,
          intermediate_size=96, num_classes=10)
JCFG, TCFG = jvit.ViTConfig(**KW), tvit.ViTConfig(**KW)
D = KW["hidden_size"]
LR = 1e-3
REL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's tiny tensors: the suite runs six
    workers on the host's cores, where a pool per worker only contends."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_tree(seed):
    """numpy ViT tree: kernels ~ N(0, 0.1), LayerNorm scales ~ 1 + N(0, 0.1)."""
    shapes = jax.eval_shape(lambda: jvit.init_vit_params(jax.random.PRNGKey(0), JCFG))
    rng = np.random.default_rng(seed)

    def leaf(name, shape):
        base = 1.0 if "scale" in name else 0.0
        return (base + 0.1 * rng.normal(size=shape)).astype(np.float32)

    return {k: ({kk: leaf(kk, vv.shape) for kk, vv in v.items()} if isinstance(v, dict)
                else leaf(k, v.shape)) for k, v in shapes.items()}


def batch(seed, b=4):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, 32, 32, 3)).astype(np.float32),
            rng.integers(0, KW["num_classes"], b).astype(np.int32))


def jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flat(v, path))
        else:
            out[path] = np.array(v.detach() if isinstance(v, torch.Tensor) else v)
    return out


def key_bias(path, arr):
    """Boolean mask of the key part of a qkv_bias leaf (False elsewhere)."""
    mask = np.zeros(arr.shape, bool)
    if path.endswith("qkv_bias"):
        mask[..., D:2 * D] = True
    return mask


def assert_trees_close(got, want, *, steps=0, lr=LR):
    got, want = flat(got), flat(want)
    assert got.keys() == want.keys()
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape, path
        noise = key_bias(path, w) if steps else np.zeros(w.shape, bool)
        err = np.abs(g - w)
        assert (err[~noise] <= REL * np.maximum(1.0, np.abs(w[~noise]))).all(), \
            f"{path}: {err[~noise].max()}"
        assert (err[noise] <= 2 * lr * steps).all(), path


def assert_unchanged(got, start, paths=None):
    got, start = flat(got), flat(start)
    for path in paths or start:
        np.testing.assert_array_equal(got[path], start[path], err_msg=path)


def pruned(tree, dense_t=None):
    """(jax, torch) trees and configs of the same 2SSP-materialized model (FFN
    64 of 96 in every block, block 1's attention removed); the torch one from
    ``dense_t`` when given (it then shares that tree's unpruned leaves)."""
    keep = [np.sort(np.random.default_rng(7 + i).permutation(96)[:64]) for i in range(3)]
    jp, jc = jwidth.materialize_width_pruning(jtree(tree), JCFG, keep)
    jp, jc = jdepth.materialize_depth_pruning(jp, jc, [1])
    if dense_t is None:
        dense_t = params_from_jax(tree, device="cpu")
    tp, tc = twidth.materialize_width_pruning(dense_t, TCFG, keep)
    tp, tc = tdepth.materialize_depth_pruning(tp, tc, [1])
    return jp, jc, tp, tc


@pytest.mark.parametrize("module", ["pruning.finetune", "llm.lora", "models.quant",
                                    "models.adapter"])
def test_port_modules_carry_the_jax_modules_public_names(module):
    import importlib

    jmod = importlib.import_module(f"ssp_x_vit_tpu.{module}")
    tmod = importlib.import_module(f"ssp_x_vit_tpu_torch.{module}")
    public = {n for n, v in vars(jmod).items() if not n.startswith("_")
              and getattr(v, "__module__", jmod.__name__) == jmod.__name__
              and (callable(v) or n.isupper())}
    assert public and public <= set(vars(tmod)), public - set(vars(tmod))


def test_cross_entropy_loss_matches_jax():
    rng = np.random.default_rng(1)
    logits = (3 * rng.normal(size=(6, 10))).astype(np.float32)
    labels = rng.integers(0, 10, 6).astype(np.int32)
    want = float(jft.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels)))
    got = tft.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels)).item()
    assert abs(got - want) <= 1e-6 * abs(want)


@pytest.mark.parametrize("trainable", ["all", "head"])
def test_trainable_mask_matches_jax(trainable):
    tree = make_tree(0)
    want = flat(jft.trainable_mask(jtree(tree), trainable))
    got = flat(tft.trainable_mask(params_from_jax(tree, device="cpu"), trainable))
    assert {k: bool(v) for k, v in got.items()} == {k: bool(v) for k, v in want.items()}
    with pytest.raises(ValueError, match="unknown trainable spec"):
        tft.make_optimizer(params_from_jax(tree, device="cpu"), trainable="blocks")


@pytest.mark.parametrize("model", ["dense", "materialized"])
def test_loss_and_gradients_match_jax(model):
    tree = make_tree(1)
    px, labels = batch(2)
    if model == "dense":
        jp, jc, tp, tc = jtree(tree), JCFG, params_from_jax(tree, device="cpu"), TCFG
    else:
        jp, jc, tp, tc = pruned(tree)

    def jloss(p):
        if jc.pruned_attention_blocks:
            logits = jvit.vit_forward_materialized(p, jnp.asarray(px), jc,
                                                   allow_fused_attn=False)
        else:
            logits, _ = jvit.vit_forward(p, jnp.asarray(px), jc, allow_fused_attn=False)
        return jft.cross_entropy_loss(logits, jnp.asarray(labels))

    loss_j, grads_j = jax.value_and_grad(jloss)(jp)
    alias = {k: {kk: vv.detach().requires_grad_(True) for kk, vv in v.items()}
             if isinstance(v, dict) else v.detach().requires_grad_(True) for k, v in tp.items()}
    logits = (tvit.vit_forward_materialized(alias, torch.from_numpy(px), tc,
                                            allow_fused_attn=False)
              if tc.pruned_attention_blocks else
              tvit.vit_forward(alias, torch.from_numpy(px), tc, allow_fused_attn=False)[0])
    loss = tft.cross_entropy_loss(logits, torch.from_numpy(labels).long())
    loss.backward()
    assert abs(loss.item() - float(loss_j)) <= REL * abs(float(loss_j))
    want = flat(grads_j)
    got = {k: t.grad.numpy() for k, t in flat_tensors(alias).items()}
    for path, w in want.items():
        scale = max(1.0, np.abs(w).max())
        np.testing.assert_allclose(got[path], w, rtol=0, atol=REL * scale, err_msg=path)
    # the zero-in-exact-arithmetic direction of the docstring
    assert np.abs(want["blocks/qkv_bias"][..., D:2 * D]).max() <= 1e-6


@pytest.fixture(scope="module")
def jax_steps():
    """Three JAX train steps per trainable spec from make_tree(3), batch(4): losses
    and final params (the JAX step donates its inputs, so each run starts from
    fresh arrays)."""
    tree, (px, labels) = make_tree(3), batch(4)
    out = {}
    for trainable in ("all", "head"):
        jp = jtree(tree)
        opt = jft.make_optimizer(jp, lr=LR, trainable=trainable)
        state = opt.init(jp)
        step = jft.make_train_step(JCFG, opt, compute_dtype=jnp.float32)
        losses = []
        for _ in range(3):
            jp, state, loss = step(jp, state, jnp.asarray(px), jnp.asarray(labels))
            losses.append(float(loss))
        out[trainable] = (losses, jax.device_get(jp))
    return tree, px, labels, out


@pytest.mark.parametrize("trainable", ["all", "head"])
def test_train_step_matches_jax(jax_steps, trainable):
    tree, px, labels, out = jax_steps
    want_losses, want_params = out[trainable]
    tp = params_from_jax(tree, device="cpu")
    opt = tft.make_optimizer(tp, lr=LR, trainable=trainable)
    state = opt.init(tp)
    step = tft.make_train_step(TCFG, opt, compute_dtype=torch.float32)
    losses = []
    for _ in range(3):
        got, state, loss = step(tp, state, px, labels)
        assert got is tp  # updated in place
        losses.append(loss.item())
    np.testing.assert_allclose(losses, want_losses, rtol=REL)
    assert_trees_close(tp, want_params, steps=3)
    if trainable == "head":
        heads = [p for p in flat(tree) if p.startswith("head/")]
        assert sorted(state["mu"]) == sorted(heads) == sorted(state["nu"])  # no backbone state
        assert_unchanged(tp, tree, [p for p in flat(tree) if p not in heads])
    else:
        assert len(state["mu"]) == len(flat(tree))


@pytest.mark.parametrize("trainable,calls", [("head", 0), ("all", 3)])
def test_frozen_backbone_builds_no_graph(monkeypatch, trainable, calls):
    """Frozen leaves are not autograd leaves: with the backbone frozen no FFN
    input requires a gradient, so the FFN runs outside its autograd Function
    (on the card: a plain kernel launch that saves nothing); with everything
    trainable each block's FFN runs inside it."""
    seen = []
    apply = tfused._FusedFFN.apply
    monkeypatch.setattr(tfused._FusedFFN, "apply", lambda *a: seen.append(1) or apply(*a))
    tp = params_from_jax(make_tree(5), device="cpu")
    opt = tft.make_optimizer(tp, lr=LR, trainable=trainable)
    step = tft.make_train_step(TCFG, opt, compute_dtype=torch.float32)
    step(tp, opt.init(tp), *batch(6))
    assert len(seen) == calls


def test_finetune_over_a_batch_list_matches_jax(capsys):
    tree = make_tree(8)
    batches = [dict(zip(("pixel_values", "labels"), batch(9 + i))) for i in range(2)]
    jp = jft.finetune(jtree(tree), JCFG, lambda: iter([{k: jnp.asarray(v) for k, v in b.items()}
                                                       for b in batches]),
                      epochs=2, lr=LR, trainable="all", compute_dtype=jnp.float32)
    want = capsys.readouterr().out.splitlines()
    tp = params_from_jax(tree, device="cpu")
    losses = []
    got = tft.finetune(tp, TCFG, lambda: iter(batches), epochs=2, lr=LR, trainable="all",
                       compute_dtype=torch.float32, losses=losses)
    lines = capsys.readouterr().out.splitlines()
    assert got is tp and len(losses) == 4
    assert lines[0] == want[0] and lines[-1] == want[-1] == "[INFO] Fine-tuning complete."
    means = [float(re.search(r"Mean loss: ([0-9.]+)", ln).group(1)) for ln in lines[1:3]]
    want_means = [float(re.search(r"Mean loss: ([0-9.]+)", ln).group(1)) for ln in want[1:3]]
    np.testing.assert_allclose(means, want_means, atol=1.5e-4)
    np.testing.assert_allclose(means, [np.mean(losses[:2]), np.mean(losses[2:])], atol=6e-5)
    assert_trees_close(tp, jax.device_get(jp), steps=4)


def test_distill_step_matches_jax():
    """Dense teacher, 2SSP-materialized student (FFN 64 of 96, block 1's
    attention removed), two KD steps; the teacher is left untouched although
    the student starts out sharing leaves with it."""
    tree, (px, labels) = make_tree(10), batch(11)
    teacher_j, teacher_t = jtree(tree), params_from_jax(tree, device="cpu")
    js, jsc, ts, tsc = pruned(tree, teacher_t)
    teacher_storages = {v.untyped_storage().data_ptr() for v in flat_tensors(teacher_t).values()}
    assert any(t.untyped_storage().data_ptr() in teacher_storages
               for t in flat_tensors(ts).values())  # the student shares the teacher's leaves
    js = jax.tree.map(jnp.copy, js)  # the JAX step donates the student's buffers
    jopt = jft.make_optimizer(js, lr=LR, trainable="all")
    jstep = jft.make_distill_train_step(teacher_j, JCFG, jsc, jopt, alpha=0.3,
                                        temperature=2.0, compute_dtype=jnp.float32)
    topt = tft.make_optimizer(ts, lr=LR, trainable="all")
    tstep = tft.make_distill_train_step(teacher_t, TCFG, tsc, topt, alpha=0.3,
                                        temperature=2.0, compute_dtype=torch.float32)
    jstate, tstate = jopt.init(js), topt.init(ts)
    for _ in range(2):
        js, jstate, jl = jstep(js, jstate, jnp.asarray(px), jnp.asarray(labels))
        ts, tstate, tl = tstep(ts, tstate, px, labels)
        assert abs(tl.item() - float(jl)) <= REL * abs(float(jl))
    assert_trees_close(ts, jax.device_get(js), steps=2)
    assert_unchanged(teacher_t, tree)


def flat_tensors(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(flat_tensors(v, path) if isinstance(v, dict) else {path: v})
    return out


def lora_arrays(params_np, targets, rank, seed):
    """Adapters as numpy: a ~ N(0, 1) / r, b ~ N(0, 0.02) (not zero, so the
    first step moves a too)."""
    rng = np.random.default_rng(seed)
    out = {}
    for t in targets:
        n_layers, d_in, d_out = params_np["blocks"][t].shape
        out[t] = {"a": (rng.normal(size=(n_layers, d_in, rank)) / rank).astype(np.float32),
                  "b": (0.02 * rng.normal(size=(n_layers, rank, d_out))).astype(np.float32)}
    return out


def test_vit_lora_step_matches_jax():
    tree, (px, labels) = make_tree(12), batch(13)
    lora_np = lora_arrays(tree, tft.VIT_LORA_TARGETS, 4, 14)
    assert tft.VIT_LORA_TARGETS == jft.VIT_LORA_TARGETS
    jopt = optax.adamw(LR)
    jstep = jft.make_lora_train_step(JCFG, jopt, alpha=8.0, compute_dtype=jnp.float32)
    base_t = params_from_jax(tree, device="cpu")
    lora_t = {t: {k: torch.from_numpy(v.copy()) for k, v in ab.items()}
              for t, ab in lora_np.items()}
    topt = AdamW(LR)  # optax.adamw's defaults: weight decay 1e-4
    tstep = tft.make_lora_train_step(TCFG, topt, alpha=8.0, compute_dtype=torch.float32)
    jl_tree, jstate, tstate = jtree(lora_np), None, topt.init(lora_t)
    jstate = jopt.init(jl_tree)
    for _ in range(3):
        jl_tree, jstate, jl = jstep(jtree(tree), jl_tree, jstate, jnp.asarray(px),
                                    jnp.asarray(labels))
        got, tstate, tl = tstep(base_t, lora_t, tstate, px, labels)
        assert got is lora_t
        assert abs(tl.item() - float(jl)) <= REL * abs(float(jl))
    assert_trees_close(lora_t, jax.device_get(jl_tree))
    assert len(tstate["mu"]) == 2 and set(tstate["mu"]) == set(tft.VIT_LORA_TARGETS)
    assert_unchanged(base_t, tree)


LLM_KW = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2,
              intermediate_size=48)


@pytest.fixture(scope="module")
def llm_model():
    jcfg = jllm.LlamaConfig(**LLM_KW)
    shapes = jax.eval_shape(lambda: jllm.init_llama_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(20)

    def leaf(name, shape):
        base = 1.0 if name.startswith("ln") or name.endswith("_norm") else 0.0
        return (base + 0.1 * rng.normal(size=shape)).astype(np.float32)

    tree = {k: ({kk: leaf(kk, vv.shape) for kk, vv in v.items()} if isinstance(v, dict)
                else leaf(k, v.shape)) for k, v in shapes.items()}
    tokens = np.random.default_rng(21).integers(0, 128, size=(3, 25)).astype(np.int32)
    return tree, jcfg, tllm.LlamaConfig(**LLM_KW), tokens


@pytest.mark.parametrize("remat", [True, False])
def test_llm_lora_step_matches_jax(llm_model, remat):
    tree, jcfg, tcfg, tokens = llm_model
    lora_np = lora_arrays(tree, tlora.DEFAULT_TARGETS, 4, 22)
    jopt = optax.adamw(LR)
    jstep = jlora.make_lora_train_step(jcfg, jopt, alpha=16.0, compute_dtype=jnp.float32,
                                       remat=remat)
    base_t = tllm_ckpt.llm_params_from_jax(tree, device="cpu")
    lora_t = {t: {k: torch.from_numpy(v.copy()) for k, v in ab.items()}
              for t, ab in lora_np.items()}
    tstep = tlora.make_lora_train_step(tcfg, AdamW(LR), alpha=16.0,
                                       compute_dtype=torch.float32, remat=remat)
    jl_tree = jtree(lora_np)
    jstate, tstate = jopt.init(jl_tree), AdamW(LR).init(lora_t)
    for _ in range(3):
        jl_tree, jstate, jl = jstep(jtree(tree), jl_tree, jstate, jnp.asarray(tokens))
        lora_t, tstate, tl = tstep(base_t, lora_t, tstate, tokens)
        assert abs(tl.item() - float(jl)) <= REL * abs(float(jl))
    assert_trees_close(lora_t, jax.device_get(jl_tree))
    assert_unchanged(base_t, tree)


def test_init_apply_and_merge_lora_match_jax(llm_model):
    tree, _, _, _ = llm_model
    base_t = tllm_ckpt.llm_params_from_jax(tree, device="cpu")
    lora = tlora.init_lora(torch.Generator().manual_seed(3), base_t, rank=4)
    assert set(lora) == set(tlora.DEFAULT_TARGETS) == set(jlora.DEFAULT_TARGETS)
    for t, ab in lora.items():
        n_layers, d_in, d_out = base_t["blocks"][t].shape
        assert ab["a"].shape == (n_layers, d_in, 4) and ab["b"].shape == (n_layers, 4, d_out)
        assert not ab["b"].any()  # b = 0: the adapted model is the base model
    same = tlora.apply_lora(base_t, lora)
    assert all(torch.equal(same["blocks"][t], base_t["blocks"][t]) for t in lora)
    lora_np = lora_arrays(tree, tlora.DEFAULT_TARGETS, 4, 23)
    want = flat(jlora.merge_lora(jtree(tree), jtree(lora_np), alpha=8.0))
    got = tlora.merge_lora(base_t, {t: {k: torch.from_numpy(v) for k, v in ab.items()}
                                    for t, ab in lora_np.items()}, alpha=8.0)
    assert not any(t.requires_grad for t in got["blocks"].values())
    for path, w in want.items():
        np.testing.assert_allclose(flat(got)[path], w, rtol=0, atol=1e-6, err_msg=path)
    with pytest.raises(ValueError, match="stacked 2-D kernels"):
        tlora.init_lora(None, {"blocks": {"q_kernel": torch.zeros(4, 4)}}, targets=("q_kernel",))


def test_finetune_refuses_inference_tensors_and_int8_leaves():
    tree = make_tree(30)
    with torch.inference_mode():
        inference = params_from_jax(tree, device="cpu")
    with pytest.raises(ValueError, match="inference tensors"):
        tft.finetune(inference, TCFG, lambda: [dict(zip(("pixel_values", "labels"), batch(31)))])
    tp = params_from_jax(tree, device="cpu")
    tp["blocks"]["fc1_kernel"] = tp["blocks"]["fc1_kernel"].to(torch.int8)
    with pytest.raises(TypeError, match="int8 leaf"):
        tft.make_optimizer(tp, trainable="all").init(tp)
    assert tft.make_optimizer(tp, trainable="head").init(tp)["count"] == 0
