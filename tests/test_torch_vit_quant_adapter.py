"""The port's int8 ViT, adapter heads, their persistence and the CLI's
recovery flags against the JAX package on the CPU, fp32.

A tiny ViT (hidden 64, 3 layers, 4 heads, FFN 128, 32x32 images in patches of
8) with numpy-seeded weights carried into both packages. Int8 codes must be
bit-identical and scales equal; quantized dense and 2SSP-materialized logits
and adapter-head logits within 1e-5 of max(1, |jax|); adapter files are read
by each package from the other's save.
"""

import dataclasses
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssp_x_vit_tpu.models import adapter as jadapter
from ssp_x_vit_tpu.models import persistence as jpersist
from ssp_x_vit_tpu.models import quant as jquant
from ssp_x_vit_tpu.models import vit as jvit
from ssp_x_vit_tpu.pruning import depth as jdepth
from ssp_x_vit_tpu.pruning import finetune as jft
from ssp_x_vit_tpu.pruning import width as jwidth
from ssp_x_vit_tpu_torch.models import adapter as tadapter
from ssp_x_vit_tpu_torch.models import persistence as tpersist
from ssp_x_vit_tpu_torch.models import quant as tquant
from ssp_x_vit_tpu_torch.models import vit as tvit
from ssp_x_vit_tpu_torch.models.checkpoints import params_from_jax
from ssp_x_vit_tpu_torch.pruning import depth as tdepth
from ssp_x_vit_tpu_torch.pruning import width as twidth

KW = dict(image_size=32, patch_size=8, hidden_size=64, num_layers=3, num_heads=4,
          intermediate_size=128, num_classes=10)
ADAPTER = dict(head_type="adapter", adapter_bottleneck=24)
TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's tiny tensors: the suite runs six
    workers on the host's cores, where a pool per worker only contends."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_tree(seed, **cfg_kw):
    jcfg = jvit.ViTConfig(**{**KW, **cfg_kw})
    shapes = jax.eval_shape(lambda: jvit.init_vit_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(seed)

    def leaf(name, shape):
        base = 1.0 if "scale" in name else 0.0
        return (base + 0.1 * rng.normal(size=shape)).astype(np.float32)

    tree = {k: ({kk: leaf(kk, vv.shape) for kk, vv in v.items()} if isinstance(v, dict)
                else leaf(k, v.shape)) for k, v in shapes.items()}
    return tree, jcfg, tvit.ViTConfig(**{**KW, **cfg_kw})


def pixels(seed, b=3):
    return np.random.default_rng(seed).normal(size=(b, 32, 32, 3)).astype(np.float32)


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


def materialized(tree, jcfg, tcfg):
    keep = [np.sort(np.random.default_rng(3 + i).permutation(128)[:80]) for i in range(3)]
    jp, jc = jdepth.materialize_depth_pruning(
        *jwidth.materialize_width_pruning(jtree(tree), jcfg, keep), [0, 2])
    tp, tc = tdepth.materialize_depth_pruning(
        *twidth.materialize_width_pruning(params_from_jax(tree, device="cpu"), tcfg, keep), [0, 2])
    return jp, jc, tp, tc


def models(kind):
    """(jax params, jax cfg, torch params, torch cfg) of the named test model."""
    if kind == "materialized":
        tree, jcfg, tcfg = make_tree(1)
        return materialized(tree, jcfg, tcfg)
    tree, jcfg, tcfg = make_tree(1, **(ADAPTER if kind == "adapter head" else {}))
    return jtree(tree), jcfg, params_from_jax(tree, device="cpu"), tcfg


def logits(params, cfg, px, jax_side):
    if jax_side:
        if cfg.pruned_attention_blocks:
            return np.asarray(jvit.vit_forward_materialized(params, jnp.asarray(px), cfg,
                                                            allow_fused_attn=False))
        return np.asarray(jvit.vit_forward(params, jnp.asarray(px), cfg,
                                           allow_fused_attn=False)[0])
    x = torch.from_numpy(px)
    if cfg.pruned_attention_blocks:
        return tvit.vit_forward_materialized(params, x, cfg).numpy()
    return tvit.vit_forward(params, x, cfg)[0].numpy()


def assert_logits(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("kind", ["dense", "materialized", "adapter head"])
def test_quantize_vit_params_int8_is_bit_identical_to_jax(kind):
    jp, jc, tp, tc = models(kind)
    want = flat(jax.device_get(jquant.quantize_vit_params_int8(jp, jc)))
    got = flat(tquant.quantize_vit_params_int8(tp, tc))
    assert got.keys() == want.keys()
    for path, w in want.items():
        assert got[path].dtype == w.dtype, path
        np.testing.assert_array_equal(got[path], w, err_msg=path)
    assert sum(p.endswith("_q") for p in got) == 4 + 1 + (2 if kind == "adapter head" else 1)


@pytest.mark.parametrize("kind", ["dense", "materialized", "adapter head"])
def test_quantized_forward_matches_jax(kind):
    jp, jc, tp, tc = models(kind)
    px = pixels(2)
    jq, tq = jquant.quantize_vit_params_int8(jp, jc), tquant.quantize_vit_params_int8(tp, tc)
    assert_logits(logits(tq, tc, px, False), logits(jq, jc, px, True))
    if kind == "dense":  # the quantized block's stats side output and gates
        gate = np.array([1.0, 0.0, 1.0], np.float32)
        want, waux = jvit.vit_forward(jq, jnp.asarray(px), jc, attn_gate=jnp.asarray(gate),
                                      collect_ffn_stats=True)
        got, gaux = tvit.vit_forward(tq, torch.from_numpy(px), tc,
                                     attn_gate=torch.from_numpy(gate), collect_ffn_stats=True)
        assert_logits(got.numpy(), np.asarray(want))
        np.testing.assert_allclose(gaux["ffn_stats"].numpy(), np.asarray(waux["ffn_stats"]),
                                   rtol=TOL, atol=TOL)


def test_adapter_head_matches_jax():
    jp, jc, tp, tc = models("adapter head")
    shapes = jax.eval_shape(lambda: jvit.init_head_params(jax.random.PRNGKey(0), jc))
    head = tvit.init_head_params(tc, seed=4, device="cpu")
    assert {k: tuple(v.shape) for k, v in head.items()} == {k: v.shape for k, v in shapes.items()}
    assert not head["b2"].any() and 0 < head["w0"].std().item() < 0.03
    px = pixels(5)
    assert_logits(logits(tp, tc, px, False), logits(jp, jc, px, True))
    with pytest.raises(ValueError, match="adapter_bottleneck > 0"):
        tvit.init_head_params(dataclasses.replace(tc, adapter_bottleneck=0), device="cpu")


@pytest.mark.parametrize("kind", ["dense", "adapter head"])
def test_adapter_npz_is_read_by_each_package_from_the_others_save(tmp_path, kind):
    jp, jc, tp, tc = models(kind)
    other_tree, other_jc, other_tc = make_tree(9, **(ADAPTER if kind == "adapter head" else {}))
    px = pixels(6)
    # port save -> JAX load onto another backbone
    path = tadapter.save_cifar_adapter(tp, tc, str(tmp_path / "port"), extra={"k": 1})
    jl, jlc = jadapter.load_cifar_adapter(path, jtree(other_tree), jvit.ViTConfig(**KW))
    assert dataclasses.asdict(jlc) == dataclasses.asdict(jc)
    for k, v in tp["head"].items():
        np.testing.assert_array_equal(np.asarray(jl["head"][k]), v.numpy())
    # JAX save -> port load onto another backbone
    jpath = jadapter.save_cifar_adapter(jp, jc, str(tmp_path / "jax"), extra={"k": 1})
    tl, tlc = tadapter.load_cifar_adapter(jpath, params_from_jax(other_tree, device="cpu"),
                                          tvit.ViTConfig(**KW))
    assert dataclasses.asdict(tlc) == dataclasses.asdict(tc)
    assert_logits(logits(tl, tlc, px, False), logits(jl, jlc, px, True))
    with open(path + ".json") as f, open(jpath + ".json") as g:
        mine, theirs = json.load(f), json.load(g)
    assert {k: v for k, v in mine.items() if k != "timestamp"} == \
        {k: v for k, v in theirs.items() if k != "timestamp"}


@pytest.mark.parametrize("kind", ["linear", "sequential"])
def test_adapter_pt_payload_loads_natively(tmp_path, kind):
    """A reference ``adapter.pt`` (``state_dict`` of a torch head, written here
    with ``torch.save``) loads into both packages alike."""
    torch.manual_seed(0)
    if kind == "linear":
        module = torch.nn.Linear(64, 7)
    else:
        module = torch.nn.Sequential(torch.nn.Linear(64, 16, bias=False), torch.nn.GELU(),
                                     torch.nn.Linear(16, 7))
    path = str(tmp_path / "adapter.pt")
    torch.save({"state_dict": module.state_dict()}, path)
    tree, jcfg, tcfg = make_tree(11)
    tp, tc = tadapter.load_cifar_adapter(path, params_from_jax(tree, device="cpu"), tcfg)
    jp, jc = jadapter.load_cifar_adapter(path, jtree(tree), jcfg)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.num_classes == 7 and tc.head_type == ("linear" if kind == "linear" else "adapter")
    px = pixels(12)
    out = logits(tp, tc, px, False)
    assert_logits(out, logits(jp, jc, px, True))
    _, aux = tvit.vit_forward(tp, torch.from_numpy(px), tc)
    with torch.no_grad():
        np.testing.assert_allclose(out, module(aux["cls_repr"]).numpy(), rtol=0, atol=1e-5)


def test_quantized_pruned_model_persists_with_int8_codes(tmp_path):
    jp, jc, tp, tc = models("materialized")
    tq = tquant.quantize_vit_params_int8(tp, tc)
    out = tpersist.save_pruned_model(str(tmp_path / "q"), tq, tc)
    loaded, lc = tpersist.load_pruned_model(out, device="cpu")
    assert lc == tc
    want, got = flat(tq), flat(loaded)
    assert got.keys() == want.keys()
    for path, w in want.items():
        assert got[path].dtype == w.dtype, path  # int8 codes stay int8, scales fp32
        np.testing.assert_array_equal(got[path], w, err_msg=path)
    px = pixels(13)
    np.testing.assert_array_equal(logits(loaded, lc, px, False), logits(tq, tc, px, False))
    jq, jlc = jpersist.load_pruned_model(out)  # the JAX package reads the port's int8 save
    assert_logits(logits(loaded, lc, px, False), logits(jq, jlc, px, True))


def _run_cli(tmp_path, name, *flags):
    from ssp_x_vit_tpu_torch.cli import auto_2ssp

    return auto_2ssp.run(auto_2ssp.build_argparser().parse_args([
        "--backend", "cpu", "--model", "tiny", "--dataset", "synthetic", "--target", "0.25",
        "--eval-batches", "2", "--min-remaining", "32", "--out-root", str(tmp_path / name),
        *flags]))


def test_cli_recovery_flags_on_cpu(tmp_path, capsys):
    from ssp_x_vit_tpu.cli.common import NAMED_CONFIGS

    report = _run_cli(tmp_path, "a", "--do-finetune", "--freeze-backbone", "--use-adapter",
                      "--save-adapter", "--quantize", "int8", "--save-pruned-model")
    out = capsys.readouterr().out
    assert set(report["phase_seconds"]) == set(report["kernel_launches"]) == {
        "setup", "finetune", "baseline", "candidates", "stats", "stage1", "materialized",
        "quantize"}
    m = report["metrics"]
    assert 0.0 <= m["acc_int8"] <= 1.0 and m["latency_int8_ms"] > 0
    assert re.search(r"\[QUANT\] int8: latency [0-9.]+ ms, top-1 [0-9.]+", out)
    with open(next((tmp_path / "a" / "reports").glob("*.json"))) as f:
        saved = json.load(f)
    assert saved["metrics"] == m and "finetune_losses" not in saved and "model" not in saved
    losses = report["finetune_losses"]
    assert len(losses) == 32 and np.isfinite(losses).all()  # 1024 images at b=32

    # the trainable count line is the JAX finetune's for the same config (the head only)
    jcfg = jvit.ViTConfig(num_classes=10, head_type="adapter", adapter_bottleneck=32,
                          **NAMED_CONFIGS["tiny"])
    jparams = jax.eval_shape(lambda: jvit.init_vit_params(jax.random.PRNGKey(0), jcfg))
    n_train = sum(int(np.prod(x.shape)) for m_, x in zip(
        jax.tree.leaves(jft.trainable_mask(jparams, "head")), jax.tree.leaves(jparams)) if m_)
    line = (f"[INFO] Fine-tuning (head) for 1 epoch(s) with {n_train/1e6:.2f}M "
            f"trainable params")
    assert line in out.splitlines()
    final, cfg = report["model"]
    assert sum(v.numel() for v in final["head"].values()) == n_train == 64 * 32 + 32 * 10 + 10

    # the adapter file reproduces the finetuned head, through the JAX loader too
    path = report["artifacts"]["adapter_path"]
    jl, jlc = jadapter.load_cifar_adapter(path, {}, jcfg)
    for k, v in final["head"].items():
        np.testing.assert_array_equal(np.asarray(jl["head"][k]), v.numpy())
    assert os.path.isdir(report["artifacts"]["pruned_model_int8_dir"])
    qp, qc = tpersist.load_pruned_model(report["artifacts"]["pruned_model_int8_dir"],
                                        device="cpu")
    assert qp["blocks"]["fc1_kernel_q"].dtype == torch.int8 and "w0_q" in qp["head"]

    # --load-adapter puts that head on a fresh model
    again = _run_cli(tmp_path, "b", "--load-adapter", path)
    assert again["model"][1].head_type == "adapter"
    for k, v in final["head"].items():
        assert torch.equal(again["model"][0]["head"][k], v)
    assert "finetune" not in again["phase_seconds"] and "acc_int8" not in again["metrics"]
