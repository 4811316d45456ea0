"""HF ViT directories, state-dict files and AugReg ``.npz`` in the port
(``models/checkpoints.py``: ``load_hf_vit``, ``export_hf_vit``,
``load_state_dict_file``, ``params_from_hf_state_dict``, ``load_augreg_npz``;
``cli/common.py`` ``resolve_model``; ``cli/auto_2ssp.py --save-format hf``)
against the JAX package, on the CPU, tiny configs.

Both ways: a JAX export loads into the JAX loader's values bit for bit (fp32
and bf16), the port's export of the same tree is byte-identical to the JAX
one, for a dense and a width-pruned model; the adapter head and attention
removal are refused before anything is written. A ``.bin`` state dict (also
nested under ``state_dict``) and an AugReg ``.npz`` made as
``tests/test_srp.py`` makes one load as the JAX readers load them.
"""

import dataclasses
import filecmp
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssp_x_vit_tpu.models import checkpoints as jckpt
from ssp_x_vit_tpu.models import vit as jvit
from ssp_x_vit_tpu.pruning import materialize_width_pruning as jwidth
from ssp_x_vit_tpu_torch.cli import common as tcommon
from ssp_x_vit_tpu_torch.models import checkpoints as tckpt
from ssp_x_vit_tpu_torch.models import vit as tvit

ARCH = dict(image_size=32, patch_size=8, hidden_size=64, num_layers=3, num_heads=4,
            intermediate_size=128)   # a NAMED_CONFIGS entry ("tiny3" below)
TINY = dict(ARCH, num_classes=10)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's tiny tensors: the suite runs six
    workers on the host's cores, where a pool per worker only contends."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_model(pruned=False, seed=0):
    cfg = jvit.ViTConfig(**TINY)
    params = jvit.init_vit_params(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)
    # non-trivial norms and biases, so every leaf's layout is visible
    params = jax.tree.map(lambda a: a + jnp.asarray(0.05 * rng.normal(size=a.shape), a.dtype),
                          params)
    if pruned:
        keep = [np.sort(rng.choice(cfg.intermediate_size, n, replace=False))
                for n in (100, 77, 120)]
        params, cfg = jwidth(params, cfg, keep)
    return params, cfg


def leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def assert_same_leaves(jtree, ttree):
    jl, tl = leaves(jtree), leaves(ttree)
    assert sorted(jl) == sorted(tl)
    for k, v in jl.items():
        assert tuple(tl[k].shape) == tuple(v.shape), k
        assert str(tl[k].dtype).split(".")[-1] == str(v.dtype), k
        np.testing.assert_array_equal(tl[k].float().numpy(), np.asarray(v.astype(jnp.float32)),
                                      err_msg=k)


def assert_same_logits(jp, jc, tp, tc):
    px = np.random.default_rng(1).normal(size=(2, 32, 32, 3)).astype(np.float32)
    ref, _ = jvit.vit_forward(jp, jnp.asarray(px), jc)
    got, _ = tvit.vit_forward(tp, torch.from_numpy(px), tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("pruned", [False, True], ids=["dense", "width_pruned"])
def test_hf_vit_both_ways_matches_jax(tmp_path, pruned):
    params, cfg = jax_model(pruned)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jckpt.export_hf_vit(jdir, params, cfg)
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        jp, jc = jckpt.load_hf_vit(jdir, dtype=jdt)
        tp, tc = tckpt.load_hf_vit(jdir, device="cpu", dtype=tdt)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert_same_leaves(jp, tp)
    jp, jc = jckpt.load_hf_vit(jdir)
    tp, tc = tckpt.load_hf_vit(jdir, device="cpu")
    tckpt.export_hf_vit(tdir, tp, tc)
    assert filecmp.cmp(os.path.join(jdir, "model.safetensors"),
                       os.path.join(tdir, "model.safetensors"), shallow=False)
    with open(os.path.join(jdir, "config.json")) as f, open(os.path.join(tdir, "config.json")) as g:
        assert f.read() == g.read()
    # the port's own tree exports byte for byte too
    from ssp_x_vit_tpu_torch.models.checkpoints import params_from_jax

    tcfg = tvit.ViTConfig(**dataclasses.asdict(cfg))
    tckpt.export_hf_vit(str(tmp_path / "own"), params_from_jax(jax.device_get(params),
                                                              device="cpu"), tcfg)
    assert filecmp.cmp(os.path.join(jdir, "model.safetensors"),
                       str(tmp_path / "own" / "model.safetensors"), shallow=False)
    assert_same_logits(jp, jc, tp, tc)
    if not pruned:
        tparams, tcfg2 = tcommon.resolve_model(jdir, device="cpu")
        assert_same_leaves(jp, tparams)


def test_export_refusals_leave_no_directory(tmp_path):
    params, cfg = jax_model()
    from ssp_x_vit_tpu_torch.models.checkpoints import params_from_jax

    tp = params_from_jax(jax.device_get(params), device="cpu")
    tc = tvit.ViTConfig(**dataclasses.asdict(cfg))
    for i, (c, match) in enumerate(((dataclasses.replace(tc, head_type="adapter",
                                                         adapter_bottleneck=16), "adapter"),
                                    (dataclasses.replace(tc, pruned_attention_blocks=(1,)),
                                     "attention removal"))):
        with pytest.raises(ValueError, match=match):
            tckpt.export_hf_vit(str(tmp_path / f"r{i}"), tp, c)
        assert not (tmp_path / f"r{i}").exists()
    with pytest.raises(FileNotFoundError, match="no weights"):
        (tmp_path / "noweights").mkdir()
        (tmp_path / "noweights" / "config.json").write_text("{}")
        tckpt.load_hf_vit(str(tmp_path / "noweights"), device="cpu")


def test_state_dict_files_load_as_jax(tmp_path, monkeypatch):
    """A torch ``.bin`` of an HF ViTModel (no ``vit.`` prefix, no classifier),
    plain and nested under ``state_dict``: a headless backbone with a zero head."""
    params, cfg = jax_model(seed=2)
    jdir = str(tmp_path / "jax")
    jckpt.export_hf_vit(jdir, params, cfg)
    sd = {k[len("vit."):]: v for k, v in tckpt._read_safetensors(
        os.path.join(jdir, "model.safetensors")).items() if k.startswith("vit.")}
    for name, obj in (("plain.bin", sd), ("nested.pt", {"state_dict": sd})):
        path = str(tmp_path / name)
        torch.save(obj, path)
        jp = jckpt.params_from_hf_state_dict(jckpt.load_state_dict_file(path), cfg)
        tp = tckpt.params_from_hf_state_dict(tckpt.load_state_dict_file(path),
                                             tvit.ViTConfig(**dataclasses.asdict(cfg)),
                                             device="cpu")
        assert_same_leaves(jp, tp)
        assert not tp["head"]["kernel"].any()
    from ssp_x_vit_tpu.cli import common as jcommon

    monkeypatch.setitem(jcommon.NAMED_CONFIGS, "tiny3", ARCH)
    monkeypatch.setitem(tcommon.NAMED_CONFIGS, "tiny3", ARCH)
    path = str(tmp_path / "plain.bin")
    assert_same_leaves(jcommon.resolve_model("tiny3", checkpoint=path)[0],
                       tcommon.resolve_model("tiny3", checkpoint=path, device="cpu")[0])


def augreg_npz(path, d=64, L=3, heads=4, f=128, P=8, C=10, seed=0):
    """An AugReg-layout npz, as tests/test_srp.py synthesizes one (tiny widths)."""
    rng = np.random.default_rng(seed)
    n = lambda *s: (0.02 * rng.normal(size=s)).astype(np.float32)
    npz = {"embedding/kernel": n(P, P, 3, d), "embedding/bias": n(d), "cls": n(1, 1, d),
           "Transformer/posembed_input/pos_embedding": n(1, (32 // P) ** 2 + 1, d),
           "Transformer/encoder_norm/scale": 1 + n(d), "Transformer/encoder_norm/bias": n(d),
           "head/kernel": n(d, C), "head/bias": n(C)}
    hd = d // heads
    for i in range(L):
        pre = f"Transformer/encoderblock_{i}"
        att = f"{pre}/MultiHeadDotProductAttention_1"
        for nm in ("query", "key", "value"):
            npz[f"{att}/{nm}/kernel"] = n(d, heads, hd)
            npz[f"{att}/{nm}/bias"] = n(heads, hd)
        npz[f"{att}/out/kernel"] = n(heads, hd, d)
        npz[f"{att}/out/bias"] = n(d)
        for ln in ("LayerNorm_0", "LayerNorm_2"):
            npz[f"{pre}/{ln}/scale"] = 1 + n(d)
            npz[f"{pre}/{ln}/bias"] = n(d)
        npz[f"{pre}/MlpBlock_3/Dense_0/kernel"] = n(d, f)
        npz[f"{pre}/MlpBlock_3/Dense_0/bias"] = n(f)
        npz[f"{pre}/MlpBlock_3/Dense_1/kernel"] = n(f, d)
        npz[f"{pre}/MlpBlock_3/Dense_1/bias"] = n(d)
    np.savez(path, **npz)


def test_augreg_npz_loads_as_jax(tmp_path):
    path = str(tmp_path / "augreg.npz")
    augreg_npz(path)
    cfg = jvit.ViTConfig(**TINY)
    tc = tvit.ViTConfig(**TINY)
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        assert_same_leaves(jckpt.load_augreg_npz(path, cfg, dtype=jdt),
                           tckpt.load_augreg_npz(path, tc, device="cpu", dtype=tdt))
    jp = jckpt.load_augreg_npz(path, cfg)
    tp = tckpt.load_augreg_npz(path, tc, device="cpu")
    assert_same_logits(jp, cfg, tp, tc)


def test_cli_checkpoint_resolution(tmp_path, monkeypatch):
    """``--checkpoint`` with an AugReg npz loads it as AugReg, and a framework npz
    as the framework tree. Accepted difference: the JAX CLI tries the framework
    reader first and, as it raises on no npz, hands an AugReg file back as its
    raw key tree; the port tells the two apart by the framework's ``blocks/``
    keys, as the JAX package's AugReg branch intends."""
    from ssp_x_vit_tpu.cli import common as jcommon
    from ssp_x_vit_tpu_torch.models.checkpoints import save_params_npz

    monkeypatch.setitem(jcommon.NAMED_CONFIGS, "tiny3", ARCH)
    monkeypatch.setitem(tcommon.NAMED_CONFIGS, "tiny3", ARCH)
    path = str(tmp_path / "augreg.npz")
    augreg_npz(path)
    tp, tc = tcommon.resolve_model("tiny3", checkpoint=path, device="cpu")
    cfg = jvit.ViTConfig(**TINY)
    assert_same_leaves(jckpt.load_augreg_npz(path, cfg), tp)
    jraw, _ = jcommon.resolve_model("tiny3", checkpoint=path)
    assert "blocks" not in jraw and "Transformer" in jraw
    framework = str(tmp_path / "framework.npz")
    save_params_npz(framework, tp)
    again, _ = tcommon.resolve_model("tiny3", checkpoint=framework, device="cpu")
    assert_same_leaves(jcommon.resolve_model("tiny3", checkpoint=framework)[0], again)


def test_auto_2ssp_save_format_hf(tmp_path, capsys):
    """Stage 1 alone exports HF at the padded width (the JAX loader reads it
    back to the pruned tree's values, and its logits); with attention removed
    the CLI saves the native format with the JAX CLI's notice."""
    from ssp_x_vit_tpu_torch.cli import auto_2ssp

    base = ["--backend", "cpu", "--model", "tiny", "--dataset", "synthetic", "--eval-batches", "1",
            "--min-remaining", "32", "--save-pruned-model", "--save-format", "hf"]
    report = auto_2ssp.run(auto_2ssp.build_argparser().parse_args(
        base + ["--stage", "s1", "--s1-sparsity", "0.25", "--out-root", str(tmp_path / "s1")]))
    saved = report["artifacts"]["pruned_model_dir"]
    assert os.path.exists(os.path.join(saved, "model.safetensors"))
    with open(os.path.join(saved, "config.json")) as f:
        assert json.load(f)["model_type"] == "vit"
    tp, tc = report["model"]
    jp, jc = jckpt.load_hf_vit(saved)
    hp, hc = tckpt.load_hf_vit(saved, device="cpu")
    assert_same_leaves(jp, hp)
    px = torch.from_numpy(np.random.default_rng(2).normal(size=(2, 32, 32, 3)).astype(np.float32))
    with torch.inference_mode():
        a = tvit.vit_forward_materialized(tp, px, tc)
        b = tvit.vit_forward_materialized(hp, px, hc)
    torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-5)
    capsys.readouterr()
    report = auto_2ssp.run(auto_2ssp.build_argparser().parse_args(
        base + ["--stage", "both", "--target", "0.25", "--out-root", str(tmp_path / "both")]))
    assert report["artifacts"]["pruned_block_indices"]
    assert "[INFO] hf export skipped (stage-2 attention removal" in capsys.readouterr().out
    assert os.path.exists(os.path.join(report["artifacts"]["pruned_model_dir"], "model.npz"))
