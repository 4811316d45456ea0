"""CIFAR on disk, the cubic resize, SRP checkpoints and the four ``auto_2ssp``
flags of the slice, on the port against the JAX package (CPU).

CIFAR directories are synthesized in torchvision's on-disk format (pickled
batch dicts, ``data`` [N, 3072] uint8 in CHW order). The JAX package reads
CIFAR through torchvision, which is not installed, so where both packages must
see the same arrays the test monkeypatches the JAX package's
``_load_cifar_arrays`` to return the port reader's arrays (nothing in the JAX
package changes). AugReg ``.npz`` files are synthesized from a numpy seed.

Tolerances: resized pixels 1e-5 (the same float32 weights, other summation
orders); fp32 logits 1e-4; importances and exported scores rtol 1e-4, 1e-6
absolute.
"""

import dataclasses
import json
import os
import pickle
import shutil
import socket
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssp_x_vit_tpu.data import pipeline as jpipe
from ssp_x_vit_tpu.data import srp as jsrp
from ssp_x_vit_tpu_torch.data import pipeline as tpipe
from ssp_x_vit_tpu_torch.data import srp as tsrp

INDEX_ROWS = [
    "name,ds,filename,final_val,adapt_ds,adapt_filename,adapt_final_val",
    "B/16,i21k,p1,0.80,,,",
    "B/16,i21k,p2,0.85,,,",
    "S/16,i21k,p3,0.70,,,",
    "Ti/16,i21k,p4,0.60,,,",
    "B/16,cifar100,p2,0,cifar100,ckpt_c1_224,0.90",
    "B/16,cifar100,p2,0,cifar100,ckpt_c2_224,0.92",
    "B/16,cifar100,p2,0,cifar100,ckpt_c3_224,0.95",
    "B/16,cifar100,p1,0,cifar100,ckpt_bad_224,0.99",
    "B/16,oxford-iiit-pet,p2,0,oxford-iiit-pet,ckpt_pet_224,0.88",
    "S/16,cifar100,p3,0,cifar100,ckpt_s_224,0.91",
    "Ti/16,cifar100,p4,0,cifar100,ti_c100_32,0.70",
]


def write_cifar(root, name, n_train_file, n_test, seed=0):
    """A CIFAR directory in torchvision's layout under ``root``; returns the
    (train, test) images and labels as the files hold them."""
    sub, train_files, test_files, key = tpipe.CIFAR_FILES[name]
    classes = 10 if name == "cifar10" else 100
    d = os.path.join(root, sub)
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    out = []
    for files, n in ((train_files, n_train_file), (test_files, n_test)):
        data, labels = [], []
        for f in files:
            x = rng.integers(0, 256, (n, 3072), dtype=np.uint8)
            y = rng.integers(0, classes, n).tolist()
            entry = {"data": x, key: y, "batch_label": f}
            if name == "cifar100":
                entry["coarse_labels"] = [v // 5 for v in y]
            with open(os.path.join(d, f), "wb") as fh:
                pickle.dump(entry, fh)
            data.append(x)
            labels += y
        out.append((np.concatenate(data), np.asarray(labels)))
    return out


def write_augreg(path, d, layers, heads, f, classes, res, seed=0):
    """An AugReg (big_vision) ``.npz`` with random weights."""
    rng = np.random.default_rng(seed)
    hd, P = d // heads, 16

    def w(*shape):
        return (rng.normal(size=shape) * 0.05).astype(np.float32)

    npz = {"embedding/kernel": w(P, P, 3, d), "embedding/bias": w(d), "cls": w(1, 1, d),
           "Transformer/posembed_input/pos_embedding": w(1, (res // P) ** 2 + 1, d),
           "Transformer/encoder_norm/scale": 1 + w(d), "Transformer/encoder_norm/bias": w(d),
           "head/kernel": w(d, classes), "head/bias": w(classes)}
    for i in range(layers):
        pre = f"Transformer/encoderblock_{i}"
        att = f"{pre}/MultiHeadDotProductAttention_1"
        for nm in ("query", "key", "value"):
            npz[f"{att}/{nm}/kernel"], npz[f"{att}/{nm}/bias"] = w(d, heads, hd), w(heads, hd)
        npz[f"{att}/out/kernel"], npz[f"{att}/out/bias"] = w(heads, hd, d), w(d)
        for ln in ("LayerNorm_0", "LayerNorm_2"):
            npz[f"{pre}/{ln}/scale"], npz[f"{pre}/{ln}/bias"] = 1 + w(d), w(d)
        npz[f"{pre}/MlpBlock_3/Dense_0/kernel"], npz[f"{pre}/MlpBlock_3/Dense_0/bias"] = w(d, f), w(f)
        npz[f"{pre}/MlpBlock_3/Dense_1/kernel"], npz[f"{pre}/MlpBlock_3/Dense_1/bias"] = w(f, d), w(d)
    np.savez(path, **npz)


@pytest.fixture
def index_csv(tmp_path):
    p = tmp_path / "index.csv"
    p.write_text("\n".join(INDEX_ROWS) + "\n")
    return str(p)


@pytest.mark.parametrize("name", ["cifar10", "cifar100"])
def test_pickle_reader_on_synthesized_cifar(tmp_path, monkeypatch, name):
    (tr_x, tr_y), (te_x, te_y) = write_cifar(str(tmp_path), name, 6, 5, seed=3)
    got = tpipe._load_cifar_arrays(name, str(tmp_path))
    assert got[0].shape == (len(tr_y), 32, 32, 3) and got[0].dtype == np.uint8
    np.testing.assert_array_equal(got[0], tr_x.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
    np.testing.assert_array_equal(got[1], tr_y)
    np.testing.assert_array_equal(got[2], te_x.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
    np.testing.assert_array_equal(got[3], te_y)
    assert got[1].dtype == got[3].dtype == np.int32
    monkeypatch.setattr(tpipe, "CIFAR_ROOTS", ())
    assert tpipe._load_cifar_arrays(name, str(tmp_path / "nothing")) is None


@pytest.mark.parametrize("name,train_pct,test_pct,calib", [
    ("cifar10", 0.25, 0.5, 2), ("cifar100", 0.5, 0.25, 1), ("cifar100", None, None, 3)])
def test_load_cifar_splits_and_calibration_match_jax(tmp_path, monkeypatch, name, train_pct,
                                                     test_pct, calib):
    write_cifar(str(tmp_path), name, 80 if name == "cifar10" else 400, 64, seed=4)
    arrays = tpipe._load_cifar_arrays(name, str(tmp_path))
    monkeypatch.setattr(jpipe, "_load_cifar_arrays", lambda n, r: arrays)
    kw = dict(train_pct=train_pct, test_pct=test_pct, calib_per_class=calib, img_size=40, seed=5)
    tparts = tpipe.load_cifar(name, root=str(tmp_path), device="cpu", **kw)
    jparts = jpipe.load_cifar(name, root=str(tmp_path), **kw)
    for t, j in zip(tparts, jparts):
        np.testing.assert_array_equal(t.images, j.images)
        np.testing.assert_array_equal(t.labels, j.labels)
        assert (t.batch_size, t.shuffle, t.flip, t.img_size) == \
            (j.batch_size, j.shuffle, j.flip, j.img_size)
        tb, jb = next(iter(t)), next(iter(j))
        np.testing.assert_allclose(tb["pixel_values"].numpy(), np.asarray(jb["pixel_values"]),
                                   rtol=0, atol=1e-5)
        np.testing.assert_array_equal(tb["labels"].numpy(), np.asarray(jb["labels"]))


def test_load_cifar_without_files_prints_the_notice(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tpipe, "CIFAR_ROOTS", ())
    monkeypatch.setattr(jpipe, "_load_cifar_arrays", lambda n, r: None)
    t = tpipe.load_cifar("cifar100", img_size=32, device="cpu")
    out_t = capsys.readouterr().out
    j = jpipe.load_cifar("cifar100", img_size=32)
    assert out_t == capsys.readouterr().out == \
        "[INFO] cifar100 not found on disk; using deterministic synthetic stand-in\n"
    assert len(t[0].images) == len(j[0].images) == 512
    assert np.abs(t[1].images.astype(int) - j[1].images.astype(int)).max() <= 1
    with pytest.raises(FileNotFoundError, match="downloads are disabled"):
        tpipe.load_cifar("cifar10", allow_synthetic=False, device="cpu")


@pytest.mark.parametrize("size,out", [(32, 224), (64, 24), (224, 32)])
def test_resize_matches_jax_image_resize(size, out):
    x = np.random.default_rng(size).random((2, size, size, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, out, out, 3), "cubic"))
    got = tpipe.resize_cubic(torch.from_numpy(x), out, out).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    u8 = (x * 255).astype(np.uint8)
    np.testing.assert_allclose(tpipe.preprocess_batch(torch.from_numpy(u8), out).numpy(),
                               np.asarray(jpipe.preprocess_batch(jnp.asarray(u8), out)),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("model_type,dataset,idx", [
    ("B/16", "cifar100", 1), ("B/16", "cifar100", 2), ("B/16", "cifar100", 3),
    ("B/16", "oxford-iiit-pet", 1), ("S/16", "cifar100", 1), ("Ti/16", "cifar100", 1),
    ("B/16", "cifar100", 4), ("B/16", "cifar10", 1)])
def test_select_srp_checkpoint_matches_jax(index_csv, model_type, dataset, idx):
    try:
        want = jsrp.select_srp_checkpoint(index_csv, model_type, dataset, idx)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(" (")[0].split(" in ")[0]):
            tsrp.select_srp_checkpoint(index_csv, model_type, dataset, idx)
        return
    assert tsrp.select_srp_checkpoint(index_csv, model_type, dataset, idx) == want
    assert want != "ckpt_bad_224"


def test_load_srp_model_ti16_matches_jax(tmp_path, index_csv):
    """A Ti/16 AugReg file at its published widths (random weights): the
    port's tree gives JAX's fp32 logits; then the same file by index.csv."""
    path = tmp_path / "augreg.npz"
    write_augreg(path, 192, 12, 3, 768, 37, 224)
    tparams, tcfg = tsrp.load_srp_model("Ti/16", "oxford-iiit-pet", checkpoint_npz=str(path),
                                        device="cpu")
    jparams, jcfg = jsrp.load_srp_model("Ti/16", "oxford-iiit-pet", checkpoint_npz=str(path))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert (tcfg.hidden_size, tcfg.num_heads, tcfg.num_classes) == (192, 3, 37)
    from ssp_x_vit_tpu.models.vit import vit_forward as jforward
    from ssp_x_vit_tpu_torch.models.vit import vit_forward as tforward

    px = np.random.default_rng(1).normal(size=(2, 224, 224, 3)).astype(np.float32)
    want, _ = jax.jit(jforward, static_argnums=2)(jparams, jnp.asarray(px), jcfg)
    got, _ = tforward(tparams, torch.from_numpy(px), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_srp_never_downloads(tmp_path, index_csv, monkeypatch):
    """A checkpoint missing from models_dir raises FileNotFoundError naming the
    AugReg URL, with no network attempt (the JAX package tries urllib, curl and
    unverified SSL)."""
    def no_network(*a, **k):
        raise AssertionError("network attempt")

    monkeypatch.setattr(socket.socket, "connect", no_network)
    monkeypatch.setattr(urllib.request, "urlopen", no_network)
    monkeypatch.setattr(urllib.request, "urlretrieve", no_network)
    with pytest.raises(FileNotFoundError,
                       match=r"storage\.googleapis\.com/vit_models/augreg/ckpt_c2_224\.npz"):
        tsrp.load_srp_model("B/16", "cifar100", top10_idx=2, index_csv=index_csv,
                            models_dir=str(tmp_path / "models"), device="cpu")


def test_srp_datasets_pets_fallback_and_refusal(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tpipe, "CIFAR_ROOTS", ())
    train, val = tsrp.load_srp_dataset("cifar100", split="trainval", res=32, batch_size=16,
                                       device="cpu")
    assert next(iter(train))["pixel_values"].shape == (16, 32, 32, 3)
    assert len(train.images) + len(val.images) == 1024
    test = tsrp.load_srp_dataset("oxford-iiit-pet", split="test", res=32, batch_size=8,
                                 device="cpu")
    b = next(iter(test))
    assert b["pixel_values"].shape == (8, 32, 32, 3) and int(b["labels"].max()) < 37
    assert "oxford-iiit-pet not on disk" in capsys.readouterr().out
    # images/ without annotations/ is no dataset (torchvision's check): the stand-in
    (tmp_path / "data" / "oxford-iiit-pet" / "images").mkdir(parents=True)
    tsrp.load_srp_dataset("oxford-iiit-pet", split="test", res=32, device="cpu")
    assert "oxford-iiit-pet not on disk" in capsys.readouterr().out
    # the committed fixtures in the dataset's layout load (once refused naming A.7d):
    # the split's labels in the seeded order, images at the asked size
    fixtures = os.path.join(os.path.dirname(__file__), "fixtures", "pets", "oxford-iiit-pet")
    shutil.copytree(os.path.join(fixtures, "annotations"),
                    tmp_path / "data" / "oxford-iiit-pet" / "annotations")
    for name in os.listdir(os.path.join(fixtures, "images")):
        shutil.copy(os.path.join(fixtures, "images", name),
                    tmp_path / "data" / "oxford-iiit-pet" / "images")
    with open(os.path.join(fixtures, "annotations", "test.txt")) as f:
        want = np.asarray([int(line.split()[1]) - 1 for line in f], np.int32)
    pets = tsrp.load_srp_dataset("oxford-iiit-pet", split="test", res=40, batch_size=8,
                                 device="cpu")
    assert pets.images.shape == (10, 40, 40, 3) and pets.images.dtype == np.uint8
    np.testing.assert_array_equal(pets.labels, want[np.random.default_rng(42).permutation(10)])
    assert "not on disk" not in capsys.readouterr().out
    write_cifar(str(tmp_path / "data"), "cifar100", 120, 40, seed=6)
    test = tsrp.load_srp_dataset("cifar100", split="test", res=32, batch_size=8,
                                 root=str(tmp_path / "data"), device="cpu")
    assert len(test.images) == 40


def test_auto_2ssp_srp_cifar_export_data_parallel_match_jax(tmp_path, monkeypatch, capsys):
    """The JAX and port CLIs on a tiny SRP checkpoint (``ARCH`` shrunk in both
    packages for the test, chosen through index.csv at res 32) and a
    synthesized CIFAR-100 directory, with --export-framework-prefix and
    --data-parallel: the same plan, parameter counts, pruned blocks, masks and
    top-1; importances and exported scores within rtol 1e-4."""
    from ssp_x_vit_tpu.cli import auto_2ssp as jcli
    from ssp_x_vit_tpu_torch.cli import auto_2ssp as tcli

    tiny = dict(hidden_size=32, num_layers=4, num_heads=2, intermediate_size=64)
    monkeypatch.setitem(jsrp.ARCH, "Ti/16", tiny)
    monkeypatch.setitem(tsrp.ARCH, "Ti/16", tiny)
    monkeypatch.chdir(tmp_path)
    write_cifar("data", "cifar100", 300, 128, seed=7)
    arrays = tpipe._load_cifar_arrays("cifar100", None)
    monkeypatch.setattr(jpipe, "_load_cifar_arrays", lambda n, r: arrays)
    os.makedirs("models")
    with open("models/index.csv", "w") as f:
        f.write("\n".join(INDEX_ROWS) + "\n")
    write_augreg("models/ti_c100_32.npz", 32, 4, 2, 64, 100, 32, seed=8)

    reports = {}
    for tag, cli, backend in (("j", jcli, "cpu"), ("t", tcli, "cpu")):
        argv = ["--use-srp-checkpoint", "--srp-model-type", "Ti/16", "--srp-top10-idx", "1",
                "--dataset", "cifar100", "--target", "0.25", "--min-remaining", "16",
                "--eval-batches", "1", "--calib-per-class", "1", "--data-parallel",
                "--export-framework-prefix", f"{tag}/fw", "--out-root", f"{tag}/runs",
                "--backend", backend]
        reports[tag] = cli.run(cli.build_argparser().parse_args(argv))
        assert "[INFO] Using SRP checkpoint; skipping head/adapter changes." in \
            capsys.readouterr().out
    jr, tr = reports["j"], reports["t"]
    assert tr["plan"] == jr["plan"]
    for key in ("params_before_stage1", "params_after_stage1", "params_after_stage2",
                "total_reduction_percent", "acc_baseline", "acc_stage1", "acc_stage2"):
        assert tr["metrics"][key] == jr["metrics"][key], key
    assert tr["config"]["dataset"] == jr["config"]["dataset"] == "cifar100"
    assert tr["artifacts"]["pruned_block_indices"] == jr["artifacts"]["pruned_block_indices"]
    with open("t/fw_masks.json") as f, open("j/fw_masks.json") as g:
        assert json.load(f) == json.load(g)
    with open("t/fw_scores.json") as f, open("j/fw_scores.json") as g:
        ts, js = json.load(f), json.load(g)
    for part in ("ffn", "heads", "qkv_dim"):
        assert list(ts[part]) == list(js[part])
        np.testing.assert_allclose(list(ts[part].values()), list(js[part].values()),
                                   rtol=1e-4, atol=1e-6, err_msg=part)
