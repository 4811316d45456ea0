"""The port's ``apply_mask_prune`` against the JAX CLI's ``run`` on the tiny
config (CPU, fp32), and one summation grid combination through the port's own
subprocesses with its resume check.

Both CLIs load the same weights (a framework ``.npz`` written from the JAX
tiny model) and see the same images: the JAX package's ``synthetic_dataset``
is monkeypatched to the port's generator for the test (nothing in the JAX
package changes), since the two agree only within one uint8 step. Parameter
counts, prune counts, keep indices and the ``[WARN]`` lines must be equal, and
top-1 equal: the fp32 forwards agree within 1e-4 (``tests/test_torch_vit.py``),
far inside the top-2 margins of these 64 images.
"""

import csv
import json

import jax
import numpy as np
import pytest

from ssp_x_vit_tpu.cli import apply_mask_prune as japply
from ssp_x_vit_tpu.data import pipeline as jpipe
from ssp_x_vit_tpu.pruning import select_keep_indices as jselect
from ssp_x_vit_tpu_torch.cli import apply_mask_prune as tapply
from ssp_x_vit_tpu_torch.cli.grid import load_completed_ok, run_grid
from ssp_x_vit_tpu_torch.data import pipeline as tpipe
from ssp_x_vit_tpu_torch.models.checkpoints import params_from_jax, save_params_npz
from ssp_x_vit_tpu_torch.pruning import select_keep_indices as tselect


@pytest.fixture(scope="module")
def tiny_npz(tmp_path_factory, tiny_params):
    path = tmp_path_factory.mktemp("ckpt") / "tiny.npz"
    save_params_npz(str(path), params_from_jax(jax.device_get(tiny_params), device="cpu"))
    return str(path)


@pytest.fixture(scope="module")
def mask_file(tmp_path_factory):
    """A summation-style mask over the tiny model's 4 x 128 neurons, nested
    as the grid writes it, with a key past the block's width."""
    rng = np.random.default_rng(21)
    leaf = {f"{i}:{j}": int(rng.random() < 0.2) for i in range(4) for j in range(128)}
    leaf["2:500"] = 1
    path = tmp_path_factory.mktemp("mask") / "mask.json"
    path.write_text(json.dumps({"ffn": leaf, "meta": {"note": "x"}}))
    return str(path)


@pytest.mark.parametrize("flags", [["--min-remaining", "110"], ["--dry-run"]])
def test_apply_mask_prune_matches_jax(tmp_path, monkeypatch, capsys, tiny_npz, mask_file, flags):
    monkeypatch.setattr(jpipe, "synthetic_dataset", tpipe.synthetic_dataset)
    reports, warns = {}, {}
    for tag, cli in (("j", japply), ("t", tapply)):
        argv = ["--mask", mask_file, "--model", "tiny", "--checkpoint", tiny_npz,
                "--dataset", "synthetic", "--eval-batches", "1", "--backend", "cpu",
                "--out-root", str(tmp_path / tag), *flags]
        reports[tag] = cli.run(cli.build_argparser().parse_args(argv))
        out = capsys.readouterr().out
        warns[tag] = [line for line in out.splitlines() if line.startswith("[WARN]")]
        summary = json.loads(out.split("[SUMMARY]\n", 1)[1].split("\n[INFO]")[0])
        assert summary == reports[tag]["metrics"]
    jr, tr = reports["j"], reports["t"]
    assert warns["t"] == warns["j"]
    assert len(warns["t"]) == (0 if "--dry-run" in flags else 4)   # 110 > 128 - ~26 pruned
    assert tr["config"] == jr["config"]
    assert tr.get("artifacts") == jr.get("artifacts")
    for key, value in jr["metrics"].items():
        if not key.startswith("latency"):
            assert tr["metrics"][key] == value, key
    if "--dry-run" in flags:
        assert "stage1" not in tr["kernel_launches"]
        return
    assert tr["metrics"]["stage1_reduction_percent"] > 0
    assert all(n == 0 for n in tr["kernel_launches"]["stage1"].values())   # CPU: plain path
    blocks = tapply.load_mask(mask_file)
    assert blocks == japply.load_mask(mask_file)
    inter = [128] * 4
    imp_t, n_t = tapply.build_importance_and_counts(blocks, inter)
    imp_j, n_j = japply.build_importance_and_counts(blocks, inter)
    np.testing.assert_array_equal(imp_t, imp_j)
    assert n_t == n_j
    n_t = tr["artifacts"]["n_to_prune_per_block"]
    for a, b in zip(tselect(imp_t, n_to_prune_per_block=n_t, min_remaining=110).keep_indices,
                    jselect(imp_j, n_to_prune_per_block=n_t, min_remaining=110).keep_indices):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_summation_grid_combo_through_the_port_and_resume(tmp_path, capsys):
    files = []
    for name, seed in (("a", 1), ("b", 2)):
        rng = np.random.default_rng(seed)
        p = tmp_path / f"{name}.json"
        p.write_text(json.dumps({"ffn": {f"{i}:{j}": float(rng.random())
                                         for i in range(4) for j in range(128)}}))
        files.append(p)
    apply = ["--model", "tiny", "--dataset", "synthetic", "--min-remaining", "32",
             "--eval-batches", "1", "--backend", "cpu"]
    out = tmp_path / "grid"
    csv_path = run_grid("summation", files, sizes={2}, prune_levels=[20], out_dir=out,
                        apply_args=apply)
    rows = list(csv.DictReader(csv_path.open()))
    assert len(rows) == 1 and rows[0]["status"] == "ok" and rows[0]["methods"] == "a+b"
    assert float(rows[0]["stage1_reduction_percent"]) > 0
    assert ("a+b", 20) in load_completed_ok(csv_path)
    assert (out / "mask.json").exists() and (out / "aggregated_sums.json").exists()
    assert "[SUMMARY]" in (out / "logs" / "a+b_p20.stdout.txt").read_text()
    printed = capsys.readouterr().out
    for module in ("aggregate_and_mask_summation", "apply_mask_prune"):
        assert f" -m ssp_x_vit_tpu_torch.cli.{module} " in printed
    run_grid("summation", files, sizes={2}, prune_levels=[20], out_dir=out, apply_args=apply)
    assert len(list(csv.DictReader(csv_path.open()))) == 1
