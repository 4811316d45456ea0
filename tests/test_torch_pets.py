"""Oxford-IIIT-Pet on disk and the last utils modules, on the port against
the JAX package (CPU).

The JAX package reads Pets through ``torchvision.datasets.OxfordIIITPet``,
which is not installed here: the tests put a stand-in into ``sys.modules``,
written to torchvision's contract over PIL (the directory check, the split
file, ``int(class_id) - 1``, ``Image.open(p).convert("RGB")``). Both packages'
``load_srp_dataset`` then read the committed fixtures
(``tests/fixtures/pets``: baseline, progressive, grey, CMYK, YCCK, Adobe RGB,
4:4:0 / 4:1:1 JPEGs and a PNG under a ``.jpg`` name). Tolerances: images and
labels exact; ``pixel_values`` 2e-7 (the port normalizes on the device as
``(x / 255 - 0.5) / 0.5`` in fp32, one ulp from JAX's order of operations at
most). Nothing in the JAX package changes.
"""

import contextlib
import json
import os
import shutil
import sys
import types

import numpy as np
import pytest
import torch
from PIL import Image

from ssp_x_vit_tpu.data import srp as jsrp
from ssp_x_vit_tpu.utils import logging as jlog
from ssp_x_vit_tpu.utils import profiling as jprof
from ssp_x_vit_tpu_torch.data import pets as tpets
from ssp_x_vit_tpu_torch.data import srp as tsrp
from ssp_x_vit_tpu_torch.utils import logging as tlog
from ssp_x_vit_tpu_torch.utils import profiling as tprof

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures", "pets")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's tiny tensors: the suite runs six
    workers on the host's cores, where a pool per worker only contends."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class StandInOxfordIIITPet:
    """``torchvision.datasets.OxfordIIITPet`` (target_types="category") as
    torchvision writes it, over PIL."""

    def __init__(self, root, split="trainval", download=False):
        assert split in ("trainval", "test") and not download
        base = os.path.join(root, "oxford-iiit-pet")
        images, anns = os.path.join(base, "images"), os.path.join(base, "annotations")
        if not (os.path.isdir(images) and os.path.isdir(anns)):
            raise RuntimeError("Dataset not found. You can use download=True to download it")
        self._images, self._labels = [], []
        with open(os.path.join(anns, f"{split}.txt")) as f:
            for line in f:
                image_id, label, _, _ = line.strip().split()
                self._images.append(os.path.join(images, f"{image_id}.jpg"))
                self._labels.append(int(label) - 1)

    def __len__(self):
        return len(self._images)

    def __getitem__(self, idx):
        return Image.open(self._images[idx]).convert("RGB"), self._labels[idx]


@pytest.fixture
def torchvision_stand_in(monkeypatch):
    tv = types.ModuleType("torchvision")
    datasets = types.ModuleType("torchvision.datasets")
    datasets.OxfordIIITPet = StandInOxfordIIITPet
    tv.datasets = datasets
    monkeypatch.setitem(sys.modules, "torchvision", tv)
    monkeypatch.setitem(sys.modules, "torchvision.datasets", datasets)


def _pipelines(out):
    return list(out) if isinstance(out, tuple) else [out]


def _assert_same_pipelines(t_out, j_out):
    t_pipes, j_pipes = _pipelines(t_out), _pipelines(j_out)
    assert len(t_pipes) == len(j_pipes)
    for tp, jp in zip(t_pipes, j_pipes):
        np.testing.assert_array_equal(tp.images, jp.images)
        np.testing.assert_array_equal(tp.labels, jp.labels)
        assert (tp.shuffle, tp.seed, tp.batch_size, len(tp)) == \
            (jp.shuffle, jp.seed, jp.batch_size, len(jp))
        for tb, jb in zip(tp, jp):
            np.testing.assert_array_equal(tb["labels"].numpy(), np.asarray(jb["labels"]))
            np.testing.assert_allclose(tb["pixel_values"].numpy(),
                                       np.asarray(jb["pixel_values"]), rtol=0, atol=2e-7)


@pytest.mark.parametrize("split", ["trainval", "test"])
@pytest.mark.parametrize("seed,subset_size,res", [(42, 1.0, 224), (42, 0.7, 32), (7, 0.5, 48)])
def test_pets_loader_matches_jax(torchvision_stand_in, split, seed, subset_size, res):
    kw = dict(split=split, res=res, batch_size=4, root=FIXTURES, seed=seed,
              subset_size=subset_size)
    t_out = tsrp.load_srp_dataset("oxford-iiit-pet", device="cpu", **kw)
    j_out = jsrp.load_srp_dataset("oxford-iiit-pet", **kw)
    _assert_same_pipelines(t_out, j_out)
    n = sum(len(p.images) for p in _pipelines(t_out))
    assert n == int(10 * subset_size)    # 10 fixtures per split, not the synthetic stand-in


def test_pets_split_reads_torchvisions_layout(tmp_path):
    paths, labels = tpets.pets_split(FIXTURES, "test")
    ds = StandInOxfordIIITPet(FIXTURES, "test")
    assert paths == ds._images and labels == ds._labels
    assert tpets.pets_split(str(tmp_path), "test") is None
    with pytest.raises(ValueError, match="split must be"):
        tpets.pets_split(FIXTURES, "train")
    base = tmp_path / "oxford-iiit-pet"
    (base / "images").mkdir(parents=True)
    (base / "annotations").mkdir()
    with pytest.raises(OSError, match=r"trainval\.txt"):
        tpets.pets_split(str(tmp_path), "trainval")
    (base / "annotations" / "trainval.txt").write_text("")
    with pytest.raises(ValueError, match=r"trainval\.txt: no images listed"):
        tpets.pets_split(str(tmp_path), "trainval")
    (base / "annotations" / "trainval.txt").write_text("Abyssinian_1 1 1 1\nbad line\n")
    with pytest.raises(ValueError, match=r"trainval\.txt:2: expected"):
        tpets.pets_split(str(tmp_path), "trainval")


@pytest.mark.parametrize("missing", ["annotations", "images"])
def test_half_a_pets_directory_is_the_synthetic_stand_in_in_both(
        torchvision_stand_in, tmp_path, capsys, missing):
    """torchvision's _check_exists needs both directories: with one, both
    packages print the notice and use the same synthetic stand-in (labels
    equal, pixels within 1 LSB as ``test_torch_data.py`` holds them)."""
    keep = "images" if missing == "annotations" else "annotations"
    (tmp_path / "oxford-iiit-pet" / keep).mkdir(parents=True)
    kw = dict(split="trainval", res=32, batch_size=16, root=str(tmp_path))
    t_out = tsrp.load_srp_dataset("oxford-iiit-pet", device="cpu", **kw)
    j_out = jsrp.load_srp_dataset("oxford-iiit-pet", **kw)
    out = capsys.readouterr().out
    assert out.count("[INFO] oxford-iiit-pet not on disk; using deterministic synthetic "
                     "stand-in") == 2
    assert sum(len(p.images) for p in t_out) == 1024
    for tp, jp in zip(t_out, j_out):
        np.testing.assert_array_equal(tp.labels, jp.labels)
        diff = np.abs(tp.images.astype(np.int16) - jp.images.astype(np.int16))
        assert diff.max() <= 1, diff.max()


@pytest.mark.parametrize("fault", ["truncated", "gif", "missing"])
def test_an_unreadable_pets_file_raises_naming_it(torchvision_stand_in, tmp_path, capsys, fault):
    """The accepted differences: where the JAX package's ``except Exception``
    swaps the whole split for the synthetic stand-in (a truncated or missing
    file), the port raises naming the file, so a reader fault can never pass
    as data; a format other than JPEG and PNG (here GIF), which Pillow reads,
    the port refuses naming the file."""
    shutil.copytree(os.path.join(FIXTURES, "oxford-iiit-pet"), tmp_path / "oxford-iiit-pet")
    bad = tmp_path / "oxford-iiit-pet" / "images" / "pug_16.jpg"
    if fault == "truncated":
        bad.write_bytes(bad.read_bytes()[:5000])
    elif fault == "gif":
        Image.new("RGB", (8, 8)).save(bad, "GIF")
    else:
        bad.unlink()
    with pytest.raises((ValueError, OSError), match=r"pug_16\.jpg"):
        tsrp.load_srp_dataset("oxford-iiit-pet", split="test", res=32, root=str(tmp_path),
                              device="cpu")
    test = jsrp.load_srp_dataset("oxford-iiit-pet", split="test", res=32, root=str(tmp_path))
    if fault == "gif":
        assert len(test.images) == 10 and "not on disk" not in capsys.readouterr().out
    else:
        assert len(test.images) == 512 and "not on disk" in capsys.readouterr().out


def test_log_lines_match_jax(capsys):
    payload = {"sparsity": 0.25, "acc": [0.5, 0.75], "model": "B/16"}
    for mod in (jlog, tlog):
        mod.step_log("pruning 3 blocks")
        mod.stage_log("s1", "importance done")
        mod.summary_log(payload)
    lines = capsys.readouterr().out.splitlines()
    assert lines[:3] == lines[3:] == [
        "[STEP] pruning 3 blocks", "[stage:s1] importance done",
        f"[SUMMARY] {json.dumps(payload)}"]


def test_section_timer_and_trace(tmp_path, monkeypatch, capsys):
    """SectionTimer sums sections as JAX's does and gives the same summary;
    trace writes a Chrome trace of the block to the directory it is given or
    to SSP_X_VIT_TRACE_DIR, prints JAX's [TRACE] line, and does nothing
    without either."""
    timers = (jprof.SectionTimer(), tprof.SectionTimer())
    for timer in timers:
        with timer.section("stage1"):
            pass
        with timer.section("eval"):
            pass
        with timer.section("stage1"):
            pass
        timer.sections = {k: round(v, 9) + (3.14159 if k == "stage1" else 0.5)
                          for k, v in timer.sections.items()}
    assert list(timers[0].sections) == list(timers[1].sections) == ["stage1", "eval"]
    assert timers[0].summary() == timers[1].summary() == "stage1=3.14s | eval=0.50s"

    monkeypatch.delenv("SSP_X_VIT_TRACE_DIR", raising=False)
    with tprof.trace():
        pass
    assert capsys.readouterr().out == ""
    for where in ("argument", "environment"):
        d = tmp_path / where
        ctx = tprof.trace(str(d)) if where == "argument" else contextlib.nullcontext()
        if where == "environment":
            monkeypatch.setenv("SSP_X_VIT_TRACE_DIR", str(d))
            ctx = tprof.trace()
        with ctx:
            torch.ones(64, 64) @ torch.ones(64, 64)
        assert f"[TRACE] profiler trace written to {d}" in capsys.readouterr().out
        (trace_file,) = d.iterdir()
        events = json.loads(trace_file.read_text())["traceEvents"]
        assert any("mm" in e.get("name", "") for e in events)


def test_trace_counts_launches_without_their_kernel(tmp_path):
    """A launch (runtime or driver) is matched to its kernel by correlation
    id; the ones left over are counted, other events are not, and the first
    ``skip`` launches in time are not."""
    def event(cat, name, corr):
        return {"ph": "X", "cat": cat, "name": name, "ts": corr, "dur": 1,
                "args": {"correlation": corr}}

    events = [event("cuda_runtime", "cudaLaunchKernel", 1), event("kernel", "ssp::a", 1),
              event("cuda_runtime", "cudaLaunchKernelExC", 2),
              event("cuda_driver", "cuLaunchKernelEx", 3), event("kernel", "ssp::b", 3),
              event("cuda_runtime", "cudaLaunchKernel", 4),
              event("cuda_runtime", "cudaMemcpyAsync", 5), event("cpu_op", "aten::mm", 6)]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    assert tprof.launches_without_kernel(str(path)) == 2
    # the first launches (by time) are left out: trace's own warm-up kernels
    assert tprof.launches_without_kernel(str(path), skip=2) == 1
    assert tprof.launches_without_kernel(str(path), skip=4) == 0
    path.write_text(json.dumps({"traceEvents": events[:2] + events[3:5]}))
    assert tprof.launches_without_kernel(str(path)) == 0
