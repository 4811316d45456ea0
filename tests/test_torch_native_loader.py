"""The port's native batch assembly (``ssp_x_vit_tpu_torch/data/
native_loader.py`` over ``native/dataloader.cc``, built with g++ into
``build/native/<hash>/``) against the JAX package's ``gather_batch`` and
against the port's numpy version, on uint8 images of odd sizes;
``DataPipeline`` assembles its batches through it."""

import numpy as np
import pytest
import torch

from ssp_x_vit_tpu.data import native_loader as jnl
from ssp_x_vit_tpu_torch.data import native_loader as tnl
from ssp_x_vit_tpu_torch.data import pipeline as tpipe


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    return rng.integers(0, 256, (50, 17, 13, 3), dtype=np.uint8)


@pytest.mark.parametrize("shape", [(50, 17, 13, 3), (7, 1, 5, 1), (9, 31, 2, 4)])
@pytest.mark.parametrize("flip", [False, True])
def test_gather_matches_jax_and_numpy(shape, flip):
    rng = np.random.default_rng(sum(shape) + flip)
    images = rng.integers(0, 256, shape, dtype=np.uint8)
    idx = rng.integers(0, shape[0], 19)
    flips = (rng.random(19) < 0.5).astype(np.uint8) if flip else None
    got = tnl.gather_batch(images, idx, flips, num_threads=3)
    assert got.dtype == np.uint8 and got.flags.c_contiguous and got.shape == (19,) + shape[1:]
    np.testing.assert_array_equal(got, tnl.gather_batch_plain(images, idx, flips))
    np.testing.assert_array_equal(got, jnl.gather_batch(images, idx, flips))
    np.testing.assert_array_equal(tnl.gather_batch(images, idx, flips, num_threads=1), got)


def test_bad_operands_and_a_failed_build_raise(images, tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="uint8"):
        tnl.gather_batch(images.astype(np.int16), [0])
    with pytest.raises(IndexError):
        tnl.gather_batch(images, [50])
    with pytest.raises(ValueError, match="flips"):
        tnl.gather_batch(images, [0, 1], [1])
    assert tnl.gather_batch(images, []).shape == (0, 17, 13, 3)
    # a compiler that fails: the build raises instead of falling back to numpy
    monkeypatch.setattr(tnl, "_lib", None)
    monkeypatch.setattr(tnl, "BUILD_ROOT", tmp_path / "native")
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="build failed"):
        tnl.gather_batch(images, [0])


def test_pipeline_assembles_batches_through_the_gather(images, monkeypatch):
    """Every batch goes through ``gather_batch`` with the pipeline's flips,
    and the pixels are those of the numpy version on the same indices."""
    calls = []
    real = tnl.gather_batch

    def spy(imgs, idx, flips=None):
        calls.append((np.asarray(idx).copy(), None if flips is None else flips.copy()))
        return real(imgs, idx, flips)

    monkeypatch.setattr(tpipe, "gather_batch", spy)
    labels = np.arange(50, dtype=np.int32) % 10
    pipe = tpipe.DataPipeline(images, labels, img_size=13 + 4, batch_size=16, shuffle=True,
                              flip=True, seed=3, device="cpu")
    batches = pipe.batches()
    assert len(calls) == len(batches) == 4
    for (idx, flips), b in zip(calls, batches):
        want = tpipe.preprocess_batch(
            torch.from_numpy(tnl.gather_batch_plain(images, idx, flips)), 17)
        assert torch.equal(b["pixel_values"], want)
        assert flips is not None and flips.dtype == np.uint8
