"""The port's image reader (``ssp_x_vit_tpu_torch/data/image_decode.py`` over
``native/image_decode.cc``, and ``data/png.py``) against Pillow, bit for bit:
``decode_rgb(p)`` against ``Image.open(p).convert("RGB")`` and the resize
against ``Image.resize((res, res))`` (BICUBIC).

JPEGs come from Pillow at test time (qualities, subsamplings, optimized and
progressive coding, grey, CMYK, Adobe RGB, restart intervals, sizes from 1x1
to 500x375) and from ``scripts/image_writers.py`` for what Pillow cannot
write (4:4:0, 4:1:1 and mixed sampling factors, YCCK, CMYK without an Adobe
marker, RGB named by component ids, progressive scan scripts that leave bits
unrefined, so that libjpeg smooths the blocks). PNGs come from both. No
tolerance: every comparison is exact.
"""

import hashlib
import io
import itertools
import json
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from ssp_x_vit_tpu_torch.data import image_decode as idec
from ssp_x_vit_tpu_torch.data import native_loader, png

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import image_writers  # noqa: E402

FIXTURES = os.path.join(ROOT, "tests", "fixtures", "pets")
SIZES = [(1, 1), (2, 2), (17, 9), (9, 17), (16, 24), (33, 31), (500, 375)]
# for the numpy writer, which is slow at 500x375 (the fixtures have those sizes)
SMALL = SIZES[:-1] + [(40, 16), (16, 40), (100, 75)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's tiny tensors: the suite runs six
    workers on the host's cores, where a pool per worker only contends."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def picture(w, h, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1), (xx + yy) * 3 % 256], -1)
    return np.clip(base + rng.integers(-40, 40, (h, w, 3)), 0, 255).astype(np.uint8)


def assert_reads_as_pillow(data, tmp_path, name="img.jpg"):
    path = tmp_path / name
    path.write_bytes(data)
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    got = idec.decode_rgb(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def pillow_jpeg(img, **opts):
    buf = io.BytesIO()
    img.save(buf, "JPEG", **opts)
    return buf.getvalue()


@pytest.mark.parametrize("quality", [10, 75, 95])
@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("coding", ["baseline", "optimize", "progressive"])
def test_pillow_rgb_jpegs(tmp_path, quality, subsampling, coding):
    extra = {} if coding == "baseline" else {coding: True}
    for w, h in SIZES:
        img = Image.fromarray(picture(w, h, w * 7 + h))
        assert_reads_as_pillow(pillow_jpeg(img, quality=quality, subsampling=subsampling,
                                           **extra), tmp_path)


@pytest.mark.parametrize("mode", ["L", "CMYK", "keep_rgb"])
@pytest.mark.parametrize("progressive", [False, True])
def test_pillow_grey_cmyk_and_adobe_rgb_jpegs(tmp_path, mode, progressive):
    for (w, h), quality in itertools.product(SIZES, [10, 75, 95]):
        img = Image.fromarray(picture(w, h, w + h))
        opts = dict(quality=quality, progressive=progressive)
        if mode == "keep_rgb":
            opts["keep_rgb"] = True
        else:
            img = img.convert(mode)
        assert_reads_as_pillow(pillow_jpeg(img, **opts), tmp_path)


@pytest.mark.parametrize("opts", [{"restart_marker_blocks": 1}, {"restart_marker_blocks": 3},
                                  {"restart_marker_rows": 1},
                                  {"restart_marker_blocks": 2, "progressive": True}])
def test_restart_intervals(tmp_path, opts):
    for (w, h), sub in itertools.product([(17, 9), (100, 75), (500, 375)], [0, 2]):
        img = Image.fromarray(picture(w, h, 3))
        assert_reads_as_pillow(pillow_jpeg(img, quality=80, subsampling=sub, **opts), tmp_path)


SAMPLINGS = {"444": [(1, 1)] * 3, "440": [(1, 2), (1, 1), (1, 1)],
             "422": [(2, 1), (1, 1), (1, 1)], "420": [(2, 2), (1, 1), (1, 1)],
             "411": [(4, 1), (1, 1), (1, 1)], "mixed": [(2, 2), (1, 2), (2, 1)],
             "chroma_v2": [(1, 1), (1, 2), (1, 1)]}
# progressive scan scripts: (components, Ss, Se, Ah, Al)
SCRIPTS = {
    "sequential": None,
    # AC 1-5 of Y at Al=1, never refined: smoothing from the 5x5 DC window
    "unrefined_ac": [([0, 1, 2], 0, 0, 0, 1), ([0], 1, 5, 0, 1), ([1], 1, 63, 0, 0),
                     ([2], 1, 63, 0, 0), ([0], 6, 63, 0, 0), ([0, 1, 2], 0, 0, 1, 0)],
    # DC only: the DC itself is interpolated too
    "dc_only": [([0, 1, 2], 0, 0, 0, 0)],
    "dc_al2_only": [([0, 1, 2], 0, 0, 0, 2)],
    "dc_and_two_ac": [([0, 1, 2], 0, 0, 0, 0), ([0], 1, 2, 0, 0)],
}


@pytest.mark.parametrize("script", list(SCRIPTS))
@pytest.mark.parametrize("sampling", list(SAMPLINGS))
def test_written_ycc_jpegs(tmp_path, sampling, script):
    """Sampling factors Pillow cannot write, and progressive scripts whose
    unrefined coefficients make libjpeg smooth the blocks; 2-block-wide
    components and partial last iMCU rows included."""
    for w, h in SMALL:
        rgb = picture(w, h, w * h)
        ycc = np.asarray(Image.fromarray(rgb).convert("YCbCr"))
        planes = [ycc[..., i] for i in range(3)]
        data = image_writers.encode_jpeg(planes, SAMPLINGS[sampling], 60, scans=SCRIPTS[script])
        assert_reads_as_pillow(data, tmp_path)
    if script == "sequential":
        data = image_writers.encode_jpeg(planes, SAMPLINGS[sampling], 75, interleaved=False,
                                         restart_interval=2)
        assert_reads_as_pillow(data, tmp_path)


@pytest.mark.parametrize("kind", ["ycck", "cmyk_without_adobe", "rgb_by_component_ids",
                                  "ycc_without_markers", "jfif_over_adobe_rgb",
                                  "adobe_ycc_over_rgb_ids", "four_with_adobe_transform_1"])
def test_written_colour_spaces(tmp_path, kind):
    """libjpeg's colour-space guess (jdapimin.c) and Pillow's inverted CMYK:
    Adobe transform 2 is YCCK, four components without an Adobe marker are
    CMYK, ids 'R' 'G' 'B' without markers are RGB, other ids YCbCr; a JFIF
    marker wins over an Adobe one, an Adobe marker over the ids, and four
    components with another transform than 0 are YCCK."""
    for w, h in SMALL:
        rgb = picture(w, h, w + 2 * h)
        ycc = np.asarray(Image.fromarray(rgb).convert("YCbCr"))
        planes = [ycc[..., i] for i in range(3)]
        k = (rgb[..., 0] // 3).astype(np.uint8)
        if kind == "ycck":
            data = image_writers.encode_jpeg(planes + [k], [(2, 2), (1, 1), (1, 1), (2, 2)], 80,
                                             jfif=False, adobe_transform=2)
        elif kind == "cmyk_without_adobe":
            data = image_writers.encode_jpeg([rgb[..., 0], rgb[..., 1], rgb[..., 2], k],
                                             [(1, 1)] * 4, 80, jfif=False)
        elif kind == "rgb_by_component_ids":
            data = image_writers.encode_jpeg([rgb[..., i] for i in range(3)], [(1, 1)] * 3, 80,
                                             jfif=False, ids=[82, 71, 66])
        elif kind == "jfif_over_adobe_rgb":
            data = image_writers.encode_jpeg(planes, [(2, 2), (1, 1), (1, 1)], 80,
                                             adobe_transform=0)
        elif kind == "adobe_ycc_over_rgb_ids":
            data = image_writers.encode_jpeg(planes, [(1, 1)] * 3, 80, jfif=False,
                                             adobe_transform=1, ids=[82, 71, 66])
        elif kind == "four_with_adobe_transform_1":
            data = image_writers.encode_jpeg(planes + [k], [(1, 1)] * 4, 80, jfif=False,
                                             adobe_transform=1)
        else:
            data = image_writers.encode_jpeg(planes, [(2, 1), (1, 1), (1, 1)], 80, jfif=False,
                                             ids=[7, 8, 9])
        assert_reads_as_pillow(data, tmp_path)


@pytest.mark.parametrize("sampling", [[(2, 4), (1, 2), (1, 1)], [(3, 3), (1, 1), (1, 1)],
                                      [(3, 1), (2, 1), (1, 1)]])
def test_sampling_libjpeg_refuses_is_refused(tmp_path, sampling):
    """More than 10 blocks in an MCU, or a ratio that is not whole: libjpeg
    (so Pillow) refuses the file, and so does the reader."""
    rgb = picture(33, 17, 4)
    data = image_writers.encode_jpeg([rgb[..., i] for i in range(3)], sampling, 70)
    with pytest.raises(OSError):
        Image.open(io.BytesIO(data)).convert("RGB")
    path = tmp_path / "odd.jpg"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=r"odd\.jpg: .*(too many blocks|fractional sampling)"):
        idec.decode_rgb(path)


@pytest.mark.parametrize("coding", ["progressive", "sequential"])
def test_a_component_in_no_scan_reads_as_in_pillow(tmp_path, coding):
    """A file whose scans leave out a component (libjpeg has no quantization
    table to latch for it, so its samples come out mid-grey)."""
    rgb = picture(30, 20, 5)
    planes = [rgb[..., i] for i in range(3)]
    if coding == "progressive":
        data = image_writers.encode_jpeg(planes, [(2, 2), (1, 1), (1, 1)], 80,
                                         scans=[([0, 1], 0, 0, 0, 0), ([0], 1, 63, 0, 0)])
    else:  # one scan per component, the third cut off before its tables
        data = image_writers.encode_jpeg(planes, [(2, 2), (1, 1), (1, 1)], 80, interleaved=False)
        dht = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xc4"]
        data = data[:dht[2]] + b"\xff\xd9"
    assert_reads_as_pillow(data, tmp_path)


@pytest.mark.parametrize("color_type,depth", [(0, 8), (0, 16), (2, 8), (2, 16), (3, 8), (4, 8),
                                              (4, 16), (6, 8), (6, 16)])
@pytest.mark.parametrize("interlace", [False, True])
def test_written_pngs(tmp_path, color_type, depth, interlace):
    """Every filter type (drawn per scanline), Adam7, 16-bit samples (grey
    clips at 255 as Pillow's I;16, the others keep the high byte), palettes
    shorter than the indices (black past the end), tRNS ignored."""
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color_type]
    rng = np.random.default_rng(color_type * 100 + depth + interlace)
    for w, h in [(1, 1), (3, 2), (17, 9), (64, 33)]:
        palette = None
        if color_type == 3:
            samples = rng.integers(0, 12, (h, w, 1))
            palette = rng.integers(0, 256, (9, 3))
        else:
            samples = rng.integers(0, 1 << depth, (h, w, channels))
        trns = b"\x00\x05" if color_type == 0 else None
        data = image_writers.encode_png(samples, color_type, depth, interlace=interlace,
                                        palette=palette, trns=trns, seed=w + h)
        assert_reads_as_pillow(data, tmp_path, "img.png")


@pytest.mark.parametrize("bpp", [1, 3, 8])
def test_png_unfilter_every_filter_type(bpp):
    """Scanlines of every filter type, drawn per row, unfilter to their
    samples; a PNG with many Average / Paeth rows reads back whole."""
    rng = np.random.default_rng(bpp)
    for h, w in [(1, 1), (2, 5), (9, 17), (40, 33)]:
        samples = rng.integers(0, 256, (h, w, bpp))
        raw = image_writers._filter_rows(samples.astype(np.uint8).reshape(h, -1), bpp, rng)
        want = samples.astype(np.uint8).reshape(h, -1)
        np.testing.assert_array_equal(png.unfilter(np.frombuffer(raw, np.uint8), h, w * bpp, bpp),
                                      want)
    noisy = rng.integers(0, 256, (60, 90, 3))
    data = image_writers.encode_png(noisy, 2, seed=bpp)         # 2 in 5 rows Average / Paeth
    np.testing.assert_array_equal(png.read_rgb(data), noisy.astype(np.uint8))


def test_png_over_pillows_pixel_limit_is_refused(tmp_path):
    """Twice Pillow's decompression-bomb limit, as Pillow refuses it, from the
    header alone: nothing the size of the image is allocated."""
    import struct
    import zlib

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body))

    side = 20000   # 4e8 pixels, over 2 x 89478485
    data = (png.SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", side, side, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"\0" * 61)) + chunk(b"IEND", b""))
    path = tmp_path / "huge.jpg"
    path.write_bytes(data)
    with pytest.raises(Image.DecompressionBombError):
        Image.open(path)
    with pytest.raises(ValueError, match=r"huge\.jpg: image too large: 20000x20000"):
        idec.decode_rgb(path)
    with pytest.raises(ValueError, match=r"huge\.jpg: image too large"):
        idec.load_resized([path], 8)


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P", "I;16"])
def test_pillow_pngs(tmp_path, mode):
    for w, h in [(17, 9), (100, 75), (500, 375)]:
        rgb = picture(w, h, w + h)
        if mode == "P":
            img = Image.fromarray(rgb).quantize(37)
        elif mode == "I;16":
            img = Image.new("I;16", (w, h))
            img.frombytes((rgb[..., 0].astype(np.uint16) * 131 + rgb[..., 1]).astype("<u2").tobytes())
        else:
            img = Image.fromarray(rgb).convert(mode)
        buf = io.BytesIO()
        img.save(buf, "PNG")
        assert_reads_as_pillow(buf.getvalue(), tmp_path, "img.jpg")  # PNG data, .jpg name


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_png_sub_byte_depths_are_refused_by_name(tmp_path, depth):
    buf = io.BytesIO()
    Image.fromarray(picture(9, 5, 1)).quantize(1 << depth).save(buf, "PNG", bits=depth)
    path = tmp_path / "sub.jpg"
    path.write_bytes(buf.getvalue())
    with pytest.raises(ValueError, match=rf"sub\.jpg: unsupported PNG: {depth}-bit samples"):
        idec.decode_rgb(path)


@pytest.mark.parametrize("kind", ["baseline", "progressive", "png"])
def test_truncated_files_raise_where_pillow_raises(tmp_path, kind):
    """A file cut short raises naming it wherever Pillow raises; where Pillow
    still reads it (a PNG cut after its pixel data) the pixels are Pillow's."""
    img = Image.fromarray(picture(50, 40, 0))
    buf = io.BytesIO()
    if kind == "png":
        img.save(buf, "PNG")
    else:
        img.save(buf, "JPEG", quality=80, progressive=kind == "progressive")
    data = buf.getvalue()
    raised = 0
    for cut in (len(data) - 1, len(data) - 2, len(data) - 10, len(data) - 20, len(data) - 40,
                len(data) // 2, 300, 60, 20):
        path = tmp_path / f"cut{cut}.jpg"
        path.write_bytes(data[:cut])
        try:
            want = np.asarray(Image.open(io.BytesIO(data[:cut])).convert("RGB"))
        except OSError:
            raised += 1
            with pytest.raises(ValueError, match=f"cut{cut}\\.jpg: .*(truncated|PNG)"):
                idec.decode_rgb(path)
            with pytest.raises(ValueError, match=f"cut{cut}\\.jpg"):
                idec._load_resized([path], 16, 1)
        else:
            np.testing.assert_array_equal(idec.decode_rgb(path), want)
    assert raised >= 4


@pytest.mark.parametrize("fmt", ["GIF", "BMP", "TIFF"])
def test_other_formats_are_refused_by_name(tmp_path, fmt):
    buf = io.BytesIO()
    Image.fromarray(picture(8, 8, 0)).save(buf, fmt)
    path = tmp_path / "odd.jpg"
    path.write_bytes(buf.getvalue())
    with pytest.raises(ValueError, match=r"odd\.jpg: neither JPEG nor PNG data \(the file starts with"):
        idec.decode_rgb(path)
    with pytest.raises(ValueError, match=r"odd\.jpg: neither JPEG nor PNG"):
        idec._load_resized([path], 8, 1)


@pytest.mark.parametrize("res", [32, 224, 384])
def test_resize_matches_pillow(res):
    """Both resizes, up and down, against Pillow's; same size is a copy."""
    for w, h in [(1, 1), (17, 9), (500, 375), (375, 500), (224, 224), (100, 224), (640, 480),
                 (res, res)]:
        rgb = picture(w, h, w * h)
        want = np.asarray(Image.fromarray(rgb).resize((res, res)))
        np.testing.assert_array_equal(idec.resize(rgb, res), want)
        np.testing.assert_array_equal(idec.resize_plain(rgb, res), want)


def test_committed_fixtures_match_their_digests():
    """tests/fixtures/pets: the reader gives the pixels Pillow gave when the
    fixtures were written (expected.json), for the file and its 224 resize,
    one by one and through load_resized; Pillow here agrees too."""
    with open(os.path.join(FIXTURES, "expected.json")) as f:
        expected = json.load(f)
    images = os.path.join(FIXTURES, "oxford-iiit-pet", "images")
    names = sorted(expected["files"])
    assert len(names) >= 12

    def sha(a):
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()

    for name in names:
        e = expected["files"][name]
        path = os.path.join(images, name)
        assert os.path.getsize(path) == e["bytes"]
        rgb = idec.decode_rgb(path)
        assert list(rgb.shape) == e["shape"] and sha(rgb) == e["rgb_sha256"], name
        assert sha(idec.resize(rgb, 224)) == e["resized_224_sha256"], name
        assert sha(np.asarray(Image.open(path).convert("RGB"))) == e["rgb_sha256"], name
    batch = idec._load_resized([os.path.join(images, n) for n in names], 224, 3)
    assert [sha(b) for b in batch] == [expected["files"][n]["resized_224_sha256"] for n in names]


def test_load_resized_threads_order_and_the_failing_file(tmp_path):
    """Any thread count gives the same array, in path order, JPEG and PNG
    mixed; the first file that fails is the one named."""
    paths = []
    for i in range(9):
        img = Image.fromarray(picture(60 + i, 40 + 2 * i, i))
        path = tmp_path / f"{i}.jpg"
        if i % 4 == 3:
            img.save(path, "PNG")
        else:
            img.save(path, "JPEG", quality=70 + i)
        paths.append(path)
    want = np.stack([np.asarray(Image.open(p).convert("RGB").resize((24, 24))) for p in paths])
    for threads in (1, 2, 5, 16):
        np.testing.assert_array_equal(idec._load_resized(paths, 24, threads), want)
    (tmp_path / "5.jpg").write_bytes((tmp_path / "5.jpg").read_bytes()[:200])
    (tmp_path / "7.jpg").write_bytes(b"\xff\xd8\xff\xe0")
    with pytest.raises(ValueError, match=r"5\.jpg: truncated JPEG"):
        idec._load_resized(paths, 24, 3)
    with pytest.raises(ValueError, match=r"5\.jpg: truncated JPEG"):
        idec.load_resized(paths, 24)
    assert idec.load_resized([], 24).shape == (0, 24, 24, 3)


def test_the_decode_threads_error_reaches_the_caller(tmp_path, monkeypatch):
    """An exception on the JPEG thread is raised by load_resized itself."""
    path = tmp_path / "a.jpg"
    Image.fromarray(picture(20, 10, 0)).save(path, "JPEG")

    class Broken:
        def __getattr__(self, name):
            def call(*args):
                raise OSError("the library call failed")
            return call

    monkeypatch.setattr(idec, "native_library", lambda: Broken())
    with pytest.raises(OSError, match="the library call failed"):
        idec.load_resized([path], 8)


def test_bad_operands_and_a_failed_build_raise(tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="uint8"):
        idec.resize(np.zeros((4, 4), np.uint8), 8)
    with pytest.raises(ValueError, match="not a PNG"):
        png.read_rgb(b"\xff\xd8\xff", "x")
    # a compiler that fails: the build raises, no fallback
    monkeypatch.setattr(idec, "_lib", None)
    monkeypatch.setattr(native_loader, "BUILD_ROOT", tmp_path / "native")
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match=r"native image_decode\.cc build failed"):
        idec.resize(np.zeros((4, 4, 3), np.uint8), 8)
