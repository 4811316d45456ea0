#!/usr/bin/env python3
"""Write ``tests/fixtures/pets/``: a small Oxford-IIIT-Pet directory whose
files cover the kinds of image the reader must take, with their expected
pixels.

    python scripts/make_pet_fixtures.py [--out tests/fixtures/pets]

Needs Pillow (for the files it can write and for the expected values);
``scripts/image_writers.py`` writes the rest (4:4:0 and 4:1:1 sampling, YCCK,
a progressive scan script that leaves bits unrefined). The
images are drawn from fixed seeds at the dataset's usual sizes (~500x375):
smooth gradients and soft shapes with mild noise, so the files stay small.
The layout is the dataset's: ``oxford-iiit-pet/images/<Breed>_<n>.jpg`` and
``annotations/{trainval,test}.txt`` with ``image_id class_id species
breed_id`` lines. ``expected.json`` gives each file's byte size and the
sha256 of Pillow's ``open(p).convert("RGB")`` and of its ``.resize((224,
224))`` (as C-ordered uint8 bytes), with the Pillow and libjpeg-turbo versions.
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import os
import sys

import numpy as np
from PIL import Image, features

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import image_writers  # noqa: E402

# (image id, class id, species 1 cat / 2 dog, breed id, split, size, kind)
FIXTURES = [
    ("Abyssinian_1", 1, 1, 1, "trainval", (500, 375), "baseline 4:2:0 q75"),
    ("american_bulldog_2", 2, 2, 1, "test", (375, 500), "baseline 4:2:0 q95"),
    ("Bengal_3", 6, 1, 3, "trainval", (500, 333), "baseline 4:4:4 q90"),
    ("basset_hound_4", 4, 2, 3, "test", (500, 375), "baseline 4:2:2 q75"),
    ("Birman_5", 7, 1, 4, "trainval", (500, 375), "baseline 4:4:0 q80 (numpy writer)"),
    ("beagle_6", 5, 2, 4, "test", (500, 375), "grey q75"),
    ("Bombay_7", 8, 1, 5, "trainval", (500, 375), "progressive 4:2:0 q75"),
    ("boxer_8", 9, 2, 5, "test", (333, 500), "progressive 4:4:4 q85 optimize"),
    ("British_Shorthair_9", 10, 1, 6, "trainval", (500, 375), "optimize 4:2:0 q60"),
    ("chihuahua_10", 11, 2, 6, "test", (500, 400), "restart every 3 MCUs q75"),
    ("Egyptian_Mau_11", 12, 1, 7, "trainval", (450, 338), "progressive restart every row"),
    ("english_setter_12", 14, 2, 8, "test", (500, 375), "Adobe RGB (keep_rgb) q85"),
    ("Maine_Coon_13", 21, 1, 8, "trainval", (500, 375), "CMYK (Adobe, inverted) q75"),
    ("havanese_14", 17, 2, 11, "test", (500, 375), "YCCK (Adobe transform 2, numpy writer)"),
    ("Persian_15", 24, 1, 9, "trainval", (500, 375), "PNG under a .jpg name"),
    ("pug_16", 26, 2, 18, "test", (499, 373), "baseline 4:2:0 q75, odd size"),
    ("Ragdoll_17", 27, 1, 10, "trainval", (500, 375),
     "progressive, AC bits left unrefined (block smoothing, numpy writer)"),
    ("samoyed_18", 30, 2, 21, "test", (500, 375), "baseline 4:2:0 q10"),
    ("Siamese_19", 33, 1, 11, "trainval", (213, 160), "baseline 4:1:1 (numpy writer), small"),
    ("yorkshire_terrier_20", 37, 2, 25, "test", (500, 375), "progressive grey"),
]


def picture(w: int, h: int, seed: int) -> np.ndarray:
    """[h, w, 3] uint8: gradients, soft ellipses and mild noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([60 + 120 * xx / w, 80 + 100 * yy / h, 150 - 80 * (xx + yy) / (w + h)], -1)
    for _ in range(6):
        cx, cy = rng.uniform(0, w), rng.uniform(0, h)
        rx, ry = rng.uniform(w / 10, w / 3), rng.uniform(h / 10, h / 3)
        d = ((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2
        img += np.exp(-2 * d)[..., None] * rng.uniform(-90, 90, 3)
    img += rng.normal(0, 4, img.shape)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def encode(kind: str, rgb: np.ndarray) -> bytes:
    img = Image.fromarray(rgb)
    buf = io.BytesIO()
    ycc = np.asarray(img.convert("YCbCr"))
    planes = [ycc[..., i] for i in range(3)]
    if kind.startswith("baseline 4:4:0"):
        return image_writers.encode_jpeg(planes, [(1, 2), (1, 1), (1, 1)], 80)
    if kind.startswith("baseline 4:1:1"):
        return image_writers.encode_jpeg(planes, [(4, 1), (1, 1), (1, 1)], 75)
    if kind.startswith("YCCK"):
        k = np.asarray(img.convert("L"))[::-1] // 2
        return image_writers.encode_jpeg(planes + [k], [(2, 2), (1, 1), (1, 1), (2, 2)], 80,
                                         jfif=False, adobe_transform=2)
    if kind.startswith("progressive, AC bits"):
        scans = [([0, 1, 2], 0, 0, 0, 1), ([0], 1, 5, 0, 2), ([1], 1, 63, 0, 1),
                 ([2], 1, 63, 0, 1), ([0], 6, 63, 0, 1), ([0, 1, 2], 0, 0, 1, 0)]
        return image_writers.encode_jpeg(planes, [(2, 2), (1, 1), (1, 1)], 75, scans=scans)
    if kind.startswith("PNG"):
        img.save(buf, "PNG")
        return buf.getvalue()
    opts = {}
    if kind.startswith("grey") or kind == "progressive grey":
        img = img.convert("L")
    if kind.startswith("CMYK"):
        img = img.convert("CMYK")
    if "progressive" in kind:
        opts["progressive"] = True
    if "optimize" in kind:
        opts["optimize"] = True
    if "4:4:4" in kind:
        opts["subsampling"] = 0
    if "4:2:2" in kind:
        opts["subsampling"] = 1
    if "restart every 3" in kind:
        opts["restart_marker_blocks"] = 3
    if "restart every row" in kind:
        opts["restart_marker_rows"] = 1
    if "keep_rgb" in kind:
        opts["keep_rgb"] = True
    quality = int(kind.split(" q")[1].split()[0].rstrip(",")) if " q" in kind else 75
    img.save(buf, "JPEG", quality=quality, **opts)
    return buf.getvalue()


def digest(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a, np.uint8).tobytes()).hexdigest()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(os.path.dirname(__file__), "..", "tests",
                                                  "fixtures", "pets"))
    args = ap.parse_args()
    base = os.path.join(args.out, "oxford-iiit-pet")
    os.makedirs(os.path.join(base, "images"), exist_ok=True)
    os.makedirs(os.path.join(base, "annotations"), exist_ok=True)
    files, lines = {}, {"trainval": [], "test": []}
    for seed, (name, cls, species, breed, split, (w, h), kind) in enumerate(FIXTURES):
        data = encode(kind, picture(w, h, seed))
        path = os.path.join(base, "images", f"{name}.jpg")
        with open(path, "wb") as f:
            f.write(data)
        rgb = Image.open(path).convert("RGB")
        files[f"{name}.jpg"] = {
            "kind": kind, "bytes": len(data), "shape": [rgb.height, rgb.width, 3],
            "rgb_sha256": digest(np.asarray(rgb)),
            "resized_224_sha256": digest(np.asarray(rgb.resize((224, 224)))),
        }
        lines[split].append(f"{name} {cls} {species} {breed}\n")
    for split, ls in lines.items():
        with open(os.path.join(base, "annotations", f"{split}.txt"), "w") as f:
            f.writelines(ls)
    expected = {"pillow": Image.__version__, "libjpeg_turbo": features.version("libjpeg_turbo"),
                "files": files}
    with open(os.path.join(args.out, "expected.json"), "w") as f:
        json.dump(expected, f, indent=1)
        f.write("\n")
    total = sum(v["bytes"] for v in files.values())
    print(f"wrote {len(files)} files, {total} bytes, under {base}")


if __name__ == "__main__":
    main()
