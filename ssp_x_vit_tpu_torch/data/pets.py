"""Oxford-IIIT-Pet on disk, as torchvision's ``OxfordIIITPet`` reads it, without
torchvision (counterpart of what ``ssp_x_vit_tpu/data/srp.py`` reaches through
``torchvision.datasets.OxfordIIITPet``).

``<root>/oxford-iiit-pet/`` is the dataset when both its ``images`` and
``annotations`` entries are directories (torchvision's ``_check_exists``).
``annotations/{trainval,test}.txt`` hold one ``image_id class_id species
breed_id`` line per image; the label is ``int(class_id) - 1`` and the image is
``images/{image_id}.jpg``, in file order.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

SPLITS = ("trainval", "test")


def pets_split(root: str, split: str) -> Optional[Tuple[List[str], List[int]]]:
    """(image paths, labels) of ``split`` under ``root``; None when the
    dataset is not there. A missing annotation file raises ``OSError``, an
    empty one or a malformed line ``ValueError``, each naming the file."""
    if split not in SPLITS:
        raise ValueError(f"split must be one of {SPLITS}, got {split!r}")
    base = os.path.join(root, "oxford-iiit-pet")
    images, anns = os.path.join(base, "images"), os.path.join(base, "annotations")
    if not (os.path.isdir(images) and os.path.isdir(anns)):
        return None
    listing = os.path.join(anns, f"{split}.txt")
    paths, labels = [], []
    with open(listing, encoding="utf-8") as f:
        for n, line in enumerate(f, 1):
            fields = line.strip().split()
            if len(fields) != 4 or not fields[1].isdigit():
                raise ValueError(f"{listing}:{n}: expected 'image_id class_id species breed_id', "
                                 f"got {line.strip()!r}")
            paths.append(os.path.join(images, f"{fields[0]}.jpg"))
            labels.append(int(fields[1]) - 1)
    if not paths:
        raise ValueError(f"{listing}: no images listed")
    return paths, labels
