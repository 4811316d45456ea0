"""Reproducibility seeding (counterpart of ``ssp_x_vit_tpu/utils/seeding.py``;
reference src/utilities.py:13-19)."""

from __future__ import annotations

import logging
import random
from typing import Optional

import numpy as np
import torch


def set_seed(seed: int, device: Optional[torch.device] = None) -> torch.Generator:
    """Seed python, numpy and torch; return a fresh generator on ``device``
    (the CPU by default) seeded with ``seed``, where the JAX function returns
    a fresh PRNG key."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    logging.info(f"Seed for reproducibility: {seed}")
    gen = torch.Generator(device=device if device is not None else "cpu")
    gen.manual_seed(seed)
    return gen
