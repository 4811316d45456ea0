"""Latency measurement (counterpart of ``ssp_x_vit_tpu/evaluation/latency.py``).

Reference protocol (experiments/vit_pruning/auto_2ssp.py:74-99): dummy input,
3 warm-up calls, 10 timed calls, mean milliseconds. On the card the 10 calls
are timed with CUDA events around the loop; on the CPU with the host clock.
"""

from __future__ import annotations

import time
from typing import Callable

import torch

from ssp_x_vit_tpu_torch.models.vit import (
    ViTConfig, cast_params, params_device, vit_forward, vit_forward_materialized,
)


def measure_latency_fn(fn: Callable[[], object], device: torch.device, *, warmup: int = 3,
                       iters: int = 10) -> float:
    """Mean milliseconds per call of ``fn()`` on ``device``."""
    for _ in range(warmup):
        fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


@torch.inference_mode()
def measure_latency(params, cfg: ViTConfig, *, batch_size: int = 1, warmup: int = 3,
                    iters: int = 10, compute_dtype=torch.float32) -> float:
    """Mean forward latency (ms) on a zero batch of ``batch_size`` images."""
    device = params_device(params)
    params = cast_params(params, compute_dtype)
    dummy = torch.zeros((batch_size, cfg.image_size, cfg.image_size, cfg.num_channels),
                        dtype=compute_dtype, device=device)
    if cfg.is_materialized_pruned:
        def fn():
            return vit_forward_materialized(params, dummy, cfg, compute_dtype=compute_dtype)
    else:
        def fn():
            return vit_forward(params, dummy, cfg, compute_dtype=compute_dtype)[0]
    return measure_latency_fn(fn, device, warmup=warmup, iters=iters)
