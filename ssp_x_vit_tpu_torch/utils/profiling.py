"""Profiler traces and wall-clock sections (counterpart of
``ssp_x_vit_tpu/utils/profiling.py``).

``trace`` records a ``torch.profiler`` trace (host operators, and the card's
kernels when CUDA is available) and writes it as a Chrome trace JSON file
(``trace-<pid>-<n>.json``) into the directory, which Perfetto and
chrome://tracing open; the JAX package writes a TensorBoard profile there
instead. ``SectionTimer`` is the JAX package's.

On the card the profiler keeps only the kernels whose times fall inside its
capture window, and in some traces it places every kernel milliseconds
earlier than the host's clock says (a kernel starting before its own
launch): the first kernels of the block then fall before the window and are
lost. So ``trace`` waits for the device and idles ``SETTLE_S`` inside each
edge of the window. The profiler can also lose the first kernels of a trace
for a reason the trace does not show (the launches are in it), so the
window opens with ``WARM_KERNELS`` tiny kernels of ``trace``'s own. After
writing the file ``trace`` matches every later kernel launch in it to its
kernel and warns when a launch has none (``scripts/torch_trace_check.py``
counts both on the card).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import time
import warnings
from typing import Dict, Iterator, Optional

import torch

_traces = itertools.count()
SETTLE_S = 0.02  # idle seconds on each side of the block, inside the window
WARM_KERNELS = 128  # tiny kernels launched first in the window, left out of the check


def _settle() -> None:
    torch.cuda.synchronize()
    time.sleep(SETTLE_S)


def launches_without_kernel(path: str, skip: int = 0) -> int:
    """The kernel launches in a Chrome trace, after its first ``skip``, whose
    kernel is not in it (matched by the CUPTI correlation id)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    launched, ran = [], set()
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and "LaunchKernel" in e.get("name", ""):
            launched.append((float(e["ts"]), corr))
        elif e.get("cat") == "kernel":
            ran.add(corr)
    return sum(corr not in ran for _, corr in sorted(launched)[skip:])


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[None]:
    """Record a profiler trace of the block when a directory is given (or
    the ``SSP_X_VIT_TRACE_DIR`` environment variable names one); a no-op
    otherwise."""
    log_dir = log_dir or os.environ.get("SSP_X_VIT_TRACE_DIR")
    if not log_dir:
        yield
        return
    os.makedirs(log_dir, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    warm = torch.zeros(1, device="cuda") if cuda else None
    prof.start()
    if cuda:
        for _ in range(WARM_KERNELS):
            warm.add_(1)
        _settle()
    try:
        yield
    finally:
        if cuda:
            _settle()
        prof.stop()
        path = os.path.join(log_dir, f"trace-{os.getpid()}-{next(_traces)}.json")
        prof.export_chrome_trace(path)
        missing = launches_without_kernel(path, WARM_KERNELS) if cuda else 0
        if missing:
            warnings.warn(f"{path}: {missing} kernel launches have no kernel event in the trace")
        print(f"[TRACE] profiler trace written to {log_dir}")


class SectionTimer:
    """Named wall-clock sections with a summary line (pruning-time reporting,
    reference main.py:164,197-198 style)."""

    def __init__(self):
        self.sections: Dict[str, float] = {}

    @contextlib.contextmanager
    def section(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.sections[name] = self.sections.get(name, 0.0) + time.perf_counter() - t0

    def summary(self) -> str:
        return " | ".join(f"{k}={v:.2f}s" for k, v in self.sections.items())
