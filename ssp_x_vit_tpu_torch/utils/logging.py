"""Tagged log lines parsed by the grid runners and the reference's tooling
(counterpart of ``ssp_x_vit_tpu/utils/logging.py``; reference
adaptation-for-Pures-framework/auto_2ssp.py:65-69, the [SUMMARY] contract of
manual-experiments/run_consensus_grid.py:189-200)."""

from __future__ import annotations

import json
from typing import Any, Dict


def step_log(msg: str) -> None:
    print(f"[STEP] {msg}", flush=True)


def stage_log(stage: str, msg: str) -> None:
    print(f"[stage:{stage}] {msg}", flush=True)


def summary_log(payload: Dict[str, Any]) -> None:
    """Machine-readable one-line summary parsed by the grid runners."""
    print(f"[SUMMARY] {json.dumps(payload)}", flush=True)
