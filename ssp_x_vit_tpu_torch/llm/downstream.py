"""Downstream task evaluation (counterpart of ``ssp_x_vit_tpu/llm/downstream.py``;
reference src/evaluation.py:69-116).

The JAX module prefers the lm-eval harness (pip-installed, or the
reference's vendored copy path-imported by ``harness_compat.py``) and falls
back to an offline task pack (``llm/taskpack.py``). ``lm_eval`` is on neither
machine this port runs on, so only the task-pack leg is ported:
``lm_eval_available()`` is False without importing anything, and the harness
adapters (``make_jax_lm``, ``eval_zero_shot``) raise naming ROADMAP.md A.10e.
The task pack's text goes through the model directory's tokenizer
(``llm/tokenizer.py`` ``load_tokenizer``), or raw UTF-8 bytes when it has
none, where the JAX module would try ``transformers.AutoTokenizer``.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch

TASK_LIST = ["winogrande", "arc_easy", "arc_challenge", "hellaswag", "piqa", "mmlu"]

_HARNESS_NOT_PORTED = ("the lm-eval harness leg is not ported: lm_eval is on neither machine "
                       "(llm/downstream.py, llm/harness_compat.py, ROADMAP.md A.10e); "
                       "use --task-pack")


def _make_offline_encode(model_name_or_dir: str):
    """Tokenizer for the task-pack leg: the directory's tokenizer through
    ``load_tokenizer`` without special tokens (the byte-level
    ``tokenizer.json`` class, any other ``tokenizer.json`` pipeline, or
    ``tokenizer.model``), raw UTF-8 byte ids when the directory has none.
    The JAX module reads any ``tokenizer.json`` with its byte-level class
    (which raises ``ValueError`` on a SentencePiece-style one) and hands the
    rest to ``transformers.AutoTokenizer``."""
    if os.path.isdir(model_name_or_dir):
        from ssp_x_vit_tpu_torch.llm.tokenizer import load_tokenizer

        try:
            tok = load_tokenizer(model_name_or_dir)
            return lambda s: tok(s, add_special_tokens=False)["input_ids"]
        except OSError as e:
            reason = str(e)
    else:
        reason = "not a directory"
    logging.warning(f"no tokenizer for {model_name_or_dir!r} ({reason}); "
                    "falling back to raw UTF-8 byte ids — scores are only comparable "
                    "against the same byte encoding")
    return lambda s: [int(b) for b in s.encode("utf-8")]


def lm_eval_available() -> bool:
    """False: the harness leg is not ported (nothing is imported to find out)."""
    return False


def make_jax_lm(params, cfg, tokenizer, batch_size: int = 1, max_length: int = 2048):
    """The lm-eval LM adapter of the JAX module; not ported."""
    raise NotImplementedError(_HARNESS_NOT_PORTED)


def eval_zero_shot(model_name, params, cfg, tokenizer, task_list=None,
                   num_fewshot: int = 0, limit: Optional[int] = None):
    """(reference src/evaluation.py:88-116) through the lm-eval harness; not ported."""
    raise NotImplementedError(_HARNESS_NOT_PORTED)


def evaluation_downstream(params, cfg, model_name_or_dir: str,
                          num_fewshot: int = 0,
                          task_pack: Optional[str] = None,
                          *, compute_dtype=torch.bfloat16):
    """(reference src/evaluation.py:69-84) The offline task pack (``task_pack``
    or $SSP_X_VIT_TASK_PACK) scored on the parameters' device, or the JAX
    module's warning and None when there is none."""
    pack = task_pack or os.environ.get("SSP_X_VIT_TASK_PACK")
    if pack and os.path.isdir(pack):
        logging.info(f"running offline task pack {pack}")
        from ssp_x_vit_tpu_torch.llm.taskpack import evaluate_task_pack

        encode = _make_offline_encode(model_name_or_dir)
        results = evaluate_task_pack(params, cfg, pack, encode, compute_dtype=compute_dtype)
        for task, r in results.items():
            logging.info(f"{task} : {r['acc']} ({r['count']} examples)")
        return {"results": results, "backend": "taskpack"}
    logging.warning(
        "downstream evaluation unavailable: no usable lm-eval harness "
        "(not pip-installed and no vendored copy importable, or its "
        "tokenizer/task data needs network) and no offline task pack; set "
        "SSP_X_VIT_TASK_PACK or pass --task-pack (llm/taskpack.py). The "
        "standalone zero-shot core is ssp_x_vit_tpu_torch.llm.zeroshot.")
    return None
