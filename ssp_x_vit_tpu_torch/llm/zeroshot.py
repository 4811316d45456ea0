"""Zero-shot multiple-choice scoring on PyTorch (counterpart of
``ssp_x_vit_tpu/llm/zeroshot.py``).

The scoring behind the reference's downstream evaluation (the lm-eval
harness tasks winogrande / arc / hellaswag / piqa / mmlu are all
loglikelihood-comparison multiple choice, reference src/evaluation.py:69-116):
each example scores ``context + choice_i`` by the total (or length-normalized)
log-likelihood of the choice tokens and picks the argmax. Tasks are plain
dicts, so this works offline; ``llm/taskpack.py`` feeds it local task files.
Every forward runs on the parameters' device through ``generate.full_logits``
(row 5's flash kernel on the card); one host read per scored sequence.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ssp_x_vit_tpu_torch.llm.generate import full_logits
from ssp_x_vit_tpu_torch.llm.model import LlamaConfig


def _padded_tokens(context_tokens, continuation_tokens, pad_to, device) -> torch.Tensor:
    """Right-padded [1, max(len, pad_to)] ids (causality makes pad positions inert)."""
    ids = list(context_tokens) + list(continuation_tokens)
    tokens = np.zeros((1, max(len(ids), pad_to)), np.int64)
    tokens[0, :len(ids)] = ids
    return torch.from_numpy(tokens).to(device)


def _token_logprobs(params, tokens, cfg, compute_dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [b, s] -> (log p(tokens[t] | tokens[<t]) at positions 1..s-1,
    the greedy (argmax) token at each of those positions), both [b, s-1]."""
    logits = full_logits(params, tokens, cfg, compute_dtype)[:, :-1].float()
    logp = torch.log_softmax(logits, dim=-1)
    return torch.gather(logp, -1, tokens[:, 1:, None])[..., 0], logits.argmax(dim=-1)


@torch.no_grad()
def sequence_loglikelihood_greedy(
    params, cfg: LlamaConfig,
    context_tokens: Sequence[int],
    continuation_tokens: Sequence[int],
    *,
    pad_to: int = 0,
    compute_dtype=torch.bfloat16,
) -> Tuple[float, bool]:
    """(log p(continuation | context), is_greedy): the lm-eval harness
    ``loglikelihood`` contract; is_greedy is True iff every continuation
    token is the argmax prediction at its position."""
    tokens = _padded_tokens(context_tokens, continuation_tokens, pad_to, params["embed"].device)
    lp, greedy = _token_logprobs(params, tokens, cfg, compute_dtype)
    start = len(context_tokens) - 1  # prediction of the first continuation token
    n = len(continuation_tokens)
    lp = lp[0, start:start + n].cpu().numpy()
    greedy = greedy[0, start:start + n].cpu().numpy()
    return float(lp.sum()), bool((greedy == np.asarray(continuation_tokens)).all())


def sequence_loglikelihood(
    params, cfg: LlamaConfig,
    context_tokens: Sequence[int],
    continuation_tokens: Sequence[int],
    *,
    pad_to: int = 0,
    compute_dtype=torch.bfloat16,
) -> float:
    """log p(continuation | context), summed over the continuation tokens;
    right padding to ``pad_to`` keeps the shapes bucketed."""
    return sequence_loglikelihood_greedy(params, cfg, context_tokens, continuation_tokens,
                                         pad_to=pad_to, compute_dtype=compute_dtype)[0]


def evaluate_multiple_choice(
    params, cfg: LlamaConfig,
    examples: List[Dict],
    encode: Callable[[str], List[int]],
    *,
    length_normalized: bool = False,
    bucket: int = 128,
    compute_dtype=torch.bfloat16,
) -> Dict[str, object]:
    """examples: [{"context": str, "choices": [str, ...], "label": int}].

    Returns {"acc", "count"} as the JAX function does, and "scores": each
    example's per-choice score (what the argmax is taken over). Sequences
    are padded to multiples of ``bucket``."""
    correct = 0
    all_scores = []
    for ex in examples:
        ctx = encode(ex["context"])
        scores = []
        for choice in ex["choices"]:
            cont = encode(choice)
            pad_to = -(-(len(ctx) + len(cont)) // bucket) * bucket
            ll = sequence_loglikelihood(params, cfg, ctx, cont, pad_to=pad_to,
                                        compute_dtype=compute_dtype)
            scores.append(ll / len(cont) if length_normalized else ll)
        if int(np.argmax(scores)) == ex["label"]:
            correct += 1
        all_scores.append(scores)
    n = len(examples)
    return {"acc": correct / max(1, n), "count": n, "scores": all_scores}
