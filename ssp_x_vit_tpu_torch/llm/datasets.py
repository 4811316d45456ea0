"""LLM corpora and calibration splitting (counterpart of
``ssp_x_vit_tpu/llm/datasets.py``; the synthetic token streams are
bit-identical).

The three corpus loaders (wikitext2, C4, FineWeb-Edu) read a local
``datasets.save_to_disk`` directory through ``llm/arrow_ipc.py`` and return its
``text`` column as a list of ``str`` (``None`` for a null row), as the JAX
package's ``load_from_disk(local_dir)["text"]`` reads it. Any failure prints
the JAX package's ``[INFO] <name> unavailable (<Type>); use
synthetic_token_stream`` and returns ``None``; so does a call without an
existing local directory, since nothing is downloaded (the JAX package tries
the hub there). ``tokenize_corpus`` turns texts into one token stream with a
tokenizer (``llm/tokenizer.py``).
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from ssp_x_vit_tpu_torch.llm.arrow_ipc import read_column


def _load_local(name: str, local_dir: Optional[str]) -> Optional[List[Optional[str]]]:
    try:
        if not (local_dir and os.path.exists(local_dir)):
            raise FileNotFoundError(f"no local {name} directory (nothing is downloaded)")
        return list(read_column(local_dir, "text"))
    except Exception as e:      # the JAX loaders' fallback: any failure -> synthetic stream
        print(f"[INFO] {name} unavailable ({type(e).__name__}); use synthetic_token_stream")
        return None


def load_wikitext2(local_dir: Optional[str] = None):
    """wikitext-2 test split texts from a local ``save_to_disk`` directory,
    or None (reference src/datasets.py:4-17)."""
    return _load_local("wikitext2", local_dir)


def load_c4(local_dir: Optional[str] = None, split: str = "validation"):
    """C4 texts from a local ``save_to_disk`` directory, or None (reference
    src/datasets.py:19-56; ``split`` picks the hub slice, which is not read)."""
    return _load_local("c4", local_dir)


def load_fineweb_edu(local_dir: Optional[str] = None):
    """FineWeb-Edu texts from a local ``save_to_disk`` directory, or None
    (reference src/datasets.py:58-75)."""
    return _load_local("fineweb-edu", local_dir)


def synthetic_token_stream(num_tokens: int, vocab_size: int, seed: int = 0) -> np.ndarray:
    """Deterministic structured token stream: a mixture of repeated n-grams
    over a small sub-vocabulary, so NLL is far below uniform and degrades when
    the model is damaged; a usable offline stand-in for perplexity-driven
    search. Returns int32 ``[1, num_tokens]``."""
    rng = np.random.default_rng(seed)
    n_patterns = 64
    pat_len = 16
    sub_vocab = rng.integers(0, vocab_size, size=512)
    patterns = [sub_vocab[rng.integers(0, 512, size=pat_len)] for _ in range(n_patterns)]
    out = np.empty(num_tokens, np.int32)
    i = 0
    while i < num_tokens:
        p = patterns[int(rng.integers(0, n_patterns))]
        n = min(pat_len, num_tokens - i)
        out[i: i + n] = p[:n]
        i += n
    return out.reshape(1, -1)


def tokenize_corpus(texts: List[str], tokenizer) -> np.ndarray:
    """'\\n\\n'.join(texts) tokenized without special tokens, int32 ``[1, n]``
    (reference main.py:93-95, src/utilities.py:158-161)."""
    ids = tokenizer("\n\n".join(texts), add_special_tokens=False)["input_ids"]
    return np.asarray(ids, np.int32).reshape(1, -1)


def get_calibration(input_ids: np.ndarray, num_samples: int, seq_len: int = 2048
                    ) -> List[np.ndarray]:
    """Split a token stream into ``num_samples`` windows of ``seq_len``
    (reference src/utilities.py:153-168)."""
    flat = np.asarray(input_ids).reshape(-1)
    out = []
    for i in range(num_samples):
        chunk = flat[i * seq_len: (i + 1) * seq_len]
        if chunk.size < seq_len:
            break
        out.append(chunk.reshape(1, seq_len))
    return out
