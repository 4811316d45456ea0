"""LLM corpora and calibration splitting (own copy of the numpy parts of
``ssp_x_vit_tpu/llm/datasets.py``; the token streams are bit-identical).

The three corpus loaders (wikitext2, C4, FineWeb-Edu) return ``None``: their
files are not in the repository and nothing is downloaded, so every run uses
the deterministic synthetic token stream, as the JAX package does offline.
The readers of local corpus directories come with ROADMAP.md A.10a.
``tokenize_corpus`` turns texts into one token stream with a tokenizer
(``llm/tokenizer.py``).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def load_wikitext2(local_dir: Optional[str] = None):
    """wikitext-2 test split texts; ``None`` until the corpus loaders are ported."""
    return None


def load_c4(local_dir: Optional[str] = None, split: str = "validation"):
    """C4 texts; ``None`` until the corpus loaders are ported."""
    return None


def load_fineweb_edu(local_dir: Optional[str] = None):
    """FineWeb-Edu texts; ``None`` until the corpus loaders are ported."""
    return None


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
