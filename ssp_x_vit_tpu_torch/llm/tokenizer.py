"""Tokenizers of a model directory (counterpart of ``ssp_x_vit_tpu/llm/tokenizer.py``).

``load_tokenizer`` dispatches as the JAX package does: a ``tokenizer.json``
that ``ByteLevelBPETokenizer`` takes goes there; any other ``tokenizer.json``
runs its whole pipeline in ``llm/hf_tokenizer.py`` (SentencePiece-style BPE
with byte fallback, byte-level BPE with its own ``Split`` patterns, Unigram;
where the JAX package calls ``transformers.AutoTokenizer``); a directory with
only a ``tokenizer.model`` is read by ``llm/spm_model.py``; a directory with
neither raises ``OSError``.

``ByteLevelBPETokenizer`` reads byte-level BPE ``tokenizer.json`` files
(GPT-2 / qwen2-class) and encodes and decodes as the JAX package's class of
that name does, with the standard library and numpy only:

- the GPT-2 pre-tokenizer
  ``'s|'t|'re|'ve|'m|'ll|'d| ?L+| ?N+| ?[^\\sLN]+|\\s+(?!\\S)|\\s+`` as a ``re``
  pattern whose classes are built once from ``unicodedata``
  (``llm/unicode_re.py``): letters are the categories L*, numbers N*,
  whitespace is Unicode White_Space (``str.isspace()`` without
  U+001C-U+001F, which ``re``'s ``\\s`` wrongly includes). Code points assigned
  after this Python's Unicode version are unassigned (Cn) here, so they fall
  in the "other" class;
- the ranked-merge loop over a batch of pre-tokens in C++ (``native/bpe.cc``,
  built with g++ into ``build/native/<hash>/`` at first use and loaded with
  ctypes when a tokenizer is made). ``engine="python"`` runs the plain Python
  loop (``_merge_py``) instead. A native engine that fails to build or load
  raises: it never becomes the Python loop on its own.

That class encodes and decodes the base vocabulary only, as the JAX one does:
added tokens (``<|endoftext|>``) are not matched in text and are dropped by
``decode``; it adds no BOS and has no ``eos_token_id``. The pipeline
tokenizers of ``llm/hf_tokenizer.py`` match added tokens, add what the
directory's post-processor or tokenizer class adds (Llama's BOS) and have
``bos_token_id`` / ``eos_token_id``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import json
import os
import re
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ssp_x_vit_tpu_torch.llm.unicode_re import compile_onig

_ROOT = Path(__file__).resolve().parents[2]
BPE_SOURCE = _ROOT / "native" / "bpe.cc"
BUILD_ROOT = _ROOT / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

_lock = threading.Lock()
_lib = None


def _build_native(source: Path = None, lib_name: str = "libssp_bpe.so") -> Path:
    """Compile ``source`` (default ``native/bpe.cc``) unless its library for
    this source and these flags exists; return the library's path. The output
    directory is keyed by a hash of both, and the library is written under a
    temporary name and renamed, so a concurrent build never loads a
    half-written file."""
    source = BPE_SOURCE if source is None else source
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(source.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    so = out_dir / lib_name
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"{lib_name}.{os.getpid()}.{threading.get_ident()}.tmp"
        proc = subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp),
                               str(source)], capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"native BPE build failed (exit {proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
    return so


def native_library() -> ctypes.CDLL:
    """The loaded merge engine with its C signatures declared; built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build_native()))
            lib.bpe_init.restype = ctypes.c_void_p
            lib.bpe_init.argtypes = [ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_void_p]
            lib.bpe_free.argtypes = [ctypes.c_void_p]
            lib.bpe_encode_batch.restype = ctypes.c_int64
            lib.bpe_encode_batch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                             ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
            _lib = lib
        return _lib


def native_available() -> bool:
    """Whether the native merge engine builds and loads here."""
    try:
        native_library()
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return False
    return True


@functools.lru_cache(maxsize=1)
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte <-> printable-unicode alphabet."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


GPT2_PATTERN = r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""


def gpt2_pattern() -> "re.Pattern":
    """The GPT-2 pre-tokenization pattern with \\p{L}, \\p{N} and \\s spelled
    out from ``unicodedata`` (``llm/unicode_re.py``; built once per process, ~1 s)."""
    return compile_onig(GPT2_PATTERN)


def load_tokenizer(model_dir: str, *, engine: str = "native"):
    """The tokenizer of a local model directory, in the JAX package's order:
    its ``tokenizer.json`` through ``ByteLevelBPETokenizer`` when that class
    takes the file; else the file's whole pipeline (``llm/hf_tokenizer.py``,
    where the JAX package calls ``transformers.AutoTokenizer``); else the
    directory's SentencePiece ``tokenizer.model`` (``llm/spm_model.py``).
    A directory with neither file raises ``OSError``, as ``AutoTokenizer``
    fails on one; a pipeline node that is not ported raises ``ValueError``
    naming it."""
    path = os.path.join(model_dir, "tokenizer.json")
    if os.path.exists(path):
        try:
            return ByteLevelBPETokenizer.from_file(path, engine=engine)
        except ValueError:
            from ssp_x_vit_tpu_torch.llm.hf_tokenizer import HFTokenizer

            return HFTokenizer.from_dir(model_dir, engine=engine)
    if os.path.exists(os.path.join(model_dir, "tokenizer.model")):
        from ssp_x_vit_tpu_torch.llm.spm_model import load_spm_tokenizer

        return load_spm_tokenizer(model_dir, engine=engine)
    raise OSError(f"{model_dir} holds neither tokenizer.json nor tokenizer.model: "
                  "no tokenizer to load")


class ByteLevelBPETokenizer:
    """Encode/decode for byte-level BPE tokenizer.json files.

    ``engine`` is ``"native"`` (the C++ merge loop) or ``"python"`` (the plain
    loop); ``native_batches`` counts the batches the native loop merged."""

    def __init__(self, vocab: Dict[str, int], merges: Sequence[Tuple[str, str]], *,
                 add_prefix_space: bool = False, engine: str = "native"):
        if engine not in ("native", "python"):
            raise ValueError(f"engine must be 'native' or 'python', got {engine!r}")
        self.engine = engine
        self.native_batches = 0
        self._vocab = dict(vocab)
        self._id_to_token = {i: t for t, i in self._vocab.items()}
        self._add_prefix_space = add_prefix_space
        self._pat = gpt2_pattern()
        self._byte_enc = bytes_to_unicode()
        self._byte_dec = {c: b for b, c in self._byte_enc.items()}
        left, right, merged, rank = [], [], [], {}
        for i, (a, b) in enumerate(merges):
            la, lb, lm = self._vocab.get(a), self._vocab.get(b), self._vocab.get(a + b)
            if la is None or lb is None or lm is None:
                raise ValueError(f"merge ({a!r}, {b!r}) not closed under vocab")
            left.append(la)
            right.append(lb)
            merged.append(lm)
            rank[(la, lb)] = i
        self._left = np.asarray(left, np.int32)
        self._right = np.asarray(right, np.int32)
        self._merged = np.asarray(merged, np.int32)
        self._rank = rank
        self._handle = None
        if engine == "native" and len(left):
            self._handle = ctypes.c_void_p(native_library().bpe_init(
                len(left), self._left.ctypes.data, self._right.ctypes.data,
                self._merged.ctypes.data))
        self._word_cache: Dict[str, List[int]] = {}

    # ---------------- construction ----------------

    @classmethod
    def from_file(cls, path: str, *, engine: str = "native") -> "ByteLevelBPETokenizer":
        """Load an HF tokenizer.json (model.type == BPE, ByteLevel pre-tokenizer,
        no custom Split pattern); anything else raises ValueError."""
        with open(path, encoding="utf-8") as f:
            tj = json.load(f)
        model = tj["model"]
        if model.get("type") != "BPE":
            raise ValueError(f"unsupported tokenizer model {model.get('type')}")
        merges = [tuple(m.split(" ", 1)) if isinstance(m, str) else tuple(m)
                  for m in model["merges"]]
        found = {"byte_level": False, "add_prefix": False, "split": False}

        def walk(node):
            if isinstance(node, dict):
                if node.get("type") == "ByteLevel":
                    found["byte_level"] = True
                    found["add_prefix"] = bool(node.get("add_prefix_space", False))
                if node.get("type") == "Split" and node.get("pattern"):
                    found["split"] = True
                for v in node.values():
                    walk(v)
            elif isinstance(node, list):
                for v in node:
                    walk(v)

        walk(tj.get("pre_tokenizer"))
        if not found["byte_level"]:
            raise ValueError("tokenizer.json has no ByteLevel pre-tokenizer (SentencePiece-style "
                             "BPE); the byte-level engine does not apply")
        if found["split"]:
            raise ValueError("tokenizer.json carries a custom Split pre-tokenization pattern; "
                             "the engine implements the GPT-2 rule only")
        return cls(model["vocab"], merges, add_prefix_space=found["add_prefix"], engine=engine)

    @classmethod
    def from_pretrained_dir(cls, model_dir: str, *, engine: str = "native"
                            ) -> "ByteLevelBPETokenizer":
        return cls.from_file(os.path.join(model_dir, "tokenizer.json"), engine=engine)

    # ---------------- encode ----------------

    def pretokenize(self, text: str) -> List[str]:
        """The GPT-2 pre-tokens of ``text`` (after the optional prefix space)."""
        if self._add_prefix_space and text and not text.startswith(" "):
            text = " " + text
        return self._pat.findall(text)

    def _initial_syms(self, word: str) -> List[int]:
        return [self._vocab[self._byte_enc[b]] for b in word.encode("utf-8")]

    def _merge_py(self, syms: List[int]) -> List[int]:
        """The plain merge loop: merge the lowest-ranked adjacent pair until none applies."""
        syms = list(syms)
        while len(syms) >= 2:
            best, pos = None, -1
            for i in range(len(syms) - 1):
                r = self._rank.get((syms[i], syms[i + 1]))
                if r is not None and (best is None or r < best):
                    best, pos = r, i
            if pos < 0:
                break
            syms[pos:pos + 2] = [int(self._merged[best])]
        return syms

    def _merge_batch_native(self, words: List[List[int]]) -> List[List[int]]:
        if self._handle is None:    # no merges
            return [list(w) for w in words]
        flat = np.asarray([s for w in words for s in w], np.int32)
        offs = np.zeros(len(words) + 1, np.int64)
        np.cumsum([len(w) for w in words], out=offs[1:])
        out = np.empty_like(flat)
        out_offs = np.empty(len(words) + 1, np.int64)
        native_library().bpe_encode_batch(self._handle, flat.ctypes.data, offs.ctypes.data, len(words),
                             out.ctypes.data, out_offs.ctypes.data)
        self.native_batches += 1
        return [out[out_offs[i]:out_offs[i + 1]].tolist() for i in range(len(words))]

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        """Token ids of ``text`` in the base vocabulary (no special tokens either way)."""
        del add_special_tokens
        pretokens = self.pretokenize(text)
        todo, pending = [], set()
        for w in pretokens:
            if w not in self._word_cache and w not in pending:
                pending.add(w)
                todo.append(w)
        if todo:
            syms = [self._initial_syms(w) for w in todo]
            if self.engine == "native":
                results = self._merge_batch_native(syms)
            else:
                results = [self._merge_py(s) for s in syms]
            self._word_cache.update(zip(todo, results))
        out: List[int] = []
        for w in pretokens:
            out.extend(self._word_cache[w])
        return out

    def __call__(self, text: str, add_special_tokens: bool = False):
        return {"input_ids": self.encode(text)}

    # ---------------- decode ----------------

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        """Text of ``ids``; ids outside the base vocabulary are dropped and
        invalid UTF-8 becomes U+FFFD."""
        chars = "".join(self._id_to_token[int(i)] for i in ids if int(i) in self._id_to_token)
        data = bytes(self._byte_dec[c] for c in chars if c in self._byte_dec)
        return data.decode("utf-8", errors="replace")

    @property
    def vocab_size(self) -> int:
        return len(self._vocab)

    def __del__(self):
        if _lib is not None and getattr(self, "_handle", None):
            _lib.bpe_free(self._handle)
