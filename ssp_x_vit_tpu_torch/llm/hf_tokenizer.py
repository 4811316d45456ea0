"""The ``tokenizer.json`` pipeline of HF ``tokenizers``, in host code of the port.

The JAX package hands every tokenizer that its byte-level class refuses to
``transformers.AutoTokenizer``: SentencePiece-style BPE with byte fallback
(Llama-2, Mistral, Mixtral, Phi-3, Gemma), byte-level BPE with its own
``Split`` patterns (Llama-3, Qwen2 / Qwen3, DeepSeek-V3) and Unigram files.
``HFTokenizer`` runs the same pipeline with the standard library and numpy:

1. added vocabulary: the text is cut at added tokens before anything else
   (those with ``normalized: false`` on the raw text, the others on each
   normalized segment), honouring ``special``, ``lstrip``, ``rstrip`` and
   ``single_word``;
2. normalizers: ``Prepend``, ``Replace`` (string or regex), ``NFC``, ``NFKC``,
   ``NFD``, ``NFKD``, ``Lowercase``, ``Strip``, ``Sequence``; applied to each
   segment between added tokens;
3. pre-tokenizers: ``Metaspace`` (``prepend_scheme`` always / first / never,
   ``split``), ``Split`` (every behavior, ``invert``), ``ByteLevel``
   (``add_prefix_space``, ``use_regex``), ``Digits``, ``Punctuation``,
   ``Whitespace``, ``WhitespaceSplit``, ``Sequence``; Oniguruma patterns go
   through ``llm/unicode_re.py``;
4. models: ``BPE`` (``byte_fallback``, ``fuse_unk``, ``unk_token``,
   ``ignore_merges``, merges as strings or pairs) merged by a heap, lowest
   rank then leftmost, in C++ (``native/bpe_heap.cc``, g++-built into
   ``build/native/<hash>/`` at first use) or, with ``engine="python"``, the
   same heap in Python; ``Unigram`` (Viterbi over the scored pieces, with
   ``byte_fallback`` and ``unk_id``);
5. post-processors: ``TemplateProcessing``, ``ByteLevel``, ``Sequence``;
6. decoders: ``Replace``, ``ByteFallback``, ``Fuse``, ``Strip``,
   ``Metaspace``, ``ByteLevel``, ``Sequence``.

``tokenizer_config.json`` adds what ``transformers`` adds on top: the special
tokens it names (with the class defaults of ``LlamaTokenizerFast``,
``GemmaTokenizerFast`` and ``Qwen2TokenizerFast``), the BOS / EOS template of
the Llama and Gemma classes (``add_bos_token`` / ``add_eos_token``, as
``update_post_processor`` builds it) and ``clean_up_tokenization_spaces``.
Without a ``tokenizer_class`` the class follows ``config.json``'s
``model_type`` as ``AutoTokenizer`` maps it.

The interface is the one the call sites use of ``AutoTokenizer``:
``__call__(text, add_special_tokens=True)["input_ids"]``, ``encode``,
``decode(ids, skip_special_tokens=False)``, ``bos_token_id``,
``eos_token_id``, ``all_special_ids`` and ``vocab_size``.

WordPiece and WordLevel models and the ``Precompiled`` normalizer (T5's
``nmt_nfkc`` charsmap) raise ``ValueError`` naming ROADMAP.md A.10g; any other
unknown node raises ``ValueError`` naming its type. A native engine that fails
to build raises; it never becomes the Python heap on its own.
"""

from __future__ import annotations

import ctypes
import functools
import heapq
import json
import os
import re
import threading
import unicodedata
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ssp_x_vit_tpu_torch.data import native_loader
from ssp_x_vit_tpu_torch.llm import tokenizer as _native
from ssp_x_vit_tpu_torch.llm.unicode_re import class_body, compile_onig, ranges

HEAP_SOURCE = Path(__file__).resolve().parents[2] / "native" / "bpe_heap.cc"
A10G = "not ported (ROADMAP.md A.10g)"
# cache merged words up to this length (HF caches words shorter than 256 bytes)
_CACHE_WORD = 256
_CACHE_SIZE = 1 << 17

Piece = Tuple[str, bool]        # (text, starts at offset 0 of the original text)

_heap_lock = threading.Lock()
_heap_lib = None


def heap_library() -> ctypes.CDLL:
    """The heap merge engine with its C signatures declared; built at first use."""
    global _heap_lib
    with _heap_lock:
        if _heap_lib is None:
            lib = ctypes.CDLL(str(native_loader.build_library(HEAP_SOURCE,
                                                               "libssp_bpe_heap.so")))
            lib.bpe_heap_init.restype = ctypes.c_void_p
            lib.bpe_heap_init.argtypes = [ctypes.c_int64] + [ctypes.c_void_p] * 4
            lib.bpe_heap_free.argtypes = [ctypes.c_void_p]
            lib.bpe_heap_encode_batch.restype = ctypes.c_int64
            lib.bpe_heap_encode_batch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                                  ctypes.c_void_p, ctypes.c_int64,
                                                  ctypes.c_void_p, ctypes.c_void_p]
            _heap_lib = lib
        return _heap_lib


_WS = frozenset(chr(c) for lo, hi in ranges("s") for c in range(lo, hi + 1))


@functools.lru_cache(maxsize=1)
def _rust_word() -> str:
    """Rust's Unicode ``\\w`` (``regex_syntax::is_word_character``) as a class
    body: Alphabetic, marks, decimal digits, connector punctuation, the
    joiners; Alphabetic's So letters (circled and squared Latin) spelled out."""
    return class_body(tuple(sorted(
        list(ranges("L")) + list(ranges("Nl")) + list(ranges("M")) + list(ranges("Nd"))
        + list(ranges("Pc")) + [(0x200C, 0x200D), (0x24B6, 0x24E9), (0x1F130, 0x1F149),
                                (0x1F150, 0x1F169), (0x1F170, 0x1F189)])))


@functools.lru_cache(maxsize=1)
def _rust_word_char() -> "re.Pattern":
    return re.compile(f"[{_rust_word()}]")


def _is_word_char(c: str) -> bool:
    return bool(_rust_word_char().match(c))


# ---------------------------------------------------------------- merges


class HeapMerger:
    """(left id, right id) -> (rank, merged id), merged by a heap: lowest rank
    first, then the leftmost position (HF ``Word::merge_all``)."""

    def __init__(self, left, right, rank, merged, engine: str = "native"):
        if engine not in ("native", "python"):
            raise ValueError(f"engine must be 'native' or 'python', got {engine!r}")
        self.engine = engine
        self.native_batches = 0
        self._left = np.asarray(left, np.int32)
        self._right = np.asarray(right, np.int32)
        self._rank = np.asarray(rank, np.int32)
        self._merged = np.asarray(merged, np.int32)
        self._map = {(int(a), int(b)): (int(r), int(m))
                     for a, b, r, m in zip(left, right, rank, merged)}
        self._handle = None
        if engine == "native" and len(self._left):
            self._handle = ctypes.c_void_p(heap_library().bpe_heap_init(
                len(self._left), self._left.ctypes.data, self._right.ctypes.data,
                self._rank.ctypes.data, self._merged.ctypes.data))

    def merge_py(self, syms: Sequence[int]) -> List[int]:
        """The plain Python heap merge of one word."""
        n = len(syms)
        ids = list(syms)
        prev = list(range(-1, n - 1))
        nxt = list(range(1, n + 1))
        if n:
            nxt[-1] = -1
        removed = [False] * n
        get = self._map.get
        heap = []
        for i in range(n - 1):
            m = get((ids[i], ids[i + 1]))
            if m is not None:
                heap.append((m[0], i, m[1]))
        heapq.heapify(heap)
        while heap:
            _, pos, new = heapq.heappop(heap)
            right = nxt[pos]
            if removed[pos] or right < 0:
                continue
            m = get((ids[pos], ids[right]))
            if m is None or m[1] != new:      # stale: the pair changed since it was pushed
                continue
            ids[pos] = new
            removed[right] = True
            nxt[pos] = nxt[right]
            if nxt[pos] >= 0:
                prev[nxt[pos]] = pos
            p = prev[pos]
            if p >= 0:
                m = get((ids[p], new))
                if m is not None:
                    heapq.heappush(heap, (m[0], p, m[1]))
            if nxt[pos] >= 0:
                m = get((new, ids[nxt[pos]]))
                if m is not None:
                    heapq.heappush(heap, (m[0], pos, m[1]))
        return [ids[i] for i in range(n) if not removed[i]]

    def merge_batch(self, words: List[List[int]]) -> List[List[int]]:
        if self.engine == "python":
            return [self.merge_py(w) for w in words]
        if self._handle is None:        # no merges
            return [list(w) for w in words]
        flat = np.fromiter((s for w in words for s in w), np.int32,
                           count=sum(len(w) for w in words))
        offs = np.zeros(len(words) + 1, np.int64)
        np.cumsum([len(w) for w in words], out=offs[1:])
        out = np.empty_like(flat)
        out_offs = np.empty(len(words) + 1, np.int64)
        heap_library().bpe_heap_encode_batch(self._handle, flat.ctypes.data, offs.ctypes.data,
                                             len(words), out.ctypes.data, out_offs.ctypes.data)
        self.native_batches += 1
        return [out[out_offs[i]:out_offs[i + 1]].tolist() for i in range(len(words))]

    def __del__(self):
        if _heap_lib is not None and getattr(self, "_handle", None):
            _heap_lib.bpe_heap_free(self._handle)


# ---------------------------------------------------------------- models


def _byte_piece(b: int) -> str:
    return f"<0x{b:02X}>"


class BPEModel:
    """HF ``models.BPE``: characters (or their ``<0xXX>`` bytes, or ``unk``)
    merged by rank."""

    def __init__(self, vocab: Dict[str, int], merger: HeapMerger, *,
                 unk_token: Optional[str] = None, fuse_unk: bool = False,
                 byte_fallback: bool = False, ignore_merges: bool = False):
        self.vocab = dict(vocab)
        self.id_to_token = {i: t for t, i in self.vocab.items()}
        self.merger = merger
        self.unk_token = unk_token
        self.fuse_unk = fuse_unk
        self.byte_fallback = byte_fallback
        self.ignore_merges = ignore_merges
        self._cache: Dict[str, List[int]] = {}

    @classmethod
    def from_node(cls, node: dict, engine: str = "native") -> "BPEModel":
        """The ``model`` node of a ``tokenizer.json`` (merges ranked by position)."""
        if node.get("dropout") not in (None, 0, 0.0):
            raise ValueError("BPE dropout samples its merges; only dropout 0 / null is ported")
        for key in ("continuing_subword_prefix", "end_of_word_suffix"):
            if node.get(key):
                raise ValueError(f"BPE {key} (no family of the port uses one) is not ported")
        vocab = node["vocab"]
        left, right, rank, merged = [], [], [], []
        for i, m in enumerate(node.get("merges", [])):
            a, b = m.split(" ", 1) if isinstance(m, str) else m
            la, lb, lm = vocab.get(a), vocab.get(b), vocab.get(a + b)
            if la is None or lb is None or lm is None:
                raise ValueError(f"merge ({a!r}, {b!r}) not closed under the vocabulary")
            left.append(la)
            right.append(lb)
            rank.append(i)
            merged.append(lm)
        return cls(vocab, HeapMerger(left, right, rank, merged, engine),
                   unk_token=node.get("unk_token"), fuse_unk=bool(node.get("fuse_unk", False)),
                   byte_fallback=bool(node.get("byte_fallback", False)),
                   ignore_merges=bool(node.get("ignore_merges", False)))

    @property
    def size(self) -> int:
        return len(self.vocab)

    def initial_symbols(self, word: str) -> List[int]:
        """The word's symbols before any merge (HF ``BPE::merge_word``)."""
        vocab = self.vocab
        ids = [vocab.get(c) for c in word]
        if None not in ids:
            return ids
        out: List[int] = []
        unk: Optional[int] = None
        for s in word:
            i = vocab.get(s)
            if i is not None:
                if unk is not None:
                    out.append(unk)
                    unk = None
                out.append(i)
                continue
            if self.byte_fallback:
                bs = [vocab.get(_byte_piece(b)) for b in s.encode("utf-8")]
                if None not in bs:
                    out.extend(bs)
                    continue
            if self.unk_token is not None:
                uid = vocab.get(self.unk_token)
                if uid is None:
                    raise ValueError(f"unk_token {self.unk_token!r} is not in the vocabulary")
                if unk is None or not self.fuse_unk:
                    if unk is not None:
                        out.append(unk)
                    unk = uid
        if unk is not None:
            out.append(unk)
        return out

    def tokenize(self, words: List[str]) -> List[List[int]]:
        out: List[Optional[List[int]]] = [None] * len(words)
        todo: Dict[str, List[int]] = {}
        for k, w in enumerate(words):
            if self.ignore_merges and w in self.vocab:
                out[k] = [self.vocab[w]]
                continue
            hit = self._cache.get(w)
            if hit is not None:
                out[k] = hit
            else:
                todo.setdefault(w, []).append(k)
        if todo:
            ws = list(todo)
            merged = self.merger.merge_batch([self.initial_symbols(w) for w in ws])
            if len(self._cache) > _CACHE_SIZE:
                self._cache.clear()
            for w, ids in zip(ws, merged):
                if len(w) < _CACHE_WORD:
                    self._cache[w] = ids
                for k in todo[w]:
                    out[k] = ids
        return out


class UnigramModel:
    """HF ``models.Unigram`` (``encode_optimized``: Viterbi over the pieces
    with ``min score - 10`` for an unknown character, consecutive unknowns
    fused, then ``byte_fallback`` or ``unk_id``). ``matchable`` limits the
    lattice to some pieces (SentencePiece's normal ones)."""

    UNK_PENALTY = 10.0

    def __init__(self, pieces: Sequence[Tuple[str, float]], unk_id: Optional[int],
                 byte_fallback: bool = False, matchable: Optional[Sequence[int]] = None):
        self.pieces = [(p, float(s)) for p, s in pieces]
        self.vocab = {p: i for i, (p, _) in enumerate(self.pieces)}
        self.id_to_token = {i: p for i, (p, _) in enumerate(self.pieces)}
        self.unk_id = unk_id
        self.byte_fallback = byte_fallback
        ids = range(len(self.pieces)) if matchable is None else matchable
        self._trie = {self.pieces[i][0]: (self.vocab[self.pieces[i][0]],
                                          self.pieces[self.vocab[self.pieces[i][0]]][1])
                      for i in ids if self.pieces[i][0]}
        self._prefixes = {p[:k] for p in self._trie for k in range(1, len(p) + 1)}
        self._min_score = min((self.pieces[i][1] for i in ids), default=0.0)
        self._cache: Dict[str, List[int]] = {}

    @property
    def size(self) -> int:
        return len(self.pieces)

    def _viterbi(self, s: str) -> List[str]:
        n = len(s)
        score = [0.0] * (n + 1)
        start = [-1] * (n + 1)
        node = [0] * (n + 1)
        unk_score = self._min_score - self.UNK_PENALTY
        trie, prefixes = self._trie, self._prefixes
        for st in range(n):
            base = score[st]
            single = False
            end = st + 1
            while end <= n:
                sub = s[st:end]
                if sub not in prefixes:
                    break
                hit = trie.get(sub)
                if hit is not None:
                    cand = hit[1] + base
                    if start[end] < 0 or cand > score[end]:
                        score[end], start[end], node[end] = cand, st, hit[0]
                    if end == st + 1:
                        single = True
                end += 1
            if not single:
                if self.unk_id is None:
                    raise ValueError("the Unigram model has no unk_id for an unknown character")
                cand = unk_score + base
                if start[st + 1] < 0 or cand > score[st + 1]:
                    score[st + 1], start[st + 1], node[st + 1] = cand, st, self.unk_id
        out: List[str] = []
        fused: List[str] = []
        end = n
        while end > 0:
            st = start[end]
            if self.unk_id is not None and node[end] == self.unk_id:
                fused.append(s[st:end])
            else:
                if fused:
                    out.append("".join(reversed(fused)))
                    fused = []
                out.append(s[st:end])
            end = st
        if fused:
            out.append("".join(reversed(fused)))
        out.reverse()
        return out

    def _word(self, w: str) -> List[int]:
        ids: List[int] = []
        for piece in self._viterbi(w):
            i = self.vocab.get(piece)
            if i is None:
                if self.byte_fallback:
                    bs = [self.vocab.get(_byte_piece(b)) for b in piece.encode("utf-8")]
                    if None not in bs:
                        ids.extend(bs)
                        continue
                if self.unk_id is None:
                    raise ValueError("the Unigram model has no unk_id")
                i = self.unk_id
            ids.append(i)
        return ids

    def tokenize(self, words: List[str]) -> List[List[int]]:
        out = []
        for w in words:
            hit = self._cache.get(w)
            if hit is None:
                hit = self._word(w)
                if len(w) < _CACHE_WORD and len(self._cache) < _CACHE_SIZE:
                    self._cache[w] = hit
            out.append(hit)
        return out


def _model(node: dict, engine: str):
    kind = node.get("type")
    if kind == "BPE" or (kind is None and "merges" in node):
        return BPEModel.from_node(node, engine)
    if kind == "Unigram":
        return UnigramModel(node["vocab"], node.get("unk_id"), bool(node.get("byte_fallback")))
    if kind in ("WordPiece", "WordLevel"):
        raise ValueError(f"the {kind} model is {A10G}")
    raise ValueError(f"unsupported tokenizer model {kind!r}")


# ---------------------------------------------------------------- patterns


def _pattern(node) -> "re.Pattern":
    """A ``{"String": s}`` or ``{"Regex": r}`` pattern node as compiled ``re``."""
    if "String" in node:
        return re.compile(re.escape(node["String"]))
    if "Regex" in node:
        return compile_onig(node["Regex"])
    raise ValueError(f"unsupported pattern {node!r}")


def _regex_spans(pat: "re.Pattern", text: str) -> List[Tuple[int, int, bool]]:
    """(start, end, is_match) covering ``text`` (HF ``Pattern::find_matches``)."""
    if not text:
        return [(0, 0, False)]
    out, prev = [], 0
    for m in pat.finditer(text):
        s, e = m.span()
        if prev != s:
            out.append((prev, s, False))
        out.append((s, e, True))
        prev = e
    if prev != len(text):
        out.append((prev, len(text), False))
    return out


def _char_spans(pred: Callable[[str], bool], text: str) -> List[Tuple[int, int, bool]]:
    """Every character for which ``pred`` holds is a match of its own."""
    if not text:
        return [(0, 0, False)]
    out, last = [], 0
    for i, c in enumerate(text):
        if pred(c):
            if last < i:
                out.append((last, i, False))
            out.append((i, i + 1, True))
            last = i + 1
    if last < len(text):
        out.append((last, len(text), False))
    return out


def _split(piece: Piece, spans, behavior: str) -> List[Piece]:
    """HF ``NormalizedString::split`` with a ``SplitDelimiterBehavior``."""
    text, origin = piece
    if behavior == "Isolated":
        kept = [(s, e, False) for s, e, _ in spans]
    elif behavior == "Removed":
        kept = spans
    elif behavior in ("Contiguous", "MergedWithPrevious"):
        kept, prev = [], False
        for s, e, m in spans:
            join = m == prev if behavior == "Contiguous" else (m and not prev)
            if join and kept:
                kept[-1] = (kept[-1][0], e, False)
            else:
                kept.append((s, e, False))
            prev = m
    elif behavior == "MergedWithNext":
        kept, prev = [], False
        for s, e, m in reversed(spans):
            if m and not prev and kept:
                kept[-1] = (s, kept[-1][1], False)
            else:
                kept.append((s, e, False))
            prev = m
        kept.reverse()
    else:
        raise ValueError(f"unsupported split behavior {behavior!r}")
    return [(text[s:e], origin and s == 0) for s, e, remove in kept if not remove and e > s]


# ---------------------------------------------------------------- normalizers


def _lowercase(s: str) -> str:
    # per character, as Rust's char::to_lowercase: no final-sigma rule
    return s.lower() if "Σ" not in s else "".join(c.lower() for c in s)


def _normalizer(node) -> Optional[Callable[[str], str]]:
    if node is None:
        return None
    kind = node.get("type")
    if kind == "Sequence":
        steps = [f for f in (_normalizer(n) for n in node["normalizers"]) if f is not None]

        def seq(s: str) -> str:
            for f in steps:
                s = f(s)
            return s
        return seq
    if kind == "Prepend":
        pre = node["prepend"]
        return lambda s: pre + s if s else s
    if kind == "Replace":
        pat, content = _pattern(node["pattern"]), node["content"]
        return lambda s: pat.sub(lambda _: content, s)
    if kind in ("NFC", "NFD", "NFKC", "NFKD"):
        return lambda s: unicodedata.normalize(kind, s)
    if kind == "Lowercase":
        return _lowercase
    if kind == "Strip":
        left, right = node.get("strip_left", True), node.get("strip_right", True)

        def strip(s: str) -> str:
            i, j = 0, len(s)
            while left and i < j and s[i] in _WS:
                i += 1
            while right and j > i and s[j - 1] in _WS:
                j -= 1
            return s[i:j]
        return strip
    if kind == "Precompiled":
        raise ValueError(f"the Precompiled normalizer (a SentencePiece charsmap) is {A10G}")
    raise ValueError(f"unsupported normalizer {kind!r}")


# ---------------------------------------------------------------- pre-tokenizers


def _metaspace_scheme(node) -> str:
    scheme = node.get("prepend_scheme")
    if scheme is None:
        scheme = "always" if node.get("add_prefix_space", True) else "never"
    if scheme not in ("always", "first", "never"):
        raise ValueError(f"unsupported Metaspace prepend_scheme {scheme!r}")
    return scheme


def _pre_tokenizer(node) -> Optional[Callable[[List[Piece]], List[Piece]]]:
    if node is None:
        return None
    kind = node.get("type")
    if kind == "Sequence":
        steps = [f for f in (_pre_tokenizer(n) for n in node["pretokenizers"]) if f is not None]

        def seq(pieces):
            for f in steps:
                pieces = f(pieces)
            return pieces
        return seq
    if kind == "Metaspace":
        rep = node.get("replacement", "▁")
        scheme, split = _metaspace_scheme(node), node.get("split", True)

        def metaspace(pieces):
            out = []
            for text, origin in pieces:
                t = text.replace(" ", rep)
                if (scheme == "always" or (scheme == "first" and origin)) \
                        and not t.startswith(rep):
                    t = rep + t
                if split:
                    out += _split((t, origin), _char_spans(lambda c: c == rep, t),
                                  "MergedWithNext")
                elif t:
                    out.append((t, origin))
            return out
        return metaspace
    if kind == "Split":
        pat, behavior, invert = _pattern(node["pattern"]), node["behavior"], node.get(
            "invert", False)

        def split(pieces):
            out = []
            for p in pieces:
                spans = _regex_spans(pat, p[0])
                if invert:
                    spans = [(s, e, not m) for s, e, m in spans]
                out += _split(p, spans, behavior)
            return out
        return split
    if kind == "ByteLevel":
        add_prefix, use_regex = node.get("add_prefix_space", True), node.get("use_regex", True)
        alphabet = _native.bytes_to_unicode()
        pat = _native.gpt2_pattern() if use_regex else None

        def byte_level(pieces):
            out = []
            for text, origin in pieces:
                if add_prefix and not text.startswith(" "):
                    text = " " + text
                parts = ([(t, origin and k == 0) for k, t in enumerate(pat.findall(text))]
                         if pat is not None else [(text, origin)])
                out += [("".join(alphabet[b] for b in t.encode("utf-8")), o)
                        for t, o in parts if t]
            return out
        return byte_level
    if kind == "Digits":
        behavior = "Isolated" if node.get("individual_digits", False) else "Contiguous"

        def digits(pieces):
            out = []
            for p in pieces:
                out += _split(p, _char_spans(
                    lambda c: unicodedata.category(c)[0] == "N", p[0]), behavior)
            return out
        return digits
    if kind == "Punctuation":
        behavior = node.get("behavior", "Isolated")

        def is_punc(c: str) -> bool:
            return (c.isascii() and not c.isalnum() and c.isprintable() and c != " ") or \
                unicodedata.category(c)[0] == "P"

        def punctuation(pieces):
            out = []
            for p in pieces:
                out += _split(p, _char_spans(is_punc, p[0]), behavior)
            return out
        return punctuation
    if kind == "Whitespace":
        word = _rust_word()
        pat = re.compile(rf"[{word}]+|[^{word}{class_body(ranges('s'))}]+")

        def whitespace(pieces):
            out = []
            for p in pieces:
                out += _split(p, [(s, e, not m) for s, e, m in _regex_spans(pat, p[0])],
                              "Removed")
            return out
        return whitespace
    if kind == "WhitespaceSplit":
        def whitespace_split(pieces):
            out = []
            for p in pieces:
                out += _split(p, _char_spans(lambda c: c in _WS, p[0]), "Removed")
            return out
        return whitespace_split
    raise ValueError(f"unsupported pre-tokenizer {kind!r}")


# ---------------------------------------------------------------- post-processors


def _post_processor(node) -> Callable[[List[int], bool], List[int]]:
    """(ids, add_special_tokens) -> ids for a single sequence."""
    if node is None:
        return lambda ids, add: ids
    kind = node.get("type")
    if kind == "Sequence":
        steps = [_post_processor(n) for n in node["processors"]]

        def seq(ids, add):
            for f in steps:
                ids = f(ids, add)
            return ids
        return seq
    if kind == "ByteLevel":
        return lambda ids, add: ids
    if kind == "TemplateProcessing":
        specials = {k: [int(i) for i in v["ids"]] for k, v in node["special_tokens"].items()}
        single = node["single"]

        def template(ids, add):
            out: List[int] = []
            for piece in single:
                if "Sequence" in piece:
                    if piece["Sequence"]["id"] != "A":
                        raise ValueError("a single-sequence template names sequence B")
                    out += ids
                elif add:
                    out += specials[piece["SpecialToken"]["id"]]
            return out
        return template
    raise ValueError(f"unsupported post-processor {kind!r}")


# ---------------------------------------------------------------- decoders


def _byte_value(token: str) -> Optional[int]:
    """The byte of a ``<0xXX>`` token (Rust's ``u8::from_str_radix`` on its two
    characters: a leading ``+`` is accepted), else None."""
    if len(token.encode("utf-8")) != 6 or not token.startswith("<0x") or not token.endswith(">"):
        return None
    digits = token[3:5]
    body = digits[1:] if digits.startswith("+") else digits
    if not body or not all(c in "0123456789abcdefABCDEF" for c in body):
        return None
    return int(body, 16)


def _decoder(node) -> Optional[Callable[[List[str]], List[str]]]:
    if node is None:
        return None
    kind = node.get("type")
    if kind == "Sequence":
        steps = [_decoder(n) for n in node["decoders"]]

        def seq(tokens):
            for f in steps:
                tokens = f(tokens)
            return tokens
        return seq
    if kind == "Replace":
        pat, content = _pattern(node["pattern"]), node["content"]
        return lambda tokens: [pat.sub(lambda _: content, t) for t in tokens]
    if kind == "ByteFallback":
        def byte_fallback(tokens):
            out, pending = [], []

            def flush():
                try:
                    out.append(bytes(pending).decode("utf-8"))
                except UnicodeDecodeError:
                    out.extend("�" for _ in pending)
                pending.clear()
            for t in tokens:
                b = _byte_value(t)
                if b is not None:
                    pending.append(b)
                    continue
                if pending:
                    flush()
                out.append(t)
            if pending:
                flush()
            return out
        return byte_fallback
    if kind == "Fuse":
        return lambda tokens: ["".join(tokens)]
    if kind == "Strip":
        content, start, stop = node["content"], int(node["start"]), int(node["stop"])

        def strip(tokens):
            out = []
            for t in tokens:
                i = 0
                while i < min(start, len(t)) and t[i] == content:
                    i += 1
                j = len(t)
                while len(t) - j < stop and j > i and t[j - 1] == content:
                    j -= 1
                out.append(t[i:j])
            return out
        return strip
    if kind == "Metaspace":
        rep, scheme = node.get("replacement", "▁"), _metaspace_scheme(node)

        def metaspace(tokens):
            out = []
            for i, t in enumerate(tokens):
                t = t.replace(rep, " ")
                if i == 0 and scheme != "never" and t.startswith(" "):
                    t = t[1:]
                out.append(t)
            return out
        return metaspace
    if kind == "ByteLevel":
        inv = {c: b for b, c in _native.bytes_to_unicode().items()}

        def byte_level(tokens):
            data = bytearray()
            for t in tokens:
                bs = [inv.get(c) for c in t]
                data += bytes(bs) if None not in bs else t.encode("utf-8")
            return [data.decode("utf-8", errors="replace")]
        return byte_level
    raise ValueError(f"unsupported decoder {kind!r}")


def clean_up_tokenization(s: str) -> str:
    """``PreTrainedTokenizerBase.clean_up_tokenization``."""
    return (s.replace(" .", ".").replace(" ?", "?").replace(" !", "!").replace(" ,", ",")
            .replace(" ' ", "'").replace(" n't", "n't").replace(" 'm", "'m")
            .replace(" 's", "'s").replace(" 've", "'ve").replace(" 're", "'re"))


# ---------------------------------------------------------------- the tokenizer

# transformers' class defaults: (special tokens, whether update_post_processor
# rebuilds the template from add_bos_token / add_eos_token)
_CLASS_DEFAULTS = {
    "llama": (dict(unk_token="<unk>", bos_token="<s>", eos_token="</s>"), True),
    "gemma": (dict(unk_token="<unk>", bos_token="<bos>", eos_token="<eos>", pad_token="<pad>"),
              True),
    "qwen2": (dict(unk_token="<|endoftext|>", bos_token=None, eos_token="<|endoftext|>",
                   pad_token="<|endoftext|>"), False),
    "generic": ({}, False),
}
_CLASS_FAMILY = {"LlamaTokenizer": "llama", "CodeLlamaTokenizer": "llama",
                 "GemmaTokenizer": "gemma", "Qwen2Tokenizer": "qwen2"}
# AutoTokenizer's model_type -> class, where tokenizer_config.json names none
_MODEL_TYPE_FAMILY = {"llama": "llama", "mistral": "llama", "mixtral": "llama", "phi3": "llama",
                      "deepseek_v3": "llama", "gemma": "gemma", "gemma2": "gemma",
                      "qwen2": "qwen2", "qwen3": "qwen2", "qwen3_moe": "qwen2"}
SPECIAL_ATTRIBUTES = ("bos_token", "eos_token", "unk_token", "sep_token", "pad_token",
                      "cls_token", "mask_token")


def _content(value) -> Optional[str]:
    if isinstance(value, dict):
        return value.get("content")
    return value


def family_of(config: dict, model_type: Optional[str] = None) -> str:
    """Which transformers class family a directory's tokenizer loads as."""
    cls = config.get("tokenizer_class")
    if cls:
        return _CLASS_FAMILY.get(cls[:-4] if cls.endswith("Fast") else cls, "generic")
    return _MODEL_TYPE_FAMILY.get(model_type or "", "generic")


class HFTokenizer:
    """A ``tokenizer.json`` pipeline with the ``tokenizer_config.json`` layer
    of ``transformers`` (see the module docstring)."""

    def __init__(self, spec: dict, config: Optional[dict] = None, *, engine: str = "native",
                 model_type: Optional[str] = None, model=None,
                 normalizer: Optional[Callable[[str], str]] = None):
        """``spec`` is a parsed ``tokenizer.json``; ``model`` / ``normalizer``
        replace its ``model`` / ``normalizer`` nodes (``llm/spm_model.py``)."""
        config = dict(config or {})
        self.family = family_of(config, model_type)
        defaults, rebuilds_template = _CLASS_DEFAULTS[self.family]
        self.model = model if model is not None else _model(spec["model"], engine)
        self._normalize = normalizer if normalizer is not None else _normalizer(
            spec.get("normalizer"))
        pre = spec.get("pre_tokenizer")
        if pre is not None and pre.get("type") == "ByteLevel" and \
                bool(pre.get("add_prefix_space", True)) != bool(config.get("add_prefix_space",
                                                                            False)):
            # PreTrainedTokenizerFast resets a ByteLevel pre-tokenizer's flag to the config's
            pre = dict(pre, add_prefix_space=bool(config.get("add_prefix_space", False)))
        self._pre_tokenize = _pre_tokenizer(pre)
        self._decode = _decoder(spec.get("decoder"))
        self.clean_up_tokenization_spaces = bool(config.get("clean_up_tokenization_spaces",
                                                            False))

        # added vocabulary: tokenizer.json's, then the config's special tokens
        # tokenizers gives an added token its id in the model's vocabulary, else
        # the next free one in list order: the ids written in the file are not read
        self._added: Dict[str, dict] = {}
        for t in spec.get("added_tokens") or []:
            if t["content"] and t["content"] not in self._added:
                self._added[t["content"]] = dict(t, id=self._new_id(t["content"]))
        specials = {k: _content(config[k]) if k in config else defaults.get(k)
                    for k in SPECIAL_ATTRIBUTES}
        extra = [_content(t) for t in config.get("additional_special_tokens") or []]
        self.special_tokens = {k: v for k, v in specials.items() if v is not None}
        self.additional_special_tokens = [t for t in extra if t]
        for content in list(self.special_tokens.values()) + self.additional_special_tokens:
            if content and content not in self._added:
                self._added[content] = dict(content=content, id=self._new_id(content),
                                            special=True, normalized=False, lstrip=False,
                                            rstrip=False, single_word=False)
        self._added_by_id = {int(t["id"]): c for c, t in self._added.items()}
        self._special = {c for c, t in self._added.items() if t.get("special")}
        self._raw_split = self._matcher([t for t in self._added.values()
                                         if not t.get("normalized", True)], normalize=False)
        self._normalized_split = self._matcher([t for t in self._added.values()
                                                if t.get("normalized", True)], normalize=True)

        if rebuilds_template:
            add_bos = bool(config.get("add_bos_token", True))
            add_eos = bool(config.get("add_eos_token", False))
            for flag, name in ((add_bos, "bos_token"), (add_eos, "eos_token")):
                if flag and name not in self.special_tokens:
                    raise ValueError(f"add_{name} = True but {name} = None")
            pre_ids = [self.token_to_id(self.special_tokens["bos_token"])] if add_bos else []
            post_ids = [self.token_to_id(self.special_tokens["eos_token"])] if add_eos else []
            self._post = lambda ids, add: pre_ids + ids + post_ids if add else ids
        else:
            self._post = _post_processor(spec.get("post_processor"))

    # ---------------- construction ----------------

    @classmethod
    def from_dir(cls, model_dir: str, *, engine: str = "native") -> "HFTokenizer":
        """``tokenizer.json`` of ``model_dir`` with its ``tokenizer_config.json``
        and ``config.json``'s ``model_type`` where they exist."""
        with open(os.path.join(model_dir, "tokenizer.json"), encoding="utf-8") as f:
            spec = json.load(f)
        return cls(spec, read_json(model_dir, "tokenizer_config.json"), engine=engine,
                   model_type=read_json(model_dir, "config.json").get("model_type"))

    def _new_id(self, content: str) -> int:
        if content in self.model.vocab:
            return self.model.vocab[content]
        size = self.model.size
        ids = [int(t["id"]) for t in self._added.values()]
        top = max(ids, default=-1)
        return top + 1 if ids and (top >= size or size == 0) else size

    def _matcher(self, tokens: List[dict], normalize: bool):
        """(compiled alternation, matched text -> token) of ``tokens``; the
        normalized ones match their normalized content."""
        by_text: Dict[str, dict] = {}
        for t in tokens:
            text = t["content"]
            if normalize and self._normalize is not None:
                text = self._normalize(text)
            if text:
                by_text[text] = t
        if not by_text:
            return None
        alternatives = sorted(by_text, key=len, reverse=True)
        return re.compile("|".join(re.escape(a) for a in alternatives)), by_text

    # ---------------- encode ----------------

    @staticmethod
    def _find_matches(text: str, matcher) -> List[Tuple[str, Optional[int], bool]]:
        """HF ``AddedVocabulary::find_matches``: (text, added id or None, starts
        at offset 0) pieces, empty ones dropped."""
        if matcher is None or not text:
            return [(text, None, True)] if text else []
        pat, by_text = matcher
        out, start_offset = [], 0
        for m in pat.finditer(text):
            start, stop = m.span()
            tok = by_text[m.group(0)]
            if tok.get("single_word"):
                if (start > 0 and _is_word_char(text[start - 1])) or \
                        (stop < len(text) and _is_word_char(text[stop])):
                    continue
            if tok.get("lstrip"):
                s = start
                while s > 0 and text[s - 1] in _WS:
                    s -= 1
                start = max(s, start_offset)
            if tok.get("rstrip"):
                while stop < len(text) and text[stop] in _WS:
                    stop += 1
            if start_offset < start:
                out.append((text[start_offset:start], None, start_offset == 0))
            out.append((text[start:stop], int(tok["id"]), start == 0))
            start_offset = stop
        if start_offset < len(text):
            out.append((text[start_offset:], None, start_offset == 0))
        return out

    def _segments(self, text: str) -> List[Tuple[str, Optional[int], bool]]:
        out = []
        for seg, tid, origin in self._find_matches(text, self._raw_split):
            if tid is not None:
                out.append((seg, tid, origin))
                continue
            norm = self._normalize(seg) if self._normalize is not None else seg
            for sub, sid, sub_origin in self._find_matches(norm, self._normalized_split):
                out.append((sub, sid, origin and sub_origin))
        return out

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        items: List[object] = []
        words: List[str] = []
        for seg, tid, origin in self._segments(text):
            if tid is not None:
                items.append(tid)
                continue
            pieces = [(seg, origin)]
            if self._pre_tokenize is not None:
                pieces = self._pre_tokenize(pieces)
            items.append((len(words), len(words) + len(pieces)))
            words += [p for p, _ in pieces]
        merged = self.model.tokenize(words) if words else []
        ids: List[int] = []
        for item in items:
            if isinstance(item, int):
                ids.append(item)
            else:
                for w in merged[item[0]:item[1]]:
                    ids += w
        return self._post(ids, add_special_tokens)

    def __call__(self, text: str, add_special_tokens: bool = True) -> dict:
        return {"input_ids": self.encode(text, add_special_tokens=add_special_tokens)}

    # ---------------- decode ----------------

    def id_to_token(self, i: int) -> Optional[str]:
        tok = self._added_by_id.get(i)
        return tok if tok is not None else self.model.id_to_token.get(i)

    def token_to_id(self, token: str) -> Optional[int]:
        t = self._added.get(token)
        return int(t["id"]) if t is not None else self.model.vocab.get(token)

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = False) -> str:
        """Text of ``ids``; ids in neither vocabulary are dropped."""
        tokens = []
        for i in ids:
            tok = self.id_to_token(int(i))
            if tok is None or (skip_special_tokens and tok in self._special):
                continue
            tokens.append(tok)
        text = "".join(self._decode(tokens)) if self._decode is not None else " ".join(tokens)
        return clean_up_tokenization(text) if self.clean_up_tokenization_spaces else text

    # ---------------- special tokens ----------------

    def _special_id(self, name: str) -> Optional[int]:
        tok = self.special_tokens.get(name)
        if tok is None:
            return None
        i = self.token_to_id(tok)
        return i if i is not None else self._special_id("unk_token") if name != "unk_token" \
            else None

    @property
    def bos_token_id(self) -> Optional[int]:
        return self._special_id("bos_token")

    @property
    def eos_token_id(self) -> Optional[int]:
        return self._special_id("eos_token")

    @property
    def unk_token_id(self) -> Optional[int]:
        return self._special_id("unk_token")

    @property
    def all_special_ids(self) -> List[int]:
        seen, out = set(), []
        for tok in [self.special_tokens[k] for k in SPECIAL_ATTRIBUTES
                    if k in self.special_tokens] + self.additional_special_tokens:
            if tok not in seen:
                seen.add(tok)
                i = self.token_to_id(tok)
                out.append(i if i is not None else self.unk_token_id)
        return out

    @property
    def vocab_size(self) -> int:
        return self.model.size


def read_json(model_dir: str, name: str) -> dict:
    path = os.path.join(model_dir, name)
    if not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as f:
        return json.load(f)
