"""SentencePiece ``tokenizer.model`` files, read without ``sentencepiece`` or protobuf.

A model directory that has no ``tokenizer.json`` may still hold the
SentencePiece model it was trained with (Llama-2, Mistral and Gemma ship
one). ``parse_model_proto`` reads its ``ModelProto`` from the protobuf wire
format by hand, as ``llm/arrow_ipc.py`` reads flatbuffers:

- ``pieces`` (field 1): piece (1), score (2, float), type (3: NORMAL 1,
  UNKNOWN 2, CONTROL 3, USER_DEFINED 4, UNUSED 5, BYTE 6);
- ``trainer_spec`` (2): model_type (3: UNIGRAM 1, BPE 2), byte_fallback
  (35), unk_id / bos_id / eos_id / pad_id (40-43),
  treat_whitespace_as_suffix (24);
- ``normalizer_spec`` (3): name (1), precompiled_charsmap (2),
  add_dummy_prefix (3), remove_extra_whitespaces (4), escape_whitespaces (5);

with protobuf's defaults for absent fields. ``load_spm_tokenizer`` builds
from it the ``llm/hf_tokenizer.py`` pipeline that ``transformers``'
``LlamaConverter`` writes for such a file: UNKNOWN and CONTROL pieces are
special added tokens, USER_DEFINED ones plain added tokens; each segment
between them is normalized as SentencePiece does (extra spaces removed, the
dummy prefix, spaces escaped as ``▁``) and encoded as SentencePiece does:

- BPE: repeatedly merge the adjacent pair whose concatenation is the
  highest-scored piece, the leftmost first, then unknown characters as
  ``<0xXX>`` pieces (``byte_fallback``) or one ``unk`` a run; this runs on the
  heap merge of ``llm/hf_tokenizer.py`` with each piece's score order as its
  rank (equal scores share a rank, so the position breaks the tie);
- Unigram: Viterbi over the normal pieces, an unknown character scoring the
  lowest piece score less 10.

Decoding is the converter's: ``▁`` to a space, ``<0xXX>`` runs to bytes, the
dummy prefix's space stripped. A non-empty ``precompiled_charsmap`` (an
``nmt_nfkc``-style normalization) raises ``ValueError`` naming ROADMAP.md
A.10g; so do WORD and CHAR models and whitespace as a suffix.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Tuple

from ssp_x_vit_tpu_torch.llm.hf_tokenizer import (
    A10G, BPEModel, HeapMerger, HFTokenizer, UnigramModel, read_json,
)

NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6
UNIGRAM, BPE = 1, 2
SPACE = "▁"

_TRAINER_DEFAULTS = {"model_type": UNIGRAM, "byte_fallback": False, "unk_id": 0, "bos_id": 1,
                     "eos_id": 2, "pad_id": -1, "treat_whitespace_as_suffix": False}
_TRAINER_FIELDS = {3: "model_type", 35: "byte_fallback", 40: "unk_id", 41: "bos_id",
                   42: "eos_id", 43: "pad_id", 24: "treat_whitespace_as_suffix"}
_NORMALIZER_DEFAULTS = {"name": "", "precompiled_charsmap": b"", "add_dummy_prefix": True,
                        "remove_extra_whitespaces": True, "escape_whitespaces": True}
_NORMALIZER_FIELDS = {1: "name", 2: "precompiled_charsmap", 3: "add_dummy_prefix",
                      4: "remove_extra_whitespaces", 5: "escape_whitespaces"}


def _varint(buf: bytes, i: int) -> Tuple[int, int]:
    out, shift = 0, 0
    while True:
        if i >= len(buf):
            raise ValueError("truncated varint in tokenizer.model")
        b = buf[i]
        out |= (b & 0x7F) << shift
        i += 1
        if not b & 0x80:
            return out, i
        shift += 7


def _fields(buf: bytes):
    """(field number, wire type, value) of a message: varints as int, 32- and
    64-bit fields as their raw bytes, length-delimited ones as bytes."""
    i = 0
    while i < len(buf):
        key, i = _varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, i = _varint(buf, i)
        elif wire == 1:
            value, i = buf[i:i + 8], i + 8
        elif wire == 2:
            n, i = _varint(buf, i)
            value, i = buf[i:i + n], i + n
        elif wire == 5:
            value, i = buf[i:i + 4], i + 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire} in tokenizer.model")
        if i > len(buf):
            raise ValueError("truncated field in tokenizer.model")
        yield field, wire, value


def _int32(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


def _message(buf: bytes, names: Dict[int, str], defaults: dict) -> dict:
    out = dict(defaults)
    for field, wire, value in _fields(buf):
        name = names.get(field)
        if name is None:
            continue
        if wire == 0:
            out[name] = bool(value) if isinstance(defaults[name], bool) else _int32(value)
        elif wire == 2:
            out[name] = value.decode("utf-8") if isinstance(defaults[name], str) else bytes(value)
    return out


def parse_model_proto(data: bytes) -> dict:
    """``{"pieces": [(piece, score, type)], "trainer_spec": {...},
    "normalizer_spec": {...}}`` of a serialized SentencePiece ``ModelProto``."""
    pieces: List[Tuple[str, float, int]] = []
    trainer, normalizer = dict(_TRAINER_DEFAULTS), dict(_NORMALIZER_DEFAULTS)
    for field, wire, value in _fields(data):
        if field == 1 and wire == 2:
            piece, score, kind = "", 0.0, NORMAL
            for f, w, v in _fields(value):
                if f == 1 and w == 2:
                    piece = v.decode("utf-8")
                elif f == 2 and w == 5:
                    score = struct.unpack("<f", v)[0]
                elif f == 3 and w == 0:
                    kind = v
            pieces.append((piece, score, kind))
        elif field == 2 and wire == 2:
            trainer = _message(value, _TRAINER_FIELDS, _TRAINER_DEFAULTS)
        elif field == 3 and wire == 2:
            normalizer = _message(value, _NORMALIZER_FIELDS, _NORMALIZER_DEFAULTS)
    return {"pieces": pieces, "trainer_spec": trainer, "normalizer_spec": normalizer}


def spm_normalizer(spec: dict):
    """SentencePiece's normalization of one segment under an identity charsmap."""
    remove, dummy, escape = (spec["remove_extra_whitespaces"], spec["add_dummy_prefix"],
                             spec["escape_whitespaces"])

    def normalize(s: str) -> str:
        if remove:
            s = " ".join(p for p in s.split(" ") if p)
        if not s:
            return s
        if dummy:
            s = " " + s
        return s.replace(" ", SPACE) if escape else s
    return normalize


def _score_ranks(pieces, ids) -> Dict[int, int]:
    """Piece id -> rank of its score, highest first; equal scores share a rank."""
    order = sorted({pieces[i][1] for i in ids}, reverse=True)
    rank = {s: r for r, s in enumerate(order)}
    return {i: rank[pieces[i][1]] for i in ids}


def spm_bpe_model(proto: dict, engine: str = "native") -> BPEModel:
    """SentencePiece's BPE as a merge table: every split of a mergeable piece
    into two mergeable pieces is a pair, ranked by the whole piece's score."""
    pieces = proto["pieces"]
    mergeable = [i for i, (_, _, t) in enumerate(pieces) if t in (NORMAL, USER_DEFINED, UNUSED)]
    by_piece = {pieces[i][0]: i for i in mergeable}
    ranks = _score_ranks(pieces, mergeable)
    left, right, rank, merged = [], [], [], []
    for i in mergeable:
        p = pieces[i][0]
        for k in range(1, len(p)):
            a, b = by_piece.get(p[:k]), by_piece.get(p[k:])
            if a is not None and b is not None:
                left.append(a)
                right.append(b)
                rank.append(ranks[i])
                merged.append(i)
    vocab = {}
    for i, (p, _, t) in enumerate(pieces):      # PieceToId: reserved pieces first
        if t not in (NORMAL, USER_DEFINED, UNUSED):
            vocab.setdefault(p, i)
    for i in mergeable:
        vocab.setdefault(pieces[i][0], i)
    unk = [p for p, _, t in pieces if t == UNKNOWN]
    return BPEModel(vocab, HeapMerger(left, right, rank, merged, engine),
                    unk_token=unk[0] if unk else None, fuse_unk=True,
                    byte_fallback=proto["trainer_spec"]["byte_fallback"])


def spm_unigram_model(proto: dict) -> UnigramModel:
    pieces = proto["pieces"]
    normal = [i for i, (_, _, t) in enumerate(pieces) if t == NORMAL]
    unk = [i for i, (_, _, t) in enumerate(pieces) if t == UNKNOWN]
    return UnigramModel([(p, s) for p, s, _ in pieces], unk[0] if unk else None,
                        proto["trainer_spec"]["byte_fallback"], matchable=normal)


def spm_tokenizer(proto: dict, config: dict = None, *, engine: str = "native",
                  model_type: str = None) -> HFTokenizer:
    """The ``HFTokenizer`` of a parsed ``ModelProto`` (see the module docstring)."""
    trainer, norm = proto["trainer_spec"], proto["normalizer_spec"]
    if norm["precompiled_charsmap"]:
        raise ValueError(f"tokenizer.model normalizes with a precompiled charsmap "
                         f"({norm['name'] or 'unnamed'}), {A10G}")
    if trainer["treat_whitespace_as_suffix"]:
        raise ValueError(f"tokenizer.model treats whitespace as a suffix, {A10G}")
    if trainer["model_type"] == BPE:
        model = spm_bpe_model(proto, engine)
    elif trainer["model_type"] == UNIGRAM:
        model = spm_unigram_model(proto)
    else:
        raise ValueError(f"SentencePiece model type {trainer['model_type']} (WORD / CHAR) is "
                         f"{A10G}")
    pieces = proto["pieces"]
    added = [dict(content=p, id=i, special=t != USER_DEFINED, normalized=False, lstrip=False,
                  rstrip=False, single_word=False)
             for i, (p, _, t) in enumerate(pieces) if t in (UNKNOWN, CONTROL, USER_DEFINED)]
    decoders = [{"type": "Replace", "pattern": {"String": SPACE}, "content": " "},
                {"type": "ByteFallback"}, {"type": "Fuse"}]
    if norm["add_dummy_prefix"]:
        decoders.append({"type": "Strip", "content": " ", "start": 1, "stop": 0})
    config = dict(config or {})
    for name, key in (("unk_token", "unk_id"), ("bos_token", "bos_id"), ("eos_token", "eos_id"),
                      ("pad_token", "pad_id")):
        if 0 <= trainer[key] < len(pieces):
            config.setdefault(name, pieces[trainer[key]][0])
    spec = {"added_tokens": added, "normalizer": None, "pre_tokenizer": None,
            "post_processor": None, "decoder": {"type": "Sequence", "decoders": decoders}}
    return HFTokenizer(spec, config, engine=engine, model_type=model_type, model=model,
                       normalizer=spm_normalizer(norm))


def load_spm_tokenizer(model_dir: str, *, engine: str = "native") -> HFTokenizer:
    """The tokenizer of ``model_dir/tokenizer.model`` with the directory's
    ``tokenizer_config.json`` and ``config.json``'s ``model_type``."""
    with open(os.path.join(model_dir, "tokenizer.model"), "rb") as f:
        proto = parse_model_proto(f.read())
    return spm_tokenizer(proto, read_json(model_dir, "tokenizer_config.json"), engine=engine,
                         model_type=read_json(model_dir, "config.json").get("model_type"))
