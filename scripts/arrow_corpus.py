#!/usr/bin/env python3
"""Write a list of texts as a ``datasets.save_to_disk`` directory, in plain
Python (no ``pyarrow``, no ``datasets``).

A test fixture writer, not a feature of the package: ``chip_smoke.py`` makes
its corpus directories with it on a machine without ``datasets``, and the
tests hold its output against ``datasets.load_from_disk``. It writes one
column, ``text`` (Arrow ``string``: int32 offsets, no nulls), as
``state.json``, ``dataset_info.json`` and ``num_shards`` Arrow IPC stream
files of record batches of at most ``batch_rows`` rows (a schema message,
the batches, the end-of-stream marker).

    python3 scripts/arrow_corpus.py OUT_DIR FILE

cuts FILE's text into documents at blank lines and writes them to OUT_DIR.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import struct
from typing import Callable, List, Sequence, Tuple

_FEATURES = {"text": {"dtype": "string", "_type": "Value"}}
_UTF8, _SCHEMA, _RECORD_BATCH, _V5 = 5, 1, 3, 4


class _Builder:
    """A flatbuffer laid out front to back: each table's vtable just before
    it, the objects a table points at after it (uoffsets are unsigned), every
    scalar at an address aligned to its size from the start of the buffer."""

    def __init__(self):
        self.buf = bytearray(4)         # the root uoffset, patched by finish()

    def _pad(self, align: int, phase: int = 0) -> None:
        while len(self.buf) % align != phase:
            self.buf.append(0)

    def _patch(self, at: int, target: int) -> None:
        struct.pack_into("<I", self.buf, at, target - at)

    def table(self, fields: Sequence[Tuple[int, str, object]]) -> int:
        """``fields``: (slot, kind, value) with kind a struct code (``b`` /
        ``B`` / ``h`` / ``q``) for scalars or ``o`` for an object, whose value
        is a function that writes it and returns its position."""
        width = {"q": 8, "o": 4, "h": 2, "b": 1, "B": 1}
        order = sorted(fields, key=lambda f: -width[f[1]])
        slots = 1 + max((f[0] for f in fields), default=-1)
        at, place = 8, {}
        for slot, kind, _ in order:
            at = -(-at // width[kind]) * width[kind]
            place[slot] = at
            at += width[kind]
        self._pad(2)
        vtable = len(self.buf)
        entries = [place.get(s, 0) for s in range(slots)]
        self.buf += struct.pack(f"<HH{slots}H", 4 + 2 * slots, at, *entries)
        self._pad(8)
        start = len(self.buf)
        self.buf += bytes(at)
        struct.pack_into("<i", self.buf, start, start - vtable)
        children = []
        for slot, kind, value in fields:
            if kind == "o":
                children.append((start + place[slot], value))
            else:
                struct.pack_into("<" + kind, self.buf, start + place[slot], value)
        for at_field, write in children:
            self._patch(at_field, write())
        return start

    def string(self, s: str) -> int:
        self._pad(4)
        start = len(self.buf)
        raw = s.encode("utf-8")
        self.buf += struct.pack("<I", len(raw)) + raw + b"\0"
        return start

    def structs(self, rows: Sequence[tuple], fmt: str) -> int:
        """A vector of 8-byte-aligned structs of ``fmt`` (the length just before them)."""
        self._pad(8, 4)
        start = len(self.buf)
        self.buf += struct.pack("<I", len(rows))
        for row in rows:
            self.buf += struct.pack("<" + fmt, *row)
        return start

    def tables(self, writers: Sequence[Callable[[], int]]) -> int:
        self._pad(4)
        start = len(self.buf)
        self.buf += struct.pack("<I", len(writers)) + bytes(4 * len(writers))
        for i, write in enumerate(writers):
            self._patch(start + 4 + 4 * i, write())
        return start

    def finish(self, root: Callable[[], int]) -> bytes:
        self._patch(0, root())
        self._pad(8)
        return bytes(self.buf)


def _message(kind: int, header: Callable[[_Builder], int], body_len: int) -> bytes:
    b = _Builder()
    meta = b.finish(lambda: b.table([(0, "h", _V5), (1, "B", kind),
                                     (2, "o", lambda: header(b)), (3, "q", body_len)]))
    return struct.pack("<iI", -1, len(meta)) + meta


def _schema(b: _Builder) -> int:
    meta = json.dumps({"info": {"features": _FEATURES}})

    def field():
        return b.table([(0, "o", lambda: b.string("text")), (1, "B", 1), (2, "B", _UTF8),
                        (3, "o", lambda: b.table([])), (5, "o", lambda: b.tables([]))])

    def key_value():
        return b.table([(0, "o", lambda: b.string("huggingface")),
                        (1, "o", lambda: b.string(meta))])

    return b.table([(1, "o", lambda: b.tables([field])), (2, "o", lambda: b.tables([key_value]))])


def _pad8(raw: bytes) -> bytes:
    return raw + bytes(-len(raw) % 8)


def _record_batch(texts: Sequence[str]) -> bytes:
    raw = [t.encode("utf-8") for t in texts]
    offsets = [0]
    for r in raw:
        offsets.append(offsets[-1] + len(r))
    off_bytes = _pad8(struct.pack(f"<{len(offsets)}i", *offsets))
    data = _pad8(b"".join(raw))
    buffers = [(0, 0), (0, 4 * len(offsets)), (len(off_bytes), offsets[-1])]
    body = off_bytes + data

    def header(b):
        return b.table([(0, "q", len(texts)),
                        (1, "o", lambda: b.structs([(len(texts), 0)], "qq")),
                        (2, "o", lambda: b.structs(buffers, "qq"))])

    return _message(_RECORD_BATCH, header, len(body)) + body


def write_dataset(directory: str, texts: Sequence[str], *, num_shards: int = 1,
                  batch_rows: int = 1000) -> str:
    """``texts`` as a ``Dataset`` directory with one ``text`` column,
    contiguous rows per shard as ``save_to_disk(num_shards=...)`` cuts them.
    Returns ``directory``."""
    if any(not isinstance(t, str) for t in texts):
        raise TypeError("texts must be str (this writer has no nulls)")
    os.makedirs(directory, exist_ok=True)
    n = len(texts)
    names = []
    for k in range(num_shards):
        rows = texts[k * n // num_shards:(k + 1) * n // num_shards]
        name = f"data-{k:05d}-of-{num_shards:05d}.arrow"
        with open(os.path.join(directory, name), "wb") as f:
            f.write(_message(_SCHEMA, _schema, 0))
            for i in range(0, len(rows), batch_rows):
                f.write(_record_batch(rows[i:i + batch_rows]))
            f.write(struct.pack("<iI", -1, 0))
        names.append(name)
    fingerprint = hashlib.sha256("\0".join(texts).encode("utf-8")).hexdigest()[:16]
    state = {"_data_files": [{"filename": name} for name in names], "_fingerprint": fingerprint,
             "_format_columns": None, "_format_kwargs": {}, "_format_type": None,
             "_output_all_columns": False, "_split": None}
    info = {"citation": "", "description": "", "features": _FEATURES, "homepage": "",
            "license": ""}
    for name, obj in (("state.json", state), ("dataset_info.json", info)):
        with open(os.path.join(directory, name), "w") as f:
            json.dump(obj, f, indent=2)
    return directory


def documents(text: str) -> List[str]:
    """``text`` cut at blank lines (``"\\n\\n"``), empty pieces dropped."""
    return [d for d in text.split("\n\n") if d.strip()]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("out_dir")
    p.add_argument("file", help="a UTF-8 text file, cut into documents at blank lines")
    args = p.parse_args(argv)
    with open(args.file, encoding="utf-8") as f:
        docs = documents(f.read())
    write_dataset(args.out_dir, docs)
    print(f"{len(docs)} documents -> {args.out_dir}")


if __name__ == "__main__":
    main()
