"""Reader of ``datasets.save_to_disk`` directories, written from the Arrow
columnar format and IPC specification, with the standard library and numpy
only (no ``pyarrow``, no ``datasets``).

A saved ``Dataset`` directory holds ``state.json`` (its ``_data_files``, in
order) and one Arrow IPC *stream* per shard. A stream is a run of messages,
each ``[0xFFFFFFFF][int32 metadata length][flatbuffer Message][body]`` (the
legacy form has no 0xFFFFFFFF marker), ended by a zero length: first the
``Schema``, then ``RecordBatch`` messages whose body holds the column buffers at
8-byte-aligned offsets. The flatbuffers are parsed by hand (``_Table``).

``read_column(directory, "text")`` maps every shard into memory and returns a
``TextColumn``: the column's rows, batch after batch, each record batch's
UTF-8 decoded only when the iteration reaches it, so a shard of hundreds of
MB is not turned into Python objects before it is read.
Columns of type ``string`` (int32 offsets) and ``large_string`` (int64
offsets) are read; a null (validity bitmap) reads as ``None``; other columns
beside the one asked for are skipped. Anything else raises a ValueError that
names the feature: dictionary batches or a dictionary-encoded column, body
compression, another type of the column, big-endian data, the IPC file format.

A ``DatasetDict`` directory (``dataset_dict.json``) has splits, not columns:
asking it for a column raises KeyError, as ``load_from_disk(path)["text"]``
does in the ``datasets`` library. A directory that is neither raises
FileNotFoundError, as ``load_from_disk`` does.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Iterator, List, Optional, Tuple

import numpy as np

# MessageHeader union (format/Message.fbs)
_SCHEMA, _DICTIONARY_BATCH, _RECORD_BATCH = 1, 2, 3
_HEADERS = {0: "NONE", 1: "Schema", 2: "DictionaryBatch", 3: "RecordBatch", 4: "Tensor",
            5: "SparseTensor"}
# Type union (format/Schema.fbs) -> (name, buffers of one array of it, validity included;
# None: depends on the type table)
_TYPES = {
    0: ("NONE", 0), 1: ("Null", 0), 2: ("Int", 2), 3: ("FloatingPoint", 2), 4: ("Binary", 3),
    5: ("Utf8", 3), 6: ("Bool", 2), 7: ("Decimal", 2), 8: ("Date", 2), 9: ("Time", 2),
    10: ("Timestamp", 2), 11: ("Interval", 2), 12: ("List", 2), 13: ("Struct_", 1),
    14: ("Union", None), 15: ("FixedSizeBinary", 2), 16: ("FixedSizeList", 1), 17: ("Map", 2),
    18: ("Duration", 2), 19: ("LargeBinary", 3), 20: ("LargeUtf8", 3), 21: ("LargeList", 2),
    22: ("RunEndEncoded", 0), 23: ("BinaryView", 2), 24: ("Utf8View", 2), 25: ("ListView", 3),
    26: ("LargeListView", 3),
}
_UTF8, _LARGE_UTF8, _UNION = 5, 20, 14
_VIEWS = (23, 24)           # their data buffers are counted in variadicBufferCounts
_MIN_VERSION = 3            # MetadataVersion V4: the current buffer layouts
_CONTINUATION = -1


class _Table:
    """A flatbuffer table at ``pos`` of ``buf``: its vtable lies at ``pos``
    minus the int32 stored there; field ``slot``'s uint16 offset from ``pos``
    is the vtable's entry 2 + slot (0: absent)."""

    __slots__ = ("buf", "pos", "vt", "vt_len")

    def __init__(self, buf: bytes, pos: int):
        self.buf, self.pos = buf, pos
        self.vt = pos - struct.unpack_from("<i", buf, pos)[0]
        self.vt_len = struct.unpack_from("<H", buf, self.vt)[0]

    def _offset(self, slot: int) -> int:
        at = 4 + 2 * slot
        return struct.unpack_from("<H", self.buf, self.vt + at)[0] if at < self.vt_len else 0

    def scalar(self, slot: int, fmt: str, default=0):
        off = self._offset(slot)
        return default if off == 0 else struct.unpack_from("<" + fmt, self.buf, self.pos + off)[0]

    def _target(self, slot: int) -> Optional[int]:
        off = self._offset(slot)
        if off == 0:
            return None
        at = self.pos + off
        return at + struct.unpack_from("<I", self.buf, at)[0]

    def table(self, slot: int) -> Optional["_Table"]:
        at = self._target(slot)
        return None if at is None else _Table(self.buf, at)

    def string(self, slot: int) -> Optional[str]:
        at = self._target(slot)
        if at is None:
            return None
        n = struct.unpack_from("<I", self.buf, at)[0]
        return self.buf[at + 4:at + 4 + n].decode("utf-8")

    def tables(self, slot: int) -> List["_Table"]:
        at = self._target(slot)
        if at is None:
            return []
        n = struct.unpack_from("<I", self.buf, at)[0]
        out = []
        for i in range(n):
            p = at + 4 + 4 * i
            out.append(_Table(self.buf, p + struct.unpack_from("<I", self.buf, p)[0]))
        return out

    def vector(self, slot: int, fmt: str) -> List[tuple]:
        """A vector of structs (or scalars) of the little-endian ``fmt``."""
        at = self._target(slot)
        if at is None:
            return []
        n = struct.unpack_from("<I", self.buf, at)[0]
        size = struct.calcsize("<" + fmt)
        return list(struct.iter_unpack("<" + fmt, self.buf[at + 4:at + 4 + n * size]))


class _Field:
    """One schema field: name, type id and table, dictionary encoding, children."""

    def __init__(self, table: _Table):
        self.name = table.string(0)
        self.type_id = table.scalar(2, "B")
        self.type = table.table(3)
        self.dictionary = table.table(4) is not None
        self.children = [_Field(t) for t in table.tables(5)]

    @property
    def type_name(self) -> str:
        return _TYPES.get(self.type_id, (f"type {self.type_id}", 0))[0]

    def layout(self) -> Tuple[int, int, int]:
        """(field nodes, buffers, views) one record batch gives this field and
        its children, in the format's pre-order; a view field's data buffers
        come on top, one entry of ``variadicBufferCounts`` per view."""
        if self.dictionary:          # the integer indices; values come in dictionary batches
            return 1, 2, 0
        if self.type_id not in _TYPES:
            raise ValueError(f"field {self.name!r}: unknown Arrow type id {self.type_id}")
        buffers = _TYPES[self.type_id][1]
        if self.type_id == _UNION:   # sparse: type ids; dense: type ids and offsets
            buffers = 1 if self.type.scalar(0, "h") == 0 else 2
        nodes, views = 1, int(self.type_id in _VIEWS)
        for child in self.children:
            n, b, v = child.layout()
            nodes, buffers, views = nodes + n, buffers + b, views + v
        return nodes, buffers, views


class _Batch:
    """One record batch's slice of a string column inside a mapped shard."""

    __slots__ = ("mm", "length", "null_count", "validity", "offsets", "data", "large")

    def __init__(self, mm, length, null_count, validity, offsets, data, large):
        self.mm, self.length, self.null_count = mm, length, null_count
        self.validity, self.offsets, self.data, self.large = validity, offsets, data, large

    def decode(self) -> List[Optional[str]]:
        n = self.length
        if n == 0:
            return []
        dtype = np.dtype("<i8" if self.large else "<i4")
        start, size = self.offsets
        if size < (n + 1) * dtype.itemsize:
            raise ValueError(f"offsets buffer of {size} bytes for {n} strings")
        offs = np.frombuffer(self.mm, dtype, n + 1, start).tolist()
        d0, dlen = self.data
        if offs[0] < 0 or offs[-1] > dlen or any(b < a for a, b in zip(offs, offs[1:])):
            raise ValueError("string offsets out of order or past the data buffer")
        data = self.mm[d0 + offs[0]:d0 + offs[-1]]
        base = offs[0]
        valid = None
        if self.null_count:
            v0, vlen = self.validity
            if vlen * 8 < n:
                raise ValueError(f"{self.null_count} nulls but a validity bitmap of {vlen} bytes")
            bits = np.frombuffer(self.mm, np.uint8, (n + 7) // 8, v0)
            valid = np.unpackbits(bits, bitorder="little")[:n].tolist()
        out: List[Optional[str]] = []
        for i in range(n):
            if valid is not None and not valid[i]:
                out.append(None)
            else:
                out.append(data[offs[i] - base:offs[i + 1] - base].decode("utf-8"))
        return out


def _read_shard(path: str, column: str) -> List[_Batch]:
    """The record batches of ``column`` in one IPC stream file."""
    with open(path, "rb") as f:
        if os.fstat(f.fileno()).st_size == 0:
            raise ValueError(f"{path}: empty file, not an Arrow IPC stream")
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    size = len(mm)
    if mm[:6] == b"ARROW1":
        raise ValueError(f"{path}: Arrow IPC file format (ARROW1 magic); only the stream format "
                         "that save_to_disk writes is read")
    pos, where, batches = 0, None, []
    try:
        while pos + 4 <= size:
            n = struct.unpack_from("<i", mm, pos)[0]
            pos += 4
            if n == _CONTINUATION:
                n = struct.unpack_from("<i", mm, pos)[0]
                pos += 4
            if n == 0:
                break
            if n < 0 or pos + n > size:
                raise ValueError(f"message metadata of {n} bytes at byte {pos - 4}")
            meta = mm[pos:pos + n]
            pos += n
            msg = _Table(meta, struct.unpack_from("<I", meta, 0)[0])
            version, kind = msg.scalar(0, "h"), msg.scalar(1, "B")
            header, body_len = msg.table(2), msg.scalar(3, "q")
            body, pos = pos, pos + body_len
            if body_len < 0 or pos > size:
                raise ValueError(f"message body of {body_len} bytes past the end of the file")
            if version < _MIN_VERSION:
                raise ValueError(f"Arrow metadata version V{version + 1} (before V4)")
            if kind == _SCHEMA:
                where = _locate(header, column)
            elif kind == _DICTIONARY_BATCH:
                raise ValueError("dictionary batches (a dictionary-encoded column) are not read")
            elif kind == _RECORD_BATCH:
                if where is None:
                    raise ValueError("a record batch before the schema")
                batches.append(_column_batch(mm, header, body, body_len, where))
            else:
                raise ValueError(f"{_HEADERS.get(kind, kind)} messages are not read")
    except (struct.error, IndexError, UnicodeDecodeError) as e:
        raise ValueError(f"{path}: malformed Arrow IPC stream ({e})") from e
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from e
    if where is None:
        raise ValueError(f"{path}: no schema message")
    return batches


def _locate(schema: _Table, column: str) -> Tuple[int, int, int, bool]:
    """(field node index, first buffer index, view fields before it, large
    offsets) of ``column`` in every record batch of this schema."""
    if schema.scalar(0, "h") != 0:
        raise ValueError("big-endian data is not read")
    node = buf = views = 0
    for table in schema.tables(1):
        field = _Field(table)
        if field.name == column:
            if field.dictionary:
                raise ValueError(f"column {column!r} is dictionary-encoded; dictionary batches "
                                 "are not read")
            if field.type_id not in (_UTF8, _LARGE_UTF8):
                raise ValueError(f"column {column!r} has Arrow type {field.type_name}; only "
                                 "string (Utf8) and large_string (LargeUtf8) are read")
            return node, buf, views, field.type_id == _LARGE_UTF8
        n, b, v = field.layout()
        node, buf, views = node + n, buf + b, views + v
    raise KeyError(column)


def _column_batch(mm, batch: _Table, body: int, body_len: int, where) -> _Batch:
    node, buf, views, large = where
    if batch.table(3) is not None:
        raise ValueError("body compression (LZ4_FRAME / ZSTD buffers) is not read")
    nodes = batch.vector(1, "qq")
    buffers = batch.vector(2, "qq")
    buf += sum(c for (c,) in batch.vector(4, "q")[:views])
    if node >= len(nodes) or buf + 3 > len(buffers):
        raise ValueError("a record batch with fewer field nodes or buffers than its schema")
    length, null_count = nodes[node]
    spans = []
    for off, size in buffers[buf:buf + 3]:
        if off < 0 or size < 0 or off + size > body_len:
            raise ValueError(f"buffer [{off}, {off + size}) outside a body of {body_len} bytes")
        spans.append((body + off, size))
    return _Batch(mm, length, null_count, *spans, large)


class TextColumn:
    """The rows of one string column over every record batch of every shard,
    in order; a batch is decoded when the iteration reaches it."""

    def __init__(self, batches: List[_Batch]):
        self._batches = batches

    def __len__(self) -> int:
        return sum(b.length for b in self._batches)

    def __iter__(self) -> Iterator[Optional[str]]:
        for batch in self._batches:
            yield from batch.decode()


def read_column(directory: str, column: str = "text") -> TextColumn:
    """The ``column`` of the ``Dataset`` that ``save_to_disk`` wrote to
    ``directory``: its shards in ``state.json`` order, each mapped into
    memory. Raises KeyError for a ``DatasetDict`` directory or a missing
    column, FileNotFoundError for a directory that holds neither kind, and
    ValueError for a stream feature this reader does not decode."""
    state_path = os.path.join(directory, "state.json")
    if not os.path.isfile(state_path):
        if os.path.isfile(os.path.join(directory, "dataset_dict.json")):
            raise KeyError(f"{column!r}: {directory} is a DatasetDict (splits, not columns)")
        raise FileNotFoundError(f"{directory} is neither a Dataset directory nor a DatasetDict "
                                "directory")
    with open(state_path) as f:
        files = [entry["filename"] for entry in json.load(f)["_data_files"]]
    batches: List[_Batch] = []
    for name in files:
        batches += _read_shard(os.path.join(directory, name), column)
    return TextColumn(batches)
