#!/usr/bin/env python3
"""JPEG and PNG writers in numpy, for the files Pillow cannot write.

A test fixture writer, not a feature of the package. Pillow writes baseline
and progressive JPEGs at 4:4:4, 4:2:2 and 4:2:0, grey, CMYK and Adobe RGB,
and non-interlaced PNGs with its own filter choice. The reader is also held
to files with other sampling factors (4:4:0, 4:1:1), YCCK, progressive scan
scripts that leave coefficient bits unrefined (what makes libjpeg smooth the
blocks), interlaced PNGs, chosen PNG filters, 16-bit samples and short
palettes; ``encode_jpeg`` and ``encode_png`` write those. Pillow decodes them
for the expected values.

- ``encode_jpeg``: any number of components with any sampling factors, a
  float DCT quantized by the IJG tables at a quality, optimal Huffman tables
  per scan (a DHT before each SOS), sequential (one interleaved scan, or one
  scan per component) or progressive from a list of scans: DC first and
  refinement scans, AC first scans (each block's band closed by its own EOB).
- ``encode_png``: colour types 0, 2, 3, 4 and 6 at 8 or 16 bits, Adam7 or not,
  each scanline's filter drawn from a seed.
"""

from __future__ import annotations

import struct
import zlib
from typing import List, Optional, Sequence, Tuple

import numpy as np

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27,
    20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58,
    59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62, 18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113,
    92, 49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
CHROMA_Q = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99, 24, 26, 56, 99, 99, 99, 99, 99,
    47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32)


def quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """The IJG scaling of a base table (natural order), clamped to 1..255."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255).astype(np.int64)


def _dct_matrix() -> np.ndarray:
    m = np.zeros((8, 8))
    for k in range(8):
        for n in range(8):
            m[k, n] = (np.sqrt(1 / 8) if k == 0 else np.sqrt(2 / 8)) * np.cos(np.pi * (2 * n + 1) * k / 16)
    return m


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, value: int, nbits: int):
        for i in range(nbits - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)
                self.acc, self.n = 0, 0

    def flush(self) -> bytes:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)
        return bytes(self.out)


def _huffman_table(freq: dict) -> Tuple[List[int], List[int]]:
    """(bits[1..16], symbols) of a length-limited Huffman code for the symbol
    counts, with one code point reserved so no code is all ones (JPEG K.2)."""
    counts = np.zeros(257, np.int64)
    for s, c in freq.items():
        counts[s] = c
    counts[256] = 1
    size = np.zeros(257, np.int64)
    other = -np.ones(257, np.int64)
    counts = counts.astype(float)
    while True:
        live = [i for i in range(257) if counts[i] > 0]
        if len(live) < 2:
            break
        live.sort(key=lambda i: (counts[i], -i))
        c1, c2 = live[0], live[1]
        counts[c1] += counts[c2]
        counts[c2] = 0
        size[c1] += 1
        while other[c1] >= 0:
            c1 = other[c1]
            size[c1] += 1
        other[c1] = c2
        size[c2] += 1
        while other[c2] >= 0:
            c2 = other[c2]
            size[c2] += 1
    bits = np.zeros(33, np.int64)
    for i in range(257):
        if size[i]:
            bits[size[i]] += 1
    for i in range(32, 16, -1):
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1  # the reserved code point
    symbols = [s for length in range(1, 33) for s in range(256) if size[s] == length]
    return [int(b) for b in bits[1:17]], symbols


def _codes(bits: List[int], symbols: List[int]) -> dict:
    code, k, table = 0, 0, {}
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            table[symbols[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return table


def _category(v: int) -> Tuple[int, int]:
    s = int(abs(v)).bit_length()
    return s, (v if v >= 0 else v + (1 << s) - 1)


def _segment(marker: int, payload: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(payload) + 2) + payload


def _box_downsample(x: np.ndarray, fy: int, fx: int) -> np.ndarray:
    h, w = x.shape
    return x.reshape(h // fy, fy, w // fx, fx).mean(axis=(1, 3))


def encode_jpeg(channels: Sequence[np.ndarray], sampling: Sequence[Tuple[int, int]],
                quality: int = 75, *, ids: Optional[Sequence[int]] = None, jfif: bool = True,
                adobe_transform: Optional[int] = None, restart_interval: int = 0,
                scans: Optional[Sequence[Tuple[Sequence[int], int, int, int, int]]] = None,
                interleaved: bool = True) -> bytes:
    """A JPEG of full-size uint8 ``channels`` (stored as given: no colour
    transform), component i sampled ``sampling[i] = (h, v)``. ``scans`` makes
    a progressive file: ``(components, Ss, Se, Ah, Al)`` each (AC scans take
    one component; AC refinement is not written). Without it the file is
    sequential: one interleaved scan, or one scan per component."""
    chans = [np.asarray(c, np.float64) for c in channels]
    height, width = chans[0].shape
    nc = len(chans)
    ids = list(ids) if ids is not None else list(range(1, nc + 1))
    hmax, vmax = max(h for h, _ in sampling), max(v for _, v in sampling)
    mx, my = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    tables = [quant_table(LUMA_Q, quality), quant_table(CHROMA_Q, quality)]
    dct = _dct_matrix()
    coefs = []  # per component: [by, bx, 64] natural order, quantized
    for i, c in enumerate(chans):
        h, v = sampling[i]
        full = np.pad(c, ((0, my * vmax * 8 - height), (0, mx * hmax * 8 - width)), mode="edge")
        plane = _box_downsample(full, vmax // v, hmax // h) - 128.0
        bh, bw = plane.shape[0] // 8, plane.shape[1] // 8
        blocks = plane.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
        freq = np.einsum("ki,abij,lj->abkl", dct, blocks, dct).reshape(bh, bw, 64)
        q = tables[min(i, 1)]
        coefs.append(np.round(freq / q).astype(np.int64))
    wib = [-(-(width * h) // (8 * hmax)) for h, _ in sampling]
    hib = [-(-(height * v) // (8 * vmax)) for _, v in sampling]

    out = bytearray(b"\xff\xd8")
    if jfif:
        out += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if adobe_transform is not None:
        out += _segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, adobe_transform))
    for t, q in enumerate(tables[:min(nc, 2)]):
        out += _segment(0xDB, bytes([t]) + bytes(int(x) for x in q[ZIGZAG]))
    progressive = scans is not None
    sof = struct.pack(">BHHB", 8, height, width, nc)
    for i in range(nc):
        sof += bytes([ids[i], sampling[i][0] << 4 | sampling[i][1], min(i, 1)])
    out += _segment(0xC2 if progressive else 0xC0, sof)
    if restart_interval:
        out += _segment(0xDD, struct.pack(">H", restart_interval))
    if scans is None:
        scans = [(list(range(nc)), 0, 63, 0, 0)] if interleaved else [([i], 0, 63, 0, 0) for i in range(nc)]

    for comps, ss, se, ah, al in scans:
        # the scan's blocks in order, grouped by MCU
        if len(comps) == 1:
            c = comps[0]
            mcus = [[(c, by, bx)] for by in range(hib[c]) for bx in range(wib[c])]
        else:
            mcus = [[(c, y * sampling[c][1] + yy, x * sampling[c][0] + xx) for c in comps
                     for yy in range(sampling[c][1]) for xx in range(sampling[c][0])]
                    for y in range(my) for x in range(mx)]
        # symbols: ("dc"|"ac", component, symbol, extra bits value, extra bits count)
        stream: List[list] = []
        pred = {c: 0 for c in comps}
        for m, mcu in enumerate(mcus):
            if restart_interval and m and m % restart_interval == 0:
                stream.append(["rst"])
                pred = {c: 0 for c in comps}
            for c, by, bx in mcu:
                blk = coefs[c][by, bx]
                zz = blk[ZIGZAG]
                if ss == 0 and (not progressive or ah == 0):
                    dc = int(zz[0]) >> al if progressive else int(zz[0])
                    s, bits_ = _category(dc - pred[c])
                    pred[c] = dc
                    stream.append(["dc", c, s, bits_, s])
                if ss == 0 and progressive and ah > 0:
                    stream.append(["raw", (int(zz[0]) >> al) & 1, 1])
                if ss > 0 or not progressive:
                    lo = 1 if not progressive else ss
                    hi = 63 if not progressive else se
                    band = [int(v) for v in zz[lo:hi + 1]]
                    if progressive:
                        band = [(abs(v) >> al) * (1 if v >= 0 else -1) for v in band]
                    run = 0
                    last = max([k for k, v in enumerate(band) if v] + [-1])
                    for k, v in enumerate(band):
                        if k > last:
                            stream.append(["ac", c, 0x00, 0, 0])
                            break
                        if v == 0:
                            run += 1
                            continue
                        while run > 15:
                            stream.append(["ac", c, 0xF0, 0, 0])
                            run -= 16
                        s, bits_ = _category(v)
                        stream.append(["ac", c, (run << 4) | s, bits_, s])
                        run = 0
        # optimal tables per (kind, component table)
        freqs = {}
        for e in stream:
            if e[0] in ("dc", "ac"):
                key = (e[0], min(e[1], 1))
                freqs.setdefault(key, {})
                freqs[key][e[2]] = freqs[key].get(e[2], 0) + 1
        codes = {}
        dht = b""
        for (kind, t), fr in sorted(freqs.items()):
            bits, symbols = _huffman_table(fr)
            codes[(kind, t)] = _codes(bits, symbols)
            dht += bytes([(0x10 if kind == "ac" else 0) | t] + bits + symbols)
        if dht:
            out += _segment(0xC4, dht)
        sos = bytes([len(comps)])
        for c in comps:
            sos += bytes([ids[c], min(c, 1) << 4 | min(c, 1)])
        out += _segment(0xDA, sos + bytes([ss, se, ah << 4 | al]))
        bw = _BitWriter()
        rst = 0
        for e in stream:
            if e[0] == "rst":
                out += bw.flush() + bytes([0xFF, 0xD0 + rst])
                rst = (rst + 1) & 7
                bw = _BitWriter()
            elif e[0] == "raw":
                bw.put(e[1], e[2])
            else:
                code, length = codes[(e[0], min(e[1], 1))][e[2]]
                bw.put(code, length)
                if e[4]:
                    bw.put(e[3], e[4])
        out += bw.flush()
    return bytes(out + b"\xff\xd9")


_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


def _filter_rows(px: np.ndarray, bpp: int, rng) -> bytes:
    """Filter each scanline of ``px`` ([h, row_bytes] uint8) with a filter
    type drawn from ``rng``."""
    out = bytearray()
    prev = np.zeros(px.shape[1], np.int64)
    for row in px.astype(np.int64):
        kind = int(rng.integers(0, 5))
        left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]]) if bpp < row.size else np.zeros_like(row)
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]]) if bpp < row.size else np.zeros_like(row)
        if kind == 0:
            pred = np.zeros_like(row)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (left + prev) >> 1
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        out.append(kind)
        out += ((row - pred) & 0xFF).astype(np.uint8).tobytes()
        prev = row
    return bytes(out)


def encode_png(samples: np.ndarray, color_type: int, depth: int = 8, *, interlace: bool = False,
               palette: Optional[np.ndarray] = None, trns: Optional[bytes] = None,
               seed: int = 0) -> bytes:
    """A PNG of ``samples`` ([h, w, channels], uint8 or uint16 for 16-bit),
    each scanline's filter drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    h, w = samples.shape[:2]
    ch = samples.shape[2]
    data = samples.astype(">u2" if depth == 16 else np.uint8)
    bpp = ch * depth // 8
    raw = b""
    for x0, y0, dx, dy in (_ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = data[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        raw += _filter_rows(np.frombuffer(sub.tobytes(), np.uint8).reshape(sub.shape[0], -1),
                            bpp, rng)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color_type,
                                                           0, 0, int(interlace)))
    if palette is not None:
        out += chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += chunk(b"tRNS", trns)
    return out + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b"")
