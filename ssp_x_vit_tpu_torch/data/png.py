"""A PNG reader on the standard library's ``zlib`` with numpy unfiltering, giving
what Pillow's ``Image.open(path).convert("RGB")`` gives (some files of
Oxford-IIIT-Pet are PNG data under a ``.jpg`` name).

- 8-bit grey, grey+alpha, RGB, RGBA and palette images, with or without Adam7
  interlacing; 16-bit grey, grey+alpha, RGB and RGBA as Pillow reduces them:
  grey opens as ``I;16``, whose RGB clips at 255, the others keep each
  sample's high byte.
- RGB as Pillow converts: alpha dropped, grey replicated, the palette looked up
  (an index past the palette is black); ``tRNS``, ``gAMA`` and ICC
  profiles change no pixel.
- Other bit depths (1, 2 and 4), images of more than twice Pillow's
  decompression-bomb limit (as Pillow refuses them) and malformed files raise
  ``ValueError``.

Unfiltering runs row by row: None, Sub and Up in numpy; Average and Paeth
predict each byte from the one reconstructed before it, so those rows go byte
by byte (Pillow's writer picks them for few rows).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"

# colour type -> channels
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))

# Pillow's Image.MAX_IMAGE_PIXELS; Image.open refuses more than twice as many
MAX_IMAGE_PIXELS = 89478485


def unfilter(raw: np.ndarray, height: int, row_bytes: int, bpp: int) -> np.ndarray:
    """[height, row_bytes] uint8 from ``height`` filtered scanlines (a filter
    byte each), ``bpp`` bytes per pixel (at least 1)."""
    rows = raw.reshape(height, row_bytes + 1)
    kinds = rows[:, 0]
    if kinds.size and kinds.max() > 4:
        raise ValueError(f"unknown PNG filter type {int(kinds.max())}")
    out = np.zeros((height + 1, row_bytes), np.uint8)  # out[0]: the zero row above
    for r in range(height):
        kind, filt, up = kinds[r], rows[r, 1:], out[r]
        if kind == 0:
            out[r + 1] = filt
        elif kind == 1:
            out[r + 1] = np.cumsum(filt.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:
            out[r + 1] = filt + up
        else:
            line, above = bytearray(filt.tobytes()), up.tobytes()
            for i in range(row_bytes):
                a = line[i - bpp] if i >= bpp else 0
                b = above[i]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    c = above[i - bpp] if i >= bpp else 0
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                line[i] = (line[i] + pred) & 0xFF
            out[r + 1] = np.frombuffer(bytes(line), np.uint8)
    return out[1:]


def _samples(data: bytes, width: int, height: int, depth: int, channels: int,
             interlace: int, name: str) -> np.ndarray:
    """[height, width, channels] samples (uint8, or uint16 for 16-bit)."""
    bytes_per_sample = depth // 8
    bpp = channels * bytes_per_sample
    buf = np.frombuffer(data, np.uint8)
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    out = np.zeros((height, width, bpp), np.uint8)
    pos = 0
    for x0, y0, dx, dy in passes:
        w, h = (width - x0 + dx - 1) // dx, (height - y0 + dy - 1) // dy
        if w <= 0 or h <= 0:
            continue
        n = h * (w * bpp + 1)
        if pos + n > buf.size:
            raise ValueError(f"{name}: truncated PNG (the image data ends early)")
        out[y0::dy, x0::dx] = unfilter(buf[pos:pos + n], h, w * bpp, bpp).reshape(h, w, bpp)
        pos += n
    if depth == 16:
        return out.reshape(height, width, channels, 2)[..., 0] * np.uint16(256) + \
            out.reshape(height, width, channels, 2)[..., 1]
    return out


def read_rgb(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """[h, w, 3] uint8 RGB of a PNG file's bytes, as Pillow's
    ``open(...).convert("RGB")``; ``name`` goes into the error messages."""
    if data[:8] != SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    # As Pillow: the chunks before the image data must be whole with good
    # CRCs; the IDAT CRCs are not checked, and what follows the image data
    # (IEND included) may be cut off.
    pos, header, palette, idat = 8, None, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if kind == b"IDAT":
            idat.append(body)
        elif idat:
            break
        else:
            crc = data[pos + 8 + length:pos + 12 + length]
            if len(body) != length or len(crc) != 4:
                raise ValueError(f"{name}: truncated PNG ({kind.decode('latin-1')} chunk)")
            if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
                raise ValueError(f"{name}: broken PNG file ({kind.decode('latin-1')} CRC)")
            if kind == b"IHDR":
                if length != 13:
                    raise ValueError(f"{name}: bad IHDR chunk")
                header = struct.unpack(">IIBBBBB", body)
            elif kind == b"PLTE":
                palette = np.frombuffer(body[:len(body) // 3 * 3], np.uint8).reshape(-1, 3)
            elif kind == b"IEND":
                break
        pos += 12 + length
    if header is None:
        raise ValueError(f"{name}: PNG without an IHDR chunk")
    width, height, depth, ctype, method, filter_method, interlace = header
    if ctype not in _CHANNELS or method != 0 or filter_method != 0 or interlace > 1:
        raise ValueError(f"{name}: unsupported PNG header (colour type {ctype}, compression "
                         f"{method}, filter {filter_method}, interlace {interlace})")
    if depth not in (8, 16) or (ctype == 3 and depth != 8):
        raise ValueError(f"{name}: unsupported PNG: {depth}-bit samples of colour type {ctype} "
                         "(8-bit, and 16-bit non-palette, are read)")
    if width == 0 or height == 0:
        raise ValueError(f"{name}: empty PNG image")
    if width * height > 2 * MAX_IMAGE_PIXELS:
        raise ValueError(f"{name}: image too large: {width}x{height}")
    if not idat:
        raise ValueError(f"{name}: truncated PNG (no image data)")
    try:  # a stream cut short gives what it has; _samples checks the length
        raw = zlib.decompressobj().decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{name}: broken PNG image data ({e})") from None
    px = _samples(raw, width, height, depth, _CHANNELS[ctype], interlace, name)
    if ctype == 3:
        if palette is None or not len(palette):
            raise ValueError(f"{name}: palette PNG without a PLTE chunk")
        table = np.zeros((256, 3), np.uint8)
        table[:min(len(palette), 256)] = palette[:256]
        return table[px[..., 0]]
    if depth == 16:
        px = np.minimum(px, 255).astype(np.uint8) if ctype == 0 else (px >> 8).astype(np.uint8)
    if ctype in (0, 4):
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])
