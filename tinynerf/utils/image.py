"""PNG IO with the standard library (zlib) only.

`write_png`/`save_png` write 8-bit RGB(A) PNGs; `read_png` decodes
non-interlaced 8-bit grayscale/RGB/RGBA PNGs, all five scanline filters.
The data loaders try the native libpng loader and Pillow first
(data/parsers.py); this decoder is the fallback that needs neither.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPES = {0: 1, 2: 3, 4: 2, 6: 4}  # PNG color type -> channels
_CHANNEL_TYPES = {v: k for k, v in _COLOR_TYPES.items()}


def _chunk(tag: bytes, data: bytes) -> bytes:
    body = tag + data
    return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body))


def write_png(arr: np.ndarray, path: Path) -> None:
    """arr: [h, w] or [h, w, C] uint8, C in {1, 2, 3, 4}."""
    arr = np.asarray(arr, dtype=np.uint8)
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, c = arr.shape
    header = struct.pack(">IIBBBBB", w, h, 8, _CHANNEL_TYPES[c], 0, 0, 0)
    # filter type 0 (None) on every scanline
    raw = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * c)], 1)
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(_chunk(b"IHDR", header))
        f.write(_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


def save_png(img: np.ndarray, path: Path) -> None:
    """img: [h, w, 3] float in [0,1] -> 8-bit PNG."""
    write_png(np.clip(np.asarray(img) * 255.0, 0, 255).astype(np.uint8), path)


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    rows = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.int32)
    for y in range(h):
        ftype, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub: running sum per channel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1)
        elif ftype == 2:  # Up
            cur = line + prior
        elif ftype in (3, 4):  # Average / Paeth: sequential in x
            cur = line.copy()
            for x in range(stride):
                a = cur[x - bpp] & 0xFF if x >= bpp else 0
                b = prior[x]
                if ftype == 3:
                    cur[x] += (a + b) // 2
                else:
                    c = prior[x - bpp] if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    cur[x] += a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        prior = cur & 0xFF
        out[y] = prior
    return out


def read_png(path: Path) -> np.ndarray:
    """Decode a PNG into [h, w, C] uint8 (C = 1, 2, 3 or 4)."""
    data = Path(path).read_bytes()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        tag, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or interlace or ctype not in _COLOR_TYPES:
        raise ValueError(f"{path}: only 8-bit non-interlaced gray/RGB(A) PNGs")
    c = _COLOR_TYPES[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    return _unfilter(raw, h, w * c, c).reshape(h, w, c)
