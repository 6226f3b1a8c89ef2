"""Minimal PNG codec on zlib + struct, so the port reads its masks and
writes its previews without an image library.

write_png: 8-bit gray or RGB, filter type 0 on every row.
read_png:  8-bit gray (0), gray + alpha (4), RGB (2) and RGBA (6),
           non-interlaced, every filter type (None, Sub, Up, Average,
           Paeth). Anything else raises.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """img: uint8 [H, W, 3] (RGB) or [H, W] (gray)."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim == 2:
        color_type, channels = 0, 1
    elif img.ndim == 3 and img.shape[2] == 3:
        color_type, channels = 2, 3
    else:
        raise ValueError(f"write_png takes [H,W] or [H,W,3] uint8, got {img.shape}")
    H, W = img.shape[:2]
    rows = img.reshape(H, W * channels)
    raw = np.concatenate([np.zeros((H, 1), np.uint8), rows], axis=1).tobytes()  # filter 0
    ihdr = struct.pack(">IIBBBBB", W, H, 8, color_type, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(_chunk(b"IHDR", ihdr))
        f.write(_chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(_chunk(b"IEND", b""))


def _unfilter(raw: bytes, H: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters; bpp = bytes per pixel."""
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != H * (stride + 1):
        raise ValueError(f"PNG: {rows.size} bytes of image data, expected {H * (stride + 1)}")
    rows = rows.reshape(H, stride + 1)
    out = np.zeros((H, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(H):
        ftype, line = int(rows[y, 0]), rows[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 1:
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif ftype == 2:
            cur = (line + prev) & 0xFF
        elif ftype in (3, 4):
            # Average and Paeth read the reconstructed left neighbour
            cur = line.copy()
            for x in range(stride):
                a = int(cur[x - bpp]) if x >= bpp else 0
                b = int(prev[x])
                if ftype == 3:
                    p = (a + b) >> 1
                else:
                    c = int(prev[x - bpp]) if x >= bpp else 0
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    p = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[x] = (cur[x] + p) & 0xFF
        else:
            raise ValueError(f"PNG: unknown filter type {ftype} in row {y}")
        out[y] = cur
        prev = cur
    return out


def read_png(path: str) -> np.ndarray:
    """-> uint8 [H, W] (gray) or [H, W, C] (C = 2, 3 or 4)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = 8, [], None
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if crc != zlib.crc32(tag + body) & 0xFFFFFFFF:
            raise ValueError(f"{path}: bad CRC in chunk {tag!r}")
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + n
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    W, H, depth, color_type, _, _, interlace = header
    if depth != 8 or color_type not in _CHANNELS or interlace != 0:
        raise ValueError(f"{path}: only 8-bit non-interlaced gray/RGB(A) PNGs are read "
                         f"(bit depth {depth}, color type {color_type}, interlace {interlace})")
    c = _CHANNELS[color_type]
    img = _unfilter(zlib.decompress(b"".join(idat)), H, W * c, c)
    return img.reshape(H, W) if c == 1 else img.reshape(H, W, c)
