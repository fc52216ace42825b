"""PNG files without PIL (counterpart of ``megaportraits_tpu/utils/image.py``,
and of ``load_image`` in ``megaportraits_tpu/eval/metrics.py``).

``save_image`` writes with ``zlib`` and ``struct`` (8-bit RGB, no interlace,
filter 0 on every row), so the training drivers' debug images need no PIL:
the card's machine has none. The pixels are those PIL wrote.

``load_image`` reads 8-bit, non-interlaced gray, RGB, gray-alpha and RGBA
files with all five row filters, and returns what PIL's
``Image.open(path).convert("RGB")`` gives (gray repeated on three channels,
alpha dropped) as float32 in [0, 1]. Any other PNG raises ``ValueError``.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Tuple

import numpy as np
import torch

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _encode_png(rgb: np.ndarray) -> bytes:
    """uint8 [H, W, 3] -> the bytes of an 8-bit RGB PNG."""
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def save_image(array, path: str) -> None:
    """[H, W, 3] or [B, H, W, 3] float in [0, 1] (a tensor on any device,
    or an array) -> PNG of the first item of a batch."""
    if isinstance(array, torch.Tensor):
        array = array.detach().float().cpu().numpy()
    arr = np.asarray(array)
    if arr.ndim == 4:
        arr = arr[0]
    arr = (np.clip(arr.astype(np.float32), 0, 1) * 255).astype(np.uint8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(_encode_png(np.ascontiguousarray(arr)))


# Colour type -> channels, for the 8-bit colour types load_image reads.
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunks(data: bytes):
    """(kind, payload) of each chunk after the signature."""
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, h: int, row_bytes: int, bpp: int) -> np.ndarray:
    """The scanlines of a decompressed IDAT stream, their filters undone."""
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != h * (row_bytes + 1):
        raise ValueError(f"PNG image data holds {rows.size} bytes, expected "
                         f"{h * (row_bytes + 1)}")
    rows = rows.reshape(h, row_bytes + 1)
    out = np.zeros((h, row_bytes), np.uint8)
    prior = np.zeros(row_bytes, np.uint8)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:  # Sub: a running sum along each channel
            cur = (np.cumsum(line.reshape(-1, bpp).astype(np.int64), axis=0)
                   % 256).astype(np.uint8).reshape(-1)
        elif kind == 2:  # Up
            cur = line + prior
        elif kind in (3, 4):  # Average, Paeth: byte by byte
            cur = bytearray(line.tobytes())
            up = prior.tobytes()
            for i in range(row_bytes):
                left = cur[i - bpp] if i >= bpp else 0
                if kind == 3:
                    pred = (left + up[i]) >> 1
                else:
                    pred = _paeth(left, up[i], up[i - bpp] if i >= bpp else 0)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG row filter {kind} is not one of 0 to 4")
        out[y] = cur
        prior = out[y]
    return out


def read_png(path: str) -> Tuple[np.ndarray, int]:
    """uint8 [H, W, channels] and the PNG colour type of an 8-bit,
    non-interlaced gray (0), RGB (2), gray-alpha (4) or RGBA (6) file."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path} is not a PNG file")
    header, idat = None, []
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat.append(payload)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if depth != 8:
        raise ValueError(f"{path}: bit depth {depth} is not supported (8 only)")
    if color not in _CHANNELS:
        raise ValueError(f"{path}: colour type {color} (palette) is not supported")
    if interlace:
        raise ValueError(f"{path}: interlaced PNGs are not supported")
    ch = _CHANNELS[color]
    pixels = _unfilter(zlib.decompress(b"".join(idat)), h, w * ch, ch)
    return pixels.reshape(h, w, ch), color


def load_image(path: str) -> np.ndarray:
    """A PNG as RGB float32 [H, W, 3] in [0, 1]: gray repeated on the three
    channels, alpha dropped (PIL's ``convert("RGB")``)."""
    pixels, color = read_png(path)
    rgb = pixels[..., :3] if color in (2, 6) else np.repeat(pixels[..., :1], 3, axis=-1)
    return rgb.astype(np.float32) / 255.0
