"""Image dumps (counterpart of ``megaportraits_tpu/utils/image.py``).

The PNG is written with ``zlib`` and ``struct`` (8-bit RGB, no interlace,
filter 0 on every row), so the training drivers' debug images need no PIL:
the card's machine has none. The pixels are those PIL wrote.
"""

from __future__ import annotations

import os
import struct
import zlib

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
