"""Image files without PIL or cv2 (counterpart of
``megaportraits_tpu/utils/image.py``, and of the image reading and resizing
that the JAX package does with PIL and cv2). The card's machine has
neither.

Files:
  * ``read_image`` gives what PIL's ``Image.open(path).convert("RGB")``
    gives, as uint8 [H, W, 3], choosing the format by the file's first
    bytes: PNG (every colour type and bit depth, plain or Adam7
    interlaced, all five row filters) or JPEG (baseline, progressive or
    CMYK; ``utils/jpeg.py``). Any other file raises ``ValueError`` naming
    its format. ``load_image`` is the same as float32 in [0, 1]. PIL's
    rules for the PNG samples are kept: gray repeated on three channels,
    alpha and tRNS dropped, gray of 1, 2 or 4 bits scaled to 0..255, a
    palette index past PLTE black, 16-bit gray clipped to 255 (PIL's
    ``I;16`` mode) and every other 16-bit sample cut to its high byte.
  * ``write_image`` writes uint8 RGB by the path's extension: ``.png``
    (``zlib``, filter 0 on every row; the pixels PIL writes) or ``.jpg`` /
    ``.jpeg`` (PIL's default JPEG, byte for byte). ``save_image`` takes
    float in [0, 1], as JAX's does.

Resizing uint8 [H, W, C] images, bit for bit:
  * ``pil_bilinear_resize``: PIL's ``Image.resize(size, Image.BILINEAR)``
    (two separable passes, horizontal first, each with a triangle filter
    whose support widens by the scale on a downscale, 22-bit fixed-point
    weights, rounded to 8 bits between the passes);
  * ``cv2_linear_resize_u8``: cv2's ``resize(..., INTER_LINEAR)`` on
    uint8 (11-bit weights, the horizontal pass in integers, the vertical
    one as its vector code rounds it: each product truncated to 16 bits,
    then (sum + 2) >> 2; the vertical weights are not clamped at the
    borders, the rows are).
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Optional, Tuple

import numpy as np
import torch

from megaportraits_tpu_torch.utils import jpeg

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
    or an array) -> an image file of the first item of a batch, PNG or
    JPEG by the path's extension (``write_image``)."""
    if isinstance(array, torch.Tensor):
        array = array.detach().float().cpu().numpy()
    arr = np.asarray(array)
    if arr.ndim == 4:
        arr = arr[0]
    write_image((np.clip(arr.astype(np.float32), 0, 1) * 255).astype(np.uint8), path)


def write_image(rgb: np.ndarray, path: str) -> None:
    """uint8 [H, W, 3] -> `path`: PNG for ``.png``, PIL's default JPEG for
    ``.jpg`` and ``.jpeg``; any other extension raises ValueError."""
    ext = os.path.splitext(path)[1].lower()
    rgb = np.ascontiguousarray(rgb)
    if ext == ".png":
        data = _encode_png(rgb)
    elif ext in (".jpg", ".jpeg"):
        data = jpeg.encode(rgb)
    else:
        raise ValueError(f"{path}: cannot write {ext or 'a file without an extension'} "
                         "(.png, .jpg or .jpeg)")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)


# Colour type -> channels, and the bit depths the PNG standard allows it.
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# The seven Adam7 passes: (first column, first row, column step, row step).
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
         (1, 0, 2, 2), (0, 1, 1, 2))


def _chunks(data: bytes):
    """(kind, payload) of each chunk after the signature."""
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length


def _unfilter(raw: bytes, h: int, row_bytes: int, bpp: int) -> np.ndarray:
    """The scanlines of a decompressed IDAT stream, their filters undone:
    row by row when every row is None, Sub or Up (each row a few array
    operations), else all rows together along anti-diagonals (Average and
    Paeth make each byte depend on the one bpp to its left)."""
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != h * (row_bytes + 1):
        raise ValueError(f"PNG image data holds {rows.size} bytes, expected "
                         f"{h * (row_bytes + 1)}")
    rows = rows.reshape(h, row_bytes + 1)
    kinds = rows[:, 0]
    if (kinds > 4).any():
        raise ValueError(f"PNG row filter {int(kinds.max())} is not one of 0 to 4")
    if (kinds >= 3).any():
        return _unfilter_diagonals(rows, h, row_bytes, bpp)
    out = np.zeros((h, row_bytes), np.uint8)
    prior = np.zeros(row_bytes, np.uint8)
    for y in range(h):
        line = rows[y, 1:]
        if kinds[y] == 1:  # Sub: a running sum along each channel
            line = (np.cumsum(line.reshape(-1, bpp).astype(np.int64), axis=0)
                    % 256).astype(np.uint8).reshape(-1)
        elif kinds[y] == 2:  # Up
            line = line + prior
        out[y] = line
        prior = out[y]
    return out


def _unfilter_diagonals(rows: np.ndarray, h: int, row_bytes: int, bpp: int) -> np.ndarray:
    """_unfilter for any mix of the five filters: step t reconstructs pixel
    x = t - y of every row y. The pixels are kept skewed, diag[t + 2, y + 1]
    = pixel (y, t - y), so that each step reads and writes contiguous slices
    (zeros stand left of x = 0 and above y = 0)."""
    w = row_bytes // bpp
    y, x = np.mgrid[0:h, 0:w]
    line = np.zeros((h + w + 2, h + 1, bpp), np.int16)
    line[x + y + 2, y + 1] = rows[:, 1:].reshape(h, w, bpp)
    diag = np.zeros_like(line)
    kinds = np.concatenate([[0], rows[:, 0].astype(np.int16)])[:, None]
    for t in range(h + w - 1):
        lo, hi = max(0, t - w + 1) + 1, min(h, t + 1) + 1  # rows y + 1
        left, up, corner = diag[t + 1, lo:hi], diag[t + 1, lo - 1:hi - 1], diag[t, lo - 1:hi - 1]
        kind = kinds[lo:hi]
        p = left + up - corner
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - corner)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, corner))
        pred = np.where(kind == 1, left, np.where(kind == 2, up, np.where(
            kind == 3, (left + up) >> 1, np.where(kind == 4, paeth, 0))))
        diag[t + 2, lo:hi] = (line[t + 2, lo:hi] + pred) & 0xFF
    return diag[x + y + 2, y + 1].astype(np.uint8).reshape(h, row_bytes)


def _unpack(rows: np.ndarray, w: int, ch: int, depth: int) -> np.ndarray:
    """Unfiltered scanlines [h, row bytes] -> samples [h, w, ch]: uint8 up
    to 8 bits (1, 2 and 4 bits unscaled), big-endian uint16 at 16."""
    h = rows.shape[0]
    if depth == 8:
        return rows[:, :w * ch].reshape(h, w, ch)
    if depth == 16:
        pairs = rows[:, :w * ch * 2].reshape(h, w, ch, 2).astype(np.uint16)
        return (pairs[..., 0] << 8) | pairs[..., 1]
    bits = np.unpackbits(rows, axis=1)[:, :w * depth].reshape(h, w, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=-1, dtype=np.uint8)[..., None]


def _samples(raw: bytes, w: int, h: int, ch: int, depth: int, interlace: int) -> np.ndarray:
    """The samples [h, w, ch] of a decompressed IDAT stream, plain or as the
    seven Adam7 passes (each filtered on its own; an empty one has no
    bytes)."""
    bpp = max(1, ch * depth // 8)  # the filters' byte distance

    def image(data: bytes, pw: int, ph: int) -> np.ndarray:
        row_bytes = -(-pw * ch * depth // 8)
        return _unpack(_unfilter(data, ph, row_bytes, bpp), pw, ch, depth)

    if not interlace:
        return image(raw, w, h)
    passes = [(x0, y0, dx, dy, max(0, -(-(w - x0) // dx)), max(0, -(-(h - y0) // dy)))
              for x0, y0, dx, dy in ADAM7]
    sizes = [ph * (-(-pw * ch * depth // 8) + 1) if pw and ph else 0
             for *_, pw, ph in passes]
    if sum(sizes) != len(raw):
        raise ValueError(f"PNG image data holds {len(raw)} bytes, expected {sum(sizes)} "
                         "for its Adam7 passes")
    out = np.zeros((h, w, ch), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for (x0, y0, dx, dy, pw, ph), n in zip(passes, sizes):
        if n:
            out[y0::dy, x0::dx] = image(raw[pos:pos + n], pw, ph)
            pos += n
    return out


def read_png(path: str) -> Tuple[np.ndarray, int, int, Optional[np.ndarray]]:
    """(samples [H, W, channels], colour type, bit depth, PLTE [n, 3] or
    None) of a PNG file; the samples as ``_samples`` gives them: uint8 up to
    8 bits (palette indices for colour type 3; 1, 2 and 4 bits unscaled),
    uint16 at 16."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path} is not a PNG file")
    header, idat, palette = None, [], None
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"PLTE":
            palette = np.frombuffer(payload[:len(payload) // 3 * 3], np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(payload)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if color not in _CHANNELS:
        raise ValueError(f"{path}: colour type {color} is not a PNG colour type")
    if depth not in _DEPTHS[color]:
        raise ValueError(f"{path}: bit depth {depth} is not valid for colour type {color}")
    if interlace not in (0, 1):
        raise ValueError(f"{path}: interlace method {interlace} is not a PNG method")
    if color == 3 and palette is None:
        raise ValueError(f"{path}: a palette PNG without a PLTE chunk")
    samples = _samples(zlib.decompress(b"".join(idat)), w, h, _CHANNELS[color], depth,
                       interlace)
    return samples, color, depth, palette


def _png_rgb(samples: np.ndarray, color: int, depth: int, palette) -> np.ndarray:
    """A PNG's samples as uint8 RGB, by PIL's rules (the module docstring)."""
    if color == 3:
        table = np.zeros((256, 3), np.uint8)
        table[:len(palette)] = palette[:256]
        return table[samples[..., 0]]
    if depth == 16:
        samples = (np.minimum(samples, 255) if color == 0 else samples >> 8).astype(np.uint8)
    elif depth < 8:
        samples = samples * np.uint8(255 // ((1 << depth) - 1))
    return samples[..., :3] if color in (2, 6) else np.repeat(samples[..., :1], 3, axis=-1)


def _format_of(head: bytes) -> str:
    for magic, name in ((b"GIF8", "GIF"), (b"BM", "BMP"), (b"II*\x00", "TIFF"),
                        (b"MM\x00*", "TIFF"), (b"\x00\x00\x01\x00", "ICO")):
        if head.startswith(magic):
            return name
    if head[:4] == b"RIFF" and head[8:12] == b"WEBP":
        return "WebP"
    return "unknown"


def read_image(path: str) -> np.ndarray:
    """An image file as uint8 RGB [H, W, 3], as PIL's
    ``Image.open(path).convert("RGB")`` gives it: a PNG or a JPEG, by its
    first bytes."""
    with open(path, "rb") as f:
        head = f.read(16)
    if head[:8] == PNG_SIGNATURE:
        return _png_rgb(*read_png(path))
    if head[:3] == b"\xff\xd8\xff":
        with open(path, "rb") as f:
            pixels = jpeg.decode(f.read())
        if pixels.shape[2] == 4:
            return jpeg.cmyk_to_rgb(pixels)
        return pixels if pixels.shape[2] == 3 else np.repeat(pixels, 3, axis=-1)
    raise ValueError(f"{path}: a {_format_of(head)} file is not a PNG or a JPEG, "
                     "the formats read here")


def load_image(path: str) -> np.ndarray:
    """An image file (``read_image``) as RGB float32 [H, W, 3] in [0, 1]."""
    return read_image(path).astype(np.float32) / 255.0


# -- resizing ---------------------------------------------------------------------

PIL_PRECISION_BITS = 22  # Resample.c: 32 - 8 - 2


def _pil_weights(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Resample.c's precompute_coeffs for the bilinear (triangle) filter and
    normalize_coeffs_8bpc: (first input index of each output [out], the
    fixed-point weights [out, ksize])."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale  # the triangle's support, 1, widened on a downscale
    ksize = int(np.ceil(support)) * 2 + 1
    centers = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum((centers - support + 0.5).astype(np.int64), 0)
    count = np.minimum((centers + support + 0.5).astype(np.int64), in_size) - xmin
    k = np.arange(ksize)
    w = np.maximum(1.0 - np.abs((k[None, :] + xmin[:, None] - centers[:, None] + 0.5)
                                / filterscale), 0.0)
    w[k[None, :] >= count[:, None]] = 0.0
    total = np.zeros(out_size)
    for i in range(ksize):  # summed in the C loop's order
        total = total + w[:, i]
    w = np.where(total[:, None] != 0.0, w / np.where(total == 0.0, 1.0, total)[:, None], w)
    fixed = np.trunc(np.where(w < 0, w * (1 << PIL_PRECISION_BITS) - 0.5,
                              w * (1 << PIL_PRECISION_BITS) + 0.5))
    return xmin, fixed.astype(np.int64)


def _pil_pass(a: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    in_size = a.shape[axis]
    xmin, weights = _pil_weights(in_size, out_size)
    a = np.moveaxis(a.astype(np.int64), axis, 0)
    acc = np.full((out_size,) + a.shape[1:], 1 << (PIL_PRECISION_BITS - 1), np.int64)
    shape = (-1,) + (1,) * (a.ndim - 1)
    for i in range(weights.shape[1]):
        acc += a[np.minimum(xmin + i, in_size - 1)] * weights[:, i].reshape(shape)
    out = np.clip(acc >> PIL_PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def pil_bilinear_resize(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """uint8 [H, W, C] -> [h, w, C] for `size` (w, h), as PIL's
    ``Image.resize(size, Image.BILINEAR)``: the horizontal pass, then the
    vertical one on its 8-bit result; an unchanged side is not filtered."""
    w, h = size
    out = np.asarray(img)
    if w != out.shape[1]:
        out = _pil_pass(out, w, 1)
    if h != out.shape[0]:
        out = _pil_pass(out, h, 0)
    return out


def _cv2_weights(in_size: int, out_size: int, clamp: bool):
    """cv2's INTER_LINEAR coefficients: (first tap, second tap, its two
    11-bit weights). `clamp`: the horizontal rule (the weight is reset at
    the borders); the vertical one keeps it and clamps the rows only."""
    f = ((np.arange(out_size) + 0.5) * (in_size / out_size) - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    if clamp:
        border = (s < 0) | (s >= in_size - 1)
        f[border] = 0
    w1 = np.rint(f * np.float32(2048)).astype(np.int64)
    w0 = np.rint((np.float32(1) - f) * np.float32(2048)).astype(np.int64)
    return np.clip(s, 0, in_size - 1), np.clip(s + 1, 0, in_size - 1), w0, w1


def cv2_linear_resize_u8(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """uint8 [H, W, C] -> [h, w, C] for `size` (w, h), as cv2's
    ``resize(img, size)`` (INTER_LINEAR) computes it on uint8."""
    w, h = size
    if (h, w) == np.shape(img)[:2]:  # cv2 copies an image of the size asked
        return np.array(img, np.uint8)
    x = np.asarray(img).astype(np.int64)
    x0, x1, a0, a1 = _cv2_weights(x.shape[1], w, clamp=True)
    y0, y1, b0, b1 = _cv2_weights(x.shape[0], h, clamp=False)
    rows = x[:, x0] * a0[None, :, None] + x[:, x1] * a1[None, :, None]
    b0, b1 = b0[:, None, None], b1[:, None, None]
    out = ((((rows[y0] >> 4) * b0) >> 16) + (((rows[y1] >> 4) * b1) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)
