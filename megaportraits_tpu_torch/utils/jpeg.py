"""Baseline JPEG without PIL (the card's machine has none): a decoder that
gives the pixels PIL gives, and an encoder that writes what PIL writes.

``decode(data)`` reads 8-bit Huffman JPEGs, baseline, extended sequential
and progressive, of 1, 3 or 4 components, any integral sampling factors,
interleaved or not, with restart intervals. A progressive file's scans
(DC first and refinement, AC first with end-of-band runs, AC refinement
with correction bits; jdphuff.c) add up into one coefficient array per
component. It computes as libjpeg(-turbo) does with PIL's settings: the
'islow' integer IDCT (jidctint.c), the "fancy" triangle-filter chroma
upsampling for 2:1 factors (jdsample.c; other integral factors are
replicated), and the fixed-point YCbCr -> RGB tables (jdcolor.c). Four
components are CMYK as PIL reads them (Adobe's inverted samples, no colour
transform), and ``cmyk_to_rgb`` is PIL's ``convert("RGB")`` of them.
Lossless, hierarchical and arithmetic-coded files, YCCK, 12-bit samples,
2 components and a progressive file that leaves a low coefficient
unrefined (libjpeg would smooth its blocks) raise ``ValueError`` naming
what they are.

``encode(rgb, quality=75)`` writes a baseline JFIF file as PIL's default
``Image.save(path, "JPEG")`` does: quality 75 scaling of the standard
tables, 4:2:0, the standard Huffman tables, no restart markers, with
libjpeg's fixed-point RGB -> YCbCr, its 2x2 downsampling with alternating
rounding bias, the 'islow' integer forward DCT (jfdctint.c) and its
reciprocal quantisation (jcdctmgr.c), dummy edge blocks included.

The transforms run on every block at once in numpy; only the Huffman
decoder walks the bits in Python (its seconds per image are in PERF.md).
"""

from __future__ import annotations

import re
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

# Zigzag position -> natural (row-major) index (jpeg_natural_order).
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63], np.int64)

# The standard quantisation tables (ITU T.81 Annex K.1), natural order.
STD_LUMINANCE_QUANT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99], np.int64)
STD_CHROMINANCE_QUANT = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99], np.int64)

# The standard Huffman tables (Annex K.3): (code counts by length 1..16, symbols).
STD_HUFFMAN = {
    "dc_luminance": (
        [0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12))),
    "dc_chrominance": (
        [0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12))),
    "ac_luminance": (
        [0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d], bytes.fromhex(
            "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
            "2433627282090a161718191a25262728292a3435363738393a434445464748494a"
            "535455565758595a636465666768696a737475767778797a838485868788898a"
            "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7"
            "c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa")),
    "ac_chrominance": (
        [0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], bytes.fromhex(
            "000102031104052131061241510761711322328108144291a1b1c109233352f0"
            "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
            "494a535455565758595a636465666768696a737475767778797a828384858687"
            "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
            "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa")),
}

# The SOF markers this module does not read, by what they are.
_UNSUPPORTED_SOF = {
    0xC3: "lossless JPEG",
    0xC5: "hierarchical JPEG", 0xC6: "hierarchical progressive JPEG",
    0xC7: "hierarchical lossless JPEG", 0xC9: "arithmetic-coded JPEG",
    0xCA: "arithmetic-coded progressive JPEG", 0xCB: "arithmetic-coded lossless JPEG",
    0xCD: "arithmetic-coded hierarchical JPEG",
    0xCE: "arithmetic-coded hierarchical progressive JPEG",
    0xCF: "arithmetic-coded hierarchical lossless JPEG",
}

# Fixed-point constants of libjpeg's integer DCTs (CONST_BITS 13).
CONST_BITS, PASS1_BITS = 13, 2
FIX_0_298631336, FIX_0_390180644, FIX_0_541196100 = 2446, 3196, 4433
FIX_0_765366865, FIX_0_899976223, FIX_1_175875602 = 6270, 7373, 9633
FIX_1_501321110, FIX_1_847759065, FIX_1_961570560 = 12299, 15137, 16069
FIX_2_053119869, FIX_2_562915447, FIX_3_072711026 = 16819, 20995, 25172


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _descale(x: np.ndarray, n: int) -> np.ndarray:
    return (x + (1 << (n - 1))) >> n


def _huffman_codes(counts: List[int], symbols) -> Dict[int, Tuple[int, int]]:
    """symbol -> (code, length), the canonical codes of Annex C."""
    codes, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            codes[symbols[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


def _lookup_table(counts: List[int], symbols) -> List[int]:
    """The 16-bit look-ahead table: the next 16 bits of the stream ->
    (code length << 8) | symbol; 0 where no code matches."""
    table = [0] * 65536
    for symbol, (code, length) in _huffman_codes(counts, symbols).items():
        first = code << (16 - length)
        table[first:first + (1 << (16 - length))] = \
            [(length << 8) | symbol] * (1 << (16 - length))
    return table


# -- decoding ---------------------------------------------------------------------


# libjpeg-turbo smooths a progressive file's blocks (jdcoefct.c) while the
# DC or one of the first SAVED_COEFS coefficients (zigzag order) is not
# refined to its last bit.
SAVED_COEFS = 10


class _Component:
    def __init__(self, ident: int, h: int, v: int, tq: int):
        self.ident, self.h, self.v, self.tq = ident, h, v, tq
        self.td = self.ta = 0  # its DC and AC Huffman tables, set by a scan
        self.coef: Optional[np.ndarray] = None  # [rows, cols, 64] natural order
        # A progressive file's coefficients as a flat list (each scan reads
        # and writes single values), and each zigzag coefficient's last
        # successive-approximation bit, -1 before its first scan.
        self.flat: Optional[List[int]] = None
        self.coef_bits = [-1] * 64


def _entropy_segments(data: bytes, pos: int) -> Tuple[List[bytes], int]:
    """The entropy-coded data from `pos` to the next marker that is no
    restart marker: its restart intervals, byte stuffing undone, and the
    position of that marker."""
    end = pos
    while True:
        j = data.find(b"\xff", end)
        if j < 0 or j + 1 >= len(data):
            end = len(data)
            break
        nxt = data[j + 1]
        if nxt == 0 or 0xD0 <= nxt <= 0xD7:
            end = j + 2
            continue
        end = j
        break
    segments = re.split(rb"\xff[\xd0-\xd7]", data[pos:end])
    return [s.replace(b"\xff\x00", b"\xff") for s in segments], end


def _windows(segment: bytes) -> List[int]:
    """32-bit big-endian windows at every byte of `segment` (zero-padded,
    as libjpeg fills a stream that ends early)."""
    b = np.frombuffer(segment + b"\x00" * 8, np.uint8).astype(np.int64)
    n = len(segment) + 4
    return ((b[:n] << 24) | (b[1:n + 1] << 16) | (b[2:n + 2] << 8) | b[3:n + 3]).tolist()


def _decode_scan(segments: List[bytes], comps: List[_Component], tables: dict,
                 restart_interval: int, mcus: Tuple[int, int]) -> None:
    """Huffman-decode one sequential scan into each component's `coef`
    (quantised values, natural order)."""
    mcu_rows, mcu_cols = mcus
    # The blocks of one MCU: (component, row, column offset in blocks).
    units = [(ci, y, x) for ci, c in enumerate(comps)
             for y in range(c.v if len(comps) > 1 else 1)
             for x in range(c.h if len(comps) > 1 else 1)]
    dc_tabs = [tables["dc", c.td] for c in comps]
    ac_tabs = [tables["ac", c.ta] for c in comps]
    flat = [c.coef.reshape(-1) for c in comps]
    strides = [c.coef.shape[1] * 64 for c in comps]
    hv = [(c.v, c.h) if len(comps) > 1 else (1, 1) for c in comps]
    zz = ZIGZAG.tolist()
    idx = [[] for _ in comps]
    vals = [[] for _ in comps]
    preds = [0] * len(comps)
    seg_i, w, p = 0, _windows(segments[0]), 0
    n_mcus = mcu_rows * mcu_cols
    for m in range(n_mcus):
        if restart_interval and m and m % restart_interval == 0:
            seg_i += 1
            if seg_i >= len(segments):
                raise ValueError("JPEG data ends before its last restart interval")
            w, p, preds = _windows(segments[seg_i]), 0, [0] * len(comps)
        my, mx = divmod(m, mcu_cols)
        for ci, y, x in units:
            v, h = hv[ci]
            base = (my * v + y) * strides[ci] + (mx * h + x) * 64
            dc_tab, ac_tab, ix, vl = dc_tabs[ci], ac_tabs[ci], idx[ci], vals[ci]
            code = dc_tab[((w[p >> 3] << (p & 7)) >> 16) & 0xFFFF]
            if not code:
                raise ValueError("corrupt JPEG data: no Huffman code matches")
            p += code >> 8
            s = code & 0xFF
            diff = 0
            if s:
                diff = ((w[p >> 3] << (p & 7)) >> (32 - s)) & ((1 << s) - 1)
                p += s
                if diff < (1 << (s - 1)):
                    diff -= (1 << s) - 1
            preds[ci] += diff
            ix.append(base)
            vl.append(preds[ci])
            k = 1
            while k < 64:
                code = ac_tab[((w[p >> 3] << (p & 7)) >> 16) & 0xFFFF]
                if not code:
                    raise ValueError("corrupt JPEG data: no Huffman code matches")
                p += code >> 8
                s = code & 15
                r = (code >> 4) & 15
                if s:
                    k += r
                    if k > 63:
                        raise ValueError("corrupt JPEG data: a run past the block's end")
                    val = ((w[p >> 3] << (p & 7)) >> (32 - s)) & ((1 << s) - 1)
                    p += s
                    if val < (1 << (s - 1)):
                        val -= (1 << s) - 1
                    ix.append(base + zz[k])
                    vl.append(val)
                    k += 1
                elif r == 15:
                    k += 16
                else:
                    break
            if (p >> 3) >= len(w):
                raise ValueError("JPEG entropy-coded data ends early")
    for f, ix, vl in zip(flat, idx, vals):
        f[np.asarray(ix, np.int64)] = np.asarray(vl, np.int64)


def _decode_progressive_scan(segments: List[bytes], comps: List[_Component], tables: dict,
                             restart_interval: int, mcus: Tuple[int, int],
                             ss: int, se: int, ah: int, al: int) -> None:
    """Huffman-decode one progressive scan (spectral band ss..se, successive
    approximation bits ah -> al) into each component's `flat` list, as
    jdphuff.c does: DC first (the DC difference, shifted left by al), DC
    refinement (one bit), AC first (runs, values shifted by al, end-of-band
    runs across blocks), AC refinement (new coefficients of +-1 << al, one
    correction bit for each coefficient already nonzero)."""
    mcu_rows, mcu_cols = mcus
    many = len(comps) > 1
    units = [(ci, y, x) for ci, c in enumerate(comps)
             for y in range(c.v if many else 1) for x in range(c.h if many else 1)]
    hv = [(c.v, c.h) if many else (1, 1) for c in comps]
    strides = [c.coef.shape[1] * 64 for c in comps]
    flats = [c.flat for c in comps]
    dc_tabs = [tables.get(("dc", c.td)) for c in comps]
    ac_tabs = [tables.get(("ac", c.ta)) for c in comps]
    zz = ZIGZAG.tolist()
    p1, m1 = 1 << al, -(1 << al)
    seg_i, w, p = 0, _windows(segments[0]), 0
    preds, eobrun = [0] * len(comps), 0
    for m in range(mcu_rows * mcu_cols):
        if restart_interval and m and m % restart_interval == 0:
            seg_i += 1
            if seg_i >= len(segments):
                raise ValueError("JPEG data ends before its last restart interval")
            w, p, preds, eobrun = _windows(segments[seg_i]), 0, [0] * len(comps), 0
        my, mx = divmod(m, mcu_cols)
        for ci, y, x in units:
            v, h = hv[ci]
            base = (my * v + y) * strides[ci] + (mx * h + x) * 64
            f = flats[ci]
            if ss == 0 and ah == 0:  # DC first
                code = dc_tabs[ci][((w[p >> 3] << (p & 7)) >> 16) & 0xFFFF]
                if not code:
                    raise ValueError("corrupt JPEG data: no Huffman code matches")
                p += code >> 8
                s = code & 0xFF
                if s:
                    diff = ((w[p >> 3] << (p & 7)) >> (32 - s)) & ((1 << s) - 1)
                    p += s
                    if diff < (1 << (s - 1)):
                        diff -= (1 << s) - 1
                    preds[ci] += diff
                f[base] = preds[ci] * p1
            elif ss == 0:  # DC refinement: one bit
                if (w[p >> 3] >> (31 - (p & 7))) & 1:
                    f[base] |= p1
                p += 1
            elif ah == 0:  # AC first
                if eobrun:
                    eobrun -= 1
                    continue
                tab, k = ac_tabs[ci], ss
                while k <= se:
                    code = tab[((w[p >> 3] << (p & 7)) >> 16) & 0xFFFF]
                    if not code:
                        raise ValueError("corrupt JPEG data: no Huffman code matches")
                    p += code >> 8
                    r, s = (code >> 4) & 15, code & 15
                    if s:
                        k += r
                        if k > 63:
                            raise ValueError("corrupt JPEG data: a run past the block's end")
                        val = ((w[p >> 3] << (p & 7)) >> (32 - s)) & ((1 << s) - 1)
                        p += s
                        if val < (1 << (s - 1)):
                            val -= (1 << s) - 1
                        f[base + zz[k]] = val * p1
                    elif r == 15:
                        k += 15
                    else:
                        eobrun = 1 << r
                        if r:
                            eobrun += ((w[p >> 3] << (p & 7)) >> (32 - r)) & ((1 << r) - 1)
                            p += r
                        eobrun -= 1
                        break
                    k += 1
            else:  # AC refinement
                k = ss
                if not eobrun:
                    tab = ac_tabs[ci]
                    while k <= se:
                        code = tab[((w[p >> 3] << (p & 7)) >> 16) & 0xFFFF]
                        if not code:
                            raise ValueError("corrupt JPEG data: no Huffman code matches")
                        p += code >> 8
                        r, s = (code >> 4) & 15, code & 15
                        if s:
                            s = p1 if (w[p >> 3] >> (31 - (p & 7))) & 1 else m1
                            p += 1
                        elif r != 15:
                            eobrun = 1 << r
                            if r:
                                eobrun += ((w[p >> 3] << (p & 7)) >> (32 - r)) & ((1 << r) - 1)
                                p += r
                            break
                        # Pass the nonzero coefficients (a correction bit each)
                        # and r zero ones; the new value goes at the next zero.
                        while k <= se:
                            pos = base + zz[k]
                            c = f[pos]
                            if c:
                                if (w[p >> 3] >> (31 - (p & 7))) & 1 and not c & p1:
                                    f[pos] = c + p1 if c >= 0 else c + m1
                                p += 1
                            else:
                                if r == 0:
                                    break
                                r -= 1
                            k += 1
                        if s:
                            if k > 63:
                                raise ValueError("corrupt JPEG data: a run past the block's end")
                            f[base + zz[k]] = s
                        k += 1
                if eobrun:  # the rest of the band: correction bits only
                    while k <= se:
                        pos = base + zz[k]
                        c = f[pos]
                        if c:
                            if (w[p >> 3] >> (31 - (p & 7))) & 1 and not c & p1:
                                f[pos] = c + p1 if c >= 0 else c + m1
                            p += 1
                        k += 1
                    eobrun -= 1
            if (p >> 3) >= len(w):
                raise ValueError("JPEG entropy-coded data ends early")


def _idct_1d(x: List[np.ndarray]) -> List[np.ndarray]:
    """jidctint.c's 1-D pass on the 8 inputs x[0..7] (arrays), before its
    final descale: returns the 8 outputs scaled by 2**CONST_BITS."""
    z2, z3 = x[2], x[6]
    z1 = (z2 + z3) * FIX_0_541196100
    tmp2 = z1 - z3 * FIX_1_847759065
    tmp3 = z1 + z2 * FIX_0_765366865
    tmp0 = (x[0] + x[4]) << CONST_BITS
    tmp1 = (x[0] - x[4]) << CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * FIX_1_175875602
    t0 = t0 * FIX_0_298631336
    t1 = t1 * FIX_2_053119869
    t2 = t2 * FIX_3_072711026
    t3 = t3 * FIX_1_501321110
    z1 = z1 * -FIX_0_899976223
    z2 = z2 * -FIX_2_562915447
    z3 = z3 * -FIX_1_961570560 + z5
    z4 = z4 * -FIX_0_390180644 + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    return [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
            tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]


# IDCT output -> sample: libjpeg's range-limit table, indexed by the value & 1023.
_RANGE_LIMIT = np.concatenate([np.arange(128, 256), np.full(384, 255), np.zeros(384),
                               np.arange(0, 128)]).astype(np.uint8)


def idct_islow(coef: np.ndarray) -> np.ndarray:
    """Dequantised coefficients [..., 8, 8] (natural order) -> uint8
    samples [..., 8, 8], as jidctint.c computes them."""
    c = coef.astype(np.int64)
    cols = _idct_1d([c[..., k, :] for k in range(8)])  # over the rows index
    ws = np.stack([_descale(v, CONST_BITS - PASS1_BITS) for v in cols], axis=-2)
    rows = _idct_1d([ws[..., k] for k in range(8)])
    out = np.stack([_descale(v, CONST_BITS + PASS1_BITS + 3) for v in rows], axis=-1)
    return _RANGE_LIMIT[out & 1023]


def _blocks_to_plane(blocks: np.ndarray) -> np.ndarray:
    """[rows, cols, 8, 8] -> [rows * 8, cols * 8]."""
    r, c = blocks.shape[:2]
    return blocks.transpose(0, 2, 1, 3).reshape(r * 8, c * 8)


def _fancy_h2(x: np.ndarray, width: int) -> np.ndarray:
    """h2v1_fancy_upsample on the first `width` columns of int rows x."""
    x = x[:, :width].astype(np.int64)
    left = np.concatenate([x[:, :1], x[:, :-1]], axis=1)
    right = np.concatenate([x[:, 1:], x[:, -1:]], axis=1)
    out = np.empty((x.shape[0], 2 * width), np.int64)
    out[:, 0::2] = (3 * x + left + 1) >> 2
    out[:, 1::2] = (3 * x + right + 2) >> 2
    out[:, 0], out[:, -1] = x[:, 0], x[:, -1]
    return out


def _fancy_h2v2(x: np.ndarray, width: int, height: int) -> np.ndarray:
    """h2v2_fancy_upsample: rows weighted 3:1 with their neighbour above
    (even output rows) or below (odd), then columns 3:1, rounding 8 / 7."""
    x = x[:height, :width].astype(np.int64)
    above = np.concatenate([x[:1], x[:-1]], axis=0)
    below = np.concatenate([x[1:], x[-1:]], axis=0)
    out = np.empty((2 * height, 2 * width), np.int64)
    for r, near in ((0, above), (1, below)):
        s = 3 * x + near  # the column sums
        left = np.concatenate([s[:, :1], s[:, :-1]], axis=1)
        right = np.concatenate([s[:, 1:], s[:, -1:]], axis=1)
        even = (3 * s + left + 8) >> 4
        odd = (3 * s + right + 7) >> 4
        even[:, 0] = (4 * s[:, 0] + 8) >> 4
        odd[:, -1] = (4 * s[:, -1] + 7) >> 4
        out[r::2, 0::2], out[r::2, 1::2] = even, odd
    return out


def _fancy_v2(x: np.ndarray, width: int, height: int) -> np.ndarray:
    """h1v2_fancy_upsample: rows 3:1 with the row above (bias 1) or below
    (bias 2)."""
    x = x[:height, :width].astype(np.int64)
    above = np.concatenate([x[:1], x[:-1]], axis=0)
    below = np.concatenate([x[1:], x[-1:]], axis=0)
    out = np.empty((2 * height, width), np.int64)
    out[0::2] = (3 * x + above + 1) >> 2
    out[1::2] = (3 * x + below + 2) >> 2
    return out


def _upsample(plane: np.ndarray, comp: _Component, hmax: int, vmax: int,
              width: int, height: int) -> np.ndarray:
    """A component's samples at the image's size, as jdsample.c makes them."""
    fh, fv = hmax // comp.h, vmax // comp.v
    dw = _ceil_div(width * comp.h, hmax)  # downsampled_width
    dh = _ceil_div(height * comp.v, vmax)
    if fh == 1 and fv == 1:
        out = plane
    elif fh == 2 and fv == 1 and dw > 2:
        out = _fancy_h2(plane[:dh], dw)
    elif fh == 2 and fv == 2 and dw > 2:
        out = _fancy_h2v2(plane, dw, dh)
    elif fh == 1 and fv == 2:
        out = _fancy_v2(plane, dw, dh)
    else:  # int_upsample / h2v1_upsample / h2v2_upsample: replicate
        out = np.repeat(np.repeat(plane[:dh, :dw], fv, axis=0), fh, axis=1)
    return out[:height, :width].astype(np.int64)


def _ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """jdcolor.c's ycc_rgb_convert (fixed point, 16 fraction bits)."""
    one_half = 1 << 15
    cb, cr = cb - 128, cr - 128
    r = y + ((91881 * cr + one_half) >> 16)           # FIX(1.40200)
    b = y + ((116130 * cb + one_half) >> 16)          # FIX(1.77200)
    g = y + ((-46802 * cr + (-22554 * cb + one_half)) >> 16)  # FIX(0.71414), FIX(0.34414)
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def decode(data: bytes) -> np.ndarray:
    """A JPEG file's pixels as PIL decodes them: uint8 [H, W, 3] RGB,
    [H, W, 1] for a grayscale file or [H, W, 4] CMYK for four components."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file (no SOI marker)")
    pos = 2
    qtables: Dict[int, np.ndarray] = {}
    tables: dict = {}
    comps: List[_Component] = []
    size = None
    restart_interval = 0
    adobe_transform = None
    progressive = False
    scanned = False
    while pos < len(data):
        if data[pos] != 0xFF:
            raise ValueError(f"corrupt JPEG: expected a marker at byte {pos}")
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1
        marker = data[pos]
        pos += 1
        if marker == 0xD9:  # EOI
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        (length,) = struct.unpack(">H", data[pos:pos + 2])
        body = data[pos + 2:pos + length]
        pos += length
        if marker in _UNSUPPORTED_SOF:
            raise ValueError(f"{_UNSUPPORTED_SOF[marker]} is not supported "
                             "(baseline only)")
        if marker == 0xCC:
            raise ValueError("arithmetic-coded JPEG is not supported (baseline only)")
        if marker == 0xDB:  # DQT
            k = 0
            while k < len(body):
                pq, tq = body[k] >> 4, body[k] & 15
                n = 64 * (2 if pq else 1)
                raw = np.frombuffer(body[k + 1:k + 1 + n], ">u2" if pq else np.uint8)
                table = np.zeros(64, np.int64)
                table[ZIGZAG] = raw
                qtables[tq] = table
                k += 1 + n
        elif marker == 0xC4:  # DHT
            k = 0
            while k < len(body):
                tc, th = body[k] >> 4, body[k] & 15
                counts = list(body[k + 1:k + 17])
                symbols = body[k + 17:k + 17 + sum(counts)]
                tables["ac" if tc else "dc", th] = _lookup_table(counts, symbols)
                k += 17 + sum(counts)
        elif marker in (0xC0, 0xC1, 0xC2):  # baseline, extended sequential, progressive
            progressive = marker == 0xC2
            precision, height, width, nf = struct.unpack(">BHHB", body[:6])
            if precision != 8:
                raise ValueError(f"{precision}-bit JPEG samples are not supported (8 only)")
            if nf not in (1, 3, 4):
                raise ValueError(f"a JPEG of {nf} components is not supported (1, 3 or 4)")
            if height == 0:
                raise ValueError("a JPEG whose height comes in a DNL marker is not supported")
            for c in range(nf):
                ident, hv, tq = body[6 + 3 * c:9 + 3 * c]
                comps.append(_Component(ident, hv >> 4, hv & 15, tq))
            size = (height, width)
            hmax = max(c.h for c in comps)
            vmax = max(c.v for c in comps)
            mcu_rows, mcu_cols = _ceil_div(height, 8 * vmax), _ceil_div(width, 8 * hmax)
            for c in comps:
                if hmax % c.h or vmax % c.v:
                    raise ValueError(f"JPEG sampling factors {c.h}x{c.v} of {hmax}x{vmax} "
                                     "are not integral ratios")
                c.coef = np.zeros((mcu_rows * c.v, mcu_cols * c.h, 64), np.int64)
                if progressive:
                    c.flat = [0] * c.coef.size
        elif marker == 0xDD:  # DRI
            (restart_interval,) = struct.unpack(">H", body[:2])
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe_transform = body[11]
        elif marker == 0xDA:  # SOS
            if size is None:
                raise ValueError("corrupt JPEG: a scan before the frame header")
            ns = body[0]
            scan = []
            for c in range(ns):
                ident, t = body[1 + 2 * c:3 + 2 * c]
                comp = next((x for x in comps if x.ident == ident), None)
                if comp is None:
                    raise ValueError(f"corrupt JPEG: scan component {ident} not in the frame")
                comp.td, comp.ta = t >> 4, t & 15
                scan.append(comp)
            ss, se, ah, al = body[1 + 2 * ns], body[2 + 2 * ns], body[3 + 2 * ns] >> 4, \
                body[3 + 2 * ns] & 15
            if progressive:
                _check_progressive_scan(scan, ss, se, ah, al)
            # A progressive scan codes with one table at most: DC first
            # with the DC table, an AC scan with the AC one.
            uses_dc = not progressive or (ss == 0 and ah == 0)
            uses_ac = not progressive or se > 0
            for comp in scan:
                for key in [("dc", comp.td)] * uses_dc + [("ac", comp.ta)] * uses_ac:
                    if key not in tables:
                        raise ValueError(f"corrupt JPEG: no {key[0].upper()} Huffman "
                                         f"table {key[1]}")
            segments, pos = _entropy_segments(data, pos)
            if ns > 1:
                mcus = (mcu_rows, mcu_cols)
            else:  # a non-interleaved scan walks the component's own blocks
                c = scan[0]
                mcus = (_ceil_div(_ceil_div(size[0] * c.v, vmax), 8),
                        _ceil_div(_ceil_div(size[1] * c.h, hmax), 8))
            if progressive:
                _decode_progressive_scan(segments, scan, tables, restart_interval, mcus,
                                         ss, se, ah, al)
            else:
                _decode_scan(segments, scan, tables, restart_interval, mcus)
            scanned = True
        elif marker in (0xC8,) or 0xF0 <= marker <= 0xFD:
            raise ValueError(f"JPEG marker 0x{marker:02X} (an extension) is not supported")
    if not scanned:
        raise ValueError("JPEG file holds no scan")
    height, width = size
    if len(comps) == 4 and adobe_transform == 2:
        raise ValueError("a YCCK JPEG (Adobe transform 2) is not supported (CMYK only)")
    planes = []
    for c in comps:
        if c.tq not in qtables:
            raise ValueError(f"corrupt JPEG: no quantisation table {c.tq}")
        if progressive:
            if any(b != 0 for b in c.coef_bits[:SAVED_COEFS]):
                raise ValueError("a progressive JPEG whose scans leave a low coefficient "
                                 "unrefined is not supported (libjpeg smooths its blocks)")
            c.coef = np.array(c.flat, np.int64).reshape(c.coef.shape)
        rows, cols = c.coef.shape[:2]
        samples = idct_islow((c.coef * qtables[c.tq]).reshape(rows, cols, 8, 8))
        planes.append(_upsample(_blocks_to_plane(samples), c, hmax, vmax, width, height))
    if len(comps) == 1:
        return planes[0].astype(np.uint8)[..., None]
    if len(comps) == 4:  # PIL reads CMYK as Adobe writes it: inverted
        return (255 - np.stack(planes, axis=-1)).astype(np.uint8)
    if adobe_transform == 0:  # stored as RGB
        return np.stack(planes, axis=-1).astype(np.uint8)
    return _ycc_to_rgb(*planes)


def _check_progressive_scan(scan: List[_Component], ss: int, se: int, ah: int,
                            al: int) -> None:
    """jdphuff.c's start_pass_phuff_decoder checks, and each coefficient's
    successive-approximation bits carried forward."""
    if (ss == 0 and se != 0) or (ss > 0 and (se < ss or se > 63 or len(scan) != 1)) \
            or (ah and al != ah - 1) or al > 13:
        raise ValueError(f"corrupt progressive JPEG: a scan of band {ss}..{se}, bits "
                         f"{ah} -> {al}, over {len(scan)} components")
    for c in scan:
        for k in range(ss, se + 1):
            expected = -1 if ah == 0 else ah
            if c.coef_bits[k] != expected:
                raise ValueError(f"corrupt progressive JPEG: coefficient {k} refined "
                                 f"from bit {ah} after bit {c.coef_bits[k]}")
            c.coef_bits[k] = al


def cmyk_to_rgb(cmyk: np.ndarray) -> np.ndarray:
    """uint8 [..., 4] CMYK -> [..., 3] RGB, as PIL's ``convert("RGB")``
    (Convert.c's cmyk2rgb: nk - MULDIV255(c, nk), nk = 255 - k)."""
    c = cmyk.astype(np.int64)
    nk = 255 - c[..., 3:4]
    t = c[..., :3] * nk + 128
    return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)


# -- encoding ---------------------------------------------------------------------


def quality_tables(quality: int) -> Tuple[np.ndarray, np.ndarray]:
    """libjpeg's jpeg_set_quality: the standard tables scaled, baseline
    (values in 1..255)."""
    quality = min(max(quality, 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return tuple(np.clip((t * scale + 50) // 100, 1, 255)
                 for t in (STD_LUMINANCE_QUANT, STD_CHROMINANCE_QUANT))


def _rgb_to_ycc(rgb: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """jccolor.c's rgb_ycc_convert (fixed point, 16 fraction bits; Cb and
    Cr rounded with 0.5 - epsilon)."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    one_half = 1 << 15
    cbcr_offset = 128 << 16
    y = (19595 * r + 38470 * g + 7471 * b + one_half) >> 16
    cb = (-11059 * r - 21709 * g + 32768 * b + cbcr_offset + one_half - 1) >> 16
    cr = (32768 * r - 27439 * g - 5329 * b + cbcr_offset + one_half - 1) >> 16
    return y, cb, cr


def _fdct_1d(x: List[np.ndarray], last: bool) -> List[np.ndarray]:
    """jfdctint.c's 1-D pass (rows first, then columns with `last`)."""
    tmp0, tmp7 = x[0] + x[7], x[0] - x[7]
    tmp1, tmp6 = x[1] + x[6], x[1] - x[6]
    tmp2, tmp5 = x[2] + x[5], x[2] - x[5]
    tmp3, tmp4 = x[3] + x[4], x[3] - x[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    shift = CONST_BITS + PASS1_BITS if last else CONST_BITS - PASS1_BITS
    out: List[Optional[np.ndarray]] = [None] * 8
    if last:
        out[0] = _descale(tmp10 + tmp11, PASS1_BITS)
        out[4] = _descale(tmp10 - tmp11, PASS1_BITS)
    else:
        out[0] = (tmp10 + tmp11) << PASS1_BITS
        out[4] = (tmp10 - tmp11) << PASS1_BITS
    z1 = (tmp12 + tmp13) * FIX_0_541196100
    out[2] = _descale(z1 + tmp13 * FIX_0_765366865, shift)
    out[6] = _descale(z1 - tmp12 * FIX_1_847759065, shift)
    z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * FIX_1_175875602
    tmp4 = tmp4 * FIX_0_298631336
    tmp5 = tmp5 * FIX_2_053119869
    tmp6 = tmp6 * FIX_3_072711026
    tmp7 = tmp7 * FIX_1_501321110
    z1 = z1 * -FIX_0_899976223
    z2 = z2 * -FIX_2_562915447
    z3 = z3 * -FIX_1_961570560 + z5
    z4 = z4 * -FIX_0_390180644 + z5
    out[7] = _descale(tmp4 + z1 + z3, shift)
    out[5] = _descale(tmp5 + z2 + z4, shift)
    out[3] = _descale(tmp6 + z2 + z3, shift)
    out[1] = _descale(tmp7 + z1 + z4, shift)
    return out


def fdct_islow(samples: np.ndarray) -> np.ndarray:
    """uint8 samples [..., 8, 8] -> jfdctint.c's output (scaled by 8)."""
    x = samples.astype(np.int64) - 128
    rows = _fdct_1d([x[..., k] for k in range(8)], last=False)
    ws = np.stack(rows, axis=-1)
    cols = _fdct_1d([ws[..., k, :] for k in range(8)], last=True)
    return np.stack(cols, axis=-2)


def _reciprocal(divisor: int) -> Tuple[int, int, int]:
    """jcdctmgr.c's compute_reciprocal for 16-bit DCT elements:
    (reciprocal, correction, total shift)."""
    if divisor == 1:
        return 1, 0, 0
    b = divisor.bit_length() - 1
    r = 16 + b
    fq, fr = divmod(1 << r, divisor)
    c = divisor // 2
    if fr == 0:
        fq >>= 1
        r -= 1
    elif fr <= divisor // 2:
        c += 1
    else:
        fq += 1
    return fq, c, r


def quantize(dct: np.ndarray, table: np.ndarray) -> np.ndarray:
    """jcdctmgr.c's quantize: |x| times the reciprocal of 8 * q, the sign
    put back; `dct` [..., 64] natural order."""
    params = np.array([_reciprocal(int(q) << 3) for q in table], np.int64)
    fq, c, r = params[:, 0], params[:, 1], params[:, 2]
    mag = ((np.abs(dct) + c) * fq) >> r
    return np.where(dct < 0, -mag, mag)


def _pad_edge(plane: np.ndarray, rows: int, cols: int) -> np.ndarray:
    return np.pad(plane, ((0, rows - plane.shape[0]), (0, cols - plane.shape[1])),
                  mode="edge")


def _component_blocks(plane: np.ndarray, table: np.ndarray, wib: int, hib: int,
                      h: int, v: int, mcu_rows: int, mcu_cols: int) -> np.ndarray:
    """A component's quantised blocks [mcu_rows * v, mcu_cols * h, 64] (natural
    order): the real ones from `plane` (padded), and jccoefct.c's dummy blocks
    past its edges (AC zero, DC the DC before them in the MCU)."""
    real = plane[:hib * 8, :wib * 8].reshape(hib, 8, wib, 8).transpose(0, 2, 1, 3)
    coef = quantize(fdct_islow(real).reshape(hib, wib, 64), table)
    out = np.zeros((mcu_rows * v, mcu_cols * h, 64), np.int64)
    out[:hib, :wib] = coef
    out[:hib, wib:, 0] = out[:hib, wib - 1:wib, 0]
    for row in range(hib, mcu_rows * v):  # dummy rows of the last MCU row
        last = out[row - 1, h - 1::h, 0]
        out[row, :, 0] = np.repeat(last, h)
    return out


def _pack_bits(values: np.ndarray, lengths: np.ndarray) -> bytes:
    """Concatenate the `lengths`-bit codes `values` MSB first; the last
    byte padded with 1 bits."""
    offsets = np.cumsum(lengths) - lengths
    total = int(offsets[-1] + lengths[-1]) if len(lengths) else 0
    words = np.zeros(total // 64 + 2, np.uint64)
    word, bit = offsets >> 6, offsets & 63
    end = bit + lengths
    fits = end <= 64
    v = values.astype(np.uint64)
    np.add.at(words, word[fits], v[fits] << (64 - end[fits]).astype(np.uint64))
    spill = ~fits
    over = (end[spill] - 64).astype(np.uint64)
    np.add.at(words, word[spill], v[spill] >> over)
    np.add.at(words, word[spill] + 1,
              (v[spill] & ((np.uint64(1) << over) - np.uint64(1))) << (np.uint64(64) - over))
    pad = (-total) % 8
    if pad:
        w, b = divmod(total, 64)
        words[w] |= np.uint64((1 << pad) - 1) << np.uint64(64 - b - pad)
    return words.astype(">u8").tobytes()[:(total + pad) // 8]


def _huffman_arrays(name: str) -> Tuple[np.ndarray, np.ndarray]:
    """symbol -> code, symbol -> length, as arrays over 256 symbols."""
    codes = _huffman_codes(*STD_HUFFMAN[name])
    code, length = np.zeros(256, np.int64), np.zeros(256, np.int64)
    for s, (c, n) in codes.items():
        code[s], length[s] = c, n
    return code, length


def _magnitude(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(category, the category's extra bits) of each value (Annex F.1.2)."""
    size = np.zeros(x.shape, np.int64)
    m = np.abs(x)
    while m.any():
        size += m > 0
        m >>= 1
    extra = np.where(x < 0, x + (1 << size) - 1, x)
    return size, extra


def _entropy_code(blocks: np.ndarray, comp_ids: np.ndarray) -> bytes:
    """Huffman-code the blocks [N, 64] (natural order, scan order) of the
    components `comp_ids` [N] with the standard tables: luminance for
    component 0, chrominance for the others."""
    n = len(blocks)
    zz = blocks[:, ZIGZAG]
    dc_code, dc_len = np.stack([_huffman_arrays("dc_luminance"),
                                _huffman_arrays("dc_chrominance")], axis=1)
    ac_code, ac_len = np.stack([_huffman_arrays("ac_luminance"),
                                _huffman_arrays("ac_chrominance")], axis=1)
    table = (comp_ids > 0).astype(np.int64)
    keys, vals, lens = [], [], []

    # DC: the difference from the component's previous block.
    dc = zz[:, 0]
    diff = np.empty(n, np.int64)
    for ci in np.unique(comp_ids):
        sel = np.nonzero(comp_ids == ci)[0]
        diff[sel] = np.diff(dc[sel], prepend=0)
    size, extra = _magnitude(diff)
    keys.append(np.arange(n) * 512)
    vals.append((dc_code[table, size] << size) | extra)
    lens.append(dc_len[table, size] + size)

    # AC: (run, size) symbols, ZRLs before a run of 16 or more, EOB.
    b, k = np.nonzero(zz[:, 1:])
    k = k + 1
    start = np.r_[True, b[1:] != b[:-1]]
    prev_k = np.where(start, 0, np.r_[0, k[:-1]])
    run = k - prev_k - 1
    size, extra = _magnitude(zz[b, k])
    t = table[b]
    sym = ((run & 15) << 4) | size
    keys.append(b * 512 + k * 4 + 3)
    vals.append((ac_code[t, sym] << size) | extra)
    lens.append(ac_len[t, sym] + size)
    for z in range(3):  # up to 3 ZRLs (runs of 16) before a coefficient
        sel = run >= 16 * (z + 1)
        keys.append(b[sel] * 512 + k[sel] * 4 + z)
        vals.append(ac_code[t[sel], 0xF0])
        lens.append(ac_len[t[sel], 0xF0])
    last = np.full(n, 0, np.int64)
    if len(b):
        ends = np.r_[b[1:] != b[:-1], True]
        last[b[ends]] = k[ends]
    eob = np.nonzero(last < 63)[0]
    keys.append(eob * 512 + 64 * 4)
    vals.append(ac_code[table[eob], 0x00])
    lens.append(ac_len[table[eob], 0x00])

    keys, vals, lens = (np.concatenate(a) for a in (keys, vals, lens))
    order = np.argsort(keys, kind="stable")
    data = _pack_bits(vals[order], lens[order])
    return data.replace(b"\xff", b"\xff\x00")


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def encode(rgb: np.ndarray, quality: int = 75) -> bytes:
    """uint8 [H, W, 3] RGB -> the bytes of a baseline 4:2:0 JFIF file, as
    PIL's ``Image.fromarray(rgb).save(f, "JPEG", quality=quality)`` writes
    them."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"encode takes uint8 [H, W, 3], got {rgb.dtype} {rgb.shape}")
    height, width = rgb.shape[:2]
    qluma, qchroma = quality_tables(quality)
    y, cb, cr = _rgb_to_ycc(rgb)
    mcu_rows, mcu_cols = _ceil_div(height, 16), _ceil_div(width, 16)
    y_wib, y_hib = _ceil_div(width, 8), _ceil_div(height, 8)
    c_wib, c_hib = mcu_cols, mcu_rows  # the chroma blocks: one an MCU
    # The rows are padded to even, the columns to twice the chroma blocks'
    # width, by repeating the last (jcprepct.c, expand_right_edge).
    rows, cols = height + height % 2, c_wib * 16
    planes = [_pad_edge(p, rows, cols) for p in (y, cb, cr)]
    sub = []
    for p in planes[1:]:  # h2v2_downsample: bias 1, 2, 1, 2, ... along a row
        s = p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2]
        bias = np.where(np.arange(s.shape[1]) % 2 == 0, 1, 2)
        sub.append((s + bias) >> 2)
    full_rows = mcu_rows * 16
    y_plane = _pad_edge(planes[0], full_rows, max(cols, mcu_cols * 16))
    grids = [_component_blocks(y_plane, qluma, y_wib, y_hib, 2, 2, mcu_rows, mcu_cols)]
    for s in sub:
        plane = _pad_edge(s, mcu_rows * 8, mcu_cols * 8)
        grids.append(_component_blocks(plane, qchroma, c_wib, c_hib, 1, 1,
                                       mcu_rows, mcu_cols))
    # Scan order: per MCU, Y's 2x2 blocks, then Cb, then Cr.
    luma = grids[0].reshape(mcu_rows, 2, mcu_cols, 2, 64).transpose(0, 2, 1, 3, 4)
    mcus = np.concatenate([luma.reshape(mcu_rows * mcu_cols, 4, 64),
                           grids[1].reshape(-1, 1, 64), grids[2].reshape(-1, 1, 64)],
                          axis=1)
    blocks = mcus.reshape(-1, 64)
    scan = _entropy_code(blocks, np.tile(np.array([0, 0, 0, 0, 1, 2]), mcu_rows * mcu_cols))

    out = [b"\xff\xd8",
           _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for tq, table in enumerate((qluma, qchroma)):
        out.append(_segment(0xDB, bytes([tq]) + bytes(table[ZIGZAG].astype(np.uint8))))
    out.append(_segment(0xC0, struct.pack(">BHHB", 8, height, width, 3)
                        + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])))
    for tc, th, name in ((0, 0, "dc_luminance"), (1, 0, "ac_luminance"),
                         (0, 1, "dc_chrominance"), (1, 1, "ac_chrominance")):
        counts, symbols = STD_HUFFMAN[name]
        out.append(_segment(0xC4, bytes([(tc << 4) | th]) + bytes(counts) + bytes(symbols)))
    out.append(_segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])))
    out.append(scan)
    out.append(b"\xff\xd9")
    return b"".join(out)
