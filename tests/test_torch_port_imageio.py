"""The port's image files and resizes without PIL or cv2 (``utils/jpeg.py``,
``utils/image.py``) against PIL and cv2, and the dataset's PNG caches
against the JAX package's.

All comparisons are bit for bit (tolerance 0):
  * the JPEG decoder against PIL's decode of files PIL writes at quality
    50, 75 and 95, sampling 4:4:4, 4:2:2 and 4:2:0, of odd sizes, of a
    grayscale image, with a restart interval and stored as RGB, and of
    files cv2 writes at 4:4:0 and 4:1:1 (the other upsampling paths);
  * the encoder: the same bytes as PIL's ``save(f, "JPEG")`` of the same
    pixels, and so the same pixels decoded by PIL;
  * ``pil_bilinear_resize`` against PIL's BILINEAR and
    ``cv2_linear_resize_u8`` against cv2's INTER_LINEAR, up and down,
    odd sizes and one-pixel sides included;
  * progressive JPEGs that PIL writes (40 random pictures, sizes, qualities
    50 to 95, 4:4:4, 4:2:2 and 4:2:0, optimized tables and restart
    intervals), gray and CMYK ones, and CMYK baseline JPEGs;
  * PNGs: palette (PIL's, with and without tRNS, and one whose indices run
    past its PLTE), gray at 1, 2 and 4 bits, 16 bits as cv2 and PIL write
    them (PIL's clip of 16-bit gray and high byte of 16-bit colour pinned),
    and Adam7 files built with this module's PNG chunk writer and random
    row filters; each ``read_image`` against PIL's ``convert("RGB")``.
"""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

import cv2

from megaportraits_tpu.data import dataset as jdataset
from megaportraits_tpu.utils.image import save_image as j_save_image

from megaportraits_tpu_torch.data import dataset
from megaportraits_tpu_torch.utils import image, jpeg


def _picture(h, w, seed, channels=3):
    """A smooth picture with noise: what a photograph's blocks hold."""
    rng = np.random.default_rng(seed)
    coarse = rng.integers(0, 256, (max(h // 8, 2), max(w // 8, 2), 3), np.uint8)
    smooth = np.asarray(Image.fromarray(coarse).resize((w, h), Image.BICUBIC)).astype(int)
    out = np.clip(smooth + rng.integers(-20, 21, smooth.shape), 0, 255).astype(np.uint8)
    return out[..., :channels] if channels == 3 else out[..., 0]


def _pil_jpeg(a, **kw):
    f = io.BytesIO()
    Image.fromarray(a).save(f, "JPEG", **kw)
    return f.getvalue()


def _pil_decode(data):
    return np.asarray(Image.open(io.BytesIO(data)))


SIZES = [(16, 16), (33, 47), (17, 5), (120, 97), (1, 1)]


@pytest.mark.parametrize("size", SIZES, ids=str)
@pytest.mark.parametrize("quality", [50, 75, 95])
@pytest.mark.parametrize("subsampling", ["4:4:4", "4:2:2", "4:2:0"])
def test_decode_equals_pil(size, quality, subsampling):
    data = _pil_jpeg(_picture(*size, seed=sum(size) + quality), quality=quality,
                     subsampling=subsampling)
    got = jpeg.decode(data)
    assert got.dtype == np.uint8 and got.shape == size + (3,)
    np.testing.assert_array_equal(got, _pil_decode(data))


@pytest.mark.parametrize("size", SIZES, ids=str)
def test_decode_gray_and_restart_intervals_equal_pil(size, tmp_path):
    gray = _pil_jpeg(_picture(*size, seed=1, channels=1))
    np.testing.assert_array_equal(jpeg.decode(gray)[..., 0], _pil_decode(gray))
    for blocks in (1, 3):
        data = _pil_jpeg(_picture(*size, seed=2), restart_marker_blocks=blocks)
        assert b"\xff\xdd" in data
        np.testing.assert_array_equal(jpeg.decode(data), _pil_decode(data))
    path = tmp_path / "gray.jpg"
    path.write_bytes(gray)
    np.testing.assert_array_equal(image.read_image(str(path)),
                                  np.asarray(Image.open(path).convert("RGB")))


@pytest.mark.parametrize("factor", ["440", "411", "420", "422"])
def test_decode_cv2_sampling_factors_equal_pil(factor):
    a = _picture(37, 61, seed=3)
    flag = getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{factor}")
    ok, buf = cv2.imencode(".jpg", a[..., ::-1], [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, flag])
    assert ok
    np.testing.assert_array_equal(jpeg.decode(buf.tobytes()), _pil_decode(buf.tobytes()))


def test_decode_rgb_jpeg_equals_pil():
    """A JPEG stored as RGB (the Adobe marker's transform 0): no YCbCr.
    (PIL writes RGB at 4:4:4 only.)"""
    data = _pil_jpeg(_picture(21, 37, seed=9), keep_rgb=True, subsampling="4:4:4")
    assert b"Adobe" in data
    np.testing.assert_array_equal(jpeg.decode(data), _pil_decode(data))


@pytest.mark.parametrize("size", SIZES + [(64, 64), (31, 200)], ids=str)
def test_encode_writes_pils_bytes(size):
    a = _picture(*size, seed=4)
    got = jpeg.encode(a)
    assert got == _pil_jpeg(a)
    np.testing.assert_array_equal(_pil_decode(got), _pil_decode(_pil_jpeg(a)))


@pytest.mark.parametrize("quality", [1, 30, 90, 100])
def test_encode_quality_scaling(quality):
    a = _picture(24, 40, seed=5)
    assert jpeg.encode(a, quality=quality) == _pil_jpeg(a, quality=quality)


def test_refused_formats_are_named(tmp_path):
    """Lossless and arithmetic-coded JPEGs (their SOF markers put in a file
    PIL wrote), a JPEG of 2 components, and formats other than PNG and JPEG
    raise naming what they are; so does writing an extension other than
    .png, .jpg and .jpeg. (Progressive and CMYK JPEGs are read: below.)"""
    a = _picture(20, 20, seed=6)
    data = _pil_jpeg(a)
    for sof, what in ((b"\xff\xc3", "lossless JPEG"), (b"\xff\xc9", "arithmetic-coded JPEG")):
        with pytest.raises(ValueError, match=f"{what} is not supported"):
            jpeg.decode(data.replace(b"\xff\xc0", sof))
    sof = data.index(b"\xff\xc0")
    two = data[:sof + 9] + b"\x02" + data[sof + 10:]
    with pytest.raises(ValueError, match="2 components"):
        jpeg.decode(two)
    Image.fromarray(a).save(tmp_path / "a.gif")
    with pytest.raises(ValueError, match="a GIF file is not a PNG or a JPEG"):
        image.read_image(str(tmp_path / "a.gif"))
    with pytest.raises(ValueError, match=r"cannot write \.bmp"):
        image.write_image(a, str(tmp_path / "a.bmp"))


@pytest.mark.parametrize("ext", [".png", ".jpg", ".jpeg"])
def test_save_image_by_extension_equals_jax(tmp_path, ext):
    """JAX's save_image writes with PIL, which picks the format by the
    extension: the port writes the same bytes, and reads them back as PIL."""
    arr = np.random.default_rng(7).uniform(-0.1, 1.1, (2, 21, 34, 3)).astype(np.float32)
    j_save_image(arr, str(tmp_path / f"jax{ext}"))
    image.save_image(arr, str(tmp_path / f"port{ext}"))
    port = (tmp_path / f"port{ext}").read_bytes()
    if ext != ".png":  # PIL's PNG encoder filters rows adaptively; the pixels agree
        assert port == (tmp_path / f"jax{ext}").read_bytes()
    np.testing.assert_array_equal(image.read_image(str(tmp_path / f"port{ext}")),
                                  np.asarray(Image.open(tmp_path / f"jax{ext}")))


RESIZES = [((80, 80), (64, 64)), ((80, 80), (512, 512)), ((37, 53), (45, 31)),
           ((37, 53), (74, 106)), ((100, 60), (50, 30)), ((5, 5), (9, 9)),
           ((13, 300), (7, 200)), ((1, 1), (5, 3)), ((7, 7), (100, 3)),
           ((480, 640), (512, 512)), ((513, 513), (512, 512)), ((9, 9), (1, 1)),
           ((33, 47), (33, 47))]


@pytest.mark.parametrize("src,dst", RESIZES, ids=str)
def test_pil_bilinear_resize_equals_pil(src, dst):
    a = np.random.default_rng(sum(src + dst)).integers(0, 256, src + (3,), np.uint8)
    want = np.asarray(Image.fromarray(a).resize(dst[::-1], Image.BILINEAR))
    np.testing.assert_array_equal(image.pil_bilinear_resize(a, dst[::-1]), want)


@pytest.mark.parametrize("src,dst", RESIZES, ids=str)
def test_cv2_linear_resize_equals_cv2(src, dst):
    a = np.random.default_rng(sum(src + dst)).integers(0, 256, src + (3,), np.uint8)
    want = cv2.resize(a, dst[::-1])
    np.testing.assert_array_equal(image.cv2_linear_resize_u8(a, dst[::-1]), want)


def test_dataset_png_caches_equal_jax(tmp_path):
    """crop_and_warp_face and remove_background_and_convert_to_rgb write
    their PNG cache and read it back as the JAX package does."""
    frame = np.random.default_rng(8).random((40, 56, 3)).astype(np.float32)
    for name, kw in (("crop_and_warp_face", dict(out_size=(32, 32))),
                     ("remove_background_and_convert_to_rgb", {})):
        for pkg, tag in ((jdataset, "jax"), (dataset, "port")):
            path = str(tmp_path / f"{name}_{tag}.png")
            first = getattr(pkg, name)(frame, cache_path=path, **kw)
            again = getattr(pkg, name)(frame, cache_path=path, **kw)
            if tag == "jax":
                want_first, want_again = first, again
        np.testing.assert_array_equal(first, want_first)
        np.testing.assert_array_equal(again, want_again)
        np.testing.assert_array_equal(image.read_image(str(tmp_path / f"{name}_port.png")),
                                      np.asarray(Image.open(tmp_path / f"{name}_jax.png")))


# -- progressive and CMYK JPEG -----------------------------------------------------


def _progressive_case(i):
    """The i-th random progressive file's picture size and PIL save options."""
    rng = np.random.default_rng(1000 + i)
    size = (int(rng.integers(1, 90)), int(rng.integers(1, 90)))
    if i % 5 == 0:  # sides that are multiples of 8 but not of 16
        size = (8 * int(rng.integers(1, 6)) * 2 - 8, 8 * int(rng.integers(1, 6)) * 2 - 8)
    kw = dict(progressive=True, quality=int(rng.integers(50, 96)),
              subsampling=["4:2:0", "4:4:4", "4:2:2"][i % 3], optimize=bool(i % 2))
    if i % 4 == 3:
        kw["restart_marker_blocks"] = int(rng.integers(1, 4))
    return size, kw


@pytest.mark.parametrize("i", range(40))
def test_progressive_decode_equals_pil(i, tmp_path):
    size, kw = _progressive_case(i)
    data = _pil_jpeg(_picture(*size, seed=2000 + i), **kw)
    assert b"\xff\xc2" in data  # SOF2
    if "restart_marker_blocks" in kw:
        assert b"\xff\xdd" in data
    got = jpeg.decode(data)
    assert got.shape == size + (3,)
    np.testing.assert_array_equal(got, _pil_decode(data))
    path = tmp_path / "p.jpg"
    path.write_bytes(data)
    np.testing.assert_array_equal(image.read_image(str(path)),
                                  np.asarray(Image.open(path).convert("RGB")))


def test_progressive_gray_and_large_equal_pil():
    gray = _pil_jpeg(_picture(45, 70, seed=11, channels=1), progressive=True, quality=90)
    np.testing.assert_array_equal(jpeg.decode(gray)[..., 0], _pil_decode(gray))
    big = _pil_jpeg(_picture(160, 232, seed=12), progressive=True, quality=95, optimize=True)
    np.testing.assert_array_equal(jpeg.decode(big), _pil_decode(big))


@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("size", [(37, 29), (16, 16), (1, 9)], ids=str)
def test_cmyk_jpeg_equals_pil(size, progressive, tmp_path):
    path = tmp_path / "cmyk.jpg"
    Image.fromarray(_picture(*size, seed=13)).convert("CMYK").save(
        path, "JPEG", progressive=progressive)
    pil = Image.open(path)
    assert pil.mode == "CMYK"
    np.testing.assert_array_equal(jpeg.decode(path.read_bytes()), np.asarray(pil))
    np.testing.assert_array_equal(image.read_image(str(path)), np.asarray(pil.convert("RGB")))


def test_cmyk_to_rgb_equals_pil():
    cmyk = np.random.default_rng(14).integers(0, 256, (64, 64, 4), np.uint8)
    cmyk[0, :4] = [[0, 0, 0, 0], [255, 255, 255, 255], [255, 0, 0, 0], [0, 0, 0, 255]]
    want = Image.frombytes("CMYK", (64, 64), cmyk.tobytes()).convert("RGB")
    np.testing.assert_array_equal(jpeg.cmyk_to_rgb(cmyk), np.asarray(want))


# -- PNG: palette, bit depths, Adam7 ------------------------------------------------


def _pil_rgb(path):
    return np.asarray(Image.open(path).convert("RGB"))


def _read_equals_pil(path):
    got = image.read_image(str(path))
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, _pil_rgb(path))


@pytest.mark.parametrize("colors", [2, 4, 16, 256])
def test_palette_png_equals_pil(colors, tmp_path):
    pal = Image.fromarray(_picture(23, 37, seed=colors)).convert(
        "P", palette=Image.ADAPTIVE, colors=colors)
    pal.save(tmp_path / "p.png")
    pal.save(tmp_path / "t.png", transparency=0)  # tRNS: convert("RGB") drops it
    for name in ("p.png", "t.png"):
        assert Image.open(tmp_path / name).mode == "P"
        _read_equals_pil(tmp_path / name)


def _filter_rows(rows, bpp, rng):
    """Each scanline [h, n] under a random one of the five PNG filters."""
    out, prior = [], np.zeros(rows.shape[1], np.int64)
    for line in rows.astype(np.int64):
        kind = int(rng.integers(0, 5))
        left = np.concatenate([np.zeros(bpp, np.int64), line[:-bpp]])
        corner = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        p = left + prior - corner
        pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - corner)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, corner))
        pred = [0, left, prior, (left + prior) >> 1, paeth][kind]
        out.append(np.concatenate([[kind], (line - pred) % 256]))
        prior = line
    return np.asarray(out, np.uint8).reshape(len(rows), -1)


def _write_png(path, samples, depth, color, interlace=False, palette=None, seed=0):
    """A PNG of `samples` [h, w, ch] written with the port's chunk writer:
    packed at `depth`, random row filters, plain or as Adam7 passes."""
    rng = np.random.default_rng(seed)
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)

    def scanlines(s):
        if depth == 16:
            packed = s.astype(">u2").view(np.uint8).reshape(s.shape[0], -1)
        elif depth == 8:
            packed = s.reshape(s.shape[0], -1)
        else:
            bits = (s[..., :1] >> np.arange(depth - 1, -1, -1)) & 1
            packed = np.packbits(bits.reshape(s.shape[0], -1).astype(np.uint8), axis=1)
        return _filter_rows(packed, bpp, rng).tobytes()

    if interlace:
        raw = b"".join(scanlines(samples[y0::dy, x0::dx]) for x0, y0, dx, dy in image.ADAM7
                       if samples[y0::dy, x0::dx].size)
    else:
        raw = scanlines(samples)
    data = image.PNG_SIGNATURE + image._chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, int(interlace)))
    if palette is not None:
        data += image._chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    data += image._chunk(b"IDAT", zlib.compress(raw)) + image._chunk(b"IEND", b"")
    path.write_bytes(data)


_CH = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _samples(h, w, color, depth, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << depth, (h, w, _CH[color])).astype(
        np.uint16 if depth == 16 else np.uint8)


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_low_bit_depths_equal_pil(depth, tmp_path):
    """Gray scaled to 0..255, and palette indices at the same depths; one
    palette shorter than its indices (the rest read black, as PIL's)."""
    _write_png(tmp_path / "g.png", _samples(13, 29, 0, depth, depth), depth, 0, seed=depth)
    _read_equals_pil(tmp_path / "g.png")
    n = 1 << depth
    for entries in (n, max(1, n // 2)):
        _write_png(tmp_path / "p.png", _samples(11, 7, 3, depth, depth + 10), depth, 3,
                   palette=np.random.default_rng(entries).integers(0, 256, 3 * entries),
                   seed=depth)
        _read_equals_pil(tmp_path / "p.png")
    Image.fromarray(_picture(17, 21, seed=15)).convert("1").save(tmp_path / "b.png")
    assert Image.open(tmp_path / "b.png").mode == "1"
    _read_equals_pil(tmp_path / "b.png")


def test_16_bit_pngs_equal_pil(tmp_path):
    """cv2's imwrite of uint16 arrays (gray, BGR, BGRA) and PIL's I;16 save;
    PIL clips 16-bit gray to 255 and keeps 16-bit colour's high byte."""
    rng = np.random.default_rng(16)
    gray = rng.integers(0, 65536, (19, 33), np.uint16)
    gray[0, :5] = [0, 255, 256, 1000, 65535]
    cv2.imwrite(str(tmp_path / "g_cv2.png"), gray)
    Image.fromarray(gray).save(tmp_path / "g_pil.png")
    for name in ("g_cv2.png", "g_pil.png"):
        assert Image.open(tmp_path / name).mode == "I;16"
        got = image.read_image(str(tmp_path / name))
        np.testing.assert_array_equal(got[0, :5, 0], [0, 255, 255, 255, 255])
        _read_equals_pil(tmp_path / name)
    color = rng.integers(0, 65536, (19, 33, 3), np.uint16)
    color[0, 0] = [65535 // 2, 65535 // 3, 65535]
    cv2.imwrite(str(tmp_path / "c.png"), color[..., ::-1])
    np.testing.assert_array_equal(image.read_image(str(tmp_path / "c.png"))[0, 0], [127, 85, 255])
    _read_equals_pil(tmp_path / "c.png")
    cv2.imwrite(str(tmp_path / "ca.png"), rng.integers(0, 65536, (19, 33, 4), np.uint16))
    _read_equals_pil(tmp_path / "ca.png")
    _write_png(tmp_path / "la.png", _samples(9, 14, 4, 16, 17), 16, 4, seed=17)
    _read_equals_pil(tmp_path / "la.png")


ADAM7_CASES = [(2, 8), (6, 8), (0, 8), (4, 8), (0, 1), (0, 2), (0, 4), (3, 1), (3, 4),
               (3, 8), (0, 16), (2, 16), (4, 16), (6, 16)]


@pytest.mark.parametrize("color,depth", ADAM7_CASES, ids=str)
def test_adam7_png_equals_pil(color, depth, tmp_path):
    for k, (h, w) in enumerate([(1, 1), (2, 3), (9, 13), (17, 9), (8, 8), (23, 31)]):
        palette = (np.random.default_rng(k).integers(0, 256, 3 << depth)
                   if color == 3 else None)
        _write_png(tmp_path / "i.png", _samples(h, w, color, depth, 100 * k + depth), depth,
                   color, interlace=True, palette=palette, seed=k)
        assert Image.open(tmp_path / "i.png").info.get("interlace") == 1
        _read_equals_pil(tmp_path / "i.png")
