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
    odd sizes and one-pixel sides included.
"""

import io

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
    a = _picture(20, 20, seed=6)
    with pytest.raises(ValueError, match="progressive JPEG is not supported"):
        jpeg.decode(_pil_jpeg(a, progressive=True))
    cmyk = io.BytesIO()
    Image.fromarray(a).convert("CMYK").save(cmyk, "JPEG")
    with pytest.raises(ValueError, match="4 components"):
        jpeg.decode(cmyk.getvalue())
    Image.fromarray(a).save(tmp_path / "a.gif")
    with pytest.raises(ValueError, match="a GIF file is not a PNG or a baseline JPEG"):
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
