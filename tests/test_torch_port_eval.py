"""The evaluation metrics, the ``eval`` command and the PNG reader against
the JAX package.

* Every function of ``eval/metrics.py`` on the same arrays: the numpy
  metrics (L1, PSNR, SSIM, the Procrustes distance, FID, CSIM, the
  memorisation index) exactly; AKD and AED with the same 68-point stub
  provider installed in both packages, and LPIPS / the embedding AED with
  the same stub callables (float64 numpy inside), to 1e-6.
* ``evaluate_metrics`` on a directory pair of PNGs (some written by PIL,
  some by the port's writer): the dicts equal to 1e-6, the auto-install
  line word for word, with the default box provider and with stub
  callables.
* ``python -m megaportraits_tpu_torch eval`` against JAX's ``eval`` on the
  same directories, and with ``--pretrained`` at a port bundle (FAN, the
  identity net, VGG16 and the LPIPS heads): real LPIPS, identity-embedding
  AED and the FAN provider reported.
* ``load_image`` against PIL on files PIL wrote (L, LA, RGB, RGBA, with and
  without ``optimize``, which mixes the row filters): bit for bit.
Both landmark registries are reset around every test.
"""

import ast
import struct
import sys
import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from megaportraits_tpu import __main__ as jmain
from megaportraits_tpu.data import landmarks as jlandmarks
from megaportraits_tpu.eval import metrics as jmetrics

from megaportraits_tpu_torch import __main__ as tmain
from megaportraits_tpu_torch.core.dtypes import FP32_POLICY
from megaportraits_tpu_torch.data import landmarks
from megaportraits_tpu_torch.eval import metrics
from megaportraits_tpu_torch.losses import perceptual, vggface
from megaportraits_tpu_torch.models import fan
from megaportraits_tpu_torch.nn.layers import init_parameters
from megaportraits_tpu_torch.utils import convert_weights as cw
from megaportraits_tpu_torch.utils import image

Image = pytest.importorskip("PIL.Image", reason="the reference reader is PIL's")

TOL = 1e-6


@pytest.fixture(autouse=True)
def fresh_registries():
    jlandmarks.set_landmark_provider(None)
    landmarks.set_landmark_provider(None)
    yield
    jlandmarks.set_landmark_provider(None)
    landmarks.set_landmark_provider(None)


class _Stub68:
    """68 points that move with the image's mean (AKD and AED nonzero)."""

    is_proxy, num_points = False, 68

    def detect(self, img):
        rng = np.random.default_rng(0)
        base = rng.uniform(0, 1, (68, 2)) * img.shape[1::-1]
        return base + float(img.mean()) * rng.normal(size=(68, 2)) * 4.0


def _install(provider):
    jlandmarks.set_landmark_provider(provider)
    landmarks.set_landmark_provider(provider)


def _pair(seed, size=40):
    rng = np.random.default_rng(seed)
    a = rng.random((size, size, 3)).astype(np.float32)
    return a, np.clip(a + 0.1 * rng.normal(size=a.shape), 0, 1).astype(np.float32)


def test_numpy_metrics_equal_jax():
    pred, tgt = _pair(0)
    for name in ("calculate_l1", "calculate_psnr", "calculate_ssim"):
        assert getattr(metrics, name)(pred, tgt) == getattr(jmetrics, name)(pred, tgt), name
    assert metrics.calculate_ssim(pred[..., 0], tgt[..., 0]) == \
        jmetrics.calculate_ssim(pred[..., 0], tgt[..., 0])
    assert metrics.calculate_psnr(pred, pred) == jmetrics.calculate_psnr(pred, pred) == float("inf")
    rng = np.random.default_rng(1)
    a, b = rng.normal(size=(12, 2)), rng.normal(size=(12, 2))
    assert metrics.procrustes_shape_distance(a, b) == jmetrics.procrustes_shape_distance(a, b)
    assert metrics.procrustes_shape_distance(a * 0, b) is None
    f1, f2 = rng.normal(size=(20, 5)), rng.normal(size=(20, 5)) + 0.3
    assert metrics.calculate_fid(f1, f2) == jmetrics.calculate_fid(f1, f2)
    assert metrics.calculate_csim(f1, f2) == jmetrics.calculate_csim(f1, f2)
    clips = {c: rng.random((3, 8, 8, 3)).astype(np.float32) for c in "abc"}
    for probe in (clips["b"][1], rng.random((8, 8, 3)).astype(np.float32)):
        assert metrics.memorization_index(probe, clips) == jmetrics.memorization_index(probe, clips)
    assert metrics.memorization_index(clips["a"][0], {"a": clips["a"]})["margin_l1"] == \
        float("inf")


def _stub_embedding(mod):
    """The same linear embedding for both packages' array types, in float64
    numpy (no summation order between them)."""
    w = np.random.default_rng(3).normal(size=(3, 7))

    def embed(img):
        out = np.asarray(img, np.float64).mean(axis=(1, 2)) @ w
        return out if mod is jnp else torch.from_numpy(out)

    return embed


def _stub_lpips(mod):
    def lpips(a, b):
        out = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).mean(axis=(1, 2, 3))
        return out if mod is jnp else torch.from_numpy(out)

    return lpips


@pytest.mark.parametrize("provider", ["stub68", "box"])
def test_keypoint_metrics_match_jax(provider):
    if provider == "stub68":
        _install(_Stub68())
    pred, tgt = _pair(4, size=64)
    np.testing.assert_array_equal(metrics.extract_keypoints(pred),
                                  jmetrics.extract_keypoints(pred))
    for name in ("calculate_akd", "calculate_aed"):
        got, want = getattr(metrics, name)(pred, tgt), getattr(jmetrics, name)(pred, tgt)
        assert (got is None) == (want is None)
        if want is not None:
            assert abs(got - want) <= TOL, name
    got = metrics.calculate_aed(pred, tgt, _stub_embedding(torch))
    assert abs(got - jmetrics.calculate_aed(pred, tgt, _stub_embedding(jnp))) <= TOL
    got = metrics.calculate_lpips(pred, tgt, _stub_lpips(torch))
    assert abs(got - jmetrics.calculate_lpips(pred, tgt, _stub_lpips(jnp))) <= TOL


def _write_pairs(tmp_path, n_pairs=3):
    out, tgt = tmp_path / "out", tmp_path / "tgt"
    out.mkdir()
    tgt.mkdir()
    for i in range(n_pairs):
        a, b = _pair(10 + i, size=48)
        name = f"pred_frame_{i}.png" if i < 2 else f"cross_reenactment_images_{i}.png"
        if i % 2:
            Image.fromarray((a * 255).astype(np.uint8)).save(out / name)
            Image.fromarray((b * 255).astype(np.uint8)).save(tgt / name, optimize=True)
        else:
            image.save_image(a, str(out / name))
            image.save_image(b, str(tgt / name))
    image.save_image(np.zeros((8, 8, 3)), str(out / "pred_frame_9.png"))  # no target
    image.save_image(np.zeros((8, 8, 3)), str(out / "other.png"))  # not a frame
    return str(out), str(tgt)


def _assert_same_dict(got, want):
    assert got.keys() == want.keys()
    for k, w in want.items():
        if isinstance(w, float):
            assert abs(got[k] - w) <= TOL, k
        else:
            assert got[k] == w, k


@pytest.mark.parametrize("case", ["auto_install", "stubs", "stub68"])
def test_evaluate_metrics_matches_jax(tmp_path, capsys, case):
    out, tgt = _write_pairs(tmp_path)
    kw, tkw = {}, {}
    if case == "stubs":
        kw = dict(lpips_apply=_stub_lpips(jnp), embedding_apply=_stub_embedding(jnp))
        tkw = dict(lpips_apply=_stub_lpips(torch), embedding_apply=_stub_embedding(torch))
    if case == "stub68":
        _install(_Stub68())
    missing = str(tmp_path / "no_bundle")
    want = jmetrics.evaluate_metrics(out, tgt, pretrained_path=missing, **kw)
    jlines = capsys.readouterr().out
    got = metrics.evaluate_metrics(out, tgt, pretrained_path=missing, device="cpu", **tkw)
    assert capsys.readouterr().out == jlines
    _assert_same_dict(got, want)
    assert got["L1"] is not None and (got["LPIPS"] is None) == (case != "stubs")


def _run_main(main, argv, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["prog"] + argv)
    assert main() == 0
    lines = capsys.readouterr().out.splitlines()
    return lines[:-1], ast.literal_eval(lines[-1])


def test_eval_command_matches_jax(tmp_path, capsys, monkeypatch):
    out, tgt = _write_pairs(tmp_path)
    monkeypatch.chdir(tmp_path)
    argv = ["eval", "--output-dir", out, "--target-dir", tgt]
    jlines, want = _run_main(jmain.main, argv, capsys, monkeypatch)
    landmarks.set_landmark_provider(None)
    assert tmain.main(argv + ["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[:-1] == jlines
    _assert_same_dict(ast.literal_eval(lines[-1]), want)


def test_eval_command_with_a_port_bundle(tmp_path, capsys):
    """FAN (1 stack), InceptionResnetV1, VGG16 and the LPIPS heads written
    as original files, converted, and used by ``eval --pretrained``."""
    kw = dict(policy=FP32_POLICY, device="cpu")
    wd = tmp_path / "weights"
    wd.mkdir()
    sources = {"2DFAN.pth": (cw.fan_table(1), fan.FAN(1, **kw)),
               "vggface2.pth": (cw.inception_table(), vggface.InceptionResnetV1(**kw)),
               "vgg16.pth": (cw.vgg_table("vgg16"), perceptual.VGG(
                   "vgg16", taps=perceptual.LPIPS_TAPS, **kw)),
               "lpips.pth": (cw.lpips_table(), perceptual.LPIPS(**kw))}
    for i, (name, (table, module)) in enumerate(sources.items()):
        init_parameters(module, seed=i)
        torch.save(cw.original_state_dict(table, module.state_dict()), wd / name)
    bundle = tmp_path / "bundle"
    assert cw.main(["--weights-dir", str(wd), "--out", str(bundle)]) == 0
    out, tgt = _write_pairs(tmp_path, n_pairs=2)
    capsys.readouterr()
    assert tmain.main(["eval", "--output-dir", out, "--target-dir", tgt,
                       "--pretrained", str(bundle), "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[:2] == ["eval: converted LPIPS active",
                         "eval: vggface identity embeddings active (AED)"]
    result = ast.literal_eval(lines[-1])
    assert result["AED_formula"] == "identity_embedding"
    assert result["AKD_provider"] == "FANLandmarkProvider"
    for k in ("L1", "LPIPS", "PSNR", "SSIM", "AKD", "AED"):
        assert np.isfinite(result[k]), k
    assert isinstance(landmarks.get_landmark_provider(), landmarks.FANLandmarkProvider)


# -- load_image ------------------------------------------------------------------


def _filters(path):
    """The row filter types of an 8-bit PNG."""
    pixels = image.read_png(path)[0]
    h, w, ch = pixels.shape
    data = open(path, "rb").read()
    idat = b"".join(p for k, p in image._chunks(data) if k == b"IDAT")
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, w * ch + 1)
    return set(raw[:, 0].tolist())


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
def test_load_image_equals_pil(tmp_path, mode):
    ch = len(mode)
    rng = np.random.default_rng(ch)
    yy, xx = np.mgrid[0:37, 0:53]
    a = ((xx * 3 + yy * 5)[..., None] + rng.integers(0, 60, (37, 53, ch))) % 256
    a = a.astype(np.uint8)
    filters = set()
    for optimize in (False, True):
        path = str(tmp_path / f"{mode}{optimize}.png")
        Image.fromarray(a[..., 0] if ch == 1 else a, mode).save(path, optimize=optimize)
        want = np.asarray(Image.open(path).convert("RGB"), dtype=np.float32) / 255.0
        got = metrics.load_image(path)
        assert got.dtype == np.float32 and got.shape == (37, 53, 3)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, jmetrics.load_image(path))
        filters |= _filters(path)
    assert len(filters) >= 3, filters


def test_load_image_refuses_what_it_does_not_read(tmp_path):
    """A palette and a 16-bit PNG read as PIL and JAX read them; a file
    whose header says Adam7 over plain data, an invalid bit depth or colour
    type, and a file that is no PNG raise."""
    Image.fromarray(np.arange(16, dtype=np.uint8).reshape(4, 4) * 16, "L").convert(
        "P").save(tmp_path / "p.png")
    Image.fromarray(np.arange(16, dtype=np.uint16).reshape(4, 4) * 4000).save(
        tmp_path / "d16.png")
    for name in ("p.png", "d16.png"):
        want = np.asarray(Image.open(tmp_path / name).convert("RGB"), np.float32) / 255.0
        np.testing.assert_array_equal(metrics.load_image(str(tmp_path / name)), want)
        np.testing.assert_array_equal(metrics.load_image(str(tmp_path / name)),
                                      jmetrics.load_image(str(tmp_path / name)))
    ok = image._encode_png(np.zeros((4, 4, 3), np.uint8))
    start = ok.index(b"IHDR") - 4
    for name, fields in (("i.png", (8, 2, 0, 0, 1)), ("b3.png", (3, 2, 0, 0, 0)),
                         ("c5.png", (8, 5, 0, 0, 0))):
        header = struct.pack(">IIBBBBB", 4, 4, *fields)
        (tmp_path / name).write_bytes(ok[:start] + image._chunk(b"IHDR", header)
                                      + ok[start + 25:])
    (tmp_path / "x.png").write_bytes(b"GIF89a")
    for name, match in (("i.png", "Adam7"), ("b3.png", "bit depth 3"),
                        ("c5.png", "colour type 5"), ("x.png", "not a PNG")):
        with pytest.raises(ValueError, match=match):
            metrics.load_image(str(tmp_path / name))
