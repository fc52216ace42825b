"""The landmark stack and the gaze terms against the JAX package: FAN, the
heatmap decode, the landmark providers and their registry, the eye-mask
rasteriser, the gaze masks of a batch, the eye crops, GazeBlinkLoss and
the FAN weight converter.

* FAN at ``num_modules=1`` on 64x64 (FULL width), numpy weights bridged:
  heatmaps to 1e-4 of their largest magnitude. The decode is compared on the
  same heatmaps, exactly, ties included (random weights give near-flat
  heatmaps whose argmax flips between two forwards that differ by 1e-6).
* ``eye_masks_from_landmarks`` against ``cv2.fillPoly`` bit for bit on 240
  seeded polygons: inside the image, crossing its edges, degenerate (all
  points equal, collinear), convex and not.
* ``gaze_masks_for_batch`` and ``eye_crops_from_landmarks`` with one fixed
  68-point stub provider installed in both packages: masks bit for bit,
  crops to 1e-6 (the port's bilinear against cv2's INTER_LINEAR).
* The port's bilinear against ``cv2.resize`` INTER_LINEAR on float32, up
  and down: 1e-6.
* GazeBlinkLoss (VGG16 eye trunk at 32x32) to 1e-5 relative.
Every test runs with both registries reset before and after it.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from megaportraits_tpu.core.dtypes import FP32_POLICY as JP
from megaportraits_tpu.data import landmarks as jlandmarks
from megaportraits_tpu.losses import gaze as jgaze
from megaportraits_tpu.models import fan as jfan
from megaportraits_tpu.utils.torch_convert import merge_params

from megaportraits_tpu_torch.core.dtypes import FP32_POLICY
from megaportraits_tpu_torch.data import landmarks
from megaportraits_tpu_torch.losses import gaze
from megaportraits_tpu_torch.models import fan
from megaportraits_tpu_torch.utils import convert_weights as cw
from megaportraits_tpu_torch.utils.jax_bridge import jax_to_state_dict, load_jax_variables

from torch_port_utils import frozen_bn_statistics, n, numpy_init, numpy_state_dict, t

cv2 = pytest.importorskip("cv2", reason="the references of the rasteriser and the "
                                         "resize are cv2's")

FAN_SIZE = 64


@pytest.fixture(autouse=True)
def fresh_registries():
    """No provider leaks between tests, in either package."""
    jlandmarks.set_landmark_provider(None)
    landmarks.set_landmark_provider(None)
    yield
    jlandmarks.set_landmark_provider(None)
    landmarks.set_landmark_provider(None)


def _close(got, want, rel):
    want = np.asarray(want, dtype=np.float32)
    got = n(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


# -- FAN ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_fan():
    """JAX's FAN (1 stack, FP32) with numpy weights, its jitted apply and an
    input batch."""
    x = np.random.default_rng(0).uniform(0, 1, (2, FAN_SIZE, FAN_SIZE, 3)).astype(np.float32)
    model = jfan.FAN(num_modules=1, policy=JP)
    v = frozen_bn_statistics(numpy_init(model, jnp.asarray(x), seed=0), seed=1)
    return model, v, jax.jit(model.apply), x


def test_fan_heatmaps_match_jax(jax_fan):
    _, v, apply, x = jax_fan
    want = np.asarray(apply(v, jnp.asarray(x)))
    model = load_jax_variables(fan.FAN(1, policy=FP32_POLICY, device="cpu"), v)
    got = model(t(x))
    assert got.dtype == torch.float32 and want.shape == (2, FAN_SIZE // 4, FAN_SIZE // 4, 68)
    _close(got, want, 1e-4)


def test_heatmap_decode_matches_jax_exactly():
    """The same heatmaps: random, with exact ties (the first maximum wins),
    peaks on every border (the clipped neighbours) and flat neighbours."""
    rng = np.random.default_rng(1)
    hm = rng.normal(size=(3, 16, 12, 68)).astype(np.float32)
    hm[0] = np.round(hm[0])  # many ties
    hm[1, :, :, :4] = 0.0  # all equal: index 0
    for c, (y, x) in enumerate([(0, 0), (15, 11), (0, 11), (15, 0), (7, 0), (0, 5)]):
        hm[2, y, x, c] = 10.0
    hm[2, 5, 5, 10], hm[2, 5, 4, 10], hm[2, 5, 6, 10] = 9.0, 1.0, 1.0  # flat: sign 0
    got = n(fan.heatmaps_to_landmarks(t(hm)))
    np.testing.assert_array_equal(got, np.asarray(jfan.heatmaps_to_landmarks(jnp.asarray(hm))))


def test_fan_converter_matches_jax(jax_fan):
    """A synthetic face_alignment 2DFAN-1 state_dict through JAX's
    ``convert_fan`` + ``merge_params`` (bridged) and through the port's
    table: equal tensors, and equal heatmaps of the two grafted FANs."""
    jm, v, apply, x = jax_fan
    port = fan.FAN(1, policy=FP32_POLICY, device="cpu")
    original = cw.original_state_dict(cw.fan_table(1), numpy_state_dict(port, 2))
    assert cw.identify(original) == "fan"
    jparams, num_modules = jfan.convert_fan(original)
    assert num_modules == 1
    jmerged = merge_params(v["params"], jparams)
    key, converted = cw.convert("fan", original)
    assert key == "fan"
    want = jax_to_state_dict({"params": jmerged})
    assert converted.keys() == want.keys() == port.state_dict().keys()
    for k in want:
        torch.testing.assert_close(converted[k], want[k], rtol=0, atol=0)
    port.load_state_dict(converted)
    _close(port(t(x)), apply({"params": jmerged}, jnp.asarray(x)), 1e-4)


# -- the providers ------------------------------------------------------------


def _smooth_image(seed, h, w):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    base = np.stack([np.sin(3 * xx + c) * np.cos(2 * yy - c) for c in range(3)], -1)
    return (0.5 + 0.4 * base + 0.05 * rng.random((h, w, 3))).astype(np.float32)


def test_box_provider_matches_jax():
    """Detected faces and the centre prior, with their counts."""
    for fallback in (True, False):
        jp = jlandmarks.BoxLandmarkProvider(center_prior_fallback=fallback)
        tp = landmarks.BoxLandmarkProvider(center_prior_fallback=fallback)
        for seed, (h, w) in enumerate([(64, 64), (48, 80)]):
            img = _smooth_image(seed, h, w)
            skin = img.copy()
            skin[10:40, 12:44] = (0.85, 0.6, 0.5)  # a skin-tone blob
            for im in (img, skin):
                want, got = jp.detect(im), tp.detect(im)
                if want is None:
                    assert got is None
                else:
                    assert got.dtype == np.float64
                    np.testing.assert_array_equal(got, want)
        assert (tp.n_center_prior, tp.n_detected) == (jp.n_center_prior, jp.n_detected)
        assert tp.n_detected > 0


def test_registry_defaults_to_the_box_proxy():
    provider = landmarks.get_landmark_provider()
    assert isinstance(provider, landmarks.BoxLandmarkProvider)
    assert landmarks.get_landmark_provider() is provider
    stub = _StubProvider()
    landmarks.set_landmark_provider(stub)
    assert landmarks.get_landmark_provider() is stub


def test_fan_provider_pipeline_matches_jax():
    """The crop, the resize to 256 and the cell-centre mapping: both
    providers' networks replaced by one that records its input and returns
    the same fixed heatmaps. The FAN inputs agree to 1e-6 (cv2's
    INTER_LINEAR against the port's bilinear), the landmarks exactly."""
    hm = np.random.default_rng(3).normal(size=(1, 64, 64, 68)).astype(np.float32)
    seen = {}

    jp = jlandmarks.FANLandmarkProvider.__new__(jlandmarks.FANLandmarkProvider)
    jp.crop_to_face, jp._hm_size = True, 64

    def j_run(variables, inp):
        seen["jax"] = np.asarray(inp)
        return jfan.heatmaps_to_landmarks(jnp.asarray(hm))

    jp._run, jp.variables = j_run, None

    tp = landmarks.FANLandmarkProvider(num_modules=1, device="cpu")

    def t_model(inp):
        seen["port"] = n(inp)
        return t(hm)

    tp.model = t_model
    for h, w in ((200, 150), (512, 512), (40, 60)):
        img = _smooth_image(h + w, h, w)
        img[h // 4:3 * h // 4, w // 4:3 * w // 4] = (0.85, 0.6, 0.5)
        want, got = jp.detect(img), tp.detect(img)
        assert seen["port"].shape == seen["jax"].shape == (1, 256, 256, 3)
        np.testing.assert_allclose(seen["port"], seen["jax"], rtol=0, atol=1e-6)
        assert got.dtype == np.float64 and got.shape == (68, 2)
        np.testing.assert_array_equal(got, want)


def test_fan_provider_runs_a_seeded_random_fan():
    """No weights: a FAN drawn from the given generator (the same weights
    for the same seed), untrained, landmarks inside the image."""
    gen = torch.Generator().manual_seed(5)
    p1 = landmarks.FANLandmarkProvider(num_modules=1, device="cpu", generator=gen)
    p2 = landmarks.FANLandmarkProvider(num_modules=1, device="cpu",
                                       generator=torch.Generator().manual_seed(5))
    assert not p1.trained
    for k, v in p1.model.state_dict().items():
        assert torch.equal(v, p2.model.state_dict()[k]), k
    img = _smooth_image(0, 96, 80)
    lm = p1.detect(img)
    assert lm.shape == (68, 2) and np.isfinite(lm).all()
    assert (lm[:, 0] >= 0).all() and (lm[:, 0] <= 80).all()
    assert (lm[:, 1] >= 0).all() and (lm[:, 1] <= 96).all()


# -- the eye masks --------------------------------------------------------------


def _polygons(n_cases=240, seed=7):
    rng = np.random.default_rng(seed)
    for i in range(n_cases):
        h, w = (int(v) for v in rng.integers(4, 48, 2))
        k = int(rng.integers(1, 9))
        kind = i % 6
        if kind == 0:  # anywhere, edges clipped
            pts = rng.integers(-12, max(h, w) + 12, (k, 2))
        elif kind == 1:  # inside
            pts = np.stack([rng.integers(0, w, k), rng.integers(0, h, k)], 1)
        elif kind == 2:  # all points equal, inside or not
            pts = np.repeat(rng.integers(-3, max(h, w) + 3, 2)[None], k, 0)
        elif kind == 3:  # collinear
            p, d = rng.integers(0, max(h, w), 2), rng.integers(-4, 5, 2)
            pts = p[None] + d[None] * np.arange(k)[:, None]
        elif kind == 4:  # convex, on a circle
            c, r = rng.uniform(0, max(h, w), 2), rng.uniform(1, 16)
            a = np.sort(rng.uniform(0, 2 * np.pi, k))
            pts = np.round(c + r * np.stack([np.cos(a), np.sin(a)], 1))
        else:  # an eye: 6 points around an ellipse, near the borders too
            c = rng.uniform(-4, [w + 4, h + 4])
            a = np.linspace(0, 2 * np.pi, 6, endpoint=False)
            pts = np.round(c + np.stack([rng.uniform(2, 10) * np.cos(a),
                                         rng.uniform(1, 5) * np.sin(a)], 1))
        yield pts.astype(np.int32), h, w


def test_eye_masks_equal_cv2_fillpoly():
    cases = list(_polygons())
    kinds_clipped = 0
    for pts, h, w in cases:
        want = np.zeros((h, w), np.float32)
        cv2.fillPoly(want, [pts], 1.0)
        got = gaze.eye_masks_from_landmarks([tuple(p) for p in pts], h, w)
        assert got.shape == (h, w, 1) and got.dtype == np.float32
        np.testing.assert_array_equal(got[..., 0], want, err_msg=f"{pts.tolist()} {h}x{w}")
        kinds_clipped += bool(((pts < 0) | (pts >= (w, h))).any())
    assert len(cases) == 240 and kinds_clipped > 40


class _StubProvider:
    """68 fixed points from the image's size and mean: eyes near the
    borders for some images (their polygons clipped)."""

    is_proxy = False
    num_points = 68

    def detect(self, image):
        h, w = image.shape[:2]
        m = float(image.mean())
        rng = np.random.default_rng(int(m * 1e6) % 1000)
        lm = rng.uniform(0, 1, (68, 2)) * (w, h)
        a = np.linspace(0, 2 * np.pi, 6, endpoint=False)
        for idx, cx in ((landmarks.RIGHT_EYE, 0.3 * w), (landmarks.LEFT_EYE, 0.7 * w + 40 * m)):
            lm[list(idx)] = np.stack([cx + 0.12 * w * np.cos(a),
                                      0.35 * h - 30 * m + 0.05 * h * np.sin(a)], 1)
        return lm


class _ProxyStub:
    is_proxy, num_points = True, 5

    def detect(self, image):
        return np.zeros((5, 2))


@pytest.mark.parametrize("provider", ["stub68", "proxy"])
def test_gaze_masks_for_batch_match_jax(provider):
    stub = _StubProvider() if provider == "stub68" else _ProxyStub()
    jlandmarks.set_landmark_provider(stub)
    landmarks.set_landmark_provider(stub)
    images = np.stack([_smooth_image(s, 64, 64) for s in range(3)])
    images[1] *= 0.2  # eyes near the top border
    want, got = jgaze.gaze_masks_for_batch(images), gaze.gaze_masks_for_batch(images)
    if provider == "proxy":
        assert want is None and got is None
        return
    assert got.shape == (3, 64, 64, 2) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert got.sum() > 0


def test_eye_crops_match_jax():
    stub = _StubProvider()
    for seed, (h, w) in enumerate([(64, 64), (100, 70)]):
        img = _smooth_image(seed, h, w)
        lm = stub.detect(img)
        want = jlandmarks.eye_crops_from_landmarks(img, lm)
        got = landmarks.eye_crops_from_landmarks(img, lm)
        for g, wv in zip(got, want):
            assert g.shape == wv.shape and g.dtype == np.float32
            np.testing.assert_allclose(g, wv, rtol=0, atol=1e-6)


@pytest.mark.parametrize("src,dst", [((37, 53), (256, 256)), ((300, 411), (256, 256)),
                                     ((512, 512), (256, 256)), ((7, 9), (32, 32))])
def test_bilinear_resize_matches_cv2(src, dst):
    x = np.random.default_rng(sum(src)).random((*src, 3)).astype(np.float32)
    want = cv2.resize(x, dst[::-1], interpolation=cv2.INTER_LINEAR)
    np.testing.assert_allclose(landmarks.bilinear_resize(x, *dst), want, rtol=0, atol=1e-6)


# -- GazeBlinkLoss ------------------------------------------------------------------


def test_gaze_blink_loss_matches_jax():
    rng = np.random.default_rng(9)
    args = [rng.random(s).astype(np.float32)
            for s in ((2, 32, 32, 3), (2, 32, 32, 3), (2, 136), (2, 2), (2, 1))]
    jm = jgaze.GazeBlinkLoss(policy=JP)
    v = numpy_init(jm, *map(jnp.asarray, args), seed=4)
    loss, pg, pb = jax.jit(jm.apply)(v, *map(jnp.asarray, args))
    model = load_jax_variables(gaze.GazeBlinkLoss(policy=FP32_POLICY, device="cpu"), v)
    tloss, tpg, tpb = model(*map(t, args))
    np.testing.assert_allclose(tloss.item(), float(loss), rtol=1e-5)
    _close(tpg, pg, 1e-5)
    _close(tpb, pb, 1e-5)
