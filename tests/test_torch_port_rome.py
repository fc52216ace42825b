"""The ROME losses, the multi-backbone perceptual loss and the 2D ops they
need, against the JAX package (FP32, numpy inputs and weights).

* ``grid_sample_2d`` in the zeros, border and reflection padding modes,
  coordinates well outside [-1, 1]: 1e-5; both corner conventions, except
  reflection with ``align_corners=True``, where JAX reflects about the
  ``align_corners=False`` bounds whatever the flag (torch's own convention
  is what the port gives; the one caller, ``Transform``, uses
  ``align_corners=False``).
* ``image_pyramid``: 1e-6.
* ``RomePerceptualLoss`` for each backbone family (vgg19, vgg16, alexnet,
  resnet50, InceptionResnetV1), with 2 scales and instance-normalised
  features: 1e-5 relative; every other name JAX accepts builds the same
  network.
* Every function of ``losses/rome.py``: 1e-5 relative. ``Transform`` takes
  the ``theta`` and ``control_params`` JAX drew (a torch generator cannot
  repeat JAX's draws); its jacobian (``torch.func.jacfwd`` under ``vmap``)
  against ``jax.jacfwd`` under ``jax.vmap``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from megaportraits_tpu.core.dtypes import FP32_POLICY as JP
from megaportraits_tpu.losses import perceptual_multi as jpm
from megaportraits_tpu.losses import rome as jrome
from megaportraits_tpu.ops.resize import image_pyramid as j_image_pyramid
from megaportraits_tpu.ops.warp import grid_sample_2d as j_grid_sample_2d

from megaportraits_tpu_torch.core.dtypes import FP32_POLICY
from megaportraits_tpu_torch.losses import perceptual_multi as pm
from megaportraits_tpu_torch.losses import rome
from megaportraits_tpu_torch.losses.vggface import InceptionResnetV1
from megaportraits_tpu_torch.ops.resize import image_pyramid
from megaportraits_tpu_torch.ops.warp import grid_sample_2d
from megaportraits_tpu_torch.utils.jax_bridge import load_jax_variables

from torch_port_utils import frozen_bn_statistics, n, numpy_init, t

REL = 1e-5


def _close(got, want, rel=REL):
    want = np.asarray(want, dtype=np.float32)
    got = n(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-6))


def _rand(seed, shape, lo=0.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


# -- the 2D ops ----------------------------------------------------------------------


@pytest.mark.parametrize("padding_mode,align_corners", [
    ("zeros", False), ("zeros", True), ("border", False), ("border", True),
    ("reflection", False), ("reflection", True)])
def test_grid_sample_2d_matches_jax(padding_mode, align_corners):
    v = _rand(0, (2, 9, 13, 4))
    coords = _rand(1, (2, 7, 5, 2), -1.6, 1.6)
    want = j_grid_sample_2d(jnp.asarray(v), jnp.asarray(coords), align_corners=align_corners,
                            padding_mode=padding_mode)
    got = grid_sample_2d(t(v), t(coords), align_corners=align_corners,
                         padding_mode=padding_mode)
    _close(got, want)
    with pytest.raises(ValueError):
        grid_sample_2d(t(v), t(coords), padding_mode="wrap")


def test_image_pyramid_matches_jax():
    x = _rand(2, (2, 32, 32, 3))
    want = j_image_pyramid(jnp.asarray(x))
    got = image_pyramid(t(x))
    assert got.keys() == want.keys() == {"0.5", "0.25"}
    for k in want:
        _close(got[k], want[k], 1e-6)
    got = image_pyramid(t(x), scales=(1.0, 0.5))
    assert torch.equal(got["1.0"], t(x))


# -- RomePerceptualLoss ------------------------------------------------------------


@pytest.mark.parametrize("backbone,size,kw", [
    ("vgg19", 32, dict(num_scales=2)),
    ("vgg16", 32, dict(normalize_features=True, layer_weights=(1.0, 0.5, 0.25, 2.0, 1.0))),
    ("alexnet", 64, dict(num_scales=2, normalize_features=True)),
    ("resnet50", 32, dict()),
    ("vggface", 96, dict(normalize_features=True)),
])
def test_rome_perceptual_loss_matches_jax(backbone, size, kw):
    pred, tgt = _rand(3, (2, size, size, 3)), _rand(4, (2, size, size, 3))
    jm = jpm.RomePerceptualLoss(backbone=backbone, policy=JP, **kw)
    v = frozen_bn_statistics(numpy_init(jm, jnp.asarray(pred), jnp.asarray(tgt), seed=5,
                                        stats_seed=6), 7)
    want = float(jax.jit(jm.apply)(v, jnp.asarray(pred), jnp.asarray(tgt)))
    model = load_jax_variables(pm.RomePerceptualLoss(backbone, policy=FP32_POLICY,
                                                     device="cpu", **kw), v)
    np.testing.assert_allclose(model(t(pred), t(tgt)).item(), want, rtol=REL)
    assert model(t(pred), t(pred)).item() == 0.0


def test_rome_perceptual_backbone_names():
    kw = dict(policy=FP32_POLICY, device="cpu")
    for name in pm.RESNET50_NAMES:
        assert isinstance(pm.RomePerceptualLoss(name, **kw).net, pm._ResNet50Taps)
    for name in pm.VGGFACE_NAMES:
        assert isinstance(pm.RomePerceptualLoss(name, **kw).net, InceptionResnetV1)
    with pytest.raises(ValueError, match="unknown backbone"):
        pm.RomePerceptualLoss("inception", **kw)


# -- rome.py --------------------------------------------------------------------


def _scores(seed, nets=2, outs=3):
    rng = np.random.default_rng(seed)
    return [[rng.normal(size=(2, 4, 4, 1)).astype(np.float32) for _ in range(outs)]
            for _ in range(nets)]


def _tree(fn, tree):
    if isinstance(tree, (list, tuple)):
        return [_tree(fn, x) for x in tree]
    return fn(tree)


def test_adversarial_psnr_and_normalisation_match_jax():
    fake, real = _scores(0), _scores(1)
    for mode in ("gen", "dis"):
        want = jrome.adversarial_loss(_tree(jnp.asarray, fake), _tree(jnp.asarray, real), mode)
        got = rome.adversarial_loss(_tree(t, fake), _tree(t, real), mode)
        np.testing.assert_allclose(got.item(), float(want), rtol=REL)
    with pytest.raises(ValueError):
        rome.adversarial_loss(_tree(t, fake), mode="nope")
    a, b = _rand(2, (2, 8, 8, 3)), _rand(3, (2, 8, 8, 3))
    np.testing.assert_allclose(rome.psnr(t(a), t(b)).item(),
                               float(jrome.psnr(jnp.asarray(a), jnp.asarray(b))), rtol=REL)
    _close(rome.apply_imagenet_normalization(t(a)),
           jrome.apply_imagenet_normalization(jnp.asarray(a)))
    np.testing.assert_array_equal(rome.make_grid(3, 5), jrome.make_grid(3, 5))


@pytest.fixture(scope="module")
def transforms():
    """JAX's Transform and the port's, given JAX's draws."""
    jt = jrome.Transform(jax.random.PRNGKey(3), 2, sigma_affine=0.05, sigma_tps=0.005,
                         points_tps=5)
    tt = rome.Transform(2, 0.05, 0.005, 5, theta=t(np.asarray(jt.theta)),
                        control_params=t(np.asarray(jt.control_params)))
    return jt, tt


def test_transform_matches_jax(transforms):
    jt, tt = transforms
    for pts in (_rand(4, (1, 10, 2), -1, 1), _rand(5, (2, 10, 2), -1, 1)):
        _close(tt.warp_pts(t(pts)), jt.warp_pts(jnp.asarray(pts)))
        _close(tt.jacobian(t(pts)), jt.jacobian(jnp.asarray(pts)))
    img = _rand(6, (2, 12, 10, 3))
    _close(tt.transform_img(t(img)), jt.transform_img(jnp.asarray(img)))


def test_transform_draws_from_its_generator():
    a = rome.Transform(2, 0.05, 0.005, 5, generator=torch.Generator().manual_seed(1))
    b = rome.Transform(2, 0.05, 0.005, 5, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a.theta, b.theta) and torch.equal(a.control_params, b.control_params)
    assert a.theta.shape == (2, 1, 2, 3) and a.control_params.shape == (2, 1, 25)
    eye = torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    assert (a.theta[:, 0] - eye).abs().max() < 0.5


def test_equivariance_loss_matches_jax():
    """Batch 1: JAX's jacobian flattens the batch into the points, which
    only a batch of one survives."""
    jt = jrome.Transform(jax.random.PRNGKey(4), 1, sigma_affine=0.05, sigma_tps=0.005,
                         points_tps=5)
    tt = rome.Transform(1, 0.05, 0.005, 5, theta=t(np.asarray(jt.theta)),
                        control_params=t(np.asarray(jt.control_params)))
    w = _rand(7, (3, 8), -1, 1)

    def detector(mod):
        def kp_detector(img):
            feats = img.mean(axis=(1, 2)) if mod is jnp else img.mean(dim=(1, 2))
            wm = jnp.asarray(w) if mod is jnp else t(w)
            kp = mod.tanh(feats @ wm).reshape(-1, 4, 2)
            jac = (mod.eye(2)[None, None] * (1.0 + 0.1 * kp[..., :1, None])
                   + 0.05 * kp[..., None, :])
            return kp, jac

        return kp_detector

    img = _rand(8, (1, 12, 12, 3))
    kp, jac = detector(jnp)(jnp.asarray(img))
    want = jrome.equivariance_loss(jnp.asarray(img), kp, jac, detector(jnp), jt)
    tkp, tjac = detector(torch)(t(img))
    got = rome.equivariance_loss(t(img), tkp, tjac, detector(torch), tt)
    for g, wv in zip(got, want):
        _close(g, wv)


def test_mesh_feature_and_keypoint_losses_match_jax():
    rng = np.random.default_rng(9)
    verts = rng.normal(size=(2, 6, 3)).astype(np.float32)
    faces = np.array([[0, 1, 2], [1, 2, 3], [3, 4, 5], [0, 4, 5]])
    np.testing.assert_allclose(rome.laplace_mesh_loss(t(verts), faces).item(),
                               float(jrome.laplace_mesh_loss(jnp.asarray(verts), faces)),
                               rtol=REL)
    real = [[[rng.normal(size=(2, 4, 4, 3)).astype(np.float32)] for _ in range(2)]
            for _ in range(2)]
    fake = [[[rng.normal(size=(2, 4, 4, 3)).astype(np.float32) for _ in range(3)]
             for _ in range(2)] for _ in range(2)]
    for loss_type in ("l1", "l2"):
        want = jrome.feature_matching_loss(_tree(jnp.asarray, real), _tree(jnp.asarray, fake),
                                           loss_type)
        got = rome.feature_matching_loss(_tree(t, real), _tree(t, fake), loss_type)
        np.testing.assert_allclose(got.item(), float(want), rtol=REL)
    pk, k = (rng.normal(size=(2, 68, 2)).astype(np.float32) for _ in range(2))
    for name in ("keypoints_matching_loss", "lip_closure_loss", "eye_closure_loss"):
        np.testing.assert_allclose(getattr(rome, name)(t(pk), t(k)).item(),
                                   float(getattr(jrome, name)(jnp.asarray(pk), jnp.asarray(k))),
                                   rtol=REL)
    np.testing.assert_array_equal(rome.KP68_WEIGHTS, jrome._KP68_WEIGHTS)


def test_segmentation_silhouette_pose_and_chamfer_match_jax():
    rng = np.random.default_rng(10)
    logits = rng.normal(size=(2, 8, 8, 1)).astype(np.float32)
    for tgt in (_rand(11, (2, 8, 8, 1)), _rand(12, (2, 16, 16, 1))):
        for loss_type in ("bce_with_logits", "dice"):
            np.testing.assert_allclose(
                rome.segmentation_loss(t(logits), t(tgt), loss_type).item(),
                float(jrome.segmentation_loss(jnp.asarray(logits), jnp.asarray(tgt), loss_type)),
                rtol=REL)
    x, gt = _rand(13, (2, 16, 16, 1), 0.05, 0.95), (_rand(14, (2, 16, 16, 1)) > 0.5) * 1.0
    for loss_type in ("iou", "mse", "bce"):
        for scales in (1, 2):
            np.testing.assert_allclose(
                rome.multi_scale_silhouette_loss(t(x), t(gt), scales, loss_type).item(),
                float(jrome.multi_scale_silhouette_loss(jnp.asarray(x), jnp.asarray(gt),
                                                        scales, loss_type)), rtol=REL)
    p, q = rng.normal(size=(2, 6)).astype(np.float32), rng.normal(size=(2, 6)).astype(np.float32)
    for loss_type in ("l1", "l2"):
        for wrap in (lambda a: a, lambda a: [a, a * 2]):
            np.testing.assert_allclose(
                rome.head_pose_matching_loss(_tree(t, wrap(p)), _tree(t, wrap(q)),
                                             loss_type).item(),
                float(jrome.head_pose_matching_loss(_tree(jnp.asarray, wrap(p)),
                                                    _tree(jnp.asarray, wrap(q)), loss_type)),
                rtol=REL)
    a, b = rng.normal(size=(2, 7, 3)).astype(np.float32), rng.normal(size=(2, 5, 3)).astype(np.float32)
    for g, w in zip(rome.chamfer_distance(t(a), t(b)),
                    jrome.chamfer_distance(jnp.asarray(a), jnp.asarray(b))):
        np.testing.assert_allclose(g.item(), float(w), rtol=REL)
