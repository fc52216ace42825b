"""Port parity on CPU for the training losses and the discriminator, against
the JAX package: the GAN losses of all three types, feature matching, the
cycle cosine loss, the masked gaze MSE, the pairwise and identity losses,
the VGG taps, LPIPS and PerceptualLoss (TINY at 64x64, FULL width at
32x32), and the PatchGAN discriminator (TINY and FULL at 64x64), FP32.
Weights are drawn with numpy and bridged (a strict load: every JAX leaf
lands in exactly one port tensor); inputs come from numpy seeds.

Tolerance: 1e-5 relative (and 1e-6 absolute) on the scalar losses and
1e-4 relative to the largest element on feature maps, patch maps and the
gradients with respect to the prediction. The convolutions sum in another
order on each side; the VGG trunks chain up to 16 of them.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from megaportraits_tpu.core.arch import FULL as JFULL
from megaportraits_tpu.core.arch import TINY as JTINY
from megaportraits_tpu.core.dtypes import FP32_POLICY as JP
from megaportraits_tpu.losses import cycle as jcycle
from megaportraits_tpu.losses import gan as jgan
from megaportraits_tpu.losses import pairwise as jpairwise
from megaportraits_tpu.losses import perceptual as jperc
from megaportraits_tpu.losses.gaze import mp_gaze_loss as j_mp_gaze_loss
from megaportraits_tpu.models.discriminator import Discriminator as JDiscriminator

from megaportraits_tpu_torch.core.arch import FULL, TINY
from megaportraits_tpu_torch.core.dtypes import FP32_POLICY
from megaportraits_tpu_torch.losses import cycle, gan, pairwise, perceptual
from megaportraits_tpu_torch.losses.gaze import mp_gaze_loss
from megaportraits_tpu_torch.models.discriminator import (
    Discriminator,
    build_discriminator,
)

from torch_port_utils import bridged, n, numpy_fill, numpy_init, t, uniform

ARCHS = {"tiny": (JTINY, TINY), "full": (JFULL, FULL)}
SCALAR = dict(rtol=1e-5, atol=1e-6)


def _close_maps(got, want, rel=1e-4):
    got, want = n(got), np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=rel * np.abs(want).max(), rtol=0)


def _images(seed, shape):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# Scalar losses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("loss_type", ["lsgan", "vanilla", "hinge"])
def test_gan_losses_match_jax(loss_type):
    rng = np.random.default_rng(0)
    real = uniform(rng, (2, 4, 4, 1), -2, 2)
    fake = uniform(rng, (2, 4, 4, 1), -2, 2)
    np.testing.assert_allclose(
        gan.discriminator_loss(t(real), t(fake), loss_type).item(),
        float(jgan.discriminator_loss(real, fake, loss_type)), **SCALAR)
    np.testing.assert_allclose(
        gan.generator_adversarial_loss(t(fake), loss_type).item(),
        float(jgan.generator_adversarial_loss(fake, loss_type)), **SCALAR)


def test_gan_losses_reject_unknown_type():
    x = torch.zeros(1, 2, 2, 1)
    with pytest.raises(NotImplementedError):
        gan.discriminator_loss(x, x, "wgan")
    with pytest.raises(NotImplementedError):
        gan.generator_adversarial_loss(x, "wgan")


def test_hinge_real_fake_and_feature_matching_match_jax():
    rng = np.random.default_rng(1)
    real, fake = uniform(rng, (2, 3, 3, 1), -2, 2), uniform(rng, (2, 3, 3, 1), -2, 2)
    np.testing.assert_allclose(gan.hinge_real_fake_loss(t(real), t(fake), 0.7).item(),
                               float(jgan.hinge_real_fake_loss(real, fake, 0.7)), **SCALAR)
    a, b = _images(2, (2, 8, 8, 3)), _images(3, (2, 8, 8, 3))
    np.testing.assert_allclose(gan.feature_matching_loss(t(a), t(b)).item(),
                               float(jgan.feature_matching_loss(a, b)), **SCALAR)


def test_losses_compute_in_float32():
    x = torch.ones(1, 2, 2, 1, dtype=torch.bfloat16)
    assert gan.discriminator_loss(x, x, "vanilla").dtype == torch.float32
    assert gan.feature_matching_loss(x, x).dtype == torch.float32


def test_cosine_loss_matches_jax():
    """Two positive and two negative pairs over a batch of 3; exp(neg)
    summed over all negative elements, as in the reference."""
    rng = np.random.default_rng(4)
    z = [rng.normal(size=(3, 16)).astype(np.float32) for _ in range(4)]
    pos = [(z[0], z[1]), (z[2], z[1])]
    neg = [(z[0], z[3]), (z[2], z[3])]
    got = cycle.cosine_loss([(t(a), t(b)) for a, b in pos],
                            [(t(a), t(b)) for a, b in neg])
    np.testing.assert_allclose(got.item(), float(jcycle.cosine_loss(pos, neg)), **SCALAR)


def test_mp_gaze_loss_matches_jax():
    rng = np.random.default_rng(5)
    pred, tgt = _images(6, (2, 16, 16, 3)), _images(7, (2, 16, 16, 3))
    left = (rng.random((2, 16, 16, 1)) > 0.7).astype(np.float32)
    right = (rng.random((2, 16, 16, 1)) > 0.7).astype(np.float32)
    np.testing.assert_allclose(
        mp_gaze_loss(t(pred), t(tgt), t(left), t(right)).item(),
        float(j_mp_gaze_loss(pred, tgt, left, right)), **SCALAR)


def test_pairwise_and_identity_losses_match_jax():
    rng = np.random.default_rng(8)
    i1, i2 = _images(9, (2, 8, 8, 3)), _images(10, (2, 8, 8, 3))
    proj = rng.normal(size=(8 * 8 * 3, 12)).astype(np.float32)

    def j_mix(variables, a, b, train):
        return a * variables, b * 0.5 + a * 0.25

    def t_mix(a, b, train):
        return a * 2.0, b * 0.5 + a * 0.25

    np.testing.assert_allclose(
        pairwise.pairwise_transfer_loss(t_mix, t(i1), t(i2)).item(),
        float(jpairwise.pairwise_transfer_loss(j_mix, 2.0, i1, i2)), **SCALAR)
    np.testing.assert_allclose(
        pairwise.identity_similarity_loss(lambda x: x.reshape(2, -1) @ t(proj),
                                          t(i1), t(i2)).item(),
        float(jpairwise.identity_similarity_loss(lambda x: x.reshape(2, -1) @ proj,
                                                 i1, i2)), **SCALAR)


# ---------------------------------------------------------------------------
# VGG, LPIPS, PerceptualLoss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["tiny", "full"])
@pytest.mark.parametrize("cfg,taps", [("vgg19", jperc.VGG19_REFERENCE_TAPS),
                                      ("vgg16", jperc.LPIPS_TAPS)])
def test_vgg_taps_match_jax(arch, cfg, taps):
    ja, ta = ARCHS[arch]
    size = 64 if arch == "tiny" else 32
    x = _images(11, (2, size, size, 3)) - 0.5
    jmod = jperc.VGG(cfg=cfg, taps=taps, policy=JP, arch=ja)
    v = numpy_init(jmod, x, seed=12)
    want = jmod.apply(v, x)
    model = bridged(perceptual.VGG(cfg, taps, policy=FP32_POLICY, arch=ta), v)
    with torch.no_grad():
        got = model(t(x))
    assert len(got) == len(want) == len(jmod.effective_taps())
    for a, b in zip(got, want):
        _close_maps(a, b)


@pytest.mark.parametrize("arch", ["tiny", "full"])
def test_lpips_matches_jax(arch):
    ja, ta = ARCHS[arch]
    size = 64 if arch == "tiny" else 32
    x, y = _images(13, (2, size, size, 3)), _images(14, (2, size, size, 3))
    jmod = jperc.LPIPS(policy=JP, arch=ja)
    v = numpy_init(jmod, x, y, seed=15)
    model = bridged(perceptual.LPIPS(policy=FP32_POLICY, arch=ta), v)
    with torch.no_grad():
        got = model(t(x), t(y))
    np.testing.assert_allclose(n(got), np.asarray(jmod.apply(v, x, y)), rtol=1e-5, atol=1e-7)


def _perceptual_pair(arch, seed):
    ja, ta = ARCHS[arch]
    size = 64 if arch == "tiny" else 32
    pred, tgt = _images(seed, (2, size, size, 3)), _images(seed + 1, (2, size, size, 3))
    jmod = jperc.PerceptualLoss(weights=dict(perceptual.DEFAULT_WEIGHTS), policy=JP,
                                arch=ja)
    v = numpy_init(jmod, pred, tgt, seed=seed + 2)
    model = bridged(perceptual.PerceptualLoss(policy=FP32_POLICY, arch=ta), v)
    return jmod, v, model.requires_grad_(False), pred, tgt


@pytest.mark.parametrize("arch", ["tiny", "full"])
@pytest.mark.parametrize("use_fm_loss", [False, True])
def test_perceptual_loss_matches_jax(arch, use_fm_loss):
    """Both trunks see the same ImageNet-normalised inputs; the gaze slot
    adds 4.0."""
    jmod, v, model, pred, tgt = _perceptual_pair(arch, 16)
    want = float(jmod.apply(v, pred, tgt, use_fm_loss))
    got = model(t(pred), t(tgt), use_fm_loss).item()
    np.testing.assert_allclose(got, want, **SCALAR)
    assert model(t(pred), t(pred)).item() == 4.0  # identical images: the constant


@pytest.mark.parametrize("arch", ["tiny", "full"])
def test_perceptual_fm_loss_without_a_vgg19_weight_matches_jax(arch):
    """weights['vgg19'] = 0 with use_fm_loss: JAX builds VGG19 for the
    feature-matching term alone; the port builds it when the constructor
    asks for it, and raises if it was not asked."""
    ja, ta = ARCHS[arch]
    size = 64 if arch == "tiny" else 32
    pred, tgt = _images(25, (2, size, size, 3)), _images(26, (2, size, size, 3))
    weights = dict(perceptual.DEFAULT_WEIGHTS, vgg19=0.0)
    jmod = jperc.PerceptualLoss(weights=weights, policy=JP, arch=ja)
    shapes = jax.eval_shape(functools.partial(jmod.init, use_fm_loss=True),
                            jax.random.PRNGKey(0), pred, tgt)
    v = numpy_fill(shapes, 27)
    assert "vgg19" in v["params"]
    model = bridged(perceptual.PerceptualLoss(weights, policy=FP32_POLICY, arch=ta,
                                              use_fm_loss=True), v)
    want = float(jmod.apply(v, pred, tgt, True))
    with torch.no_grad():
        got = model(t(pred), t(tgt), True).item()
    np.testing.assert_allclose(got, want, **SCALAR)
    with pytest.raises(ValueError, match="use_fm_loss"):
        perceptual.PerceptualLoss(weights, policy=FP32_POLICY, arch=ta)(
            t(pred), t(tgt), True)


def test_perceptual_gradient_reaches_the_prediction():
    """The frozen trunks pass the gradient on to the prediction, as
    jax.grad of the JAX loss does."""
    jmod, v, model, pred, tgt = _perceptual_pair("tiny", 20)
    want = jax.grad(lambda p: jmod.apply(v, p, tgt))(jnp.asarray(pred))
    x = t(pred).requires_grad_(True)
    model(x, t(tgt)).backward()
    _close_maps(x.grad, want)
    assert all(p.grad is None for p in model.parameters())


def test_build_perceptual_loss_is_frozen():
    model = perceptual.build_perceptual_loss("tiny", policy=FP32_POLICY, device="cpu")
    assert not any(p.requires_grad for p in model.parameters())
    assert not model.training
    assert model.vgg19 is not None and model.lpips is not None


# ---------------------------------------------------------------------------
# Discriminator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["tiny", "full"])
def test_discriminator_matches_jax(arch):
    """Patch logits in float32 and the gradient with respect to the first
    image (the path G's adversarial term takes)."""
    ja, ta = ARCHS[arch]
    a, b = _images(21, (2, 64, 64, 3)), _images(22, (2, 64, 64, 3))
    jmod = JDiscriminator(policy=JP, arch=ja)
    v = numpy_init(jmod, a, b, seed=23)
    want = np.asarray(jmod.apply(v, a, b))
    model = bridged(Discriminator(policy=FP32_POLICY, arch=ta), v)
    x = t(a).requires_grad_(True)
    got = model(x, t(b))
    assert got.dtype == torch.float32
    assert want.shape == (2, 64 // 2 ** ja.disc_stages, 64 // 2 ** ja.disc_stages, 1)
    _close_maps(got, want)
    rng = np.random.default_rng(24)
    ct = rng.normal(size=want.shape).astype(np.float32)
    jgrad = jax.grad(lambda p: jnp.sum(jmod.apply(v, p, b) * ct))(jnp.asarray(a))
    (got * t(ct)).sum().backward()
    _close_maps(x.grad, jgrad)


def test_build_discriminator_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_discriminator("tiny")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        perceptual.build_perceptual_loss("tiny")
    model = build_discriminator("tiny", policy=FP32_POLICY, device="cpu", seed=3)
    again = build_discriminator("tiny", policy=FP32_POLICY, device="cpu", seed=3)
    for p, q in zip(model.parameters(), again.parameters(), strict=True):
        assert torch.equal(p, q)
