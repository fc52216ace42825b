"""The identity net against the JAX package: InceptionResnetV1, its weight
converter, and PerceptualLoss with the 'vggface' term.

* InceptionResnetV1 (full width: it has no TINY) at 96x96, the smallest
  side its stem takes comfortably: the L2-normalised embedding and the four
  taps to 1e-4 of their largest magnitude.
* A synthetic facenet_pytorch state_dict through JAX's
  ``convert_inception_resnet`` + ``merge_params`` (bridged) and through the
  port's table: equal tensors and equal embeddings.
* ``PerceptualLoss(use_vggface=True)`` at TINY on 96x96 images: the loss
  to 1e-5 relative; without `use_vggface`, or with a zero weight, no
  identity net is built (as in JAX, whose tree then has no 'vggface').
JAX's weights are drawn with numpy (no flax ``init`` is compiled), with the
frozen BatchNorm statistics in range.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from megaportraits_tpu.core.arch import TINY as JTINY
from megaportraits_tpu.core.dtypes import FP32_POLICY as JP
from megaportraits_tpu.losses import perceptual as jperc
from megaportraits_tpu.losses import vggface as jvggface
from megaportraits_tpu.utils.torch_convert import merge_params

from megaportraits_tpu_torch.core.arch import TINY
from megaportraits_tpu_torch.core.dtypes import FP32_POLICY
from megaportraits_tpu_torch.losses import perceptual, vggface
from megaportraits_tpu_torch.utils import convert_weights as cw
from megaportraits_tpu_torch.utils.jax_bridge import jax_to_state_dict, load_jax_variables

from torch_port_utils import frozen_bn_statistics, n, numpy_init, numpy_state_dict, t

SIZE = 96


def _close(got, want, rel=1e-4):
    want = np.asarray(want, dtype=np.float32)
    got = n(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


@pytest.fixture(scope="module")
def jax_face():
    x = np.random.default_rng(0).uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    model = jvggface.InceptionResnetV1(policy=JP)
    v = frozen_bn_statistics(numpy_init(model, jnp.asarray(x), seed=0), seed=1)
    apply = jax.jit(lambda v, x: model.apply(v, x, return_taps=True))
    return v, apply, x


def test_inception_resnet_matches_jax(jax_face):
    v, apply, x = jax_face
    emb, taps = apply(v, jnp.asarray(x))
    model = load_jax_variables(vggface.InceptionResnetV1(policy=FP32_POLICY, device="cpu"), v)
    temb, ttaps = model(t(x), return_taps=True)
    assert temb.dtype == torch.float32 and temb.shape == (2, 512)
    np.testing.assert_allclose(n(torch.linalg.vector_norm(temb, dim=-1)), 1.0, atol=1e-5)
    _close(temb, emb)
    assert len(ttaps) == 4
    for a, b in zip(ttaps, taps):
        _close(a, b)
    torch.testing.assert_close(model(t(x)), temb)


def test_inception_converter_matches_jax(jax_face):
    v, apply, x = jax_face
    port = vggface.InceptionResnetV1(policy=FP32_POLICY, device="cpu")
    original = cw.original_state_dict(cw.inception_table(), numpy_state_dict(port, 2))
    assert cw.identify(original) == "vggface"
    jmerged = merge_params(v["params"], jvggface.convert_inception_resnet(original))
    key, converted = cw.convert("vggface", original)
    assert key == "vggface"
    want = jax_to_state_dict({"params": jmerged})
    assert converted.keys() == want.keys() == port.state_dict().keys()
    for k in want:
        torch.testing.assert_close(converted[k], want[k], rtol=0, atol=0)
    port.load_state_dict(converted)
    emb, _ = apply({"params": jmerged}, jnp.asarray(x))
    _close(port(t(x)), emb)


def test_perceptual_loss_with_vggface_matches_jax():
    rng = np.random.default_rng(3)
    pred, tgt = (rng.random((2, SIZE, SIZE, 3)).astype(np.float32) for _ in range(2))
    jm = jperc.PerceptualLoss(use_vggface=True, policy=JP, arch=JTINY)
    v = frozen_bn_statistics(numpy_init(jm, jnp.asarray(pred), jnp.asarray(tgt), seed=5), 6)
    assert "vggface" in v["params"]
    want = float(jax.jit(jm.apply)(v, jnp.asarray(pred), jnp.asarray(tgt)))
    model = load_jax_variables(
        perceptual.PerceptualLoss(policy=FP32_POLICY, arch=TINY, device="cpu",
                                  use_vggface=True), v)
    np.testing.assert_allclose(model(t(pred), t(tgt)).item(), want, rtol=1e-5)
    # The identity term alone: the loss less the same loss without it.
    without = load_jax_variables(
        perceptual.PerceptualLoss(policy=FP32_POLICY, arch=TINY, device="cpu"),
        {"params": {k: w for k, w in v["params"].items() if k != "vggface"}})
    assert model(t(pred), t(tgt)).item() - without(t(pred), t(tgt)).item() > 0


def test_vggface_term_is_off_by_default():
    assert perceptual.PerceptualLoss(arch=TINY, device="cpu").vggface is None
    weights = dict(perceptual.DEFAULT_WEIGHTS, vggface=0.0)
    assert perceptual.PerceptualLoss(weights, arch=TINY, device="cpu",
                                     use_vggface=True).vggface is None
    loss = perceptual.build_perceptual_loss("tiny", policy=FP32_POLICY, device="cpu",
                                            use_vggface=True)
    assert loss.vggface is not None
    assert not any(p.requires_grad for p in loss.parameters())
