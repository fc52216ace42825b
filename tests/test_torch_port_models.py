"""Port parity on CPU: the stage-1 sub-networks at TINY against the JAX
package, weights (and non-trivial BN statistics) carried across by
utils/jax_bridge. FP32 on both sides.

Tolerances: 1e-4 absolute and relative for single networks (float32 convs
in another order), 2e-4 for Eapp and G2d, whose outputs pass 10+ convs and
GroupNorms; the pose angles in degrees get 1e-3.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from megaportraits_tpu.core.arch import TINY as JT
from megaportraits_tpu.core.dtypes import FP32_POLICY as JP
from megaportraits_tpu.models import eapp as je
from megaportraits_tpu.models import emtn as jm
from megaportraits_tpu.models import g2d as jg2
from megaportraits_tpu.models import g3d as jg3
from megaportraits_tpu.models import repvgg as jr
from megaportraits_tpu.models import resnet as jres
from megaportraits_tpu.models import warpgen as jw

from megaportraits_tpu_torch.core.arch import TINY
from megaportraits_tpu_torch.core.dtypes import FP32_POLICY as TP
from megaportraits_tpu_torch.models import eapp as te
from megaportraits_tpu_torch.models import emtn as tm
from megaportraits_tpu_torch.models import g2d as tg2
from megaportraits_tpu_torch.models import g3d as tg3
from megaportraits_tpu_torch.models import repvgg as tr
from megaportraits_tpu_torch.models import resnet as tres
from megaportraits_tpu_torch.models import warpgen as tw

from torch_port_utils import engaged_on_cpu  # noqa: F401  (a fixture)
from torch_port_utils import bridged, init_jax, n, t, uniform

TOL = dict(atol=1e-4, rtol=1e-4)


def _img(seed, shape=(2, 64, 64, 3)):
    return uniform(np.random.default_rng(seed), shape, 0.0, 1.0)


def _eval(module, variables, *args, **kwargs):
    module = bridged(module, variables).eval()
    with torch.no_grad():
        return module(*args, **kwargs)


def test_resnet18_head():
    x = _img(0)
    jmod = jres.ResNet18(num_classes=6, policy=JP, arch=JT)
    v = init_jax(jmod, jnp.asarray(x), stats_seed=1)
    got = _eval(tres.ResNet18(num_classes=6, policy=TP, arch=TINY), v, t(x))
    np.testing.assert_allclose(n(got), np.asarray(jmod.apply(v, jnp.asarray(x))),
                               **TOL)


def test_custom_resnet50_adaptive_pool():
    x = _img(2, (1, 72, 72, 3))  # 5x5 last map: uneven 2x2 pool bins
    jmod = jres.CustomResNet50(policy=JP, arch=JT)
    v = init_jax(jmod, jnp.asarray(x), stats_seed=3)
    got = _eval(tres.CustomResNet50(policy=TP, arch=TINY), v, t(x))
    want = jmod.apply(v, jnp.asarray(x))
    assert got.shape == want.shape == (1, 2, 2, TINY.ch(512))
    np.testing.assert_allclose(n(got), np.asarray(want), **TOL)


def test_max_pool_and_adaptive_pool_helpers():
    x = uniform(np.random.default_rng(4), (2, 9, 7, 3))
    np.testing.assert_allclose(n(tres.max_pool_3x3_s2(t(x))),
                               np.asarray(jres.max_pool_3x3_s2(jnp.asarray(x))))
    np.testing.assert_allclose(
        n(tres.adaptive_avg_pool_2d(t(x), (2, 3))),
        np.asarray(jres.adaptive_avg_pool_2d(jnp.asarray(x), (2, 3))), atol=1e-6)


def test_sixdrepnet_deploy_grouped():
    x = _img(5, (2, 64, 64, 3))
    jmod = jr.SixDRepNet(policy=JP, arch=JT)
    v = init_jax(jmod, jnp.asarray(x))
    rot, eul = _eval(tr.SixDRepNet(policy=TP, arch=TINY), v, t(x))
    jrot, jeul = jmod.apply(v, jnp.asarray(x))
    np.testing.assert_allclose(n(rot), np.asarray(jrot), **TOL)
    np.testing.assert_allclose(n(eul), np.asarray(jeul), atol=1e-3)


def test_rotation_math_with_gimbal_branch():
    rng = np.random.default_rng(6)
    six = rng.normal(size=(4, 6)).astype(np.float32)
    want = jr.rotation_6d_to_matrix(jnp.asarray(six))
    np.testing.assert_allclose(n(tr.rotation_6d_to_matrix(t(six))),
                               np.asarray(want), atol=1e-6)
    mats = np.asarray(want).copy()
    # Gimbal lock: R[0,0] = R[1,0] = 0 (sy < 1e-6) takes the singular branch.
    mats[0] = np.array([[0, 0, 1], [0, 1, 0], [-1, 0, 0]], np.float32)
    np.testing.assert_allclose(n(tr.euler_angles_from_matrix(t(mats))),
                               np.asarray(jr.euler_angles_from_matrix(
                                   jnp.asarray(mats))), atol=1e-6)


@pytest.mark.parametrize("train", [False, True])
def test_emtn(train):
    """Default 224/256 input resizes (the 300px image is resized for both
    the rotation net and the descriptor nets), tile-then-flatten order."""
    x = _img(7, (2, 300, 300, 3))
    jmod = jm.Emtn(policy=JP, arch=JT)
    v = init_jax(jmod, jnp.asarray(x), stats_seed=8)
    tmod = bridged(tm.Emtn(policy=TP, arch=TINY), v).eval()
    with torch.no_grad():
        got = tmod(t(x), train)
    if train:
        want, _ = jmod.apply(v, jnp.asarray(x), True, mutable=["batch_stats"])
    else:
        want = jmod.apply(v, jnp.asarray(x))
    for g, w, tol in zip(got, want, (dict(atol=1e-3), TOL, TOL)):
        np.testing.assert_allclose(n(g), np.asarray(w), **tol)


def test_eapp():
    x = _img(9, (1, 64, 64, 3))
    jmod = je.Eapp(policy=JP, arch=JT)
    v = init_jax(jmod, jnp.asarray(x), stats_seed=10)
    vs, es = _eval(te.Eapp(policy=TP, arch=TINY), v, t(x))
    jvs, jes = jmod.apply(v, jnp.asarray(x))
    assert vs.shape == (1, TINY.volume_depth, 8, 8, TINY.volume_channels)
    np.testing.assert_allclose(n(vs), np.asarray(jvs), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(n(es), np.asarray(jes), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("invert", [True, False])
def test_warp_generator(invert):
    rng = np.random.default_rng(11)
    rot = rng.uniform(-30, 30, (2, 3)).astype(np.float32)
    trans = rng.uniform(-0.2, 0.2, (2, 3)).astype(np.float32)
    z = rng.normal(size=(2, TINY.compress_dim)).astype(np.float32)
    e = rng.normal(size=(2, TINY.compress_dim)).astype(np.float32)
    jmod = jw.WarpGenerator(invert=invert, policy=JP, arch=JT)
    args = [jnp.asarray(a) for a in (rot, trans, z, e)]
    v = init_jax(jmod, *args)
    got = _eval(tw.WarpGenerator(invert=invert, policy=TP, arch=TINY), v,
                *[t(a) for a in (rot, trans, z, e)])
    want = jmod.apply(v, *args)
    assert got.shape == (2, 16, 16, 16, 3)
    np.testing.assert_allclose(n(got), np.asarray(want), **TOL)


def test_g3d():
    x = uniform(np.random.default_rng(12), (1, 4, 8, 8, TINY.volume_channels))
    jmod = jg3.G3d(policy=JP, arch=JT)
    v = init_jax(jmod, jnp.asarray(x))
    got = _eval(tg3.G3d(policy=TP, arch=TINY), v, t(x))
    np.testing.assert_allclose(n(got), np.asarray(jmod.apply(v, jnp.asarray(x))),
                               **TOL)


@pytest.fixture(scope="module")
def g2d_case():
    x = uniform(np.random.default_rng(13), (2, 8, 8, TINY.volume_channels))
    jmod = jg2.G2d(policy=JP, arch=JT)
    v = init_jax(jmod, jnp.asarray(x), stats_seed=14)
    return x, v, np.asarray(jmod.apply(v, jnp.asarray(x)))


@pytest.mark.parametrize("chain", [False, True])
def test_g2d(g2d_case, chain, request):
    """G2d with the kernels' gate shut, or opened on the CPU: the trunk
    through K2 and the decoder's BatchNorms through K4 (their plain
    versions)."""
    calls = request.getfixturevalue("engaged_on_cpu") if chain else []
    x, v, want = g2d_case
    got = _eval(tg2.G2d(policy=TP, arch=TINY), v, t(x))
    assert got.shape == (2, 64, 64, 3) and got.dtype == torch.float32
    assert len(calls) == (6 if chain else 0)  # the decoder's three blocks
    np.testing.assert_allclose(n(got), want, atol=2e-4, rtol=2e-4)


def test_g2d_chain_against_jax_chain_interpret(g2d_case, engaged_on_cpu):
    """JAX's chain switch on, in Pallas interpret mode, against the port
    with the kernels' gate opened on the CPU."""
    from jax.experimental.pallas import tpu as pltpu

    x, v, _ = g2d_case
    jmod = jg2.G2d(policy=JP, arch=JT, use_chain_kernel=True)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jmod.apply(v, jnp.asarray(x)))
    got = _eval(tg2.G2d(policy=TP, arch=TINY), v, t(x))
    np.testing.assert_allclose(n(got), want, atol=2e-4, rtol=2e-4)
