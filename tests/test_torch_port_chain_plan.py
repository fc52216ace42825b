"""What surrounds the K1/K2 kernels and runs on the CPU: the tile-box
chooser, a plain-PyTorch emulation of the kernel's data path, and the cache
of the G2d trunk's folded operands.

Tolerances. The emulation sums each output over steps of one tap and one
64-channel slice in float32 where the plain version runs one float32 convolution, so
the two differ by the order of summation: 2e-5 absolute and relative at
these sizes (outputs of order 1). Against the JAX package's Pallas kernel in
interpret mode it is the 1e-4 that tests/test_torch_port_kernels.py uses
for K1. G2d against the JAX G2d, both with the chain switch on: 2e-4, as in
tests/test_torch_port_models.py.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from megaportraits_tpu.core.arch import TINY as JT
from megaportraits_tpu.core.dtypes import FP32_POLICY as JP
from megaportraits_tpu.models import g2d as jg2
from megaportraits_tpu.ops.pallas.conv2d import fused_conv3x3

from megaportraits_tpu_torch.core.arch import TINY
from megaportraits_tpu_torch.core.dtypes import FP32_POLICY as TP
from megaportraits_tpu_torch.infer.streaming import ReenactmentSession
from megaportraits_tpu_torch.models import g2d as tg2
from megaportraits_tpu_torch.models.gbase import build_gbase
from megaportraits_tpu_torch.ops.kernels import conv3x3 as k1

from torch_port_utils import bridged, n, numpy_init, t, uniform

ORDER_TOL = dict(atol=2e-5, rtol=2e-5)
PALLAS_TOL = dict(atol=1e-4, rtol=1e-4)
G2D_TOL = dict(atol=2e-4, rtol=2e-4)


def _check_boxes(h, w):
    bh, bw = k1.tile_box(h, w)
    assert bh * bw == 128
    assert bw in (8, 16, 32, 64)
    assert bw >= min(w, 64) and (bw == 8 or bw // 2 < w)  # the smallest that fits
    covered = np.zeros((h, w), np.int32)
    for y0, x0 in k1.tile_origins(h, w):
        assert 0 <= y0 < h and 0 <= x0 < w  # every box touches the image
        covered[y0:y0 + bh, x0:x0 + bw] += 1  # numpy clips the box to the image
    assert (covered == 1).all()


@pytest.mark.parametrize("shape", [(64, 64), (40, 24), (16, 16), (10, 12),
                                   (8, 8), (9, 65), (1, 1), (3, 200)])
def test_tile_boxes_cover_each_pixel_once(shape):
    _check_boxes(*shape)


@settings(max_examples=60, deadline=None, database=None)
@given(st.integers(1, 150), st.integers(1, 150))
def test_tile_boxes_cover_each_pixel_once_sweep(h, w):
    _check_boxes(h, w)


def test_tile_box_rejects_empty_image():
    with pytest.raises(ValueError):
        k1.tile_box(0, 8)


def test_staged_bytes_of_the_tile_plan():
    # The trunk conv: 32 x 4 tiles, each 8 slices x (a 4 x 66 haloed box of
    # 128-byte rows + 9 weight boxes of 16 KB).
    assert k1.staged_bytes(64, 64, 512, 512) == 128 * 8 * (4 * 66 * 128 + 9 * 16384)
    # 10x12x32->40: 2 tiles of 8 x 16 pixels, one slice, one 64-channel half;
    # every tap of both tiles touches the image.
    assert k1.staged_bytes(10, 12, 32, 40) == 2 * 9 * (16384 + 8192)
    # 9 rows in boxes of 8: the second tile's bottom taps lie outside.
    assert k1.staged_bytes(9, 16, 64, 128) == (9 + 6) * (16384 + 16384)


def _conv_inputs(seed, h, w, c, f):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(h, w, c)).astype(np.float32)
    kern = (rng.normal(size=(3, 3, c, f)) * 0.05).astype(np.float32)
    s = rng.uniform(0.5, 1.5, (f,)).astype(np.float32)
    sh = (rng.normal(size=(f,)) * 0.1).astype(np.float32)
    res = rng.normal(size=(h, w, f)).astype(np.float32)
    return x, kern, s, sh, res


# C and F that are no multiples of 64; images narrower and wider than a box,
# with a last tile of one row and of one column (taps wholly outside); boxes
# 64 wide take the nine taps from one box with its halo.
@pytest.mark.parametrize("shape", [(10, 12, 32, 40), (9, 65, 96, 136),
                                   (16, 16, 64, 64), (5, 33, 32, 8),
                                   (3, 130, 64, 72)])
@pytest.mark.parametrize("with_residual", [False, True])
@pytest.mark.parametrize("relu", [True, False])
def test_boxed_data_path_matches_plain(shape, with_residual, relu):
    x, kern, s, sh, res = _conv_inputs(20, *shape)
    args = (t(x), t(kern), t(s), t(sh), t(res) if with_residual else None)
    got = k1.conv3x3_bn_act_boxed(*args, relu=relu)
    want = k1.conv3x3_bn_act_plain(*args, relu=relu)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(n(got), n(want), **ORDER_TOL)


@pytest.mark.parametrize("shape,y_tile", [((12, 12, 32, 40), 4),
                                          ((8, 20, 96, 136), 8),
                                          ((8, 40, 32, 40), 4)])
@pytest.mark.parametrize("with_residual", [False, True])
def test_boxed_data_path_matches_pallas_interpret(shape, y_tile, with_residual):
    x, kern, s, sh, res = _conv_inputs(21, *shape)
    r = res if with_residual else None
    with pltpu.force_tpu_interpret_mode():
        want = fused_conv3x3(jnp.asarray(x), jnp.asarray(kern), jnp.asarray(s),
                             jnp.asarray(sh),
                             residual=None if r is None else jnp.asarray(r),
                             relu=True, y_tile=y_tile)
    got = k1.conv3x3_bn_act_boxed(t(x), t(kern), t(s), t(sh),
                                  None if r is None else t(r))
    np.testing.assert_allclose(n(got), np.asarray(want), **PALLAS_TOL)


def test_boxed_data_path_keeps_dtype_and_checks_shapes():
    x, kern, s, sh, res = _conv_inputs(22, 8, 8, 32, 32)
    out = k1.conv3x3_bn_act_boxed(t(x).bfloat16(), t(kern).bfloat16(), t(s),
                                  t(sh), t(res).bfloat16())
    assert out.dtype == torch.bfloat16 and out.shape == (8, 8, 32)
    with pytest.raises(ValueError):
        k1.conv3x3_bn_act_boxed(t(x), t(kern)[:, :, :16], t(s), t(sh))


# ---- the cache of the trunk's folded operands ----------------------------

@pytest.fixture(scope="module")
def g2d_case():
    x = uniform(np.random.default_rng(30), (2, 8, 8, TINY.volume_channels))
    jmod = jg2.G2d(policy=JP, arch=JT, use_chain_kernel=True)
    variables = [numpy_init(jmod, jnp.asarray(x), seed=s, stats_seed=s + 10)
                 for s in (0, 1)]
    return x, jmod, variables


def _jax_chain(jmod, v, x):
    # One jitted call. Applied eagerly, it once hung on a loaded CPU: the
    # main thread in an eager op after the chain, a thread in the
    # interpreted kernel's callback, both waiting.
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(jax.jit(jmod.apply)(v, jnp.asarray(x)))


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def test_cached_trunk_operands_equal_a_fresh_fold(g2d_case):
    x, _, (v0, _) = g2d_case
    mod = bridged(tg2.G2d(policy=TP, arch=TINY, use_chain_kernel=True), v0).eval()
    cached = mod.cached_trunk_chain_params()
    assert mod.trunk_cache.folds == 1
    assert _same(cached, mod.trunk_chain_params())
    again = mod.cached_trunk_chain_params()
    assert mod.trunk_cache.folds == 1
    assert all(a is b for a, b in zip(cached, again))
    weights, scales, shifts = cached
    nb, c = TINY.g2d_blocks, TINY.ch(512)
    assert weights.shape == (nb, 2, 3, 3, c, c)
    assert scales.shape == shifts.shape == (nb, 2, c)
    assert not any(a.requires_grad for a in cached)


def test_trunk_operands_follow_the_weights_and_match_jax(g2d_case):
    """After each way a trunk tensor can change, the next call folds again
    and the output equals the JAX G2d's (chain kernel in interpret mode) on
    the same variables, and differs from the output before."""
    x, jmod, (v0, v1) = g2d_case
    mod = bridged(tg2.G2d(policy=TP, arch=TINY, use_chain_kernel=True), v0).eval()

    def run():
        with torch.no_grad():
            return n(mod(t(x)))

    outs = [run()]
    np.testing.assert_allclose(outs[0], _jax_chain(jmod, v0, x), **G2D_TOL)
    assert mod.trunk_cache.folds == 1
    run()
    assert mod.trunk_cache.folds == 1  # nothing changed: nothing folded

    # 1. Another seed's variables, loaded in place through the bridge.
    bridged(mod, v1)
    v = {k: {**v1[k]} for k in v1}
    outs.append(run())
    np.testing.assert_allclose(outs[-1], _jax_chain(jmod, v, x), **G2D_TOL)
    assert mod.trunk_cache.folds == 2

    # 2. BatchNorm running statistics written in place.
    with torch.no_grad():
        mod.res0.bn1.running_mean.add_(0.3)
        mod.res1.bn2.running_var.mul_(2.0)
    v["batch_stats"]["res0"] = {**v["batch_stats"]["res0"]}
    v["batch_stats"]["res1"] = {**v["batch_stats"]["res1"]}
    v["batch_stats"]["res0"]["bn1_mean"] = v["batch_stats"]["res0"]["bn1_mean"] + 0.3
    v["batch_stats"]["res1"]["bn2_var"] = v["batch_stats"]["res1"]["bn2_var"] * 2.0
    outs.append(run())
    np.testing.assert_allclose(outs[-1], _jax_chain(jmod, v, x), **G2D_TOL)
    assert mod.trunk_cache.folds == 3

    # 3. A weight updated in place, as an optimiser step does.
    with torch.no_grad():
        mod.res1.conv2.weight.mul_(1.5)
        mod.res0.conv1.bias.add_(0.2)
    v["params"]["res0"] = {**v["params"]["res0"]}
    v["params"]["res1"] = {**v["params"]["res1"]}
    v["params"]["res1"]["conv2_kernel"] = v["params"]["res1"]["conv2_kernel"] * 1.5
    v["params"]["res0"]["conv1_bias"] = v["params"]["res0"]["conv1_bias"] + 0.2
    outs.append(run())
    np.testing.assert_allclose(outs[-1], _jax_chain(jmod, v, x), **G2D_TOL)
    assert mod.trunk_cache.folds == 4
    assert _same(mod.cached_trunk_chain_params(), mod.trunk_chain_params())

    for before, after in zip(outs, outs[1:]):
        assert np.abs(after - before).max() > 1e-3


def test_trunk_operands_follow_dtype_and_replaced_tensors(g2d_case):
    _, _, (v0, _) = g2d_case
    mod = bridged(tg2.G2d(policy=TP, arch=TINY, use_chain_kernel=True), v0).eval()
    mod.cached_trunk_chain_params()
    mod.res0.conv1.weight.data = mod.res0.conv1.weight.data.clone() * 2.0
    got = mod.cached_trunk_chain_params()
    assert mod.trunk_cache.folds == 2
    assert _same(got, mod.trunk_chain_params())
    mod.double()
    got = mod.cached_trunk_chain_params()
    assert mod.trunk_cache.folds == 3
    assert got[1].dtype == torch.float32  # scales stay float32


def test_resblock2d_kernel_path_folds_once():
    """ResBlock2D's use_pallas path keeps its folded operands too."""
    from megaportraits_tpu_torch.nn.blocks import ResBlock2D
    from megaportraits_tpu_torch.nn.layers import init_parameters

    rng = np.random.default_rng(31)
    block = init_parameters(ResBlock2D(128, 128, policy=TP, use_pallas=True),
                            seed=6).eval()
    with torch.no_grad():
        block.bn1.running_mean.copy_(t(uniform(rng, (128,), -0.2, 0.2)))
    x = t(uniform(rng, (1, 8, 8, 128)))
    plain = ResBlock2D(128, 128, policy=TP).eval()
    plain.load_state_dict(block.state_dict())
    with torch.no_grad():
        a, b = block(x), block(x)
        want = plain(x)
    assert block.chain_cache.folds == 1 and torch.equal(a, b)
    np.testing.assert_allclose(n(a), n(want), atol=1e-4, rtol=1e-4)
    with torch.no_grad():
        block.bn2.weight.mul_(0.5)
        c = block(x)
    assert block.chain_cache.folds == 2
    assert (c - a).abs().max() > 1e-3


def test_drive_loop_folds_the_trunk_once():
    model = build_gbase("tiny", policy=TP, device="cpu", seed=5)
    model.g2d.use_chain_kernel = True
    rng = np.random.default_rng(32)
    session = ReenactmentSession(model=model, bn_mode="running")
    session.set_source(t(uniform(rng, (1, 64, 64, 3), 0.0, 1.0)))
    frames = [session(t(uniform(rng, (1, 64, 64, 3), 0.0, 1.0))) for _ in range(3)]
    assert model.g2d.trunk_cache.folds == 1
    assert all(f.shape == (1, 64, 64, 3) for f in frames)
    model.g2d.use_chain_kernel = False
    plain = session(t(uniform(np.random.default_rng(32), (1, 64, 64, 3), 0.0, 1.0)))
    assert plain.shape == (1, 64, 64, 3) and model.g2d.trunk_cache.folds == 1
