"""Port parity on CPU: leaf layers and residual blocks against the JAX
package, weights carried across by utils/jax_bridge.

Both sides run FP32_POLICY (JAX at matmul precision 'highest', set by
conftest). Tolerance 1e-4 (absolute and relative): float32 convs and norms
summed in another order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from megaportraits_tpu.core.dtypes import FP32_POLICY as JP
from megaportraits_tpu.nn import blocks as jb
from megaportraits_tpu.nn import layers as jl

from megaportraits_tpu_torch.core.dtypes import FP32_POLICY as TP
from megaportraits_tpu_torch.nn import blocks as tb
from megaportraits_tpu_torch.nn import layers as tl

from torch_port_utils import bridged, init_jax, n, t, uniform

TOL = dict(atol=1e-4, rtol=1e-4)


def _run(jmod, tmod, x, stats_seed=None, jkw=None, tkw=None):
    v = init_jax(jmod, jnp.asarray(x), stats_seed=stats_seed, **(jkw or {}))
    want = jmod.apply(v, jnp.asarray(x), **(jkw or {}))
    tmod = bridged(tmod, v).eval()
    with torch.no_grad():
        got = tmod(t(x), **(tkw or {}))
    return np.asarray(want), n(got), v, tmod


@pytest.mark.parametrize("nd,groups,stride,pad", [
    (2, 1, 1, 1), (2, 2, 2, 1), (2, 1, 2, 3), (3, 1, 1, 1), (3, 1, 1, 0),
])
def test_torch_conv(nd, groups, stride, pad):
    shape = (2,) + (6,) * nd + (8,)
    k = (7, 7) if pad == 3 else (3,) * nd if pad else (1,) * nd
    x = uniform(np.random.default_rng(0), shape)
    want, got, _, _ = _run(
        jl.TorchConv(12, k, strides=stride, padding=pad, feature_group_count=groups,
                     policy=JP),
        tl.TorchConv(8, 12, k, strides=stride, padding=pad,
                     feature_group_count=groups, policy=TP), x)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("nd", [2, 3])
def test_ws_conv(nd):
    x = uniform(np.random.default_rng(1), (1,) + (5,) * nd + (6,))
    want, got, _, _ = _run(jl.WSConv(10, (3,) * nd, padding=1, policy=JP),
                           tl.WSConv(6, 10, (3,) * nd, padding=1, policy=TP), x)
    np.testing.assert_allclose(got, want, **TOL)


def test_dense():
    x = uniform(np.random.default_rng(2), (3, 20))
    want, got, _, _ = _run(jl.TorchDense(7, policy=JP),
                           tl.TorchDense(20, 7, policy=TP), x)
    np.testing.assert_allclose(got, want, **TOL)


def test_group_norms():
    x = uniform(np.random.default_rng(3), (2, 3, 4, 5, 64), -2.0, 3.0)
    np.testing.assert_allclose(n(tl.GroupNorm32()(t(x))),
                               np.asarray(jl.GroupNorm32()(jnp.asarray(x))), **TOL)
    for jm, tm in ((jl.AffineGroupNorm(policy=JP), tl.AffineGroupNorm(64, policy=TP)),
                   (jl.AdaptiveGroupNorm(policy=JP),
                    tl.AdaptiveGroupNorm(64, policy=TP))):
        v = init_jax(jm, jnp.asarray(x))
        rng = np.random.default_rng(4)
        v = {"params": {k: (rng.normal(size=a.shape).astype(np.float32)
                            if not isinstance(a, dict) else
                            {kk: rng.normal(size=aa.shape).astype(np.float32)
                             for kk, aa in a.items()})
                        for k, a in v["params"].items()}}
        want = jm.apply(v, jnp.asarray(x))
        with torch.no_grad():
            got = bridged(tm, v)(t(x))
        np.testing.assert_allclose(n(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("dims", [2, 3])
def test_resblock_custom(dims):
    x = uniform(np.random.default_rng(5), (1,) + (6,) * dims + (32,))
    want, got, _, _ = _run(jb.ResBlockCustom(dims, 64, policy=JP),
                           tb.ResBlockCustom(dims, 32, 64, policy=TP), x)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("cin,cout", [(32, 32), (32, 64)])
def test_resblock3d(cin, cout):
    x = uniform(np.random.default_rng(6), (1, 2, 4, 4, cin))
    want, got, _, _ = _run(jb.ResBlock3D(cout, policy=JP),
                           tb.ResBlock3D(cin, cout, policy=TP), x)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("cin,cout", [(32, 32), (64, 32)])
def test_resblock3d_adaptive(cin, cout):
    x = uniform(np.random.default_rng(7), (2, 2, 4, 4, cin))
    want, got, _, _ = _run(jb.ResBlock3DAdaptive(cout, policy=JP),
                           tb.ResBlock3DAdaptive(cin, cout, policy=TP), x)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("cin,cout", [(32, 32), (32, 64)])
def test_resblock2d_eval(cin, cout):
    """Eval mode with non-trivial running statistics."""
    x = uniform(np.random.default_rng(8), (2, 8, 8, cin))
    want, got, _, _ = _run(jb.ResBlock2D(cout, policy=JP),
                           tb.ResBlock2D(cin, cout, policy=TP), x, stats_seed=9)
    np.testing.assert_allclose(got, want, **TOL)


def test_jax_resblock2d_downsample_is_broken():
    """Why the port has no ``downsample`` option: the JAX block strides only
    the shortcut, so its residual add fails for every input."""
    x = uniform(np.random.default_rng(8), (1, 8, 8, 32))
    with pytest.raises(TypeError):
        init_jax(jb.ResBlock2D(64, downsample=True, policy=JP), jnp.asarray(x))


def test_resblock2d_train_updates_running_stats():
    """train=True: batch statistics, and (module in .train()) the running
    statistics move as 0.9*old + 0.1*new, like JAX's mutable batch_stats."""
    x = uniform(np.random.default_rng(10), (2, 8, 8, 32), -1.0, 2.0)
    jm = jb.ResBlock2D(64, policy=JP)
    v = init_jax(jm, jnp.asarray(x), stats_seed=11)
    want, upd = jm.apply(v, jnp.asarray(x), True, mutable=["batch_stats"])
    tm = bridged(tb.ResBlock2D(32, 64, policy=TP), v).train()
    with torch.no_grad():
        got = tm(t(x), train=True)
    np.testing.assert_allclose(n(got), np.asarray(want), **TOL)
    for name in ("bn1", "bn2", "shortcut_bn"):
        bn = getattr(tm, name)
        np.testing.assert_allclose(n(bn.running_mean),
                                   np.asarray(upd["batch_stats"][f"{name}_mean"]),
                                   **TOL)
        np.testing.assert_allclose(n(bn.running_var),
                                   np.asarray(upd["batch_stats"][f"{name}_var"]),
                                   **TOL)


def test_batchnorm_eval_module_does_not_record():
    bn = tl.BatchNorm(4, policy=TP).eval()
    x = torch.randn(8, 4) * 3 + 1
    bn(x, train=True)
    assert torch.equal(bn.running_mean, torch.zeros(4))
    assert torch.equal(bn.running_var, torch.ones(4))


def test_resblock2d_kernel_path_matches_jax_fused_path():
    """``ResBlock2D.chain_params`` (K2's operands of one block) through K1's
    plain version twice, conv1+BN1+ReLU then conv2+BN2+residual+ReLU,
    against the JAX block with use_pallas in Pallas interpret mode, and
    against the block itself."""
    from jax.experimental.pallas import tpu as pltpu

    from megaportraits_tpu_torch.ops.kernels.conv3x3 import conv3x3_bn_act_plain

    x = uniform(np.random.default_rng(12), (1, 16, 16, 128))
    jm = jb.ResBlock2D(128, policy=JP, use_pallas=True)
    v = init_jax(jm, jnp.asarray(x), stats_seed=13)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jm.apply(v, jnp.asarray(x)))
    block = bridged(tb.ResBlock2D(128, 128, policy=TP), v).eval()
    with torch.no_grad():
        k1, k2, s1, t1, s2, t2 = block.chain_params()
        h = conv3x3_bn_act_plain(t(x)[0], k1, s1, t1, None, relu=True)
        got_f = n(conv3x3_bn_act_plain(h, k2, s2, t2, t(x)[0], relu=True))[None]
        got_p = n(block(t(x)))
    np.testing.assert_allclose(got_f, want, **TOL)
    np.testing.assert_allclose(got_f, got_p, **TOL)


def test_resblock2d_group_norm_not_ported_yet():
    """The norms that are ported are 'batch' and 'group'; any other is
    refused when the block is built."""
    with pytest.raises(ValueError):
        tb.ResBlock2D(32, 32, norm="layer")
    gn = tb.ResBlock2D(32, 64, norm="group")
    assert {"gn1.weight", "gn2.bias", "shortcut_gn.weight"} <= set(gn.state_dict())


def test_instance_norm():
    x = uniform(np.random.default_rng(14), (2, 5, 6, 16), -2.0, 3.0)
    np.testing.assert_allclose(n(tl.InstanceNorm()(t(x))),
                               np.asarray(jl.InstanceNorm()(jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("cin,cout", [(32, 32), (32, 64)])
@pytest.mark.parametrize("train", [False, True])
def test_resblock2d_group_norm(cin, cout, train):
    """norm='group': with and without the shortcut; ``train`` changes
    nothing (GroupNorm has no batch statistics)."""
    x = uniform(np.random.default_rng(15), (2, 8, 8, cin))
    want, got, v, tmod = _run(jb.ResBlock2D(cout, policy=JP, norm="group"),
                              tb.ResBlock2D(cin, cout, policy=TP, norm="group"),
                              x, jkw=dict(train=train), tkw=dict(train=train))
    assert "batch_stats" not in v
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("cin,cout", [(32, 32), (64, 32)])
def test_resblock2d_adaptive(cin, cout):
    x = uniform(np.random.default_rng(16), (2, 6, 6, cin))
    want, got, _, _ = _run(jb.ResBlock2DAdaptive(cout, policy=JP),
                           tb.ResBlock2DAdaptive(cin, cout, policy=TP), x)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("cin,cout,downsample", [
    (16, 16, False), (16, 24, False), (16, 32, True),
])
def test_resblock_bn(cin, cout, downsample):
    """Eval mode with non-trivial running statistics: the identity, the
    width-changing and the downsampling shortcut."""
    x = uniform(np.random.default_rng(17), (2, 8, 8, cin))
    want, got, _, tmod = _run(jb.ResBlockBN(cout, downsample=downsample, policy=JP),
                              tb.ResBlockBN(cin, cout, downsample, policy=TP), x,
                              stats_seed=18)
    assert (tmod.shortcut_conv is None) == (cin == cout and not downsample)
    assert got.shape == (2, 4 if downsample else 8, 4 if downsample else 8, cout)
    np.testing.assert_allclose(got, want, **TOL)


def _avatars():
    return dict(avatar_index=jnp.asarray([2, 0])), dict(avatar_index=torch.tensor([2, 0]))


def test_spade():
    x = uniform(np.random.default_rng(19), (2, 6, 6, 16))
    jkw, tkw = _avatars()
    want, got, _, _ = _run(jb.SPADE(3, policy=JP), tb.SPADE(16, 3, policy=TP), x,
                           jkw=jkw, tkw=tkw)
    assert not np.allclose(got[0], got[1])
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("cin,cout", [(16, 16), (16, 24), (24, 16)])
def test_spade_resblock(cin, cout):
    """Without (same width) and with the learned 1x1 shortcut."""
    x = uniform(np.random.default_rng(20), (2, 6, 6, cin))
    jkw, tkw = _avatars()
    want, got, v, tmod = _run(jb.SPADEResBlock(cout, 3, policy=JP),
                              tb.SPADEResBlock(cin, cout, 3, policy=TP), x,
                              jkw=jkw, tkw=tkw)
    assert ("conv_s" in v["params"]) == (cin != cout) == (tmod.conv_s is not None)
    np.testing.assert_allclose(got, want, **TOL)
