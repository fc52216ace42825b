"""Kernels K1 (conv3x3_bn_act), K2 (resblock_chain) and K3
(fused_resblock_chain, the chain in one launch).

On the CPU: the plain PyTorch versions against the JAX package's Pallas
kernels in interpret mode, the way tests/test_pallas_conv.py runs them, in
float32 (tolerance 1e-4: float32 convs summed in another order); and the
wrappers' dispatch and argument checks.

The kernels themselves are held against these plain versions on the card
in tests/test_torch_port_cuda.py.

The shapes run in TPU interpret mode differ from tests/test_pallas_conv.py's
on purpose. In one process, a second interpret-mode call of a kernel at a
shape already compiled there returns at once, and test_pallas_conv.py then
dispatches its reference ops without waiting for the kernel: with those ops
compiled too, the main thread and the kernel's callbacks deadlock (seen
when both files ran in one pytest-xdist worker).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from megaportraits_tpu.ops.pallas.conv2d import fused_conv3x3
from megaportraits_tpu.ops.pallas.g2d_chain import fused_resblock_chain
from megaportraits_tpu.ops.pallas.g2d_chain_v2 import fused_resblock_chain_v2

from megaportraits_tpu_torch.ops.kernels import conv3x3 as k1
from megaportraits_tpu_torch.ops.kernels import resblock_chain as k2
from megaportraits_tpu_torch.ops.kernels import resblock_chain_fused as k3

from torch_port_utils import n, t

TOL = dict(atol=1e-4, rtol=1e-4)


def _conv_inputs(seed, h, w, c, f, scale=0.05):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(h, w, c)).astype(np.float32)
    kern = (rng.normal(size=(3, 3, c, f)) * scale).astype(np.float32)
    s = rng.uniform(0.5, 1.5, (f,)).astype(np.float32)
    sh = (rng.normal(size=(f,)) * 0.1).astype(np.float32)
    res = rng.normal(size=(h, w, f)).astype(np.float32)
    return x, kern, s, sh, res


def _chain_inputs(seed, h, w, c, nb):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(h, w, c)).astype(np.float32)
    wts = (rng.normal(size=(nb, 2, 3, 3, c, c)) * 0.05).astype(np.float32)
    sc = rng.uniform(0.8, 1.2, (nb, 2, c)).astype(np.float32)
    sh = (rng.normal(size=(nb, 2, c)) * 0.05).astype(np.float32)
    return x, wts, sc, sh


@pytest.mark.parametrize("with_residual", [False, True])
@pytest.mark.parametrize("relu", [True, False])
def test_k1_plain_matches_pallas_interpret(with_residual, relu):
    x, kern, s, sh, res = _conv_inputs(0, 8, 16, 128, 128)
    r = res if with_residual else None
    with pltpu.force_tpu_interpret_mode():
        want = fused_conv3x3(jnp.asarray(x), jnp.asarray(kern), jnp.asarray(s),
                             jnp.asarray(sh),
                             residual=None if r is None else jnp.asarray(r),
                             relu=relu)
    before = k1.conv3x3_bn_act.launches
    got = k1.conv3x3_bn_act(t(x), t(kern), t(s), t(sh),
                            None if r is None else t(r), relu=relu)
    assert k1.conv3x3_bn_act.launches == before  # CPU: plain version, no launch
    np.testing.assert_allclose(n(got), np.asarray(want), **TOL)


def test_k2_plain_matches_pallas_v2_interpret():
    x, wts, sc, sh = _chain_inputs(1, 16, 16, 128, 3)
    want = fused_resblock_chain_v2(jnp.asarray(x), jnp.asarray(wts),
                                   jnp.asarray(sc), jnp.asarray(sh), y_tile=4,
                                   interpret=True)
    before = k2.resblock_chain.launches
    got = k2.resblock_chain(t(x), t(wts), t(sc), t(sh))
    assert k2.resblock_chain.launches == before
    np.testing.assert_allclose(n(got), np.asarray(want), **TOL)


def test_k3_plain_matches_pallas_chain_interpret():
    """K3's CPU path against the JAX whole-chain kernel, run as
    tests/test_pallas_conv.py runs it; no kernel counts move."""
    x, wts, sc, sh = _chain_inputs(6, 8, 16, 128, 2)
    with pltpu.force_tpu_interpret_mode():
        want = fused_resblock_chain(jnp.asarray(x), jnp.asarray(wts),
                                    jnp.asarray(sc), jnp.asarray(sh))
    before = (k1.conv3x3_bn_act.launches, k2.resblock_chain.launches,
              k3.fused_resblock_chain.launches)
    got = k3.fused_resblock_chain(t(x), t(wts), t(sc), t(sh))
    assert (k1.conv3x3_bn_act.launches, k2.resblock_chain.launches,
            k3.fused_resblock_chain.launches) == before
    np.testing.assert_allclose(n(got), np.asarray(want), **TOL)
    torch.testing.assert_close(
        got, k2.resblock_chain_plain(t(x), t(wts), t(sc), t(sh)), atol=0, rtol=0)


def test_k3_rejects_bad_shapes_and_other_devices():
    x, wts, sc, sh = _chain_inputs(7, 8, 8, 32, 2)
    with pytest.raises(ValueError):
        k3.fused_resblock_chain(t(x), t(wts)[:, :1], t(sc), t(sh))
    with pytest.raises(ValueError):
        k3.fused_resblock_chain(t(x)[None], t(wts), t(sc), t(sh))
    meta = [t(a).to("meta") for a in (x, wts, sc, sh)]
    with pytest.raises(ValueError, match="no kernel for device"):
        k3.fused_resblock_chain(*meta)


def test_k2_plain_is_k1_chain_with_zero_padded_h():
    """conv2 pads h with zeros: the chain equals two K1 calls per block."""
    x, wts, sc, sh = _chain_inputs(2, 8, 8, 32, 2)
    cur = t(x)
    for b in range(2):
        h = k1.conv3x3_bn_act_plain(cur, t(wts[b, 0]), t(sc[b, 0]), t(sh[b, 0]))
        cur = k1.conv3x3_bn_act_plain(h, t(wts[b, 1]), t(sc[b, 1]), t(sh[b, 1]),
                                      residual=cur)
    got = k2.resblock_chain_plain(t(x), t(wts), t(sc), t(sh))
    torch.testing.assert_close(got, cur, atol=0, rtol=0)


def test_plain_versions_keep_input_dtype():
    x, kern, s, sh, res = _conv_inputs(3, 8, 8, 32, 32)
    out = k1.conv3x3_bn_act(t(x).bfloat16(), t(kern).bfloat16(), t(s), t(sh),
                            t(res).bfloat16())
    assert out.dtype == torch.bfloat16 and out.shape == (8, 8, 32)


def test_wrappers_reject_bad_shapes():
    x, kern, s, sh, res = _conv_inputs(4, 8, 8, 32, 32)
    with pytest.raises(ValueError):
        k1.conv3x3_bn_act(t(x)[None], t(kern), t(s), t(sh))
    with pytest.raises(ValueError):
        k1.conv3x3_bn_act(t(x), t(kern)[:, :, :16], t(s), t(sh))
    with pytest.raises(ValueError):
        k1.conv3x3_bn_act(t(x), t(kern), t(s), t(sh), t(res)[:4])
    xc, wts, sc, shc = _chain_inputs(5, 8, 8, 32, 2)
    with pytest.raises(ValueError):
        k2.resblock_chain(t(xc), t(wts)[:, :1], t(sc), t(shc))
