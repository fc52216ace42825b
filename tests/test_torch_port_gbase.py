"""Port parity on CPU for the slice as a whole: Gbase (encode_source + drive,
the full forward and its pyramids) and the streaming ReenactmentSession in
both bn modes, at TINY with 64x64 images, against the JAX package with the
same bridged weights and non-trivial BN statistics; plus the bridge's
one-to-one coverage.

Tolerance: 3e-5 absolute on the [0,1] sigmoid outputs, whose spread here
is 1e-2 to 3e-2, so about 1e-3 of the signal. The outputs pass ~60 float32
convs, two trilinear warps and the GroupNorms, summed in another order, and
in batch-statistics mode flax's BatchNorm takes the variance as
E[x^2] - E[x]^2 where the port takes E[(x - mean)^2]. 1e-4 absolute and
relative on the intermediate volume and descriptors.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from megaportraits_tpu.core.arch import TINY as JT
from megaportraits_tpu.core.dtypes import FP32_POLICY as JP
from megaportraits_tpu.infer.streaming import ReenactmentSession as JSession
from megaportraits_tpu.models.gbase import Gbase as JGbase

from megaportraits_tpu_torch.core.arch import TINY
from megaportraits_tpu_torch.core.dtypes import FP32_POLICY as TP
from megaportraits_tpu_torch.infer.streaming import ReenactmentSession
from megaportraits_tpu_torch.models.gbase import Gbase, build_gbase
from megaportraits_tpu_torch.utils.jax_bridge import jax_to_state_dict

from torch_port_utils import bridged, n, numpy_tree, randomize_batch_stats, t

SIZE = 64
OUT_TOL = dict(atol=3e-5, rtol=0)
MID_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    xs = rng.uniform(0, 1, (1, SIZE, SIZE, 3)).astype(np.float32)
    xd = rng.uniform(0, 1, (1, SIZE, SIZE, 3)).astype(np.float32)
    jmod = JGbase(policy=JP, arch=JT)
    v = numpy_tree(jax.jit(jmod.init)(jax.random.PRNGKey(0), xs, xs))
    v = randomize_batch_stats(v, seed=1)
    return jmod, v, xs, xd


def _torch_model(v):
    return bridged(Gbase(policy=TP, arch=TINY), v).eval()


def test_encode_source_and_drive(case):
    jmod, v, xs, xd = case
    jstate = jax.jit(lambda v, x: jmod.apply(v, x, method=JGbase.encode_source))(
        v, xs)
    jout = jax.jit(lambda v, s, x: jmod.apply(v, s, x, method=JGbase.drive))(
        v, jstate, xd)
    model = _torch_model(v)
    with torch.no_grad():
        state = model.encode_source(t(xs))
        out = model.drive(state, t(xd))
    np.testing.assert_allclose(n(state["vc2d"]), np.asarray(jstate["vc2d"]),
                               **MID_TOL)
    np.testing.assert_allclose(n(state["es"]), np.asarray(jstate["es"]), **MID_TOL)
    jout = np.asarray(jout)
    assert out.shape == (1, SIZE, SIZE, 3) and jout.std() > 1e-3
    np.testing.assert_allclose(n(out), jout, **OUT_TOL)


def test_full_forward_and_pyramids(case):
    jmod, v, xs, xd = case
    jout, jpyr = jax.jit(lambda v, a, b: jmod.apply(v, a, b))(v, xs, xd)
    with torch.no_grad():
        out, pyr = _torch_model(v)(t(xs), t(xd))
    np.testing.assert_allclose(n(out), np.asarray(jout), **OUT_TOL)
    assert set(pyr) == set(jpyr) == {"0.5", "0.25"}
    for k in pyr:
        np.testing.assert_allclose(n(pyr[k]), np.asarray(jpyr[k]), **OUT_TOL)


def test_pairwise_outputs_and_encoders(case):
    """The training entry points: encode_appearance, encode_motion and the
    pairwise-transfer pass (pose of xd with the expression of xs, and the
    reverse), in eval mode."""
    jmod, v, xs, xd = case
    japp, jmot, (jpose, jexp) = jax.jit(lambda v, a, b: (
        jmod.apply(v, a, method=JGbase.encode_appearance),
        jmod.apply(v, a, method=JGbase.encode_motion),
        jmod.apply(v, a, b, method=JGbase.pairwise_outputs)))(v, xs, xd)
    model = _torch_model(v)
    with torch.no_grad():
        app = model.encode_appearance(t(xs))
        mot = model.encode_motion(t(xs))
        pose, exp = model.pairwise_outputs(t(xs), t(xd))
    for got, want in zip([*app, *mot], [*japp, *jmot], strict=True):
        np.testing.assert_allclose(n(got), np.asarray(want), **MID_TOL)
    assert not np.allclose(np.asarray(jpose), np.asarray(jexp))
    np.testing.assert_allclose(n(pose), np.asarray(jpose), **OUT_TOL)
    np.testing.assert_allclose(n(exp), np.asarray(jexp), **OUT_TOL)


@pytest.mark.parametrize("bn_mode", ["running", "batch"])
def test_session_matches_jax_session(case, bn_mode):
    """Both bn modes; 'batch' must leave the running statistics untouched
    (the JAX session throws its mutated batch_stats away)."""
    jmod, v, xs, xd = case
    jsess = JSession(v, model=jmod, bn_mode=bn_mode)
    jsess.set_source(jnp.asarray(xs))
    want = np.asarray(jsess(jnp.asarray(xd)))
    model = _torch_model(v)
    stats_before = {k: b.clone() for k, b in model.named_buffers()}
    sess = ReenactmentSession(model=model, bn_mode=bn_mode)
    sess.set_source(t(xs))
    got = sess(t(xd))
    np.testing.assert_allclose(n(got), want, **OUT_TOL)
    for k, b in model.named_buffers():
        assert torch.equal(b, stats_before[k]), k


def test_session_bn_modes_differ_and_need_source(case):
    _, v, xs, xd = case
    outs = {}
    for mode in ("running", "batch"):
        sess = ReenactmentSession(model=_torch_model(v), bn_mode=mode)
        with pytest.raises(RuntimeError):
            sess(t(xd))
        sess.set_source(t(xs))
        outs[mode] = n(sess(t(xd)))
        assert outs[mode].min() >= 0.0 and outs[mode].max() <= 1.0
    assert not np.allclose(outs["running"], outs["batch"])


def test_bridge_maps_every_leaf_to_exactly_one_tensor(case):
    _, v, _, _ = case
    n_leaves = len(jax.tree_util.tree_leaves(v))
    state = jax_to_state_dict(v)
    model = Gbase(policy=TP, arch=TINY)
    assert len(state) == n_leaves  # no two leaves share a key
    assert set(state) == set(model.state_dict())  # every tensor covered
    bridged(model, v)  # strict=True load with matching shapes
    n_params = sum(p.numel() for p in model.parameters())
    n_jax = sum(a.size for a in jax.tree_util.tree_leaves(v["params"]))
    assert n_params == n_jax


def test_build_gbase_is_seeded():
    a = build_gbase("tiny", policy=TP, device="cpu", seed=3)
    b = build_gbase("tiny", policy=TP, device="cpu", seed=3)
    c = build_gbase("tiny", policy=TP, device="cpu", seed=4)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["g2d.res0.conv1.weight"], sc["g2d.res0.conv1.weight"])
