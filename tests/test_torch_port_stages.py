"""Port parity on CPU for the stage-2 and stage-3 serving models: Genh (both
norms), GHR (Gbase composed with Genh) and the SPADE Student, at TINY with
small images, against the JAX package with the same bridged weights and
non-trivial BN statistics; plus the bridge's one-to-one coverage of their
trees. The weights are drawn with numpy (flax's own init of these trees
takes about 30 s to compile on a CPU). FP32 on both sides (JAX at matmul
precision 'highest', set by conftest).

Tolerances: 2e-4 absolute and relative on Genh's tanh output and the
Student's sigmoid output, which pass 20-60 float32 convs and norms summed in
another order; GHR gets 3e-5 absolute on top of that, as Gbase's own test
does, for the Gbase part it carries (the tanh output's spread here is about
1e-1).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from megaportraits_tpu.core.arch import TINY as JT
from megaportraits_tpu.core.dtypes import FP32_POLICY as JP
from megaportraits_tpu.models import genh as jgenh
from megaportraits_tpu.models import student as jstudent

from megaportraits_tpu_torch.core.arch import TINY
from megaportraits_tpu_torch.core.dtypes import FP32_POLICY as TP
from megaportraits_tpu_torch.models import genh as tgenh
from megaportraits_tpu_torch.models import student as tstudent
from megaportraits_tpu_torch.utils.jax_bridge import jax_to_state_dict

from torch_port_utils import bridged, n, numpy_init, t, uniform

TOL = dict(atol=2e-4, rtol=2e-4)
GHR_TOL = dict(atol=2e-4 + 3e-5, rtol=0)
NUM_AVATARS = 3


def _jit_apply(jmod, v, *args):
    return np.asarray(jax.jit(jmod.apply)(v, *args))


def _torch_eval(tmod, v, *args):
    tmod = bridged(tmod, v).eval()
    with torch.no_grad():
        return n(tmod(*args))


def _coverage(v, tmod):
    """Every JAX leaf lands on exactly one torch tensor and every tensor is
    covered (strict load), with the same parameter count."""
    state = jax_to_state_dict(v)
    assert len(state) == len(jax.tree_util.tree_leaves(v))
    assert set(state) == set(tmod.state_dict())
    bridged(tmod, v)
    n_jax = sum(a.size for a in jax.tree_util.tree_leaves(v["params"]))
    assert sum(p.numel() for p in tmod.parameters()) == n_jax


def _archs(norm):
    return (dataclasses.replace(JT, norm=norm), dataclasses.replace(TINY, norm=norm))


@pytest.fixture(scope="module", params=["batch", "group"])
def genh_case(request):
    ja, ta = _archs(request.param)
    x = uniform(np.random.default_rng(0), (2, 32, 32, 3))
    jmod = jgenh.Genh(policy=JP, arch=ja)
    v = numpy_init(jmod, x, stats_seed=1)
    return request.param, ja, ta, x, v, _jit_apply(jmod, v, x)


def test_genh(genh_case):
    norm, _, ta, x, v, want = genh_case
    assert ("batch_stats" in v) == (norm == "batch")
    tmod = tgenh.Genh(policy=TP, arch=ta)
    assert len(tmod.mid_names) == TINY.g2d_blocks
    got = _torch_eval(tmod, v, t(x))
    assert got.shape == (2, 32, 32, 3) and want.std() > 1e-2
    np.testing.assert_allclose(got, want, **TOL)


def test_genh_bridge_coverage(genh_case):
    _, _, ta, _, v, _ = genh_case
    _coverage(v, tgenh.Genh(policy=TP, arch=ta))


@pytest.fixture(scope="module")
def ghr_case():
    rng = np.random.default_rng(2)
    xs = rng.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    xd = rng.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    jmod = jgenh.GHR(policy=JP, arch=JT)
    v = numpy_init(jmod, xs, xd, stats_seed=3)
    return xs, xd, v, _jit_apply(jmod, v, xs, xd)


def test_ghr(ghr_case):
    """Gbase's image (not its tuple) goes into Genh."""
    xs, xd, v, want = ghr_case
    got = _torch_eval(tgenh.GHR(policy=TP, arch=TINY), v, t(xs), t(xd))
    assert got.shape == (1, 64, 64, 3) and want.std() > 1e-3
    np.testing.assert_allclose(got, want, **GHR_TOL)


def test_ghr_bridge_coverage(ghr_case):
    _, _, v, _ = ghr_case
    _coverage(v, tgenh.GHR(policy=TP, arch=TINY))


@pytest.fixture(scope="module")
def student_case():
    x = uniform(np.random.default_rng(4), (2, 64, 64, 3), 0.0, 1.0)
    idx = np.array([2, 0], np.int32)
    jmod = jstudent.Student(NUM_AVATARS, policy=JP, arch=JT)
    v = numpy_init(jmod, x, idx, stats_seed=5)
    return x, idx, v, _jit_apply(jmod, v, x, idx)


def test_student(student_case):
    """Batch 2 with different avatars; the two avatars' frames differ."""
    x, idx, v, want = student_case
    got = _torch_eval(tstudent.Student(NUM_AVATARS, policy=TP, arch=TINY), v,
                      t(x), torch.from_numpy(idx).long())
    assert got.shape == (2, 64, 64, 3)
    assert got.min() >= 0.0 and got.max() <= 1.0
    np.testing.assert_allclose(got, want, **TOL)
    same = _torch_eval(tstudent.Student(NUM_AVATARS, policy=TP, arch=TINY), v,
                       t(x[:1]), torch.tensor([0]))
    other = _torch_eval(tstudent.Student(NUM_AVATARS, policy=TP, arch=TINY), v,
                        t(x[:1]), torch.tensor([1]))
    assert not np.allclose(same, other)


def test_student_bridge_coverage(student_case):
    _, _, v, _ = student_case
    _coverage(v, tstudent.Student(NUM_AVATARS, policy=TP, arch=TINY))


@pytest.mark.parametrize("build,kwargs,key", [
    (tgenh.build_genh, {}, "enc_conv.weight"),
    (tgenh.build_ghr, {}, "genh.enc_conv.weight"),
    (tstudent.build_student, dict(num_avatars=2), "dec0.norm_0.avatar_gamma_emb.weight"),
])
def test_factories_are_seeded(build, kwargs, key):
    a, b, c = (build(arch="tiny", policy=TP, device="cpu", seed=s, **kwargs)
               for s in (3, 3, 4))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa[key], sc[key])
