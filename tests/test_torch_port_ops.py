"""Port parity on CPU: core copies and ops (resize, affine grid, warp),
plus the port's import and device rules.

Each op gets the same numpy inputs in both packages; float32 throughout.
Tolerances: 1e-5 where both sides do the same float32 arithmetic in another
order, 1e-4 for the warp (its coordinates pass a division and a trilinear
blend of 8 corners).
"""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from megaportraits_tpu.core import arch as jarch
from megaportraits_tpu.ops import affine_grid as jag
from megaportraits_tpu.ops import resize as jrs
from megaportraits_tpu.ops import warp as jwarp

from megaportraits_tpu_torch.core import arch as tarch
from megaportraits_tpu_torch.core.dtypes import DEFAULT_POLICY, FP32_POLICY
from megaportraits_tpu_torch.ops import affine_grid as tag
from megaportraits_tpu_torch.ops import resize as trs
from megaportraits_tpu_torch.ops import warp as twarp

from torch_port_utils import n, t, uniform

REPO = Path(__file__).resolve().parents[1]


def test_arch_presets_are_copies():
    for name in ("FULL", "TINY"):
        assert dataclasses.asdict(getattr(tarch, name)) == dataclasses.asdict(
            getattr(jarch, name))
    for c in (3, 64, 96, 512, 1536):
        assert tarch.TINY.ch(c) == jarch.TINY.ch(c)
    assert tarch.get_arch("tiny") is tarch.TINY
    with pytest.raises(ValueError):
        tarch.get_arch("medium-rare")


def test_policies():
    assert DEFAULT_POLICY.param_dtype == torch.float32
    assert DEFAULT_POLICY.compute_dtype == torch.bfloat16
    assert DEFAULT_POLICY.norm_dtype == torch.float32
    assert FP32_POLICY.compute_dtype == torch.float32
    x = torch.ones(2)
    assert DEFAULT_POLICY.cast_to_compute(x).dtype == torch.bfloat16


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("shape,sizes,axes", [
    ((2, 7, 9, 4), (14, 5), (1, 2)),        # up along H, down along W
    ((1, 4, 6, 5, 3), (16, 12, 10), (1, 2, 3)),
    ((1, 8, 8, 3), (5, 5), (1, 2)),         # non-integer down: clamp at 0
])
def test_linear_resize(align_corners, shape, sizes, axes):
    x = uniform(np.random.default_rng(0), shape)
    want = jrs.linear_resize(jnp.asarray(x), sizes, axes, align_corners)
    got = trs.linear_resize(t(x), sizes, axes, align_corners)
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape,factors", [
    ((1, 4, 2, 2, 8), (2, 2, 2)),
    ((1, 4, 3, 5, 8), (1, 2, 2)),
])
def test_upsample_nearest(shape, factors):
    x = uniform(np.random.default_rng(1), shape)
    want = jrs.upsample_nearest(jnp.asarray(x), factors, (1, 2, 3))
    got = trs.upsample_nearest(t(x), factors, (1, 2, 3))
    np.testing.assert_array_equal(n(got), np.asarray(want))


def test_nearest_resize_non_integer():
    x = uniform(np.random.default_rng(2), (1, 9, 7, 2))
    want = jrs.nearest_resize(jnp.asarray(x), (4, 3), (1, 2))
    got = trs.nearest_resize(t(x), (4, 3), (1, 2))
    np.testing.assert_array_equal(n(got), np.asarray(want))


def test_avg_pools():
    rng = np.random.default_rng(3)
    x2 = uniform(rng, (2, 8, 6, 3))
    x3 = uniform(rng, (1, 4, 8, 6, 3))
    np.testing.assert_allclose(n(trs.avg_pool_2d(t(x2))),
                               np.asarray(jrs.avg_pool_2d(jnp.asarray(x2))),
                               atol=1e-6)
    np.testing.assert_allclose(n(trs.avg_pool_3d(t(x3))),
                               np.asarray(jrs.avg_pool_3d(jnp.asarray(x3))),
                               atol=1e-6)


@pytest.mark.parametrize("scale", [0.5, 0.25])
def test_anti_alias_downsample(scale):
    x = uniform(np.random.default_rng(4), (2, 32, 32, 3), 0.0, 1.0)
    want = jrs.anti_alias_downsample(jnp.asarray(x), scale)
    got = trs.anti_alias_downsample(t(x), scale)
    assert got.shape == want.shape
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-5)


def _pose(seed, b=3):
    rng = np.random.default_rng(seed)
    rot = rng.uniform(-60, 60, (b, 3)).astype(np.float32)
    trans = rng.uniform(-0.3, 0.3, (b, 3)).astype(np.float32)
    return rot, trans


def test_rotation_and_affine_grid():
    rot, _ = _pose(5)
    np.testing.assert_allclose(
        n(tag.rotation_matrix_from_euler_deg(t(rot))),
        np.asarray(jag.rotation_matrix_from_euler_deg(jnp.asarray(rot))),
        atol=1e-6)
    theta = uniform(np.random.default_rng(6), (2, 3, 4))
    for ac in (True, False):
        np.testing.assert_allclose(
            n(tag.affine_grid_3d(t(theta), (4, 5, 6), align_corners=ac)),
            np.asarray(jag.affine_grid_3d(jnp.asarray(theta), (4, 5, 6), ac)),
            atol=1e-5)


@pytest.mark.parametrize("invert", [False, True])
def test_compute_rt_warp(invert):
    rot, trans = _pose(7)
    want = jag.compute_rt_warp(jnp.asarray(rot), jnp.asarray(trans), invert, 8)
    got = tag.compute_rt_warp(t(rot), t(trans), invert, 8)
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("mode", ["reference", "standard"])
def test_apply_warping_field(mode):
    rng = np.random.default_rng(8)
    v = uniform(rng, (2, 4, 8, 8, 5))
    flow = uniform(rng, (2, 6, 6, 6, 3), -0.6, 0.6)
    want = jwarp.apply_warping_field(jnp.asarray(v), jnp.asarray(flow), mode)
    got = twarp.apply_warping_field(t(v), t(flow), mode)
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_warp_rejects_unknown_mode():
    with pytest.raises(ValueError):
        twarp.apply_warping_field(torch.zeros(1, 2, 2, 2, 1),
                                  torch.zeros(1, 2, 2, 2, 3), "bogus")


def _port_files():
    files = sorted((REPO / "megaportraits_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def test_port_imports_no_jax():
    """No file of the port (nor chip_smoke.py) imports jax, flax or the JAX
    package, at any depth of the file."""
    banned = ("jax", "jaxlib", "flax", "megaportraits_tpu")
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in banned, f"{path.name} imports {name}"


def test_default_device_is_cuda_and_raises_without_card(monkeypatch):
    from megaportraits_tpu_torch.core import device
    from megaportraits_tpu_torch.infer.streaming import ReenactmentSession
    from megaportraits_tpu_torch.models.gbase import build_gbase

    assert device.DEFAULT_DEVICE == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_gbase("tiny")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ReenactmentSession(arch=tarch.TINY)
    from megaportraits_tpu_torch.models.genh import build_genh, build_ghr
    from megaportraits_tpu_torch.models.student import build_student

    for build in (build_genh, build_ghr, lambda arch: build_student(2, arch)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build("tiny")
    assert device.resolve_device("cpu") == torch.device("cpu")
