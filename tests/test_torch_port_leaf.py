"""The port's leaf modules against the JAX package: ``core/debug.py``,
``utils/profiling.py``, ``utils/viz.py``, ``models/encoders.py``,
``models/cifar_resnet.py``, ``ResNet50``, ``SixDRepNet2`` and
``geodesic_loss``, ``ops/warp_alt.py``, ``data/pose_datasets.py`` and
``CheckpointManager.close``.

Weights are numpy draws (``torch_port_utils.numpy_init``, BatchNorm
statistics randomised) bridged to the port; inputs are numpy draws.
Tolerances: the networks' outputs 1e-4 relative and 1e-5 absolute
(float32 convolutions summed in another order: measured below 2e-6), their
BatchNorm statistics after a train-mode pass 1e-5; the warp math 1e-5
absolute (float32, the same formulas); rotations from the pose loaders
1e-6; the debug pictures, the datasets' images and the bookkeeping equal.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from megaportraits_tpu.core import debug as jdebug
from megaportraits_tpu.core.dtypes import FP32_POLICY as JP
from megaportraits_tpu.data import pose_datasets as jpose
from megaportraits_tpu.models import cifar_resnet as jcifar
from megaportraits_tpu.models.encoders import PatchGanEncoder as JPatchGanEncoder
from megaportraits_tpu.models.repvgg import SixDRepNet2 as JSixDRepNet2
from megaportraits_tpu.models.repvgg import geodesic_loss as j_geodesic_loss
from megaportraits_tpu.models.resnet import ResNet50 as JResNet50
from megaportraits_tpu.core.arch import TINY as JTINY
from megaportraits_tpu.ops import warp_alt as jwarp
from megaportraits_tpu.utils import viz as jviz

from megaportraits_tpu_torch.core import debug
from megaportraits_tpu_torch.core.arch import TINY
from megaportraits_tpu_torch.core.checkpoint import CheckpointManager
from megaportraits_tpu_torch.core.dtypes import FP32_POLICY
from megaportraits_tpu_torch.data import pose_datasets
from megaportraits_tpu_torch.models import cifar_resnet
from megaportraits_tpu_torch.models.encoders import PatchGanEncoder
from megaportraits_tpu_torch.models.repvgg import SixDRepNet2, geodesic_loss
from megaportraits_tpu_torch.models.resnet import ResNet50
from megaportraits_tpu_torch.ops import warp_alt
from megaportraits_tpu_torch.utils import profiling, viz
from megaportraits_tpu_torch.utils.jax_bridge import jax_to_state_dict, load_jax_variables

from torch_port_utils import n, numpy_init, t

NET_TOL = dict(rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# core/debug.py
# ---------------------------------------------------------------------------


def test_nan_debugging_switches_anomaly_mode():
    try:
        debug.enable_nan_debugging()
        assert torch.is_anomaly_enabled()
    finally:
        debug.enable_nan_debugging(False)
    assert not torch.is_anomaly_enabled()


def test_assert_shape_matches_jax():
    x = np.zeros((2, 4, 5))
    jdebug.assert_shape(jnp.asarray(x), (4, 5), "x")
    debug.assert_shape(t(x), (4, 5), "x")
    with pytest.raises(AssertionError) as jerr:
        jdebug.assert_shape(jnp.asarray(x), (5, 4), "x")
    with pytest.raises(AssertionError) as terr:
        debug.assert_shape(t(x), (5, 4), "x")
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("bad", [False, True])
def test_checked_reports_as_checkify_does(bad):
    """``err, out = checked(fn)(x); err.throw()``: the same output, and the
    failed check's message where JAX's has it; nothing raises before
    ``throw``."""
    x = np.array([1.0, np.nan if bad else 2.0], np.float32)

    def jfn(a):
        jdebug.assert_finite(a, "volume")
        return a * 2

    def tfn(a):
        debug.assert_finite(a, "volume")
        return a * 2

    jerr, jout = jdebug.checked(jfn)(jnp.asarray(x))
    err, out = debug.checked(tfn)(t(x))
    np.testing.assert_array_equal(n(out), np.asarray(jout))
    assert (err.get() is None) == (jerr.get() is None) == (not bad)
    if bad:
        assert err.get() == "volume contains non-finite values"
        assert err.get() in jerr.get()
        with pytest.raises(FloatingPointError, match="volume contains non-finite"):
            err.throw()
        with pytest.raises(FloatingPointError):
            debug.assert_finite(t(x), "volume")  # outside checked: at once
    else:
        err.throw()


def test_apply_platform_env(monkeypatch):
    monkeypatch.delenv("MEGAPORTRAITS_PLATFORM", raising=False)
    assert debug.apply_platform_env() == "cuda"
    assert debug.apply_platform_env("cpu") == "cpu"
    for platform, device in (("cpu", "cpu"), ("gpu", "cuda"), ("cuda", "cuda")):
        monkeypatch.setenv("MEGAPORTRAITS_PLATFORM", platform)
        assert debug.apply_platform_env() == device
    assert debug.apply_platform_env("cpu") == "cpu"  # an explicit device wins
    monkeypatch.setenv("MEGAPORTRAITS_PLATFORM", "tpu")
    with pytest.raises(ValueError, match="MEGAPORTRAITS_PLATFORM='tpu'"):
        debug.apply_platform_env()


def test_probe_device_count():
    assert debug.probe_device_count() == torch.cuda.device_count()


# ---------------------------------------------------------------------------
# utils/profiling.py
# ---------------------------------------------------------------------------


def test_trace_writes_a_chrome_trace_with_annotations(tmp_path):
    with profiling.trace(str(tmp_path / "trace")):
        with profiling.annotate("g2d_trunk"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "trace" / profiling.TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "g2d_trunk" for e in events)


def test_device_memory_stats_and_start_server():
    stats = profiling.device_memory_stats()
    if torch.cuda.is_available():
        assert set(stats) == {"bytes_in_use", "peak_bytes_in_use", "bytes_limit"}
    else:
        assert stats == {}
    assert profiling.device_memory_stats("cpu") == {}


# ---------------------------------------------------------------------------
# utils/viz.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_draw_axis_matches_jax(dtype):
    rng = np.random.default_rng(0)
    img = rng.random((96, 128, 3))
    img = (img * 255).astype(np.uint8) if dtype == "uint8" else img.astype(np.float32)
    for angles, kw in (((20.0, -10.0, 5.0), {}), ((-45.0, 30.0, 80.0),
                                                   dict(tdx=30.0, tdy=70.0, size=40.0))):
        np.testing.assert_array_equal(viz.draw_axis(img, *angles, **kw),
                                      jviz.draw_axis(img, *angles, **kw))


def test_visualize_warp_fields_matches_jax(tmp_path):
    import matplotlib.image

    rng = np.random.default_rng(1)
    xs, xd = rng.random((32, 32, 3)), rng.random((32, 32, 3))
    w1, w2 = rng.normal(size=(2, 6, 9, 9, 3))
    viz.visualize_warp_fields(xs, xd, w1, w2, str(tmp_path / "port.png"))
    jviz.visualize_warp_fields(xs, xd, w1, w2, str(tmp_path / "jax.png"))
    np.testing.assert_array_equal(matplotlib.image.imread(tmp_path / "port.png"),
                                  matplotlib.image.imread(tmp_path / "jax.png"))
    fig = viz.visualize_warp_fields(xs, xd, w1, w2)
    assert len(fig.axes) == 4 and fig.axes[2].get_title() == "w_s2c"


# ---------------------------------------------------------------------------
# The models
# ---------------------------------------------------------------------------


def _compare_net(jmodel, model, x, train_too=True, stats_seed=1):
    """Bridge numpy-drawn weights into `model`; its eval output (and, with
    `train_too`, its batch-statistics output and recorded statistics)
    against `jmodel`'s."""
    variables = numpy_init(jmodel, jnp.asarray(x), seed=0, stats_seed=stats_seed)
    load_jax_variables(model, variables)
    model.eval()
    with torch.no_grad():
        got = model(t(x), train=False)
    want = jmodel.apply(variables, jnp.asarray(x), False)
    np.testing.assert_allclose(n(got), np.asarray(want), **NET_TOL)
    if train_too:
        model.train()
        with torch.no_grad():
            got = model(t(x), train=True)
        want, updated = jmodel.apply(variables, jnp.asarray(x), True,
                                     mutable=["batch_stats"])
        np.testing.assert_allclose(n(got), np.asarray(want), **NET_TOL)
        want_stats = jax_to_state_dict(jax.tree_util.tree_map(np.asarray, updated))
        buffers = dict(model.named_buffers())
        assert set(want_stats) == set(buffers)
        for k, v in want_stats.items():
            np.testing.assert_allclose(n(buffers[k]), v.numpy(), rtol=0, atol=1e-5,
                                       err_msg=k)
    return got


def test_patchgan_encoder_matches_jax():
    x = np.random.default_rng(2).random((2, 40, 40, 3)).astype(np.float32)
    out = _compare_net(JPatchGanEncoder(output_nc=24, ngf=8, n_downsampling=3, policy=JP),
                       PatchGanEncoder(3, 24, ngf=8, n_downsampling=3,
                                       policy=FP32_POLICY, device="cpu"), x)
    assert out.shape == (2, 1, 1, 24)


@pytest.mark.parametrize("depth", [18, 34, 50])
def test_cifar_resnets_match_jax(depth):
    x = np.random.default_rng(depth).random((2, 16, 16, 3)).astype(np.float32)
    jmodel = getattr(jcifar, f"cifar_resnet{depth}")(num_classes=7, policy=JP)
    model = getattr(cifar_resnet, f"cifar_resnet{depth}")(num_classes=7, policy=FP32_POLICY,
                                                          device="cpu")
    assert _compare_net(jmodel, model, x, train_too=depth == 18).shape == (2, 7)


def test_resnet50_matches_jax():
    x = np.random.default_rng(3).random((2, 64, 64, 3)).astype(np.float32)
    out = _compare_net(JResNet50(num_classes=5, policy=JP, arch=JTINY),
                       ResNet50(num_classes=5, policy=FP32_POLICY, arch=TINY, device="cpu"), x)
    assert out.shape == (2, 5)
    features = ResNet50(num_classes=0, policy=FP32_POLICY, arch=TINY, device="cpu")
    assert features(t(x)).shape == (2, TINY.ch(512) * 4)


def test_sixdrepnet2_and_geodesic_loss_match_jax():
    x = np.random.default_rng(4).random((2, 64, 64, 3)).astype(np.float32)
    rot = _compare_net(JSixDRepNet2(policy=JP), SixDRepNet2(policy=FP32_POLICY, device="cpu"),
                       x, train_too=False)
    assert rot.shape == (2, 3, 3)
    np.testing.assert_allclose(n(rot @ rot.transpose(1, 2)), np.broadcast_to(np.eye(3),
                                                                             (2, 3, 3)),
                               atol=1e-5)
    rng = np.random.default_rng(5)
    m1 = warp_alt.get_rotation_matrix(*t(rng.uniform(-60, 60, (3, 4)).astype(np.float32)))
    m2 = warp_alt.get_rotation_matrix(*t(rng.uniform(-60, 60, (3, 4)).astype(np.float32)))
    got = geodesic_loss(m1, m2)
    want = j_geodesic_loss(jnp.asarray(n(m1)), jnp.asarray(n(m2)))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    assert geodesic_loss(m1, m1).item() < 1e-3  # the clip keeps acos off 1


# ---------------------------------------------------------------------------
# ops/warp_alt.py
# ---------------------------------------------------------------------------


def test_warp_alt_matches_jax():
    rng = np.random.default_rng(6)
    logits = [rng.normal(size=(3, 66)).astype(np.float32) * 3 for _ in range(3)]
    translation = rng.normal(size=(3, 3)).astype(np.float32) * 0.1
    tol = dict(rtol=0, atol=1e-5)
    np.testing.assert_allclose(n(warp_alt.headpose_pred_to_degree(t(logits[0]))),
                               np.asarray(jwarp.headpose_pred_to_degree(logits[0])),
                               rtol=0, atol=1e-4)
    angles = [rng.uniform(-90, 90, 3).astype(np.float32) for _ in range(3)]
    np.testing.assert_allclose(n(warp_alt.get_rotation_matrix(*map(t, angles))),
                               np.asarray(jwarp.get_rotation_matrix(*angles)), **tol)
    for size in ((5, 7), (3, 4, 6), (1, 4, 1)):
        np.testing.assert_array_equal(n(warp_alt.make_coordinate_grid(size)),
                                      np.asarray(jwarp.make_coordinate_grid(size)))
    got = warp_alt.compute_rt_warp2(tuple(map(t, logits)), t(translation), (4, 8, 8))
    want = jwarp.compute_rt_warp2(tuple(map(jnp.asarray, logits)),
                                  jnp.asarray(translation), (4, 8, 8))
    assert got.shape == (3, 4, 8, 8, 3)
    np.testing.assert_allclose(n(got), np.asarray(want), **tol)


# ---------------------------------------------------------------------------
# data/pose_datasets.py (the synthetic files of tests/test_pose_datasets.py)
# ---------------------------------------------------------------------------


def _write_image(path, size=32, seed=0):
    from PIL import Image

    arr = np.random.default_rng(seed).integers(0, 255, size=(size, size, 3), dtype=np.uint8)
    Image.fromarray(arr).save(path)


@pytest.fixture
def wlp_dir(tmp_path):
    from scipy.io import savemat

    d = tmp_path / "300wlp"
    d.mkdir()
    for i, (p, y, r) in enumerate(((0.1, -0.3, 0.05), (-0.4, 0.2, 0.0))):
        savemat(str(d / f"img{i}.mat"), {"Pose_Para": np.array([[p, y, r, 0.0, 0.0, 0.0]])})
        _write_image(str(d / f"img{i}.jpg"), seed=i)
    return str(d)


def _assert_items_equal(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == want[0].dtype == np.float32
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-9)


@pytest.mark.parametrize("cls", ["Pose300WLP", "AFLW2000"])
def test_300wlp_and_aflw2000_match_jax(wlp_dir, cls):
    ds = getattr(pose_datasets, cls)(wlp_dir, img_size=24)
    jds = getattr(jpose, cls)(wlp_dir, img_size=24)
    assert ds.files == jds.files and len(ds) == 2
    for i in range(2):
        _assert_items_equal(ds[i], jds[i])
    got = next(pose_datasets.pose_batches(ds, 3, seed=1))
    want = next(jpose.pose_batches(jds, 3, seed=1))
    np.testing.assert_array_equal(got["image"], want["image"])
    np.testing.assert_allclose(got["rotation"], want["rotation"], rtol=0, atol=1e-6)


def test_biwi_matches_jax(tmp_path):
    d = tmp_path / "biwi" / "01"
    d.mkdir(parents=True)
    th = np.radians(30.0)
    rot = np.array([[np.cos(th), -np.sin(th), 0.0], [np.sin(th), np.cos(th), 0.0],
                    [0.0, 0.0, 1.0]], dtype=np.float32)
    vals = " ".join(f"{v:.6f}" for v in list(rot.reshape(-1)) + [10.0, 20.0, 30.0])
    (d / "frame_00001_pose.txt").write_text(vals)
    _write_image(str(d / "frame_00001_rgb.png"))
    (d / "frame_00002_pose.txt").write_text(vals)  # no frame: skipped
    ds, jds = pose_datasets.BIWI(str(tmp_path / "biwi"), 20), jpose.BIWI(str(tmp_path / "biwi"), 20)
    assert ds.samples == jds.samples and len(ds) == 1
    _assert_items_equal(ds[0], jds[0])


# ---------------------------------------------------------------------------
# core/checkpoint.py
# ---------------------------------------------------------------------------


def test_checkpoint_manager_close_returns_at_once(tmp_path):
    """The saves are synchronous: a step is on disk when ``save`` returns,
    and ``close`` (JAX's wait for its asynchronous saves) has nothing to
    wait for."""
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(1, {"w": torch.ones(3)})
    assert os.path.isfile(tmp_path / "ckpt" / "1" / "checkpoint.pt")
    assert mgr.close() is None
    assert mgr.restore({"w": torch.zeros(3)})["w"].tolist() == [1.0, 1.0, 1.0]
