"""Port parity on CPU for the serving CLIs: ``infer/inference.py``
(``inference_base`` and ``main``), ``infer/video.py`` (``reenact_video``)
and ``utils/image.save_image``, against the JAX package.

TINY Gbase, FP32, 64x64, the same numpy-drawn weights on both sides
(bridged), PNG and JPEG inputs of 80x80 that JAX reads and resizes with
PIL (the port without it), and driving frames as printf patterns of PNGs,
starting at index 0 and at 1, that JAX reads with cv2 (the port without
it). The port's side of those cases runs with ``yaml``, ``PIL`` and
``cv2`` blocked in ``sys.modules``: the commands go through
``python -m megaportraits_tpu_torch`` with a YAML config. Tolerances:
  * ``inference_base``'s uint8 frames differ by at most 1 level (measured
    at most 1): the float32 outputs agree to about 1e-5 (the Gbase tests),
    so a value near a rounding edge may land on either side;
  * ``reenact_video`` on a frame pattern: the same number of frames, and
    each frame the port writes (PNG) within 1 level of the frame JAX
    hands its cv2 writer (measured at most 1), for the same reason;
  * the port's ``infer`` command: its PNG equal to the in-process
    ``inference_base`` on the same checkpoint, bit for bit, and its JPEG
    the bytes PIL writes for those pixels;
  * ``reenact_video`` on an mp4: the same number of frames, and the frames decoded
    from both mp4 files within 1 level on average and 16 at most (measured
    0 and 0: both packages wrote the same uint8 frames, and the codec is
    deterministic). A one-level difference in a frame, as inference_base
    shows, would go through the lossy mp4v codec and move its block.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from megaportraits_tpu.core import config as jconfig
from megaportraits_tpu.core.arch import TINY as JT
from megaportraits_tpu.core.dtypes import FP32_POLICY as JP
from megaportraits_tpu.infer import inference as jinf
from megaportraits_tpu.infer import video as jvideo
from megaportraits_tpu.models.gbase import Gbase as JGbase
from megaportraits_tpu.utils.image import save_image as j_save_image

from megaportraits_tpu_torch.core import config as tconfig
from megaportraits_tpu_torch.core.arch import TINY
from megaportraits_tpu_torch.core.checkpoint import CheckpointManager
from megaportraits_tpu_torch.core.dtypes import FP32_POLICY as TP
from megaportraits_tpu_torch.infer import inference, video
from megaportraits_tpu_torch.models.gbase import Gbase
from megaportraits_tpu_torch.utils.image import read_image, save_image

from torch_port_utils import engaged_on_cpu  # noqa: F401  (a fixture)
from torch_port_utils import bridged, numpy_init

SIZE = 64
FILE_SIZE = 80
VIDEO_FRAMES = 5


def _png(path, seed):
    from PIL import Image

    coarse = np.random.default_rng(seed).integers(0, 256, (10, 10, 3), np.uint8)
    Image.fromarray(coarse).resize((FILE_SIZE, FILE_SIZE), Image.BICUBIC).save(path)
    return str(path)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    d = tmp_path_factory.mktemp("infer")
    jmod = JGbase(policy=JP, arch=JT)
    x = jnp.zeros((1, SIZE, SIZE, 3), jnp.float32)
    v = numpy_init(jmod, x, x, seed=0, stats_seed=1)
    return dict(dir=d, jmod=jmod, v=v, source=_png(d / "source.png", 2),
                driving=_png(d / "driving.png", 3))


def _model(case):
    return bridged(Gbase(policy=TP, arch=TINY), case["v"])


def _configs(case, checkpoint_path, out_name):
    """The same TINY FP32 64x64 inference config for both packages."""
    out = []
    for mod in (jconfig, tconfig):
        cfg = mod.Config()
        cfg.model.arch = "tiny"
        cfg.model.use_bf16 = False
        cfg.data.train_width = cfg.data.train_height = SIZE
        cfg.inference.checkpoint_path = checkpoint_path
        cfg.inference.source_image = case["source"]
        cfg.inference.driving_image = case["driving"]
        cfg.inference.output_image = str(case["dir"] / f"{out_name}_{mod.__name__[-6:]}.png")
        out.append(cfg)
    return out


@pytest.mark.parametrize("bn_mode,reference_normalize",
                         [("running", False), ("batch", False), ("running", True)])
def test_inference_base_matches_jax(case, bn_mode, reference_normalize):
    kw = dict(size=(SIZE, SIZE), reference_normalize=reference_normalize, bn_mode=bn_mode)
    want = jinf.inference_base(case["source"], case["driving"], case["v"], case["jmod"], **kw)
    model = _model(case)
    before = {k: b.clone() for k, b in model.named_buffers()}
    got = inference.inference_base(case["source"], case["driving"], model, **kw)
    assert got.dtype == np.uint8 and got.shape == want.shape == (SIZE, SIZE, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert got.std() > 0
    assert all(torch.equal(b, before[k]) for k, b in model.named_buffers())


def test_main_without_a_checkpoint_prints_the_jax_line(case, capsys):
    jcfg, tcfg = _configs(case, str(case["dir"] / "no-such-checkpoint"), "random")
    jinf.main(jcfg)
    want = capsys.readouterr().out.splitlines()
    inference.main(tcfg, device="cpu")
    got = capsys.readouterr().out.splitlines()
    assert got[0] == want[0] == (f"No checkpoint found at '{tcfg.inference.checkpoint_path}'"
                                 " — running with random weights")
    assert got[1] == f"wrote {tcfg.inference.output_image}"
    assert os.path.isfile(tcfg.inference.output_image)


def test_main_defaults_to_the_card(case):
    """Without a card, main raises unless asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    _, tcfg = _configs(case, "", "unused")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        inference.main(tcfg)


def test_main_serves_a_saved_export(case, capsys):
    """A training checkpoint at checkpoint_path lacks 'g_variables', so
    main takes the export beside it; the served image is inference_base's
    on the saved weights."""
    from PIL import Image

    root = case["dir"] / "trained"
    CheckpointManager(str(root)).save(7, {"g": {"step": torch.tensor(7)}})
    CheckpointManager(str(root / "export")).save(7, {"g_variables": _model(case)})
    _, tcfg = _configs(case, str(root), "served")
    inference.main(tcfg, device="cpu")
    assert "No checkpoint" not in capsys.readouterr().out
    got = np.asarray(Image.open(tcfg.inference.output_image))
    want = inference.inference_base(case["source"], case["driving"], _model(case),
                                    size=(SIZE, SIZE))
    np.testing.assert_array_equal(got, want)


def _write_video(path):
    cv2 = pytest.importorskip("cv2")
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 25,
                             (FILE_SIZE, FILE_SIZE))
    base = np.random.default_rng(4).integers(0, 255, (FILE_SIZE, FILE_SIZE, 3), np.uint8)
    for i in range(VIDEO_FRAMES):
        writer.write(np.roll(base, 3 * i, axis=1))
    writer.release()
    return str(path)


def _read_video(path):
    import cv2

    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame.astype(int))
    cap.release()
    return frames


@pytest.mark.parametrize("max_frames", [None, 3])
def test_reenact_video_matches_jax(case, max_frames):
    driving = _write_video(case["dir"] / f"driving_{max_frames}.mp4")
    out_j = str(case["dir"] / f"jax_{max_frames}.mp4")
    out_t = str(case["dir"] / f"port_{max_frames}.mp4")
    n_j = jvideo.reenact_video(case["source"], driving, out_j, case["v"], size=SIZE,
                               max_frames=max_frames, model=case["jmod"])
    n_t = video.reenact_video(case["source"], driving, out_t, _model(case), size=SIZE,
                              max_frames=max_frames)
    assert n_t == n_j == (max_frames or VIDEO_FRAMES)
    got, want = _read_video(out_t), _read_video(out_j)
    assert len(got) == len(want) == n_t
    diff = np.abs(np.stack(got) - np.stack(want))
    assert diff.mean() <= 1 and diff.max() <= 16, (diff.mean(), diff.max())


@pytest.mark.parametrize("shape", [(2, 16, 16, 3), (17, 30, 3)])
def test_save_image_matches_jax(case, shape):
    """The port writes its PNG with zlib (no PIL); PIL reads both."""
    from PIL import Image

    arr = np.random.default_rng(5).uniform(-0.2, 1.2, shape).astype(np.float32)
    j_save_image(arr, str(case["dir"] / "img_jax.png"))
    save_image(torch.from_numpy(arr), str(case["dir"] / "img_port.png"))
    assert Image.open(case["dir"] / "img_port.png").mode == "RGB"
    np.testing.assert_array_equal(np.asarray(Image.open(case["dir"] / "img_port.png")),
                                  np.asarray(Image.open(case["dir"] / "img_jax.png")))


# -- the commands without PyYAML, PIL or cv2 ------------------------------------------


def _jpg(path, seed):
    from PIL import Image

    coarse = np.random.default_rng(seed).integers(0, 256, (10, 10, 3), np.uint8)
    Image.fromarray(coarse).resize((FILE_SIZE, FILE_SIZE), Image.BICUBIC).save(
        path, quality=90)
    return str(path)


def _block_host_libraries(monkeypatch):
    """What the card's machine lacks: an import of any of them raises."""
    for name in ("yaml", "PIL", "cv2"):
        monkeypatch.setitem(sys.modules, name, None)


def _run_cli(monkeypatch, *argv):
    from megaportraits_tpu_torch.__main__ import main

    monkeypatch.setattr(sys, "argv", list(sys.argv))
    assert main(list(argv)) == 0


@pytest.fixture(scope="module")
def jpeg_inputs(case):
    return dict(source=_jpg(case["dir"] / "source.jpg", 12),
                driving=_jpg(case["dir"] / "driving.jpg", 13))


@pytest.mark.parametrize("kind", ["png", "jpg"])
def test_inference_base_matches_jax_on_png_and_jpeg(case, jpeg_inputs, kind):
    src, drv = ((case["source"], case["driving"]) if kind == "png"
                else (jpeg_inputs["source"], jpeg_inputs["driving"]))
    want = jinf.inference_base(src, drv, case["v"], case["jmod"], size=(SIZE, SIZE))
    got = inference.inference_base(src, drv, _model(case), size=(SIZE, SIZE))
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    np.testing.assert_array_equal(
        inference.load_image(src, (SIZE, SIZE)).numpy(), np.asarray(jinf.load_image(src, (SIZE, SIZE))))


@pytest.mark.parametrize("kind,out_ext", [("png", ".png"), ("jpg", ".jpg"), ("png", ".jpg")])
def test_infer_command_from_yaml_without_host_libraries(case, jpeg_inputs, kind, out_ext,
                                                        engaged_on_cpu, monkeypatch, tmp_path):
    """``python -m megaportraits_tpu_torch infer --config x.yaml`` with
    PyYAML, PIL and cv2 blocked, and the kernels' gate opened on the CPU:
    the trunk goes through K2's wrapper once (its plain version), the PNG
    is the in-process result bit for bit, and the JPEG is the bytes PIL
    writes for it (what JAX's command writes)."""
    from PIL import Image

    from megaportraits_tpu_torch.ops.kernels import resblock_chain as rc

    src, drv = ((case["source"], case["driving"]) if kind == "png"
                else (jpeg_inputs["source"], jpeg_inputs["driving"]))
    root = tmp_path / "ckpt"
    CheckpointManager(str(root)).save(1, {"g_variables": _model(case)})
    want = inference.inference_base(src, drv, _model(case), size=(SIZE, SIZE))
    pil_jpeg = tmp_path / "pil.jpg"
    Image.fromarray(want).save(pil_jpeg)
    out = tmp_path / f"out{out_ext}"
    config = tmp_path / "infer.yaml"
    config.write_text(
        f"data:\n  train_width: {SIZE}\n  train_height: {SIZE}\n"
        "model:\n  arch: tiny\n  use_bf16: false\n"
        f"inference:\n  checkpoint_path: '{root}'\n  source_image: {src}\n"
        f"  driving_image: \"{drv}\"\n  output_image: {out}  # the result\n")
    calls = []
    plain = rc.resblock_chain
    monkeypatch.setattr(rc, "resblock_chain", lambda *a, **k: calls.append(1) or plain(*a, **k))
    _block_host_libraries(monkeypatch)
    _run_cli(monkeypatch, "infer", "--config", str(config), "--device", "cpu")
    monkeypatch.undo()
    assert len(calls) == 1
    if out_ext == ".png":
        np.testing.assert_array_equal(read_image(str(out)), want)
    else:
        assert out.read_bytes() == pil_jpeg.read_bytes()


def _frames(directory, start, count, seed):
    """PNG frames start..start+count-1 of a smooth moving picture, then a
    gap and one more frame that a reader must not reach."""
    import cv2

    directory.mkdir(exist_ok=True)
    rng = np.random.default_rng(seed)
    base = cv2.resize(rng.integers(0, 256, (10, 10, 3), np.uint8), (FILE_SIZE, FILE_SIZE),
                      interpolation=cv2.INTER_CUBIC)
    for i in range(start, start + count):
        cv2.imwrite(str(directory / f"f_{i:04d}.png"), np.roll(base, 3 * i, axis=1))
    cv2.imwrite(str(directory / f"f_{start + count + 1:04d}.png"), base)
    return str(directory / "f_%04d.png")


class _RecordingWriter:
    """Stands in for cv2.VideoWriter in JAX's reenact: keeps the frames."""

    frames = []

    def __init__(self, *args):
        pass

    def write(self, frame):
        _RecordingWriter.frames.append(frame[..., ::-1].copy())  # BGR -> RGB

    def release(self):
        pass


@pytest.mark.parametrize("start", [0, 1])
@pytest.mark.parametrize("source", ["png", "jpg"])
def test_reenact_frame_pattern_matches_jax(case, jpeg_inputs, start, source, monkeypatch,
                                           tmp_path):
    """JAX reads the pattern with cv2.VideoCapture (its writer recorded);
    the port, with PyYAML, PIL and cv2 blocked, reads the same pattern and
    writes a PNG pattern numbered from 1 through the reenact command."""
    import cv2

    src = case["source"] if source == "png" else jpeg_inputs["source"]
    pattern = _frames(tmp_path / "frames", start, VIDEO_FRAMES, seed=20 + start)
    _RecordingWriter.frames = []
    monkeypatch.setattr(cv2, "VideoWriter", _RecordingWriter)
    n_j = jvideo.reenact_video(src, pattern, str(tmp_path / "unused.mp4"), case["v"],
                               size=SIZE, model=case["jmod"])
    monkeypatch.undo()
    want = _RecordingWriter.frames
    assert n_j == len(want) == VIDEO_FRAMES

    root = tmp_path / "ckpt"
    CheckpointManager(str(root)).save(1, {"g_variables": _model(case)})
    config = tmp_path / "serve.yaml"
    config.write_text(f"model: {{arch: tiny, use_bf16: false}}\n"
                      f"inference: {{checkpoint_path: '{root}'}}\n")
    out = tmp_path / "out" / "r_%03d.png"
    _block_host_libraries(monkeypatch)
    _run_cli(monkeypatch, "reenact", "--config", str(config), "--source", src,
             "--driving", pattern, "--output", str(out), "--size", str(SIZE),
             "--device", "cpu")
    monkeypatch.undo()
    written = sorted(os.listdir(tmp_path / "out"))
    assert written == [f"r_{i:03d}.png" for i in range(1, VIDEO_FRAMES + 1)]
    for i, frame in enumerate(want):
        got = read_image(str(out).replace("%03d", f"{i + 1:03d}"))
        assert np.abs(got.astype(int) - frame.astype(int)).max() <= 1


@pytest.mark.parametrize("first,count,expected", [(0, 3, 3), (4, 2, 2), (5, 2, 0),
                                                  (2, 0, 1)])
def test_frame_pattern_reads_where_cv2_reads(first, count, expected, tmp_path):
    """The first index of 0 to 4 that exists, then every frame to the first
    missing one: the frames cv2.VideoCapture gives, in order. (Frames
    first..first+count-1 exist, then a gap, then one more: with no frame
    before it, that one is the first, if its index is at most 4.)"""
    import cv2

    d = tmp_path / "p"
    d.mkdir()
    rng = np.random.default_rng(first)
    for i in list(range(first, first + count)) + [first + count + 1]:
        cv2.imwrite(str(d / f"{i}.png"), rng.integers(0, 256, (6, 9, 3), np.uint8))
    cap = cv2.VideoCapture(str(d / "%d.png"))
    want = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        want.append(frame[..., ::-1])
    cap.release()
    frames, fps = video.read_frames(str(d / "%d.png"))
    got = list(frames)
    assert len(got) == len(want) == expected
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert fps == 25.0


def test_reenact_mp4_without_cv2_raises_before_the_model(case, monkeypatch, tmp_path):
    """Without cv2, an .mp4 input or output raises naming cv2 and the
    pattern form, before any model is built."""
    def no_model(*args, **kwargs):
        raise AssertionError("the model was built")

    monkeypatch.setattr(tconfig.Config, "make_gbase", no_model)
    _block_host_libraries(monkeypatch)
    for driving, output in (("in.mp4", "out/%04d.png"), ("in/%04d.png", "out.mp4")):
        with pytest.raises(RuntimeError, match=r"needs cv2.*frames/%04d\.png"):
            _run_cli(monkeypatch, "reenact", "--source", case["source"], "--driving",
                     str(tmp_path / driving), "--output", str(tmp_path / output),
                     "--device", "cpu")
