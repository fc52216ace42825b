"""Port parity on CPU for the serving CLIs: ``infer/inference.py``
(``inference_base`` and ``main``), ``infer/video.py`` (``reenact_video``)
and ``utils/image.save_image``, against the JAX package.

TINY Gbase, FP32, 64x64, the same numpy-drawn weights on both sides
(bridged), PNG inputs of 80x80 that both resize with PIL. Tolerances:
  * ``inference_base``'s uint8 frames differ by at most 1 level (measured
    at most 1): the float32 outputs agree to about 1e-5 (the Gbase tests),
    so a value near a rounding edge may land on either side;
  * ``reenact_video``: the same number of frames, and the frames decoded
    from both mp4 files within 1 level on average and 16 at most (measured
    0 and 0: both packages wrote the same uint8 frames, and the codec is
    deterministic). A one-level difference in a frame, as inference_base
    shows, would go through the lossy mp4v codec and move its block.
"""

import os

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
from megaportraits_tpu_torch.utils.image import save_image

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
