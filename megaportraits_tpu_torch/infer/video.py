"""Video reenactment: drive one source image with a whole driving video
(counterpart of ``megaportraits_tpu/infer/video.py``).

    python -m megaportraits_tpu_torch.infer.video --source a.png \
        --driving frames/%04d.png [--output out/%04d.png] \
        [--config <yaml>] [--size 512] [--device cuda]

The source is encoded once (``ReenactmentSession.set_source``), then every
driving frame is resized to size x size as cv2's INTER_LINEAR resizes it,
driven and written.

The driving input and the output are each either a printf pattern of
image files (``frames/%04d.png``) or a video file. A pattern reads as
JAX's ``cv2.VideoCapture`` reads one: from the first index of 0 to 4 whose
file exists, every frame up to the first one missing, at 25 fps; PNG and
baseline JPEG frames, without PIL or cv2 (``utils/image.py``). An output
pattern is written frame by frame, numbered from 1 as cv2's image2 writer
numbers them, PNG or JPEG by its extension. A video file (``.mp4``) goes
through cv2, imported only for it; without cv2 the command raises before
the model is built, naming the pattern form.
"""

from __future__ import annotations

import argparse
import os
import re
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from megaportraits_tpu_torch.core.checkpoint import CheckpointManager
from megaportraits_tpu_torch.core.config import load_config
from megaportraits_tpu_torch.core.debug import apply_platform_env
from megaportraits_tpu_torch.core.device import resolve_device
from megaportraits_tpu_torch.infer.inference import load_image
from megaportraits_tpu_torch.infer.streaming import BN_MODES, ReenactmentSession
from megaportraits_tpu_torch.models.gbase import Gbase
from megaportraits_tpu_torch.utils.image import cv2_linear_resize_u8, read_image, write_image

_PATTERN = re.compile(r"%0?\d*d")
PATTERN_FIRST_INDICES = range(5)  # where cv2 (FFmpeg's image2) looks for the first frame
PATTERN_FPS = 25.0


def is_frame_pattern(path: str) -> bool:
    """Whether `path` names numbered image files (``frames/%04d.png``)."""
    return _PATTERN.search(path) is not None


def _cv2_for(path: str):
    """cv2, for a video file; raises naming the pattern form without it."""
    try:
        import cv2
    except ImportError:
        raise RuntimeError(
            f"{path}: a video file needs cv2, which is not installed; give the "
            "frames as a printf pattern of PNG or JPEG files instead, such as "
            "frames/%04d.png") from None
    return cv2


def check_video_paths(*paths: str) -> None:
    """Raise now, before a model is built, if a path needs cv2 and there
    is none."""
    for path in paths:
        if not is_frame_pattern(path):
            _cv2_for(path)


def read_frames(path: str) -> Tuple[Iterator[np.ndarray], float]:
    """(the frames of `path` as uint8 RGB [H, W, 3], its frame rate)."""
    if is_frame_pattern(path):
        first = next((i for i in PATTERN_FIRST_INDICES if os.path.isfile(path % i)), None)

        def numbered():
            i = first
            while i is not None and os.path.isfile(path % i):
                yield read_image(path % i)
                i += 1

        return numbered(), PATTERN_FPS
    cv2 = _cv2_for(path)
    cap = cv2.VideoCapture(path)

    def decoded():
        try:
            while True:
                ok, frame = cap.read()
                if not ok:
                    return
                yield cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
        finally:
            cap.release()

    return decoded(), cap.get(cv2.CAP_PROP_FPS) or PATTERN_FPS


class FrameWriter:
    """Writes uint8 RGB frames to a pattern (from 1) or a video file."""

    def __init__(self, path: str, fps: float, size: int):
        self.path, self.count, self.video = path, 0, None
        if not is_frame_pattern(path):
            cv2 = _cv2_for(path)
            self.cv2 = cv2
            self.video = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                                         (size, size))

    def write(self, rgb: np.ndarray) -> None:
        self.count += 1
        if self.video is None:
            write_image(rgb, self.path % self.count)
        else:
            self.video.write(self.cv2.cvtColor(rgb, self.cv2.COLOR_RGB2BGR))

    def close(self) -> None:
        if self.video is not None:
            self.video.release()


def reenact_video(source_image_path: str, driving_video_path: str,
                  output_video_path: str, model: Gbase, size: int = 512,
                  fps: Optional[float] = None, max_frames: Optional[int] = None,
                  reference_normalize: bool = False, bn_mode: str = "running") -> int:
    """Drive `model` (on its own device) with every frame of the driving
    video or pattern, at size x size, and write the frames; returns the
    number written.

    Inputs stay [0, 1] end to end; `reference_normalize` gives converted
    reference checkpoints the reference's [-1, 1] transform."""
    check_video_paths(driving_video_path, output_video_path)
    session = ReenactmentSession(model=model, bn_mode=bn_mode)
    session.set_source(load_image(source_image_path, (size, size), reference_normalize))
    frames, src_fps = read_frames(driving_video_path)
    writer = FrameWriter(output_video_path, fps or src_fps, size)
    try:
        for frame in frames:
            if max_frames and writer.count >= max_frames:
                break
            rgb = cv2_linear_resize_u8(frame, (size, size))
            xd = torch.from_numpy(rgb.astype(np.float32) / 255.0)[None]
            if reference_normalize:
                xd = (xd - 0.5) / 0.5
            xhat = session(xd)  # [1, H, W, 3] in [0, 1]
            out = (xhat[0].float().cpu().numpy() * 255).clip(0, 255)
            writer.write(out.astype(np.uint8))
    finally:
        frames.close()
        writer.close()
    return writer.count


def main() -> None:
    parser = argparse.ArgumentParser(description="Video reenactment")
    parser.add_argument("--config", default="configs/inference/stage1-base.yaml")
    parser.add_argument("--source", required=True)
    parser.add_argument("--driving", required=True,
                        help="a video file (needs cv2) or a printf pattern of PNG/JPEG "
                             "frames such as frames/%%04d.png")
    parser.add_argument("--output", default="reenacted.mp4",
                        help="a video file (needs cv2) or a printf pattern such as "
                             "out/%%04d.png (PNG or JPEG by its extension)")
    parser.add_argument("--size", type=int, default=512)
    parser.add_argument("--max-frames", type=int, default=None)
    parser.add_argument(
        "--bn-mode", choices=BN_MODES, default="running",
        help="BatchNorm stats: 'batch' for small-batch-trained checkpoints")
    parser.add_argument("--device", default=None,
                        help="torch device (default: $MEGAPORTRAITS_PLATFORM, else cuda)")
    args = parser.parse_args()

    check_video_paths(args.driving, args.output)
    cfg = load_config(args.config)
    model = cfg.make_gbase(device=resolve_device(apply_platform_env(args.device)), seed=0)
    CheckpointManager(cfg.inference.checkpoint_path).restore({"g_variables": model})
    n = reenact_video(args.source, args.driving, args.output, model, size=args.size,
                      max_frames=args.max_frames,
                      reference_normalize=cfg.inference.reference_normalize,
                      bn_mode=args.bn_mode)
    print(f"wrote {n} frames to {args.output}")


if __name__ == "__main__":
    main()
