"""Video reenactment: drive one source image with a whole driving video
(counterpart of ``megaportraits_tpu/infer/video.py``).

    python -m megaportraits_tpu_torch.infer.video --source a.png --driving b.mp4 \
        [--config <yaml>] [--output reenacted.mp4] [--size 512] [--device cuda]

The source is encoded once (``ReenactmentSession.set_source``), then every
driving frame is driven and written with cv2. cv2 and PIL are imported
where files are read or written, so the module imports without them.
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from megaportraits_tpu_torch.core.checkpoint import CheckpointManager
from megaportraits_tpu_torch.core.config import load_config
from megaportraits_tpu_torch.core.debug import apply_platform_env
from megaportraits_tpu_torch.core.device import resolve_device
from megaportraits_tpu_torch.infer.inference import load_image
from megaportraits_tpu_torch.infer.streaming import BN_MODES, ReenactmentSession
from megaportraits_tpu_torch.models.gbase import Gbase


def reenact_video(source_image_path: str, driving_video_path: str,
                  output_video_path: str, model: Gbase, size: int = 512,
                  fps: Optional[float] = None, max_frames: Optional[int] = None,
                  reference_normalize: bool = False, bn_mode: str = "running") -> int:
    """Drive `model` (on its own device) with every frame of the video, at
    size x size, and write the frames as mp4; returns the number written.

    Inputs stay [0, 1] end to end; `reference_normalize` gives converted
    reference checkpoints the reference's [-1, 1] transform."""
    import cv2

    session = ReenactmentSession(model=model, bn_mode=bn_mode)
    session.set_source(load_image(source_image_path, (size, size), reference_normalize))
    cap = cv2.VideoCapture(driving_video_path)
    src_fps = fps or cap.get(cv2.CAP_PROP_FPS) or 25.0
    writer = cv2.VideoWriter(output_video_path, cv2.VideoWriter_fourcc(*"mp4v"),
                             src_fps, (size, size))
    count = 0
    try:
        while not (max_frames and count >= max_frames):
            ok, frame = cap.read()
            if not ok:
                break
            rgb = cv2.cvtColor(cv2.resize(frame, (size, size)), cv2.COLOR_BGR2RGB)
            xd = torch.from_numpy(rgb.astype(np.float32) / 255.0)[None]
            if reference_normalize:
                xd = (xd - 0.5) / 0.5
            xhat = session(xd)  # [1, H, W, 3] in [0, 1]
            out = (xhat[0].float().cpu().numpy() * 255).clip(0, 255)
            writer.write(cv2.cvtColor(out.astype(np.uint8), cv2.COLOR_RGB2BGR))
            count += 1
    finally:
        writer.release()
        cap.release()
    return count


def main() -> None:
    parser = argparse.ArgumentParser(description="Video reenactment")
    parser.add_argument("--config", default="configs/inference/stage1-base.yaml")
    parser.add_argument("--source", required=True)
    parser.add_argument("--driving", required=True)
    parser.add_argument("--output", default="reenacted.mp4")
    parser.add_argument("--size", type=int, default=512)
    parser.add_argument("--max-frames", type=int, default=None)
    parser.add_argument(
        "--bn-mode", choices=BN_MODES, default="running",
        help="BatchNorm stats: 'batch' for small-batch-trained checkpoints")
    parser.add_argument("--device", default=None,
                        help="torch device (default: $MEGAPORTRAITS_PLATFORM, else cuda)")
    args = parser.parse_args()

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
