"""Single-pair inference and its command line (counterpart of
``megaportraits_tpu/infer/inference.py``).

    python -m megaportraits_tpu_torch.infer.inference --config <yaml> [--device cuda]

builds Gbase from the config, restores ``{'g_variables': Gbase}`` from
``inference.checkpoint_path`` or, failing that, from its ``/export``
subdirectory (``core/checkpoint.py``; a checkpoint without that key counts
as none), runs Gbase on the source/driving pair and writes the output
image.

Images are [0, 1] end to end, as the trainer feeds them;
``reference_normalize`` reproduces the reference's [-1, 1] input transform
and its denormalisation, for converted reference checkpoints. PIL is
imported where an image is read or written, so the module imports without
it.
"""

from __future__ import annotations

import argparse
from typing import Optional, Tuple, Union

import numpy as np
import torch

from megaportraits_tpu_torch.core.checkpoint import CheckpointManager
from megaportraits_tpu_torch.core.config import Config, load_config
from megaportraits_tpu_torch.core.debug import apply_platform_env
from megaportraits_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device
from megaportraits_tpu_torch.infer.streaming import BN_MODES, check_bn_mode
from megaportraits_tpu_torch.models.gbase import Gbase


def load_image(path: str, size: Optional[Tuple[int, int]] = None,
               reference_normalize: bool = False) -> torch.Tensor:
    """Image file -> [1, H, W, 3] float32 on the host, in [0, 1], or the
    reference's mean/std-0.5 [-1, 1] transform with `reference_normalize`.
    `size` is (width, height), resized bilinearly by PIL."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    if size is not None:
        img = img.resize(size, Image.BILINEAR)
    arr = np.asarray(img, dtype=np.float32) / 255.0
    if reference_normalize:
        arr = (arr - 0.5) / 0.5
    return torch.from_numpy(arr)[None]


def to_uint8(frame: torch.Tensor) -> np.ndarray:
    """[0, 1] model output [1, H, W, 3] -> uint8 RGB [H, W, 3]."""
    out = frame[0].detach().float().cpu().numpy()
    return np.clip(out * 255.0, 0, 255).astype(np.uint8)


def denormalize(frame: torch.Tensor) -> np.ndarray:
    """Reference [-1, 1] output [1, H, W, 3] -> uint8 RGB [H, W, 3]."""
    out = frame[0].detach().float().cpu().numpy()
    return np.clip((out + 1.0) / 2.0 * 255.0, 0, 255).astype(np.uint8)


def inference_base(source_image_path: str, driving_image_path: str, model: Gbase,
                   size: Optional[Tuple[int, int]] = (512, 512),
                   reference_normalize: bool = False,
                   bn_mode: str = "running") -> np.ndarray:
    """One source/driving pair through `model` on its own device -> uint8
    RGB. bn_mode 'running' normalises with the BatchNorm running statistics
    (the reference convention), 'batch' with the input's own (what a
    small-batch-trained checkpoint learned against); neither records
    anything."""
    check_bn_mode(bn_mode)
    dev = next(model.parameters()).device
    xs = load_image(source_image_path, size, reference_normalize).to(dev)
    xd = load_image(driving_image_path, size, reference_normalize).to(dev)
    model.eval()
    with torch.no_grad():
        xhat = model.generate(xs, xd, train=bn_mode == "batch")
    if reference_normalize:
        # Gbase ends in a sigmoid, [0, 1]; the reference's denormalisation
        # takes [-1, 1].
        return denormalize(xhat * 2.0 - 1.0)
    return to_uint8(xhat)


def restore_gbase(model: Gbase, paths) -> bool:
    """Restore ``{'g_variables': model}`` from the first of `paths` that
    holds it; whether one did."""
    for path in paths:
        try:
            if CheckpointManager(path).restore({"g_variables": model}) is not None:
                return True
        except KeyError:  # a checkpoint of something else (a training state)
            continue
    return False


def main(cfg: Optional[Config] = None,
         device: Union[str, torch.device] = DEFAULT_DEVICE) -> None:
    """Serve the config's pair on `device` (the card by default; raises if
    there is none and the caller did not ask for the CPU). Without `cfg`,
    the arguments come from the command line."""
    if cfg is None:
        parser = argparse.ArgumentParser(description="Inference script")
        parser.add_argument("--config", type=str, required=True)
        parser.add_argument(
            "--reference-normalize", action="store_true",
            help="reproduce the reference's [-1,1] input transform "
                 "(for converted reference checkpoints)")
        parser.add_argument(
            "--bn-mode", choices=BN_MODES, default=None,
            help="BatchNorm stats: 'running' (eval-mode, reference "
                 "convention) or 'batch' (per-input stats: for "
                 "small-batch-trained checkpoints)")
        parser.add_argument("--device", default=None,
                            help="torch device (default: $MEGAPORTRAITS_PLATFORM, else cuda)")
        args = parser.parse_args()
        cfg = load_config(args.config)
        if args.reference_normalize:
            cfg.inference.reference_normalize = True
        if args.bn_mode:
            cfg.inference.bn_mode = args.bn_mode
        device = apply_platform_env(args.device)
    from PIL import Image

    model = cfg.make_gbase(device=resolve_device(device), seed=0)
    path = cfg.inference.checkpoint_path
    if not restore_gbase(model, (path, path + "/export")):
        print(f"No checkpoint found at '{path}' — running with random weights")
    out = inference_base(
        cfg.inference.source_image, cfg.inference.driving_image, model,
        size=(cfg.data.train_width, cfg.data.train_height),
        reference_normalize=cfg.inference.reference_normalize,
        bn_mode=cfg.inference.bn_mode)
    Image.fromarray(out).save(cfg.inference.output_image)
    print(f"wrote {cfg.inference.output_image}")


if __name__ == "__main__":
    main()
