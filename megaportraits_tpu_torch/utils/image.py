"""Image dumps (counterpart of ``megaportraits_tpu/utils/image.py``). PIL is
imported when an image is written, so the module imports without it."""

from __future__ import annotations

import os

import numpy as np
import torch


def save_image(array, path: str) -> None:
    """[H, W, 3] or [B, H, W, 3] float in [0, 1] (a tensor on any device,
    or an array) -> PNG of the first item of a batch."""
    from PIL import Image

    if isinstance(array, torch.Tensor):
        array = array.detach().float().cpu().numpy()
    arr = np.asarray(array)
    if arr.ndim == 4:
        arr = arr[0]
    arr = (np.clip(arr.astype(np.float32), 0, 1) * 255).astype(np.uint8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(arr).save(path)
