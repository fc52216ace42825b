"""Foreground (person) segmentation on the host (a copy of
``megaportraits_tpu/data/segmentation.py``).

The reference's DeepLabV3 person mask needs pretrained weights that this
environment lacks, so the default provider is a cv2 GrabCut seeded by a
centre rectangle, adequate for face-centred talking-head crops; any
segmentation model plugs in through `provider`. Without cv2 the mask is all
foreground.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

try:
    import cv2
except Exception:  # pragma: no cover
    cv2 = None


def grabcut_foreground_mask(image: np.ndarray, iters: int = 3) -> np.ndarray:
    """[H, W, 3] float [0,1] -> [H, W, 1] float foreground mask."""
    h, w = image.shape[:2]
    if cv2 is None:
        return np.ones((h, w, 1), dtype=np.float32)
    img8 = (np.clip(image, 0, 1) * 255).astype(np.uint8)
    mask = np.zeros((h, w), np.uint8)
    # Seed: a generous centre rectangle (talking-head crops are face-centred).
    rect = (int(0.05 * w), int(0.02 * h), int(0.9 * w), int(0.96 * h))
    bgd = np.zeros((1, 65), np.float64)
    fgd = np.zeros((1, 65), np.float64)
    try:
        cv2.grabCut(cv2.cvtColor(img8, cv2.COLOR_RGB2BGR), mask, rect,
                    bgd, fgd, iters, cv2.GC_INIT_WITH_RECT)
    except Exception:
        return np.ones((h, w, 1), dtype=np.float32)
    fg = ((mask == cv2.GC_FGD) | (mask == cv2.GC_PR_FGD)).astype(np.float32)
    return fg[..., None]


def get_foreground_mask(
    image: np.ndarray,
    provider: Optional[Callable[[np.ndarray], np.ndarray]] = None,
) -> np.ndarray:
    """Host-side foreground mask with a pluggable model provider."""
    if provider is not None:
        return provider(image)
    return grabcut_foreground_mask(image)


def masks_for_batch(
    images: np.ndarray,
    provider: Optional[Callable[[np.ndarray], np.ndarray]] = None,
) -> np.ndarray:
    """[B, H, W, 3] -> [B, H, W, 1] foreground masks, for the masked-loss
    variant of the stage-1 step (``TrainingConfig.use_foreground_mask``)."""
    return np.stack([get_foreground_mask(img, provider) for img in images])
