"""Gaze loss, device math only (counterpart of ``mp_gaze_loss`` in
``megaportraits_tpu/losses/gaze.py``).

The eye-region masks come from the host: the JAX package rasterises them
from 68-point landmarks (``gaze_masks_for_batch``); that rasteriser and the
GazeBlinkLoss network are not ported.
"""

from __future__ import annotations

import torch


def mp_gaze_loss(predicted: torch.Tensor, target: torch.Tensor,
                 left_mask: torch.Tensor, right_mask: torch.Tensor) -> torch.Tensor:
    """Per-eye masked MSE in float32; masks are [B, H, W, 1]."""
    pg = predicted.float()
    tg = target.float()
    left = torch.mean((pg * left_mask - tg * left_mask) ** 2)
    right = torch.mean((pg * right_mask - tg * right_mask) ** 2)
    return left + right
