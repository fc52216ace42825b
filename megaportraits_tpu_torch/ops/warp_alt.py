"""Alternative head-pose warp math (counterpart of
``megaportraits_tpu/ops/warp_alt.py``): the binned-softmax pose decoding of
Hopenet-style estimators and the coordinate-grid rt-warp variant, with the
reference's undefined-translation bug fixed as in JAX."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from megaportraits_tpu_torch.ops.affine_grid import rotation_matrix_from_euler_deg


def headpose_pred_to_degree(pred: torch.Tensor) -> torch.Tensor:
    """[B, 66] binned logits -> degrees: the softmax-expected bin index * 3 - 99."""
    idx = torch.arange(66, dtype=torch.float32, device=pred.device)
    probs = torch.softmax(pred.float(), dim=-1)
    return torch.sum(probs * idx, dim=-1) * 3.0 - 99.0


def get_rotation_matrix(yaw: torch.Tensor, pitch: torch.Tensor,
                        roll: torch.Tensor) -> torch.Tensor:
    """Euler degrees [B] each -> rotation matrices [B, 3, 3]."""
    return rotation_matrix_from_euler_deg(torch.stack([pitch, yaw, roll], dim=-1))


def make_coordinate_grid(spatial_size: Tuple[int, ...]) -> torch.Tensor:
    """Identity grid in [-1, 1]: 2D -> [H, W, 2] (x, y); 3D -> [D, H, W, 3]
    (x, y, z); an axis of size 1 sits at 0."""
    axes = [np.linspace(-1.0, 1.0, s) if s > 1 else np.zeros(1) for s in spatial_size]
    mesh = np.meshgrid(*axes, indexing="ij")
    return torch.from_numpy(np.stack(list(reversed(mesh)), axis=-1).astype(np.float32))


def compute_rt_warp2(rotation_logits: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
                     translation: torch.Tensor,
                     grid_size: Tuple[int, int, int] = (16, 64, 64)) -> torch.Tensor:
    """Binned (yaw, pitch, roll) logits and a translation [B, 3] -> the rt
    warp grid [B, D, H, W, 3]: the rotated identity grid plus the
    translation."""
    yaw, pitch, roll = (headpose_pred_to_degree(t) for t in rotation_logits)
    rot = get_rotation_matrix(yaw, pitch, roll)
    flat = make_coordinate_grid(grid_size).to(rot.device).reshape(-1, 3)
    warped = torch.einsum("bij,nj->bni", rot, flat) + translation.float()[:, None, :]
    return warped.reshape(rot.shape[0], *grid_size, 3)
