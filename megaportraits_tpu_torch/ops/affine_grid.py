"""Rotation/translation warp math (torch ``F.affine_grid`` conventions).

Counterpart of ``megaportraits_tpu/ops/affine_grid.py``: Euler degrees to a
rotation matrix, a 4x4 affine that is optionally inverted, and the
``affine_grid`` lattice with (x, y, z) in the last axis.
``affine_grid_3d.host_uploads`` counts its base grids made from host data.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch

from megaportraits_tpu_torch.core.device import upload


def rotation_matrix_from_euler_deg(rotation_deg: torch.Tensor) -> torch.Tensor:
    """Euler degrees [B,3] -> rotation matrices [B,3,3], R = R_x @ R_y @ R_z."""
    rad = rotation_deg * (math.pi / 180.0)
    ca, cb, cg = torch.cos(rad[:, 0]), torch.cos(rad[:, 1]), torch.cos(rad[:, 2])
    sa, sb, sg = torch.sin(rad[:, 0]), torch.sin(rad[:, 1]), torch.sin(rad[:, 2])
    zero = torch.zeros_like(ca)
    one = torch.ones_like(ca)

    def mat(rows):
        return torch.stack([torch.stack(r, dim=1) for r in rows], dim=1)

    r_a = mat([[one, zero, zero], [zero, ca, -sa], [zero, sa, ca]])
    r_b = mat([[cb, zero, sb], [zero, one, zero], [-sb, zero, cb]])
    r_g = mat([[cg, -sg, zero], [sg, cg, zero], [zero, zero, one]])
    return r_a @ (r_b @ r_g)


@functools.lru_cache(maxsize=None)
def _base_grid_3d(d: int, h: int, w: int, align_corners: bool) -> np.ndarray:
    """Homogeneous base grid [D,H,W,4] of (x, y, z, 1); x varies along W."""

    def axis_coords(s: int) -> np.ndarray:
        if s == 1:
            return np.zeros((1,), dtype=np.float64)
        c = np.linspace(-1.0, 1.0, s)
        if not align_corners:
            c = c * (s - 1) / s
        return c

    grid = np.empty((d, h, w, 4), dtype=np.float64)
    grid[..., 0] = axis_coords(w)[None, None, :]
    grid[..., 1] = axis_coords(h)[None, :, None]
    grid[..., 2] = axis_coords(d)[:, None, None]
    grid[..., 3] = 1.0
    return grid.astype(np.float32)


def affine_grid_3d(theta: torch.Tensor, size: Tuple[int, int, int],
                   align_corners: bool = False) -> torch.Tensor:
    """torch ``F.affine_grid(theta, (B,1,D,H,W))``: theta [B,3,4] ->
    grid [B,D,H,W,3] with (x, y, z) in the last axis."""
    d, h, w = size
    base = upload(_base_grid_3d(d, h, w, align_corners), theta.device, affine_grid_3d)
    out = torch.einsum("bij,nj->bni", theta.float(), base.reshape(-1, 4))
    return out.reshape(theta.shape[0], d, h, w, 3)


affine_grid_3d.host_uploads = 0


def compute_rt_warp(rotation_deg: torch.Tensor, translation: torch.Tensor,
                    invert: bool = False, grid_size: int = 64) -> torch.Tensor:
    """Head-pose rotation/translation warp: 4x4 affine from (R, t), optionally
    inverted (source -> canonical), over grid_size^3 with
    align_corners=False. Returns [B, D, H, W, 3] (x, y, z)."""
    b = rotation_deg.shape[0]
    rot = rotation_matrix_from_euler_deg(rotation_deg.float())
    affine = torch.eye(4, device=rot.device).repeat(b, 1, 1)
    affine[:, :3, :3] = rot
    affine[:, :3, 3] = translation.float()
    if invert:
        affine = torch.linalg.inv(affine)
    return affine_grid_3d(affine[:, :3, :], (grid_size,) * 3, align_corners=False)
