"""Warp-field and head-pose debug pictures (counterpart of
``megaportraits_tpu/utils/viz.py``). Host-side, on numpy arrays: pass
tensors as ``t.detach().float().cpu().numpy()``. cv2 and matplotlib are
imported inside the functions that draw (the machine with the card has
neither)."""

from __future__ import annotations

from typing import Optional

import numpy as np


def plot_warp_field(ax, warp_field: np.ndarray, title: str, sample_rate: int = 3) -> None:
    """3D quiver of a flow field [D, H, W, 3] (channels last) on a
    matplotlib 3D axis: red where a component is positive, blue where
    negative."""
    depth, height, width = warp_field.shape[:3]
    xs = np.arange(0, width, sample_rate)
    ys = np.arange(0, height, sample_rate)
    zs = np.arange(0, depth, sample_rate)
    gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")
    sub = warp_field[::sample_rate, ::sample_rate, ::sample_rate]
    u = sub[..., 0].transpose(2, 1, 0)
    v = sub[..., 1].transpose(2, 1, 0)
    w = sub[..., 2].transpose(2, 1, 0)
    pos = (u > 0) | (v > 0) | (w > 0)
    neg = (u < 0) | (v < 0) | (w < 0)
    ax.quiver(gx[pos], gy[pos], gz[pos], u[pos], v[pos], w[pos],
              color="red", length=0.3, normalize=True)
    ax.quiver(gx[neg], gy[neg], gz[neg], u[neg], v[neg], w[neg],
              color="blue", length=0.3, normalize=True)
    ax.set_xlabel("X")
    ax.set_ylabel("Y")
    ax.set_zlabel("Z")
    ax.set_title(title)


def draw_axis(img: np.ndarray, yaw: float, pitch: float, roll: float,
              tdx: Optional[float] = None, tdy: Optional[float] = None,
              size: float = 100.0) -> np.ndarray:
    """Head-pose axes (degrees) drawn on `img` ([H, W, 3] uint8, or float
    in [0, 1]) from (tdx, tdy), the centre by default; returns uint8."""
    import cv2

    out = ((np.clip(img, 0, 1) * 255).astype(np.uint8) if img.dtype != np.uint8
           else img.copy())
    h, w = out.shape[:2]
    pitch_r = pitch * np.pi / 180
    yaw_r = -yaw * np.pi / 180
    roll_r = roll * np.pi / 180
    tdx = tdx if tdx is not None else w / 2
    tdy = tdy if tdy is not None else h / 2
    x1 = size * (np.cos(yaw_r) * np.cos(roll_r)) + tdx
    y1 = size * (np.cos(pitch_r) * np.sin(roll_r)
                 + np.cos(roll_r) * np.sin(pitch_r) * np.sin(yaw_r)) + tdy
    x2 = size * (-np.cos(yaw_r) * np.sin(roll_r)) + tdx
    y2 = size * (np.cos(pitch_r) * np.cos(roll_r)
                 - np.sin(pitch_r) * np.sin(yaw_r) * np.sin(roll_r)) + tdy
    x3 = size * np.sin(yaw_r) + tdx
    y3 = size * (-np.cos(yaw_r) * np.sin(pitch_r)) + tdy
    cv2.line(out, (int(tdx), int(tdy)), (int(x1), int(y1)), (0, 0, 255), 3)
    cv2.line(out, (int(tdx), int(tdy)), (int(x2), int(y2)), (0, 255, 0), 3)
    cv2.line(out, (int(tdx), int(tdy)), (int(x3), int(y3)), (255, 0, 0), 2)
    return out


def visualize_warp_fields(xs: np.ndarray, xd: np.ndarray, w_s2c: np.ndarray,
                          w_c2d: np.ndarray, out_path: Optional[str] = None):
    """Source and driving images ([H, W, 3] in [0, 1]) and both warp fields
    ([D, H, W, 3]) in one figure: written to `out_path` (and closed), or
    returned."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(15, 10))
    for i, (img, title) in enumerate(((xs, "Source"), (xd, "Driving"))):
        ax = fig.add_subplot(2, 2, i + 1)
        ax.imshow(np.clip(img, 0, 1))
        ax.set_title(title)
        ax.axis("off")
    plot_warp_field(fig.add_subplot(2, 2, 3, projection="3d"), w_s2c, "w_s2c")
    plot_warp_field(fig.add_subplot(2, 2, 4, projection="3d"), w_c2d, "w_c2d")
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=80)
        plt.close(fig)
        return None
    return fig
