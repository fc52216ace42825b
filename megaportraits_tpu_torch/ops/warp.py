"""3D flow-field application and the 2D grid sample (counterpart of
``megaportraits_tpu/ops/warp.py``).

Trilinear-resize the flow to the volume dims (``align_corners=True``), add
it to an identity grid in (x, y, z) order, renormalize, then sample the
volume trilinearly with border padding and ``align_corners=True``.

The sample is ``F.grid_sample`` (5-D) itself, which is the reference op; the
JAX package has no Pallas kernel here either (``ops/pallas/README.md``).
The volume is sampled in float32 so that bf16 volumes keep float32
coordinates; the result has the volume's dtype.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from megaportraits_tpu_torch.nn.layers import to_channels_first, to_channels_last
from megaportraits_tpu_torch.ops.resize import linear_resize


@functools.lru_cache(maxsize=None)
def _identity_grid(d: int, h: int, w: int) -> np.ndarray:
    """[D,H,W,3] identity grid with (x,y,z) in [-1,1], align-corners spacing."""
    zs = np.linspace(-1.0, 1.0, d) if d > 1 else np.zeros((1,))
    ys = np.linspace(-1.0, 1.0, h) if h > 1 else np.zeros((1,))
    xs = np.linspace(-1.0, 1.0, w) if w > 1 else np.zeros((1,))
    grid = np.empty((d, h, w, 3), dtype=np.float64)
    grid[..., 0] = xs[None, None, :]
    grid[..., 1] = ys[None, :, None]
    grid[..., 2] = zs[:, None, None]
    return grid.astype(np.float32)


def grid_sample_3d(v: torch.Tensor, coords: torch.Tensor,
                   align_corners: bool = True) -> torch.Tensor:
    """Trilinear sample of v [B,D,H,W,C] at coords [B,Do,Ho,Wo,3] (x,y,z in
    [-1,1]) with border padding; float32 math, result in v's dtype."""
    out = F.grid_sample(to_channels_first(v.float()), coords.float(),
                        mode="bilinear", padding_mode="border",
                        align_corners=align_corners)
    return to_channels_last(out).to(v.dtype)


def _reflect_about_pixel_edges(x: torch.Tensor, size: torch.Tensor) -> torch.Tensor:
    """Pixel coordinates reflected about -0.5 and size - 0.5, then clamped
    into [0, size - 1] (JAX's ``_reflect_coords``)."""
    span = size
    x = torch.remainder(x + 0.5, 2.0 * span)
    x = torch.where(x > span, 2.0 * span - x, x) - 0.5
    return torch.minimum(torch.clamp(x, min=0.0), size - 1)


def grid_sample_2d(v: torch.Tensor, coords: torch.Tensor,
                   align_corners: bool = False,
                   padding_mode: str = "border") -> torch.Tensor:
    """Bilinear sample of v [B,H,W,C] at coords [B,Ho,Wo,2] ((x, y) in
    [-1, 1]), torch's conventions: `padding_mode` 'border', 'reflection'
    or 'zeros'. Float32 math, result in v's dtype.

    With 'reflection' and ``align_corners=True`` this computes what JAX's
    ``grid_sample_2d`` computes, which differs from torch there: the pixel
    coordinate (``align_corners=True``'s) is reflected about -0.5 and
    size - 0.5, the ``align_corners=False`` bounds, and clamped into the
    image; torch reflects about 0 and size - 1. The sample at that pixel
    coordinate is then taken with border padding."""
    if padding_mode not in ("border", "reflection", "zeros"):
        raise ValueError(f"unknown padding_mode: {padding_mode}")
    coords = coords.float()
    if padding_mode == "reflection" and align_corners:
        sizes = torch.tensor([v.shape[2], v.shape[1]], dtype=torch.float32,
                             device=coords.device)
        pixel = _reflect_about_pixel_edges((coords + 1.0) * 0.5 * (sizes - 1), sizes)
        coords = pixel * 2.0 / (sizes - 1).clamp(min=1.0) - 1.0
        padding_mode = "border"
    out = F.grid_sample(to_channels_first(v.float()), coords,
                        mode="bilinear", padding_mode=padding_mode,
                        align_corners=align_corners)
    return to_channels_last(out).to(v.dtype)


def apply_warping_field(v: torch.Tensor, flow: torch.Tensor,
                        normalize_mode: str = "reference") -> torch.Tensor:
    """Warp a feature volume v [B,D,H,W,C] by a flow [B,Df,Hf,Wf,3].

    normalize_mode 'reference' replicates the reference renormalization
    ``2*(grid+flow)/[W-1,H-1,D-1] - 1`` (needed for checkpoint parity);
    'standard' samples at grid+flow directly.
    """
    b, d, h, w, c = v.shape
    flow = linear_resize(flow, (d, h, w), axes=(1, 2, 3), align_corners=True)
    grid = torch.as_tensor(_identity_grid(d, h, w), device=v.device)[None]
    warped = grid + flow.float()
    if normalize_mode == "reference":
        norm = torch.tensor([w - 1, h - 1, d - 1], dtype=torch.float32,
                            device=v.device)
        warped = 2.0 * warped / norm - 1.0
    elif normalize_mode != "standard":
        raise ValueError(f"unknown normalize_mode: {normalize_mode}")
    return grid_sample_3d(v, warped, align_corners=True)
