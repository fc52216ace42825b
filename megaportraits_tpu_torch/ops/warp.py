"""3D flow-field application (counterpart of ``megaportraits_tpu/ops/warp.py``).

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
