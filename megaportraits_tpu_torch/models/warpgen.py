"""Expression warp generators (counterpart of ``megaportraits_tpu/models/warpgen.py``).

FlowField: latent [B,512] -> 1x1 conv to 2048 -> [B,4,1,1,512] volume
(channel-major 512, depth minor 4) -> 4x (ResBlock3D_Adaptive + nearest
upsample) -> 3x3x3 conv-3 -> GroupNorm(1) -> ReLU -> tanh -> [B,16,16,16,3].
The reference applies ReLU *then* tanh, so the flow is non-negative; kept
for checkpoint parity.

WarpGenerator: w = w_rt + resize(w_em), w_em = FlowField((z + e) @ A),
w_rt the rotation/translation affine grid (inverted for source->canonical).
"""

from __future__ import annotations

import torch
from torch import nn

from megaportraits_tpu_torch.core.arch import FULL, Arch
from megaportraits_tpu_torch.core.dtypes import DEFAULT_POLICY, Policy, cast_param
from megaportraits_tpu_torch.nn.blocks import ResBlock3DAdaptive
from megaportraits_tpu_torch.nn.layers import AffineGroupNorm, TorchConv
from megaportraits_tpu_torch.ops.affine_grid import compute_rt_warp
from megaportraits_tpu_torch.ops.resize import linear_resize, upsample_nearest


class FlowField(nn.Module):
    _UPSAMPLES = ((2, 2, 2), (2, 2, 2), (1, 2, 2), (1, 2, 2))

    def __init__(self, policy: Policy = DEFAULT_POLICY, arch: Arch = FULL,
                 device=None):
        super().__init__()
        a = arch
        kw = dict(policy=policy, device=device)
        self.cdim = a.compress_dim
        self.conv1x1 = TorchConv(self.cdim, self.cdim * 4, (1, 1), **kw)
        widths = [self.cdim, a.ch(256), a.ch(128), a.ch(64), a.ch(32)]
        for i in range(4):
            self.add_module(f"resblock{i + 1}",
                            ResBlock3DAdaptive(widths[i], widths[i + 1], **kw))
        self.conv3x3x3 = TorchConv(widths[-1], 3, (3, 3, 3), padding=1, **kw)
        self.gn = AffineGroupNorm(3, num_groups=1, **kw)

    def forward(self, z_sum: torch.Tensor) -> torch.Tensor:
        x = self.conv1x1(z_sum[:, None, None, :])  # [B,1,1,4*cdim]
        b = x.shape[0]
        # torch view(-1, 512, 4, 1, 1): channel-major, depth minor.
        x = x.reshape(b, 1, 1, self.cdim, 4).permute(0, 4, 1, 2, 3).contiguous()
        for i, factors in enumerate(self._UPSAMPLES):
            x = getattr(self, f"resblock{i + 1}")(x)
            x = upsample_nearest(x, factors, axes=(1, 2, 3))
        x = self.gn(self.conv3x3x3(x))
        return torch.tanh(torch.relu(x))  # [B, 16, 16, 16, 3]


class WarpGenerator(nn.Module):
    """S2C (invert=True) / C2D (invert=False) warp generator;
    ``param_casts`` counts the casts of ``adaptive_matrix_gamma``."""

    param_casts = 0

    def __init__(self, invert: bool, grid_size: int = 0,
                 policy: Policy = DEFAULT_POLICY, arch: Arch = FULL, device=None):
        super().__init__()
        self.invert = invert
        self.grid_size = grid_size or arch.grid_size
        self.policy = policy
        self.adaptive_matrix_gamma = nn.Parameter(torch.empty(
            arch.compress_dim, arch.compress_dim, dtype=policy.param_dtype,
            device=device))
        self.flowfield = FlowField(policy=policy, arch=arch, device=device)

    def reset_parameters(self, generator: torch.Generator):
        with torch.no_grad():  # torch.randn, as in the reference
            self.adaptive_matrix_gamma.normal_(0.0, 1.0, generator=generator)

    def forward(self, rotation: torch.Tensor, translation: torch.Tensor,
                z: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
        cdt = self.policy.compute_dtype
        z_sum = (z + e).to(cdt) @ cast_param(self.adaptive_matrix_gamma, cdt, WarpGenerator)
        w_em = self.flowfield(z_sum)
        w_rt = compute_rt_warp(rotation.float(), translation.float(),
                               invert=self.invert, grid_size=self.grid_size)
        w_em = linear_resize(w_em.float(), (self.grid_size,) * 3, axes=(1, 2, 3),
                             align_corners=False)
        return w_rt + w_em  # [B, D, H, W, 3]
