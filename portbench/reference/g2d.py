"""G2d — 2D synthesis network (counterpart of ``megaportraits_tpu/models/g2d.py``).

Projected volume [B, H/8, W/8, 96] -> 1x1 conv 96->1536 -> 1x1 1536->512 ->
8x ResBlock2D-512 (the trunk) -> 3x (bilinear up x2, align_corners=True, +
ResBlock2D 512->256->128->64) -> GN+ReLU+3x3 conv-3 -> sigmoid in float32
-> [B, H, W, 3].

The trunk is the eight plain blocks, whatever kernel the measured program
runs it on.
"""

from __future__ import annotations

import torch
from torch import nn

from portbench.reference.arch import FULL, Arch
from portbench.reference.dtypes import DEFAULT_POLICY, Policy
from portbench.reference.blocks import ResBlock2D
from portbench.reference.layers import GroupNorm32, TorchConv
from portbench.reference.resize import linear_resize


def _up2(x: torch.Tensor) -> torch.Tensor:
    sizes = [s * 2 for s in x.shape[1:3]]
    return linear_resize(x, sizes, axes=(1, 2), align_corners=True)


class G2d(nn.Module):
    def __init__(self, policy: Policy = DEFAULT_POLICY, arch: Arch = FULL,
                 device=None):
        super().__init__()
        a = arch
        self.policy = policy
        self.arch = arch
        kw = dict(policy=policy, device=device)
        bkw = dict(kw, norm=a.norm)
        self.reshape_conv = TorchConv(a.volume_channels, a.ch(1536), (1, 1), **kw)
        self.conv1x1 = TorchConv(a.ch(1536), a.ch(512), (1, 1), **kw)
        self.trunk_names = [f"res{i}" for i in range(a.g2d_blocks)]
        for name in self.trunk_names:
            self.add_module(name, ResBlock2D(a.ch(512), a.ch(512), **bkw))
        self.up1 = ResBlock2D(a.ch(512), a.ch(256), **bkw)
        self.up2 = ResBlock2D(a.ch(256), a.ch(128), **bkw)
        self.up3 = ResBlock2D(a.ch(128), a.ch(64), **bkw)
        self.norm = GroupNorm32()
        self.final_conv = TorchConv(a.ch(64), 3, (3, 3), padding=1, **kw)

    def trunk(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """The ResBlock2D trunk on the 1x1 head's output [B, h, w, C]."""
        for name in self.trunk_names:
            x = getattr(self, name)(x, train)
        return x

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = self.trunk(self.conv1x1(self.reshape_conv(x)), train)
        x = self.up1(_up2(x), train)
        x = self.up2(_up2(x), train)
        x = self.up3(_up2(x), train)
        x = self.final_conv(torch.relu(self.norm(x)))
        return torch.sigmoid(x.float())
