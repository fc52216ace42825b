"""SixDRepNet head-pose estimator in deploy mode (counterpart of
``megaportraits_tpu/models/repvgg.py``): a RepVGG trunk with one
reparameterized 3x3 conv + ReLU per block, global average pool, a linear
6-dim head, the Gram-Schmidt ortho6d rotation and Euler angles; and
``SixDRepNet2`` (a resnet18 trunk with the same head) with the
``geodesic_loss`` its trainers use.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from portbench.reference.arch import FULL, Arch
from portbench.reference.dtypes import DEFAULT_POLICY, Policy
from portbench.reference.resnet import BasicBlock, _ResNetTrunk
from portbench.reference.layers import TorchConv, TorchDense


def _normalize(v: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    mag = torch.clamp(torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True)), min=eps)
    return v / mag


def rotation_6d_to_matrix(poses: torch.Tensor) -> torch.Tensor:
    """[B,6] ortho6d -> [B,3,3] rotation (Gram-Schmidt, Zhou et al.)."""
    x_raw, y_raw = poses[:, 0:3], poses[:, 3:6]
    x = _normalize(x_raw)
    z = _normalize(torch.linalg.cross(x, y_raw, dim=-1))
    y = torch.linalg.cross(z, x, dim=-1)
    return torch.stack([x, y, z], dim=-1)  # columns x, y, z


def euler_angles_from_matrix(r: torch.Tensor) -> torch.Tensor:
    """[B,3,3] -> [B,3] Euler radians, x-y-z sequence with gimbal handling."""
    sy = torch.sqrt(r[:, 0, 0] ** 2 + r[:, 1, 0] ** 2)
    singular = (sy < 1e-6).to(r.dtype)
    x = torch.atan2(r[:, 2, 1], r[:, 2, 2])
    y = torch.atan2(-r[:, 2, 0], sy)
    z = torch.atan2(r[:, 1, 0], r[:, 0, 0])
    xs = torch.atan2(-r[:, 1, 2], r[:, 1, 1])
    zs = torch.zeros_like(z)
    return torch.stack(
        [x * (1 - singular) + xs * singular, y, z * (1 - singular) + zs * singular],
        dim=1,
    )


# RepVGG-B1g2, the detector's backbone: blocks per stage, width multipliers,
# and 2 groups on the even-numbered ("optional groupwise") layers.
_B1G2_BLOCKS = (4, 6, 16, 1)
_B1G2_WIDTHS = (2, 2, 2, 4)
_B1G2_GROUPS = 2
_OPTIONAL_GROUPWISE_LAYERS = (2, 4, 6, 8, 10, 12, 14, 16, 18, 20, 22, 24, 26)


class RepVGGBlock(nn.Module):
    """One deploy-mode RepVGG block: 3x3 conv (grouped) + ReLU."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 groups: int = 1, policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        self.rbr_reparam = TorchConv(in_channels, out_channels, (3, 3),
                                     strides=stride, padding=1,
                                     feature_group_count=groups, policy=policy,
                                     device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.rbr_reparam(x))


class RepVGG(nn.Module):
    """RepVGG-B1g2 trunk: stage0 + 4 stages, returns [B, H/32, W/32, C4]."""

    def __init__(self, policy: Policy = DEFAULT_POLICY, arch: Arch = FULL,
                 device=None):
        super().__init__()
        a = arch
        widths = _B1G2_WIDTHS
        blocks = a.repvgg_blocks or _B1G2_BLOCKS
        in_planes = a.ch(min(64, int(64 * widths[0])))
        kw = dict(policy=policy, device=device)
        self.stage0 = RepVGGBlock(3, in_planes, stride=2, **kw)
        stage_planes = [a.ch(int(64 * widths[0])), a.ch(int(128 * widths[1])),
                        a.ch(int(256 * widths[2])), a.ch(int(512 * widths[3]))]
        self.block_names = []
        layer_idx = 1
        cin = in_planes
        for stage, (planes, n) in enumerate(zip(stage_planes, blocks)):
            for i in range(n):
                name = f"stage{stage + 1}_block{i}"
                self.add_module(name, RepVGGBlock(
                    cin, planes, stride=2 if i == 0 else 1,
                    groups=(_B1G2_GROUPS if layer_idx in _OPTIONAL_GROUPWISE_LAYERS
                            else 1), **kw))
                self.block_names.append(name)
                cin = planes
                layer_idx += 1
        self.out_channels = cin

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stage0(x)
        for name in self.block_names:
            x = getattr(self, name)(x)
        return x


class SixDRepNet(nn.Module):
    """RepVGG-B1g2 trunk -> GAP -> linear 6 -> ortho6d rotation matrix.

    ``forward`` returns (rotation_matrix [B,3,3], euler_degrees [B,3]).
    """

    def __init__(self, policy: Policy = DEFAULT_POLICY, arch: Arch = FULL,
                 device=None):
        super().__init__()
        self.trunk = RepVGG(policy=policy, arch=arch, device=device)
        self.linear_reg = TorchDense(self.trunk.out_channels, 6, policy=policy,
                                     device=device)

    def forward(self, x: torch.Tensor):
        pooled = self.trunk(x).mean(dim=(1, 2)).float()
        six = self.linear_reg(pooled)
        rot = rotation_6d_to_matrix(six.float())
        return rot, euler_angles_from_matrix(rot) * (180.0 / math.pi)


class SixDRepNet2(nn.Module):
    """The ResNet-backbone 6D-rotation estimator: a resnet18 trunk (FULL
    widths) -> global average pool -> linear 6 -> ortho6d rotation
    [B, 3, 3]."""

    def __init__(self, policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        self.trunk = _ResNetTrunk(BasicBlock, (2, 2, 2, 2), policy=policy, device=device)
        self.linear_reg = TorchDense(self.trunk.out_channels, 6, policy=policy,
                                     device=device)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        pooled = self.trunk(x, train).mean(dim=(1, 2)).float()
        return rotation_6d_to_matrix(self.linear_reg(pooled).float())


def geodesic_loss(m1: torch.Tensor, m2: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """The mean geodesic angle (radians) between rotations m1 and m2
    [B, 3, 3]; the cosine is clipped to (-1 + eps, 1 - eps)."""
    m = m1.float() @ m2.float().transpose(1, 2)
    cos = (m[:, 0, 0] + m[:, 1, 1] + m[:, 2, 2] - 1.0) / 2.0
    return torch.mean(torch.arccos(torch.clamp(cos, -1.0 + eps, 1.0 - eps)))
