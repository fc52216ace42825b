"""Residual building blocks (counterpart of ``megaportraits_tpu/nn/blocks.py``).

Channels-last in and out, like the JAX blocks. Parameter names follow the
JAX module names so that ``utils/jax_bridge.py`` maps them one to one.

The Student's blocks (``ResBlockBN``, ``SPADE``, ``SPADEResBlock``) carry
the JAX package's fixes of the reference: SPADE's shared conv takes the
feature width, and a width change gets a 1x1 shortcut.
"""

from __future__ import annotations

import torch
from torch import nn

from portbench.reference.dtypes import DEFAULT_POLICY, Policy
from portbench.reference.layers import (
    AdaptiveGroupNorm,
    AffineGroupNorm,
    BatchNorm,
    GroupNorm32,
    TorchConv,
    WSConv,
)


class ResBlockCustom(nn.Module):
    """Reference ResBlock_Custom, 2D or 3D by `dims`.

    residual = conv3(x); main = conv3(relu(GN32(conv3_ws(relu(GN32(x))))));
    out = main + residual.
    """

    def __init__(self, dims: int, in_channels: int, out_channels: int,
                 policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        k = (3,) * dims
        self.conv_res = TorchConv(in_channels, out_channels, k, padding=1,
                                  policy=policy, device=device)
        self.norm_in = GroupNorm32()
        self.conv_ws = WSConv(in_channels, out_channels, k, padding=1,
                              policy=policy, device=device)
        self.norm_mid = GroupNorm32()
        self.conv = TorchConv(out_channels, out_channels, k, padding=1,
                              policy=policy, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out2 = self.conv_res(x)
        out1 = torch.relu(self.norm_in(x))
        out1 = torch.relu(self.norm_mid(self.conv_ws(out1)))
        return self.conv(out1) + out2


class ResBlock2DAdaptive(nn.Module):
    """Reference ResBlock2D_Adaptive (NHWC): conv-AGN-relu-conv-AGN, 1x1
    residual conv when the width changes, relu. (The JAX block's optional
    upsample is unused by every caller and not ported.)"""

    dims = 2

    def __init__(self, in_channels: int, out_channels: int,
                 policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        k = (3,) * self.dims
        self.conv1 = TorchConv(in_channels, out_channels, k, padding=1,
                               policy=policy, device=device)
        self.norm1 = AdaptiveGroupNorm(out_channels, policy=policy, device=device)
        self.conv2 = TorchConv(out_channels, out_channels, k, padding=1,
                               policy=policy, device=device)
        self.norm2 = AdaptiveGroupNorm(out_channels, policy=policy, device=device)
        self.residual_conv = (
            TorchConv(in_channels, out_channels, (1,) * self.dims,
                      policy=policy, device=device)
            if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.norm1(self.conv1(x)))
        out = self.norm2(self.conv2(out))
        residual = x if self.residual_conv is None else self.residual_conv(x)
        return torch.relu(out + residual)


class ResBlock3DAdaptive(ResBlock2DAdaptive):
    """Reference ResBlock3D_Adaptive: the same block over NDHWC."""

    dims = 3


class ResBlock3D(nn.Module):
    """Reference ResBlock3D: GN(affine)+ReLU, 1x1x1 shortcut (NDHWC). (The
    JAX block's optional upsample is unused by every caller and not ported.)"""

    def __init__(self, in_channels: int, out_channels: int,
                 policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        self.shortcut = (
            TorchConv(in_channels, out_channels, (1, 1, 1), policy=policy,
                      device=device)
            if in_channels != out_channels else None)
        self.conv1 = TorchConv(in_channels, out_channels, (3, 3, 3), padding=1,
                               policy=policy, device=device)
        self.gn1 = AffineGroupNorm(out_channels, policy=policy, device=device)
        self.conv2 = TorchConv(out_channels, out_channels, (3, 3, 3), padding=1,
                               policy=policy, device=device)
        self.gn2 = AffineGroupNorm(out_channels, policy=policy, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.shortcut is None else self.shortcut(x)
        out = torch.relu(self.gn1(self.conv1(x)))
        out = self.gn2(self.conv2(out))
        return torch.relu(out + identity)


class ResBlock2D(nn.Module):
    """Reference ResBlock2D: conv3-norm-ReLU-conv3-norm (+ a 1x1 conv + norm
    shortcut when the width changes) -> ReLU. The JAX block's ``downsample``
    option is unused and broken there (it strides only the shortcut), so it
    is not ported.

    ``norm='batch'`` (the reference) uses BatchNorm (``bn1``, ``bn2``,
    ``shortcut_bn``); ``norm='group'`` uses AffineGroupNorm(32) (``gn1``,
    ``gn2``, ``shortcut_gn``), which has no batch statistics, so ``train``
    changes nothing there.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 policy: Policy = DEFAULT_POLICY,
                 norm: str = "batch", device=None):
        super().__init__()
        if norm not in ("batch", "group"):
            raise ValueError(f"unknown norm {norm!r}; expected 'batch' or 'group'")
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.policy = policy
        self.norm = norm
        f = out_channels
        norm_cls, prefix = ((BatchNorm, "bn") if norm == "batch"
                            else (AffineGroupNorm, "gn"))
        self.conv1 = TorchConv(in_channels, f, (3, 3), padding=1, policy=policy,
                               device=device)
        self.add_module(f"{prefix}1", norm_cls(f, policy=policy, device=device))
        self.conv2 = TorchConv(f, f, (3, 3), padding=1, policy=policy,
                               device=device)
        self.add_module(f"{prefix}2", norm_cls(f, policy=policy, device=device))
        if in_channels != f:
            self.shortcut_conv = TorchConv(in_channels, f, (1, 1), policy=policy,
                                           device=device)
            self.add_module(f"shortcut_{prefix}",
                            norm_cls(f, policy=policy, device=device))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if self.norm == "group":
            identity = x
            if self.in_channels != self.out_channels:
                identity = self.shortcut_gn(self.shortcut_conv(x))
            out = torch.relu(self.gn1(self.conv1(x)))
            return torch.relu(self.gn2(self.conv2(out)) + identity)

        identity = x
        if self.in_channels != self.out_channels:
            identity = self.shortcut_bn(self.shortcut_conv(x), train)


        out = torch.relu(self.bn1(self.conv1(x), train))
        out = self.bn2(self.conv2(out), train)
        return torch.relu(out + identity)

