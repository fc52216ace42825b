"""Residual building blocks (counterpart of ``megaportraits_tpu/nn/blocks.py``).

Channels-last in and out, like the JAX blocks. Parameter names follow the
JAX module names so that ``utils/jax_bridge.py`` maps them one to one.

``ResBlock2D`` has only the ``norm='batch'`` variant here; the GroupNorm
variant and the SPADE / ResBlockBN blocks belong to later stages.
"""

from __future__ import annotations

import torch
from torch import nn

from megaportraits_tpu_torch.core.dtypes import DEFAULT_POLICY, Policy
from megaportraits_tpu_torch.nn.layers import (
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


class ResBlock3DAdaptive(nn.Module):
    """Reference ResBlock3D_Adaptive (NDHWC): conv-AGN-relu-conv-AGN,
    1x1x1 residual conv when the width changes, relu. (The JAX block's
    optional upsample is unused by every caller and not ported.)"""

    def __init__(self, in_channels: int, out_channels: int,
                 policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        self.conv1 = TorchConv(in_channels, out_channels, (3, 3, 3), padding=1,
                               policy=policy, device=device)
        self.norm1 = AdaptiveGroupNorm(out_channels, policy=policy, device=device)
        self.conv2 = TorchConv(out_channels, out_channels, (3, 3, 3), padding=1,
                               policy=policy, device=device)
        self.norm2 = AdaptiveGroupNorm(out_channels, policy=policy, device=device)
        self.residual_conv = (
            TorchConv(in_channels, out_channels, (1, 1, 1), policy=policy,
                      device=device)
            if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.norm1(self.conv1(x)))
        out = self.norm2(self.conv2(out))
        residual = x if self.residual_conv is None else self.residual_conv(x)
        return torch.relu(out + residual)


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


def conv_weight_hwio(conv: TorchConv, dtype: torch.dtype) -> torch.Tensor:
    """OIHW conv weight -> contiguous HWIO in `dtype` (the kernels' layout)."""
    return conv.weight.permute(2, 3, 1, 0).contiguous().to(dtype)


class ResBlock2D(nn.Module):
    """Reference ResBlock2D with BatchNorm: conv3-BN-ReLU-conv3-BN
    (+ a 1x1 conv + BN shortcut when the width changes) -> ReLU. The JAX
    block's ``downsample`` option is unused and broken there (it strides
    only the shortcut), so it is not ported.

    With ``use_pallas`` (the JAX switch's name) eligible blocks run in eval
    mode as two launches of kernel K1 (``ops/kernels/conv3x3.py``), BN
    folded into the epilogue: conv1+BN1+ReLU, then conv2+BN2+residual+ReLU.
    Eligibility is the JAX predicate without its TPU-only VMEM bound.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 policy: Policy = DEFAULT_POLICY, use_pallas: bool = False,
                 norm: str = "batch", device=None):
        super().__init__()
        if norm != "batch":
            raise NotImplementedError(
                f"ResBlock2D norm={norm!r}: only 'batch' is ported so far")
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.policy = policy
        self.use_pallas = use_pallas
        self.norm = norm
        f = out_channels
        self.conv1 = TorchConv(in_channels, f, (3, 3), padding=1, policy=policy,
                               device=device)
        self.bn1 = BatchNorm(f, policy=policy, device=device)
        self.conv2 = TorchConv(f, f, (3, 3), padding=1, policy=policy,
                               device=device)
        self.bn2 = BatchNorm(f, policy=policy, device=device)
        if in_channels != f:
            self.shortcut_conv = TorchConv(in_channels, f, (1, 1), policy=policy,
                                           device=device)
            self.shortcut_bn = BatchNorm(f, policy=policy, device=device)

    def eligible(self, x: torch.Tensor) -> bool:
        """JAX ``ResBlock2D._eligible`` without the VMEM byte bound."""
        _, h, w, c = x.shape
        f = self.out_channels
        if not self.use_pallas or self.norm != "batch":
            return False
        return (c % 128 == 0 and f % 128 == 0 and h % 8 == 0 and w % 8 == 0
                and c == f)

    def chain_params(self):
        """(k1, k2, scale1, shift1, scale2, shift2): HWIO conv weights in the
        compute dtype and the BN-folded float32 epilogues, for K1/K2."""
        cdt = self.policy.compute_dtype
        s1, t1 = self.bn1.folded_scale_shift(self.conv1.bias)
        s2, t2 = self.bn2.folded_scale_shift(self.conv2.bias)
        return (conv_weight_hwio(self.conv1, cdt), conv_weight_hwio(self.conv2, cdt),
                s1, t1, s2, t2)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        identity = x
        if self.in_channels != self.out_channels:
            identity = self.shortcut_bn(self.shortcut_conv(x), train)

        if not train and self.eligible(x):
            from megaportraits_tpu_torch.ops.kernels.conv3x3 import conv3x3_bn_act

            cdt = self.policy.compute_dtype
            k1, k2, s1, t1, s2, t2 = self.chain_params()
            outs = []
            for xi, ri in zip(x.to(cdt), identity.to(cdt)):
                h1 = conv3x3_bn_act(xi.contiguous(), k1, s1, t1, None, relu=True)
                outs.append(conv3x3_bn_act(h1, k2, s2, t2, ri.contiguous(),
                                           relu=True))
            return torch.stack(outs)

        out = torch.relu(self.bn1(self.conv1(x), train))
        out = self.bn2(self.conv2(out), train)
        return torch.relu(out + identity)
