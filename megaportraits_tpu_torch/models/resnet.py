"""torchvision-layout ResNets over NHWC (counterpart of
``megaportraits_tpu/models/resnet.py``).

  * CustomResNet50: resnet50 stem + layer1..3, adaptive-avg-pool to 2x2,
    1x1 conv to 512; Eapp's appearance descriptor.
  * ResNet18 (fc -> 6): Emtn's head-pose net; translation = out[:, 3:].
  * _ResNetTrunk(BasicBlock): Emtn's expression net.
  * ResNet50: the torchvision classifier (no caller in the pipeline).

The stem's and BasicBlock's BatchNorms run as ``nn/blocks.BatchNormEpilogue``
(kernel K4 in eval mode on bf16 CUDA tensors outside autograd); the
Bottleneck's (ResNet-50) stay PyTorch's chain.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from megaportraits_tpu_torch.core.arch import FULL, Arch
from megaportraits_tpu_torch.core.dtypes import DEFAULT_POLICY, Policy
from megaportraits_tpu_torch.nn.blocks import BatchNormEpilogue
from megaportraits_tpu_torch.nn.layers import (
    BatchNorm,
    TorchConv,
    TorchDense,
    to_channels_first,
    to_channels_last,
)


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """torch nn.MaxPool2d(3, stride 2, padding 1) over NHWC (the padding
    is -inf, so it never wins the max)."""
    return to_channels_last(F.max_pool2d(to_channels_first(x), 3, 2, 1))


def adaptive_avg_pool_2d(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """torch nn.AdaptiveAvgPool2d over NHWC: bin i spans
    [floor(i*H/oh), ceil((i+1)*H/oh))."""
    _, h, w, _ = x.shape
    oh, ow = out_hw
    rows = []
    for i in range(oh):
        h0, h1 = (i * h) // oh, -(-((i + 1) * h) // oh)
        cols = []
        for j in range(ow):
            w0, w1 = (j * w) // ow, -(-((j + 1) * w) // ow)
            cols.append(x[:, h0:h1, w0:w1, :].mean(dim=(1, 2)))
        rows.append(torch.stack(cols, dim=1))
    return torch.stack(rows, dim=1)  # [B, oh, ow, C]


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_channels: int, planes: int, stride: int = 1,
                 policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        kw = dict(policy=policy, device=device)
        self.conv1 = TorchConv(in_channels, planes, (3, 3), strides=stride,
                               padding=1, use_bias=False, **kw)
        self.bn1 = BatchNorm(planes, **kw)
        self.conv2 = TorchConv(planes, planes, (3, 3), padding=1, use_bias=False,
                               **kw)
        self.bn2 = BatchNorm(planes, **kw)
        self.has_downsample = stride != 1 or in_channels != planes
        if self.has_downsample:
            self.downsample_conv = TorchConv(in_channels, planes, (1, 1),
                                             strides=stride, use_bias=False, **kw)
            self.downsample_bn = BatchNorm(planes, **kw)
        self.epilogue1 = BatchNormEpilogue()
        self.epilogue2 = BatchNormEpilogue()

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """relu(bn1(conv1)), then relu(bn2(conv2) + the identity or the
        downsample), each a ``BatchNormEpilogue`` (kernel K4 where it
        engages)."""
        out = self.epilogue1(train, self.conv1(x), self.bn1)
        if self.has_downsample:
            return self.epilogue2(train, self.conv2(out), self.bn2,
                                  self.downsample_conv(x), self.downsample_bn)
        return self.epilogue2(train, self.conv2(out), self.bn2, x)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_channels: int, planes: int, stride: int = 1,
                 policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        kw = dict(policy=policy, device=device)
        out_ch = planes * self.expansion
        self.conv1 = TorchConv(in_channels, planes, (1, 1), use_bias=False, **kw)
        self.bn1 = BatchNorm(planes, **kw)
        self.conv2 = TorchConv(planes, planes, (3, 3), strides=stride, padding=1,
                               use_bias=False, **kw)
        self.bn2 = BatchNorm(planes, **kw)
        self.conv3 = TorchConv(planes, out_ch, (1, 1), use_bias=False, **kw)
        self.bn3 = BatchNorm(out_ch, **kw)
        self.has_downsample = stride != 1 or in_channels != out_ch
        if self.has_downsample:
            self.downsample_conv = TorchConv(in_channels, out_ch, (1, 1),
                                             strides=stride, use_bias=False, **kw)
            self.downsample_bn = BatchNorm(out_ch, **kw)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x), train))
        out = torch.relu(self.bn2(self.conv2(out), train))
        out = self.bn3(self.conv3(out), train)
        identity = x
        if self.has_downsample:
            identity = self.downsample_bn(self.downsample_conv(x), train)
        return torch.relu(out + identity)


class _ResNetTrunk(nn.Module):
    """conv1/bn1/relu/maxpool + layer1..layerN with torchvision widths."""

    def __init__(self, block: type, layers: Sequence[int], num_stages: int = 4,
                 policy: Policy = DEFAULT_POLICY, arch: Arch = FULL, device=None):
        super().__init__()
        a = arch
        kw = dict(policy=policy, device=device)
        self.conv1 = TorchConv(3, a.ch(64), (7, 7), strides=2, padding=3,
                               use_bias=False, **kw)
        self.bn1 = BatchNorm(a.ch(64), **kw)
        self.stem_epilogue = BatchNormEpilogue()
        planes = [a.ch(64), a.ch(128), a.ch(256), a.ch(512)]
        in_ch = a.ch(64)
        self.block_names = []
        for stage in range(num_stages):
            stride = 1 if stage == 0 else 2
            for i in range(layers[stage]):
                name = f"layer{stage + 1}_block{i}"
                self.add_module(name, block(in_ch, planes[stage],
                                            stride if i == 0 else 1, **kw))
                self.block_names.append(name)
                in_ch = planes[stage] * block.expansion
        self.out_channels = in_ch

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = max_pool_3x3_s2(self.stem_epilogue(train, self.conv1(x), self.bn1))
        for name in self.block_names:
            x = getattr(self, name)(x, train)
        return x


class ResNet18(nn.Module):
    """torchvision resnet18; `num_classes=0` returns pooled trunk features."""

    def __init__(self, num_classes: int = 1000, policy: Policy = DEFAULT_POLICY,
                 arch: Arch = FULL, device=None):
        super().__init__()
        self.trunk = _ResNetTrunk(BasicBlock, arch.resnet18_layers, policy=policy,
                                  arch=arch, device=device)
        self.fc = (TorchDense(self.trunk.out_channels, num_classes, policy=policy,
                              device=device)
                   if num_classes else None)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = self.trunk(x, train).mean(dim=(1, 2))  # global average pool
        return x if self.fc is None else self.fc(x)


class ResNet50(nn.Module):
    """torchvision resnet50; `num_classes=0` returns pooled trunk features."""

    def __init__(self, num_classes: int = 1000, policy: Policy = DEFAULT_POLICY,
                 arch: Arch = FULL, device=None):
        super().__init__()
        self.trunk = _ResNetTrunk(Bottleneck, arch.resnet50_layers, policy=policy,
                                  arch=arch, device=device)
        self.fc = (TorchDense(self.trunk.out_channels, num_classes, policy=policy,
                              device=device)
                   if num_classes else None)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = self.trunk(x, train).mean(dim=(1, 2))
        return x if self.fc is None else self.fc(x)


class CustomResNet50(nn.Module):
    """resnet50 stem + layer1..layer3, adaptive-avg-pool to 2x2, 1x1 conv to
    512. Output [B, 2, 2, 512]."""

    def __init__(self, policy: Policy = DEFAULT_POLICY, arch: Arch = FULL,
                 device=None):
        super().__init__()
        self.trunk = _ResNetTrunk(Bottleneck, arch.resnet50_layers[:3],
                                  num_stages=3, policy=policy, arch=arch,
                                  device=device)
        self.conv_reduce = TorchConv(self.trunk.out_channels, arch.ch(512), (1, 1),
                                     policy=policy, device=device)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = adaptive_avg_pool_2d(self.trunk(x, train), (2, 2))
        return self.conv_reduce(x)
