"""CIFAR-style ResNets (counterpart of ``megaportraits_tpu/models/cifar_resnet.py``):
a 3x3 stem without max pool, for 32x32-class inputs; distinct from the
torchvision ImageNet layout of ``models/resnet.py``, whose blocks it
shares."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from megaportraits_tpu_torch.core.dtypes import DEFAULT_POLICY, Policy
from megaportraits_tpu_torch.models.resnet import BasicBlock, Bottleneck
from megaportraits_tpu_torch.nn.layers import BatchNorm, TorchConv, TorchDense


class CifarResNet(nn.Module):
    """3x3 conv 64 + BN + ReLU, four stages of `block` (64, 128, 256, 512
    planes; stride 2 from the second), global average pool, and a linear
    head to `num_classes` (the pooled features when 0)."""

    def __init__(self, block: type = BasicBlock, layers: Sequence[int] = (2, 2, 2, 2),
                 num_classes: int = 10, policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        kw = dict(policy=policy, device=device)
        self.conv1 = TorchConv(3, 64, (3, 3), padding=1, use_bias=False, **kw)
        self.bn1 = BatchNorm(64, **kw)
        in_ch = 64
        self.block_names = []
        for stage, planes in enumerate((64, 128, 256, 512)):
            for i in range(layers[stage]):
                name = f"layer{stage + 1}_block{i}"
                stride = 2 if stage and i == 0 else 1
                self.add_module(name, block(in_ch, planes, stride, **kw))
                self.block_names.append(name)
                in_ch = planes * block.expansion
        self.fc = TorchDense(in_ch, num_classes, **kw) if num_classes else None

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = torch.relu(self.bn1(self.conv1(x), train))
        for name in self.block_names:
            x = getattr(self, name)(x, train)
        x = x.mean(dim=(1, 2))
        return x if self.fc is None else self.fc(x)


def cifar_resnet18(num_classes: int = 10, policy: Policy = DEFAULT_POLICY, device=None):
    return CifarResNet(BasicBlock, (2, 2, 2, 2), num_classes, policy, device)


def cifar_resnet34(num_classes: int = 10, policy: Policy = DEFAULT_POLICY, device=None):
    return CifarResNet(BasicBlock, (3, 4, 6, 3), num_classes, policy, device)


def cifar_resnet50(num_classes: int = 10, policy: Policy = DEFAULT_POLICY, device=None):
    return CifarResNet(Bottleneck, (3, 4, 6, 3), num_classes, policy, device)
