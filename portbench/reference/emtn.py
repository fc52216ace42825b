"""Emtn — motion encoder (counterpart of ``megaportraits_tpu/models/emtn.py``).

Outputs per image:
  * rotation [B,3] Euler degrees from the frozen SixDRepNet (always eval,
    no gradient), fed at 224x224 by default;
  * translation [B,3]: the resnet18 head-pose net's fc->6, last 3 slots;
  * expression [B,512]: a headless resnet18, global pool tiled to 2x2 and
    flattened in (h, w, c) order -> Linear(2048 -> 512).
The translation/expression nets see the image at 256x256 by default.
"""

from __future__ import annotations

import torch
from torch import nn

from portbench.reference.arch import FULL, Arch
from portbench.reference.dtypes import DEFAULT_POLICY, Policy
from portbench.reference.repvgg import SixDRepNet
from portbench.reference.resnet import BasicBlock, ResNet18, _ResNetTrunk
from portbench.reference.layers import TorchDense
from portbench.reference.resize import linear_resize


class Emtn(nn.Module):
    def __init__(self, policy: Policy = DEFAULT_POLICY, arch: Arch = FULL,
                 rotation_input_size: int = 224, descriptor_input_size: int = 256,
                 device=None):
        super().__init__()
        self.policy = policy
        self.rotation_input_size = rotation_input_size
        self.descriptor_input_size = descriptor_input_size
        kw = dict(policy=policy, arch=arch, device=device)
        self.rotation_net = SixDRepNet(**kw)
        self.head_pose_net = ResNet18(num_classes=6, **kw)
        self.expression_net = _ResNetTrunk(BasicBlock, arch.resnet18_layers, **kw)
        self.fc = TorchDense(4 * self.expression_net.out_channels, arch.compress_dim,
                             policy=policy, device=device)

    @staticmethod
    def _maybe_resize(img: torch.Tensor, s: int) -> torch.Tensor:
        if s and (img.shape[1] > s or img.shape[2] > s):
            return linear_resize(img, (s, s), axes=(1, 2), align_corners=False)
        return img

    def forward(self, x: torch.Tensor, train: bool = False):
        x = self.policy.cast_to_compute(x)
        with torch.no_grad():  # the frozen detector gets no gradient
            _, rotation = self.rotation_net(
                self._maybe_resize(x, self.rotation_input_size))
        x = self._maybe_resize(x, self.descriptor_input_size)
        translation = self.head_pose_net(x, train)[:, 3:].float()
        pooled = self.expression_net(x, train).mean(dim=(1, 2))  # [B, C]
        tiled = pooled[:, None, :].expand(-1, 4, -1)  # 2x2 adaptive pool
        expression = self.fc(tiled.reshape(x.shape[0], -1))  # (h, w, c) order
        return rotation, translation, expression.float()
