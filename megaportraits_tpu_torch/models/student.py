"""Student — the distilled real-time per-avatar generator, SPADE-conditioned
(counterpart of ``megaportraits_tpu/models/student.py``).

  encoder: ResNet18 stem (conv7 stride 2, BN, ReLU, max pool) and stages
           1-2 of ResBlockBN (stride 8, 128 ch) -> conv3 to 192 ->
           ResBlockBN chain 192,192,192,192,96,48,24 at /8
  decoder: SPADEResBlock 24->48->96->192 at /8, nearest x2 up,
           192->192 three times at /4 (six SPADE blocks)
  tail:    nearest x2 + conv3-64 + IN + ReLU (at /2), nearest x2 + conv3-32
           + IN + ReLU (full size), 1x1 conv -> 3, sigmoid in float32

Widths are ``c // width_div`` floored at 8 (BatchNorm and InstanceNorm have
no group constraint), not ``Arch.ch``. ``build_student`` is the factory; it
runs on the card unless asked otherwise.
"""

from __future__ import annotations

from typing import Union

import torch
from torch import nn

from megaportraits_tpu_torch.core.arch import FULL, Arch, get_arch
from megaportraits_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device
from megaportraits_tpu_torch.core.dtypes import DEFAULT_POLICY, Policy
from megaportraits_tpu_torch.models.resnet import max_pool_3x3_s2
from megaportraits_tpu_torch.nn.blocks import ResBlockBN, SPADEResBlock
from megaportraits_tpu_torch.nn.layers import (
    BatchNorm,
    InstanceNorm,
    TorchConv,
    init_parameters,
)
from megaportraits_tpu_torch.ops.resize import upsample_nearest

ENCODER_WIDTHS = (192, 192, 192, 192, 96, 48, 24)
DECODER_WIDTHS = (48, 96, 192, 192, 192, 192)  # dec0-2 at /8, dec3-5 at /4


def _up2(x: torch.Tensor) -> torch.Tensor:
    return upsample_nearest(x, (2, 2), axes=(1, 2))


class Student(nn.Module):
    def __init__(self, num_avatars: int, policy: Policy = DEFAULT_POLICY,
                 arch: Arch = FULL, device=None):
        super().__init__()
        self.policy = policy

        def ch(c):
            return c if arch.width_div <= 1 else max(8, c // arch.width_div)

        kw = dict(policy=policy, device=device)
        self.stem_conv = TorchConv(3, ch(64), (7, 7), strides=2, padding=3, **kw)
        self.stem_bn = BatchNorm(ch(64), **kw)
        self.layer1_0 = ResBlockBN(ch(64), ch(64), **kw)
        self.layer1_1 = ResBlockBN(ch(64), ch(64), **kw)
        self.layer2_0 = ResBlockBN(ch(64), ch(128), downsample=True, **kw)
        self.layer2_1 = ResBlockBN(ch(128), ch(128), **kw)
        self.adapter = TorchConv(ch(128), ch(192), (3, 3), padding=1, **kw)
        prev = ch(192)
        self.enc_names = []
        for i, c in enumerate(ENCODER_WIDTHS):
            self.enc_names.append(f"enc_res{i}")
            self.add_module(f"enc_res{i}", ResBlockBN(prev, ch(c), **kw))
            prev = ch(c)
        self.dec_names = []
        for i, c in enumerate(DECODER_WIDTHS):
            self.dec_names.append(f"dec{i}")
            self.add_module(f"dec{i}", SPADEResBlock(prev, ch(c), num_avatars, **kw))
            prev = ch(c)
        self.tail_conv0 = TorchConv(prev, ch(64), (3, 3), padding=1, **kw)
        self.tail_conv1 = TorchConv(ch(64), ch(32), (3, 3), padding=1, **kw)
        self.final_conv = TorchConv(ch(32), 3, (1, 1), **kw)
        self.norm = InstanceNorm()

    def forward(self, xd: torch.Tensor, avatar_index: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        """xd [B, H, W, 3], avatar_index [B] integers -> [B, H, W, 3] in
        [0, 1]; H and W divisible by 8."""
        x = self.stem_conv(self.policy.cast_to_compute(xd))
        x = max_pool_3x3_s2(torch.relu(self.stem_bn(x, train)))
        for name in ("layer1_0", "layer1_1", "layer2_0", "layer2_1"):
            x = getattr(self, name)(x, train)
        x = self.adapter(x)
        for name in self.enc_names:
            x = getattr(self, name)(x, train)
        for i, name in enumerate(self.dec_names):
            if i == 3:
                x = _up2(x)
            x = getattr(self, name)(x, avatar_index)
        x = torch.relu(self.norm(self.tail_conv0(_up2(x))))
        x = torch.relu(self.norm(self.tail_conv1(_up2(x))))
        x = self.final_conv(x)
        return torch.sigmoid(x.float())


def build_student(num_avatars: int, arch: Union[str, Arch] = "full",
                  policy: Policy = DEFAULT_POLICY,
                  device: Union[str, torch.device] = DEFAULT_DEVICE,
                  seed: int = 0) -> Student:
    """Student with seeded random weights on `device` (the card by default)."""
    model = Student(num_avatars, policy=policy, arch=get_arch(arch),
                    device=resolve_device(device))
    return init_parameters(model, seed)
