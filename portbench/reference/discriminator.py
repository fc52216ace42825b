"""Conditional PatchGAN discriminator (counterpart of
``megaportraits_tpu/models/discriminator.py``).

cat(img_a, img_b) over channels -> ``disc_stages`` x [conv4x4 stride 2
(+ InstanceNorm from the second block) + LeakyReLU(0.2)], 64 -> 512 wide
-> zero pad of one row on top and one column on the left -> conv4x4 -> one
logit channel in float32. A 512x512 input gives a 32x32 patch map.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.arch import FULL, Arch
from portbench.reference.dtypes import DEFAULT_POLICY, Policy
from portbench.reference.layers import InstanceNorm, TorchConv


class Discriminator(nn.Module):
    def __init__(self, policy: Policy = DEFAULT_POLICY, arch: Arch = FULL,
                 device=None):
        super().__init__()
        self.policy = policy
        chans = [arch.ch(64 * 2 ** i) if arch.width_div > 1 else 64 * 2 ** i
                 for i in range(arch.disc_stages)]
        self.n_blocks = len(chans)
        c_in = 6
        for i, ch in enumerate(chans):
            self.add_module(f"block{i}_conv", TorchConv(
                c_in, ch, (4, 4), strides=2, padding=1, policy=policy, device=device))
            c_in = ch
        self.norm = InstanceNorm()
        self.final_conv = TorchConv(c_in, 1, (4, 4), padding=1, use_bias=False,
                                    policy=policy, device=device)

    def forward(self, img_a: torch.Tensor, img_b: torch.Tensor) -> torch.Tensor:
        p = self.policy
        x = torch.cat([p.cast_to_compute(img_a), p.cast_to_compute(img_b)], dim=-1)
        for i in range(self.n_blocks):
            x = getattr(self, f"block{i}_conv")(x)
            if i > 0:
                x = self.norm(x)
            x = F.leaky_relu(x, 0.2)
        # nn.ZeroPad2d((1, 0, 1, 0)) on NHWC: (C: none, W: left, H: top).
        x = F.pad(x, (0, 0, 1, 0, 1, 0))
        return self.final_conv(x).float()

