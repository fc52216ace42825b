"""PatchGanEncoder (counterpart of ``megaportraits_tpu/models/encoders.py``):
a reflection-padded conv encoder to a 1x1 embedding, used by contrastive
losses in the legacy trainers."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from megaportraits_tpu_torch.core.dtypes import DEFAULT_POLICY, Policy
from megaportraits_tpu_torch.nn.layers import (
    BatchNorm,
    TorchConv,
    to_channels_first,
    to_channels_last,
)


class PatchGanEncoder(nn.Module):
    """7x7 conv + BN + ReLU, `n_downsampling` stride-2 3x3 convs doubling
    the width (+ BN + ReLU), a global average pool and a 1x1 projection to
    `output_nc`: [B, H, W, `input_nc`] -> [B, 1, 1, `output_nc`]."""

    def __init__(self, input_nc: int = 3, output_nc: int = 512, ngf: int = 64,
                 n_downsampling: int = 4, policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        kw = dict(policy=policy, device=device)
        self.policy = policy
        self.n_downsampling = n_downsampling
        self.conv0 = TorchConv(input_nc, ngf, (7, 7), **kw)
        self.bn0 = BatchNorm(ngf, **kw)
        for i in range(n_downsampling):
            mult = 2**i
            self.add_module(f"down{i}", TorchConv(ngf * mult, ngf * mult * 2, (3, 3),
                                                  strides=2, padding=1, **kw))
            self.add_module(f"bn{i + 1}", BatchNorm(ngf * mult * 2, **kw))
        self.proj = TorchConv(ngf * 2**n_downsampling, output_nc, (1, 1), **kw)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = self.policy.cast_to_compute(x)
        x = to_channels_last(F.pad(to_channels_first(x), (3, 3, 3, 3), mode="reflect"))
        x = torch.relu(self.bn0(self.conv0(x), train))
        for i in range(self.n_downsampling):
            x = getattr(self, f"down{i}")(x)
            x = torch.relu(getattr(self, f"bn{i + 1}")(x, train))
        x = x.mean(dim=(1, 2), keepdim=True)  # adaptive average pool to 1x1
        return self.proj(x)
