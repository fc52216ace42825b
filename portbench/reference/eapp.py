"""Eapp — appearance encoder (counterpart of ``megaportraits_tpu/models/eapp.py``).

Image [B,H,W,3] ->
  * volume vs [B,16,H/8,W/8,96] (NDHWC): 7x7 conv-64, ResBlock_Custom
    128/256/512 with avg-pools between, GN+ReLU+1x1 conv-1536, split
    1536 -> (C96, D16) with depth minor, then rounds of 2x
    ResBlock3D_Adaptive-96;
  * descriptor es [B,512]: CustomResNet50 [B,2,2,512] flattened in
    (h, w, c) order -> Linear(2048, 512).
"""

from __future__ import annotations

import torch
from torch import nn

from portbench.reference.arch import FULL, Arch
from portbench.reference.dtypes import DEFAULT_POLICY, Policy
from portbench.reference.resnet import CustomResNet50
from portbench.reference.blocks import ResBlock3DAdaptive, ResBlockCustom
from portbench.reference.layers import GroupNorm32, TorchConv, TorchDense
from portbench.reference.resize import avg_pool_2d


class Eapp(nn.Module):
    def __init__(self, policy: Policy = DEFAULT_POLICY, arch: Arch = FULL,
                 device=None):
        super().__init__()
        a = arch
        self.policy = policy
        self.arch = arch
        kw = dict(policy=policy, device=device)
        self.conv = TorchConv(3, a.ch(64), (7, 7), padding=3, **kw)
        self.resblock_128 = ResBlockCustom(2, a.ch(64), a.ch(128), **kw)
        self.resblock_256 = ResBlockCustom(2, a.ch(128), a.ch(256), **kw)
        self.resblock_512 = ResBlockCustom(2, a.ch(256), a.ch(512), **kw)
        self.norm = GroupNorm32()
        vol_c, vol_d = a.volume_channels, a.volume_depth
        self.conv_1 = TorchConv(a.ch(512), vol_c * vol_d, (1, 1), **kw)
        self.round_names = []
        for rnd in range(a.eapp_rounds3d):
            for tag in ("a", "b"):
                name = f"resblock3D_96_r{rnd}_{tag}"
                self.add_module(name, ResBlock3DAdaptive(vol_c, vol_c, **kw))
                self.round_names.append(name)
        self.custom_resnet50 = CustomResNet50(policy=policy, arch=arch,
                                              device=device)
        self.fc = TorchDense(4 * a.ch(512), a.compress_dim, **kw)

    def forward(self, x: torch.Tensor, train: bool = False):
        x = self.policy.cast_to_compute(x)
        out = self.resblock_128(self.conv(x))
        out = self.resblock_256(avg_pool_2d(out))
        out = self.resblock_512(avg_pool_2d(out))
        out = avg_pool_2d(out)
        out = self.conv_1(torch.relu(self.norm(out)))
        # 1536 -> (C96, D16) with depth minor, then NDHWC [B, 16, H, W, 96].
        b, h, w, _ = out.shape
        vs = out.reshape(b, h, w, self.arch.volume_channels, self.arch.volume_depth)
        vs = vs.permute(0, 4, 1, 2, 3).contiguous()
        for name in self.round_names:
            vs = getattr(self, name)(vs)
        es = self.custom_resnet50(x, train).reshape(b, -1)  # (h, w, c) order
        return vs, self.fc(es)
