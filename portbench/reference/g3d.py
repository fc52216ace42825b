"""G3d — 3D U-Net over the canonical volume (counterpart of
``megaportraits_tpu/models/g3d.py``).

Down: ResBlock3D 96 -> avgpool -> 192 -> avgpool -> 384 -> avgpool -> 768.
Up:   768 -> 384 -> up x2 -> 192 -> up -> 96 -> up, then a 3x3x3 conv-96.
Trilinear upsamples use align_corners=True. [B,16,64,64,96] NDHWC in/out.
"""

from __future__ import annotations

import torch
from torch import nn

from portbench.reference.arch import FULL, Arch
from portbench.reference.dtypes import DEFAULT_POLICY, Policy
from portbench.reference.blocks import ResBlock3D
from portbench.reference.layers import TorchConv
from portbench.reference.resize import avg_pool_3d, linear_resize


def _up2(x: torch.Tensor) -> torch.Tensor:
    sizes = [s * 2 for s in x.shape[1:4]]
    return linear_resize(x, sizes, axes=(1, 2, 3), align_corners=True)


class G3d(nn.Module):
    def __init__(self, policy: Policy = DEFAULT_POLICY, arch: Arch = FULL,
                 device=None):
        super().__init__()
        a = arch
        kw = dict(policy=policy, device=device)
        self.stages = a.g3d_stages
        chans = [a.ch(a.volume_channels * 2 ** i) if a.width_div > 1
                 else a.volume_channels * 2 ** i
                 for i in range(self.stages + 1)]
        self.down1 = ResBlock3D(a.volume_channels, chans[0], **kw)
        for i in range(1, self.stages + 1):
            self.add_module(f"down{i + 1}", ResBlock3D(chans[i - 1], chans[i], **kw))
        cin = chans[-1]
        for j, i in enumerate(range(self.stages - 1, -1, -1)):
            self.add_module(f"up{j + 1}", ResBlock3D(cin, chans[i], **kw))
            cin = chans[i]
        self.final_conv = TorchConv(cin, a.volume_channels, (3, 3, 3), padding=1,
                                    **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.down1(x)
        for i in range(1, self.stages + 1):
            x = getattr(self, f"down{i + 1}")(avg_pool_3d(x))
        for j in range(self.stages):
            x = _up2(getattr(self, f"up{j + 1}")(x))
        return self.final_conv(x)
