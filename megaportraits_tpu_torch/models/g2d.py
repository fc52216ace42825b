"""G2d — 2D synthesis network (counterpart of ``megaportraits_tpu/models/g2d.py``).

Projected volume [B, H/8, W/8, 96] -> 1x1 conv 96->1536 -> 1x1 1536->512 ->
8x ResBlock2D-512 (the trunk) -> 3x (bilinear up x2, align_corners=True, +
ResBlock2D 512->256->128->64) -> GN+ReLU+3x3 conv-3 -> sigmoid in float32
-> [B, H, W, 3].

With ``use_chain_kernel`` the trunk runs through kernel K2
(``ops/kernels/resblock_chain.py``) under the JAX conditions: not training,
norm 'batch', H % 8 == 0 and W % 8 == 0; BatchNorm folded into per-conv
scale/shift; one call per sample. K2 takes bf16 operands, so on the card
a G2d that computes in float32 hands it the trunk's input and weights in
bf16 and takes its result back in float32 (its plain version on the CPU
runs in the compute dtype, as JAX's kernel does). The folded, stacked
operands are kept between calls (``cached_trunk_chain_params``) and folded
again only after a weight or a BatchNorm statistic of the trunk changed.
"""

from __future__ import annotations

import torch
from torch import nn

from megaportraits_tpu_torch.core.arch import FULL, Arch
from megaportraits_tpu_torch.core.dtypes import DEFAULT_POLICY, Policy
from megaportraits_tpu_torch.nn.blocks import OperandCache, ResBlock2D
from megaportraits_tpu_torch.nn.layers import GroupNorm32, TorchConv
from megaportraits_tpu_torch.ops.resize import linear_resize
from megaportraits_tpu_torch.utils.profiling import annotate


def _up2(x: torch.Tensor) -> torch.Tensor:
    sizes = [s * 2 for s in x.shape[1:3]]
    return linear_resize(x, sizes, axes=(1, 2), align_corners=True)


class G2d(nn.Module):
    def __init__(self, policy: Policy = DEFAULT_POLICY, arch: Arch = FULL,
                 use_chain_kernel: bool = False, device=None):
        super().__init__()
        a = arch
        self.policy = policy
        self.arch = arch
        self.use_chain_kernel = use_chain_kernel
        kw = dict(policy=policy, device=device)
        bkw = dict(kw, norm=a.norm)
        self.reshape_conv = TorchConv(a.volume_channels, a.ch(1536), (1, 1), **kw)
        self.conv1x1 = TorchConv(a.ch(1536), a.ch(512), (1, 1), **kw)
        self.trunk_names = [f"res{i}" for i in range(a.g2d_blocks)]
        for name in self.trunk_names:
            self.add_module(name, ResBlock2D(a.ch(512), a.ch(512), **bkw))
        self.up1 = ResBlock2D(a.ch(512), a.ch(256), **bkw)
        self.up2 = ResBlock2D(a.ch(256), a.ch(128), **bkw)
        self.up3 = ResBlock2D(a.ch(128), a.ch(64), **bkw)
        self.norm = GroupNorm32()
        self.final_conv = TorchConv(a.ch(64), 3, (3, 3), padding=1, **kw)
        self.trunk_cache = OperandCache()

    def trunk_chain_params(self, dtype=None):
        """Stacked K2 parameters: weights [N,2,3,3,C,C] in `dtype` (the
        compute dtype by default), BN-folded scales and shifts [N,2,C] in
        float32."""
        ws, scs, shs = [], [], []
        for name in self.trunk_names:
            k1, k2, s1, t1, s2, t2 = getattr(self, name).chain_params()
            ws.append(torch.stack([k1, k2]))
            scs.append(torch.stack([s1, s2]))
            shs.append(torch.stack([t1, t2]))
        return (torch.stack(ws).to(dtype or self.policy.compute_dtype),
                torch.stack(scs), torch.stack(shs))

    def cached_trunk_chain_params(self, dtype=None):
        """``trunk_chain_params(dtype)``, folded again only after a conv
        weight or bias, a BatchNorm weight or bias or a running statistic of
        the trunk changed, or `dtype` did; ``trunk_cache.folds`` counts the
        folds."""
        dtype = dtype or self.policy.compute_dtype
        sources = [t for name in self.trunk_names
                   for t in getattr(self, name).chain_sources()]
        return self.trunk_cache.get(sources, lambda: self.trunk_chain_params(dtype),
                                    dtype)

    def trunk(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """The ResBlock2D trunk on the 1x1 head's output [B, h, w, C]."""
        chain_ok = (self.use_chain_kernel and not train
                    and self.arch.norm == "batch"
                    and x.shape[1] % 8 == 0 and x.shape[2] % 8 == 0)
        if chain_ok:
            from megaportraits_tpu_torch.ops.kernels.resblock_chain import (
                resblock_chain,
            )

            kdt = torch.bfloat16 if x.device.type == "cuda" else self.policy.compute_dtype
            weights, scales, shifts = self.cached_trunk_chain_params(kdt)
            return torch.stack([
                resblock_chain(xi.contiguous(), weights, scales, shifts)
                for xi in x.to(kdt)
            ]).to(x.dtype)
        for name in self.trunk_names:
            x = getattr(self, name)(x, train)
        return x

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """The 1x1 head, the trunk and the decoder, each a span."""
        with annotate("g2d.head"):
            x = self.conv1x1(self.reshape_conv(x))
        with annotate("g2d.trunk"):
            x = self.trunk(x, train)
        with annotate("g2d.decoder"):
            x = self.up1(_up2(x), train)
            x = self.up2(_up2(x), train)
            x = self.up3(_up2(x), train)
            x = self.final_conv(torch.relu(self.norm(x)))
            return torch.sigmoid(x.float())
