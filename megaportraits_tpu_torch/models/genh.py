"""Genh — the 512->1024 high-resolution enhancer, and GHR, Gbase composed
with it (counterpart of ``megaportraits_tpu/models/genh.py``).

Genh: conv7 -> 64, four encoder ResBlock2D-64 with three 2x2 average
pools, ``n_mid`` ResBlock2D-64 (8 at the reference width, ``g2d_blocks``
when narrowed), three (bilinear x2 with ``align_corners=True`` +
ResBlock2D-64), conv7 -> 3 and tanh in float32. Its blocks run plain: at
64 channels no kernel applies, and the JAX package never asks for one.

GHR feeds Gbase's image, not its (image, pyramids) tuple, into Genh.
``build_genh`` and ``build_ghr`` are the factories; they run on the card
unless asked otherwise.
"""

from __future__ import annotations

from typing import Union

import torch
from torch import nn

from megaportraits_tpu_torch.core.arch import FULL, Arch, get_arch
from megaportraits_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device
from megaportraits_tpu_torch.core.dtypes import DEFAULT_POLICY, Policy
from megaportraits_tpu_torch.models.g2d import _up2
from megaportraits_tpu_torch.models.gbase import Gbase
from megaportraits_tpu_torch.nn.blocks import ResBlock2D
from megaportraits_tpu_torch.nn.layers import TorchConv, init_parameters
from megaportraits_tpu_torch.ops.resize import avg_pool_2d
from megaportraits_tpu_torch.utils.profiling import annotate


class Genh(nn.Module):
    def __init__(self, policy: Policy = DEFAULT_POLICY, arch: Arch = FULL,
                 device=None):
        super().__init__()
        self.policy = policy
        c = arch.ch(64)
        n_mid = 8 if arch.width_div <= 1 else arch.g2d_blocks
        kw = dict(policy=policy, device=device)

        def block():
            return ResBlock2D(c, c, norm=arch.norm, **kw)

        self.enc_conv = TorchConv(3, c, (7, 7), padding=3, **kw)
        self.enc_names = [f"enc_res{i}" for i in range(4)]
        self.mid_names = [f"mid_res{i}" for i in range(n_mid)]
        self.dec_names = [f"dec_res{i}" for i in range(3)]
        for name in self.enc_names + self.mid_names + self.dec_names:
            self.add_module(name, block())
        self.dec_conv = TorchConv(c, 3, (7, 7), padding=3, **kw)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """x [B, H, W, 3] -> [B, H, W, 3] in [-1, 1]; H and W divisible by 8.
        One span, ``genh.forward``."""
        with annotate("genh.forward"):
            x = self.enc_conv(self.policy.cast_to_compute(x))
            for i, name in enumerate(self.enc_names):
                if i > 0:
                    x = avg_pool_2d(x)
                x = getattr(self, name)(x, train)
            for name in self.mid_names:
                x = getattr(self, name)(x, train)
            for name in self.dec_names:
                x = getattr(self, name)(_up2(x), train)
            x = self.dec_conv(x)
            return torch.tanh(x.float())


class GHR(nn.Module):
    """Gbase + Genh: ``genh(gbase(xs, xd)[0])``."""

    def __init__(self, policy: Policy = DEFAULT_POLICY,
                 warp_normalize_mode: str = "reference", arch: Arch = FULL,
                 device=None):
        super().__init__()
        self.gbase = Gbase(policy=policy, warp_normalize_mode=warp_normalize_mode,
                           arch=arch, device=device)
        self.genh = Genh(policy=policy, arch=arch, device=device)

    def forward(self, xs: torch.Tensor, xd: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        return self.genh(self.gbase.generate(xs, xd, train), train)


def build_genh(arch: Union[str, Arch] = "full", policy: Policy = DEFAULT_POLICY,
               device: Union[str, torch.device] = DEFAULT_DEVICE,
               seed: int = 0) -> Genh:
    """Genh with seeded random weights on `device` (the card by default)."""
    model = Genh(policy=policy, arch=get_arch(arch), device=resolve_device(device))
    return init_parameters(model, seed)


def build_ghr(arch: Union[str, Arch] = "full", policy: Policy = DEFAULT_POLICY,
              device: Union[str, torch.device] = DEFAULT_DEVICE, seed: int = 0,
              use_chain_kernel: bool = False, **kwargs) -> GHR:
    """GHR with seeded random weights on `device` (the card by default). Its
    Gbase draws first, so it gets the weights of ``build_gbase`` with the
    same seed; `use_chain_kernel` puts its G2d trunk on K2 (``Config``'s
    ``model.use_chain_kernel``)."""
    model = GHR(policy=policy, arch=get_arch(arch), device=resolve_device(device),
                **kwargs)
    model.gbase.g2d.use_chain_kernel = use_chain_kernel
    return init_parameters(model, seed)
