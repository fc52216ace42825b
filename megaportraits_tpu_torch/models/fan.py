"""FAN (Face Alignment Network, 2DFAN-N): 68-point facial landmarks
(counterpart of ``megaportraits_tpu/models/fan.py``).

The stacked-hourglass network of Bulat & Tzimiropoulos (ICCV'17) in the
layout of face_alignment's 2DFAN-4 checkpoint, whose module names it keeps
(``conv1``, ``m{i}.b1_4``, ``top_m_{i}``, ``l{i}``, ``bl{i}``, ``al{i}``...),
so that ``utils/convert_weights.py`` renames that ``.pth`` onto it.

Inference only: BatchNorm uses its stored statistics (``FrozenBN``). Input
[B, 256, 256, 3] RGB in [0, 1], output the last stack's heatmaps [B, 64, 64,
68] in float32; ``heatmaps_to_landmarks`` decodes them.
"""

from __future__ import annotations

import torch
from torch import nn

from megaportraits_tpu_torch.core.dtypes import DEFAULT_POLICY, Policy
from megaportraits_tpu_torch.nn.layers import FrozenBN, TorchConv
from megaportraits_tpu_torch.ops.resize import avg_pool_2d, upsample_nearest

HEATMAP_SIZE = 64
NUM_LANDMARKS = 68


class ConvBlock(nn.Module):
    """Three bn-relu-conv stages at out/2, out/4, out/4 channels,
    concatenated; a bn-relu-1x1 conv shortcut when the width changes."""

    def __init__(self, in_planes: int, out_planes: int,
                 policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        kw = dict(policy=policy, device=device)
        o = out_planes
        self.bn1 = FrozenBN(in_planes, **kw)
        self.conv1 = TorchConv(in_planes, o // 2, (3, 3), padding=1, use_bias=False, **kw)
        self.bn2 = FrozenBN(o // 2, **kw)
        self.conv2 = TorchConv(o // 2, o // 4, (3, 3), padding=1, use_bias=False, **kw)
        self.bn3 = FrozenBN(o // 4, **kw)
        self.conv3 = TorchConv(o // 4, o // 4, (3, 3), padding=1, use_bias=False, **kw)
        self.has_down = in_planes != o
        if self.has_down:
            self.down_bn = FrozenBN(in_planes, **kw)
            self.down_conv = TorchConv(in_planes, o, (1, 1), use_bias=False, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h1 = self.conv1(torch.relu(self.bn1(x)))
        h2 = self.conv2(torch.relu(self.bn2(h1)))
        h3 = self.conv3(torch.relu(self.bn3(h2)))
        out = torch.cat([h1, h2, h3], dim=-1)
        res = self.down_conv(torch.relu(self.down_bn(x))) if self.has_down else x
        return out + res


class HourGlass(nn.Module):
    """Recursive hourglass over `features` channels; level n holds b1_n,
    b2_n and b3_n, and the innermost level b2_plus_1."""

    def __init__(self, depth: int = 4, features: int = 256,
                 policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        self.depth = depth
        for n in range(depth, 0, -1):
            for name in (f"b1_{n}", f"b2_{n}", f"b3_{n}"):
                self.add_module(name, ConvBlock(features, features, policy, device))
        self.b2_plus_1 = ConvBlock(features, features, policy, device)

    def _level(self, n: int, x: torch.Tensor) -> torch.Tensor:
        up1 = getattr(self, f"b1_{n}")(x)
        low = getattr(self, f"b2_{n}")(avg_pool_2d(x))
        low = self._level(n - 1, low) if n > 1 else self.b2_plus_1(low)
        low = getattr(self, f"b3_{n}")(low)
        return up1 + upsample_nearest(low, (2, 2), axes=(1, 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._level(self.depth, x)


class FAN(nn.Module):
    """2DFAN-N: a stem to 64x64x256, then `num_modules` stacked hourglasses
    with intermediate supervision; returns the last stack's heatmaps."""

    def __init__(self, num_modules: int = 4, policy: Policy = DEFAULT_POLICY,
                 device=None):
        super().__init__()
        self.num_modules = num_modules
        self.policy = policy
        kw = dict(policy=policy, device=device)
        self.conv1 = TorchConv(3, 64, (7, 7), strides=2, padding=3, **kw)
        self.bn1 = FrozenBN(64, **kw)
        self.conv2 = ConvBlock(64, 128, **kw)
        self.conv3 = ConvBlock(128, 128, **kw)
        self.conv4 = ConvBlock(128, 256, **kw)
        for i in range(num_modules):
            self.add_module(f"m{i}", HourGlass(4, 256, **kw))
            self.add_module(f"top_m_{i}", ConvBlock(256, 256, **kw))
            self.add_module(f"conv_last{i}", TorchConv(256, 256, (1, 1), **kw))
            self.add_module(f"bn_end{i}", FrozenBN(256, **kw))
            self.add_module(f"l{i}", TorchConv(256, NUM_LANDMARKS, (1, 1), **kw))
            if i < num_modules - 1:
                self.add_module(f"bl{i}", TorchConv(256, 256, (1, 1), **kw))
                self.add_module(f"al{i}", TorchConv(NUM_LANDMARKS, 256, (1, 1), **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.policy.cast_to_compute(x)
        x = torch.relu(self.bn1(self.conv1(x)))
        x = avg_pool_2d(self.conv2(x))
        x = self.conv4(self.conv3(x))
        previous, out = x, None
        for i in range(self.num_modules):
            ll = getattr(self, f"top_m_{i}")(getattr(self, f"m{i}")(previous))
            ll = torch.relu(getattr(self, f"bn_end{i}")(getattr(self, f"conv_last{i}")(ll)))
            out = getattr(self, f"l{i}")(ll)
            if i < self.num_modules - 1:
                previous = (previous + getattr(self, f"bl{i}")(ll)
                            + getattr(self, f"al{i}")(out))
        return out.float()


def heatmaps_to_landmarks(heatmaps: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 68] -> [B, 68, 2] (x, y) in heatmap pixels: the argmax
    (the first of equal maxima), moved a quarter pixel toward the stronger
    neighbour on each axis (the sign of the difference of the two
    neighbours, indices clipped at the border)."""
    b, h, w, c = heatmaps.shape
    flat = heatmaps.reshape(b, h * w, c)
    idx = torch.argmax(flat, dim=1)  # [B, 68]
    row, col = idx // w, idx % w

    def gather_at(dy: int, dx: int) -> torch.Tensor:
        yy = torch.clamp(row + dy, 0, h - 1)
        xx = torch.clamp(col + dx, 0, w - 1)
        return torch.gather(flat, 1, (yy * w + xx)[:, None, :])[:, 0, :]

    dx = gather_at(0, 1) - gather_at(0, -1)
    dy = gather_at(1, 0) - gather_at(-1, 0)
    xs = col.float() + 0.25 * torch.sign(dx)
    ys = row.float() + 0.25 * torch.sign(dy)
    return torch.stack([xs, ys], dim=-1)
