"""InceptionResnetV1 ('vggface2'), the face-identity network (counterpart of
``megaportraits_tpu/losses/vggface.py``).

facenet_pytorch's network over NHWC: the 'vggface' term of PerceptualLoss
takes the L1 of its children-[4, 5, 6, 7] taps (conv2d_3b, conv2d_4a,
conv2d_4b, repeat_1), and the AED metric its L2-normalised 512-d embedding.
Module names are the JAX package's (``repeat_1_0.branch1_0``); facenet's
own (``repeat_1.0.branch1.0``) are renamed onto them by
``utils/convert_weights.py``. BatchNorm is frozen with facenet's eps 1e-3.
Max pools are VALID (3x3, stride 2, no padding).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from megaportraits_tpu_torch.core.dtypes import DEFAULT_POLICY, Policy
from megaportraits_tpu_torch.nn.layers import (
    FrozenBN,
    TorchConv,
    TorchDense,
    to_channels_first,
    to_channels_last,
)

BN_EPS = 1e-3
EMBEDDING_SIZE = 512


def max_pool_3x3_s2_valid(x: torch.Tensor) -> torch.Tensor:
    """3x3 max pool, stride 2, VALID, over NHWC."""
    return to_channels_last(F.max_pool2d(to_channels_first(x), 3, 2))


class BasicConv2d(nn.Module):
    """Bias-free conv, frozen BatchNorm (eps 1e-3), ReLU."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Tuple[int, int], stride: int = 1,
                 padding: Tuple[int, int] = (0, 0),
                 policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        self.conv = TorchConv(in_channels, out_channels, kernel_size, strides=stride,
                              padding=tuple(padding), use_bias=False, policy=policy,
                              device=device)
        self.bn = FrozenBN(out_channels, eps=BN_EPS, policy=policy, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(self.conv(x)))


class _Branches(nn.Module):
    """Branches of BasicConv2d chains concatenated on channels, then (for
    the residual blocks) a 1x1 ``conv2d`` with bias back to the input
    width, scaled and added to the input."""

    def __init__(self, in_channels: int,
                 branches: Sequence[Sequence[Tuple[str, int, tuple, int, tuple]]],
                 pool: bool = False, residual: bool = False, scale: float = 1.0,
                 no_relu: bool = False, policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        kw = dict(policy=policy, device=device)
        self.chains: List[List[str]] = []
        width = 0
        for chain in branches:
            names, c = [], in_channels
            for name, out, kernel, stride, padding in chain:
                self.add_module(name, BasicConv2d(c, out, kernel, stride, padding, **kw))
                names.append(name)
                c = out
            self.chains.append(names)
            width += c
        self.pool = pool
        if pool:
            width += in_channels
        self.residual, self.scale, self.no_relu = residual, scale, no_relu
        if residual:
            self.conv2d = TorchConv(width, in_channels, (1, 1), **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = []
        for names in self.chains:
            h = x
            for name in names:
                h = getattr(self, name)(h)
            outs.append(h)
        if self.pool:
            outs.append(max_pool_3x3_s2_valid(x))
        up = torch.cat(outs, dim=-1)
        if not self.residual:
            return up
        out = x + self.scale * self.conv2d(up)
        return out if self.no_relu else torch.relu(out)


def Block35(scale: float = 0.17, policy: Policy = DEFAULT_POLICY, device=None):
    return _Branches(256, [
        [("branch0", 32, (1, 1), 1, (0, 0))],
        [("branch1_0", 32, (1, 1), 1, (0, 0)), ("branch1_1", 32, (3, 3), 1, (1, 1))],
        [("branch2_0", 32, (1, 1), 1, (0, 0)), ("branch2_1", 32, (3, 3), 1, (1, 1)),
         ("branch2_2", 32, (3, 3), 1, (1, 1))],
    ], residual=True, scale=scale, policy=policy, device=device)


def Block17(scale: float = 0.10, policy: Policy = DEFAULT_POLICY, device=None):
    return _Branches(896, [
        [("branch0", 128, (1, 1), 1, (0, 0))],
        [("branch1_0", 128, (1, 1), 1, (0, 0)), ("branch1_1", 128, (1, 7), 1, (0, 3)),
         ("branch1_2", 128, (7, 1), 1, (3, 0))],
    ], residual=True, scale=scale, policy=policy, device=device)


def Block8(scale: float = 0.20, no_relu: bool = False,
           policy: Policy = DEFAULT_POLICY, device=None):
    return _Branches(1792, [
        [("branch0", 192, (1, 1), 1, (0, 0))],
        [("branch1_0", 192, (1, 1), 1, (0, 0)), ("branch1_1", 192, (1, 3), 1, (0, 1)),
         ("branch1_2", 192, (3, 1), 1, (1, 0))],
    ], residual=True, scale=scale, no_relu=no_relu, policy=policy, device=device)


def Mixed6a(policy: Policy = DEFAULT_POLICY, device=None):
    return _Branches(256, [
        [("branch0", 384, (3, 3), 2, (0, 0))],
        [("branch1_0", 192, (1, 1), 1, (0, 0)), ("branch1_1", 192, (3, 3), 1, (1, 1)),
         ("branch1_2", 256, (3, 3), 2, (0, 0))],
    ], pool=True, policy=policy, device=device)


def Mixed7a(policy: Policy = DEFAULT_POLICY, device=None):
    return _Branches(896, [
        [("branch0_0", 256, (1, 1), 1, (0, 0)), ("branch0_1", 384, (3, 3), 2, (0, 0))],
        [("branch1_0", 256, (1, 1), 1, (0, 0)), ("branch1_1", 256, (3, 3), 2, (0, 0))],
        [("branch2_0", 256, (1, 1), 1, (0, 0)), ("branch2_1", 256, (3, 3), 1, (1, 1)),
         ("branch2_2", 256, (3, 3), 2, (0, 0))],
    ], pool=True, policy=policy, device=device)


class InceptionResnetV1(nn.Module):
    """facenet's trunk. ``forward(x, return_taps=False)`` returns the
    L2-normalised [B, 512] float32 embedding, and with `return_taps` also
    the children-[4, 5, 6, 7] activations."""

    def __init__(self, policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        kw = dict(policy=policy, device=device)
        self.conv2d_1a = BasicConv2d(3, 32, (3, 3), stride=2, **kw)
        self.conv2d_2a = BasicConv2d(32, 32, (3, 3), **kw)
        self.conv2d_2b = BasicConv2d(32, 64, (3, 3), padding=(1, 1), **kw)
        self.conv2d_3b = BasicConv2d(64, 80, (1, 1), **kw)
        self.conv2d_4a = BasicConv2d(80, 192, (3, 3), **kw)
        self.conv2d_4b = BasicConv2d(192, 256, (3, 3), stride=2, **kw)
        for i in range(5):
            self.add_module(f"repeat_1_{i}", Block35(**kw))
        self.mixed_6a = Mixed6a(**kw)
        for i in range(10):
            self.add_module(f"repeat_2_{i}", Block17(**kw))
        self.mixed_7a = Mixed7a(**kw)
        for i in range(5):
            self.add_module(f"repeat_3_{i}", Block8(**kw))
        # facenet's last Block8: no ReLU, and its default scale 1.0.
        self.block8 = Block8(scale=1.0, no_relu=True, **kw)
        self.last_linear = TorchDense(1792, EMBEDDING_SIZE, use_bias=False, **kw)
        self.last_bn = FrozenBN(EMBEDDING_SIZE, eps=BN_EPS, **kw)

    def forward(self, x: torch.Tensor, return_taps: bool = False):
        taps = []
        x = self.conv2d_2b(self.conv2d_2a(self.conv2d_1a(x)))
        x = self.conv2d_3b(max_pool_3x3_s2_valid(x))
        taps.append(x)
        x = self.conv2d_4a(x)
        taps.append(x)
        x = self.conv2d_4b(x)
        taps.append(x)
        for i in range(5):
            x = getattr(self, f"repeat_1_{i}")(x)
        taps.append(x)
        x = self.mixed_6a(x)
        for i in range(10):
            x = getattr(self, f"repeat_2_{i}")(x)
        x = self.mixed_7a(x)
        for i in range(5):
            x = getattr(self, f"repeat_3_{i}")(x)
        x = self.block8(x)
        x = self.last_bn(self.last_linear(x.mean(dim=(1, 2))).float())
        emb = x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)
        return (emb, taps) if return_taps else emb
