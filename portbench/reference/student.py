"""The stage-3 Student, the distilled per-avatar generator, in plain float32
``torch``: the reference of the ``student`` system's cells.

  encoder: ResNet18 stem (conv7 stride 2, BN, ReLU, max pool) and stages
           1-2 of ResBlockBN (stride 8, 128 ch) -> conv3 to 192 ->
           ResBlockBN chain 192,192,192,192,96,48,24 at /8
  decoder: SPADEResBlock 24->48->96->192 at /8, nearest x2 up,
           192->192 three times at /4 (six SPADE blocks)
  tail:    nearest x2 + conv3-64 + IN + ReLU (at /2), nearest x2 + conv3-32
           + IN + ReLU (full size), 1x1 conv -> 3, sigmoid

It follows ``johndpope/MegaPortrait-hack`` ``model.py:1464-1645`` (``SPADE``,
``SPADEResBlock``, ``ResBlockBN``, ``Student``) with the port's departures,
which make it run: SPADE's shared conv takes the feature width (the
original's hardcodes 3 input channels, ``model.py:1510``) and its
gamma/beta offset reads the block's own width (``model.py:1529`` reads an
unset attribute); a width change in a ResBlockBN or a SPADEResBlock gets a
1x1 shortcut (the original adds tensors of different widths there). Each
row of a batch takes its own avatar's three embeddings. BatchNorm uses
its running statistics unless ``train`` is set; nothing is fused or folded.

Parameter names and their order are the port's (``models/student.py``),
so that ``portbench/seeded.draw_state`` gives both the same weights. Widths
are ``c // width_div`` floored at 8. It imports nothing of the port, of JAX
or of the JAX package, and computes in float32 with TF32 off
(``dtypes.Policy``); ``dtypes.FP8_CONTROL`` rounds every convolution's
operands through float8 e4m3.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.dtypes import DEFAULT_POLICY, Policy
from portbench.reference.layers import BatchNorm, InstanceNorm, TorchConv
from portbench.reference.resize import upsample_nearest
from portbench.reference.resnet import max_pool_3x3_s2

ENCODER_WIDTHS = (192, 192, 192, 192, 96, 48, 24)
DECODER_WIDTHS = (48, 96, 192, 192, 192, 192)  # dec0-2 at /8, dec3-5 at /4


def _up2(x: torch.Tensor) -> torch.Tensor:
    return upsample_nearest(x, (2, 2), axes=(1, 2))


class Embed(nn.Embedding):
    """An avatar's embedding, looked up in the compute type."""

    def __init__(self, num_embeddings: int, features: int,
                 policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__(num_embeddings, features, device=device,
                         dtype=policy.param_dtype)
        self.policy = policy

    def forward(self, index: torch.Tensor) -> torch.Tensor:
        return super().forward(index.long()).to(self.policy.compute_dtype)


class ResBlockBN(nn.Module):
    """relu(BN(conv3)) twice, plus a shortcut (1x1 conv stride 2 + BN when
    downsampling, 1x1 conv + BN when the width changes, else the input),
    then ReLU once more."""

    def __init__(self, in_channels: int, out_channels: int,
                 downsample: bool = False, policy: Policy = DEFAULT_POLICY,
                 device=None):
        super().__init__()
        kw = dict(policy=policy, device=device)
        stride = 2 if downsample else 1
        self.shortcut_conv = self.shortcut_bn = None
        if downsample or in_channels != out_channels:
            self.shortcut_conv = TorchConv(in_channels, out_channels, (1, 1),
                                           strides=stride, **kw)
            self.shortcut_bn = BatchNorm(out_channels, **kw)
        self.conv1 = TorchConv(in_channels, out_channels, (3, 3), strides=stride,
                               padding=1, **kw)
        self.bn1 = BatchNorm(out_channels, **kw)
        self.conv2 = TorchConv(out_channels, out_channels, (3, 3), padding=1, **kw)
        self.bn2 = BatchNorm(out_channels, **kw)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        shortcut = x
        if self.shortcut_conv is not None:
            shortcut = self.shortcut_bn(self.shortcut_conv(x), train)
        out = torch.relu(self.bn1(self.conv1(x), train))
        out = torch.relu(self.bn2(self.conv2(out), train))
        return torch.relu(out + shortcut)


class SPADE(nn.Module):
    """InstanceNorm; a shared conv (C -> 128) + ReLU plus the avatar's shared
    embedding; gamma and beta convs plus the avatar's gamma and beta
    embeddings; ``normed * (1 + gamma) + beta``."""

    def __init__(self, norm_nc: int, num_avatars: int,
                 policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        kw = dict(policy=policy, device=device)
        self.avatar_shared_emb = Embed(num_avatars, 128, **kw)
        self.avatar_gamma_emb = Embed(num_avatars, norm_nc, **kw)
        self.avatar_beta_emb = Embed(num_avatars, norm_nc, **kw)
        self.norm = InstanceNorm()
        self.conv_shared = TorchConv(norm_nc, 128, (3, 3), padding=1, **kw)
        self.conv_gamma = TorchConv(128, norm_nc, (3, 3), padding=1, **kw)
        self.conv_beta = TorchConv(128, norm_nc, (3, 3), padding=1, **kw)

    def forward(self, x: torch.Tensor, avatar_index: torch.Tensor) -> torch.Tensor:
        normed = self.norm(x)
        shared = torch.relu(self.conv_shared(normed))
        shared = shared + self.avatar_shared_emb(avatar_index)[:, None, None, :]
        gamma = (self.conv_gamma(shared)
                 + self.avatar_gamma_emb(avatar_index)[:, None, None, :])
        beta = (self.conv_beta(shared)
                + self.avatar_beta_emb(avatar_index)[:, None, None, :])
        return normed * (1.0 + gamma) + beta


class SPADEResBlock(nn.Module):
    """Two SPADE -> leaky_relu(0.2) -> conv3 steps through ``min(in, out)``
    channels, plus a bias-free 1x1 shortcut after its own SPADE when the
    width changes."""

    def __init__(self, in_channels: int, out_channels: int, num_avatars: int,
                 policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        kw = dict(policy=policy, device=device)
        middle = min(in_channels, out_channels)
        self.norm_s = self.conv_s = None
        if in_channels != out_channels:
            self.norm_s = SPADE(in_channels, num_avatars, **kw)
            self.conv_s = TorchConv(in_channels, out_channels, (1, 1),
                                    use_bias=False, **kw)
        self.norm_0 = SPADE(in_channels, num_avatars, **kw)
        self.conv_0 = TorchConv(in_channels, middle, (3, 3), padding=1, **kw)
        self.norm_1 = SPADE(middle, num_avatars, **kw)
        self.conv_1 = TorchConv(middle, out_channels, (3, 3), padding=1, **kw)

    def forward(self, x: torch.Tensor, avatar_index: torch.Tensor) -> torch.Tensor:
        x_s = x
        if self.conv_s is not None:
            x_s = self.conv_s(self.norm_s(x, avatar_index))
        dx = self.conv_0(F.leaky_relu(self.norm_0(x, avatar_index), 0.2))
        dx = self.conv_1(F.leaky_relu(self.norm_1(dx, avatar_index), 0.2))
        return x_s + dx


class Student(nn.Module):
    def __init__(self, num_avatars: int, policy: Policy = DEFAULT_POLICY,
                 width_div: int = 1, device=None):
        super().__init__()
        self.policy = policy

        def ch(c):
            return c if width_div <= 1 else max(8, c // width_div)

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

    def encode(self, xd: torch.Tensor, train: bool = False) -> torch.Tensor:
        """xd [B, H, W, 3] -> [B, H/8, W/8, 24] features."""
        x = self.stem_conv(self.policy.cast_to_compute(xd))
        x = max_pool_3x3_s2(torch.relu(self.stem_bn(x, train)))
        for name in ("layer1_0", "layer1_1", "layer2_0", "layer2_1"):
            x = getattr(self, name)(x, train)
        x = self.adapter(x)
        for name in self.enc_names:
            x = getattr(self, name)(x, train)
        return x

    def decode(self, x: torch.Tensor, avatar_index: torch.Tensor) -> torch.Tensor:
        """[B, H/8, W/8, 24] -> [B, H/4, W/4, 192]."""
        for i, name in enumerate(self.dec_names):
            if i == 3:
                x = _up2(x)
            x = getattr(self, name)(x, avatar_index)
        return x

    def tail(self, x: torch.Tensor) -> torch.Tensor:
        """[B, H/4, W/4, 192] -> [B, H, W, 3] in [0, 1], float32."""
        x = torch.relu(self.norm(self.tail_conv0(_up2(x))))
        x = torch.relu(self.norm(self.tail_conv1(_up2(x))))
        return torch.sigmoid(self.final_conv(x).float())

    def forward(self, xd: torch.Tensor, avatar_index: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        """xd [B, H, W, 3], avatar_index [B] integers -> [B, H, W, 3]."""
        return self.tail(self.decode(self.encode(xd, train), avatar_index))
