"""Residual building blocks (counterpart of ``megaportraits_tpu/nn/blocks.py``).

Channels-last in and out, like the JAX blocks. Parameter names follow the
JAX module names so that ``utils/jax_bridge.py`` maps them one to one.

The Student's blocks (``ResBlockBN``, ``SPADE``, ``SPADEResBlock``) carry
the JAX package's fixes of the reference: SPADE's shared conv takes the
feature width, and a width change gets a 1x1 shortcut.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from megaportraits_tpu_torch.core.dtypes import DEFAULT_POLICY, Policy
from megaportraits_tpu_torch.nn.layers import (
    AdaptiveGroupNorm,
    AffineGroupNorm,
    BatchNorm,
    Embed,
    GroupNorm32,
    InstanceNorm,
    TorchConv,
    WSConv,
)


class ResBlockCustom(nn.Module):
    """Reference ResBlock_Custom, 2D or 3D by `dims`.

    residual = conv3(x); main = conv3(relu(GN32(conv3_ws(relu(GN32(x))))));
    out = main + residual.
    """

    def __init__(self, dims: int, in_channels: int, out_channels: int,
                 policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        k = (3,) * dims
        self.conv_res = TorchConv(in_channels, out_channels, k, padding=1,
                                  policy=policy, device=device)
        self.norm_in = GroupNorm32()
        self.conv_ws = WSConv(in_channels, out_channels, k, padding=1,
                              policy=policy, device=device)
        self.norm_mid = GroupNorm32()
        self.conv = TorchConv(out_channels, out_channels, k, padding=1,
                              policy=policy, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out2 = self.conv_res(x)
        out1 = torch.relu(self.norm_in(x))
        out1 = torch.relu(self.norm_mid(self.conv_ws(out1)))
        return self.conv(out1) + out2


class ResBlock2DAdaptive(nn.Module):
    """Reference ResBlock2D_Adaptive (NHWC): conv-AGN-relu-conv-AGN, 1x1
    residual conv when the width changes, relu. (The JAX block's optional
    upsample is unused by every caller and not ported.)"""

    dims = 2

    def __init__(self, in_channels: int, out_channels: int,
                 policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        k = (3,) * self.dims
        self.conv1 = TorchConv(in_channels, out_channels, k, padding=1,
                               policy=policy, device=device)
        self.norm1 = AdaptiveGroupNorm(out_channels, policy=policy, device=device)
        self.conv2 = TorchConv(out_channels, out_channels, k, padding=1,
                               policy=policy, device=device)
        self.norm2 = AdaptiveGroupNorm(out_channels, policy=policy, device=device)
        self.residual_conv = (
            TorchConv(in_channels, out_channels, (1,) * self.dims,
                      policy=policy, device=device)
            if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.norm1(self.conv1(x)))
        out = self.norm2(self.conv2(out))
        residual = x if self.residual_conv is None else self.residual_conv(x)
        return torch.relu(out + residual)


class ResBlock3DAdaptive(ResBlock2DAdaptive):
    """Reference ResBlock3D_Adaptive: the same block over NDHWC."""

    dims = 3


class ResBlock3D(nn.Module):
    """Reference ResBlock3D: GN(affine)+ReLU, 1x1x1 shortcut (NDHWC). (The
    JAX block's optional upsample is unused by every caller and not ported.)"""

    def __init__(self, in_channels: int, out_channels: int,
                 policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        self.shortcut = (
            TorchConv(in_channels, out_channels, (1, 1, 1), policy=policy,
                      device=device)
            if in_channels != out_channels else None)
        self.conv1 = TorchConv(in_channels, out_channels, (3, 3, 3), padding=1,
                               policy=policy, device=device)
        self.gn1 = AffineGroupNorm(out_channels, policy=policy, device=device)
        self.conv2 = TorchConv(out_channels, out_channels, (3, 3, 3), padding=1,
                               policy=policy, device=device)
        self.gn2 = AffineGroupNorm(out_channels, policy=policy, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.shortcut is None else self.shortcut(x)
        out = torch.relu(self.gn1(self.conv1(x)))
        out = self.gn2(self.conv2(out))
        return torch.relu(out + identity)


def conv_weight_hwio(conv: TorchConv, dtype: torch.dtype) -> torch.Tensor:
    """OIHW conv weight -> contiguous HWIO in `dtype` (the kernels' layout)."""
    return conv.weight.permute(2, 3, 1, 0).contiguous().to(dtype)


class OperandCache:
    """Kernel operands computed from a module's tensors, kept until one of
    those tensors changes.

    ``get(sources, build, extra)`` returns ``build()``'s last result while
    every tensor of ``sources`` still has the ``data_ptr``, ``_version``,
    device and dtype it had then (and `extra` is unchanged), else builds
    anew, without autograd. ``load_state_dict``, a BatchNorm calibration and
    an optimiser step write in place and move ``_version``; ``.to()`` and an
    assignment to ``.data`` move ``data_ptr``. ``folds`` counts the builds,
    ``OperandCache.all_folds`` those of every cache.
    """

    all_folds = 0

    def __init__(self):
        self.folds = 0
        self._key = None
        self._value = None

    def get(self, sources, build, extra=()):
        key = (extra, tuple((t.data_ptr(), t._version, t.device, t.dtype)
                            for t in sources))
        if key != self._key:
            with torch.no_grad():
                self._value = build()
            self._key = key
            self.folds += 1
            OperandCache.all_folds += 1
        return self._value


class ResBlock2D(nn.Module):
    """Reference ResBlock2D: conv3-norm-ReLU-conv3-norm (+ a 1x1 conv + norm
    shortcut when the width changes) -> ReLU. The JAX block's ``downsample``
    option is unused and broken there (it strides only the shortcut), so it
    is not ported.

    ``norm='batch'`` (the reference) uses BatchNorm (``bn1``, ``bn2``,
    ``shortcut_bn``); ``norm='group'`` uses AffineGroupNorm(32) (``gn1``,
    ``gn2``, ``shortcut_gn``), which has no batch statistics, so ``train``
    changes nothing there.

    With ``use_pallas`` (the JAX switch's name) eligible blocks run in eval
    mode as two launches of kernel K1 (``ops/kernels/conv3x3.py``), BN
    folded into the epilogue: conv1+BN1+ReLU, then conv2+BN2+residual+ReLU.
    Eligibility is the JAX predicate without its TPU-only VMEM bound.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 policy: Policy = DEFAULT_POLICY, use_pallas: bool = False,
                 norm: str = "batch", device=None):
        super().__init__()
        if norm not in ("batch", "group"):
            raise ValueError(f"unknown norm {norm!r}; expected 'batch' or 'group'")
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.policy = policy
        self.use_pallas = use_pallas
        self.norm = norm
        f = out_channels
        norm_cls, prefix = ((BatchNorm, "bn") if norm == "batch"
                            else (AffineGroupNorm, "gn"))
        self.conv1 = TorchConv(in_channels, f, (3, 3), padding=1, policy=policy,
                               device=device)
        self.add_module(f"{prefix}1", norm_cls(f, policy=policy, device=device))
        self.conv2 = TorchConv(f, f, (3, 3), padding=1, policy=policy,
                               device=device)
        self.add_module(f"{prefix}2", norm_cls(f, policy=policy, device=device))
        if in_channels != f:
            self.shortcut_conv = TorchConv(in_channels, f, (1, 1), policy=policy,
                                           device=device)
            self.add_module(f"shortcut_{prefix}",
                            norm_cls(f, policy=policy, device=device))
        self.chain_cache = OperandCache()

    def eligible(self, x: torch.Tensor) -> bool:
        """JAX ``ResBlock2D._eligible`` without the VMEM byte bound."""
        _, h, w, c = x.shape
        f = self.out_channels
        if not self.use_pallas or self.norm != "batch":
            return False
        return (c % 128 == 0 and f % 128 == 0 and h % 8 == 0 and w % 8 == 0
                and c == f)

    def chain_params(self):
        """(k1, k2, scale1, shift1, scale2, shift2): HWIO conv weights in the
        compute dtype and the BN-folded float32 epilogues, for K1/K2."""
        cdt = self.policy.compute_dtype
        s1, t1 = self.bn1.folded_scale_shift(self.conv1.bias)
        s2, t2 = self.bn2.folded_scale_shift(self.conv2.bias)
        return (conv_weight_hwio(self.conv1, cdt), conv_weight_hwio(self.conv2, cdt),
                s1, t1, s2, t2)

    def chain_sources(self):
        """The tensors ``chain_params`` is computed from (norm 'batch')."""
        return [t for conv, bn in ((self.conv1, self.bn1), (self.conv2, self.bn2))
                for t in (conv.weight, conv.bias, bn.weight, bn.bias,
                          bn.running_mean, bn.running_var)]

    def cached_chain_params(self):
        """``chain_params()``, folded again only after a source changed."""
        return self.chain_cache.get(self.chain_sources(), self.chain_params,
                                    self.policy.compute_dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if self.norm == "group":
            identity = x
            if self.in_channels != self.out_channels:
                identity = self.shortcut_gn(self.shortcut_conv(x))
            out = torch.relu(self.gn1(self.conv1(x)))
            return torch.relu(self.gn2(self.conv2(out)) + identity)

        identity = x
        if self.in_channels != self.out_channels:
            identity = self.shortcut_bn(self.shortcut_conv(x), train)

        if not train and self.eligible(x):
            from megaportraits_tpu_torch.ops.kernels.conv3x3 import conv3x3_bn_act

            cdt = self.policy.compute_dtype
            k1, k2, s1, t1, s2, t2 = self.cached_chain_params()
            outs = []
            for xi, ri in zip(x.to(cdt), identity.to(cdt)):
                h1 = conv3x3_bn_act(xi.contiguous(), k1, s1, t1, None, relu=True)
                outs.append(conv3x3_bn_act(h1, k2, s2, t2, ri.contiguous(),
                                           relu=True))
            return torch.stack(outs)

        out = torch.relu(self.bn1(self.conv1(x), train))
        out = self.bn2(self.conv2(out), train)
        return torch.relu(out + identity)


class ResBlockBN(nn.Module):
    """Reference Student/ResNet18 ResBlock: relu(BN(conv3)) twice, plus a
    shortcut (1x1 conv stride 2 + BN when downsampling, 1x1 conv + BN when
    the width changes, else the input), then ReLU once more."""

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
    """Spatially-adaptive norm with per-avatar embeddings: InstanceNorm, a
    shared conv (C -> 128) + ReLU plus the avatar's shared embedding, then
    gamma/beta convs plus the avatar's gamma/beta embeddings;
    ``normed * (1 + gamma) + beta``. ``avatar_index`` is [B] integers."""

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
    """Reference SPADEResBlock: two SPADE -> leaky_relu(0.2) -> conv3 steps
    through ``min(in, out)`` channels, plus a learned bias-free 1x1 shortcut
    (after its own SPADE) only when the width changes."""

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
        def actvn(t):
            return F.leaky_relu(t, 0.2)

        x_s = x
        if self.conv_s is not None:
            x_s = self.conv_s(self.norm_s(x, avatar_index))
        dx = self.conv_0(actvn(self.norm_0(x, avatar_index)))
        dx = self.conv_1(actvn(self.norm_1(dx, avatar_index)))
        return x_s + dx
