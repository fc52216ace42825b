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
    fold_batch_norm,
)
from megaportraits_tpu_torch.utils.profiling import annotate


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

    ``get(sources, build)`` returns ``build()``'s last result while every
    tensor of ``sources`` still has the ``data_ptr``, ``_version``, device
    and dtype it had then, else builds anew, without autograd. ``load_state_dict``, a BatchNorm calibration and
    an optimiser step write in place and move ``_version``; ``.to()`` and an
    assignment to ``.data`` move ``data_ptr``. ``folds`` counts the builds,
    ``OperandCache.all_folds`` those of every cache.
    """

    all_folds = 0

    def __init__(self):
        self.folds = 0
        self._key = None
        self._value = None

    def get(self, sources, build):
        key = tuple((t.data_ptr(), t._version, t.device, t.dtype) for t in sources)
        if key != self._key:
            with torch.no_grad():
                self._value = build()
            self._key = key
            self.folds += 1
            OperandCache.all_folds += 1
        return self._value


def kernel_takes(tensors) -> bool:
    """Whether the hand-written kernels take `tensors`' device and dtype:
    bf16 on a CUDA device. A width a kernel does not take raises there."""
    return all(t.device.type == "cuda" and t.dtype == torch.bfloat16 for t in tensors)


def kernel_engages(train: bool, tensors, sources) -> bool:
    """Whether a hand-written kernel (K2, K4) runs on `tensors`, its
    activations, with operands folded from the module tensors `sources`:
    not `train`, ``kernel_takes`` the tensors, and autograd recording
    nothing (grad off, or no tensor nor source requires grad), since the
    kernels have no backward. Anywhere else the modules run as they are:
    training, float32 policies, the CPU."""
    if train or not kernel_takes(tensors):
        return False
    return not torch.is_grad_enabled() or not any(
        t.requires_grad for t in [*tensors, *sources])


class BatchNormEpilogue:
    """One conv's eval-mode BatchNorm epilogue: ``relu(bn(y) [+ r])``, with
    ``r`` the `residual` as it is or ``residual_bn(residual)``.

    Where ``kernel_engages`` it is one launch of kernel K4
    (``ops/kernels/bn_act.py``) on the BatchNorms' folded operands, kept in
    an ``OperandCache`` and folded again only after a weight, bias or
    running statistic changed. Otherwise it is the modules' own float32
    chain, as before: training, float32 policies, the CPU and anything
    autograd records.
    """

    def __init__(self):
        self.cache = OperandCache()

    def __call__(self, train: bool, y: torch.Tensor, bn: BatchNorm,
                 residual: torch.Tensor = None,
                 residual_bn: BatchNorm = None) -> torch.Tensor:
        bns = [bn] if residual_bn is None else [bn, residual_bn]
        tensors = [y] if residual is None else [y, residual]
        sources = [t for b in bns
                   for t in (b.weight, b.bias, b.running_mean, b.running_var)]
        if not kernel_engages(train, tensors, sources):
            out = bn(y, train)
            if residual is not None:
                out = out + (residual if residual_bn is None
                             else residual_bn(residual, train))
            return torch.relu(out)
        from megaportraits_tpu_torch.ops.kernels.bn_act import bn_act

        operands = self.cache.get(
            sources, lambda: [t for b in bns for t in fold_batch_norm(b)])
        return bn_act(y.contiguous(), *operands[:3],
                      None if residual is None else residual.contiguous(),
                      *operands[3:])


class ResBlock2D(nn.Module):
    """Reference ResBlock2D: conv3-norm-ReLU-conv3-norm (+ a 1x1 conv + norm
    shortcut when the width changes) -> ReLU. The JAX block's ``downsample``
    option is unused and broken there (it strides only the shortcut), so it
    is not ported.

    ``norm='batch'`` (the reference) uses BatchNorm (``bn1``, ``bn2``,
    ``shortcut_bn``), each half's BatchNorm, residual and ReLU a
    ``BatchNormEpilogue`` (kernel K4 where it engages); ``norm='group'``
    uses AffineGroupNorm(32) (``gn1``, ``gn2``, ``shortcut_gn``), which has
    no batch statistics, so ``train`` changes nothing there.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 policy: Policy = DEFAULT_POLICY, norm: str = "batch", device=None):
        super().__init__()
        if norm not in ("batch", "group"):
            raise ValueError(f"unknown norm {norm!r}; expected 'batch' or 'group'")
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.policy = policy
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
        self.epilogue1 = BatchNormEpilogue()
        self.epilogue2 = BatchNormEpilogue()

    def chain_params(self):
        """(k1, k2, scale1, shift1, scale2, shift2): HWIO conv weights in the
        compute dtype and the BN-folded float32 epilogues, for K2 (whose
        launches run K1's tile routine)."""
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

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if self.norm == "group":
            identity = x
            if self.in_channels != self.out_channels:
                identity = self.shortcut_gn(self.shortcut_conv(x))
            out = torch.relu(self.gn1(self.conv1(x)))
            return torch.relu(self.gn2(self.conv2(out)) + identity)

        shortcut = self.in_channels != self.out_channels
        residual = self.shortcut_conv(x) if shortcut else x
        out = self.epilogue1(train, self.conv1(x), self.bn1)
        return self.epilogue2(train, self.conv2(out), self.bn2, residual,
                              self.shortcut_bn if shortcut else None)


class ResBlockBN(nn.Module):
    """Reference Student/ResNet18 ResBlock: relu(BN(conv3)) twice, plus a
    shortcut (1x1 conv stride 2 + BN when downsampling, 1x1 conv + BN when
    the width changes, else the input), then ReLU once more.

    Each ``relu(BN(conv3))`` is a ``BatchNormEpilogue`` (kernel K4 where it
    engages). The shortcut's BatchNorm and the last ``relu(out + shortcut)``
    stay the modules' chain: K4's residual form ``relu(bn(y) + r)`` has no
    ReLU between the BatchNorm and the sum."""

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
        self.epilogue1 = BatchNormEpilogue()
        self.epilogue2 = BatchNormEpilogue()

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        shortcut = x
        if self.shortcut_conv is not None:
            shortcut = self.shortcut_bn(self.shortcut_conv(x), train)
        out = self.epilogue1(train, self.conv1(x), self.bn1)
        out = self.epilogue2(train, self.conv2(out), self.bn2)
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
        with annotate("student.spade"):
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
