"""Leaf layers: convs (incl. weight-standardized), dense, norms.

Counterpart of ``megaportraits_tpu/nn/layers.py``. Every layer takes and
returns channels-last tensors (NHWC for 2D, NDHWC for 3D), as the JAX
package does. Inside, a conv views its input as channels-first with
``movedim`` (a stride change, no copy), so cuDNN runs it in channels-last
memory format and the result moves back to NHWC without a copy either.

Parameters use torch's own layouts (conv OIHW/OIDHW, dense [out, in]).
``utils/jax_bridge.py`` maps a JAX variable tree onto them.

Initialisation is explicit: ``init_parameters(module, seed)`` draws every
parameter from one ``torch.Generator`` on the module's device, with torch's
default conv/linear bounds (uniform +-1/sqrt(fan_in)).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from megaportraits_tpu_torch.core.dtypes import DEFAULT_POLICY, Policy, cast_param
from megaportraits_tpu_torch.parallel.mesh import all_reduce_sum


def to_channels_first(x: torch.Tensor) -> torch.Tensor:
    """[B, *spatial, C] -> [B, C, *spatial] view."""
    return x.movedim(-1, 1)


def to_channels_last(x: torch.Tensor) -> torch.Tensor:
    """[B, C, *spatial] -> [B, *spatial, C] view."""
    return x.movedim(1, -1)


def _uniform_(t: torch.Tensor, bound: float, generator: torch.Generator):
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=generator)


def init_parameters(module: nn.Module, seed: int = 0,
                    generator: Optional[torch.Generator] = None) -> nn.Module:
    """Draw every parameter of `module` from one seeded generator (or from
    `generator`, on the module's device, when given).

    Layers with a ``reset_parameters(generator)`` method are visited in
    ``module.modules()`` order, so the same seed gives the same weights on
    the same device.
    """
    gen = generator
    if gen is None:
        gen = torch.Generator(device=next(module.parameters()).device)
        gen.manual_seed(seed)
    for m in module.modules():
        fn = getattr(m, "reset_parameters", None)
        if fn is not None:
            fn(gen)
    return module


# ---------------------------------------------------------------------------
# Convolutions
# ---------------------------------------------------------------------------


class TorchConv(nn.Module):
    """Conv with torch default init and the mixed-precision policy.

    2D (NHWC) or 3D (NDHWC) by ``len(kernel_size)``; ``strides`` and
    ``padding`` are torch's symmetric ints. Input, weight and bias are cast to the compute
    dtype, as flax's ``nn.Conv(dtype=...)`` does; a float32 policy convolves
    with TF32 off (``Policy.conv_scope``). ``param_casts`` counts the casts
    of weight and bias (``core/dtypes.cast_param``).
    """

    param_casts = 0

    def __init__(self, in_features: int, features: int,
                 kernel_size: Sequence[int], strides: int = 1,
                 padding: int = 0, use_bias: bool = True,
                 feature_group_count: int = 1,
                 policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        self.kernel_size = tuple(kernel_size)
        self.nd = len(self.kernel_size)
        self.strides = strides
        self.padding = padding
        self.groups = feature_group_count
        self.policy = policy
        self.fan_in = math.prod(self.kernel_size) * (in_features // self.groups)
        self.weight = nn.Parameter(torch.empty(
            features, in_features // self.groups, *self.kernel_size,
            dtype=policy.param_dtype, device=device))
        self.bias = (nn.Parameter(torch.empty(features, dtype=policy.param_dtype,
                                              device=device))
                     if use_bias else None)

    def reset_parameters(self, generator: torch.Generator):
        bound = 1.0 / math.sqrt(self.fan_in)
        _uniform_(self.weight, bound, generator)
        if self.bias is not None:
            _uniform_(self.bias, bound, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cdt = self.policy.compute_dtype
        conv = F.conv2d if self.nd == 2 else F.conv3d
        bias = None if self.bias is None else cast_param(self.bias, cdt, TorchConv)
        with self.policy.conv_scope():
            y = conv(to_channels_first(x.to(cdt)), cast_param(self.weight, cdt, TorchConv),
                     bias,
                     self.strides, self.padding, 1, self.groups)
        return to_channels_last(y)


class WSConv(nn.Module):
    """Weight-standardized conv (reference Conv2d_WS / Conv3D_WS).

    The kernel is standardized per output filter in float32: subtract the
    mean over all input taps, divide by the *unbiased* std + 1e-5.
    ``param_casts`` counts the casts of the standardized weight and the bias.
    """

    param_casts = 0

    def __init__(self, in_features: int, features: int,
                 kernel_size: Sequence[int], padding: int = 0,
                 policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        self.kernel_size = tuple(kernel_size)
        self.nd = len(self.kernel_size)
        self.padding = padding
        self.policy = policy
        self.fan_in = math.prod(self.kernel_size) * in_features
        self.weight = nn.Parameter(torch.empty(
            features, in_features, *self.kernel_size,
            dtype=policy.param_dtype, device=device))
        self.bias = nn.Parameter(torch.empty(features, dtype=policy.param_dtype,
                                             device=device))

    reset_parameters = TorchConv.reset_parameters

    def standardized_weight(self) -> torch.Tensor:
        k = self.weight.float()
        dims = tuple(range(1, k.ndim))  # all but the output-feature axis
        k = k - k.mean(dim=dims, keepdim=True)
        n = float(math.prod(k.shape[1:]))
        var = (k * k).sum(dim=dims, keepdim=True) / max(n - 1.0, 1.0)
        return k / (torch.sqrt(var) + 1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cdt = self.policy.compute_dtype
        conv = F.conv2d if self.nd == 2 else F.conv3d
        with self.policy.conv_scope():
            y = conv(to_channels_first(x.to(cdt)),
                     cast_param(self.standardized_weight(), cdt, WSConv), None, 1,
                     self.padding)
        return to_channels_last(y) + cast_param(self.bias, cdt, WSConv)


class TorchDense(nn.Module):
    """Linear with torch default init and the policy dtypes; ``param_casts``
    counts the casts of weight and bias."""

    param_casts = 0

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        self.policy = policy
        self.fan_in = in_features
        self.weight = nn.Parameter(torch.empty(
            features, in_features, dtype=policy.param_dtype, device=device))
        self.bias = (nn.Parameter(torch.empty(features, dtype=policy.param_dtype,
                                              device=device))
                     if use_bias else None)

    reset_parameters = TorchConv.reset_parameters

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cdt = self.policy.compute_dtype
        bias = None if self.bias is None else cast_param(self.bias, cdt, TorchDense)
        return F.linear(x.to(cdt), cast_param(self.weight, cdt, TorchDense), bias)


# ---------------------------------------------------------------------------
# Normalization (always reduces in float32)
# ---------------------------------------------------------------------------


def group_norm(x: torch.Tensor, num_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over channels-last input of any spatial rank, float32 math."""
    orig_dtype = x.dtype
    xf = x.float()
    shape = xf.shape
    c = shape[-1]
    assert c % num_groups == 0, f"channels {c} not divisible by {num_groups}"
    grouped = xf.reshape(*shape[:-1], num_groups, c // num_groups)
    # Reduce over all spatial axes + within-group channels, per (batch, group).
    dims = tuple(range(1, grouped.ndim - 2)) + (grouped.ndim - 1,)
    var, mean = torch.var_mean(grouped, dim=dims, keepdim=True, correction=0)
    normed = (grouped - mean) * torch.rsqrt(var + eps)
    return normed.reshape(shape).to(orig_dtype)


class GroupNorm32(nn.Module):
    """F.group_norm(num_groups=32) with no learned affine."""

    def __init__(self, num_groups: int = 32, eps: float = 1e-5):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm(x, self.num_groups, self.eps)


class AffineGroupNorm(nn.Module):
    """nn.GroupNorm(groups, channels) with learned per-channel scale/bias;
    ``param_casts`` counts their casts to the input's dtype."""

    param_casts = 0

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-5,
                 policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels, dtype=policy.param_dtype,
                                              device=device))
        self.bias = nn.Parameter(torch.zeros(channels, dtype=policy.param_dtype,
                                             device=device))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        normed = group_norm(x, self.num_groups, self.eps)
        return (normed * cast_param(self.weight, normed.dtype, AffineGroupNorm)
                + cast_param(self.bias, normed.dtype, AffineGroupNorm))


class AdaptiveGroupNorm(nn.Module):
    """Reference AdaptiveGroupNorm: GroupNorm(32, C) with its own affine,
    then an extra learned per-channel scale/bias on top; ``param_casts``
    counts the casts of that scale and bias."""

    param_casts = 0

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-5,
                 policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        self.group_norm = AffineGroupNorm(channels, num_groups, eps, policy, device)
        self.weight = nn.Parameter(torch.ones(channels, dtype=policy.param_dtype,
                                              device=device))
        self.bias = nn.Parameter(torch.zeros(channels, dtype=policy.param_dtype,
                                             device=device))

    reset_parameters = AffineGroupNorm.reset_parameters

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        normed = self.group_norm(x)
        return (normed * cast_param(self.weight, normed.dtype, AdaptiveGroupNorm)
                + cast_param(self.bias, normed.dtype, AdaptiveGroupNorm))


class InstanceNorm(nn.Module):
    """torch nn.InstanceNorm2d default: per-sample, per-channel statistics
    over the spatial axes in float32, no affine, no running statistics."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        dims = tuple(range(1, xf.ndim - 1))
        var, mean = torch.var_mean(xf, dim=dims, keepdim=True, correction=0)
        return ((xf - mean) * torch.rsqrt(var + self.eps)).to(x.dtype)


class BatchNorm(nn.Module):
    """BatchNorm over the last axis, eps 1e-5, float32 statistics.

    ``forward(x, train)`` follows the JAX package: ``train=True`` normalises
    with the batch's own (biased) statistics, ``train=False`` with the
    running ones. The running statistics are updated as
    ``0.9 * old + 0.1 * new`` only when the module is in ``.train()`` mode,
    the counterpart of JAX's ``mutable=['batch_stats']``; a module in
    ``.eval()`` mode can use batch statistics without recording them.

    The batch statistics are two reductions, the mean and then the mean of
    the centred squares. With ``sync_group`` set (``parallel/mesh.
    sync_batch_norm``) both sums and the count are summed over that group
    of data-parallel ranks by a reduction that autograd differentiates: the
    statistics of the global batch, as JAX's GSPMD computes them, and the
    same running statistics on every rank.
    """

    momentum = 0.1  # weight of the new batch statistic
    sync_group = None  # the data-parallel group the statistics span

    def __init__(self, channels: int, eps: float = 1e-5,
                 policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels, dtype=policy.param_dtype,
                                              device=device))
        self.bias = nn.Parameter(torch.zeros(channels, dtype=policy.param_dtype,
                                             device=device))
        self.register_buffer("running_mean", torch.zeros(channels, device=device))
        self.register_buffer("running_var", torch.ones(channels, device=device))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def batch_statistics(self, xf: torch.Tensor):
        """(mean, var) of `xf` over every axis but the last, over the ranks
        of ``sync_group`` when it is set."""
        dims = tuple(range(xf.ndim - 1))
        total = xf.sum(dim=dims)
        # A tensor in both cases: a division by a Python number on the card
        # multiplies by its reciprocal, which rounds apart from the synced
        # path's division.
        count = total.new_full((1,), xf.numel() // xf.shape[-1])
        if self.sync_group is not None:
            summed = all_reduce_sum(torch.cat([total, count]), self.sync_group)
            total, count = summed[:-1], summed[-1:]
        mean = total / count
        squares = torch.square(xf - mean).sum(dim=dims)
        if self.sync_group is not None:
            squares = all_reduce_sum(squares, self.sync_group)
        return mean, squares / count

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        xf = x.float()
        if train:
            mean, var = self.batch_statistics(xf)
            if self.training:
                with torch.no_grad():
                    m = self.momentum
                    self.running_mean.mul_(1.0 - m).add_(m * mean)
                    self.running_var.mul_(1.0 - m).add_(m * var)
        else:
            mean, var = self.running_mean, self.running_var
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        y = y * self.weight.float() + self.bias.float()
        return y.to(x.dtype)

    def folded_scale_shift(self, conv_bias: torch.Tensor):
        """(scale, shift) with BN(conv(x) + conv_bias) == conv(x)*scale + shift
        in eval mode (JAX ``ResBlock2D._fold``), from ``fold_batch_norm``."""
        m, s, b = fold_batch_norm(self)
        return s, b + (conv_bias.float() - m) * s


def fold_batch_norm(bn: BatchNorm):
    """(m, s, b), float32 [C], with eval-mode ``bn(y) == (y - m) * s + b``
    up to float32 reassociation: ``s = weight * rsqrt(running_var + eps)``
    folded once, K4's operands and the base of K2's."""
    return (bn.running_mean.float(),
            bn.weight.detach().float() * torch.rsqrt(bn.running_var.float() + bn.eps),
            bn.bias.detach().float())


class FrozenBN(nn.Module):
    """Inference-mode BatchNorm over the last axis whose statistics are
    parameters, as the JAX package holds them for its frozen networks (FAN,
    InceptionResnetV1): ``(x - running_mean) * rsqrt(running_var + eps) *
    weight + bias`` in float32, the result in x's dtype."""

    def __init__(self, channels: int, eps: float = 1e-5,
                 policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        self.eps = eps
        for name in ("weight", "bias", "running_mean", "running_var"):
            self.register_parameter(name, nn.Parameter(torch.empty(
                channels, dtype=policy.param_dtype, device=device)))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = (x.float() - self.running_mean) * torch.rsqrt(self.running_var + self.eps)
        return (y * self.weight + self.bias).to(x.dtype)


def calibrate_batch_norm_with(model: nn.Module, forward: Callable[[], object]) -> int:
    """Set every BatchNorm's running statistics in `model` to the batch
    statistics that ``forward()`` (a pass with ``train=True``) meets; random
    weights otherwise leave the eval path on mean-0/var-1 statistics that
    saturate it. Leaves the model in ``.eval()``; returns the number of
    BatchNorms."""
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for bn in bns:
        bn.momentum = 1.0
    model.train()
    with torch.no_grad():
        forward()
    for bn in bns:
        del bn.momentum  # back to the class default
    model.eval()
    return len(bns)


class Embed(nn.Embedding):
    """flax ``nn.Embed``: a table drawn from N(0, 1) in the parameter dtype,
    looked up in the compute dtype."""

    def __init__(self, num_embeddings: int, features: int,
                 policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__(num_embeddings, features, device=device,
                         dtype=policy.param_dtype)
        self.policy = policy

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.weight.normal_(generator=generator)

    def forward(self, index: torch.Tensor) -> torch.Tensor:
        """`index` of any integer dtype (the drivers' batches carry int32)."""
        return super().forward(index.long()).to(self.policy.compute_dtype)
