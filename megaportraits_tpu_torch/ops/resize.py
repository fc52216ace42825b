"""Resize / pooling primitives over channels-last tensors.

Counterpart of ``megaportraits_tpu/ops/resize.py``. The JAX package builds
torch's ``F.interpolate`` semantics out of interpolation matrices; here the
same functions call ``F.interpolate`` / ``F.avg_pool*`` on a channels-first
view of the tensor, which keep the exact torch conventions (including the
clamp-at-0 source index for ``align_corners=False``).

Public layout: ``linear_resize``/``nearest_resize`` take JAX-style ``axes``
(the spatial axes of a [B, *spatial, C] tensor, in order).
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from megaportraits_tpu_torch.core.dtypes import cudnn_float32
from megaportraits_tpu_torch.nn.layers import to_channels_first, to_channels_last


def _spatial_sizes(x: torch.Tensor, out_sizes: Sequence[int],
                   axes: Sequence[int]) -> Tuple[int, ...]:
    """Full spatial output size for a [B, *spatial, C] tensor."""
    sizes = list(x.shape[1:-1])
    for size, axis in zip(out_sizes, axes):
        axis = axis % x.ndim
        if not 1 <= axis <= x.ndim - 2:
            raise ValueError(f"axis {axis} is not a spatial axis of {tuple(x.shape)}")
        sizes[axis - 1] = int(size)
    return tuple(sizes)


def linear_resize(x: torch.Tensor, out_sizes: Sequence[int],
                  axes: Sequence[int], align_corners: bool) -> torch.Tensor:
    """torch ``F.interpolate(mode='bilinear'|'trilinear')`` over `axes`, in
    the input's dtype (bf16 stays bf16, float32 stays float32)."""
    sizes = _spatial_sizes(x, out_sizes, axes)
    if sizes == tuple(x.shape[1:-1]):
        return x
    mode = {1: "linear", 2: "bilinear", 3: "trilinear"}[len(sizes)]
    out = F.interpolate(to_channels_first(x), size=sizes, mode=mode,
                        align_corners=align_corners)
    return to_channels_last(out)


def nearest_resize(x: torch.Tensor, out_sizes: Sequence[int],
                   axes: Sequence[int]) -> torch.Tensor:
    """torch ``F.interpolate(mode='nearest')`` over the given axes."""
    sizes = _spatial_sizes(x, out_sizes, axes)
    if sizes == tuple(x.shape[1:-1]):
        return x
    out = F.interpolate(to_channels_first(x), size=sizes, mode="nearest")
    return to_channels_last(out)


def upsample_nearest(x: torch.Tensor, scale_factors: Sequence[int],
                     axes: Sequence[int]) -> torch.Tensor:
    """torch ``nn.Upsample(scale_factor=...)`` (default mode='nearest')."""
    sizes = [x.shape[a] * s for a, s in zip(axes, scale_factors)]
    return nearest_resize(x, sizes, axes)


def avg_pool_2d(x: torch.Tensor, window: int = 2, stride: int = 2) -> torch.Tensor:
    """AvgPool2d over NHWC, matching torch nn.AvgPool2d(k, s) (no padding)."""
    return to_channels_last(F.avg_pool2d(to_channels_first(x), window, stride))


def avg_pool_3d(x: torch.Tensor, window: int = 2, stride: int = 2) -> torch.Tensor:
    """AvgPool3d over NDHWC, matching torch nn.AvgPool3d(k, s)."""
    return to_channels_last(F.avg_pool3d(to_channels_first(x), window, stride))


@functools.lru_cache(maxsize=None)
def gaussian_kernel_2d(scale: float) -> Tuple[np.ndarray, int, int]:
    """Gaussian kernel for band-limited downsampling (AntiAliasInterpolation2d):
    sigma = (1/scale - 1)/2, size 2*round(4*sigma)+1, normalized to sum 1.
    Returns (kernel[k,k], pad_a, pad_b)."""
    sigma = (1.0 / scale - 1.0) / 2.0
    ksize = 2 * round(sigma * 4) + 1
    ka = ksize // 2
    kb = ka - 1 if ksize % 2 == 0 else ka
    grid = np.arange(ksize, dtype=np.float64)
    mean = (ksize - 1) / 2.0
    g1 = np.exp(-((grid - mean) ** 2) / (2.0 * sigma**2))
    kernel = np.outer(g1, g1)
    kernel = kernel / kernel.sum()
    return kernel.astype(np.float32), ka, kb


def image_pyramid(x: torch.Tensor, scales: Sequence[float] = (0.5, 0.25)):
    """Anti-aliased image pyramid of NHWC images: {str(scale): the
    band-limited downsample} (the reference's ImagePyramide)."""
    return {str(s): anti_alias_downsample(x, s) for s in scales}


class _Float32Blur(torch.autograd.Function):
    """The depthwise blur of ``anti_alias_downsample`` with TF32 off in its
    backward too: JAX's ``Precision.HIGHEST`` holds for the convolution's
    transpose, and autograd runs the backward outside any scope the
    forward opened (a bf16 training step opens none around it)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(k)
        ctx.input_shape = x.shape
        with cudnn_float32():
            return F.conv2d(x, k, groups=k.shape[0])

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (k,) = ctx.saved_tensors
        with cudnn_float32():
            dx = torch.nn.grad.conv2d_input(ctx.input_shape, k, grad, groups=k.shape[0])
        return dx, None


def anti_alias_downsample(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Band-limited downsample of NHWC images: zero-pad, depthwise gaussian
    blur in float32 (TF32 off, forward and backward: JAX's
    ``Precision.HIGHEST``), then nearest resize by `scale`."""
    if scale == 1.0:
        return x
    kernel, ka, kb = gaussian_kernel_2d(scale)
    c = x.shape[-1]
    xf = to_channels_first(x.float())
    xf = F.pad(xf, (ka, kb, ka, kb))
    k = torch.as_tensor(kernel, device=x.device)[None, None].expand(c, 1, -1, -1)
    out = to_channels_last(_Float32Blur.apply(xf, k.contiguous()))
    h, w = out.shape[1], out.shape[2]
    out = nearest_resize(out, [int(h * scale), int(w * scale)], axes=[1, 2])
    return out.to(x.dtype)
