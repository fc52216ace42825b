"""K2: a chain of N ResBlock2D blocks (eval mode, BatchNorm folded).

Replaces ``megaportraits_tpu/ops/pallas/g2d_chain_v2.py::
fused_resblock_chain_v2`` (and computes the same function as v1,
``g2d_chain.py::fused_resblock_chain``). For each block b:

    h = relu(conv3x3(x, w[b,0]) * s[b,0] + t[b,0])
    x = relu(conv3x3(h, w[b,1]) * s[b,1] + t[b,1] + x)

with x [H, W, C], weights [N, 2, 3, 3, C, C] (HWIO per conv), scales and
shifts [N, 2, C] float32. Each conv zero-pads its own input, so conv2 pads
h with zeros (not conv1 of a padded x), as in the TPU kernel.

On a CUDA tensor the chain is ONE call into ``csrc/conv3x3_bn_act.cu``,
which enqueues 2N launches of the K1 kernel (TMA-fed ``wgmma``,
``csrc/conv3x3_wgmma.cuh``) on the current stream over two ping-pong
activation buffers and one h buffer, with no host synchronisation. Each
launch after the first is a programmatic dependent launch: its set-up and
its first weight loads run under the tail of the conv before, the Hopper
counterpart of the TPU kernel's weight double buffer. The tensor maps that
TMA needs are cached on the C side by (pointer, shape, box). Bound on an
H100 SXM for the 8-block 64x64x512 trunk: 309 GFLOP of bf16 products over
989 TFLOP/s is 0.313 ms; it is bound by the tensor cores. The activations
(4 MB a map) stay in the 50 MB L2 between launches, which is the part of
the TPU kernel's keep-on-chip design this version keeps. The single-launch
chain is K3 (``resblock_chain_fused.py``).

``resblock_chain.launches`` counts chain calls that launched kernels; the
convolutions themselves count in ``conv3x3_bn_act.launches`` (the C call
reports how many it launched). ``resblock_chain.dependent_launch`` can be
set to False to time the chain without the overlap.
"""

from __future__ import annotations

import ctypes

import torch

from megaportraits_tpu_torch.ops.kernels.conv3x3 import (
    check_kernel_args,
    conv3x3_bn_act,
    conv3x3_bn_act_plain,
    library,
    raise_launch_error,
    tile_box,
)


def check_chain(x, weights, scales, shifts):
    if x.ndim != 3:
        raise ValueError(f"expected x [H,W,C], got {tuple(x.shape)}")
    c = x.shape[2]
    n = weights.shape[0]
    if tuple(weights.shape) != (n, 2, 3, 3, c, c):
        raise ValueError(f"weights must be [N,2,3,3,{c},{c}], got "
                         f"{tuple(weights.shape)}")
    if tuple(scales.shape) != (n, 2, c) or tuple(shifts.shape) != (n, 2, c):
        raise ValueError(f"scales/shifts must be [{n},2,{c}]")


def resblock_chain_plain(x: torch.Tensor, weights: torch.Tensor,
                         scales: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: each conv in float32, activations stored in
    x.dtype between convs (as the kernel stores them)."""
    check_chain(x, weights, scales, shifts)
    for b in range(weights.shape[0]):
        h = conv3x3_bn_act_plain(x, weights[b, 0], scales[b, 0], shifts[b, 0],
                                 residual=None, relu=True)
        x = conv3x3_bn_act_plain(h, weights[b, 1], scales[b, 1], shifts[b, 1],
                                 residual=x, relu=True)
    return x


def resblock_chain(x: torch.Tensor, weights: torch.Tensor, scales: torch.Tensor,
                   shifts: torch.Tensor) -> torch.Tensor:
    """K2: the CUDA kernel chain for CUDA tensors, the plain version for CPU
    tensors."""
    check_chain(x, weights, scales, shifts)
    if x.device.type == "cpu":
        return resblock_chain_plain(x, weights, scales, shifts)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    check_kernel_args(x, weights, scales, shifts, None)
    n = weights.shape[0]
    if n == 0:
        return x
    lib = library()
    h, wd, c = x.shape
    _, bw = tile_box(h, wd)
    hbuf = torch.empty_like(x)
    bufs = (torch.empty_like(x), torch.empty_like(x))
    launched = ctypes.c_int(0)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.resblock_chain(
            x.data_ptr(), weights.data_ptr(), scales.data_ptr(),
            shifts.data_ptr(), hbuf.data_ptr(), bufs[0].data_ptr(),
            bufs[1].data_ptr(), h, wd, c, n, bw,
            int(resblock_chain.dependent_launch), stream,
            ctypes.byref(launched))
    conv3x3_bn_act.launches += launched.value
    if launched.value:
        resblock_chain.launches += 1
    if err != 0:
        raise_launch_error(lib, "resblock_chain", err)
    return bufs[(n - 1) % 2]


resblock_chain.launches = 0
resblock_chain.dependent_launch = True
