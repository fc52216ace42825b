"""K3: a chain of N ResBlock2D blocks (eval mode, BatchNorm folded) in one
kernel launch.

Replaces ``megaportraits_tpu/ops/pallas/g2d_chain.py::fused_resblock_chain``,
the whole trunk in one ``pallas_call``. It computes the same function as K2
(``resblock_chain.py``), with the same signature and contract: for each
block b,

    h = relu(conv3x3(x, w[b,0]) * s[b,0] + t[b,0])
    x = relu(conv3x3(h, w[b,1]) * s[b,1] + t[b,1] + x)

with x [H, W, C], weights [N, 2, 3, 3, C, C] (HWIO per conv), scales and
shifts [N, 2, C] float32; conv2 zero-pads h.

On a CUDA tensor ``fused_resblock_chain`` launches the hand-written kernel
in ``csrc/resblock_chain_fused.cu`` once: a persistent cooperative grid
that walks the tiles of all 2N convs with a grid-wide barrier between them
(its header states the bound and the design). It takes what K1 takes (bf16
x and weights, float32 scales and shifts, contiguous, C % 32 == 0) and
N >= 1. If the grid cannot be resident at once, or the launch fails, it
raises; it never runs K2 or the plain version instead. On a CPU tensor it
runs ``fused_resblock_chain_plain``.

``fused_resblock_chain.launches`` counts kernel launches; K3 adds nothing
to ``conv3x3_bn_act.launches``. JAX calls its K3 from no model (``G2d``
runs K2), and neither does the port: this wrapper is K3's entry point.
"""

from __future__ import annotations

import ctypes

import torch

from megaportraits_tpu_torch.ops.kernels.build import load_library
from megaportraits_tpu_torch.ops.kernels.conv3x3 import check_kernel_args
from megaportraits_tpu_torch.ops.kernels.resblock_chain import (
    check_chain,
    resblock_chain_plain,
)

KERNEL_NAME = "resblock_chain_fused"


def fused_resblock_chain_plain(x: torch.Tensor, weights: torch.Tensor,
                               scales: torch.Tensor,
                               shifts: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the same function as K2's plain version."""
    return resblock_chain_plain(x, weights, scales, shifts)


def _library() -> ctypes.CDLL:
    lib = load_library(KERNEL_NAME)
    if lib.resblock_chain_fused.argtypes is None:
        lib.resblock_chain_fused.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.resblock_chain_fused.restype = ctypes.c_int
        lib.resblock_chain_fused_grid.argtypes = (
            [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)])
        lib.resblock_chain_fused_grid.restype = ctypes.c_int
        lib.resblock_chain_fused_error_string.argtypes = [ctypes.c_int]
        lib.resblock_chain_fused_error_string.restype = ctypes.c_char_p
    return lib


def _raise(lib, what: str, err: int):
    msg = lib.resblock_chain_fused_error_string(err).decode()
    raise RuntimeError(f"{KERNEL_NAME} {what} failed: {msg} ({err})")


def grid_ctas(h: int, w: int, c: int, device=None) -> int:
    """CTAs of one launch at [h, w, c] on `device` (the current card by
    default): resident CTAs per SM x SMs, capped at one conv's tiles."""
    lib = _library()
    grid = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = lib.resblock_chain_fused_grid(h, w, c, ctypes.byref(grid))
    if err != 0:
        _raise(lib, "grid query", err)
    return grid.value


def fused_resblock_chain(x: torch.Tensor, weights: torch.Tensor,
                         scales: torch.Tensor,
                         shifts: torch.Tensor) -> torch.Tensor:
    """K3: one kernel launch for CUDA tensors, the plain version for CPU
    tensors."""
    check_chain(x, weights, scales, shifts)
    if x.device.type == "cpu":
        return fused_resblock_chain_plain(x, weights, scales, shifts)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    check_kernel_args(x, weights, scales, shifts, None)
    n = weights.shape[0]
    if n < 1:
        raise ValueError("the CUDA kernel takes at least one block")
    lib = _library()
    h, w, c = x.shape
    act = torch.empty_like(x)
    hbuf = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.resblock_chain_fused(
            x.data_ptr(), weights.data_ptr(), scales.data_ptr(),
            shifts.data_ptr(), act.data_ptr(), hbuf.data_ptr(), h, w, c, n,
            stream)
    if err != 0:
        _raise(lib, "launch", err)
    fused_resblock_chain.launches += 1
    return act


fused_resblock_chain.launches = 0
