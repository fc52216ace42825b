"""K4: eval-mode BatchNorm (+ residual) (+ ReLU) in one pass, bf16 in and out.

    out = [relu]((y - m1) * s1 + b1 [+ r | + (r - m2) * s2 + b2])

with y [..., C] a conv's output, channels-last; m, s and b [C] float32: a
BatchNorm's running mean, ``weight * rsqrt(running_var + eps)`` and bias
(``nn/layers.fold_batch_norm``); r of y's shape, the identity as it is or,
with (m2, s2, b2), a shortcut conv's output under its own BatchNorm. All
arithmetic is float32 and the output is rounded to y's dtype once.

It replaces no TPU kernel: JAX leaves this chain to XLA, which fuses it
into the conv. In PyTorch, eval-mode ``BatchNorm`` then ReLU (and a block's
residual sum) is a float32 broadcast chain of about ten launches;
``csrc/bn_act.cu`` states the kernel's bound and design.

On a CUDA tensor ``bn_act`` launches the kernel or raises. The kernel
takes bf16 y and r, float32 operands, contiguous and 16-byte aligned, C %
8 == 0 and C <= 2048; it has no backward, so with autograd on an argument
that requires grad raises. On a CPU tensor it runs ``bn_act_plain``, the
same function in plain PyTorch, which is also the reference the kernel is
held against on the card. ``bn_act.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from megaportraits_tpu_torch.ops.kernels.build import load_library

KERNEL_NAME = "bn_act"
MAX_CHANNELS = 2048  # 8 channels a thread, at most 256 threads a block


def _check_shapes(y, m1, s1, b1, residual, m2, s2, b2):
    if (m2 is None) != (s2 is None) or (m2 is None) != (b2 is None):
        raise ValueError("the residual's operands come as m2, s2 and b2 together")
    if residual is None and m2 is not None:
        raise ValueError("m2, s2 and b2 need a residual")
    c = y.shape[-1]
    for t in (m1, s1, b1) + (() if m2 is None else (m2, s2, b2)):
        if tuple(t.shape) != (c,):
            raise ValueError(f"the BatchNorm operands must be [{c}]")
    if residual is not None and residual.shape != y.shape:
        raise ValueError(f"residual must be {tuple(y.shape)}, got "
                         f"{tuple(residual.shape)}")


def bn_act_plain(y: torch.Tensor, m1: torch.Tensor, s1: torch.Tensor,
                 b1: torch.Tensor, residual: Optional[torch.Tensor] = None,
                 m2: Optional[torch.Tensor] = None, s2: Optional[torch.Tensor] = None,
                 b2: Optional[torch.Tensor] = None, relu: bool = True) -> torch.Tensor:
    """Plain PyTorch version: float32 math, output in y.dtype."""
    _check_shapes(y, m1, s1, b1, residual, m2, s2, b2)
    out = (y.float() - m1.float()) * s1.float() + b1.float()
    if residual is not None:
        r = residual.float()
        out = out + (r if m2 is None else (r - m2.float()) * s2.float() + b2.float())
    if relu:
        out = torch.relu(out)
    return out.to(y.dtype)


def check_bn_act_args(y, operands, residual):
    """What the CUDA kernel takes; raises on anything else."""
    tensors = [y, *operands] + ([] if residual is None else [residual])
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "the CUDA kernels have no backward: call them under torch.no_grad() "
            "or on tensors that do not require grad")
    if any(t.device != y.device for t in tensors):
        raise ValueError("all arguments must lie on one device")
    if y.dtype != torch.bfloat16 or (residual is not None
                                     and residual.dtype != torch.bfloat16):
        raise TypeError("the CUDA kernel takes bf16 y and residual, got "
                        f"{y.dtype}{'' if residual is None else ', ' + str(residual.dtype)}")
    if any(t.dtype != torch.float32 for t in operands):
        raise TypeError("the CUDA kernel takes float32 BatchNorm operands")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the CUDA kernel takes contiguous tensors")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("the CUDA kernel takes 16-byte aligned tensors")
    c = y.shape[-1]
    if c % 8 or c > MAX_CHANNELS:
        raise ValueError(f"the CUDA kernel takes C % 8 == 0 and C <= "
                         f"{MAX_CHANNELS}, got C={c}")


def library():
    """The built library with its argument types set."""
    lib = load_library(KERNEL_NAME)
    if lib.bn_act.argtypes is None:
        lib.bn_act.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_longlong]
                               + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        lib.bn_act.restype = ctypes.c_int
        lib.bn_act_error_string.argtypes = [ctypes.c_int]
        lib.bn_act_error_string.restype = ctypes.c_char_p
    return lib


def bn_act(y: torch.Tensor, m1: torch.Tensor, s1: torch.Tensor, b1: torch.Tensor,
           residual: Optional[torch.Tensor] = None, m2: Optional[torch.Tensor] = None,
           s2: Optional[torch.Tensor] = None, b2: Optional[torch.Tensor] = None,
           relu: bool = True) -> torch.Tensor:
    """K4 on y [..., C]: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors."""
    _check_shapes(y, m1, s1, b1, residual, m2, s2, b2)
    if y.device.type == "cpu":
        return bn_act_plain(y, m1, s1, b1, residual, m2, s2, b2, relu)
    if y.device.type != "cuda":
        raise ValueError(f"no kernel for device {y.device}")
    operands = [m1, s1, b1] + ([] if m2 is None else [m2, s2, b2])
    check_bn_act_args(y, operands, residual)
    out = torch.empty_like(y)
    mode = 0 if residual is None else (1 if m2 is None else 2)

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = library()
    stream = torch.cuda.current_stream(y.device).cuda_stream
    with torch.cuda.device(y.device):
        err = lib.bn_act(ptr(y), ptr(m1), ptr(s1), ptr(b1), ptr(residual), ptr(m2),
                         ptr(s2), ptr(b2), out.data_ptr(), y.numel(), y.shape[-1],
                         mode, int(relu), stream)
    if err != 0:
        msg = lib.bn_act_error_string(err).decode()
        raise RuntimeError(f"{KERNEL_NAME} launch failed: {msg} ({err})")
    bn_act.launches += 1
    return out


bn_act.launches = 0
