"""K1: fused 3x3 SAME conv + scale/shift (+ residual) (+ ReLU), bf16 NHWC.

Replaces ``megaportraits_tpu/ops/pallas/conv2d.py::fused_conv3x3``:

    out = [relu](conv3x3_SAME(x, w) * scale + shift [+ residual])

with x [H, W, C], w [3, 3, C, F] (HWIO), scale/shift [F] float32 (folded
eval-mode BatchNorm plus conv bias), residual [H, W, F], f32 accumulation.

On a CUDA tensor ``conv3x3_bn_act`` launches the hand-written kernel in
``csrc/conv3x3_bn_act.cu`` (an implicit GEMM on bf16 tensor cores; its
header states the bound and the design) or raises: it takes bf16 x, w and
residual, float32 scale/shift, contiguous, C % 32 == 0 and F % 8 == 0. On a
CPU tensor it runs ``conv3x3_bn_act_plain``, the same function in plain
PyTorch, which is also the reference the kernel is held against on the card.

``conv3x3_bn_act.launches`` counts kernel launches, wherever they come from
(the ResBlock2D chain launches this kernel too).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from megaportraits_tpu_torch.ops.kernels.build import load_library

KERNEL_NAME = "conv3x3_bn_act"


def _check_shapes(x, w, scale, shift, residual):
    if x.ndim != 3 or w.ndim != 4 or tuple(w.shape[:2]) != (3, 3):
        raise ValueError(f"expected x [H,W,C] and w [3,3,C,F], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    h, wd, c = x.shape
    f = w.shape[3]
    if w.shape[2] != c:
        raise ValueError(f"w has {w.shape[2]} input channels, x has {c}")
    if tuple(scale.shape) != (f,) or tuple(shift.shape) != (f,):
        raise ValueError(f"scale/shift must be [{f}]")
    if residual is not None and tuple(residual.shape) != (h, wd, f):
        raise ValueError(f"residual must be [{h},{wd},{f}], got "
                         f"{tuple(residual.shape)}")


def conv3x3_bn_act_plain(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                         shift: torch.Tensor,
                         residual: Optional[torch.Tensor] = None,
                         relu: bool = True) -> torch.Tensor:
    """Plain PyTorch version: float32 conv and epilogue, output in x.dtype.

    On the card the conv runs with TF32 off, so that it is a float32
    reference for the bf16 kernel.
    """
    _check_shapes(x, w, scale, shift, residual)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        y = F.conv2d(x.float().permute(2, 0, 1)[None],
                     w.float().permute(3, 2, 0, 1), padding=1)
    y = y[0].permute(1, 2, 0) * scale.float() + shift.float()
    if residual is not None:
        y = y + residual.float()
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


def check_kernel_args(x, w, scale, shift, residual):
    tensors = [x, w, scale, shift] + ([] if residual is None else [residual])
    if any(t.device != x.device for t in tensors):
        raise ValueError("all arguments must lie on one device")
    if any(t.dtype != torch.bfloat16 for t in (x, w)) or (
            residual is not None and residual.dtype != torch.bfloat16):
        raise TypeError("the CUDA kernel takes bf16 x, w and residual, got "
                        f"{x.dtype}, {w.dtype}"
                        f"{'' if residual is None else ', ' + str(residual.dtype)}")
    if scale.dtype != torch.float32 or shift.dtype != torch.float32:
        raise TypeError("the CUDA kernel takes float32 scale and shift")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the CUDA kernel takes contiguous tensors")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("the CUDA kernel takes 16-byte aligned tensors")
    c, f = x.shape[2], w.shape[-1]
    if c % 32 or f % 8:
        raise ValueError(f"the CUDA kernel takes C % 32 == 0 and F % 8 == 0, "
                         f"got C={c}, F={f}")


def launch_conv3x3(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                   shift: torch.Tensor, residual: Optional[torch.Tensor],
                   out: torch.Tensor, relu: bool) -> torch.Tensor:
    """Launch the kernel into `out` on the current stream (no checks beyond
    the launch status; callers validate). Counts the launch."""
    lib = load_library(KERNEL_NAME)
    fn = lib.conv3x3_bn_act
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.conv3x3_bn_act_error_string.argtypes = [ctypes.c_int]
        lib.conv3x3_bn_act_error_string.restype = ctypes.c_char_p
    h, wd, c = x.shape
    f = w.shape[3]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                 None if residual is None else residual.data_ptr(),
                 out.data_ptr(), h, wd, c, f, int(relu), stream)
    if err != 0:
        msg = lib.conv3x3_bn_act_error_string(err).decode()
        raise RuntimeError(f"{KERNEL_NAME} launch failed: {msg} ({err})")
    conv3x3_bn_act.launches += 1
    return out


def conv3x3_bn_act(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                   shift: torch.Tensor, residual: Optional[torch.Tensor] = None,
                   relu: bool = True) -> torch.Tensor:
    """K1 on x [H,W,C], w [3,3,C,F]: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    _check_shapes(x, w, scale, shift, residual)
    if x.device.type == "cpu":
        return conv3x3_bn_act_plain(x, w, scale, shift, residual, relu)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    check_kernel_args(x, w, scale, shift, residual)
    out = torch.empty((x.shape[0], x.shape[1], w.shape[3]), dtype=x.dtype,
                      device=x.device)
    return launch_conv3x3(x, w, scale, shift, residual, out, relu)


conv3x3_bn_act.launches = 0

