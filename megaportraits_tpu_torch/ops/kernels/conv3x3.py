"""K1: fused 3x3 SAME conv + scale/shift (+ residual) (+ ReLU), bf16 NHWC.

Replaces ``megaportraits_tpu/ops/pallas/conv2d.py::fused_conv3x3``:

    out = [relu](conv3x3_SAME(x, w) * scale + shift [+ residual])

with x [H, W, C], w [3, 3, C, F] (HWIO), scale/shift [F] float32 (folded
eval-mode BatchNorm plus conv bias), residual [H, W, F], f32 accumulation.

On a CUDA tensor ``conv3x3_bn_act`` launches the hand-written kernel in
``csrc/conv3x3_bn_act.cu`` or raises. The kernel is an implicit GEMM for
Hopper (``csrc/conv3x3_wgmma.cuh`` states the bound and the design): the
output is cut into boxes of ``tile_box(H, W)`` pixels by 128 channels, TMA
loads the pixel boxes at signed coordinates (the hardware's zero fill is
the SAME padding; a box 64 pixels wide is loaded once per channel slice
with its halo and serves all nine taps), ``wgmma`` multiplies, and the
epilogue runs on the accumulators in registers. It takes bf16 x, w and
residual, float32 scale/shift, contiguous and 16-byte aligned, C % 32 == 0
and F % 8 == 0; neither x nor the residual may overlap the output. It has
no backward: with autograd on, an argument that requires grad raises (as in
K2 and K3). On a CPU tensor it runs ``conv3x3_bn_act_plain``, the same
function in plain PyTorch, which is also the reference the kernel is held
against on the card.
``conv3x3_bn_act_boxed`` follows the kernel's data path step by step in
plain PyTorch, for the tests.

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

TILE_PIXELS = 128  # output pixels of one tile
TILE_CHANNELS = 128  # output channels of one tile
K_SLICE = 64  # input channels of one K step
HALO_BOX_WIDTH = 64  # boxes this wide load once per slice, with their halo


def tile_box(h: int, w: int) -> tuple:
    """(bh, bw): the box of pixels of one output tile, bh * bw == 128. bw is
    the smallest of 8, 16, 32, 64 that holds a whole image row (64 for wider
    images), so that narrow images waste few of the tile's pixels."""
    if h < 1 or w < 1:
        raise ValueError(f"empty image {h}x{w}")
    bw = next((b for b in (8, 16, 32, 64) if b >= w), 64)
    return TILE_PIXELS // bw, bw


def tile_origins(h: int, w: int) -> list:
    """(y0, x0) of every tile box of an h x w image, in launch order."""
    bh, bw = tile_box(h, w)
    return [(y0, x0) for y0 in range(0, h, bh) for x0 in range(0, w, bw)]


def staged_bytes(h: int, w: int, c: int, f: int) -> int:
    """Bytes that one conv's CTAs load from L2 into shared memory for the
    K loop (pixel boxes and weight boxes; zero-filled parts count, the
    residual and the output do not): what the tile routine's design costs
    beyond the tensors' own size."""
    bh, bw = tile_box(h, w)
    slices = -(-c // K_SLICE)
    total = 0
    for n0 in range(0, f, TILE_CHANNELS):
        weight_box = K_SLICE * 2 * (128 if f - n0 > 64 else 64)
        for y0, x0 in tile_origins(h, w):
            if bw == HALO_BOX_WIDTH:
                total += slices * ((bh + 2) * (bw + 2) * K_SLICE * 2
                                   + 9 * weight_box)
            else:
                taps = sum(1 for tap in range(9)
                           if y0 + tap // 3 - 1 < h and x0 + tap % 3 - 1 < w)
                total += taps * slices * (TILE_PIXELS * K_SLICE * 2 + weight_box)
    return total


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


def zero_filled_box(t: torch.Tensor, starts, sizes) -> torch.Tensor:
    """The box of `t` at signed `starts` with `sizes`, zeros outside `t`
    (what a tiled TMA load writes to shared memory)."""
    out = t.new_zeros(sizes)
    src, dst = [], []
    for start, size, dim in zip(starts, sizes, t.shape):
        lo, hi = max(start, 0), min(start + size, dim)
        if lo >= hi:
            return out
        src.append(slice(lo, hi))
        dst.append(slice(lo - start, hi - start))
    out[tuple(dst)] = t[tuple(src)]
    return out


def conv3x3_bn_act_boxed(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                         shift: torch.Tensor,
                         residual: Optional[torch.Tensor] = None,
                         relu: bool = True) -> torch.Tensor:
    """The kernel's data path in plain PyTorch, for tests only (slow).

    The output is assembled tile by tile. A tile is a box of ``tile_box``
    pixels by 128 channels. Each K step multiplies a zero-filled pixel box
    [128, 64] by the zero-filled weight box [64, 128] of one tap and one
    64-channel slice and accumulates in float32. Boxes 64 pixels wide walk
    the slices and, inside a slice, the nine taps, which are views of ONE
    zero-filled box with its halo, (bh + 2) x (bw + 2) pixels at
    (y0 - 1, x0 - 1). Narrower boxes walk the taps and, inside a tap, the
    slices, each step with the box at the tap's signed coordinate; a tap
    whose box lies wholly outside the image is left out. The epilogue reads a
    zero-filled residual box, and the store is clipped to the image and to F.
    """
    _check_shapes(x, w, scale, shift, residual)
    h, wd, c = x.shape
    f = w.shape[3]
    bh, bw = tile_box(h, wd)
    xf, wf = x.float(), w.float()
    out = torch.empty((h, wd, f), dtype=x.dtype, device=x.device)
    for n0 in range(0, f, TILE_CHANNELS):
        sc = zero_filled_box(scale.float(), (n0,), (TILE_CHANNELS,))
        sh = zero_filled_box(shift.float(), (n0,), (TILE_CHANNELS,))
        for y0, x0 in tile_origins(h, wd):
            acc = torch.zeros(TILE_PIXELS, TILE_CHANNELS, device=x.device)

            def step(a, tap, c0):
                b = zero_filled_box(wf[tap // 3, tap % 3], (c0, n0),
                                     (K_SLICE, TILE_CHANNELS))
                acc.add_(a.reshape(TILE_PIXELS, K_SLICE) @ b)

            if bw == HALO_BOX_WIDTH:
                for c0 in range(0, c, K_SLICE):
                    halo = zero_filled_box(xf, (y0 - 1, x0 - 1, c0),
                                            (bh + 2, bw + 2, K_SLICE))
                    for tap in range(9):
                        dy, dx = tap // 3, tap % 3
                        step(halo[dy:dy + bh, dx:dx + bw], tap, c0)
            else:
                for tap in range(9):
                    ty, tx = y0 + tap // 3 - 1, x0 + tap % 3 - 1
                    if ty >= h or tx >= wd:
                        continue
                    for c0 in range(0, c, K_SLICE):
                        step(zero_filled_box(xf, (ty, tx, c0), (bh, bw, K_SLICE)),
                             tap, c0)
            y = acc * sc + sh
            if residual is not None:
                y = y + zero_filled_box(
                    residual.float(), (y0, x0, n0),
                    (bh, bw, TILE_CHANNELS)).reshape(TILE_PIXELS, TILE_CHANNELS)
            if relu:
                y = torch.relu(y)
            y = y.reshape(bh, bw, TILE_CHANNELS).to(x.dtype)
            ye, xe, ne = min(y0 + bh, h), min(x0 + bw, wd), min(n0 + TILE_CHANNELS, f)
            out[y0:ye, x0:xe, n0:ne] = y[:ye - y0, :xe - x0, :ne - n0]
    return out


def check_kernel_args(x, w, scale, shift, residual, c_multiple: int = 32):
    """What every CUDA kernel of the port takes (K1, K2 and K3)."""
    tensors = [x, w, scale, shift] + ([] if residual is None else [residual])
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        # The kernels have no backward, and their outputs no autograd node:
        # a gradient through them would be cut without a word.
        raise RuntimeError(
            "the CUDA kernels have no backward: call them under torch.no_grad() "
            "or on tensors that do not require grad")
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
    if c % c_multiple or f % 8:
        raise ValueError(f"the CUDA kernel takes C % {c_multiple} == 0 and "
                         f"F % 8 == 0, got C={c}, F={f}")


def library():
    """The built library with its argument types set."""
    lib = load_library(KERNEL_NAME)
    if lib.conv3x3_bn_act.argtypes is None:
        lib.conv3x3_bn_act.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        lib.conv3x3_bn_act.restype = ctypes.c_int
        lib.resblock_chain.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
            + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
        lib.resblock_chain.restype = ctypes.c_int
        lib.conv3x3_bn_act_maps_encoded.argtypes = []
        lib.conv3x3_bn_act_maps_encoded.restype = ctypes.c_longlong
        lib.conv3x3_bn_act_error_string.argtypes = [ctypes.c_int]
        lib.conv3x3_bn_act_error_string.restype = ctypes.c_char_p
    return lib


def raise_launch_error(lib, what: str, err: int):
    msg = lib.conv3x3_bn_act_error_string(err).decode()
    raise RuntimeError(f"{what} launch failed: {msg} ({err})")


def launch_conv3x3(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                   shift: torch.Tensor, residual: Optional[torch.Tensor],
                   out: torch.Tensor, relu: bool) -> torch.Tensor:
    """Launch the kernel into `out` on the current stream (no checks beyond
    the launch status; callers validate). Counts the launch."""
    lib = library()
    h, wd, c = x.shape
    f = w.shape[3]
    _, bw = tile_box(h, wd)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.conv3x3_bn_act(
            x.data_ptr(), w.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            None if residual is None else residual.data_ptr(), out.data_ptr(),
            h, wd, c, f, int(relu), bw, stream)
    if err != 0:
        raise_launch_error(lib, KERNEL_NAME, err)
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

