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
in ``csrc/resblock_chain_fused.cu`` once: a persistent cooperative grid on
the TMA + ``wgmma`` tile routine of K1 (``csrc/conv3x3_wgmma.cuh``) that
walks the tiles of all 2N convs. Between two convs only the thread that
loads pixels waits for the other CTAs (a counter in global memory); the
next conv's weights stream into shared memory meanwhile, and where the grid
has one tile a CTA the block's residual never leaves shared memory (the
source's header states the bound and the design). It sums in K2's order, so the two agree bit for bit. It
takes bf16 x and weights, float32 scales and shifts, contiguous and 16-byte
aligned, C % 8 == 0 and N >= 1. If the grid cannot be resident at once, a
tensor map cannot be encoded or the launch fails, it raises; it never runs
K2 or the plain version instead. On a CPU tensor it runs
``fused_resblock_chain_plain``.

What the host can decide is decided here and held by CPU tests: which tiles
a CTA takes and in what order (``chain_schedule``), what a tile reads of
the conv before it (``tile_dependencies``: the least it must wait for; the
kernel waits for the whole conv, which a probe found as fast), and whether
the residual stays in shared memory (``residual_stays_in_shared``).
``fused_resblock_chain_tiled`` runs the chain tile by tile in a given order,
in place on one activation and one h buffer, in plain PyTorch, for the
tests.

``fused_resblock_chain.launches`` counts kernel launches; K3 adds nothing
to ``conv3x3_bn_act.launches``. JAX calls its K3 from no model (``G2d``
runs K2), and neither does the port: this wrapper is K3's entry point.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Set, Tuple

import torch
import torch.nn.functional as F

from megaportraits_tpu_torch.ops.kernels.build import load_library
from megaportraits_tpu_torch.ops.kernels.conv3x3 import (
    TILE_CHANNELS,
    check_kernel_args,
    tile_box,
    tile_origins,
    zero_filled_box,
)
from megaportraits_tpu_torch.ops.kernels.resblock_chain import (
    check_chain,
    resblock_chain_plain,
)

KERNEL_NAME = "resblock_chain_fused"

Step = Tuple[int, int]  # (conv 0 .. 2N - 1, tile of that conv)


def fused_resblock_chain_plain(x: torch.Tensor, weights: torch.Tensor,
                               scales: torch.Tensor,
                               shifts: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the same function as K2's plain version."""
    return resblock_chain_plain(x, weights, scales, shifts)


# ---- the plan: what the kernel derives from the shape and its grid -------

def conv_tiles(h: int, w: int, c: int) -> int:
    """Output tiles of one conv: pixel boxes x 128-channel tiles. Tile t is
    pixel box t % boxes (``tile_origins`` order) at channel tile
    t // boxes, as K1's launch numbers its CTAs."""
    return len(tile_origins(h, w)) * -(-c // TILE_CHANNELS)


def plan_grid(h: int, w: int, c: int, resident_ctas: int) -> int:
    """CTAs of one launch on a card that holds `resident_ctas` at once (one
    an SM): no more than one conv has tiles."""
    if resident_ctas < 1:
        raise ValueError("the grid cannot be resident")
    return min(resident_ctas, conv_tiles(h, w, c))


def chain_schedule(h: int, w: int, c: int, n_blocks: int,
                   grid: int) -> List[List[Step]]:
    """For each of `grid` CTAs, the (conv, tile) steps it takes, in order:
    tiles cta, cta + grid, ... of conv 0, then the same tiles of conv 1, and
    so on. Every CTA takes all its tiles of a conv before any of the next,
    in one fixed order, which is what keeps waiting for other CTAs free of
    deadlock."""
    tiles = conv_tiles(h, w, c)
    if not 1 <= grid <= tiles:
        raise ValueError(f"grid {grid} outside 1..{tiles}")
    return [[(k, t) for k in range(2 * n_blocks) for t in range(cta, tiles, grid)]
            for cta in range(grid)]


def residual_stays_in_shared(h: int, w: int, c: int, grid: int) -> bool:
    """True if conv2 of block b >= 1 finds its residual in the epilogue
    buffer that the same CTA stored from one block earlier: the grid has one
    tile a CTA. Else every conv2 tile's residual arrives by TMA."""
    return grid == conv_tiles(h, w, c)


def tile_dependencies(h: int, w: int, c: int, conv: int, tile: int) -> Set[Step]:
    """The steps whose output tile (conv, tile) reads. As its input, the
    pixel boxes around its own (the box with its one-pixel halo) of the conv
    before, at all channel tiles. As its residual (conv2 of block b >= 1),
    its own tile of the conv2 before; block 0 adds x, which no step writes.
    In-place updates need no more: whoever reads the tile that this step
    overwrites belongs to the steps it reads."""
    bh, bw = tile_box(h, w)
    boxes_x, boxes_y = -(-w // bw), -(-h // bh)
    boxes = boxes_x * boxes_y
    channel_tiles = -(-c // TILE_CHANNELS)
    if not (conv >= 0 and 0 <= tile < boxes * channel_tiles):
        raise ValueError(f"no tile {tile} of conv {conv}")
    deps: Set[Step] = set()
    if conv == 0:
        return deps
    by, bx = divmod(tile % boxes, boxes_x)
    for ny in range(max(by - 1, 0), min(by + 2, boxes_y)):
        for nx in range(max(bx - 1, 0), min(bx + 2, boxes_x)):
            for n in range(channel_tiles):
                deps.add((conv - 1, n * boxes + ny * boxes_x + nx))
    if conv % 2 == 1 and conv >= 3:
        deps.add((conv - 2, tile))
    return deps


def fused_resblock_chain_tiled(x: torch.Tensor, weights: torch.Tensor,
                               scales: torch.Tensor, shifts: torch.Tensor,
                               order: Sequence[Step],
                               keep_residual: bool = False) -> torch.Tensor:
    """The kernel's schedule in plain PyTorch, for tests only (slow): runs
    the steps of `order` one tile at a time, in place on ONE activation
    buffer and ONE h buffer as the kernel does. conv1 reads the block's
    input (x for block 0, else the activation buffer) and writes h; conv2
    reads h, adds the block's input and writes the activation buffer. A
    step reads its pixel box with the halo, zero-filled outside the image,
    from the buffer AS IT IS when the step runs, so an order that runs a
    step before one it depends on gives another result. With
    `keep_residual`, conv2 of block b >= 1 adds the tile that the same
    step of block b - 1 stored, kept aside, not the buffer's."""
    check_chain(x, weights, scales, shifts)
    h, w, c = x.shape
    bh, bw = tile_box(h, w)
    origins = tile_origins(h, w)
    act = torch.zeros_like(x)
    hbuf = torch.zeros_like(x)
    kept: Dict[int, torch.Tensor] = {}
    for conv, tile in order:
        block, second = divmod(conv, 2)
        y0, x0 = origins[tile % len(origins)]
        n0 = (tile // len(origins)) * TILE_CHANNELS
        ne = min(n0 + TILE_CHANNELS, c)
        ye, xe = min(y0 + bh, h), min(x0 + bw, w)
        block_in = x if block == 0 else act
        src = hbuf if second else block_in
        halo = zero_filled_box(src.float(), (y0 - 1, x0 - 1, 0),
                                (bh + 2, bw + 2, c))
        wt = weights[block, second, :, :, :, n0:ne].float()
        y = F.conv2d(halo.permute(2, 0, 1)[None], wt.permute(3, 2, 0, 1))
        y = y[0].permute(1, 2, 0)[:ye - y0, :xe - x0]
        y = y * scales[block, second, n0:ne].float() \
            + shifts[block, second, n0:ne].float()
        if second:
            if keep_residual and block > 0:
                y = y + kept[tile].float()
            else:
                y = y + block_in[y0:ye, x0:xe, n0:ne].float()
        y = torch.relu(y).to(x.dtype)
        (act if second else hbuf)[y0:ye, x0:xe, n0:ne] = y
        if second:
            kept[tile] = y
    return act


# ---- the kernel ------------------------------------------------------------------

def _library() -> ctypes.CDLL:
    lib = load_library(KERNEL_NAME)
    if lib.resblock_chain_fused.argtypes is None:
        lib.resblock_chain_fused.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        lib.resblock_chain_fused.restype = ctypes.c_int
        lib.resblock_chain_fused_grid.argtypes = (
            [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)])
        lib.resblock_chain_fused_grid.restype = ctypes.c_int
        lib.resblock_chain_fused_smem_bytes.argtypes = []
        lib.resblock_chain_fused_smem_bytes.restype = ctypes.c_int
        lib.resblock_chain_fused_maps_encoded.argtypes = []
        lib.resblock_chain_fused_maps_encoded.restype = ctypes.c_longlong
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
    _, bw = tile_box(h, w)
    with torch.cuda.device(device):
        err = lib.resblock_chain_fused_grid(h, w, c, bw, ctypes.byref(grid))
    if err != 0:
        _raise(lib, "grid query", err)
    return grid.value


def shared_memory_bytes() -> int:
    """Dynamic shared memory of one CTA of the kernel."""
    return _library().resblock_chain_fused_smem_bytes()


# Two zeroed words per (device, stream) for the kernel's boundary counter.
# Launches on one stream run one after the other and each leaves the words
# zeroed, so they share them; launches on different streams may overlap and
# get their own.
_SYNC_WORDS: Dict[Tuple[Optional[int], int], torch.Tensor] = {}


def _sync_words(device: torch.device, stream: int) -> torch.Tensor:
    key = (device.index, stream)
    words = _SYNC_WORDS.get(key)
    if words is None:
        words = torch.zeros(2, dtype=torch.int32, device=device)
        _SYNC_WORDS[key] = words
    return words


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
    check_kernel_args(x, weights, scales, shifts, None, c_multiple=8)
    n = weights.shape[0]
    if n < 1:
        raise ValueError("the CUDA kernel takes at least one block")
    lib = _library()
    h, w, c = x.shape
    _, bw = tile_box(h, w)
    act = torch.empty_like(x)
    hbuf = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    sync = _sync_words(x.device, stream)
    with torch.cuda.device(x.device):
        err = lib.resblock_chain_fused(
            x.data_ptr(), weights.data_ptr(), scales.data_ptr(),
            shifts.data_ptr(), act.data_ptr(), hbuf.data_ptr(),
            sync.data_ptr(), h, w, c, n, bw, stream)
    if err != 0:
        _raise(lib, "launch", err)
    fused_resblock_chain.launches += 1
    return act


fused_resblock_chain.launches = 0
