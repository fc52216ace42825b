"""Where the time goes inside the tile routine (K1, K2) and at the conv
boundary of the one-launch chain (K3), on the card.

    python -m megaportraits_tpu_torch.utils.probe_conv3x3

Builds variants of ``csrc/conv3x3_bn_act.cu`` and
``csrc/resblock_chain_fused.cu`` from edited copies of the sources (under
``build/probe/``, never the package's own files) and times the 8-block
64x64x512 chain, 16 convs queued on the device, with each.

K2 (2N dependent launches), edits of the tile routine:

  as it is      the kernel as the package builds it
  loads only    the consumers wait for every buffer and release it, but
                run no wgmma: the TMA side alone
  wgmma only    the producers load nothing and the consumers wait for
                nothing: the tensor-core side alone (results are garbage)
  half weights  one 64-channel half of every weight box is loaded (results
                are garbage): does the time follow the bytes?
  rings         other depths of the weight ring and of the haloed-box ring
  padded        32 KB more shared memory a CTA, never touched: does the
                footprint alone cost time?

K3 (one launch), edits of the chain kernel:

  as it is            the kernel as the package builds it: one counter for
                      the grid, a tile waits for the whole conv before it
  a counter a box     per-tile dependencies: a tile waits only for the pixel
                      boxes around it, at all channel tiles (same results)
  no boundary         no CTA waits for another (results are garbage): the
                      persistent tile routine with its arrivals alone
  boundary only       the tiles' loads, products and stores are left out:
                      the arrivals, the waits and the loop around them alone
  no boundary, no arrival   neither waits nor arrivals; the same with loads
                      only and with wgmma only, as for K2
  arrival without fences    a relaxed add and no proxy fence (unsafe): what
                      the arrival's ordering costs
  full proxy fences   fence.proxy.async for all state spaces at the arrival
                      and after the wait, where the kernel's name global
                      memory alone
  not cooperative     the same grid in an ordinary launch
  plain row test      the epilogue's warp vote replaced by a plain `if`: the
                      compiler then keeps the K loop off the uniform
                      registers and the wgmma of a step apart
  weights wait too    the weights' producer waits as the pixels' does: what
                      streaming weights across the boundary buys
  residual by TMA     the block's residual is loaded for every conv2 tile
                      and not kept in shared memory

``utils/probe_timeline.py`` records when one CTA passes each stage.

An edit that no longer finds its place in the source raises, so the script
cannot silently time the wrong thing. Times are CUDA-event medians of 5
samples of 5 chains each, after 3 warm-ups, in two rounds.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess

import torch

from megaportraits_tpu_torch.ops.kernels import build

PROBE_DIR = build.BUILD_DIR.parent / "probe"
HEADERS = ("conv3x3_wgmma.cuh", "conv3x3_maps.cuh")
K2_SOURCE = "conv3x3_bn_act.cu"
K3_SOURCE = "resblock_chain_fused.cu"
N_BLOCKS = 8


def _edit(source: str, old: str, new: str) -> str:
    if source.count(old) != 1:
        raise RuntimeError(f"probe edit found {source.count(old)} places for:\n{old}")
    return source.replace(old, new)


def _same(text: str) -> str:
    return text


# ---- edits of the tile routine (conv3x3_wgmma.cuh) ------------------------

def _loads_only(hdr: str) -> str:
    hdr = _edit(hdr, '    asm volatile("wgmma.fence.sync.aligned;\\n" ::: "memory");\n',
                "#if 0\n")
    return _edit(hdr, '    asm volatile("wgmma.wait_group.sync.aligned 1;\\n" ::: "memory");\n',
                 "#endif\n")


def _wgmma_only(hdr: str) -> str:
    hdr = _edit(hdr, "    if (warp == 0 && lane == 0) {\n      // The weights' producer",
                "    if (false) {\n      // The weights' producer")
    hdr = _edit(hdr, "    } else if (warp == 1 && lane == 0) {", "    } else if (false) {")
    return _consumers_wait_for_nothing(hdr)


def _consumers_wait_for_nothing(hdr: str) -> str:
    hdr = _edit(hdr, "    if (lane == 0) {\n      if (k.a_first(i))",
                "    if (false) {\n      if (k.a_first(i))")
    hdr = _edit(hdr, "    if (i > 0 && lane == 0) {\n      mbar_arrive(sm.b_empty",
                "    if (false) {\n      mbar_arrive(sm.b_empty")
    return _edit(hdr, "    if (add_residual && residual_parity >= 0)\n"
                      "      mbar_wait(sm.res_full(e), residual_parity);\n", "")


def _half_weights(hdr: str) -> str:
    hdr = _edit(hdr, "  mbar_expect_tx(sm.b_full(s), t.n_halves * B_HALF_BYTES);",
                "  mbar_expect_tx(sm.b_full(s), B_HALF_BYTES);")
    return _edit(hdr, "  for (int h = 0; h < t.n_halves; ++h)\n    tma_load_3d(sm.b_base",
                 "  for (int h = 0; h < 1; ++h)\n    tma_load_3d(sm.b_base")


def _rings(a_halo: int, b: int):
    def edit(hdr: str) -> str:
        hdr = _edit(hdr, "constexpr int A_HALO_STAGES = 2;",
                    f"constexpr int A_HALO_STAGES = {a_halo};")
        return _edit(hdr, "constexpr int B_STAGES = 4;", f"constexpr int B_STAGES = {b};")
    return edit


def _plain_row_test(hdr: str) -> str:
    return _edit(hdr, "  if (__all_sync(0xffffffffu, row_y < p.H)) {", "  if (row_y < p.H) {")


def _padded(extra_bytes: int):
    def edit(hdr: str) -> str:
        return _edit(hdr, "constexpr int BAR_BYTES = 256;",
                     f"constexpr int BAR_BYTES = 256 + {extra_bytes};")
    return edit


# ---- edits of the chain kernel (resblock_chain_fused.cu) ------------------

_PIXELS_WAIT = "        if (k > 0) boundary_wait(cp.sync, 2u * grid * k);\n"
_ARRIVE = "      if (storing_thread && k + 1 < n_convs) boundary_arrive(cp.sync);\n"


def _no_boundary(cu: str) -> str:
    return _edit(cu, _PIXELS_WAIT, "")


def _boundary_only(cu: str) -> str:
    cu = _no_loads(cu)
    cu = _edit(cu, "        multiply_tile(sm, t, g, lane, acc, na, nb);\n", "")
    return _edit(cu, "        finish_tile(sm, e, map_out, t, p, !conv1, parity, g, warp, lane, acc);\n",
                 "")


def _no_boundary_no_arrive(cu: str) -> str:
    return _edit(_no_boundary(cu), _ARRIVE, "")


def _arrive_without_fences(cu: str) -> str:
    cu = _edit(cu, '  asm volatile("fence.proxy.async.global;\\n" ::: "memory");\n'
                   '  asm volatile("red.release', '  asm volatile("red.release')
    return _edit(cu, "red.release.gpu.global.add.u32", "red.relaxed.gpu.global.add.u32")


def _full_proxy_fences(cu: str) -> str:
    if cu.count("fence.proxy.async.global;") != 2:
        raise RuntimeError("probe edit: proxy fences")
    return cu.replace("fence.proxy.async.global;", "fence.proxy.async;")


def _no_loads(cu: str) -> str:
    cu = _edit(cu, "            load_weights(sm, &map_w, t, i, nb++, 9 * k);\n", "            ;\n")
    cu = _edit(cu, "          if (residual_by_tma) {\n            // The tile two before",
               "          if (false) {\n            // The tile two before")
    return _edit(cu, "            if (t.k.a_first(i)) load_pixels(sm, map_in, t, i, na++);\n",
                 "            ;\n")


def _k3_wgmma_only(cu: str) -> str:
    return _no_loads(_no_boundary_no_arrive(cu))


def _not_cooperative(cu: str) -> str:
    return _edit(cu, "  config.numAttrs = 1;", "  config.numAttrs = 0;")


def _weights_wait_too(cu: str) -> str:
    return _edit(cu, "      for (int k = 0; k < n_convs; ++k) {\n"
                     "        for (int ti = blockIdx.x; ti < tiles; ti += grid) {\n",
                 "      for (int k = 0; k < n_convs; ++k) {\n" + _PIXELS_WAIT +
                 "        for (int ti = blockIdx.x; ti < tiles; ti += grid) {\n")


# Waits for the pixel boxes around `box`, one counter each at arrivals[box].
_WAIT_FOR_BOXES = """
__device__ __forceinline__ void wait_for_boxes(const unsigned int* arrivals,
                                               int box, int boxes_x,
                                               int boxes_y,
                                               unsigned int target) {
  const int by = box / boxes_x, bx = box % boxes_x;
  for (int ny = max(by - 1, 0); ny <= min(by + 1, boxes_y - 1); ++ny)
    for (int nx = max(bx - 1, 0); nx <= min(bx + 1, boxes_x - 1); ++nx)
      boundary_wait(arrivals + ny * boxes_x + nx, target);
}

__global__ void __launch_bounds__(THREADS, 1) resblock_chain_fused_kernel("""


def _counter_a_box(cu: str) -> str:
    """Per-tile dependencies in place of the grid-wide counter: a consumer
    warpgroup adds to the counter of its tile's pixel box (sync[2 + box])
    after each tile, and the pixels' producer waits, before each tile, for
    the boxes around it at all channel tiles."""
    cu = _edit(cu, "\n__global__ void __launch_bounds__(THREADS, 1) "
                   "resblock_chain_fused_kernel(", _WAIT_FOR_BOXES)
    cu = _edit(cu, _PIXELS_WAIT, "")
    cu = _edit(cu, "          const Tile t(p, ti % boxes, ti / boxes);\n"
                   "          if (residual_by_tma) {\n",
               "          const Tile t(p, ti % boxes, ti / boxes);\n"
               "          if (k > 0)\n"
               "            wait_for_boxes(cp.sync + 2, ti % boxes, (cp.W + cp.bw - 1) / cp.bw,\n"
               "                           (cp.H + cp.bh - 1) / cp.bh, 2u * (tiles / boxes) * k);\n"
               "          if (residual_by_tma) {\n")
    cu = _edit(cu, _ARRIVE, "")
    cu = _edit(cu, "        if (storing_thread) mbar_arrive(sm.epi_free(e));\n",
               "        if (storing_thread) mbar_arrive(sm.epi_free(e));\n"
               "        if (storing_thread && k + 1 < n_convs)\n"
               "          boundary_arrive(cp.sync + 2 + ti % boxes);\n")
    return _edit(cu, "        cp.sync[0] = 0;\n        cp.sync[1] = 0;\n",
                 "        for (int b = 0; b < 2 + boxes; ++b) cp.sync[b] = 0;\n")


def _residual_by_tma(cu: str) -> str:
    return _edit(cu, "  const bool keep_residual = grid == tiles;",
                 "  const bool keep_residual = false;")


# (name, source, edit of the tile routine, edit of the source, whether the
# variant must still compute the chain: its result is then held against the
# first such variant's, bit for bit)
VARIANTS = [
    ("K2 as it is", K2_SOURCE, _same, _same, True),
    ("K2 loads only", K2_SOURCE, _loads_only, _same, False),
    ("K2 wgmma only", K2_SOURCE, _wgmma_only, _same, False),
    ("K2 half weights", K2_SOURCE, _half_weights, _same, False),
    ("K2 rings: 2 haloed boxes, 6 weight boxes", K2_SOURCE, _rings(2, 6), _same, True),
    ("K2 rings: 3 haloed boxes, 4 weight boxes", K2_SOURCE, _rings(3, 4), _same, True),
    ("K2 with 32 KB of shared memory unused", K2_SOURCE, _padded(32768), _same, True),
    ("K3 as it is", K3_SOURCE, _same, _same, True),
    ("K3 no boundary", K3_SOURCE, _same, _no_boundary, False),
    ("K3 boundary only", K3_SOURCE, _same, _boundary_only, False),
    ("K3 no boundary, no arrival", K3_SOURCE, _same, _no_boundary_no_arrive, False),
    ("K3 no boundary, no arrival, loads only", K3_SOURCE, _loads_only, _no_boundary_no_arrive, False),
    ("K3 no boundary, no arrival, wgmma only", K3_SOURCE, _consumers_wait_for_nothing, _k3_wgmma_only, False),
    ("K3 arrival without fences", K3_SOURCE, _same, _arrive_without_fences, False),
    ("K3 full proxy fences", K3_SOURCE, _same, _full_proxy_fences, True),
    ("K3 not cooperative", K3_SOURCE, _same, _not_cooperative, True),
    ("K3 plain row test in the epilogue", K3_SOURCE, _plain_row_test, _same, True),
    ("K3 weights wait too", K3_SOURCE, _same, _weights_wait_too, True),
    ("K3 residual by TMA", K3_SOURCE, _same, _residual_by_tma, True),
    ("K3 a counter a pixel box", K3_SOURCE, _same, _counter_a_box, True),
]


def build_variants(names=None):
    """Builds the named variants (all by default), one nvcc each, all at
    once. Returns {name: (source, library)}."""
    texts = {name: (build.CSRC_DIR / name).read_text()
             for name in HEADERS + (K2_SOURCE, K3_SOURCE)}
    jobs = []
    for i, (name, source, edit_hdr, edit_cu, _) in enumerate(VARIANTS):
        if names is not None and name not in names:
            continue
        d = PROBE_DIR / f"v{i}"
        d.mkdir(parents=True, exist_ok=True)
        (d / HEADERS[0]).write_text(edit_hdr(texts[HEADERS[0]]))
        (d / HEADERS[1]).write_text(texts[HEADERS[1]])
        (d / source).write_text(edit_cu(texts[source]))
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(d / "lib.so"),
               str(d / source)]
        jobs.append((name, source, d / "lib.so", subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, source, path, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc exit {proc.returncode}\n{log}")
        libs[name] = (source, bind(ctypes.CDLL(str(path)), source))
    return libs


def bind(lib, source):
    """Sets the argument types of a variant's chain entry point."""
    if source == K2_SOURCE:
        lib.resblock_chain.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
            + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
        lib.resblock_chain.restype = ctypes.c_int
    else:
        lib.resblock_chain_fused.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        lib.resblock_chain_fused.restype = ctypes.c_int
    return lib


def chain_runner():
    """(chain, sync, result): `chain(source, lib)` enqueues the 8-block
    64x64x512 chain through a variant's library on seeded inputs; `sync`
    holds K3's boundary words; `result(source)` is where the last chain of
    that source left its output."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    h = w = 64
    c, n = 512, N_BLOCKS
    x = torch.randn(h, w, c, device=dev, generator=gen).bfloat16()
    wts = (torch.randn(n, 2, 3, 3, c, c, device=dev, generator=gen)
           / (9 * c) ** 0.5).bfloat16()
    scs = torch.rand(n, 2, c, device=dev, generator=gen) * 0.2 + 0.4
    shs = torch.randn(n, 2, c, device=dev, generator=gen) * 0.05
    hbuf, buf0, buf1 = (torch.empty_like(x) for _ in range(3))
    sync = torch.zeros(2 + 32, dtype=torch.int32, device=dev)  # 32 pixel boxes
    stream = torch.cuda.current_stream().cuda_stream

    def chain(source, lib):
        if source == K2_SOURCE:
            launched = ctypes.c_int(0)
            err = lib.resblock_chain(
                x.data_ptr(), wts.data_ptr(), scs.data_ptr(), shs.data_ptr(),
                hbuf.data_ptr(), buf0.data_ptr(), buf1.data_ptr(), h, w, c, n, 64,
                1, stream, ctypes.byref(launched))
        else:
            err = lib.resblock_chain_fused(
                x.data_ptr(), wts.data_ptr(), scs.data_ptr(), shs.data_ptr(),
                buf0.data_ptr(), hbuf.data_ptr(), sync.data_ptr(), h, w, c, n, 64,
                stream)
        if err != 0:
            raise RuntimeError(f"launch failed: {err}")

    def result(source):
        return buf1 if source == K2_SOURCE and n % 2 == 0 else buf0

    return chain, sync, result


def time_variants(names=None, rounds=2, report=None):
    """Builds the named variants (all by default) and times the 8-block
    64x64x512 chain with each, `rounds` times in turns. Returns
    {name: [ms, ...]}; `report(name, ms)` is called after each timing."""
    libs = build_variants(names)
    chain, sync, result = chain_runner()
    exact = {name for name, _, _, _, is_exact in VARIANTS if is_exact}
    reference = None

    def time_ms(source, lib, reps=5):
        for _ in range(3):
            chain(source, lib)
        samples = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(1_000_000)  # the host enqueues meanwhile
            sync.zero_()  # a variant without waits may leave the words dirty
            start.record()
            for _ in range(reps):
                chain(source, lib)
            end.record()
            torch.cuda.synchronize()
            samples.append(start.elapsed_time(end) / reps)
        return statistics.median(samples)

    times = {name: [] for name in libs}
    for _ in range(rounds):
        for name, (source, lib) in libs.items():
            ms = time_ms(source, lib)
            times[name].append(ms)
            if name in exact:
                if reference is None:
                    reference = result(source).clone()
                elif not torch.equal(result(source), reference):
                    raise RuntimeError(f"{name}: the chain's result differs")
            if report is not None:
                report(name, ms)
    return times


def main():
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    time_variants(report=lambda name, ms: print(
        f"{name:42s} chain {ms:.4f} ms = {ms / (2 * N_BLOCKS) * 1e3:.1f} us a conv",
        flush=True))


if __name__ == "__main__":
    main()
