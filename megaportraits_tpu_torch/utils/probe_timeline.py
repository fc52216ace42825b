"""When one CTA passes each stage of a conv, inside K2's launches and inside
K3's one launch, on the card.

    python -m megaportraits_tpu_torch.utils.probe_timeline

Builds instrumented copies of the kernel sources (under
``build/probe/timeline``, never the package's own files): one CTA reads the
card's nanosecond timer where its consumer warpgroup starts and ends a
tile's K loop and has stored the tile, where K3's arrival is made and where
the pixels' producer passes the boundary. Nothing is added inside the K
loop, where an `if` on the thread index changes the code the compiler makes.

Printed for one 8-block 64x64x512 chain of each kernel: the mean
microseconds a conv spends in its K loop, from the K loop's end to the
tile's store, and from there to the next K loop's start (negative for K2,
whose next launch begins under the tail of the one before).
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess

import numpy as np
import torch

from megaportraits_tpu_torch.ops.kernels import build
from megaportraits_tpu_torch.utils.probe_conv3x3 import (
    HEADERS,
    K2_SOURCE,
    K3_SOURCE,
    N_BLOCKS,
    PROBE_DIR,
    _ARRIVE,
    _PIXELS_WAIT,
    _edit,
    bind,
    chain_runner,
)

EVENTS = 4096
LOOP_START, LOOP_END, STORED, ARRIVED, PASSED = 1, 2, 3, 4, 5
# The recording CTA: pixel box 5 at channel tile 1 (K1's grid is 32 x 4,
# K3's is flat).
_RECORDER = f'''
__device__ unsigned long long g_events[{EVENTS}];
__device__ unsigned int g_event_count;
__device__ __forceinline__ bool recording() {{
  return gridDim.y > 1 ? blockIdx.x == 5 && blockIdx.y == 1 : blockIdx.x == 37;
}}
__device__ __forceinline__ void record(int tag) {{
  if (!recording()) return;
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  const unsigned int i = atomicAdd(&g_event_count, 1u);
  if (i < {EVENTS}) g_events[i] = (t << 8) | static_cast<unsigned long long>(tag);
}}
'''

_READ_BACK = f'''
extern "C" void timeline_read(unsigned long long* events, unsigned int* count) {{
  cudaDeviceSynchronize();
  cudaMemcpyFromSymbol(count, conv3x3_wgmma::g_event_count, 4);
  cudaMemcpyFromSymbol(events, conv3x3_wgmma::g_events, {EVENTS} * 8);
  const unsigned int zero = 0;
  cudaMemcpyToSymbol(conv3x3_wgmma::g_event_count, &zero, 4);
}}
'''


def instrument_header(hdr: str) -> str:
    hdr = _edit(hdr, "namespace conv3x3_wgmma {\n",
                "namespace conv3x3_wgmma {\n" + _RECORDER)
    # K1's single tile.
    hdr = _edit(hdr, "    multiply_tile(sm, t, g, lane, acc, na, nb);\n",
                f"    if (tid == 128) record({LOOP_START});\n"
                "    multiply_tile(sm, t, g, lane, acc, na, nb);\n"
                f"    if (tid == 128) record({LOOP_END});\n")
    return _edit(hdr, "                acc);\n  }\n}\n\n}  // namespace conv3x3_wgmma",
                 f"                acc);\n    if (tid == 128) record({STORED});\n"
                 "  }\n}\n\n}  // namespace conv3x3_wgmma")


def instrument_k3(cu: str) -> str:
    cu = _edit(cu, "        multiply_tile(sm, t, g, lane, acc, na, nb);\n",
               f"        if (tid == 128) record({LOOP_START});\n"
               "        multiply_tile(sm, t, g, lane, acc, na, nb);\n"
               f"        if (tid == 128) record({LOOP_END});\n")
    cu = _edit(cu, "        if (storing_thread) mbar_arrive(sm.epi_free(e));\n",
               "        if (storing_thread) mbar_arrive(sm.epi_free(e));\n"
               f"        if (tid == 128) record({STORED});\n")
    cu = _edit(cu, _ARRIVE, _ARRIVE + f"      if (tid == 128) record({ARRIVED});\n")
    return _edit(cu, _PIXELS_WAIT, _PIXELS_WAIT + f"        record({PASSED});\n") + _READ_BACK


def build_instrumented():
    texts = {name: (build.CSRC_DIR / name).read_text()
             for name in HEADERS + (K2_SOURCE, K3_SOURCE)}
    d = PROBE_DIR / "timeline"
    d.mkdir(parents=True, exist_ok=True)
    (d / HEADERS[0]).write_text(instrument_header(texts[HEADERS[0]]))
    (d / HEADERS[1]).write_text(texts[HEADERS[1]])
    (d / K2_SOURCE).write_text(texts[K2_SOURCE] + _READ_BACK)
    (d / K3_SOURCE).write_text(instrument_k3(texts[K3_SOURCE]))
    jobs = [(src, subprocess.Popen(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(d / f"{src}.so"), str(d / src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for src in (K2_SOURCE, K3_SOURCE)]
    libs = {}
    for src, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{src}: nvcc exit {proc.returncode}\n{log}")
        lib = bind(ctypes.CDLL(str(d / f"{src}.so")), src)
        lib.timeline_read.argtypes = [ctypes.c_void_p] * 2
        lib.timeline_read.restype = None
        libs[src] = lib
    return libs


def read_timeline(lib):
    """[(microseconds, tag), ...] in time order."""
    events = np.zeros(EVENTS, np.uint64)
    count = np.zeros(1, np.uint32)
    lib.timeline_read(events.ctypes.data, count.ctypes.data)
    stamped = sorted((int(v) >> 8, int(v) & 255) for v in events[:int(count[0])])
    return [(t / 1e3, tag) for t, tag in stamped]


def main():
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    libs = build_instrumented()
    chain, _, _ = chain_runner()
    n_convs = 2 * N_BLOCKS
    for name, source in (("K2", K2_SOURCE), ("K3", K3_SOURCE)):
        lib = libs[source]
        for _ in range(3):
            chain(source, lib)
        read_timeline(lib)  # drop the warm-up's events
        torch.cuda._sleep(2_000_000)
        chain(source, lib)
        events = read_timeline(lib)
        at = {tag: [t for t, g in events if g == tag]
              for tag in (LOOP_START, LOOP_END, STORED, ARRIVED, PASSED)}
        if not len(at[LOOP_START]) == len(at[LOOP_END]) == len(at[STORED]) == n_convs:
            raise RuntimeError(f"{name}: {len(events)} events, expected {n_convs} convs")

        def mean_gap(later, earlier):
            return statistics.mean(b - a for a, b in zip(earlier, later))

        print(f"{name}: one CTA over {n_convs} convs, "
              f"{at[STORED][-1] - at[LOOP_START][0]:.1f} us from its first K loop "
              f"to its last store; a conv spends {mean_gap(at[LOOP_END], at[LOOP_START]):.2f} "
              f"us in the K loop, {mean_gap(at[STORED], at[LOOP_END]):.2f} us from "
              f"there to its tile stored, "
              f"{mean_gap(at[LOOP_START][1:], at[STORED][:-1]):.2f} us from there to "
              f"the next K loop's start")
        if at[ARRIVED]:
            print(f"    of that, {mean_gap(at[ARRIVED], at[STORED]):.2f} us to its "
                  f"arrival at the boundary and "
                  f"{mean_gap(at[PASSED][1:], at[ARRIVED][:-1]):.2f} us more "
                  f"until the pixels' producer has passed it")


if __name__ == "__main__":
    main()
