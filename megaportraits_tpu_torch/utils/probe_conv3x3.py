"""Where K1's time goes inside the tile routine, on the card.

    python -m megaportraits_tpu_torch.utils.probe_conv3x3

Builds variants of ``csrc/conv3x3_bn_act.cu`` from edited copies of the two
sources (under ``build/probe/``, never the package's own files) and times
the 8-block 64x64x512 chain, 16 convs queued on the device, with each:

  as it is      the kernel as the package builds it
  loads only    the consumers wait for every buffer and release it, but
                run no wgmma: the TMA side alone
  wgmma only    the producers load nothing and the consumers wait for
                nothing: the tensor-core side alone (results are garbage)
  half weights  one 64-channel half of every weight box is loaded (results
                are garbage): does the time follow the bytes?
  rings         other depths of the weight ring and of the haloed-box ring

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


def _edit(source: str, old: str, new: str) -> str:
    if source.count(old) != 1:
        raise RuntimeError(f"probe edit found {source.count(old)} places for:\n{old}")
    return source.replace(old, new)


def _loads_only(hdr: str) -> str:
    hdr = _edit(hdr, '      asm volatile("wgmma.fence.sync.aligned;\\n" ::: "memory");\n',
                "#if 0\n")
    return _edit(hdr, '      asm volatile("wgmma.wait_group.sync.aligned 1;\\n" ::: "memory");\n',
                 "#endif\n")


def _wgmma_only(hdr: str) -> str:
    hdr = _edit(hdr, "    if (warp == 0 && lane == 0) {\n      // The weights' producer",
                "    if (false) {\n      // The weights' producer")
    hdr = _edit(hdr, "    } else if (warp == 1 && lane == 0) {", "    } else if (false) {")
    hdr = _edit(hdr, "      if (lane == 0) {\n        if (k.a_first(i))",
                "      if (false) {\n        if (k.a_first(i))")
    hdr = _edit(hdr, "      if (i > 0 && lane == 0) {\n        mbar_arrive(b_empty",
                "      if (false) {\n        mbar_arrive(b_empty")
    return _edit(hdr, "      if (p.has_residual) mbar_wait(res_bar, 0);", "")


def _half_weights(hdr: str) -> str:
    hdr = _edit(hdr, "      const uint32_t b_bytes = n_halves * B_HALF_BYTES;",
                "      const uint32_t b_bytes = B_HALF_BYTES;")
    return _edit(hdr, "        for (int h = 0; h < n_halves; ++h)\n          tma_load_3d(b_base",
                 "        for (int h = 0; h < 1; ++h)\n          tma_load_3d(b_base")


def _rings(a_halo: int, b: int):
    def edit(hdr: str) -> str:
        hdr = _edit(hdr, "constexpr int A_HALO_STAGES = 2;",
                    f"constexpr int A_HALO_STAGES = {a_halo};")
        return _edit(hdr, "constexpr int B_STAGES = 4;", f"constexpr int B_STAGES = {b};")
    return edit


VARIANTS = [("as it is", lambda hdr: hdr), ("loads only", _loads_only),
            ("wgmma only", _wgmma_only), ("half weights", _half_weights),
            ("rings: 2 haloed boxes, 6 weight boxes", _rings(2, 6)),
            ("rings: 3 haloed boxes, 4 weight boxes", _rings(3, 4))]


def build_variants():
    hdr = (build.CSRC_DIR / "conv3x3_wgmma.cuh").read_text()
    cu = (build.CSRC_DIR / "conv3x3_bn_act.cu").read_text()
    jobs = []
    for i, (name, edit) in enumerate(VARIANTS):
        d = PROBE_DIR / f"v{i}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "conv3x3_wgmma.cuh").write_text(edit(hdr))
        (d / "conv3x3_bn_act.cu").write_text(cu)
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(d / "lib.so"),
               str(d / "conv3x3_bn_act.cu")]
        jobs.append((name, d / "lib.so", subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, path, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc exit {proc.returncode}\n{log}")
        lib = ctypes.CDLL(str(path))
        lib.resblock_chain.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
            + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
        lib.resblock_chain.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main():
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    libs = build_variants()

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    h = w = 64
    c, n = 512, 8
    x = torch.randn(h, w, c, device=dev, generator=gen).bfloat16()
    wts = (torch.randn(n, 2, 3, 3, c, c, device=dev, generator=gen)
           / (9 * c) ** 0.5).bfloat16()
    scs = torch.rand(n, 2, c, device=dev, generator=gen) * 0.2 + 0.4
    shs = torch.randn(n, 2, c, device=dev, generator=gen) * 0.05
    hbuf, buf0, buf1 = (torch.empty_like(x) for _ in range(3))
    stream = torch.cuda.current_stream().cuda_stream

    def chain(lib):
        launched = ctypes.c_int(0)
        err = lib.resblock_chain(
            x.data_ptr(), wts.data_ptr(), scs.data_ptr(), shs.data_ptr(),
            hbuf.data_ptr(), buf0.data_ptr(), buf1.data_ptr(), h, w, c, n, 64, 1,
            stream, ctypes.byref(launched))
        if err != 0:
            raise RuntimeError(f"launch failed: {err}")

    def time_ms(lib, reps=5):
        for _ in range(3):
            chain(lib)
        samples = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(1_000_000)  # the host enqueues meanwhile
            start.record()
            for _ in range(reps):
                chain(lib)
            end.record()
            torch.cuda.synchronize()
            samples.append(start.elapsed_time(end) / reps)
        return statistics.median(samples)

    for _ in range(2):
        for name, lib in libs.items():
            ms = time_ms(lib)
            print(f"{name:40s} chain {ms:.4f} ms = {ms / (2 * n) * 1e3:.1f} us a conv")


if __name__ == "__main__":
    main()
