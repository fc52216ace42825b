"""Build the CUDA sources in ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` becomes ``build/torch_kernels/<name>-<hash>.so`` at
the root of the checkout, where ``<hash>`` covers the source, the shared
headers (``csrc/*.cuh``) and the flags, so an edited source or header is
rebuilt and an unchanged one is reused. The sources
have a plain C interface (no PyTorch headers), which keeps a build to
seconds. ``build_all()`` starts one nvcc per source, all at once.

Nothing here runs at import time: the host that runs the tests has no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / shared memory / spills go to the build log
]

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    return BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"


def build_all(srcs: Optional[List[Path]] = None) -> Dict[str, Path]:
    """Compile every source whose library is missing, in parallel.

    Returns {name: library path}. Raises with nvcc's output if a build fails.
    """
    srcs = sources() if srcs is None else srcs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs = {s.stem: library_path(s) for s in srcs}
    jobs = []
    for src in srcs:
        lib = libs[src.stem]
        if lib.exists():
            continue
        # Build into a private temporary name, then rename: concurrent
        # builders of the same source never see a half-written library.
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((src, lib, tmp, proc))
    failures = []
    for src, lib, tmp, proc in jobs:
        log, _ = proc.communicate()
        lib.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"{src.name}: nvcc exit {proc.returncode}\n{log}")
        else:
            os.replace(tmp, lib)
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return libs


def build_log(name: str) -> str:
    """nvcc/ptxas output of the last build of `name` (empty if reused)."""
    log = library_path(CSRC_DIR / f"{name}.cu").with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    lib = _LIBS.get(name)
    if lib is None:
        path = build_all([CSRC_DIR / f"{name}.cu"])[name]
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib


def timed_build() -> float:
    """Build every source; returns the wall seconds the build took."""
    t0 = time.perf_counter()
    build_all()
    return time.perf_counter() - t0
