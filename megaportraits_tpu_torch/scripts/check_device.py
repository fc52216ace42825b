"""Device check (counterpart of ``scripts/check_device.py``, which prints
JAX's backend and devices):

    python -m megaportraits_tpu_torch.scripts.check_device

Prints the backend and its devices as the JAX script does. With a card it
also prints each card's name, compute capability and power limit (from
``torch.cuda`` and ``nvidia-smi``), then builds the CUDA sources of K1, K2
and K3 (``ops/kernels/build.py``) and says whether each builds and loads;
it exits 1 if one does not. Without a card it says so and exits 0.
"""

from __future__ import annotations

import subprocess
import time
from typing import List, Optional, Sequence

import torch

from megaportraits_tpu_torch.ops.kernels import build

# Each TPU kernel's port: (id, CUDA source in csrc/).
KERNELS = (("K1 fused_conv3x3", "conv3x3_bn_act"),
           ("K2 fused_resblock_chain_v2", "conv3x3_bn_act"),
           ("K3 fused_resblock_chain", "resblock_chain_fused"))


def power_limits() -> List[str]:
    """``nvidia-smi``'s power limit of each card, or why there is none."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return [f"unknown ({e.__class__.__name__})"] * torch.cuda.device_count()
    lines = [line.strip() for line in out.stdout.splitlines() if line.strip()]
    return lines or [f"unknown (nvidia-smi exit {out.returncode})"] * torch.cuda.device_count()


def build_kernels() -> bool:
    """Build and load each kernel's source once; print one line a kernel.
    True if every one built."""
    results = {}
    for name in dict.fromkeys(src for _, src in KERNELS):
        t0 = time.perf_counter()
        try:
            build.load_library(name)
            results[name] = f"builds ({time.perf_counter() - t0:.1f}s)"
        except Exception as e:  # nvcc missing or failing, or the library not loading
            results[name] = f"FAILED: {str(e).splitlines()[0] if str(e) else type(e).__name__}"
    for kernel, src in KERNELS:
        print(f"{kernel} (csrc/{src}.cu): {results[src]}")
    return all(r.startswith("builds") for r in results.values())


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    if not torch.cuda.is_available():
        print("backend: cpu, devices: 1")
        print("[device(type='cpu')]")
        print("no CUDA card: the kernels K1, K2 and K3 are not built")
        return 0
    n = torch.cuda.device_count()
    print(f"backend: cuda, devices: {n}")
    print([torch.device("cuda", i) for i in range(n)])
    for i, limit in zip(range(n), power_limits()):
        major, minor = torch.cuda.get_device_capability(i)
        print(f"cuda:{i}: {torch.cuda.get_device_name(i)}, compute capability "
              f"{major}.{minor}, power limit {limit}")
    return 0 if build_kernels() else 1


if __name__ == "__main__":
    raise SystemExit(main())
