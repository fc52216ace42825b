"""Tracing and profiling (counterpart of ``megaportraits_tpu/utils/profiling.py``).

  * ``trace``: a ``torch.profiler`` capture of the host and the card,
    written as a Chrome trace (open it in Perfetto or chrome://tracing);
  * ``device_memory_stats``: the card's allocator statistics under JAX's
    key names;
  * ``StepTimer``: steps per second after a warm-up, as in JAX;
  * ``annotate``: a named range in the trace (``record_function``).
JAX's live trace server (``start_server``) has no PyTorch counterpart:
``torch.profiler`` captures in process only. The port's ``start_server``
raises with that reason.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str = "runs/trace") -> Iterator[torch.profiler.profile]:
    """Profile the block, ``with trace('runs/trace'): step(...)``; the
    Chrome trace goes to ``<log_dir>/trace.json``. The card's activity is
    recorded when there is one."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def start_server(port: int = 9999):
    """JAX's live-capture profiler server; PyTorch has none."""
    raise NotImplementedError(
        f"no live trace server on port {port}: torch.profiler captures only in "
        f"process; wrap the steps in utils.profiling.trace instead")


def device_memory_stats(device=None) -> Dict[str, int]:
    """The card's allocator statistics in bytes (``bytes_in_use``,
    ``peak_bytes_in_use``, ``bytes_limit``); empty without a card or for
    a CPU device, as JAX's is where its device has none."""
    if not torch.cuda.is_available():
        return {}
    device = torch.device("cuda") if device is None else torch.device(device)
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    return {"bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(device).total_memory}


class StepTimer:
    """Wall-clock it/s with warmup skip (the first `warmup` ticks)."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self._count = 0
        self._start: Optional[float] = None

    def tick(self) -> Optional[float]:
        self._count += 1
        if self._count == self.warmup:
            self._start = time.perf_counter()
            return None
        if self._start is None or self._count <= self.warmup:
            return None
        return (self._count - self.warmup) / (time.perf_counter() - self._start)


def annotate(name: str):
    """A named range in the trace: ``with annotate('g2d'): ...``."""
    return torch.profiler.record_function(name)
