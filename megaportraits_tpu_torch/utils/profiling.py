"""Tracing and profiling (counterpart of ``megaportraits_tpu/utils/profiling.py``).

  * ``trace``: a ``torch.profiler`` capture of the host and the card,
    written as a Chrome trace (open it in Perfetto or chrome://tracing),
    with the spans recorded during it beside it (``spans.json``);
  * ``annotate``: a span, the port's one recorder (below);
  * ``spans``: the spans recorded so far; ``counters``: the program's event
    counters in one snapshot;
  * ``device_memory_stats``: the card's allocator statistics under JAX's
    key names.

A span costs nothing but one check while no ``torch.profiler`` capture is
on. During a capture it is a ``record_function`` range in the trace (a
``user_annotation`` event on the trace's own clock, so the device
operations launched inside it fall under it) and a record in a bounded
buffer: its index, name, the index of its parent span, its step, and its
start and end on the ``time.time_ns()`` clock, taken inside the range (the
trace's clock: ``baseTimeNanoseconds + ts * 1000`` in the exported file).
The spans nest on one stack: a span that autograd's worker thread opens
during a backward (remat's recompute) is a child of the span around the
gradient call. ``session.step`` and ``train.step`` each open a new step;
any other span belongs to the step of the last of them opened. A span
opened outside every other span is a root; its record also holds the
change of every counter over it.

JAX's live trace server and its step timer have no counterpart here: a
capture is in process only, and a step's host time is read from its spans.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
from time import time_ns
from typing import Deque, Dict, Iterator, List

import torch

TRACE_FILE = "trace.json"
SPANS_FILE = "spans.json"
STEP_ROOTS = ("session.step", "train.step")
SPAN_LIMIT = 1 << 16  # records kept; the oldest go first

_capturing = torch._C._autograd._profiler_enabled
_NULL = contextlib.nullcontext()
_records: Deque[Dict] = collections.deque(maxlen=SPAN_LIMIT)
_open: List["_Span"] = []  # the spans open now, outermost first
_next_index = 0
_step = 0


class _Span:
    __slots__ = ("record", "range", "before")

    def __init__(self, name: str):
        self.record = {"name": name}

    def __enter__(self) -> "_Span":
        global _next_index, _step
        rec = self.record
        rec["index"] = _next_index
        _next_index += 1
        rec["parent"] = _open[-1].record["index"] if _open else None
        if rec["name"] in STEP_ROOTS:
            _step += 1
        rec["step"] = _step
        if rec["parent"] is None:
            self.before = counters()
        self.range = torch.profiler.record_function(rec["name"])
        self.range.__enter__()
        rec["start_ns"] = time_ns()
        _open.append(self)
        _records.append(rec)
        return self

    def __exit__(self, *exc) -> None:
        rec = self.record
        rec["end_ns"] = time_ns()
        self.range.__exit__(*exc)
        _open.pop()
        if rec["parent"] is None:
            after = counters()
            rec["counters"] = {k: v - self.before.get(k, 0) for k, v in after.items()}


def annotate(name: str):
    """A span: ``with annotate('g2d.trunk'): ...``. Without a capture on it
    returns one shared null context and records nothing."""
    if not _capturing():
        return _NULL
    return _Span(name)


def spans() -> List[Dict]:
    """The recorded spans, oldest first (at most ``SPAN_LIMIT``)."""
    return list(_records)


def counters() -> Dict[str, int]:
    """Every counter of the program, summed since the process started:
    ``param_casts`` (per-call casts of a parameter to the compute dtype),
    ``host_uploads`` (tensors made from host data inside a call), each
    with its sites under ``<counter>.<site>``; the kernels' ``launches.*``;
    ``folds`` (the builds of every ``OperandCache``: G2d's trunk operands,
    the ResBlock2D K1 operands)."""
    from megaportraits_tpu_torch.models.warpgen import WarpGenerator
    from megaportraits_tpu_torch.nn import layers
    from megaportraits_tpu_torch.nn.blocks import OperandCache
    from megaportraits_tpu_torch.ops import affine_grid, resize, warp
    from megaportraits_tpu_torch.ops.kernels.conv3x3 import conv3x3_bn_act
    from megaportraits_tpu_torch.ops.kernels.resblock_chain import resblock_chain
    from megaportraits_tpu_torch.ops.kernels.resblock_chain_fused import (
        fused_resblock_chain,
    )

    sites = {
        "param_casts": (layers.TorchConv, layers.WSConv, layers.TorchDense,
                        layers.AffineGroupNorm, layers.AdaptiveGroupNorm, WarpGenerator),
        "host_uploads": (warp.apply_warping_field, warp.grid_sample_2d,
                         affine_grid.affine_grid_3d, resize.anti_alias_downsample),
    }
    out = {}
    for counter, owners in sites.items():
        out[counter] = sum(getattr(o, counter) for o in owners)
        out.update((f"{counter}.{o.__name__}", getattr(o, counter)) for o in owners)
    for fn in (conv3x3_bn_act, resblock_chain, fused_resblock_chain):
        out[f"launches.{fn.__name__}"] = fn.launches
    out["folds"] = OperandCache.all_folds
    return out


@contextlib.contextmanager
def trace(log_dir: str = "runs/trace") -> Iterator[torch.profiler.profile]:
    """Profile the block, ``with trace('runs/trace'): step(...)``; the
    Chrome trace goes to ``<log_dir>/trace.json`` and the spans recorded
    during the block to ``<log_dir>/spans.json``. The card's activity is
    recorded when there is one."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    first = _next_index
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
    with open(os.path.join(log_dir, SPANS_FILE), "w") as f:
        json.dump([r for r in _records if r["index"] >= first], f)


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
