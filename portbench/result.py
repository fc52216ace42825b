"""What every generator does once its window has closed: free the card for
the reference, and pack the result line's metrics."""

from __future__ import annotations

import gc
import statistics
from types import SimpleNamespace
from typing import Dict, Optional, Tuple

import torch


def free_card(on_card: bool) -> None:
    """Give the freed program's memory back before the reference runs, and
    keep TF32 off for it."""
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def traced_step_times(step_s, tracer) -> str:
    """The median step of the window's untraced steps and of each traced
    phase: what the profiler adds to a step."""
    a, n = tracer.first, tracer.steps
    parts = {"untraced": step_s[:a] + step_s[tracer.last:],
             "device phase": step_s[a:a + n], "layer phase": step_s[a + n:tracer.last]}
    return "step ms, median: " + ", ".join(
        f"{k} {statistics.median(v) * 1e3:.2f}" for k, v in parts.items() if v)


def pack(out: Dict, bench: Optional[Dict], tracer, e2e: Dict[str, Tuple[float, str]],
         **context) -> Dict:
    """`out` with its metrics: the cell's per-layer metrics read from the
    tracer's trace (with the device's busy and window seconds and the
    breakdown) where the run was traced, its end-to-end metrics `e2e`
    ({name: (value, unit)}) otherwise. `context` goes to the readers."""
    bench = bench or {}
    if tracer is not None:
        from portbench.trace import read_metrics, traced_record

        ctx = SimpleNamespace(trace=tracer.device_trace(), layers=tracer.layer_trace(),
                              **context)
        out["metrics"] = read_metrics(bench.get("per_layer", []), ctx)
        out["device_extra"], out["breakdown"] = traced_record(ctx.trace, ctx.layers)
    else:
        wanted = [m["name"] for m in bench.get("end_to_end", [])] or list(e2e)
        out["metrics"] = {k: {"value": e2e[k][0], "unit": e2e[k][1]} for k in wanted}
    return out
