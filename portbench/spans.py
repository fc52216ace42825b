"""The port's own spans (``megaportraits_tpu_torch/utils/profiling.py``) as
the readers in ``metrics/`` take them: the records of the traced run's
steps, grouped by step.

The program records a span only while a profiler captures, so its buffer
holds the steps of the traced phases (after those of any traced run made
before in the same process). Of the last ``2 x traced_steps`` steps
recorded, the first half are the device phase's, where the profiler does
not record the host, and the readers take those; where the program
recorded no span in the device phase, they take the layer phase's. A
program that records no spans (one older than them) gives None, and its
readers report nothing.
"""

from __future__ import annotations

from typing import Dict, List, Optional


def traced_steps(ctx) -> int:
    """Steps a phase of the traced run profiles: a training cell's
    ``steps``, a serving cell's frames over its batch."""
    steps = getattr(ctx, "steps", None)
    return steps if steps is not None else ctx.frames // ctx.batch


def steps(ctx) -> Optional[List[List[Dict]]]:
    """The spans of each step of one traced phase, oldest step first; None
    where the program recorded none."""
    try:
        from megaportraits_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    n = traced_steps(ctx)
    if read is None or not n:
        return None
    by_step: Dict[int, List[Dict]] = {}
    for rec in read():
        if "end_ns" in rec:
            by_step.setdefault(rec["step"], []).append(rec)
    ids = sorted(by_step)[-2 * n:]
    if len(ids) == 2 * n:
        ids = ids[:n]
    return [by_step[i] for i in ids] or None


def roots(step: List[Dict]) -> List[Dict]:
    """The spans of a step opened outside every other span: ``session.step``
    (and ``genh.forward`` after it where Genh serves), ``train.step``."""
    return [r for r in step if r["parent"] is None]


def host_ms_per_step(ctx) -> Optional[float]:
    """The host's milliseconds in a step's root spans, the mean over the
    phase's steps."""
    got = steps(ctx)
    if not got:
        return None
    return sum((r["end_ns"] - r["start_ns"]) * 1e-6
               for s in got for r in roots(s)) / len(got)


def counted_per_step(ctx, counter: str) -> Optional[float]:
    """A counter's change over a step's root spans, the mean over the
    phase's steps."""
    got = steps(ctx)
    if not got:
        return None
    return sum(r.get("counters", {}).get(counter, 0)
               for s in got for r in roots(s)) / len(got)
