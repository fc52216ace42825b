"""Eval-mode BatchNorm epilogues run as kernel K4 in a served step: the
change of the program's ``launches.bn_act`` counter over the step's root
spans, the mean over the steps of one traced phase (``portbench/spans.py``).
The same every step: it counts launches, not time. A program without the
counter (one older than K4) gives nothing."""

from portbench.spans import counted_per_step, roots, steps

COUNTER = "launches.bn_act"


def read(ctx):
    got = steps(ctx)
    if not got or not any(COUNTER in r.get("counters", {}) for s in got for r in roots(s)):
        return None
    return counted_per_step(ctx, COUNTER)
