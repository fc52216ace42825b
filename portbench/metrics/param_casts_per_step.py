"""Per-call casts of a parameter to the compute dtype in a served step:
the change of the program's ``param_casts`` counter over the step's root
spans, the mean over the steps of one traced phase (``portbench/spans.py``).
The same every step: it counts calls, not time."""

from portbench.spans import counted_per_step


def read(ctx):
    return counted_per_step(ctx, "param_casts")
