"""Tensors made from host data inside a served step: the change of the
program's ``host_uploads`` counter over the step's root spans, the mean
over the steps of one traced phase (``portbench/spans.py``)."""

from portbench.spans import counted_per_step


def read(ctx):
    return counted_per_step(ctx, "host_uploads")
