"""Host milliseconds a training step in the program's ``train.step`` span,
on the host's clock, the mean over the steps of one traced phase
(``portbench/spans.py``): the time the host takes to launch the step's
work, and any wait it meets there (a loss read, a blocking copy)."""

from portbench.spans import host_ms_per_step


def read(ctx):
    return host_ms_per_step(ctx)
