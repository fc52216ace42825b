"""Host milliseconds a served step in the program's root spans
(``session.step``, and ``genh.forward`` where Genh serves), on the host's
clock, the mean over the steps of one traced phase (``portbench/spans.py``).
The step does not wait for the card inside them, so this is the time the
host takes to launch the step's work, and any wait it meets there."""

from portbench.spans import host_ms_per_step


def read(ctx):
    return host_ms_per_step(ctx)
