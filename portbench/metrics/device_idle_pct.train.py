"""The share of the traced run's device phase, in %, in which no operation
ran on the card: one less the union of the device operations' intervals
over the phase's window (``trace.py``: the host is not recorded there)."""


def read(ctx):
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
