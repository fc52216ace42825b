"""The card's peak of allocated memory over the window, in GiB: PyTorch's
``max_memory_allocated`` after ``reset_peak_memory_stats`` at the window's
start. Nothing off the card."""


def read(ctx):
    return ctx.window_peak / 2**30 if ctx.window_peak else None
