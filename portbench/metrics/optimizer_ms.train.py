"""Device milliseconds a training step in the program's ``train.optimizer``
span (both AdamW steps, and the metrics' mean over the ranks): the
operations launched inside it, over the profiled steps. Nothing where the
span never opened."""


def read(ctx):
    s = ctx.layers.range_device_s("train.optimizer")
    return None if s is None or not ctx.steps else s * 1e3 / ctx.steps
