"""Device milliseconds a training step in the program's ``train.g_backward``
span (G's gradient, with remat's recompute of Eapp and G2d): the operations
launched inside it, over the profiled steps. Nothing where the span never
opened."""


def read(ctx):
    s = ctx.layers.range_device_s("train.g_backward")
    return None if s is None or not ctx.steps else s * 1e3 / ctx.steps
