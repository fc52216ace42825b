"""Device milliseconds a training step in the program's ``train.g_forward``
span (G's losses: Gbase's passes, D on the prediction, VGG19 and LPIPS):
the operations launched inside it, over the profiled steps. Nothing where
the span never opened."""


def read(ctx):
    s = ctx.layers.range_device_s("train.g_forward")
    return None if s is None or not ctx.steps else s * 1e3 / ctx.steps
