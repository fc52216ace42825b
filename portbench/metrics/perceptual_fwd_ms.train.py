"""Device milliseconds a training step in the PerceptualLoss forward calls
(VGG19 and LPIPS, three calls a step): the operations launched inside the
``perceptual`` range, over the profiled steps."""


def read(ctx):
    s = ctx.layers.range_device_s("perceptual")
    return None if s is None or not ctx.steps else s * 1e3 / ctx.steps
