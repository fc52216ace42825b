"""Device milliseconds a served frame in G2d: the operations launched
inside the ``g2d`` range, over the frames the profiled steps served.
Nothing where the range never opened."""


def read(ctx):
    s = ctx.layers.range_device_s("g2d")
    return None if s is None or not ctx.frames else s * 1e3 / ctx.frames
