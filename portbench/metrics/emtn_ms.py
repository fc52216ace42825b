"""Device milliseconds a served frame in Emtn: the operations launched
inside the ``motion_encoder`` range, over the frames the profiled steps served.
Nothing where the range never opened."""


def read(ctx):
    s = ctx.layers.range_device_s("motion_encoder")
    return None if s is None or not ctx.frames else s * 1e3 / ctx.frames
