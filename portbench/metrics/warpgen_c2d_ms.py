"""Device milliseconds a served frame in the c2d WarpGenerator: the operations launched
inside the ``warp_generator_c2d`` range, over the frames the profiled steps served.
Nothing where the range never opened."""


def read(ctx):
    s = ctx.layers.range_device_s("warp_generator_c2d")
    return None if s is None or not ctx.frames else s * 1e3 / ctx.frames
