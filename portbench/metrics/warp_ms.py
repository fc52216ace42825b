"""Device milliseconds a served frame in the warp and depth sum: the
operations launched inside the program's ``gbase.warp`` span
(``apply_warping_field`` on the source's volume, then the sum over depth),
over the frames the profiled steps served. Nothing where the span never
opened."""


def read(ctx):
    s = ctx.layers.range_device_s("gbase.warp")
    return None if s is None or not ctx.frames else s * 1e3 / ctx.frames
