"""Device milliseconds a served frame in G2d's decoder: the operations
launched inside the program's ``g2d.decoder`` span (the three upsampling
ResBlock2Ds, the norm, the last conv and the sigmoid), over the frames the
profiled steps served. Nothing where the span never opened."""


def read(ctx):
    s = ctx.layers.range_device_s("g2d.decoder")
    return None if s is None or not ctx.frames else s * 1e3 / ctx.frames
