"""Device milliseconds a served frame in the Student's decoder: the
operations launched inside the program's ``student.decoder`` span (the six
SPADE blocks and the nearest x2 between them), over the frames the profiled
steps served. Nothing where the span never opened."""


def read(ctx):
    s = ctx.layers.range_device_s("student.decoder")
    return None if s is None or not ctx.frames else s * 1e3 / ctx.frames
