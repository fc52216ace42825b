"""Device milliseconds a served frame in the Student's encoder: the
operations launched inside the program's ``student.encoder`` span (the
stem, the ResNet stages and the ResBlockBN chain, with their 23 K4
epilogues), over the frames the profiled steps served. Nothing where the
span never opened."""


def read(ctx):
    s = ctx.layers.range_device_s("student.encoder")
    return None if s is None or not ctx.frames else s * 1e3 / ctx.frames
