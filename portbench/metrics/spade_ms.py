"""Device milliseconds a served frame inside the program's ``student.spade``
spans (each SPADE's InstanceNorm, its shared, gamma and beta convs, the
avatars' embeddings and the modulation; 15 a step), over the frames the
profiled steps served. Nothing where the span never opened."""


def read(ctx):
    s = ctx.layers.range_device_s("student.spade")
    return None if s is None or not ctx.frames else s * 1e3 / ctx.frames
