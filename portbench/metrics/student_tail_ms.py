"""Device milliseconds a served frame in the Student's tail: the operations
launched inside the program's ``student.tail`` span (two nearest x2, three
convs, two InstanceNorms and the sigmoid), over the frames the profiled
steps served. Nothing where the span never opened."""


def read(ctx):
    s = ctx.layers.range_device_s("student.tail")
    return None if s is None or not ctx.frames else s * 1e3 / ctx.frames
