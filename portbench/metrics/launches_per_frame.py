"""CUDA kernels launched a served frame: the kernels in the profiled
steps' trace over the frames those steps served."""


def read(ctx):
    return len(ctx.trace.kernels()) / ctx.frames if ctx.frames else None
