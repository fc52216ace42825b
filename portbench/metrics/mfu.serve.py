"""The served step's share of the card's peak, in %: the forward operations
of a frame (``flops/model.py``) times the frames the profiled steps served,
over the traced run's device phase window, over the compute peak of the
configuration's precision."""

from portbench.flops.model import serve_flops_per_frame
from portbench.flops.peaks import compute_peak


def read(ctx):
    if not ctx.frames:
        return None
    flops = serve_flops_per_frame(ctx.config) * ctx.frames
    return 100.0 * flops / ctx.trace.window_s / compute_peak(ctx.config["use_bf16"])
