"""The training step's share of the card's peak, in %: the operations of a
step (``flops/train.py``: G, D, VGG19 and LPIPS, forward and backward,
remat's recompute not counted) times the profiled steps, over the device
phase's window, over the compute peak of the configuration's precision."""

from portbench.flops.peaks import compute_peak
from portbench.flops.train import train_flops_per_step


def read(ctx):
    if not ctx.steps:
        return None
    flops = train_flops_per_step(ctx.config, ctx.batch) * ctx.steps
    return 100.0 * flops / ctx.trace.window_s / compute_peak(ctx.config["use_bf16"])
