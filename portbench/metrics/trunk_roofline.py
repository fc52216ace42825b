"""The G2d trunk's share of its roofline, in %: the least time the card
could take for the trunks of the profiled steps (``flops/trunk.py``: the
larger of operations over the bf16 peak and bytes over the memory
bandwidth) over the device time of the operations launched inside the
``trunk`` range (the kernel chain and the casts and stack around it)."""

from portbench.flops.peaks import HBM_BYTES_PER_S, compute_peak
from portbench.flops.trunk import bound_s, trunk_work


def read(ctx):
    device_s = ctx.layers.range_device_s("trunk")
    calls = sum(1 for r in ctx.layers.ranges if r[2] == "trunk")
    if not device_s or not calls:
        return None
    work = trunk_work(ctx.config, ctx.batch)
    least = bound_s(work, compute_peak(ctx.config["use_bf16"]), HBM_BYTES_PER_S)
    return 100.0 * least * calls / device_s
