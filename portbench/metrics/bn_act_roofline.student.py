"""Kernel K4's share of its roofline in the Student's served steps, in %:
the least time the card could take to move K4's bytes in the profiled
steps (``flops/student.py``: each epilogue's bf16 input and output once,
its operands once a launch, at the memory bandwidth) over the device time
of the K4 kernels in the traced run's device phase. Nothing where no K4
kernel ran."""

from portbench.flops.peaks import HBM_BYTES_PER_S
from portbench.flops.student import bn_act_bytes_per_step

KERNEL = "bn_act_kernel"


def read(ctx):
    device_s = sum(k["end"] - k["start"] for k in ctx.trace.kernels()
                   if KERNEL in k["name"]) * 1e-6
    if not device_s or not ctx.frames:
        return None
    steps = ctx.frames // ctx.batch
    least = bn_act_bytes_per_step(ctx.config, ctx.batch) * steps / HBM_BYTES_PER_S
    return 100.0 * least / device_s
