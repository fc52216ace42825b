"""Operations and bytes of the G2d trunk: ``g2d_blocks`` ResBlock2D blocks
of two 3x3 convolutions, C -> C channels, over an h x w map, BatchNorm
folded (eval). Each input byte is read once and each output byte written
once: the activation in and out of every sample, and the weights, scales
and shifts once for the batch."""

from __future__ import annotations

from typing import Dict


def trunk_work(config: Dict, batch: int) -> Dict[str, float]:
    from portbench.reference.arch import Arch
    from portbench.spec import arch_fields

    a = Arch(**arch_fields(config))
    c, n = a.ch(512), a.g2d_blocks
    side = config["image_size"] // 8
    act_bytes = 2 if config["use_bf16"] else 4
    flops = 2.0 * 9 * c * c * side * side * 2 * n * batch
    weights = n * 2 * 9 * c * c * act_bytes + n * 2 * 2 * c * 4
    acts = 2 * batch * side * side * c * act_bytes
    return {"flops": flops, "bytes": float(weights + acts)}


def bound_s(work: Dict[str, float], peak_flops: float, peak_bytes: float) -> float:
    """The least time the card could take: the larger of operations over
    the compute peak and bytes over the memory bandwidth."""
    return max(work["flops"] / peak_flops, work["bytes"] / peak_bytes)
