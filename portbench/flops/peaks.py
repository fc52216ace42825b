"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its 700 W limit)."""

BF16_FLOPS = 989e12      # bf16 / fp16 tensor cores
FP32_FLOPS = 67e12       # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12


def compute_peak(use_bf16: bool) -> float:
    return BF16_FLOPS if use_bf16 else FP32_FLOPS
