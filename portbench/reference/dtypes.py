"""The reference's precision: float32 parameters, float32 compute with TF32
off, float32 norms.

``Policy(operand_dtype=...)`` is the control: every convolution's and
matmul's operands (input and weight, not the bias) are rounded through a
narrower type, float8 e4m3 for a configuration that computes in bf16, and
the product is taken in float32, as an fp8 GEMM with float32 accumulation
would. Values beyond the type's range are clamped to it first (a cast would
give NaN).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch


@contextlib.contextmanager
def cudnn_float32():
    """cuDNN convolutions in full float32 while the block runs, whatever
    ``torch.backends.cudnn.allow_tf32`` says; the flag is put back after."""
    cudnn = torch.backends.cudnn
    if not cudnn.allow_tf32:
        yield
        return
    cudnn.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32 = True


@dataclasses.dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    norm_dtype: torch.dtype = torch.float32
    operand_dtype: Optional[torch.dtype] = None

    def cast_to_compute(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.compute_dtype)

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        """A convolution's or matmul's operand in the compute type, rounded
        through ``operand_dtype`` when the policy has one."""
        x = x.to(self.compute_dtype)
        if self.operand_dtype is None:
            return x
        limit = torch.finfo(self.operand_dtype).max
        return x.clamp(-limit, limit).to(self.operand_dtype).to(self.compute_dtype)

    def conv_scope(self):
        return cudnn_float32()


DEFAULT_POLICY = Policy()
FP8_CONTROL = Policy(operand_dtype=torch.float8_e4m3fn)
