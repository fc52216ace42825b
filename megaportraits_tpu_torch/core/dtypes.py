"""Mixed-precision policy: float32 parameters, bfloat16 compute, float32 norms.

Counterpart of ``megaportraits_tpu/core/dtypes.py``. bf16 has float32's
exponent range, so inference needs no loss scaling; norm layers reduce in
float32 whatever the compute type.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    """Parameter / compute / norm dtype policy threaded through all modules."""

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    norm_dtype: torch.dtype = torch.float32

    def cast_to_compute(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.compute_dtype)


DEFAULT_POLICY = Policy()
FP32_POLICY = Policy(compute_dtype=torch.float32)


def policy_for(device: torch.device) -> Policy:
    """The policy of a run on `device` that sets no ``use_bf16`` (the
    ``scripts/`` tools): bf16 compute on the card, as JAX's DEFAULT_POLICY;
    float32 on the CPU, which lacks bf16 kernels the models use."""
    return DEFAULT_POLICY if torch.device(device).type == "cuda" else FP32_POLICY
