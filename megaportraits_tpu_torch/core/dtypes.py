"""Mixed-precision policy: float32 parameters, bfloat16 compute, float32 norms.

Counterpart of ``megaportraits_tpu/core/dtypes.py``. bf16 has float32's
exponent range, so inference needs no loss scaling; norm layers reduce in
float32 whatever the compute type.

A float32 policy computes in float32 on the card too: its convolutions run
under ``cudnn_float32`` (TF32 off), forward (``Policy.conv_scope``) and
backward (``Policy.backward_scope``, around the trainers' gradient calls),
as JAX's float32 convolutions run at ``Precision.HIGHEST`` where it
matters; torch's default would let cuDNN round their inputs to TF32's
10-bit mantissa.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch


@contextlib.contextmanager
def cudnn_float32():
    """cuDNN convolutions in full float32 while the block runs, whatever
    the process-wide ``torch.backends.cudnn.allow_tf32`` says (torch's
    default is True); the flag is put back after. Matmuls need nothing:
    torch's default for float32 matmuls is full precision, and the port
    never changes it. The flag is process-wide: a convolution in another
    thread while the block runs sees it off too."""
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
    """Parameter / compute / norm dtype policy threaded through all modules."""

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    norm_dtype: torch.dtype = torch.float32

    def cast_to_compute(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.compute_dtype)

    def conv_scope(self):
        """Where the policy's convolutions run: ``cudnn_float32()`` for a
        float32 compute type; as the flags say for bf16, which has no TF32
        mode."""
        if self.compute_dtype == torch.float32:
            return cudnn_float32()
        return contextlib.nullcontext()

    def backward_scope(self):
        """Where autograd runs the backward of the policy's convolutions:
        ``conv_scope`` again, entered around the gradient call, since
        autograd runs the backward after each forward's scope has closed."""
        return self.conv_scope()


def cast_param(p: torch.Tensor, dtype: torch.dtype, site) -> torch.Tensor:
    """Parameter `p` in `dtype` for one call. A cast that makes a new tensor
    adds one to ``site.param_casts``, the counter of the layer that casts
    (``utils/profiling.counters``); one in `dtype` already is `p` itself."""
    if p.dtype == dtype:
        return p
    site.param_casts += 1
    return p.to(dtype)


DEFAULT_POLICY = Policy()
FP32_POLICY = Policy(compute_dtype=torch.float32)


def policy_for(device: torch.device) -> Policy:
    """The policy of a run on `device` that sets no ``use_bf16`` (the
    ``scripts/`` tools): bf16 compute on the card, as JAX's DEFAULT_POLICY;
    float32 on the CPU, which lacks bf16 kernels the models use."""
    return DEFAULT_POLICY if torch.device(device).type == "cuda" else FP32_POLICY
