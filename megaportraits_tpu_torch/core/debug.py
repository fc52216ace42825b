"""Numerics debugging and invariant checks (counterpart of
``megaportraits_tpu/core/debug.py``).

  * ``enable_nan_debugging``: autograd's anomaly mode, which names the
    forward op whose backward made a NaN (JAX: ``jax_debug_nans``);
  * ``checked(fn)``: ``err, out = checked(fn)(...); err.throw()``. The
    ``assert_finite`` checks made inside the call collect their flags on
    the device, without a host sync; ``err`` reads them after the call and
    raises on the host (JAX: ``checkify``);
  * ``assert_shape`` / ``assert_finite``: the invariants, as the reference's
    asserts; ``assert_finite`` outside ``checked`` raises at once;
  * ``apply_platform_env``: ``MEGAPORTRAITS_PLATFORM`` (cpu, cuda or gpu)
    names the device when the caller names none, an explicit request;
  * ``probe_device_count``: the number of cards. JAX probes its devices on
    a thread with a timeout because the TPU plugin could hang there; CUDA
    has no such hang, so the port asks ``torch.cuda.device_count()``.
"""

from __future__ import annotations

import contextvars
import functools
import os
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from megaportraits_tpu_torch.core.device import DEFAULT_DEVICE

PLATFORMS = {"cpu": "cpu", "cuda": "cuda", "gpu": "cuda"}

# The flags of the innermost ``checked`` call: (flag on the device, message).
_checks: contextvars.ContextVar[Optional[List[Tuple[torch.Tensor, str]]]] = \
    contextvars.ContextVar("megaportraits_checks", default=None)


def enable_nan_debugging(enable: bool = True) -> None:
    torch.autograd.set_detect_anomaly(enable)


def apply_platform_env(device: Optional[str] = None) -> str:
    """`device` when given; else the device ``MEGAPORTRAITS_PLATFORM`` names
    (``cpu``, ``cuda``, or JAX's ``gpu``); else the card. Any other value
    raises."""
    if device:
        return device
    platform = os.environ.get("MEGAPORTRAITS_PLATFORM")
    if not platform:
        return DEFAULT_DEVICE
    if platform not in PLATFORMS:
        raise ValueError(f"MEGAPORTRAITS_PLATFORM={platform!r}: the port runs on "
                         f"{sorted(PLATFORMS)}")
    return PLATFORMS[platform]


def assert_shape(x: torch.Tensor, expected: Sequence[int], name: str) -> None:
    """The trailing shape of `x` (all but the batch axis) is `expected`."""
    if tuple(x.shape[1:]) != tuple(expected):
        raise AssertionError(f"{name}: expected trailing shape {tuple(expected)}, "
                             f"got {tuple(x.shape[1:])}")


def assert_finite(x: torch.Tensor, name: str) -> None:
    """Every element of `x` is finite: recorded for the enclosing
    ``checked`` call, or checked at once outside one."""
    flag = torch.isfinite(x.detach().float()).all()
    message = f"{name} contains non-finite values"
    checks = _checks.get()
    if checks is None:
        if not bool(flag):
            raise FloatingPointError(message)
    else:
        checks.append((flag, message))


class CheckError:
    """The checks of one ``checked`` call, read on the host on demand."""

    def __init__(self, checks: List[Tuple[torch.Tensor, str]]):
        self._checks = checks

    def get(self) -> Optional[str]:
        """The first failed check's message, or None."""
        for flag, message in self._checks:
            if not bool(flag):
                return message
        return None

    def throw(self) -> None:
        message = self.get()
        if message is not None:
            raise FloatingPointError(message)


def checked(fn: Callable) -> Callable:
    """`fn` returning ``(err, out)``: the ``assert_finite`` checks of the
    call raise on the host at ``err.throw()``."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        checks: List[Tuple[torch.Tensor, str]] = []
        token = _checks.set(checks)
        try:
            out = fn(*args, **kwargs)
        finally:
            _checks.reset(token)
        return CheckError(checks), out

    return wrapper


def probe_device_count() -> int:
    """The number of cards this process sees."""
    return torch.cuda.device_count()
