"""Device selection for the port's entry points.

Entry points run on the card by default. The host CPU is used only when the
caller asks for it (``device="cpu"``); a request for CUDA on a host without
a card raises instead of silently running on the CPU.
"""

from __future__ import annotations

from typing import Union

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: Union[str, torch.device] = DEFAULT_DEVICE) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the host"
        )
    return dev


def upload(data, device: Union[str, torch.device], site, dtype=None) -> torch.Tensor:
    """``torch.as_tensor(data, dtype, device)`` for host data (a numpy array
    or a list) made into a tensor inside a call; adds one to
    ``site.host_uploads``, the counter of the function that uploads
    (``utils/profiling.counters``). It counts on the CPU too, where nothing
    crosses to a card."""
    site.host_uploads += 1
    return torch.as_tensor(data, dtype=dtype, device=device)
