"""Forward operations of a served frame, counted from shapes: the plain
reference's convolutions and matmuls under ``torch.utils.flop_counter`` on
the meta device (no memory, no arithmetic). Two operations a
multiply-add; what the algorithm needs, whatever runs it."""

from __future__ import annotations

from typing import Dict

import torch
from torch.utils.flop_counter import FlopCounterMode


def serve_flops_per_frame(config: Dict) -> float:
    """Gbase's ``drive`` at ``image_size`` and, with ``hr_size``, Genh at
    ``hr_size``, for one frame."""
    from portbench.reference.arch import Arch
    from portbench.reference.gbase import Gbase
    from portbench.reference.genh import Genh
    from portbench.spec import arch_fields

    a = Arch(**arch_fields(config))
    s = config["image_size"]
    with torch.device("meta"):
        gbase = Gbase(arch=a).eval()
        genh = Genh(arch=a).eval() if config.get("hr_size") else None
    with torch.no_grad():
        x = torch.empty(1, s, s, 3, device="meta")
        state = gbase.encode_source(x)
        with FlopCounterMode(display=False) as counter:
            gbase.drive(state, x)
            if genh is not None:
                hr = config["hr_size"]
                genh(torch.empty(1, hr, hr, 3, device="meta"))
    return float(counter.get_total_flops())
