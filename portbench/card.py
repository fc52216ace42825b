"""The card a run measures, and the modules a run may not load."""

from __future__ import annotations

import subprocess
import sys
from typing import Dict, Iterable, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "megaportraits_tpu")


def forbidden_modules(names: Optional[Iterable[str]] = None) -> List[str]:
    """Loaded modules (or `names`) whose top-level name, compared whole, is
    JAX's or the JAX package's (``megaportraits_tpu_torch`` is not caught)."""
    names = list(sys.modules) if names is None else names
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


def require_cards(torch, count: int) -> None:
    """Exit with code 3 and no result unless `count` CUDA cards are there."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < count:
        print(f"portbench: the cell needs {count} CUDA card(s); found {have}",
              file=sys.stderr)
        sys.exit(3)


def power_limit_w() -> str:
    """The card's power limit as ``nvidia-smi`` prints it, or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError) as exc:
        return f"unread ({type(exc).__name__})"
    return out.strip().splitlines()[0] if out.strip() else "unread"


def device_record(torch, count: int, peak_bytes: int, power: str) -> Dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count, "memory_peak_bytes": int(peak_bytes),
            "power_limit": power}
