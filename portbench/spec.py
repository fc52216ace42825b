"""Finding a cell's pieces by name, and the contract's rules on names.

``BENCHMARK.json`` at the root of the checkout lists the cells and the
metrics. A cell's own file ``workloads/<cell>.json`` names its
configuration and traffic mix, which live in ``configs/<config>.json`` and
``traffic/<traffic>.json``, and holds the limits of its correctness check.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def check_name(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"not a valid name: {name!r}")
    return name


def load(kind: str, name: str) -> Dict:
    """``<kind>/<name>.json`` under the benchmark's folder."""
    path = HERE / kind / f"{check_name(name)}.json"
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def cell(name: str) -> Dict:
    """The cell's file with its configuration and traffic mix loaded in
    place of their names."""
    c = load("workloads", name)
    c["name"] = name
    c["config"] = load("configs", c["config"])
    c["traffic"] = load("traffic", c["traffic"])
    return c


def arch_fields(config: Dict, override: Optional[Dict] = None) -> Dict:
    """The configuration's ``arch`` (or `override`) as ``Arch`` keywords."""
    fields = dict(override if override is not None else config["arch"])
    return {k: tuple(v) if isinstance(v, list) else v for k, v in fields.items()}


def end_to_end(bench: Dict, cell_name: str) -> List[Dict]:
    """The end-to-end metrics the cell reports."""
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or cell_name in m["workloads"]]


def per_layer(bench: Dict, cell_name: str) -> List[Dict]:
    """The per-layer metrics the cell reports: those that list it, and
    those that list no cells and move an end-to-end metric it reports."""
    reported = {m["name"] for m in end_to_end(bench, cell_name)}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in reported)]
