"""Run one cell of ``BENCHMARK.json`` on the card and print one JSON line.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (``setup_s``, from the start of this process to the start of the
window): the program is built, its weights drawn on the card from the seed,
the sources encoded, and every shape of the cell's traffic warmed up (the
kernels come from ``build/torch_kernels/`` inside the checkout, built on a
checkout's first run). The window then runs the cell's traffic for
``--seconds``. With ``--trace 1`` it profiles a fixed number of steady
steps of the window and reports the cell's per-layer metrics instead of its
end-to-end ones. After the window the peak memory is read, the program is
freed, and the plain reference checks the frames the window served.

The last line of standard output is the result; the last lines of standard
error are the numbers compared, each beside its limit. Without the cards
the cell asks for, or with JAX or the JAX package loaded, the run exits
with a code other than 0 and prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
os.environ.setdefault("TRITON_CACHE_DIR", str(HERE.parent / "build" / "triton"))


def pin() -> None:
    """Keep the process on two fixed cores of those it may use, with one
    thread for the host's tensor operations: a one-card machine shares its
    host, and a process that the scheduler moves between cores paces its
    steps less evenly from run to run. Called before torch is imported."""
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) >= 4:
        os.sched_setaffinity(0, cores[2:4])
    os.environ["OMP_NUM_THREADS"] = "1"


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    pin()
    import torch

    from portbench import card, spec

    bench = spec.benchmark()
    cell = spec.cell(args.workload)
    card.require_cards(torch, cell["chips"])
    power = card.power_limit_w()
    cell_bench = {"end_to_end": spec.end_to_end(bench, args.workload),
                  "per_layer": spec.per_layer(bench, args.workload)}
    generator = importlib.import_module(
        f"portbench.generators.{cell['traffic']['generator']}")
    out, checks, peak = generator.run_cell(cell, args.seed, args.seconds, args.trace,
                                           "cuda", T0, bench=cell_bench)
    found = card.forbidden_modules()
    if found:
        print(f"portbench: JAX or the JAX package is loaded: {found}", file=sys.stderr)
        return 4
    device = card.device_record(torch, cell["chips"], peak, power)
    device.update(out.pop("device_extra", {}))
    out["device"] = device
    # The numbers compared, last in the line: an infinite gap (no frame, a
    # shape or a value gone wrong) is written as the string "inf".
    out["checks"] = {k: {"value": c["value"] if math.isfinite(c["value"]) else "inf",
                         "limit": c["limit"]} for k, c in checks.items()}
    for name, c in checks.items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
