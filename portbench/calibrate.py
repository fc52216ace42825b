"""The readings that a cell's correctness limits are set from, on the card,
at the cell's own size and load, in one process.

    python -m portbench.calibrate --workload <cell> --seeds 101 102 ... \\
        --control-seeds 201 202 203 [--seconds 2] [--out <file.jsonl>]

For each of ``--seeds`` the program runs a short window of the cell's
traffic (at least ``checked_steps`` steps) and its frames are checked
against the float32 reference, as a benchmark run does: the program's
gaps, from which the lower reading is taken. For each of
``--control-seeds`` the control, the reference computed with fp8 (e4m3)
operands in every convolution and matmul (``reference/dtypes.py``), takes
the program's place: the upper reading. Each of ``--faults`` (``faults.py``)
planted under the program runs on ``--fault-seeds``. Each reading is one
JSON line.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import sys
import time

import torch

from portbench import card, faults, spec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--faults", nargs="*", default=[],
                   help="names in faults.py, each run on --fault-seeds")
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    cell = spec.cell(args.workload)
    card.require_cards(torch, cell["chips"])
    system = importlib.import_module(f"portbench.systems.{cell['system']}")

    def control(config, seed, device, arch, *size):
        return system.Reference(config, seed, device, arch, *size,
                                policy=system.control_policy())

    sink = open(args.out, "a") if args.out else None
    runs = [("program", s, None) for s in args.seeds]
    runs += [("control", s, control) for s in args.control_seeds]
    planted = {**faults.SERVE, **faults.TRAIN}
    runs += [(f"fault.{f}", s, planted[f](system.Program))
             for f in args.faults for s in args.fault_seeds]
    for kind, seed, factory in runs:
        t0 = time.perf_counter()
        generator = importlib.import_module(
            f"portbench.generators.{cell['traffic']['generator']}")
        out, checks, peak = generator.run_cell(
            cell, seed, args.seconds, 0, "cuda", t0, program=factory,
            min_steps=cell["traffic"]["checked_steps"])
        line = {"workload": args.workload, "kind": kind, "seed": seed,
                "readings": {k: c["value"] for k, c in checks.items()},
                "steps": out["attempted"], "correct": out["correct"],
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        if sink:
            sink.write(json.dumps(line) + "\n")
            sink.flush()
        gc.collect()
        torch.cuda.empty_cache()
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
