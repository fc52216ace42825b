"""The traced run: a ``torch.profiler`` trace over a fixed number of steady
steps, in two phases of ``steps`` steps each, and its reading.

The device phase records only the card's activity (kernels, copies, fills
and the CUDA calls that launched them): the busy time, the window, and the
operations that took the most time come from it. Its window runs from the
first CUDA call of its first step to the end of the synchronize that ends
its last. Recording every operator on the host as well lengthens a step
by a fifth or more, the card's activity alone by a twentieth to a tenth,
so the idle share and the step's share of the peak are read where the host
is not recorded.

The layer phase records the host too, with ranges around the calls into
the program's layers: forward pre/post hooks on the named submodules, and
a wrapper on the instance's ``trunk`` method (the ranges come from the
benchmark, not the program). A device operation counts toward a range when
its launch lies inside that range on the host; one whose launch the trace
does not record is given the ranges of the operation before it on the same
stream, which was launched before it. The device time of each layer, and
the idle gaps named by what the host was launching, come from this phase.
Busy time is the union of the device operations' intervals inside a
window, not their sum.

The traces are written under ``portbench/traces/`` (listed in the folder's
``.gitignore``), two files a cell, overwritten by the next traced run.
"""

from __future__ import annotations

import bisect
import importlib.util
import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

HERE = Path(__file__).resolve().parent
TRACE_DIR = HERE / "traces"
WINDOW = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
PHASES = ("device", "layers")


class Tracer:
    """Profiles window steps ``after`` to ``after + steps`` (the device
    phase) and the ``steps`` after them (the layer phase). The window calls
    ``at(k)`` before its step k and once when it closes, and runs at least
    ``last`` steps."""

    def __init__(self, layers: Dict[str, torch.nn.Module], trunk_owner=None,
                 name: str = "trace", on_card: bool = True, after: int = 0,
                 steps: int = 1):
        self.on_card = on_card
        self.layers = layers
        self.trunk_owner = trunk_owner
        self.paths = {p: TRACE_DIR / f"{name}.{p}.json" for p in PHASES}
        self.first, self.steps = after, steps
        self.last = after + 2 * steps
        self.handles = []
        self.prof = None
        self.phase = None

    def at(self, k: int) -> None:
        if k == self.first:
            self._start("device")
        elif k == self.first + self.steps:
            self._stop()
            self._start("layers")
        elif k == self.last and self.phase is not None:
            self._stop()

    def _hooks(self):
        for name, module in self.layers.items():
            opened: List = []

            def pre(_m, _a, name=name, opened=opened):
                rf = torch.profiler.record_function(name)
                rf.__enter__()
                opened.append(rf)

            def post(_m, _a, _o, opened=opened):
                opened.pop().__exit__(None, None, None)

            self.handles.append(module.register_forward_pre_hook(pre))
            self.handles.append(module.register_forward_hook(post))
        if self.trunk_owner is not None:
            owner = self.trunk_owner
            method = owner.trunk

            def trunk(*args, **kwargs):
                with torch.profiler.record_function("trunk"):
                    return method(*args, **kwargs)

            owner.trunk = trunk

    def _unhook(self):
        for h in self.handles:
            h.remove()
        self.handles = []
        if self.trunk_owner is not None and "trunk" in vars(self.trunk_owner):
            del self.trunk_owner.trunk  # back to the class's method

    def _sync(self):
        if self.on_card:
            torch.cuda.synchronize()

    def _start(self, phase: str) -> None:
        self._sync()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.on_card:
            acts = [torch.profiler.ProfilerActivity.CUDA]
            if phase == "layers":
                acts.insert(0, torch.profiler.ProfilerActivity.CPU)
        if phase == "layers":
            self._hooks()
        self.phase = phase
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.window = torch.profiler.record_function(WINDOW)
        self.window.__enter__()

    def _stop(self) -> None:
        self._sync()
        self.window.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self._unhook()
        TRACE_DIR.mkdir(parents=True, exist_ok=True)
        self.prof.export_chrome_trace(str(self.paths[self.phase]))
        self.prof = None
        self.phase = None

    def device_trace(self) -> "Trace":
        return Trace(self.paths["device"])

    def layer_trace(self) -> "Trace":
        return Trace(self.paths["layers"])


class Trace:
    """The device operations of one profiled window, each with the ranges
    its launch lay in, read from a Chrome trace."""

    def __init__(self, path: Path):
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
        win = [e for e in events if e.get("name") == WINDOW
               and e.get("cat") == "user_annotation"]
        calls = [e for e in events if e.get("cat") in LAUNCH_CATS]
        if win:  # the host was recorded: the window's own range
            self.t0 = float(win[0]["ts"])
            self.t1 = self.t0 + float(win[0]["dur"])
        elif calls:  # the card alone: its first CUDA call to its last's end
            self.t0 = min(float(e["ts"]) for e in calls)
            self.t1 = max(float(e["ts"]) + float(e["dur"]) for e in calls)
        else:
            raise RuntimeError(f"no {WINDOW} range and no CUDA call in {path}")
        launches = {}
        for e in events:
            if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
                launches[e["args"]["correlation"]] = float(e["ts"])
        ranges = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                         for e in events if e.get("cat") == "user_annotation"
                         and e["name"] != WINDOW), key=lambda r: r[0])
        self.cpu_ops = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                               for e in events if e.get("cat") == "cpu_op"),
                              key=lambda r: r[0])
        self._cpu_starts = [r[0] for r in self.cpu_ops]
        ops = []
        for e in events:
            if e.get("cat") not in DEVICE_CATS:
                continue
            start = float(e["ts"])
            end = start + float(e["dur"])
            if end <= self.t0 or start >= self.t1:
                continue
            corr = e.get("args", {}).get("correlation")
            ops.append({"name": e["name"], "cat": e["cat"], "start": start, "end": end,
                        "stream": e.get("args", {}).get("stream", e.get("tid")),
                        "launch": launches.get(corr), "ranges": set()})
        ops.sort(key=lambda o: o["start"])
        self.unlaunched = sum(o["launch"] is None for o in ops)
        launched = sorted((o["launch"], k) for k, o in enumerate(ops)
                          if o["launch"] is not None)
        keys = [t for t, _ in launched]
        for lo, hi, name in ranges:
            for _, k in launched[bisect.bisect_left(keys, lo):bisect.bisect_right(keys, hi)]:
                ops[k]["ranges"].add(name)
                ops[k]["inner"] = name  # ranges run by start: the last is innermost
        last: Dict = {}
        for o in ops:
            if o["launch"] is None and o["stream"] in last:
                o["ranges"] = set(last[o["stream"]]["ranges"])
                o["inner"] = last[o["stream"]].get("inner")
            last[o["stream"]] = o
        self.ops = ops
        self.ranges = ranges

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def busy_s(self) -> float:
        """The union of the device operations' intervals in the window."""
        total, cur_s, cur_e = 0.0, None, None
        for o in self.ops:
            s, e = max(o["start"], self.t0), min(o["end"], self.t1)
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            total += cur_e - cur_s
        return total * 1e-6

    def kernels(self) -> List[Dict]:
        return [o for o in self.ops if o["cat"] == "kernel"]

    def range_device_s(self, name: str) -> Optional[float]:
        """Device seconds of the operations launched inside range `name`;
        None where the range never opened."""
        if not any(r[2] == name for r in self.ranges):
            return None
        return sum(o["end"] - o["start"] for o in self.ops if name in o["ranges"]) * 1e-6

    def top_ops(self, n: int = 10) -> List[Tuple[str, float]]:
        sums: Dict[str, float] = {}
        for o in self.ops:
            sums[o["name"]] = sums.get(o["name"], 0.0) + (o["end"] - o["start"]) * 1e-6
        return sorted(sums.items(), key=lambda kv: -kv[1])[:n]

    def _host_op(self, ts: Optional[float]) -> str:
        """The innermost CPU operation running on the host at `ts`."""
        if ts is None:
            return "unrecorded launch"
        k = bisect.bisect_right(self._cpu_starts, ts)
        for lo, hi, name in reversed(self.cpu_ops[max(0, k - 400):k]):
            if lo <= ts <= hi:
                return name
        return "no operation"

    def idle_gaps(self, n: int = 10) -> List[Tuple[str, float]]:
        """Idle time summed by what the host was doing when it launched the
        operation that ended each gap: the innermost range and operation."""
        sums: Dict[str, float] = {}
        cur_e = self.t0
        for o in self.ops:
            if o["start"] > cur_e:
                inner = o.get("inner") or "outside the layers"
                name = f"{inner}: {self._host_op(o['launch'])}"
                sums[name] = sums.get(name, 0.0) + (o["start"] - cur_e) * 1e-6
            cur_e = max(cur_e, o["end"])
        if self.t1 > cur_e:
            sums["window end"] = sums.get("window end", 0.0) + (self.t1 - cur_e) * 1e-6
        return sorted(sums.items(), key=lambda kv: -kv[1])[:n]


def read_metrics(per_layer: List[Dict], ctx) -> Dict[str, Dict]:
    """Each per-layer metric's ``metrics/<name>.py`` ``read(ctx)``, with its
    unit; a metric whose reader finds nothing to read is left out."""
    out = {}
    for m in per_layer:
        spec = importlib.util.spec_from_file_location(
            f"portbench_metric_{m['name'].replace('.', '_')}",
            HERE / "metrics" / f"{m['name']}.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        value = module.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def traced_record(device: "Trace", layers: "Trace") -> Tuple[Dict, Dict]:
    """(the device phase's busy and window seconds, the line's breakdown:
    the device phase's top operations, the layer phase's idle gaps)."""
    record = {"busy_s": device.busy_s(), "window_s": device.window_s}
    breakdown = {"device_ops": [list(x) for x in device.top_ops()],
                 "idle_gaps": [list(x) for x in layers.idle_gaps()]}
    return record, breakdown
