"""Lockstep avatar streams in a closed loop, read from a traffic file.

Parameters (``traffic/<name>.json``): ``streams`` (the batch: one frame of
every stream a step), ``pool_frames`` (distinct driving frames per stream,
used in turn), ``warmup_steps`` (steps at set-up, on the pool's own
shapes), ``checked_steps`` (steps of the window whose frames the reference
checks, drawn from the seed) and ``traced_steps`` (steps in each of the
two phases a traced run profiles, ``trace.py``, after ``traced_after``
steps of its window). The image size is
the configuration's ``image_size``.

Every seed serves the same shapes, and the same number of frames a step:
the seed changes only the pictures, the weights and which steps are
checked. Each step passes the next frame of every stream through the
system and waits for the result on the device, then the next step starts.
A frame's latency is its step's: from the step's start to the moment the
host has seen its output ready.
"""

from __future__ import annotations

import importlib
import random
import statistics
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from portbench.seeded import generator, smooth_images


def make_inputs(traffic: Dict, config: Dict, seed: int, device,
                image_size: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """The sources [B, S, S, 3] and the pool of driving frames
    [P, B, S, S, 3], on the device, from the seed."""
    size = image_size or config["image_size"]
    b, p = traffic["streams"], traffic["pool_frames"]
    gen = generator(device, seed, "inputs")
    sources = smooth_images(gen, b, size, device)
    pool = smooth_images(gen, p * b, size, device).view(p, b, size, size, 3)
    return {"sources": sources, "pool": pool}


def warm_up(step: Callable, pool: torch.Tensor, steps: int) -> None:
    for i in range(steps):
        step(pool[i % len(pool)])
    if pool.is_cuda:
        torch.cuda.synchronize()


def window(step: Callable, pool: torch.Tensor, seconds: float, traffic: Dict,
           seed: int, tracer=None, min_steps: int = 0,
           seen: Optional[Callable] = None) -> Dict:
    """Run steps until `seconds` have passed (and at least `min_steps`, and
    every step the tracer profiles); keep a sample of ``checked_steps``
    steps' outputs, and what `seen` returns after each of them, drawn from
    the seed by reservoir sampling over the steps run."""
    sync = torch.cuda.synchronize if pool.is_cuda else (lambda: None)
    rng = random.Random(seed)
    keep_n = traffic["checked_steps"]
    kept: List[Tuple[int, torch.Tensor, Dict]] = []
    latencies, failures = [], []
    b = pool.shape[1]
    least = max(min_steps, tracer.last if tracer is not None else 0)
    i = 0
    start = time.perf_counter()
    while True:
        if tracer is not None:
            tracer.at(i)
        t0 = time.perf_counter()
        try:
            out = step(pool[i % len(pool)])
            sync()
        except RuntimeError as exc:  # a failed step fails its frames
            failures.append(f"step {i}: {exc}")
            out = None
        t1 = time.perf_counter()
        latencies.append(t1 - t0)
        if out is not None:  # reservoir sampling: each step kept alike
            slot = len(kept) if len(kept) < keep_n else rng.randrange(i + 1)
            if slot < keep_n:
                got = {k: v.clone() for k, v in seen().items()} if seen else {}
                kept[slot:slot + 1] = [(i, out.detach().clone(), got)]
        i += 1
        if t1 - start >= seconds and i >= least:
            break
    wall = time.perf_counter() - start
    if tracer is not None:
        tracer.at(i)
    return {"steps": i, "frames": i * b, "failed_frames": len(failures) * b,
            "failures": failures, "wall_s": wall, "latencies_s": latencies,
            "kept": sorted(kept, key=lambda e: e[0]), "pool_size": len(pool)}


def percentile(values, q: int) -> float:
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def end_to_end(result) -> Dict[str, Tuple[float, str]]:
    """frames_per_s: every frame completed over the window's wall time;
    frame_p95_ms: the 95th percentile of every frame's latency."""
    per_frame = [s for s in result["latencies_s"]
                 for _ in range(result["frames"] // result["steps"])]
    done = result["frames"] - result["failed_frames"]
    return {"frames_per_s": (done / result["wall_s"], "frames/s"),
            "frame_p95_ms": (percentile(per_frame, 95) * 1e3, "ms")}


def run_cell(cell, seed, seconds, trace, device, t0, arch=None, image_size=None,
             program=None, bench=None, min_steps=0):
    """Run a cell of this traffic; returns (the result line without its
    ``device``, the checks, the peak memory in bytes). `arch`, `image_size`
    and `program` (a factory in place of the system's ``Program``) let the
    CPU tests drive a small run and ``calibrate.py`` put the control in the
    program's place; `min_steps` makes the window run at least that many
    steps."""
    from portbench import compare, result

    config, traffic = cell["config"], cell["traffic"]
    on_card = torch.device(device).type == "cuda"
    system = importlib.import_module(f"portbench.systems.{cell['system']}")
    prog = (program or system.Program)(config, seed, device, arch, image_size)
    inputs = make_inputs(traffic, config, seed, device, image_size)
    prog.encode(inputs["sources"])
    warm_up(prog.step, inputs["pool"], traffic["warmup_steps"])
    setup_s = time.perf_counter() - t0

    tracer = None
    if trace:
        from portbench.trace import Tracer

        tracer = Tracer(prog.layers(), prog.trunk_owner(), name=cell["name"],
                        on_card=on_card, after=traffic["traced_after"],
                        steps=traffic["traced_steps"])
    res = window(prog.step, inputs["pool"], seconds, traffic, seed, tracer, min_steps,
                 seen=prog.seen)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    del prog
    result.free_card(on_card)

    ref = system.Reference(config, seed, device, arch, image_size)
    ref.encode(inputs["sources"])
    frames, rows = [], []
    for i, out, got in res["kept"]:
        frames.append((out, ref.step(inputs["pool"][i % res["pool_size"]])))
        rows.append((got, ref.seen()))
    readings = {**compare.frame_gaps(frames), **compare.row_gaps(rows, system.SEEN)}
    ok, checks = compare.judge(readings, cell["limits"])
    if frames:
        served = torch.stack([p[0].float() for p in frames])
        print(f"checked {len(frames)} steps' frames: served mean "
              f"{served.mean().item():.5f}, std {served.std().item():.5f}",
              file=sys.stderr)
    for failure in res["failures"][:5]:
        print(f"failed {failure}", file=sys.stderr)
    lat = sorted(res["latencies_s"])
    print(f"window: {res['steps']} steps in {res['wall_s']:.3f} s; step ms "
          f"min {lat[0] * 1e3:.2f}, median {percentile(lat, 50) * 1e3:.2f}, "
          f"p95 {percentile(lat, 95) * 1e3:.2f}, max {lat[-1] * 1e3:.2f}; set-up "
          f"{setup_s:.3f} s", file=sys.stderr)

    if tracer is not None:
        print(result.traced_step_times(res["latencies_s"], tracer), file=sys.stderr)
    out = {"correct": ok and res["failed_frames"] == 0,
           "attempted": res["frames"], "failed": res["failed_frames"]}
    e2e = {**end_to_end(res), "setup_s": (setup_s, "s")}
    result.pack(out, bench, tracer, e2e, config=config, batch=traffic["streams"],
                frames=traffic["traced_steps"] * traffic["streams"])
    return out, checks, peak
