"""Training steps in a closed loop over a pool of batches on the card, read
from a traffic file.

Parameters (``traffic/<name>.json``): ``batch`` (rows a step),
``pool_batches`` (distinct batches, used in turn through the step's own
``pool_index`` path), ``checked_steps`` (the first steps, taken at set-up
by the same object and call as the window's, which the reference follows),
``traced_after`` and ``traced_steps`` (the steps in each of the two phases
a traced run profiles, ``trace.py``).
The image size is the configuration's ``image_size``. Every row of every
batch is a different picture; every seed trains on the same shapes.

Set-up builds the trainer once, takes the checked steps, and hands that
same trainer to the window. What is compared with the reference, each by
``compare.train_gaps``: every checked step's G and D loss; the norm of each
leaf's first gradient as the optimiser got it, worked out from its state
after the first step (AdamW's first moment over one less beta1); the norm
of each leaf's change after the checked steps, read before the window's
first step moves it.
"""

from __future__ import annotations

import gc
import importlib
import math
import sys
import time
from typing import Dict, List

import torch

from portbench.seeded import generator, smooth_images

KEYS = ("source", "driving", "source_next", "source_star", "driving_star")


def make_inputs(traffic: Dict, config: Dict, seed: int, device,
                image_size=None) -> Dict[str, torch.Tensor]:
    """{key: [P, B, S, S, 3]} for the five images of a stage-1 batch."""
    size = image_size or config["image_size"]
    b, p = traffic["batch"], traffic["pool_batches"]
    gen = generator(device, seed, "inputs")
    images = smooth_images(gen, len(KEYS) * p * b, size, device)
    images = images.view(len(KEYS), p, b, size, size, 3)
    return {k: images[j] for j, k in enumerate(KEYS)}


def _norms(tensors: List[torch.Tensor]) -> List[float]:
    return torch.stack(torch._foreach_norm([t.float() for t in tensors])).tolist()


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def first_steps(system, pool: Dict[str, torch.Tensor], n: int, device) -> Dict:
    """Take steps 0..n-1 and read what the comparison needs."""
    before = {k: [p.detach().clone() for p in ps] for k, ps in system.params().items()}
    losses, grad1 = [], {}
    for i in range(n):
        metrics = system.step(pool, i)
        _sync(device)
        losses.append({k: float(v) for k, v in metrics.items()})
        if i == 0:
            for name, opt in system.optimizers().items():
                b1 = opt.param_groups[0]["betas"][0]
                grad1[name] = [x / (1.0 - b1) for x in _norms(
                    [opt.state[p]["exp_avg"] for p in system.params()[name]])]
    change = {k: _norms([p.detach() - q for p, q in zip(system.params()[k], before[k])])
              for k in before}
    return {"losses": losses, "grad1": grad1, "change": change,
            "names": system.param_names()}


def window(system, pool: Dict[str, torch.Tensor], seconds: float, traffic: Dict,
           first: int, device, tracer=None, min_steps: int = 0) -> Dict:
    p = next(iter(pool.values())).shape[0]
    least = max(min_steps, tracer.last if tracer is not None else 0)
    failures, step_s = [], []
    i = first
    start = time.perf_counter()
    while True:
        if tracer is not None:
            tracer.at(i - first)
        t0 = time.perf_counter()
        try:
            metrics = system.step(pool, i % p)
            _sync(device)
            if not all(math.isfinite(float(v)) for v in metrics.values()):
                failures.append(f"step {i}: a loss is not finite")
        except RuntimeError as exc:  # a failed step fails its rows
            failures.append(f"step {i}: {exc}")
        t1 = time.perf_counter()
        step_s.append(t1 - t0)
        i += 1
        if t1 - start >= seconds and i - first >= least:
            break
    wall = time.perf_counter() - start
    if tracer is not None:
        tracer.at(i - first)
    return {"steps": i - first, "failed_steps": len(failures), "failures": failures,
            "wall_s": wall, "step_s": step_s}


def run_cell(cell, seed, seconds, trace, device, t0, arch=None, image_size=None,
             program=None, bench=None, min_steps=0):
    """As ``streams.run_cell``, for a training cell."""
    from portbench import compare, result

    config, traffic = cell["config"], cell["traffic"]
    on_card = torch.device(device).type == "cuda"
    system = importlib.import_module(f"portbench.systems.{cell['system']}")
    prog = (program or system.Program)(config, seed, device, arch)
    pool = make_inputs(traffic, config, seed, device, image_size)
    n = traffic["checked_steps"]
    got = first_steps(prog, pool, n, device)
    gc.collect()
    setup_s = time.perf_counter() - t0

    tracer = None
    if trace:
        from portbench.trace import Tracer

        tracer = Tracer(prog.layers(), prog.trunk_owner(), name=cell["name"],
                        on_card=on_card, after=traffic["traced_after"],
                        steps=traffic["traced_steps"])
    setup_peak = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    res = window(prog, pool, seconds, traffic, n, device, tracer, min_steps)
    window_peak = torch.cuda.max_memory_allocated() if on_card else 0
    del prog
    result.free_card(on_card)

    want = first_steps(system.Reference(config, seed, device, arch), pool, n, device)
    readings, where = compare.train_gaps(got, want)
    ok, checks = compare.judge(readings, cell["limits"])
    print(f"losses, program {got['losses']}; reference {want['losses']}",
          file=sys.stderr)
    print(f"readings {readings}; {where}", file=sys.stderr)
    for failure in res["failures"][:5]:
        print(f"failed {failure}", file=sys.stderr)
    step_ms = sorted(s * 1e3 for s in res["step_s"])
    print(f"window: {res['steps']} steps in {res['wall_s']:.3f} s; step ms "
          f"min {step_ms[0]:.1f}, median {step_ms[len(step_ms) // 2]:.1f}, max "
          f"{step_ms[-1]:.1f}; set-up {setup_s:.3f} s; peaks {setup_peak / 2**30:.2f} "
          f"GiB set-up, {window_peak / 2**30:.2f} GiB window", file=sys.stderr)
    if tracer is not None:
        print(result.traced_step_times(res["step_s"], tracer), file=sys.stderr)

    b = traffic["batch"]
    out = {"correct": ok and res["failed_steps"] == 0,
           "attempted": res["steps"] * b, "failed": res["failed_steps"] * b}
    done = (res["steps"] - res["failed_steps"]) * b
    e2e = {"train_samples_per_s": (done / res["wall_s"], "samples/s"),
           "setup_s": (setup_s, "s")}
    result.pack(out, bench, tracer, e2e, config=config, batch=b,
                steps=traffic["traced_steps"], window_peak=window_peak)
    return out, checks, max(setup_peak, window_peak)
