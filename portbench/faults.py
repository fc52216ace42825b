"""Faults planted under the timed path, to show that ``correct`` catches
them: each wraps a system's ``Program`` class. The benchmark's runs never
use them; ``calibrate.py --faults`` reads them on the card and the CPU
tests see each come out not correct.
"""

from __future__ import annotations

import torch


def stale(program_cls):
    """Serving: a step that returns its state unchanged, the previous
    step's frames (and what the previous call computed)."""
    class Stale(program_cls):
        last = None

        def step(self, frames):
            out = super().step(frames) if self.last is None else self.last
            self.last = out
            return out
    return Stale


def half_batch(program_cls):
    """Serving: half of the streams' driving frames left out of the batch;
    the first half's take their place."""
    class Half(program_cls):
        def step(self, frames):
            frames = frames.clone()
            h = len(frames) // 2
            frames[h:2 * h] = frames[:h]
            return super().step(frames)
    return Half


def altered(program_cls):
    """Serving: one answer altered where it is produced (an 8x8 patch of
    one frame moved by 0.25)."""
    class Altered(program_cls):
        def step(self, frames):
            out = super().step(frames).clone()
            out[0, :8, :8] += 0.25
            return out
    return Altered


def frozen(program_cls):
    """Training: a step that leaves the parameters unchanged."""
    class Frozen(program_cls):
        def step(self, pool, i):
            saved = {k: [p.detach().clone() for p in ps] for k, ps in self.params().items()}
            metrics = super().step(pool, i)
            with torch.no_grad():
                for k, ps in self.params().items():
                    for p, q in zip(ps, saved[k]):
                        p.copy_(q)
            return metrics
    return Frozen


def half_rows(program_cls):
    """Training: half of the batch left out, the mean taken over the rest."""
    class HalfRows(program_cls):
        def step(self, pool, i):
            b = next(iter(pool.values())).shape[1]
            return super().step({k: v[:, :b // 2] for k, v in pool.items()}, i)
    return HalfRows


SERVE = {"stale": stale, "half_batch": half_batch, "altered": altered}
TRAIN = {"frozen": frozen, "half_rows": half_rows}
