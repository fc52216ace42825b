"""The comparisons that decide ``correct``, each number against its limit
in the cell's file.

Serving: what the timed path computed for the checked steps against the
plain float32 reference's answer for the same sources, driving frames and
weights. The frames: the widest gap of any pixel channel
(``frame_max_abs``) and the mean gap (``frame_mean_abs``). What each
stream's call computed from its driving frame (``systems/serve.SEEN``):
for each quantity the worst stream's relative gap, the norm of its row's
difference over the norm of the reference's row (``<quantity>_rel``), so
that a stream served another frame's or another stream's motion fails
even where the frames themselves change little. A check that has nothing
to compare, or rows of another shape, fails.

Training: the readings of ``generators/train_steps.first_steps`` on both
sides (``train_gaps``).
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Tuple

import torch


def frame_gaps(pairs: List[Tuple[torch.Tensor, torch.Tensor]]) -> Dict[str, float]:
    """Widest and mean absolute gap over all (served, reference) pairs."""
    inf = {"frame_max_abs": float("inf"), "frame_mean_abs": float("inf")}
    if not pairs:
        return inf
    widest, total, count = 0.0, 0.0, 0
    for got, want in pairs:
        if got.shape != want.shape:
            return inf
        gap = (got.float() - want.float()).abs()
        if not torch.isfinite(gap).all():
            return inf
        widest = max(widest, gap.max().item())
        total += gap.sum(dtype=torch.float64).item()
        count += gap.numel()
    return {"frame_max_abs": widest, "frame_mean_abs": total / count}


def row_gaps(pairs: List[Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]],
             names) -> Dict[str, float]:
    """``<name>_rel`` for each of `names`: the largest, over the checked
    steps and streams, of |got row - reference row| / |reference row|."""
    out = {}
    for name in names:
        worst = float("inf") if not pairs else 0.0
        for got, want in pairs:
            g, w = got.get(name), want.get(name)
            if g is None or w is None or g.shape != w.shape:
                worst = float("inf")
                break
            g, w = g.reshape(len(g), -1).double(), w.reshape(len(w), -1).double()
            rel = ((g - w).norm(dim=1) / w.norm(dim=1)).max().item()
            worst = max(worst, rel) if rel == rel else float("inf")
        out[f"{name}_rel"] = worst
    return out


def judge(readings: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict]:
    """(all within their limits, {name: {"value", "limit"}}) over the
    numbers that have a limit; the others are only reported."""
    checks = {k: {"value": readings[k], "limit": limits[k]} for k in limits}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def _leaf_gaps(got: List[float], want: List[float]) -> List[float]:
    """|got - want| of each leaf's norm over the larger of the reference's
    norm of that leaf and of the median leaf."""
    floor = statistics.median(want)
    return [abs(g - w) / max(w, floor) for g, w in zip(got, want)]


def train_gaps(got: Dict, want: Dict) -> Tuple[Dict[str, float], Dict]:
    """The training numbers, and where their worst leaves lie.

    ``loss1_rel``: the larger relative gap of the first step's G and D loss
    (the same weights on both sides). ``loss_rel``: the largest over every
    checked step. ``grad1_median`` / ``grad1_worst``: the median and the
    worst leaf's gap of the first gradient's norm. ``change_median`` /
    ``change_worst``: the same of each leaf's change after the checked
    steps, leaving out the leaves whose first gradient in the reference is
    under a thousandth of the median leaf's: Adam moves those by round-off
    alone. A number that is not a number reads as infinite.
    """
    def rel(g, w):
        return abs(g - w) / abs(w)

    first = max(rel(got["losses"][0][k], w) for k, w in want["losses"][0].items())
    loss = max(rel(g[k], w[k]) for g, w in zip(got["losses"], want["losses"]) for k in w)
    grad, change, names, excluded = [], [], [], 0
    for model in want["grad1"]:
        ref_g = want["grad1"][model]
        floor = 1e-3 * statistics.median(ref_g)
        keep = [x >= floor for x in ref_g]
        excluded += keep.count(False)
        grad += _leaf_gaps(got["grad1"][model], ref_g)
        gaps = _leaf_gaps(got["change"][model], want["change"][model])
        change += [(g, f"{model}:{n}") for g, n, k in
                   zip(gaps, want["names"][model], keep) if k]
        names += [f"{model}:{n}" for n in want["names"][model]]
    readings = {"loss1_rel": first, "loss_rel": loss,
                "grad1_median": statistics.median(grad), "grad1_worst": max(grad),
                "change_median": statistics.median(g for g, _ in change),
                "change_worst": max(g for g, _ in change)}
    where = {"grad1_worst": names[grad.index(max(grad))],
             "change_worst": max(change)[1], "excluded_leaves": excluded}
    return {k: (v if v == v else float("inf")) for k, v in readings.items()}, where
