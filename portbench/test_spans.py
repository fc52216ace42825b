"""CPU tests of the readers of the program's spans and counters
(``python -m pytest portbench -q``), at the sizes of ``test_portbench.py``."""

from __future__ import annotations

import time

import pytest

from portbench import spec
from portbench.generators import streams, train_steps
from portbench.systems import serve
from portbench.test_portbench import BENCH, SEED, SERVE_CELLS, TRAIN_CELLS, run_small, small

SPAN_METRICS = {
    "serve": ("warp_ms", "g2d_decoder_ms", "host_dispatch_ms.serve",
              "param_casts_per_step", "host_uploads_per_step"),
    "train_base": ("host_dispatch_ms.train", "g_forward_ms.train", "g_backward_ms.train",
                   "optimizer_ms.train"),
}
COUNTED = ("param_casts_per_step", "host_uploads_per_step")


def run_small_seeded(cell, seed, trace=1):
    """``run_small`` with another seed."""
    gen = streams if cell["system"] == "serve" else train_steps
    return gen.run_cell(cell, seed, 0.2, trace, "cpu", time.perf_counter(),
                        arch=serve.tiny_arch(), image_size=64,
                        bench={"end_to_end": spec.end_to_end(BENCH, cell["name"]),
                               "per_layer": spec.per_layer(BENCH, cell["name"])},
                        min_steps=2)


@pytest.mark.parametrize("cell_name", SERVE_CELLS + TRAIN_CELLS)
def test_traced_run_reports_the_metrics_of_the_program_spans(cell_name):
    cell = small(cell_name)
    out, _, _ = run_small(cell, trace=1)
    assert out["correct"]
    names = SPAN_METRICS[cell["system"]]
    assert set(names) <= {m["name"] for m in spec.per_layer(BENCH, cell_name)}
    for name in names:
        assert name in out["metrics"], name
        assert out["metrics"][name]["value"] >= 0
    host = [n for n in names if n.startswith("host_dispatch_ms")]
    assert out["metrics"][host[0]]["value"] > 0


@pytest.mark.parametrize("cell_name", SERVE_CELLS)
def test_span_counters_repeat_between_seeds(cell_name):
    """Casts and uploads count calls: two seeds read the same. The CPU
    program computes in float32, so it casts no parameter (the card's bf16
    one casts at every layer); the warp and the rotation's grid upload 3."""
    reads = []
    for seed in (SEED, SEED + 7):
        out, _, _ = run_small_seeded(small(cell_name), seed)
        reads.append({k: out["metrics"][k]["value"] for k in COUNTED})
    assert reads[0] == reads[1]
    assert reads[0]["host_uploads_per_step"] == 3
    assert reads[0]["param_casts_per_step"] == 0


def test_span_readers_report_nothing_without_the_program_spans(monkeypatch):
    """A program older than its spans has no ``profiling.spans`` and opens
    none of the span ranges: every reader of them gives None, and none
    raises."""
    from types import SimpleNamespace

    from megaportraits_tpu_torch.utils import profiling

    from portbench.trace import read_metrics

    monkeypatch.delattr(profiling, "spans")
    layers = SimpleNamespace(range_device_s=lambda name: None, ranges=[])
    for system, names in SPAN_METRICS.items():
        per_layer = [m for m in BENCH["per_layer"] if m["name"] in names]
        ctx = SimpleNamespace(layers=layers, trace=layers, config={}, batch=2,
                              frames=4, steps=None if system == "serve" else 2)
        assert read_metrics(per_layer, ctx) == {}
