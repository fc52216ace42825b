"""CPU tests of the ``student`` system (``python -m pytest portbench -q``).

The cell runs here at an eighth of the Student's widths on 64-pixel
images, the program in float32 (the CPU lacks bf16 kernels that the models
use), its numbers held to ``TINY_LIMIT``; the control and every fault,
this system's own among them, must come out not correct.
"""

from __future__ import annotations

import time

import pytest

from portbench import faults, spec
from portbench.flops.student import bn_act_bytes_per_step, epilogue_shapes, student_flops_per_frame
from portbench.generators import streams
from portbench.systems import student

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]
         if spec.cell(w["name"])["system"] == "student"]
SEED = 2**31 + 321
TINY_LIMIT = 1e-4  # the float32 program meets the reference to the last bit


def small(cell_name):
    cell = spec.cell(cell_name)
    cell["limits"] = {k: TINY_LIMIT for k in cell["limits"]}
    cell["traffic"].update(streams=4, pool_frames=3, warmup_steps=1, checked_steps=2,
                           traced_after=1, traced_steps=2)
    return cell


def run_small(cell, program=None, trace=0):
    """A window of exactly two steps (or those the traced phases need), both
    checked: which steps a fault meets does not hang on the host's speed."""
    return streams.run_cell(cell, SEED, 0.0, trace, "cpu", time.perf_counter(),
                            arch=student.tiny_arch(), image_size=64, program=program,
                            bench={"end_to_end": spec.end_to_end(BENCH, cell["name"]),
                                   "per_layer": spec.per_layer(BENCH, cell["name"])},
                            min_steps=2)


def control(config, seed, device, arch, *size):
    return student.Reference(config, seed, device, arch, *size,
                             policy=student.control_policy())


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell_name", CELLS)
def test_the_program_meets_the_reference_at_tiny(cell_name, trace):
    out, checks, _ = run_small(small(cell_name), trace=trace)
    assert out["correct"], checks
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(checks) == set(spec.cell(cell_name)["limits"])
    if trace:
        metrics = out["metrics"]
        assert metrics["host_uploads_per_step"]["value"] == 0
        for name in ("student_encoder_ms", "student_decoder_ms", "student_tail_ms",
                     "spade_ms", "mfu.student"):
            assert name in metrics
    else:
        assert set(out["metrics"]) == {"frames_per_s", "frame_p95_ms", "setup_s"}


@pytest.mark.parametrize("fault", ["control", *sorted(faults.SERVE), *sorted(student.FAULTS)])
@pytest.mark.parametrize("cell_name", CELLS)
def test_the_control_and_the_faults_are_not_correct(cell_name, fault):
    planted = {**faults.SERVE, **student.FAULTS}
    program = control if fault == "control" else planted[fault](student.Program)
    out, checks, _ = run_small(small(cell_name), program=program)
    assert not out["correct"], checks


def test_the_counts_from_the_shapes():
    config = spec.cell("student1024.stream8")["config"]
    assert student_flops_per_frame(config) == pytest.approx(1.0953e12, rel=1e-4)
    shapes = epilogue_shapes(config)
    assert len(shapes) == 23 and shapes[0] == (1, 512, 512, 64)
    assert all(s[-1] % 8 == 0 for s in shapes)  # every width K4 takes
    assert bn_act_bytes_per_step(config, 8) == pytest.approx(2.3237e9, rel=1e-4)
