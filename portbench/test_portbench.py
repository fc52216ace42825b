"""CPU tests of the benchmark (``python -m pytest portbench -q``).

The cells run here at the reference's TINY widths on 64-pixel images, the
program in float32 (the CPU lacks bf16 kernels the models use); the test
marked ``cuda`` runs a cell on the card and skips without one.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import pytest
import torch

from portbench import card, compare, faults, spec
from portbench.flops.peaks import BF16_FLOPS, HBM_BYTES_PER_S
from portbench.flops.trunk import bound_s, trunk_work
from portbench.generators import streams, train_steps
from portbench.systems import serve, train_base

BENCH = spec.benchmark()
SERVE_CELLS = [w["name"] for w in BENCH["workloads"]
               if spec.cell(w["name"])["system"] == "serve"]
TRAIN_CELLS = [w["name"] for w in BENCH["workloads"]
               if spec.cell(w["name"])["system"] == "train_base"]
SEED = 2**31 + 123
TINY_LIMIT = 1e-4  # the float32 program at TINY meets the reference to 5e-5


def small(cell_name):
    """The cell at TINY widths, 64 pixels, a few streams or rows, its
    numbers held to ``TINY_LIMIT``: the cell's own limits are for bf16
    rounding at full width, the float32 program here meets the reference to
    5e-5 (``calibrate.py`` reads the control and the faults at full
    width)."""
    cell = spec.cell(cell_name)
    cell["limits"] = {k: TINY_LIMIT for k in cell["limits"]}
    if cell["system"] == "serve":
        if cell["config"].get("hr_size"):
            cell["config"]["hr_size"] = 128
        cell["traffic"].update(streams=2, pool_frames=3, warmup_steps=1,
                               checked_steps=2, traced_after=1, traced_steps=2)
    else:
        cell["traffic"].update(batch=2, pool_batches=3, traced_after=0, traced_steps=1)
    return cell


def run_small(cell, program=None, trace=0):
    gen = streams if cell["system"] == "serve" else train_steps
    return gen.run_cell(cell, SEED, 0.2, trace, "cpu", time.perf_counter(),
                        arch=serve.tiny_arch(), image_size=64, program=program,
                        bench={"end_to_end": spec.end_to_end(BENCH, cell["name"]),
                               "per_layer": spec.per_layer(BENCH, cell["name"])},
                        min_steps=2)


# --- the manifest and the files it names --------------------------------

def test_manifest_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert all(not w.startswith("/") and ".." not in w for w in BENCH["command"])
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names))
    for name in names:
        spec.check_name(name)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert spec.UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


@pytest.mark.parametrize("cell_name", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_load(cell_name):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell_name)
    cell = spec.cell(cell_name)
    assert spec.load("workloads", cell_name)["config"] == entry["config"]
    assert spec.load("workloads", cell_name)["traffic"] == entry["traffic"]
    assert cell["chips"] == entry["chips"] == 1
    assert len(entry["why"]) <= 200
    reported = {m["name"] for m in spec.end_to_end(BENCH, cell_name)}
    assert "setup_s" in reported and len(reported) >= 2
    assert spec.per_layer(BENCH, cell_name)
    assert cell["limits"] and all(v > 0 for v in cell["limits"].values())


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    data = json.loads((spec.ROOT / config["file"]).read_text())
    assert data["name"] == config["name"] and data["source"] == config["source"]
    assert data["reduced"] == config["reduced"] == []
    assert data["use_bf16"] is True


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_has_a_reader_and_moves_a_reported_metric(metric):
    assert (spec.HERE / "metrics" / f"{metric['name']}.py").exists()
    for cell_name in metric["workloads"]:
        reported = {m["name"] for m in spec.end_to_end(BENCH, cell_name)}
        assert metric["moves"] in reported, (metric["name"], cell_name)


# --- what may be loaded ---------------------------------------------------

def test_forbidden_names_compare_whole_top_level_names():
    names = ["megaportraits_tpu_torch", "megaportraits_tpu_torch.models", "jaxtyping",
             "jax", "jax.numpy", "megaportraits_tpu.models", "flax.linen", "jaxlib"]
    assert card.forbidden_modules(names) == sorted(
        ["jax", "jax.numpy", "megaportraits_tpu.models", "flax.linen", "jaxlib"])
    assert card.FORBIDDEN == ("jax", "jaxlib", "flax", "megaportraits_tpu")


def _loaded_after(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted(sys.modules)))"],
                         capture_output=True, text=True, check=True, cwd=spec.ROOT)
    return {m.split(".")[0] for m in json.loads(out.stdout.splitlines()[-1])}


def test_harness_loads_neither_jax_nor_the_jax_package():
    tops = _loaded_after(
        "import portbench.run, portbench.calibrate, portbench.trace\n"
        "import portbench.systems.serve as s, portbench.systems.train_base as t\n"
        "import portbench.generators.streams, portbench.generators.train_steps\n"
        "import portbench.flops.model, portbench.flops.train\n"
        "import megaportraits_tpu_torch.infer.streaming, megaportraits_tpu_torch.train.train_base\n"
        "import megaportraits_tpu_torch.models.genh")
    assert not tops & set(card.FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    tops = _loaded_after(
        "import pkgutil, importlib, portbench.reference as r\n"
        "[importlib.import_module('portbench.reference.' + m.name)"
        " for m in pkgutil.iter_modules(r.__path__)]")
    assert not tops & ({"megaportraits_tpu_torch"} | set(card.FORBIDDEN))


# --- the counters -----------------------------------------------------------

def test_trunk_counter_matches_the_kernel_bound():
    config = spec.cell("gbase512.stream8")["config"]
    work = trunk_work(config, 1)
    assert work["flops"] == pytest.approx(309.237645312e9)
    assert bound_s(work, BF16_FLOPS, HBM_BYTES_PER_S) * 1e3 == pytest.approx(0.3127, abs=1e-4)
    assert trunk_work(config, 8)["flops"] == 8 * work["flops"]


def test_served_frame_counter():
    from portbench.flops.model import serve_flops_per_frame

    drive = serve_flops_per_frame(spec.cell("gbase512.stream8")["config"])
    hr = serve_flops_per_frame(spec.cell("ghr1024.stream4")["config"])
    assert drive == pytest.approx(532.2e9, rel=1e-3)
    assert hr - drive == pytest.approx(467.1e9, rel=1e-3)


# --- the reference against the port's plain path ------------------------------

@pytest.mark.parametrize("cell_name", SERVE_CELLS + TRAIN_CELLS)
def test_reference_agrees_with_the_port_at_tiny(cell_name):
    out, checks, _ = run_small(small(cell_name))
    assert out["correct"], checks
    assert out["failed"] == 0 and out["attempted"] > 0
    for c in checks.values():
        assert c["value"] <= TINY_LIMIT, checks


@pytest.mark.parametrize("cell_name", SERVE_CELLS)
def test_traced_serving_run_reads_its_ranges(cell_name):
    cell = small(cell_name)
    out, _, _ = run_small(cell, trace=1)
    assert out["correct"]
    assert out["device_extra"]["window_s"] > 0
    assert "breakdown" in out


def test_state_draw_is_seeded_and_shared():
    from portbench.reference.gbase import Gbase as RefGbase
    from portbench.reference.arch import TINY
    from portbench.seeded import draw_state

    from megaportraits_tpu_torch.core.arch import TINY as PTINY
    from megaportraits_tpu_torch.models.gbase import Gbase

    a = draw_state(RefGbase(arch=TINY), 7, "w", "cpu")
    b = draw_state(Gbase(arch=PTINY, device="cpu"), 7, "w", "cpu")
    assert list(a) == list(b)
    assert all(torch.equal(a[k], b[k]) for k in a)
    c = draw_state(RefGbase(arch=TINY), 8, "w", "cpu")
    assert not torch.equal(a["g2d.conv1x1.weight"], c["g2d.conv1x1.weight"])


def test_motion_statistics_reach_both_sides():
    """The motion encoder's BatchNorm statistics, set from the seed, are the
    same in the program and the reference, and not the drawn ones."""
    config = spec.cell("gbase512.stream8")["config"]
    prog = serve.Program(config, SEED, "cpu", serve.tiny_arch(), 64)
    ref = serve.Reference(config, SEED, "cpu", serve.tiny_arch(), 64)
    got = {k: v for k, v in prog.gbase.motion_encoder.state_dict().items()
           if k.endswith("running_var")}
    want = ref.gbase.motion_encoder.state_dict()
    assert got and all(torch.equal(v, want[k]) for k, v in got.items())
    assert any(v.max() > 1.5 or v.min() < 0.5 for v in got.values())


# --- the control and the faults must come out not correct ---------------------

@pytest.mark.parametrize("cell_name", SERVE_CELLS + TRAIN_CELLS)
def test_control_is_not_correct(cell_name):
    """The reference with fp8 operands in the program's place."""
    system = serve if cell_name in SERVE_CELLS else train_base

    def control(config, seed, device, arch, *size):
        return system.Reference(config, seed, device, arch, *size,
                                policy=system.control_policy())

    out, checks, _ = run_small(small(cell_name), program=control)
    assert not out["correct"], checks


@pytest.mark.parametrize("fault", sorted(faults.SERVE))
@pytest.mark.parametrize("cell_name", SERVE_CELLS)
def test_serving_faults_are_not_correct(cell_name, fault):
    cell = small(cell_name)
    out, checks, _ = run_small(cell)
    assert out["correct"], checks
    out, checks, _ = run_small(cell, program=faults.SERVE[fault](serve.Program))
    assert not out["correct"], checks


@pytest.mark.parametrize("fault", sorted(faults.TRAIN))
@pytest.mark.parametrize("cell_name", TRAIN_CELLS)
def test_training_faults_are_not_correct(cell_name, fault):
    out, checks, _ = run_small(small(cell_name), program=faults.TRAIN[fault](train_base.Program))
    assert not out["correct"], checks


def test_judge_holds_each_number_to_its_limit():
    ok, checks = compare.judge({"a": 1.0, "b": 2.0}, {"a": 1.0, "b": 1.5})
    assert not ok and checks["a"] == {"value": 1.0, "limit": 1.0}
    assert compare.frame_gaps([])["frame_max_abs"] == float("inf")
    row = {"warp": torch.ones(2, 3)}
    assert compare.row_gaps([(row, row)], ["warp"]) == {"warp_rel": 0.0}
    assert compare.row_gaps([], ["warp"])["warp_rel"] == float("inf")
    short = {"warp": torch.ones(1, 3)}
    assert compare.row_gaps([(short, row)], ["warp"])["warp_rel"] == float("inf")


# --- on the card ------------------------------------------------------------

@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "gbase512.stream8", "--seed", str(SEED), "--seconds", "2",
                          "--trace", "0"], capture_output=True, text=True, cwd=spec.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
