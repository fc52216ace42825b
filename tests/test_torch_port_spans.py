"""The port's spans and counters (``utils/profiling.py``) at TINY on the CPU.

A span records only under a ``torch.profiler`` capture; it is then a
``user_annotation`` range in the Chrome trace and a record in memory. The
counters count per-call parameter casts and tensors made from host data.
On the card the bf16 policy casts every float32 parameter per call; the
CPU lacks bf16 kernels that the models use, so the tests that count casts
hold float64 parameters and compute in float32, which casts at the same
sites.
"""

import contextlib
import json
import re
from pathlib import Path

import pytest
import torch

from megaportraits_tpu_torch.core import config as tconfig
from megaportraits_tpu_torch.core.arch import TINY
from megaportraits_tpu_torch.core.dtypes import FP32_POLICY, Policy
from megaportraits_tpu_torch.infer.streaming import ReenactmentSession
from megaportraits_tpu_torch.models.gbase import build_gbase
from megaportraits_tpu_torch.models.genh import build_genh
from megaportraits_tpu_torch.ops.kernels.conv3x3 import conv3x3_bn_act
from megaportraits_tpu_torch.ops.kernels.resblock_chain import resblock_chain
from megaportraits_tpu_torch.train.train_base import init_states, make_train_step
from megaportraits_tpu_torch.utils import profiling

from torch_port_utils import engaged_on_cpu  # noqa: F401  (a fixture)

SIZE = 64
CASTING = Policy(param_dtype=torch.float64, compute_dtype=torch.float32)
# The ranges the benchmark's traced run opens around the program's layers
# (portbench/trace.py): a span of the same name would be counted as theirs.
HARNESS_RANGES = ("motion_encoder", "warp_generator_c2d", "g2d", "trunk", "genh",
                  "perceptual", "portbench.window")
DRIVE_TREE = {"session.step": ["gbase.emtn", "gbase.warpgen_c2d", "gbase.warp", "gbase.g2d"],
              "gbase.g2d": ["g2d.head", "g2d.trunk", "g2d.decoder"]}
TRAIN_PHASES = ["train.g_forward", "train.g_backward", "train.d_step", "train.optimizer"]
# Of the trace's clock against time.time_ns(): the exported microseconds
# round to the nanosecond, the clocks agree to a few microseconds.
CLOCK_TOLERANCE_NS = 50_000
IMAGES = ("source", "driving", "source_next", "source_star", "driving_star")


def _session(policy=FP32_POLICY):
    gbase = build_gbase(TINY, policy=policy, device="cpu", seed=3)
    session = ReenactmentSession(model=gbase)
    session.set_source(_frames(0))
    return session


def _frames(seed, b=2):
    gen = torch.Generator().manual_seed(seed)
    return torch.rand(b, SIZE, SIZE, 3, generator=gen)


def _traced(tmp_path, fn):
    """`fn()` under ``profiling.trace``: (its result, the spans written
    beside the trace, the trace's events)."""
    with profiling.trace(str(tmp_path)):
        out = fn()
    spans = json.loads((tmp_path / profiling.SPANS_FILE).read_text())
    trace = json.loads((tmp_path / profiling.TRACE_FILE).read_text())
    return out, spans, trace


def _children(spans):
    """{parent name: [child names in order]} of a list of records."""
    names = {r["index"]: r["name"] for r in spans}
    tree = {}
    for r in spans:
        if r["parent"] is not None:
            tree.setdefault(names[r["parent"]], []).append(r["name"])
    return tree


def _train_step(remat):
    cfg = tconfig.Config()
    cfg.model.arch = "tiny"
    cfg.data.train_width = cfg.data.train_height = SIZE
    cfg.training.steps_per_epoch = 1
    _, _, ploss, g_state, d_state = init_states(cfg, policy=FP32_POLICY, device="cpu",
                                                remat_mode=remat)
    gen = torch.Generator().manual_seed(5)
    batch = {k: torch.rand(1, SIZE, SIZE, 3, generator=gen) for k in IMAGES}
    step = make_train_step(ploss, cfg)
    return lambda: step(g_state, d_state, batch)


def test_without_a_capture_annotate_is_one_null_context_and_records_nothing():
    session = _session()
    first, second = profiling.annotate("a.b"), profiling.annotate("c.d")
    assert first is second and isinstance(first, contextlib.nullcontext)
    before = profiling.spans()
    session(_frames(1))
    assert profiling.spans() == before


def test_a_drive_records_its_stages_under_one_step(tmp_path):
    session = _session()
    session(_frames(1))
    _, spans, _ = _traced(tmp_path, lambda: session(_frames(1)))
    assert [r["name"] for r in spans if r["parent"] is None] == ["session.step"]
    assert _children(spans) == DRIVE_TREE
    assert len({r["step"] for r in spans}) == 1
    assert spans == profiling.spans()[-len(spans):]
    assert all(r["start_ns"] <= r["end_ns"] for r in spans)


def test_a_span_outside_every_root_takes_the_last_steps_id(tmp_path):
    """Stage 2 as served: Genh after the session's step is a root of its
    own in that step, with its counters."""
    session = _session()
    genh = build_genh(TINY, policy=FP32_POLICY, device="cpu", seed=4).eval()

    def serve():
        with torch.no_grad():
            return genh(session(_frames(1)))

    _, spans, _ = _traced(tmp_path, serve)
    roots = [r for r in spans if r["parent"] is None]
    assert [r["name"] for r in roots] == ["session.step", "genh.forward"]
    assert roots[0]["step"] == roots[1]["step"]
    assert all("param_casts" in r["counters"] for r in roots)


def test_a_training_step_records_its_phases(tmp_path):
    step = _train_step("none")
    _, spans, _ = _traced(tmp_path, step)
    assert [r["name"] for r in spans if r["parent"] is None] == ["train.step"]
    tree = _children(spans)
    assert tree["train.step"] == TRAIN_PHASES
    assert tree["train.g_forward"].count("losses.perceptual") == 3
    assert tree["train.g_forward"].count("g2d.head") == 1
    assert len({r["step"] for r in spans}) == 1


def test_remat_recompute_falls_inside_the_backward_span(tmp_path):
    """Remat 'selective' runs G2d again in G's backward: its spans there
    are children of ``train.g_backward``."""
    _, spans, _ = _traced(tmp_path, _train_step("selective"))
    phase = {r["name"]: r["index"] for r in spans if r["name"] in TRAIN_PHASES}
    heads = [r["parent"] for r in spans if r["name"] == "g2d.head"]
    assert heads == [phase["train.g_forward"], phase["train.g_backward"]]


def test_each_span_lies_inside_its_trace_event(tmp_path):
    session = _session()
    session(_frames(1))
    _, spans, trace = _traced(tmp_path, lambda: [session(_frames(1)) for _ in range(2)])
    base = trace["baseTimeNanoseconds"]
    events = {}
    for e in sorted((e for e in trace["traceEvents"] if e.get("cat") == "user_annotation"),
                    key=lambda e: e["ts"]):
        events.setdefault(e["name"], []).append(e)
    seen = {}
    for r in spans:
        k = seen[r["name"]] = seen.get(r["name"], -1) + 1
        e = events[r["name"]][k]
        start = base + e["ts"] * 1000
        end = start + e["dur"] * 1000
        assert start - CLOCK_TOLERANCE_NS <= r["start_ns"], (r, e)
        assert r["end_ns"] <= end + CLOCK_TOLERANCE_NS, (r, e)
    assert seen == {name: len(events[name]) - 1 for name in seen}
    assert len(spans) == 2 * (1 + 4 + 3)


def test_counters_repeat_exactly_from_one_drive_to_the_next(tmp_path):
    session = _session(CASTING)
    frames = _frames(1)
    snaps = [profiling.counters()]
    for _ in range(3):
        session(frames)
        snaps.append(profiling.counters())
    deltas = [{k: b[k] - a[k] for k in a} for a, b in zip(snaps, snaps[1:])]
    assert deltas[0] == deltas[1] == deltas[2]
    assert deltas[0]["param_casts"] > 0
    assert deltas[0]["param_casts.TorchConv"] > 0
    assert deltas[0]["param_casts.WarpGenerator"] == 1
    assert deltas[0]["host_uploads"] == 3
    assert deltas[0]["host_uploads.apply_warping_field"] == 2
    assert deltas[0]["host_uploads.affine_grid_3d"] == 1
    _, spans, _ = _traced(tmp_path, lambda: session(frames))
    root = next(r for r in spans if r["parent"] is None)
    assert root["counters"] == deltas[0]


def test_a_float32_policy_casts_nothing():
    session = _session()
    before = profiling.counters()
    session(_frames(1))
    after = profiling.counters()
    assert after["param_casts"] == before["param_casts"]
    assert after["host_uploads"] == before["host_uploads"] + 3


def test_counters_hold_the_kernel_launches_and_the_trunk_folds(engaged_on_cpu):
    """With the kernels' gate opened on the CPU the trunk folds its K2
    operands at its first call, and each K4 epilogue its own, once."""
    session = _session()
    snap = profiling.counters()
    assert snap["launches.conv3x3_bn_act"] == conv3x3_bn_act.launches
    assert snap["launches.resblock_chain"] == resblock_chain.launches
    assert "launches.fused_resblock_chain" in snap
    folds = session.model.g2d.trunk_cache.folds
    session(_frames(1))
    first = profiling.counters()["folds"]
    session(_frames(2))
    assert session.model.g2d.trunk_cache.folds == folds + 1
    # The first frame's new folds: the trunk's and the two epilogues of
    # each of G2d's three decoder blocks (Emtn's folded at set_source).
    assert first == snap["folds"] + 1 + 2 * 3
    assert profiling.counters()["folds"] == first


def test_frames_are_the_same_with_the_capture_on_and_off(tmp_path):
    session = _session()
    frames = _frames(1)
    off = session(frames)
    on, spans, _ = _traced(tmp_path, lambda: session(frames))
    assert spans and torch.equal(on, off)


def test_span_names_carry_a_dot_and_none_is_a_harness_range():
    root = Path(profiling.__file__).resolve().parents[1]
    names = {m for p in root.rglob("*.py")
             for m in re.findall(r'annotate\("([^"]+)"\)', p.read_text())}
    assert set(DRIVE_TREE["session.step"] + DRIVE_TREE["gbase.g2d"] + TRAIN_PHASES) <= names
    assert {"session.step", "session.encode_source", "genh.forward", "train.step",
            "losses.perceptual"} <= names
    for name in names:
        assert "." in name and name not in HARNESS_RANGES, name
    assert set(profiling.STEP_ROOTS) <= names


@pytest.mark.parametrize("name", ["session.step", "train.step"])
def test_each_step_root_opens_a_new_step(tmp_path, name):
    def nest():
        with profiling.annotate(name):
            with profiling.annotate("inner.span"):
                pass
        with profiling.annotate("after.root"):
            pass
        with profiling.annotate(name):
            pass

    _, spans, _ = _traced(tmp_path, nest)
    steps = [r["step"] for r in spans]
    assert steps[0] == steps[1] == steps[2] and steps[3] == steps[0] + 1
    assert [r["parent"] for r in spans] == [None, spans[0]["index"], None, None]
