"""The port's ``scripts/`` tools (``megaportraits_tpu_torch/scripts/``)
against the repo's JAX scripts, loaded from ``scripts/`` with importlib.

* Side by side: each JAX script and its port run on the same clips (mp4s
  written with cv2), with the functions that make the models and the steps
  replaced by cheap stubs (a state whose weight counts the steps taken,
  a teacher and a Student that are fixed functions of their inputs), so
  that no model compiles. Held equal: every batch the steps receive (bit
  for bit), the console lines less their timings, the held-out evaluation
  steps, the best snapshot's step, the export's step and weights, and the
  PNGs and RESULTS.txt the tools write. The JAX scripts' npz cache (a fixed
  /tmp path) is redirected into the test's directory, and so is the port's
  (``$TMPDIR``).
* For real: each port tool at TINY width on the CPU (2 or 3 steps on the
  same clips), with finite losses that move, an export that restores into
  a fresh Gbase bit for bit, and the teacher's K2 path switched on (on the
  CPU its wrapper runs the plain version, which counts nothing).
* ``check_device`` on the CPU reports no card and exits 0.
"""

import importlib.util
import json
import os
import re
import sys
import tempfile
import types

import numpy as np
import pytest
import torch
from torch import nn

import cv2
import jax.numpy as jnp
import optax
from PIL import Image

from megaportraits_tpu.core.checkpoint import CheckpointManager as JManager
from megaportraits_tpu.data import dataset as jdataset
from megaportraits_tpu.eval.heldout import HeldoutEvaluator as JEvaluator
from megaportraits_tpu.losses import perceptual as jperceptual
from megaportraits_tpu.models import genh as jgenh
from megaportraits_tpu.train import train_student as jtrain_student
from megaportraits_tpu.train.state import TrainState as JTrainState

from megaportraits_tpu_torch.core import config as tconfig
from megaportraits_tpu_torch.core.checkpoint import CheckpointManager
from megaportraits_tpu_torch.core.dtypes import FP32_POLICY
from megaportraits_tpu_torch.eval.heldout import HeldoutEvaluator
from megaportraits_tpu_torch.models.gbase import build_gbase
from megaportraits_tpu_torch.scripts import check_device, overfit, train_smoke
from megaportraits_tpu_torch.scripts import validate_student
from megaportraits_tpu_torch.train.state import TrainState, make_optimizer

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SIZE = 64
CLIPS = ["clipA", "clipB", "clipC"]
SCORES = {2: 10.0, 4: 12.5, 6: 11.0, 8: 12.0}  # held-out score by step


@pytest.fixture(scope="module")
def clip_dir(tmp_path_factory):
    """3 mp4 clips of 100 frames (96x96, a skin-toned disc that moves),
    a clip list naming the first two, and a tools' working directory."""
    d = tmp_path_factory.mktemp("clips")
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:96, 0:96]
    for n, vid in enumerate(CLIPS):
        writer = cv2.VideoWriter(str(d / f"{vid}.mp4"), cv2.VideoWriter_fourcc(*"mp4v"),
                                 25, (96, 96))
        base = rng.integers(0, 255, (96, 96, 3), dtype=np.uint8)
        base[(yy - 48) ** 2 + (xx - 40 - 4 * n) ** 2 < 30 ** 2] = (120, 150, 200)
        for i in range(100):
            writer.write(np.roll(base, i, axis=1))
        writer.release()
    with open(d / "overfit.json", "w") as f:
        json.dump({"clips": {vid: {} for vid in CLIPS[:2]}}, f)
    return d


def _load_jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}",
                                                  os.path.join(ROOT, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class _OsWithCache(types.ModuleType):
    """The os module, with makedirs of JAX's fixed cache path redirected."""

    def __init__(self, cache):
        super().__init__("os")
        self._cache = cache

    def __getattr__(self, name):
        return getattr(os, name)

    def makedirs(self, path, *args, **kwargs):
        return os.makedirs(self._cache if path == "/tmp/megaportraits_cache" else path,
                           *args, **kwargs)


def _redirect_caches(monkeypatch, tmp_path, jscript):
    """JAX's /tmp/megaportraits_cache -> tmp_path/jax_cache; the port's
    $TMPDIR (its cache and clip lists) -> tmp_path/port_tmp; JAX's clip
    lists (tempfile.gettempdir()) -> the same."""
    jcache = tmp_path / "jax_cache"
    jcache.mkdir()
    (tmp_path / "port_tmp").mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "port_tmp"))
    monkeypatch.setattr(jscript, "os", _OsWithCache(str(jcache)))

    class CachedDataset(jdataset.EMODataset):
        def __init__(self, *args, cache_dir=None, **kwargs):
            assert cache_dir == "/tmp/megaportraits_cache"
            super().__init__(*args, cache_dir=str(jcache), **kwargs)

    monkeypatch.setattr(jdataset, "EMODataset", CachedDataset)
    if hasattr(jscript, "EMODataset"):
        monkeypatch.setattr(jscript, "EMODataset", CachedDataset)


def _lines(text):
    """Console lines less their timings."""
    text = re.sub(r"\(\d+(\.\d+)?s\)", "(s)", text)
    text = re.sub(r"(init:|first step \(incl\. compile\):) \d+\.\d+ s", r"\1 s", text)
    return re.sub(r"steps in \d+\.\d+s", "steps in s", text).splitlines()


def _run(monkeypatch, capsys, where, fn):
    where.mkdir(exist_ok=True)
    monkeypatch.chdir(where)
    result = fn()
    return _lines(capsys.readouterr().out), result


def _arrays(batch):
    return {k: np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in batch.items()}


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _assert_same_files(jdir, tdir, suffix):
    names = sorted(n for n in os.listdir(jdir) if n.endswith(suffix))
    assert names and names == sorted(n for n in os.listdir(tdir) if n.endswith(suffix))
    for name in names:
        if suffix == ".png":
            np.testing.assert_array_equal(np.asarray(Image.open(tdir / name)),
                                          np.asarray(Image.open(jdir / name)))
        else:
            assert (tdir / name).read_text() == (jdir / name).read_text()
    return names


# -- one-weight states ---------------------------------------------------------------


def _jax_state(w=0.0):
    return JTrainState.create({"w": jnp.full((2,), w, jnp.float32)}, None, optax.sgd(0.1))


def _jax_advance(state, n=1):
    return state.replace(step=state.step + n, params={"w": state.params["w"] + n})


class _Weight(nn.Module):
    def __init__(self, w=0.0):
        super().__init__()
        self.w = nn.Parameter(torch.full((2,), w))


def _port_state():
    model = _Weight()
    return TrainState(model, make_optimizer(model, 0.1, 1))


def _port_advance(state, n=1):
    with torch.no_grad():
        state.model.w += n
    state.step += n
    return state


class _Recorder:
    def __init__(self):
        self.batches, self.built, self.evals = [], {}, []


def _stub_stage1(monkeypatch, jscript, tscript, jrec, trec):
    """init_states / make_train_step of both scripts: one-weight states and a
    step that records its batch and returns its driving frames as xhat;
    the held-out score is SCORES by step, the real consider runs."""
    def j_init_states(cfg, rng, policy, image_size):
        jrec.built.update(size=image_size, norm=cfg.model.norm, lr=cfg.training.lr,
                          steps_per_epoch=cfg.training.steps_per_epoch)
        return None, None, None, None, _jax_state(), _jax_state()

    def j_make_train_step(gbase, disc, ploss, p_vars, cfg, donate=True, pool_index=False):
        jrec.built["pool_index"] = pool_index

        def step(g, d, batch, *index):
            if index:
                batch = {k: v[index[0]] for k, v in batch.items()}
            jrec.batches.append(_arrays(batch))
            metrics = {"loss_G": jnp.float32(1.0 / (int(g.step) + 2)),
                       "loss_D": jnp.float32(0.25)}
            return _jax_advance(g), _jax_advance(d), metrics, batch["driving"]
        return step

    def t_init_states(cfg, seed, policy, device, image_size):
        trec.built.update(size=image_size, norm=cfg.model.norm, lr=cfg.training.lr,
                          steps_per_epoch=cfg.training.steps_per_epoch)
        return None, None, None, _port_state(), _port_state()

    def t_make_train_step(ploss, cfg, pool_index=False):
        trec.built["pool_index"] = pool_index

        def step(g, d, batch, *index):
            if index:
                batch = {k: v[index[0]] for k, v in batch.items()}
            trec.batches.append(_arrays(batch))
            metrics = {"loss_G": torch.tensor(1.0 / (g.step + 2)),
                       "loss_D": torch.tensor(0.25)}
            return _port_advance(g), _port_advance(d), metrics, batch["driving"]
        return step

    def j_psnr(self, s):
        jrec.evals.append(int(s.step))
        return SCORES[int(s.step)]

    def t_psnr(self, s):
        trec.evals.append(int(s.step))
        return SCORES[int(s.step)]

    monkeypatch.setattr(jscript, "init_states", j_init_states)
    monkeypatch.setattr(jscript, "make_train_step", j_make_train_step)
    monkeypatch.setattr(tscript, "init_states", t_init_states)
    monkeypatch.setattr(tscript, "make_train_step", t_make_train_step)
    monkeypatch.setattr(JEvaluator, "psnr", j_psnr)
    monkeypatch.setattr(HeldoutEvaluator, "psnr", t_psnr)


def _steps_on_disk(path):
    return sorted(int(n) for n in os.listdir(path) if n.isdigit())


# -- overfit -------------------------------------------------------------------------


OVERFIT_RUNS = {
    # --pool with held-out early stopping, the best at step 4 of 8, exported
    # as it improves, and the final state beside it.
    "pool_eval_export": ["--pool", "3", "--eval-every", "2", "--holdout", "2",
                         "--log-every", "3", "--steps", "8", "--export", "EXPORT"],
    # Fresh batches a step over every clip, burn-in past the best score.
    "all_clips_burn_in": ["--all-clips", "--eval-every", "2", "--eval-burn-in", "5",
                          "--steps", "6", "--log-every", "2", "--export", "EXPORT",
                          "--norm", "group", "--frames", "6", "--sample-rate", "5"],
    # No evaluator: the export of the final state.
    "plain_export": ["--steps", "3", "--log-every", "1", "--export", "EXPORT"],
}


@pytest.mark.parametrize("case", list(OVERFIT_RUNS))
def test_overfit_matches_the_jax_script(case, clip_dir, tmp_path, monkeypatch, capsys):
    jscript = _load_jax_script("overfit")
    _redirect_caches(monkeypatch, tmp_path, jscript)
    jrec, trec = _Recorder(), _Recorder()
    _stub_stage1(monkeypatch, jscript, overfit, jrec, trec)
    base = ["--size", str(SIZE), "--batch", "2", "--video-dir", str(clip_dir),
            "--json-file", str(clip_dir / "overfit.json")] + OVERFIT_RUNS[case]

    def args(side):
        return [str(tmp_path / side / "export") if a == "EXPORT" else a for a in base]

    monkeypatch.setattr(sys, "argv", ["overfit.py"] + args("jax"))
    jout, _ = _run(monkeypatch, capsys, tmp_path / "jax", jscript.main)
    tout, result = _run(monkeypatch, capsys, tmp_path / "port",
                        lambda: overfit.main(args("port") + ["--device", "cpu"]))
    assert [line.replace("/port/", "/jax/") for line in tout] == jout
    assert trec.built == jrec.built
    assert trec.built["size"] == SIZE and trec.built["lr"] == 3e-5
    _assert_batches_equal(trec.batches, jrec.batches)
    assert trec.evals == jrec.evals
    _assert_same_files(tmp_path / "jax" / "output_images", tmp_path / "port" / "output_images",
                       ".png")
    for suffix in ("", "_final"):
        jdir, tdir = str(tmp_path / "jax" / "export") + suffix, \
            str(tmp_path / "port" / "export") + suffix
        assert os.path.isdir(tdir) == (os.path.isdir(jdir) and bool(_steps_on_disk(jdir)))
        if not os.path.isdir(tdir):
            continue
        assert _steps_on_disk(tdir) == _steps_on_disk(jdir)
        step = _steps_on_disk(jdir)[-1]
        jw = JManager(jdir).restore({"g_variables": {"params": {"w": jnp.zeros(2)}}},
                                    step)["g_variables"]["params"]["w"]
        tw = torch.load(os.path.join(tdir, str(step), "checkpoint.pt"))["g_variables"]["w"]
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    want_export = {"pool_eval_export": 4, "all_clips_burn_in": 6, "plain_export": 3}[case]
    assert result["export_step"] == want_export
    if case == "pool_eval_export":
        assert trec.built["pool_index"] is True
        assert result["best_step"] == 4 and _steps_on_disk(str(tmp_path / "port" / "export"
                                                              ) + "_final") == [8]


def test_overfit_refuses_a_used_export_and_names_missing_clips(clip_dir, tmp_path):
    CheckpointManager(str(tmp_path / "export")).save(5, {"g_variables": _Weight()})
    with pytest.raises(SystemExit, match="already holds step 5; pass --export-clean"):
        overfit.open_export(overfit.parse_args(["--export", str(tmp_path / "export")]))
    default = overfit.parse_args([]).video_dir  # the reference's clips, not in the repo
    if not os.path.exists(default):
        with pytest.raises(FileNotFoundError, match=re.escape(default)):
            overfit.main(["--device", "cpu"])
    with pytest.raises(FileNotFoundError, match="nope.json"):
        overfit.main(["--device", "cpu", "--video-dir", str(clip_dir),
                      "--json-file", str(clip_dir / "nope.json")])


# -- train_smoke -----------------------------------------------------------------------


def test_train_smoke_matches_the_jax_script(tmp_path, monkeypatch, capsys):
    jscript = _load_jax_script("train_smoke")
    jrec, trec = _Recorder(), _Recorder()
    _stub_stage1(monkeypatch, jscript, train_smoke, jrec, trec)
    monkeypatch.setattr(sys, "argv", ["train_smoke.py", "32", "3", "2"])
    jout, _ = _run(monkeypatch, capsys, tmp_path / "jax", jscript.main)
    tout, result = _run(monkeypatch, capsys, tmp_path / "port",
                        lambda: train_smoke.main(["32", "3", "2", "--device", "cpu"]))
    assert tout == jout
    assert trec.built == jrec.built
    assert trec.built["size"] == 32 and trec.built["steps_per_epoch"] == 10
    _assert_batches_equal(trec.batches, jrec.batches)
    assert len(trec.batches) == 3 and trec.batches[0]["source"].shape == (3, 32, 32, 3)
    assert len(result["step_s"]) == 2


# -- validate_student ---------------------------------------------------------------------


class _JTeacher:
    """GHR's stand-in: ``init`` gives the one-weight tree."""

    def __init__(self, *args, **kwargs):
        pass

    def init(self, rng, *inputs):
        return {"params": {"gbase": {"w": jnp.zeros((2,), jnp.float32)},
                           "genh": {"w": jnp.zeros((2,), jnp.float32)}}}


class _TTeacher(nn.Module):
    def __init__(self):
        super().__init__()
        self.gbase, self.genh = _Weight(), _Weight()


# Products by powers of two are exact, so that a fused multiply-add in
# XLA's compiled Student gives the bits of PyTorch's separate operations.
def _target(xs, xd, wb, we, include_enh):
    return xs * 0.5 + xd * 0.25 + wb * 0.0625 + (we * 0.03125 + 0.125 if include_enh else 0.0)


def _student_out(xd, idx, w):
    return xd * 0.5 + w * 0.0078125 + idx.reshape(-1, 1, 1, 1) * 0.125


def _stub_student(monkeypatch, jrec, trec):
    """The teacher makes _target of its inputs and its grafted weights, the
    Student _student_out; the steps record their batches (target01
    included) and advance a one-weight state; LPIPS is the mean absolute
    difference."""
    class JStudent:
        def apply(self, v, xd, idx):
            return _student_out(xd, idx, v["params"]["w"][0])

    def j_init_student_state(cfg, rng, policy, size):
        jrec.built.update(size=size, avatars=cfg.training.num_avatars, lr=cfg.training.lr,
                          steps_per_epoch=cfg.training.steps_per_epoch,
                          epochs=cfg.training.student_epochs)
        return JStudent(), _jax_state()

    def j_make_student_train_step(student, teacher, t_vars, cfg, donate=True):
        def step(state, batch):
            jrec.batches.append(_arrays(batch))
            return _jax_advance(state), {"loss_student": jnp.float32(
                1.0 / (int(state.step) + 3))}
        return step

    def j_make_teacher_forward(teacher, t_vars, include_enh=True, bn_mode="running"):
        jrec.built.update(include_enh=include_enh, bn_mode=bn_mode)
        p = t_vars["params"]
        return lambda xs, xd: _target(jnp.asarray(xs), jnp.asarray(xd), p["gbase"]["w"][0],
                                      p["genh"]["w"][0], include_enh)

    class JLPIPS:
        def __init__(self, *args, **kwargs):
            pass

        def init(self, rng, *inputs):
            return {}

        def apply(self, v, a, b):
            return jnp.mean(jnp.abs(a - b), axis=(1, 2, 3))

    class TStudent(nn.Module):
        def __init__(self):
            super().__init__()
            self.w = nn.Parameter(torch.zeros(2))

        def forward(self, xd, idx, train=False):
            return _student_out(xd, idx.float(), self.w[0])

    def t_init_student_state(cfg, seed, policy, image_size, device):
        trec.built.update(size=image_size, avatars=cfg.training.num_avatars,
                          lr=cfg.training.lr, steps_per_epoch=cfg.training.steps_per_epoch,
                          epochs=cfg.training.student_epochs)
        student = TStudent()
        return student, TrainState(student, make_optimizer(student, 0.1, 1))

    def t_make_student_train_step(student, teacher, cfg):
        def step(state, batch):
            trec.batches.append(_arrays(batch))
            out = {"loss_student": torch.tensor(1.0 / (state.step + 3))}
            return _port_advance(state), out
        return step

    def t_make_teacher_forward(teacher, include_enh=True, bn_mode="running"):
        trec.built.update(include_enh=include_enh, bn_mode=bn_mode)
        return lambda xs, xd: _target(xs, xd, teacher.gbase.w[0].detach(),
                                      teacher.genh.w[0].detach(), include_enh)

    class TLPIPS(nn.Module):
        def __init__(self, *args, **kwargs):
            super().__init__()
            self.unused = nn.Parameter(torch.zeros(1))

        def forward(self, a, b):
            return torch.mean(torch.abs(a - b), dim=(1, 2, 3))

    def t_build_ghr(arch, policy, device, seed, use_chain_kernel):
        trec.built["use_chain_kernel"] = use_chain_kernel
        trec.built["teacher_policy"] = policy
        return _TTeacher()

    monkeypatch.setattr(jgenh, "GHR", _JTeacher)
    monkeypatch.setattr(jperceptual, "LPIPS", JLPIPS)
    monkeypatch.setattr(jtrain_student, "init_student_state", j_init_student_state)
    monkeypatch.setattr(jtrain_student, "make_student_train_step", j_make_student_train_step)
    monkeypatch.setattr(jtrain_student, "make_teacher_forward", j_make_teacher_forward)
    monkeypatch.setattr(validate_student, "build_ghr", t_build_ghr)
    monkeypatch.setattr(validate_student, "LPIPS", TLPIPS)
    monkeypatch.setattr(validate_student, "init_student_state", t_init_student_state)
    monkeypatch.setattr(validate_student, "make_student_train_step",
                        t_make_student_train_step)
    monkeypatch.setattr(validate_student, "make_teacher_forward", t_make_teacher_forward)


@pytest.mark.parametrize("teacher", ["random", "gbase", "gbase_genh"])
def test_validate_student_matches_the_jax_script(teacher, clip_dir, tmp_path, monkeypatch,
                                                 capsys):
    """Random teacher weights (GHR), a grafted Gbase export (Gbase-only,
    read from <dir>/export) and both exports (GHR); 3 avatars asked over 3
    clips, 55 steps (the loss printed at 0, 50 and 54)."""
    jscript = _load_jax_script("validate_student")
    _redirect_caches(monkeypatch, tmp_path, jscript)
    jrec, trec = _Recorder(), _Recorder()
    _stub_student(monkeypatch, jrec, trec)
    extra = []
    if teacher != "random":
        JManager(str(tmp_path / "jax_ckpt" / "g" / "export")).save(
            7, {"g_variables": {"params": {"w": jnp.full((2,), 3.0)}}}, wait=True)
        CheckpointManager(str(tmp_path / "port_ckpt" / "g" / "export")).save(
            7, {"g_variables": _Weight(3.0)})
        extra += ["--gbase-ckpt", "CKPT/g", "--teacher-bn-mode", "running"]
    if teacher == "gbase_genh":
        JManager(str(tmp_path / "jax_ckpt" / "e")).save(
            2, {"genh_variables": {"params": {"w": jnp.full((2,), 5.0)}}}, wait=True)
        CheckpointManager(str(tmp_path / "port_ckpt" / "e")).save(
            2, {"genh_variables": _Weight(5.0)})
        extra += ["--genh-ckpt", "CKPT/e"]
    base = ["--size", str(SIZE), "--steps", "55", "--batch", "2", "--num-avatars", "3",
            "--video-dir", str(clip_dir), "--lr", "1e-4", "--out", "quality"] + extra

    def args(side):
        return [a.replace("CKPT", str(tmp_path / f"{side}_ckpt")) for a in base]

    monkeypatch.setattr(sys, "argv", ["validate_student.py"] + args("jax"))
    jout, jrc = _run(monkeypatch, capsys, tmp_path / "jax", jscript.main)
    tout, trc = _run(monkeypatch, capsys, tmp_path / "port", lambda: validate_student.main(
        args("port") + ["--device", "cpu"]))
    assert jrc == trc == 0
    assert [line.replace("port_ckpt", "jax_ckpt") for line in tout] == jout
    assert trec.built.pop("use_chain_kernel") is False
    assert trec.built.pop("teacher_policy") == FP32_POLICY
    assert trec.built == jrec.built
    assert trec.built["include_enh"] == (teacher != "gbase")
    _assert_batches_equal(trec.batches, jrec.batches)
    assert len(trec.batches) == 55
    for b in trec.batches:  # the held-out last frame is never sampled
        assert set(np.unique(b["avatar_index"])) <= {0, 1, 2}
    jq, tq = tmp_path / "jax" / "quality", tmp_path / "port" / "quality"
    assert _assert_same_files(jq, tq, ".png") == [
        f"avatar{a}_teacher_vs_student.png" for a in range(3)]
    assert (tq / "RESULTS.txt").read_text().replace("port_ckpt", "jax_ckpt") == \
        (jq / "RESULTS.txt").read_text()


def test_validate_student_names_what_it_cannot_restore(clip_dir, tmp_path, monkeypatch,
                                                       capsys):
    jrec, trec = _Recorder(), _Recorder()
    _stub_student(monkeypatch, jrec, trec)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    with pytest.raises(SystemExit, match="--gbase-ckpt: nothing restorable at"):
        validate_student.main(["--size", str(SIZE), "--video-dir", str(clip_dir),
                               "--device", "cpu", "--gbase-ckpt", str(tmp_path / "none"),
                               "--use-chain-kernel"])
    assert trec.built["use_chain_kernel"] is True
    assert trec.built["teacher_policy"] == FP32_POLICY  # the switch keeps it float32


# -- the tools for real at TINY on the CPU ---------------------------------------------


@pytest.fixture
def tiny(monkeypatch, tmp_path):
    """The tools build TINY models; their cache and clip lists go to
    tmp_path."""
    def config():
        cfg = tconfig.Config()
        cfg.model.arch = "tiny"
        return cfg

    for module in (overfit, train_smoke, validate_student):
        monkeypatch.setattr(module, "Config", config)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.chdir(tmp_path)


def _finite_and_moving(first, last):
    assert np.isfinite(first) and np.isfinite(last)
    assert first != last


def test_train_smoke_runs_at_tiny(tiny, capsys):
    result = train_smoke.main(["64", "2", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "first step (incl. compile):" in out and "2 steps in" in out
    assert len(result["step_s"]) == 2
    for k in ("loss_G", "loss_D"):
        _finite_and_moving(result["metrics_first"][k], result["metrics"][k])
    assert all(np.isfinite(v) for v in result["metrics"].values())


@pytest.fixture
def one_cpu_thread():
    """PyTorch's multi-threaded CPU backward of the TINY Student's strided
    1x1 shortcut at 64x64 corrupts the heap (test_torch_port_train_stages.py,
    one_cpu_thread): the real Student trains here on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_overfit_and_validate_student_run_at_tiny(tiny, clip_dir, tmp_path, capsys,
                                                  one_cpu_thread):
    """overfit with a pool, held-out evaluation and an export; the export
    restores into a fresh TINY Gbase bit for bit; validate_student
    distils behind it with the chain-kernel switch and running statistics."""
    result = overfit.main(["--size", str(SIZE), "--steps", "3", "--batch", "2",
                           "--video-dir", str(clip_dir), "--json-file",
                           str(clip_dir / "overfit.json"), "--pool", "2", "--eval-every",
                           "1", "--holdout", "2", "--log-every", "1", "--export",
                           str(tmp_path / "export"), "--device", "cpu"])
    out = capsys.readouterr().out
    _finite_and_moving(result["first_loss_G"], result["final_loss_G"])
    assert re.findall(r"held-out self-PSNR (\S+) dB", out)[:3] and np.isfinite(
        result["best_psnr"])
    step = result["export_step"]
    assert step == result["best_step"] and _steps_on_disk(str(tmp_path / "export"))[-1] == step
    saved = torch.load(tmp_path / "export" / str(step) / "checkpoint.pt")["g_variables"]
    fresh = build_gbase("tiny", device="cpu", seed=5)
    CheckpointManager(str(tmp_path / "export")).restore({"g_variables": fresh}, step)
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, saved[k]), k

    assert validate_student.main([
        "--size", str(SIZE), "--steps", "3", "--batch", "2", "--video-dir", str(clip_dir),
        "--gbase-ckpt", str(tmp_path / "export"), "--teacher-bn-mode", "running",
        "--use-chain-kernel", "--out", str(tmp_path / "quality"), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "teacher: grafted trained Gbase from" in out
    losses = [float(x) for x in re.findall(r"distill MSE (\S+)", out)]
    assert len(losses) == 2
    _finite_and_moving(*losses)
    scores = re.findall(r"held-out MSE (\S+)  LPIPS (\S+)", out)
    assert len(scores) == 2 and all(np.isfinite(float(x)) for s in scores for x in s)
    assert (tmp_path / "quality" / "RESULTS.txt").exists()
    png = np.asarray(Image.open(tmp_path / "quality" / "avatar0_teacher_vs_student.png"))
    assert png.shape == (SIZE, 2 * SIZE, 3)


def test_check_device_on_the_cpu(capsys):
    assert check_device.main([]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "backend: cpu, devices: 1"
    assert "no CUDA card" in out[-1]
