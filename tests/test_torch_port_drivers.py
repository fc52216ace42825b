"""The port's held-out evaluator, the stage-1 step's ``unroll`` and
``pool_index``, and the three training drivers, against the JAX package.

* ``HeldoutEvaluator``: the cases of ``tests/test_heldout.py``, scored by
  both packages on the same weights (TINY, FP32, 64x64; numpy draws bridged
  to the port). Tolerance 1e-3 dB on a score (measured up to 1.9e-6 dB for
  ``for_gbase`` and 4.8e-7 dB for ``for_genh``, whose box-mean inputs equal
  cv2's at x2 here). The port's own contract besides: scoring writes
  nothing into the model, and a snapshot is not moved by later steps.
* ``make_train_step``: ``unroll=2`` and ``pool_index`` against single steps
  of the same step function, bit for bit (the same float32 operations in
  the same order on the CPU).
* The drivers' bookkeeping: each JAX driver and its port run side by side
  on the same npz-cached clips, with the functions that make the models and
  the steps replaced by cheap stubs (a state whose weight counts the steps
  taken), so that no model compiles. Held equal: every batch the steps receive (bit for
  bit; the box mean within 1e-6 of cv2's INTER_AREA), the console lines
  (less the it/s rates), the checkpoint and export steps on disk, the
  exported weights, the resume, the debug PNGs pixel for pixel, and what
  those functions were given.
"""

import dataclasses
import json
import os
import re
import types

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp
import optax

from megaportraits_tpu.core import config as jconfig
from megaportraits_tpu.core.arch import TINY as JTINY
from megaportraits_tpu.core.checkpoint import CheckpointManager as JManager
from megaportraits_tpu.core.dtypes import FP32_POLICY as JP
from megaportraits_tpu.eval.heldout import HeldoutEvaluator as JEvaluator
from megaportraits_tpu.models.gbase import Gbase as JGbase
from megaportraits_tpu.models.genh import Genh as JGenh
from megaportraits_tpu.parallel import mesh as jmesh
from megaportraits_tpu.train import main_base as jmain_base
from megaportraits_tpu.train import main_hr as jmain_hr
from megaportraits_tpu.train import main_student as jmain_student
from megaportraits_tpu.train.state import TrainState as JTrainState

from megaportraits_tpu_torch.core import config as tconfig
from megaportraits_tpu_torch.core.checkpoint import CheckpointManager
from megaportraits_tpu_torch.core.arch import TINY
from megaportraits_tpu_torch.core.dtypes import FP32_POLICY
from megaportraits_tpu_torch.eval.heldout import HeldoutEvaluator
from megaportraits_tpu_torch.models.gbase import Gbase
from megaportraits_tpu_torch.models.genh import Genh
from megaportraits_tpu_torch.ops.kernels import resblock_chain as k2
from megaportraits_tpu_torch.train import main_base, main_hr, main_student
from megaportraits_tpu_torch.train.state import TrainState, make_optimizer
from megaportraits_tpu_torch.train.train_base import init_states, make_train_step
from megaportraits_tpu_torch.utils.jax_bridge import load_jax_variables

from torch_port_utils import numpy_init

SIZE = 64
BATCH = 2
SCORE_TOL = 1e-3  # dB


@pytest.fixture(autouse=True)
def one_cpu_thread():
    """The port's models here run small CPU ops, which on PyTorch's thread
    pool beside the other test workers' pools spend their time waiting for
    cores (a test ran 30 to 100 times slower in the parallel run than
    alone); on one thread they do not."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- HeldoutEvaluator -------------------------------------------------------


class _JState:
    def __init__(self, variables):
        self.params = variables["params"]
        self.batch_stats = variables.get("batch_stats")


def _clips(n_clips, n_frames, size=SIZE, seed=0):
    rng = np.random.default_rng(seed)
    return {f"clip{i}": rng.uniform(0, 1, (n_frames, size, size, 3)).astype(np.float32)
            for i in range(n_clips)}


def _gbase_pair(norm):
    arch = dataclasses.replace(JTINY, norm=norm)
    jm = JGbase(policy=JP, arch=arch)
    x = jnp.zeros((BATCH, SIZE, SIZE, 3), jnp.float32)
    v = numpy_init(jm, x, x, seed=0, stats_seed=1)
    model = load_jax_variables(
        Gbase(policy=FP32_POLICY, arch=dataclasses.replace(TINY, norm=norm), device="cpu"), v)
    return jm, _JState(v), model


def _state(model):
    """The evaluator scores a state's ``model``, as of a ``TrainState``."""
    return types.SimpleNamespace(model=model)


@pytest.fixture(scope="module")
def gbases():
    return {norm: _gbase_pair(norm) for norm in ("batch", "group")}


@pytest.mark.parametrize("case", [
    dict(norm="batch", clips=(2, 8), holdout=3, bn_mode="batch", pairs=6),
    dict(norm="batch", clips=(1, 8), holdout=3, bn_mode="batch", pairs=3),  # padded tail
    dict(norm="batch", clips=(2, 8), holdout=2, bn_mode="running", pairs=4),
    dict(norm="group", clips=(1, 8), holdout=2, bn_mode="running", pairs=2),
    dict(norm="batch", clips=(1, 3), holdout=4, bn_mode="batch", pairs=0),  # no pairs
], ids=["batch", "padded_tail", "running", "running_group", "no_pairs"])
def test_for_gbase_scores_match_jax(gbases, case):
    jm, jstate, model = gbases[case["norm"]]
    clips = _clips(*case["clips"])
    kw = dict(holdout=case["holdout"], batch_size=BATCH, bn_mode=case["bn_mode"])
    jev = JEvaluator.for_gbase(jm, clips, **kw)
    ev = HeldoutEvaluator.for_gbase(model, clips, **kw)
    assert ev.n_pairs == jev.n_pairs == case["pairs"]
    got, want = ev.psnr(_state(model)), jev.psnr(jstate)
    if not case["pairs"]:
        assert got == want == float("-inf")
        variables, step, is_best = ev.export_variables(_state(model))
        assert not is_best and step == -1 and variables.keys() == model.state_dict().keys()
        return
    assert np.isfinite(got)
    assert abs(got - want) <= SCORE_TOL, (got, want)


def test_consider_tracks_the_best_and_leaves_the_model_alone(gbases):
    _, _, model = gbases["batch"]
    ev = HeldoutEvaluator.for_gbase(model, _clips(2, 8), holdout=2, batch_size=BATCH,
                                    burn_in=20)
    model.train()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = _state(model)
    score, improved = ev.consider(state, step=10)  # before burn-in: no snapshot
    assert np.isfinite(score) and not improved and ev.best_variables is None
    score2, improved2 = ev.consider(state, step=20)
    assert score2 == score and improved2 and ev.best_step == 20
    score3, improved3 = ev.consider(state, step=30)
    assert score3 == score and not improved3 and ev.best_step == 20
    # Train-mode BatchNorm inside the scoring forward recorded nothing.
    assert model.training
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    variables, step, is_best = ev.export_variables(state)
    assert is_best and step == 20
    assert all(v.device.type == "cpu" for v in variables.values())


def test_the_best_snapshot_survives_a_later_step():
    cfg = tconfig.Config()
    cfg.model.arch = "tiny"
    cfg.training.steps_per_epoch = 1
    gbase, _, ploss, g_state, d_state = init_states(cfg, seed=0, policy=FP32_POLICY,
                                                   device="cpu")
    rng = np.random.default_rng(3)
    batch = {k: torch.from_numpy(rng.random((BATCH, SIZE, SIZE, 3), dtype=np.float32))
             for k in ("source", "driving", "source_next", "source_star", "driving_star")}
    ev = HeldoutEvaluator.for_gbase(gbase, _clips(1, 4), holdout=2, batch_size=BATCH)
    ev.consider(g_state, step=1)
    snapshot = {k: v.clone() for k, v in ev.best_variables.items()}
    make_train_step(ploss, cfg)(g_state, d_state, batch)
    exported, step, is_best = ev.export_variables(g_state)
    assert is_best and step == 1
    for k, v in exported.items():
        assert torch.equal(v, snapshot[k]), k
    assert not torch.equal(gbase.state_dict()["g2d.res0.conv1.weight"],
                           exported["g2d.res0.conv1.weight"])


def test_for_genh_scores_match_jax_and_run_k2_once_a_row(monkeypatch):
    """Stage 2: the frozen Gbase (trunk on K2's wrapper, its plain version
    on the CPU) at 64, x2, Genh at 128; 3 pairs in batches of 2, so the
    padded row runs through K2 too."""
    calls = []
    wrapped = k2.resblock_chain
    monkeypatch.setattr(k2, "resblock_chain", lambda *a: calls.append(1) or wrapped(*a))
    jgbase, jgstate, gbase = _gbase_pair("batch")
    gbase.g2d.use_chain_kernel = True
    jgenh = JGenh(policy=JP, arch=JTINY)
    xhr = jnp.zeros((BATCH, 2 * SIZE, 2 * SIZE, 3), jnp.float32)
    gv = numpy_init(jgenh, xhr, seed=4, stats_seed=5)
    genh = load_jax_variables(Genh(policy=FP32_POLICY, arch=TINY, device="cpu"), gv)
    clips_hr = _clips(1, 8, size=2 * SIZE, seed=6)
    kw = dict(holdout=3, batch_size=BATCH, base_size=SIZE, upscale=2)
    jev = JEvaluator.for_genh(jgenh, jgbase, {"params": jgstate.params,
                                              "batch_stats": jgstate.batch_stats},
                              clips_hr, **kw)
    ev = HeldoutEvaluator.for_genh(genh, gbase, clips_hr, **kw)
    assert ev.n_pairs == jev.n_pairs == 3
    np.testing.assert_array_equal(ev.tgt, jev.tgt)
    np.testing.assert_allclose(ev.src, jev.src, rtol=0, atol=1e-6)
    np.testing.assert_allclose(ev.drv, jev.drv, rtol=0, atol=1e-6)
    genh.train()
    before = {k: v.clone() for k, v in genh.state_dict().items()}
    score, improved = ev.consider(_state(genh), step=5)
    assert improved and ev.best_step == 5
    assert abs(score - jev.psnr(_JState(gv))) <= SCORE_TOL
    assert len(calls) == 4  # 2 batches of 2 rows, the padded row included
    assert genh.training
    assert all(torch.equal(v, before[k]) for k, v in genh.state_dict().items())


# -- make_train_step: unroll and pool_index ---------------------------------


def _fresh_states():
    cfg = tconfig.Config()
    cfg.model.arch = "tiny"
    cfg.training.steps_per_epoch = 1
    _, _, ploss, g_state, d_state = init_states(cfg, seed=0, policy=FP32_POLICY,
                                                device="cpu")
    return cfg, ploss, g_state, d_state


def _assert_same_states(a, b):
    for sa, sb in zip(a, b, strict=True):
        assert sa.step == sb.step
        for k, v in sa.model.state_dict().items():
            assert torch.equal(v, sb.model.state_dict()[k]), k
        for p, q in zip(sa.params, sb.params, strict=True):
            for k, v in sa.tx.adamw.state[p].items():
                assert torch.equal(v, sb.tx.adamw.state[q][k]), k


def test_unroll_and_pool_index_equal_single_steps():
    rng = np.random.default_rng(7)
    pool = {k: torch.from_numpy(rng.random((2, BATCH, SIZE, SIZE, 3), dtype=np.float32))
            for k in ("source", "driving", "source_next", "source_star", "driving_star")}
    cfg, ploss, *single = _fresh_states()
    step = make_train_step(ploss, cfg)
    for i in range(2):
        *single, metrics, xhat = step(*single, {k: v[i] for k, v in pool.items()})

    _, ploss_u, *unrolled = _fresh_states()
    *unrolled, metrics_u, xhat_u = make_train_step(ploss_u, cfg, unroll=2)(*unrolled, pool)
    assert xhat_u is None
    assert metrics_u.keys() == metrics.keys()
    for k, v in metrics.items():
        assert torch.equal(metrics_u[k], v), k
    _assert_same_states(unrolled, single)

    _, ploss_p, *pooled = _fresh_states()
    pool_step = make_train_step(ploss_p, cfg, pool_index=True)
    for i in range(2):
        *pooled, metrics_p, xhat_p = pool_step(*pooled, pool, i)
    assert torch.equal(xhat_p, xhat)
    for k, v in metrics.items():
        assert torch.equal(metrics_p[k], v), k
    _assert_same_states(pooled, single)

    with pytest.raises(ValueError, match="mutually exclusive"):
        make_train_step(ploss, cfg, unroll=2, pool_index=True)


# -- the drivers' bookkeeping -------------------------------------------------

CLIP_IDS = ("a", "b", "c")
FRAMES = 6
SCORES = {2: 10.0, 3: 10.5, 4: 12.0, 6: 11.0, 8: 13.0}


@pytest.fixture(scope="module")
def clip_dir(tmp_path_factory):
    """npz caches of 3 clips at 64 and 128, and the clip list."""
    d = tmp_path_factory.mktemp("clips")
    rng = np.random.default_rng(11)
    for vid in CLIP_IDS:
        for s in (SIZE, 2 * SIZE):
            np.savez(d / f"{vid}_{s}x{s}_tensors.npz",
                     source_frames=rng.random((FRAMES, s, s, 3), dtype=np.float32),
                     driving_frames=rng.random((FRAMES, s, s, 3), dtype=np.float32))
    with open(d / "meta.json", "w") as f:
        json.dump({"clips": {vid: {} for vid in CLIP_IDS}}, f)
    return d


def _configs(clip_dir, tmp_path, **training):
    """(JAX config, port config) alike, checkpoints apart."""
    out = []
    for module, name in ((jconfig, "jax"), (tconfig, "port")):
        cfg = module.Config()
        cfg.model.arch = "tiny"
        cfg.data.train_width = cfg.data.train_height = SIZE
        t = cfg.training
        t.video_dir, t.json_file = str(clip_dir), str(clip_dir / "meta.json")
        t.checkpoint_path = str(tmp_path / name / "ckpt")
        t.batch_size, t.n_sample_frames, t.use_bf16 = BATCH, FRAMES, False
        for k, v in training.items():
            setattr(t, k, v)
        out.append(cfg)
    return out


def _arrays(batch):
    return {k: np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in batch.items()}


class _Recorder:
    """What a driver handed the stubbed functions and steps."""

    def __init__(self):
        self.batches, self.built = [], {}


def _jax_state(w=0.0):
    return JTrainState.create({"w": jnp.full((2,), w, jnp.float32)}, None, optax.sgd(0.1))


def _jax_advance(state, n):
    return state.replace(step=state.step + n, params={"w": state.params["w"] + n})


class _Weight(nn.Module):
    def __init__(self, w=0.0):
        super().__init__()
        self.w = nn.Parameter(torch.full((2,), w))


def _port_state():
    model = _Weight()
    return TrainState(model, make_optimizer(model, 0.1, 1))


def _port_advance(state, n):
    with torch.no_grad():
        state.model.w += n
    state.step += n
    return state


def _patch_scores(monkeypatch):
    """Both evaluators score a state by its step (SCORES); the real
    ``consider`` and ``export_variables`` run."""
    monkeypatch.setattr(JEvaluator, "psnr", lambda self, s: SCORES[int(s.step)])
    monkeypatch.setattr(HeldoutEvaluator, "psnr", lambda self, s: SCORES[int(s.step)])


def _one_device_mesh(monkeypatch, module):
    monkeypatch.setattr(module, "make_mesh",
                        lambda shape=None, **kw: jmesh.make_mesh({"data": 1},
                                                                 devices=jax.devices()[:1]))


def _lines(text):
    return [re.sub(r"\(\d+\.\d+ it/s\)", "(it/s)", line) for line in text.splitlines()]


def _steps_on_disk(path):
    return sorted(int(n) for n in os.listdir(path) if n.isdigit())


def _port_export(path, key):
    step = _steps_on_disk(path)[-1]
    return step, torch.load(os.path.join(path, str(step), "checkpoint.pt"))[key]


def _jax_export(path, key, like):
    step = _steps_on_disk(path)[-1]
    return step, JManager(path).restore({key: like}, step)[key]


def _assert_batches_equal(got, want, atol=0.0):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=atol, err_msg=k)


def _stub_base(monkeypatch, jrec, trec):
    def j_init_states(cfg, rng, policy):
        jrec.built["steps_per_epoch"] = cfg.training.steps_per_epoch
        return None, None, None, None, _jax_state(), _jax_state()

    def j_make_train_step(gbase, disc, ploss, p_vars, cfg, unroll=1):
        def step(g, d, batch):
            jrec.batches.append(_arrays(batch))
            metrics = {"loss_G": jnp.float32(int(g.step) + 0.5), "loss_D": jnp.float32(0.25)}
            return (_jax_advance(g, unroll), _jax_advance(d, unroll), metrics,
                    batch["driving"] if unroll == 1 else None)
        return step

    def t_init_states(cfg, seed, policy, device, mesh=None):
        trec.built["steps_per_epoch"] = cfg.training.steps_per_epoch
        return None, None, None, _port_state(), _port_state()

    def t_make_train_step(ploss, cfg, unroll=1, mesh=None):
        def step(g, d, batch):
            trec.batches.append(_arrays(batch))
            metrics = {"loss_G": torch.tensor(g.step + 0.5), "loss_D": torch.tensor(0.25)}
            return (_port_advance(g, unroll), _port_advance(d, unroll), metrics,
                    batch["driving"] if unroll == 1 else None)
        return step

    monkeypatch.setattr(jmain_base, "init_states", j_init_states)
    monkeypatch.setattr(jmain_base, "make_train_step", j_make_train_step)
    monkeypatch.setattr(main_base, "init_states", t_init_states)
    monkeypatch.setattr(main_base, "make_train_step", t_make_train_step)


def _run(monkeypatch, capsys, where, fn):
    """fn() with `where` as the working directory; its console lines."""
    where.mkdir(exist_ok=True)
    monkeypatch.chdir(where)
    fn()
    return _lines(capsys.readouterr().out)


def _assert_same_pngs(tmp_path):
    names = {side: sorted(os.listdir(tmp_path / side / "output_images"))
             if (tmp_path / side / "output_images").exists() else []
             for side in ("jax", "port")}
    assert names["port"] == names["jax"]
    from PIL import Image

    for name in names["jax"]:
        np.testing.assert_array_equal(
            np.asarray(Image.open(tmp_path / "port" / "output_images" / name)),
            np.asarray(Image.open(tmp_path / "jax" / "output_images" / name)))
    return names["jax"]


@pytest.mark.parametrize("runs", [
    # (training overrides, max_steps) per call: early stopping with unroll
    # 2, then a resume at unroll 1 that writes the debug PNG.
    [(dict(unroll_steps=2, save_interval=2, log_interval=2, eval_interval=2,
           holdout_frames=2), 4),
     (dict(unroll_steps=1, save_interval=2, log_interval=2, eval_interval=2,
           holdout_frames=2), 6)],
    # No evaluator: unroll 4 past max_steps 7, the export of the final
    # state. (JAX shards the stacked batches' leading axis, the unroll axis,
    # over its 2-device data mesh here, so unroll must be even on its side.)
    [(dict(unroll_steps=4, save_interval=2, log_interval=3), 7)],
], ids=["eval_then_resume", "unroll4_no_eval"])
def test_main_base_bookkeeping_matches_jax(clip_dir, tmp_path, monkeypatch, capsys, runs):
    jrec, trec = _Recorder(), _Recorder()
    _stub_base(monkeypatch, jrec, trec)
    _patch_scores(monkeypatch)
    for training, max_steps in runs:
        jcfg, tcfg = _configs(clip_dir, tmp_path, **training)
        jout = _run(monkeypatch, capsys, tmp_path / "jax",
                    lambda: jmain_base.train_base(jcfg, max_steps))
        tout = _run(monkeypatch, capsys, tmp_path / "port",
                    lambda: main_base.train_base(tcfg, max_steps, device="cpu"))
        assert tout == jout
    assert trec.built == jrec.built == {"steps_per_epoch": 3 * FRAMES // BATCH}
    _assert_batches_equal(trec.batches, jrec.batches)
    jck, tck = jcfg.training.checkpoint_path, tcfg.training.checkpoint_path
    assert _steps_on_disk(tck) == _steps_on_disk(jck)
    jstep, jw = _jax_export(jck + "/export", "g_variables", {"params": {"w": jnp.zeros(2)}})
    tstep, tw = _port_export(tck + "/export", "g_variables")
    assert tstep == jstep
    np.testing.assert_array_equal(tw["w"].numpy(), np.asarray(jw["params"]["w"]))
    pngs = _assert_same_pngs(tmp_path)
    assert pngs == (["pred_frame_6.png"] if len(runs) == 2 else [])
    if len(runs) == 2:
        assert "Resumed from checkpoint step 4" in tout


class _JModel:
    """A flax-like model whose ``init`` gives the one-weight tree."""

    def __init__(self, *args, **kwargs):
        pass

    def init(self, rng, *inputs):
        return {"params": {"w": jnp.zeros((2,), jnp.float32)}}


def _stub_hr(monkeypatch, jrec, trec):
    def j_init_hr_state(cfg, rng, policy, image_size, upscale):
        jrec.built.update(steps_per_epoch=cfg.training.steps_per_epoch,
                          image_size=image_size, upscale=upscale)
        return None, None, None, _jax_state()

    def j_make_hr_train_step(genh, gbase, gbase_vars, ploss, p_vars, cfg, upscale):
        jrec.built["gbase_w"] = np.asarray(gbase_vars["params"]["w"])

        def step(state, batch):
            jrec.batches.append(_arrays(batch))
            return _jax_advance(state, 1), {"loss_hr": jnp.float32(int(state.step) + 0.5)}
        return step

    def t_init_hr_state(cfg, seed, policy, image_size, upscale, device, mesh=None):
        trec.built.update(steps_per_epoch=cfg.training.steps_per_epoch,
                          image_size=image_size, upscale=upscale)
        return None, None, _port_state()

    def t_make_hr_train_step(genh, gbase, ploss, cfg, upscale, mesh=None):
        trec.built["gbase_w"] = gbase.w.detach().numpy().copy()

        def step(state, batch):
            trec.batches.append(_arrays(batch))
            metrics = {"loss_hr": torch.tensor(state.step + 0.5)}
            return _port_advance(state, 1), metrics
        return step

    monkeypatch.setattr(jconfig.Config, "make_gbase", lambda self, policy=None: _JModel())
    monkeypatch.setattr(jmain_hr, "init_hr_state", j_init_hr_state)
    monkeypatch.setattr(jmain_hr, "make_hr_train_step", j_make_hr_train_step)
    monkeypatch.setattr(tconfig.Config, "make_gbase",
                        lambda self, policy=None, device="cuda", seed=0: _Weight())
    monkeypatch.setattr(main_hr, "init_hr_state", t_init_hr_state)
    monkeypatch.setattr(main_hr, "make_hr_train_step", t_make_hr_train_step)
    _one_device_mesh(monkeypatch, jmain_hr)


@pytest.mark.parametrize("native_hr", [True, False], ids=["native", "synthetic"])
def test_main_hr_bookkeeping_matches_jax(clip_dir, tmp_path, monkeypatch, capsys, native_hr):
    """4 steps, eval every 2 (the synthetic targets warn and skip it), the
    frozen Gbase restored from an export of weight 5."""
    jrec, trec = _Recorder(), _Recorder()
    _stub_hr(monkeypatch, jrec, trec)
    _patch_scores(monkeypatch)
    gbase_ckpt = tmp_path / "gbase"
    JManager(str(gbase_ckpt / "jax" / "export")).save(
        3, {"g_variables": {"params": {"w": jnp.full((2,), 5.0)}}}, wait=True)
    CheckpointManager(str(gbase_ckpt / "port" / "export")).save(
        3, {"g_variables": _Weight(5.0)})
    jcfg, tcfg = _configs(clip_dir, tmp_path, save_interval=3, log_interval=2,
                          eval_interval=2, holdout_frames=2)
    jout = _run(monkeypatch, capsys, tmp_path / "jax", lambda: jmain_hr.train_hr(
        jcfg, 4, str(gbase_ckpt / "jax"), 2, native_hr=native_hr))
    tout = _run(monkeypatch, capsys, tmp_path / "port", lambda: main_hr.train_hr(
        tcfg, 4, str(gbase_ckpt / "port"), 2, native_hr=native_hr, device="cpu"))
    assert tout == jout
    assert ("held-out early stopping: 6 eval pairs, every 2 steps" in tout) == native_hr
    np.testing.assert_array_equal(trec.built.pop("gbase_w"), np.full((2,), 5.0))
    np.testing.assert_array_equal(jrec.built.pop("gbase_w"), np.full((2,), 5.0))
    assert trec.built == jrec.built == dict(
        steps_per_epoch=3 * FRAMES // BATCH, image_size=SIZE, upscale=2)
    # Gbase's inputs: the box mean against cv2's INTER_AREA (native), or
    # the frames themselves; the targets bit for bit.
    _assert_batches_equal(trec.batches, jrec.batches, atol=1e-6 if native_hr else 0.0)
    for b in trec.batches:
        assert b["source"].shape == (BATCH, SIZE, SIZE, 3)
        assert b["target_hr"].shape == (BATCH, 2 * SIZE, 2 * SIZE, 3)
    jck, tck = jcfg.training.checkpoint_path, tcfg.training.checkpoint_path
    assert _steps_on_disk(tck) == _steps_on_disk(jck) == [3, 4]
    jstep, jw = _jax_export(jck + "/export", "genh_variables", {"params": {"w": jnp.zeros(2)}})
    tstep, tw = _port_export(tck + "/export", "genh_variables")
    assert tstep == jstep == 4
    np.testing.assert_array_equal(tw["w"].numpy(), np.asarray(jw["params"]["w"]))


def _stub_student(monkeypatch, jrec, trec):
    def j_init_student_state(cfg, rng, policy, image_size):
        jrec.built.update(steps_per_epoch=cfg.training.steps_per_epoch,
                          num_avatars=cfg.training.num_avatars, image_size=image_size)
        return None, _jax_state()

    def j_make_student_train_step(student, teacher, teacher_vars, cfg):
        jrec.built["teacher_w"] = np.asarray(teacher_vars["params"]["w"])

        def step(state, batch):
            jrec.batches.append(_arrays(batch))
            return _jax_advance(state, 1), {"loss_student": jnp.float32(0.125)}
        return step

    def t_init_student_state(cfg, seed, policy, image_size, device, mesh=None):
        trec.built.update(steps_per_epoch=cfg.training.steps_per_epoch,
                          num_avatars=cfg.training.num_avatars, image_size=image_size)
        return None, _port_state()

    def t_make_student_train_step(student, teacher, cfg, mesh=None):
        trec.built["teacher_w"] = teacher.w.detach().numpy().copy()

        def step(state, batch):
            trec.batches.append(_arrays(batch))
            return _port_advance(state, 1), {"loss_student": torch.tensor(0.125)}
        return step

    monkeypatch.setattr(jmain_student, "GHR", _JModel)
    monkeypatch.setattr(jmain_student, "init_student_state", j_init_student_state)
    monkeypatch.setattr(jmain_student, "make_student_train_step", j_make_student_train_step)
    monkeypatch.setattr(main_student, "build_ghr", lambda *a, **kw: _Weight())
    monkeypatch.setattr(main_student, "init_student_state", t_init_student_state)
    monkeypatch.setattr(main_student, "make_student_train_step", t_make_student_train_step)
    _one_device_mesh(monkeypatch, jmain_student)


def test_main_student_bookkeeping_matches_jax(clip_dir, tmp_path, monkeypatch, capsys):
    """5 avatars asked for over 3 clips: draws among 3, the Student built
    for 5; the teacher restored from ``{"ghr_variables"}`` of weight 7."""
    jrec, trec = _Recorder(), _Recorder()
    _stub_student(monkeypatch, jrec, trec)
    teacher = tmp_path / "teacher"
    JManager(str(teacher / "jax")).save(
        1, {"ghr_variables": {"params": {"w": jnp.full((2,), 7.0)}}}, wait=True)
    CheckpointManager(str(teacher / "port")).save(1, {"ghr_variables": _Weight(7.0)})
    jcfg, tcfg = _configs(clip_dir, tmp_path, save_interval=2, log_interval=3,
                          num_avatars=5, batch_size=4)
    jout = _run(monkeypatch, capsys, tmp_path / "jax", lambda: jmain_student.train_student(
        jcfg, 5, str(teacher / "jax")))
    tout = _run(monkeypatch, capsys, tmp_path / "port", lambda: main_student.train_student(
        tcfg, 5, str(teacher / "port"), device="cpu"))
    assert tout == jout
    np.testing.assert_array_equal(trec.built.pop("teacher_w"), np.full((2,), 7.0))
    np.testing.assert_array_equal(jrec.built.pop("teacher_w"), np.full((2,), 7.0))
    assert trec.built == jrec.built == dict(
        steps_per_epoch=3 * FRAMES // 4, num_avatars=5, image_size=SIZE)
    _assert_batches_equal(trec.batches, jrec.batches)
    assert all(b["avatar_index"].dtype == np.int32 for b in trec.batches)
    assert max(b["avatar_index"].max() for b in trec.batches) <= 2
    jck, tck = jcfg.training.checkpoint_path, tcfg.training.checkpoint_path
    assert _steps_on_disk(tck) == _steps_on_disk(jck) == [2, 4, 5]


class _EyeStub:
    """68 points whose eyes follow the frame's mean; with `fail_after`, no
    landmarks from that call on (the driver then sends zero masks)."""

    is_proxy, num_points = False, 68

    def __init__(self, fail_after=None):
        self.calls, self.fail_after = 0, fail_after

    def detect(self, img):
        self.calls += 1
        if self.fail_after is not None and self.calls > self.fail_after:
            return None
        h, w = img.shape[:2]
        m = float(img.mean())
        lm = np.tile([[w / 2, h / 2]], (68, 1))
        a = np.linspace(0, 2 * np.pi, 6, endpoint=False)
        for lo, cx in ((36, 0.3 * w), (42, 0.7 * w)):
            lm[lo:lo + 6] = np.stack([cx + 0.1 * w * np.cos(a) + 8 * m,
                                      0.4 * h + 0.05 * h * np.sin(a)], 1)
        return lm


@pytest.mark.parametrize("provider", ["stub68", "none", "fails_later"])
def test_main_base_gaze_masks_match_jax(clip_dir, tmp_path, monkeypatch, capsys, provider):
    """use_gaze_loss: the same 68-point stub in both registries (masks on
    every batch), none (the box proxy: the "gaze term skipped" line, no
    masks), or one that stops giving landmarks after the first batch (zero
    masks from then on)."""
    from megaportraits_tpu.data import landmarks as jlandmarks
    from megaportraits_tpu_torch.data import landmarks

    make = {"stub68": _EyeStub, "none": lambda: None,
            "fails_later": lambda: _EyeStub(fail_after=BATCH)}[provider]
    jlandmarks.set_landmark_provider(make())
    landmarks.set_landmark_provider(make())
    try:
        jrec, trec = _Recorder(), _Recorder()
        _stub_base(monkeypatch, jrec, trec)
        jcfg, tcfg = _configs(clip_dir, tmp_path, use_gaze_loss=True, log_interval=1,
                              save_interval=10)
        jout = _run(monkeypatch, capsys, tmp_path / "jax",
                    lambda: jmain_base.train_base(jcfg, 3))
        tout = _run(monkeypatch, capsys, tmp_path / "port",
                    lambda: main_base.train_base(tcfg, 3, device="cpu"))
    finally:
        jlandmarks.set_landmark_provider(None)
        landmarks.set_landmark_provider(None)
    assert tout == jout
    skipped = ("use_gaze_loss: no 68-point landmark provider (converted FAN weights "
               "absent) — gaze term skipped")
    assert (skipped in tout) == (provider == "none")
    _assert_batches_equal(trec.batches, jrec.batches)
    masks = [b.get("gaze_masks") for b in trec.batches]
    if provider == "none":
        assert all(m is None for m in masks)
    else:
        assert all(m is not None and m.shape == (BATCH, SIZE, SIZE, 2) for m in masks)
        assert masks[0].sum() > 0
        assert (masks[-1].sum() == 0) == (provider == "fails_later")
