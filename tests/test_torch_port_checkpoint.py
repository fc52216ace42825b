"""The port's CheckpointManager (``core/checkpoint.py``) against the JAX
package's Orbax manager, and a training run resumed from it.

The contract of ``tests/test_checkpoint_incremental.py``: one directory a
step, ``latest_step``, a save of a step that is not newer than the latest
refused (nothing written), the newest ``max_to_keep`` kept, None from an
empty directory. The same sequence of calls goes to both managers and each
must leave the same steps on disk and restore the same values. Then a TINY
HR run on the CPU: two steps in one go, and one step, a save, a restore
into a fresh state and one more step, must end bit for bit equal.
"""

import os

import numpy as np
import pytest
import torch

from megaportraits_tpu.core.checkpoint import CheckpointManager as JManager

from megaportraits_tpu_torch.core.checkpoint import CheckpointManager
from megaportraits_tpu_torch.core.config import Config
from megaportraits_tpu_torch.core.dtypes import FP32_POLICY
from megaportraits_tpu_torch.models.gbase import build_gbase
from megaportraits_tpu_torch.train.train_hr import init_hr_state, make_hr_train_step

SIZE = 32


def _steps(directory):
    return sorted(int(d) for d in os.listdir(directory) if d.isdigit())


@pytest.mark.parametrize("max_to_keep", [1, 2, 3])
def test_manager_keeps_the_orbax_contract(tmp_path, max_to_keep):
    port = CheckpointManager(str(tmp_path / "port"), max_to_keep=max_to_keep)
    jax_ = JManager(str(tmp_path / "jax"), max_to_keep=max_to_keep)
    assert port.latest_step() is None and jax_.latest_step() is None
    assert port.restore({"g_variables": {"w": torch.zeros(2)}}) is None
    assert jax_.restore({"g_variables": {"w": np.zeros(2)}}) is None
    for step, newer in ((1, True), (2, True), (3, True), (3, False), (2, False),
                        (5, True)):
        value = float(step + 10 * (not newer))  # a refused save must not land
        assert port.save(step, {"g_variables": {"w": torch.full((2,), value)}}) is newer
        jax_.save(step, {"g_variables": {"w": np.full((2,), value)}}, wait=True)
        assert _steps(port.directory) == _steps(tmp_path / "jax"), step
        assert port.latest_step() == jax_.latest_step(), step
    assert port.latest_step() == 5
    for step in _steps(port.directory):
        got = port.restore({"g_variables": {"w": torch.zeros(2)}}, step=step)
        want = jax_.restore({"g_variables": {"w": np.zeros(2)}}, step=step)
        np.testing.assert_array_equal(got["g_variables"]["w"].numpy(),
                                      want["g_variables"]["w"])
    got = port.restore({"g_variables": {"w": torch.zeros(2)}})
    assert torch.equal(got["g_variables"]["w"], torch.full((2,), 5.0))
    jax_.close()


def test_refused_double_save_keeps_the_first(tmp_path):
    """A second save of the latest step writes nothing (the guard in the
    JAX package's overfit export relies on it)."""
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.save(100, {"g_variables": {"w": torch.ones(2)}}, wait=True)
    assert not mgr.save(100, {"g_variables": {"w": torch.zeros(2)}}, wait=True)
    out = CheckpointManager(str(tmp_path)).restore({"g_variables": {"w": torch.zeros(2)}})
    assert torch.equal(out["g_variables"]["w"], torch.ones(2))
    assert sorted(os.listdir(tmp_path)) == ["100"]  # no temporary left behind


def test_restore_of_a_missing_key_raises(tmp_path):
    """A training checkpoint restored as an export: KeyError, which the
    serving CLIs take for 'no checkpoint here'."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"genh": {"w": torch.ones(2)}})
    with pytest.raises(KeyError, match="g_variables"):
        mgr.restore({"g_variables": {"w": torch.zeros(2)}})


def _hr_setup(cfg, gbase):
    genh, ploss, state = init_hr_state(cfg, seed=0, policy=FP32_POLICY, image_size=SIZE,
                                       device="cpu")
    return genh, state, make_hr_train_step(genh, gbase, ploss, cfg)


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"source": torch.from_numpy(rng.random((2, SIZE, SIZE, 3), np.float32)),
            "driving": torch.from_numpy(rng.random((2, SIZE, SIZE, 3), np.float32)),
            "target_hr": torch.from_numpy(rng.random((2, 2 * SIZE, 2 * SIZE, 3),
                                                     np.float32))}


def _snapshot(state):
    adamw = state.tx.adamw.state_dict()
    return (state.model.state_dict(), adamw["state"], adamw["param_groups"],
            state.tx.schedule.state_dict(), state.step)


def _equal(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


def test_resumed_hr_run_equals_the_uninterrupted_one(tmp_path):
    """Weights, BatchNorm statistics, AdamW's moments and counts, the
    schedule and the step: bit for bit on the CPU. The fresh state takes a
    step of its own before the restore, so that everything the restore
    must set differs first."""
    cfg = Config()
    cfg.model.arch = "tiny"
    cfg.training.steps_per_epoch = 1
    gbase = build_gbase("tiny", policy=FP32_POLICY, device="cpu", seed=1)
    b1, b2, b3 = _batch(1), _batch(2), _batch(3)

    _, state, step = _hr_setup(cfg, gbase)
    state, _ = step(state, b1)
    state, m_once = step(state, b2)
    uninterrupted = _snapshot(state)

    _, state, step = _hr_setup(cfg, gbase)
    state, _ = step(state, b1)
    assert CheckpointManager(str(tmp_path)).save(state.step, {"genh": state})
    _, fresh, step = _hr_setup(cfg, gbase)
    fresh, _ = step(fresh, b3)
    assert not _equal(_snapshot(fresh), _snapshot(state))
    restored = CheckpointManager(str(tmp_path)).restore({"genh": fresh})
    assert restored["genh"] is fresh and _equal(_snapshot(fresh), _snapshot(state))
    fresh, m_resumed = step(fresh, b2)
    assert _equal(_snapshot(fresh), uninterrupted)
    assert all(torch.equal(m_resumed[k], m_once[k]) for k in m_once)
