"""Port parity on CPU for stage-2 and stage-3 training: one HR step, one
Student step (the teacher inline, and with 'target01' given) and the frozen
teacher's forward (both bn_modes, with and without Genh), against the JAX
package.

TINY, FP32 on both sides, images at 64 and the HR target at 128, batch 2,
the weights drawn with numpy and bridged to the port. Each JAX step runs
once, with an optax transformation that applies no update and keeps the
gradients as its state, so the gradients are read from the step itself.
The port's frozen Gbase runs with the kernels' gate opened on the CPU
(``torch_port_utils.engaged_on_cpu``): its G2d trunk goes through K2's
wrapper, which on CPU tensors is K2's plain version, and its eval-mode
BatchNorms through K4's; the tests count K2's calls. The images are 64 and not the 32 of the JAX
package's own stage tests: at 32 the trunk's map is 4x4, which K2 does not
take (G2d asks for H and W divisible by 8), and batch statistics over the
1x1 maps of Emtn's ResNets, two values each, are so ill-conditioned that
the 'batch' teacher differs from JAX's by 5e-4 there (this file with SIZE
= 32; 2.2e-5 at 64).

Tolerances:
  * metrics: 1e-4 relative (measured up to 1.3e-6);
  * BatchNorm running statistics after a step: 1e-4 absolute (measured
    3.6e-7 for Genh, 1.8e-7 for the Student);
  * the teacher's targets: 1e-4 absolute on [0, 1] (measured 2.2e-5 for
    the Gbase image with batch statistics, 9e-7 through Genh);
  * gradients, relative Frobenius error over the leaves above 1e-6 of the
    largest norm: Genh 5e-2 over all leaves and 1e-1 a leaf (measured
    1.3e-2 and 3.9e-2), the Student 1e-2 and 5e-2 (measured 1.1e-3 and
    1.3e-2, teacher inline). The gradients pass ReLU kinks and the |.| of
    the L1 losses, where float32 rounding puts the odd element on the
    other side (``test_torch_port_train_base.py`` states the mechanism).
    Genh, trained at 128 here through two passes, meets more kinks than
    the Student, and the base image entering it differs from JAX's by up
    to 7e-6 (the teacher test's Gbase image). The metrics see no such
    jump and are held tight.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from megaportraits_tpu.core import config as jconfig
from megaportraits_tpu.core.arch import TINY as JTINY
from megaportraits_tpu.core.dtypes import FP32_POLICY as JP
from megaportraits_tpu.losses.perceptual import PerceptualLoss as JPerceptualLoss
from megaportraits_tpu.models.genh import GHR as JGHR
from megaportraits_tpu.models.genh import Genh as JGenh
from megaportraits_tpu.models.student import Student as JStudent
from megaportraits_tpu.train import train_hr as jhr
from megaportraits_tpu.train import train_student as jst
from megaportraits_tpu.train.state import TrainState as JTrainState

from megaportraits_tpu_torch.core import config as tconfig
from megaportraits_tpu_torch.core.arch import TINY
from megaportraits_tpu_torch.core.dtypes import FP32_POLICY
from megaportraits_tpu_torch.models.genh import GHR
from megaportraits_tpu_torch.ops.kernels import resblock_chain as k2
from megaportraits_tpu_torch.train.train_hr import HR_LOSS_WEIGHTS, init_hr_state, make_hr_train_step
from megaportraits_tpu_torch.train.train_student import (
    init_student_state,
    make_student_train_step,
    make_teacher_forward,
)
from megaportraits_tpu_torch.utils.jax_bridge import jax_to_state_dict, load_jax_variables

from torch_port_utils import engaged_on_cpu  # noqa: F401  (a fixture)
from torch_port_utils import grad_errors, keep_gradients, n, numpy_init, t

SIZE = 64
UPSCALE = 2
BATCH = 2
AVATARS = 2
METRIC_TOL = 1e-4  # relative
STATS_TOL = 1e-4  # absolute
GRAD_TOL = {"Genh": (5e-2, 1e-1), "Student": (1e-2, 5e-2)}  # (overall, a leaf)


def _tiny(cfg):
    cfg.model.arch = "tiny"
    cfg.data.train_width = cfg.data.train_height = SIZE
    cfg.training.steps_per_epoch = 1
    cfg.training.num_avatars = AVATARS
    return cfg


def _images(seed, size=SIZE):
    return np.random.default_rng(seed).random((BATCH, size, size, 3)).astype(np.float32)


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_outcome(state, metrics):
    return dict(metrics={k: float(v) for k, v in metrics.items()},
                grads=jax_to_state_dict({"params": _numpy(state.opt_state)}),
                stats=jax_to_state_dict({"batch_stats": _numpy(state.batch_stats)}))


class K2Calls:
    """Counts the calls of K2's wrapper (its own counter counts only
    launches on the card)."""

    def __init__(self, monkeypatch):
        self.n = 0
        wrapped = k2.resblock_chain

        def counting(*args):
            self.n += 1
            return wrapped(*args)

        monkeypatch.setattr(k2, "resblock_chain", counting)


@pytest.fixture(scope="module")
def dummy():
    return jnp.zeros((1, SIZE, SIZE, 3), jnp.float32)


@pytest.fixture(scope="module")
def teacher_vars(dummy):
    """A TINY GHR's variables with non-trivial BatchNorm statistics."""
    return numpy_init(JGHR(policy=JP, arch=JTINY), dummy, dummy, seed=1, stats_seed=2)


@pytest.fixture
def teacher(teacher_vars, engaged_on_cpu):
    """The port's GHR on the same weights, the kernels' gate opened."""
    return load_jax_variables(GHR(policy=FP32_POLICY, arch=TINY), teacher_vars)


def _stage_equal(model, before):
    return all(torch.equal(v, before[k]) for k, v in model.state_dict().items())


def _check_step(module, got_metrics, want, n_metrics):
    got = {k: v.item() for k, v in got_metrics.items()}
    assert set(got) == set(want["metrics"]) and len(got) == n_metrics
    for k, w in want["metrics"].items():
        assert np.isfinite(got[k]), k
        assert abs(got[k] - w) <= METRIC_TOL * max(abs(w), 1e-6), (k, got[k], w)
    per_leaf, overall = grad_errors(module, want["grads"])
    worst = max(per_leaf, key=per_leaf.get)
    overall_tol, leaf_tol = GRAD_TOL[type(module).__name__]
    assert overall <= overall_tol, overall
    assert per_leaf[worst] <= leaf_tol, (worst, per_leaf[worst])
    buffers = dict(module.named_buffers())
    assert set(want["stats"]) == set(buffers)
    for k, w in want["stats"].items():
        np.testing.assert_allclose(n(buffers[k]), w.numpy(), atol=STATS_TOL, rtol=0,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# Stage 2: the HR step
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def hr_reference(dummy, teacher_vars):
    """One JAX HR step: the frozen Gbase is the GHR teacher's."""
    cfg = _tiny(jconfig.Config())
    hr = jnp.zeros((1, SIZE * UPSCALE, SIZE * UPSCALE, 3), jnp.float32)
    genh = JGenh(policy=JP, arch=JTINY)
    genh_vars = numpy_init(genh, hr, seed=3, stats_seed=4)
    ploss = JPerceptualLoss(weights=HR_LOSS_WEIGHTS, policy=JP, arch=JTINY)
    p_vars = numpy_init(ploss, hr, hr, seed=5)
    gbase_vars = {c: tree["gbase"] for c, tree in teacher_vars.items()}
    batch = {"source": _images(6), "driving": _images(7),
             "target_hr": _images(8, SIZE * UPSCALE)}
    step = jhr.make_hr_train_step(genh, cfg.make_gbase(policy=JP), gbase_vars, ploss,
                                  p_vars, cfg, upscale=UPSCALE, donate=False)
    state, metrics = step(JTrainState.create(genh_vars["params"], genh_vars["batch_stats"],
                                             keep_gradients()), batch)
    return dict(genh_vars=genh_vars, p_vars=p_vars, batch=batch,
                **_jax_outcome(state, metrics))


def test_hr_step_matches_jax(hr_reference, teacher, monkeypatch):
    """Metrics, Genh's gradients and its BatchNorm statistics (the first
    pass's, the cycle pass recording none); Gbase, its statistics and the
    loss net untouched; Gbase's trunk through K2's wrapper, once a
    sample."""
    cfg = _tiny(tconfig.Config())
    genh, ploss, state = init_hr_state(cfg, policy=FP32_POLICY, image_size=SIZE,
                                       upscale=UPSCALE, device="cpu")
    load_jax_variables(genh, hr_reference["genh_vars"])
    load_jax_variables(ploss, hr_reference["p_vars"])
    gbase = teacher.gbase
    before = {name: {k: v.clone() for k, v in m.state_dict().items()}
              for name, m in (("gbase", gbase), ("ploss", ploss), ("genh", genh))}
    calls = K2Calls(monkeypatch)
    step = make_hr_train_step(genh, gbase, ploss, cfg, upscale=UPSCALE)
    state, metrics = step(state, {k: t(v) for k, v in hr_reference["batch"].items()})
    _check_step(genh, metrics, hr_reference, 4)
    assert calls.n == BATCH
    assert _stage_equal(gbase, before["gbase"]) and _stage_equal(ploss, before["ploss"])
    moved = [k for k, v in genh.state_dict().items() if not torch.equal(v, before["genh"][k])]
    assert len(moved) == len(genh.state_dict())  # every weight and statistic
    assert state.step == 1 and not gbase.training


# ---------------------------------------------------------------------------
# Stage 3: the Student step and the teacher's forward
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["inline", "target01"])
def student_reference(request, dummy, teacher_vars):
    """One JAX Student step, the teacher inline or the target given."""
    cfg = _tiny(jconfig.Config())
    student = JStudent(num_avatars=AVATARS, policy=JP, arch=JTINY)
    s_vars = numpy_init(student, dummy, jnp.zeros((1,), jnp.int32), seed=9,
                        stats_seed=10)
    batch = {"source": _images(11), "driving": _images(12),
             "avatar_index": np.array([1, 0], np.int32)}
    if request.param == "target01":
        batch = {"driving": batch["driving"], "avatar_index": batch["avatar_index"],
                 "target01": _images(13)}
    step = jst.make_student_train_step(student, JGHR(policy=JP, arch=JTINY), teacher_vars,
                                       cfg, donate=False)
    state, metrics = step(JTrainState.create(s_vars["params"], s_vars["batch_stats"],
                                             keep_gradients()), batch)
    return dict(s_vars=s_vars, batch=batch, **_jax_outcome(state, metrics))


@pytest.fixture
def one_cpu_thread():
    """PyTorch's CPU backward of a 1x1 stride-2 convolution on a
    channels-last view, 8 to 16 channels at 16x16 (the TINY Student's
    layer2_0 shortcut at 64x64), corrupts the heap when it runs on several
    threads (torch 2.13 CPU; seen as segfaults and as garbage gradients
    later in the process, and caught at once by glibc's malloc checks); on
    one thread it does not. The Student step here runs on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_student_step_matches_jax(student_reference, teacher, monkeypatch,
                                  one_cpu_thread):
    """Metric, the Student's gradients and statistics; the teacher runs
    only when the batch has no target, with its trunk through K2's wrapper
    once a sample, and stays untouched."""
    cfg = _tiny(tconfig.Config())
    student, state = init_student_state(cfg, policy=FP32_POLICY, image_size=SIZE,
                                        device="cpu")
    load_jax_variables(student, student_reference["s_vars"])
    before = {k: v.clone() for k, v in teacher.state_dict().items()}
    calls = K2Calls(monkeypatch)
    batch = {k: t(v) for k, v in student_reference["batch"].items()}
    state, metrics = make_student_train_step(student, teacher, cfg)(state, batch)
    _check_step(student, metrics, student_reference, 1)
    assert calls.n == (0 if "target01" in batch else BATCH)
    assert _stage_equal(teacher, before)
    assert state.step == 1


@pytest.mark.parametrize("bn_mode", ["running", "batch"])
@pytest.mark.parametrize("include_enh", [True, False])
def test_teacher_forward_matches_jax(teacher_vars, teacher, monkeypatch, bn_mode,
                                     include_enh):
    """[0, 1] float32 targets; 'batch' records no statistic and cannot use
    K2, 'running' takes K2's wrapper once a sample."""
    xs, xd = _images(14), _images(15)
    want = np.asarray(jst.make_teacher_forward(JGHR(policy=JP, arch=JTINY), teacher_vars,
                                               include_enh, bn_mode)(xs, xd))
    before = {k: v.clone() for k, v in teacher.state_dict().items()}
    calls = K2Calls(monkeypatch)
    got = make_teacher_forward(teacher, include_enh, bn_mode)(t(xs), t(xd))
    assert got.dtype == torch.float32 and not got.requires_grad
    assert got.shape == want.shape == (BATCH, SIZE, SIZE, 3)
    assert 0.0 <= got.min().item() and got.max().item() <= 1.0
    np.testing.assert_allclose(n(got), want, atol=1e-4, rtol=0)
    assert calls.n == (BATCH if bn_mode == "running" else 0)
    assert _stage_equal(teacher, before)


def test_teacher_forward_rejects_an_unknown_bn_mode(teacher):
    with pytest.raises(ValueError, match="bn_mode"):
        make_teacher_forward(teacher, bn_mode="train")


@pytest.mark.parametrize("entry", ["init_hr_state", "init_student_state"])
def test_entry_points_default_to_the_card(entry):
    """Without a card, the stage-2 and stage-3 entry points raise unless
    asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    init = {"init_hr_state": init_hr_state, "init_student_state": init_student_state}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init[entry](_tiny(tconfig.Config()))
