"""A float32 training step convolves without TF32 backward as well as
forward.

``Policy.conv_scope`` turns cuDNN's TF32 off around a float32 policy's
forward convolutions, but autograd runs their backward later, inside the
trainers' ``torch.autograd.grad``. Each of the three steps takes its
gradients under the trained model's ``Policy.backward_scope``: Gbase's for
G and D in stage 1, Genh's in stage 2, the Student's in stage 3. On the CPU
the flag does not change the arithmetic, so these tests read the flag:
every convolution's output gets a tensor hook that records
``torch.backends.cudnn.allow_tf32`` when its gradient arrives, which is
when the convolution's backward runs, and every convolution called while
autograd runs the backward (remat's recompute) records it at the call.

  * under ``FP32_POLICY`` every backward convolution sees the flag False,
    whatever it was set to before the step;
  * under the bf16 policy (``DEFAULT_POLICY``: bf16 has no TF32 mode) it
    sees the flag as it was set;
  * the flag is as it was after the step;
  * stage 1 with remat 'full' (the recompute runs inside the backward) and
    through the data-parallel path (a one-rank gloo group) likewise;
  * ``anti_alias_downsample``'s blur (Gbase's pyramids in the stage-1
    loss), which JAX runs at ``Precision.HIGHEST`` forward and backward,
    takes its backward with TF32 off in any step, bf16 too.

TINY, 64x64. The CPU has no bf16 ``avg_pool3d``: the bf16 cases run it in
float32 (a test shim). Stage 2's frozen Gbase runs in float32 beside a
bf16 Genh; the scope follows the trained model's policy.
"""

import contextlib

import pytest
import torch
import torch.nn.functional as F

from megaportraits_tpu_torch.core import config as tconfig
from megaportraits_tpu_torch.core.dtypes import DEFAULT_POLICY, FP32_POLICY
from megaportraits_tpu_torch.models.genh import build_ghr
from megaportraits_tpu_torch.train.train_base import init_states, make_train_step
from megaportraits_tpu_torch.train.train_hr import init_hr_state, make_hr_train_step
from megaportraits_tpu_torch.train.train_student import (
    init_student_state,
    make_student_train_step,
)

from torch_port_utils import free_port

SIZE = 64
POLICIES = {"float32": FP32_POLICY, "bf16": DEFAULT_POLICY}


def _cfg():
    cfg = tconfig.Config()
    cfg.model.arch = "tiny"
    cfg.data.train_width = cfg.data.train_height = SIZE
    cfg.training.steps_per_epoch = 1
    cfg.training.num_avatars = 2
    return cfg


def _images(gen, b, size=SIZE):
    return torch.rand(b, size, size, 3, generator=gen)


@pytest.fixture
def backward_flags(monkeypatch):
    """The cuDNN TF32 flag each convolution's backward saw."""
    flags = []

    def spy(fn):
        def conv(*args, **kwargs):
            if torch._C._current_graph_task_id() != -1:  # called by the backward
                flags.append(torch.backends.cudnn.allow_tf32)
            out = fn(*args, **kwargs)
            if out.requires_grad:
                out.register_hook(
                    lambda g: flags.append(torch.backends.cudnn.allow_tf32))
            return out
        return conv

    monkeypatch.setattr(F, "conv2d", spy(F.conv2d))
    monkeypatch.setattr(F, "conv3d", spy(F.conv3d))
    avg_pool3d = F.avg_pool3d
    monkeypatch.setattr(F, "avg_pool3d", lambda x, *a, **k: avg_pool3d(
        x.float(), *a, **k).to(x.dtype))
    return flags


@pytest.fixture(params=[True, False], ids=["tf32-on", "tf32-off"])
def global_tf32(request):
    """The process-wide cuDNN TF32 flag set to each value, restored after."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = request.param
    yield request.param
    torch.backends.cudnn.allow_tf32 = before


@pytest.fixture
def one_thread():
    """The TINY Student's CPU backward runs on one thread (see
    test_torch_port_train_stages.py's ``one_cpu_thread``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@contextlib.contextmanager
def one_rank_group():
    """A one-rank gloo process group in this process, and the mesh over it."""
    import torch.distributed as dist

    from megaportraits_tpu_torch.parallel.mesh import make_mesh

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{free_port()}",
                            rank=0, world_size=1)
    try:
        yield make_mesh({"data": 1}, device="cpu")
    finally:
        dist.destroy_process_group()


def _step_base(policy, gen, remat_mode=None, mesh=None):
    cfg = _cfg()
    _, _, ploss, g_state, d_state = init_states(cfg, policy=policy, device="cpu",
                                                remat_mode=remat_mode, mesh=mesh)
    batch = {k: _images(gen, 1) for k in ("source", "driving", "source_next",
                                          "source_star", "driving_star")}
    _, _, metrics, _ = make_train_step(ploss, cfg, mesh=mesh)(g_state, d_state, batch)
    return metrics


def _step_hr(policy, gen):
    cfg = _cfg()
    genh, ploss, state = init_hr_state(cfg, policy=policy, image_size=SIZE, device="cpu")
    gbase = cfg.make_gbase(policy=FP32_POLICY, device="cpu")
    batch = {"source": _images(gen, 2), "driving": _images(gen, 2),
             "target_hr": _images(gen, 2, 2 * SIZE)}
    return make_hr_train_step(genh, gbase, ploss, cfg)(state, batch)[1]


def _step_student(policy, gen):
    cfg = _cfg()
    student, state = init_student_state(cfg, policy=policy, image_size=SIZE,
                                        device="cpu")
    teacher = build_ghr("tiny", policy=FP32_POLICY, device="cpu")
    batch = {"source": _images(gen, 2), "driving": _images(gen, 2),
             "avatar_index": torch.tensor([1, 0])}
    return make_student_train_step(student, teacher, cfg)(state, batch)[1]


STEPS = {"base": _step_base, "hr": _step_hr, "student": _step_student}


@pytest.mark.parametrize("precision", list(POLICIES))
@pytest.mark.parametrize("stage", list(STEPS))
def test_step_backward_tf32_flag(stage, precision, global_tf32, backward_flags,
                                 one_thread):
    """Float32: every backward convolution without TF32, whatever the flag;
    bf16: as the flag says. The flag is back after the step."""
    gen = torch.Generator().manual_seed(0)
    metrics = STEPS[stage](POLICIES[precision], gen)
    assert all(torch.isfinite(v) for v in metrics.values())
    assert len(backward_flags) > 20
    want = False if precision == "float32" else global_tf32
    assert set(backward_flags) == {want}
    assert torch.backends.cudnn.allow_tf32 is global_tf32


@pytest.mark.parametrize("variant", ["remat-full", "data-parallel"])
def test_stage1_variants_backward_without_tf32(variant, backward_flags, one_thread,
                                               monkeypatch):
    """The remat and data-parallel variants take the same step: float32
    convolves without TF32 in the backward (the recompute included) with
    the flag set True beforehand, and the flag is True again after."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    gen = torch.Generator().manual_seed(1)
    if variant == "remat-full":
        calls = []
        from megaportraits_tpu_torch.models import gbase as gbase_module

        remat_call = gbase_module.remat_call
        monkeypatch.setattr(gbase_module, "remat_call",
                            lambda *a: calls.append(1) or remat_call(*a))
        metrics = _step_base(FP32_POLICY, gen, remat_mode="full")
        assert len(calls) > 6  # the checkpointed submodules ran
    else:
        with one_rank_group() as mesh:
            metrics = _step_base(FP32_POLICY, gen, mesh=mesh)
    assert all(torch.isfinite(v) for v in metrics.values())
    assert len(backward_flags) > 20 and not any(backward_flags)
    assert torch.backends.cudnn.allow_tf32 is True


def test_anti_alias_downsample_backward_without_tf32(global_tf32, monkeypatch):
    """The pyramid's gaussian blur (JAX: ``Precision.HIGHEST``, which holds
    for its transpose) takes its input gradient with TF32 off in any step,
    bf16 too, and that gradient is autograd's own for the same convolution
    bit for bit."""
    from megaportraits_tpu_torch.nn.layers import to_channels_first, to_channels_last
    from megaportraits_tpu_torch.ops import resize

    seen = []
    conv2d_input = torch.nn.grad.conv2d_input
    monkeypatch.setattr(torch.nn.grad, "conv2d_input", lambda *a, **k: (
        seen.append(torch.backends.cudnn.allow_tf32), conv2d_input(*a, **k))[1])
    gen = torch.Generator().manual_seed(2)
    x = torch.rand(2, 37, 29, 3, generator=gen, requires_grad=True)
    y = resize.anti_alias_downsample(x, 0.25)
    g = torch.randn(y.shape, generator=gen)
    (got,) = torch.autograd.grad(y, x, g)
    assert seen == [False]
    assert torch.backends.cudnn.allow_tf32 is global_tf32

    kernel, ka, kb = resize.gaussian_kernel_2d(0.25)
    k = torch.as_tensor(kernel)[None, None].expand(3, 1, -1, -1).contiguous()
    blurred = to_channels_last(F.conv2d(F.pad(to_channels_first(x), (ka, kb, ka, kb)), k,
                                        groups=3))
    want = resize.nearest_resize(blurred, [y.shape[1], y.shape[2]], axes=[1, 2])
    assert torch.equal(want, y)
    assert torch.equal(torch.autograd.grad(want, x, g)[0], got)
