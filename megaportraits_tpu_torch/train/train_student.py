"""Stage-3 training: Student distillation from a frozen GHR teacher
(counterpart of ``megaportraits_tpu/train/train_student.py``).

The teacher (Gbase + Genh) makes the target for a fixed set of avatars;
the Student, SPADE-conditioned on the avatar index, learns it by plain MSE.
AdamW on a cosine schedule over ``student_epochs * steps_per_epoch`` steps.

The teacher runs in ``.eval()`` under ``torch.no_grad()`` (JAX's
``stop_gradient``), so with ``G2d.use_chain_kernel`` set its G2d trunk
runs on kernel K2, once a sample. ``make_teacher_forward`` is the teacher
on its own, for targets made ahead of the step. The JAX module splits it
into two jitted graphs and threads the variables as jit arguments, to get
past the TPU compile service; the port needs neither.

With a mesh (``parallel/mesh.py``) each rank's batch is its rows of the
global batch: the Student is distributed from rank 0 with its BatchNorms
normalising over the data group, its optimiser averages the gradients, and
the loss is the mean over the ranks.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple, Union

import torch

from megaportraits_tpu_torch.core.config import Config
from megaportraits_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device
from megaportraits_tpu_torch.core.dtypes import DEFAULT_POLICY, Policy
from megaportraits_tpu_torch.infer.streaming import check_bn_mode
from megaportraits_tpu_torch.models.genh import GHR
from megaportraits_tpu_torch.models.student import Student, build_student
from megaportraits_tpu_torch.parallel.mesh import distribute, mean_over_ranks
from megaportraits_tpu_torch.train.state import TrainState, make_optimizer


def init_student_state(cfg: Config, seed: int = 0, policy: Policy = DEFAULT_POLICY,
                       image_size: int = 512,
                       device: Union[str, torch.device] = DEFAULT_DEVICE, mesh=None
                       ) -> Tuple[Student, TrainState]:
    """The Student for ``cfg.training.num_avatars`` avatars (seeded random
    weights on `device`, the card by default) and its state with its
    optimiser (``cfg.training.lr`` over ``student_epochs * steps_per_epoch``
    steps). The Student runs at `image_size`, which must be a multiple of
    8. With a `mesh`, the Student is distributed over it and its optimiser
    makes its collectives."""
    if image_size % 8:
        raise ValueError(f"the Student needs a size divisible by 8, got {image_size}")
    student = build_student(cfg.training.num_avatars, cfg.make_arch(), policy=policy,
                            device=resolve_device(device), seed=seed)
    distribute(student, mesh)
    steps = (cfg.training.steps_per_epoch or 1) * cfg.training.student_epochs
    return student, TrainState(student, make_optimizer(student, cfg.training.lr, steps,
                                                       mesh=mesh))


def make_teacher_forward(teacher: GHR, include_enh: bool = True,
                         bn_mode: str = "running"
                         ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """The frozen teacher as ``(xs, xd) -> target`` in [0, 1], float32.

    With ``include_enh=False`` the Gbase image is the target: use it when no
    trained Genh exists, since a random Genh collapses the targets to
    near-constant. ``bn_mode='batch'`` runs the teacher's Gbase on its
    input's own batch statistics, recording none; small-batch-trained Gbase
    checkpoints carry a train/eval BatchNorm gap that washes out targets
    made with the running statistics ('running'). K2 can carry the G2d
    trunk only in 'running' mode: batch statistics do not fold into it.
    Genh always uses its running statistics."""
    check_bn_mode(bn_mode)

    @torch.no_grad()
    def forward(xs: torch.Tensor, xd: torch.Tensor) -> torch.Tensor:
        teacher.eval()
        xhat = teacher.gbase.generate(xs, xd, train=bn_mode == "batch")
        if not include_enh:
            return xhat.float()
        return (teacher.genh(xhat).float() + 1.0) * 0.5

    return forward


def make_student_train_step(student: Student, teacher: GHR, cfg: Config, mesh=None):
    """The stage-3 step ``(state, batch) -> (state, metrics)``. `batch`
    holds 'driving' [B, H, W, 3] in [0, 1], 'avatar_index' [B] integers,
    and either 'target01' (the target, made ahead, e.g. by
    ``make_teacher_forward``) or 'source' [B, H, W, 3], from which the
    frozen teacher makes it inline: (tanh + 1) / 2 of GHR with running
    statistics. `state` is the Student's, updated in place and returned;
    the metric 'loss_student' is a detached float32 scalar (the mean over
    the ranks of `mesh`)."""
    del cfg  # the JAX step takes it too and reads nothing of it
    teacher_forward = make_teacher_forward(teacher)

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        xd = batch["driving"]
        if "target01" in batch:
            target01 = batch["target01"].detach()
        else:
            target01 = teacher_forward(batch["source"], xd)
        student.train()
        pred = student(xd, batch["avatar_index"], train=True)
        loss = torch.mean((pred.float() - target01) ** 2)
        state.apply_gradients(torch.autograd.grad(loss, state.params, allow_unused=True))
        return state, mean_over_ranks({"loss_student": loss.detach()}, mesh)

    return step
