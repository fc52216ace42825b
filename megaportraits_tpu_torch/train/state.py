"""Train state and optimiser (counterpart of ``megaportraits_tpu/train/state.py``).

The optimiser is the JAX package's ``make_optimizer``: AdamW with
betas (0.5, 0.999), eps 1e-8 and decoupled weight decay 1e-2, its rate on
optax's per-step cosine schedule

    lr_t = lr * ((1 - alpha) * 0.5 * (1 + cos(pi * min(t, T) / T)) + alpha),
    alpha = eta_min / lr,

with t the number of steps taken before this one (the first step uses
``lr``), and an optional clip of the gradients' global norm first.
Parameters under a frozen name (``rotation_net``, the frozen SixDRepNet)
are left out of the optimiser: no update, no weight decay, and they do not
count in the global norm.
"""

from __future__ import annotations

import math
from typing import Iterable, List, Optional, Sequence, Tuple

import torch
from torch import nn

FROZEN_KEYS = ("rotation_net",)


def trainable_parameters(module: nn.Module) -> List[Tuple[str, nn.Parameter]]:
    """(name, parameter) of every parameter of `module` whose name has no
    component containing a frozen key (JAX ``_trainable_mask``)."""
    return [(name, p) for name, p in module.named_parameters()
            if not any(f in part for part in name.split(".") for f in FROZEN_KEYS)]


def cosine_factor(count: int, total_steps: int, alpha: float) -> float:
    """optax ``cosine_decay_schedule`` over ``init_value``, at step `count`."""
    t = max(total_steps, 1)
    return (1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * min(count, t) / t)) + alpha


class Optimizer:
    """AdamW on a cosine schedule with an optional global-norm clip."""

    def __init__(self, params: Iterable[nn.Parameter], lr: float, total_steps: int,
                 eta_min: float = 1e-6, b1: float = 0.5, b2: float = 0.999,
                 weight_decay: float = 1e-2, grad_clip: Optional[float] = None):
        self.params = list(params)
        self.grad_clip = grad_clip
        alpha = eta_min / lr if lr > 0 else 0.0
        self.adamw = torch.optim.AdamW(self.params, lr=lr, betas=(b1, b2), eps=1e-8,
                                       weight_decay=weight_decay)
        self.schedule = torch.optim.lr_scheduler.LambdaLR(
            self.adamw, lambda count: cosine_factor(count, total_steps, alpha))

    def step(self, grads: Sequence[Optional[torch.Tensor]]) -> None:
        """Apply `grads` (one per parameter, in order; None counts as zero,
        as JAX's gradient of an unused leaf is zero). They stay in ``.grad``
        until the next step."""
        for p, g in zip(self.params, grads, strict=True):
            p.grad = torch.zeros_like(p) if g is None else g
        if self.grad_clip:
            clip_by_global_norm(self.params, self.grad_clip)
        self.adamw.step()
        self.schedule.step()


def clip_by_global_norm(params: Sequence[nn.Parameter], max_norm: float) -> None:
    """optax ``clip_by_global_norm``: scale every gradient by
    max_norm / norm when the global norm reaches max_norm."""
    grads = [p.grad for p in params]
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(factor)


def make_optimizer(module: nn.Module, lr: float, total_steps: int,
                   eta_min: float = 1e-6, b1: float = 0.5, b2: float = 0.999,
                   weight_decay: float = 1e-2, grad_clip: Optional[float] = None
                   ) -> Optimizer:
    """The optimiser of `module`'s trainable parameters."""
    return Optimizer((p for _, p in trainable_parameters(module)),
                     lr, total_steps, eta_min, b1, b2, weight_decay, grad_clip)


class TrainState:
    """A model, its optimiser and the number of steps taken (the JAX
    ``TrainState``; parameters and BatchNorm statistics live in the model)."""

    def __init__(self, model: nn.Module, tx: Optimizer):
        self.model = model
        self.tx = tx
        self.step = 0

    @property
    def params(self) -> List[nn.Parameter]:
        """The trainable parameters, in the optimiser's order."""
        return self.tx.params

    def apply_gradients(self, grads: Sequence[Optional[torch.Tensor]]) -> "TrainState":
        self.tx.step(grads)
        self.step += 1
        return self
