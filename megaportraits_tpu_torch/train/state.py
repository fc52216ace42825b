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

Given a mesh (``parallel/mesh.py``), the optimiser makes the collectives
that GSPMD inserts for JAX. The steps take gradients with
``torch.autograd.grad`` and call Gbase methods other than ``forward``, which
``DistributedDataParallel``'s and FSDP's hooks would not see; instead:
  * the gradients are averaged over ``data`` (all-reduced in flat buckets);
  * a parameter that ``parallel/sharding_rules.py`` shards over ``model``
    has its gradient reduce-scattered over ``model``; AdamW keeps the
    moments and the updated values of this rank's shard only, and the
    shards are gathered into the parameter after the step;
  * the clip's global norm is taken over the averaged gradient, the squares
    of the sharded gradients summed over ``model``: the norm optax sees in
    JAX.
``state_dict`` gathers the shards, so that a checkpoint has the
single-process format; ``load_state_dict`` takes that format either way.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from megaportraits_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, axis_group, axis_size
from megaportraits_tpu_torch.parallel.sharding_rules import fsdp_param_specs, shard_of

FROZEN_KEYS = ("rotation_net",)
BUCKET_BYTES = 2**26  # the largest flat bucket of gradients in one all-reduce
MOMENTS = ("exp_avg", "exp_avg_sq")

# torch 2.13 renames the two collectives; the card's torch has the old names.
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


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
    """AdamW on a cosine schedule with an optional global-norm clip, and the
    collectives of `mesh` (None: one rank; the module docstring).
    `shard_dims` gives each parameter's dim sharded over ``model``, or
    None."""

    def __init__(self, params: Iterable[nn.Parameter], lr: float, total_steps: int,
                 eta_min: float = 1e-6, b1: float = 0.5, b2: float = 0.999,
                 weight_decay: float = 1e-2, grad_clip: Optional[float] = None,
                 mesh=None, shard_dims: Optional[Sequence[Optional[int]]] = None):
        self.params = list(params)
        self.grad_clip = grad_clip
        self.mesh = mesh
        self.shard_dims = list(shard_dims or [None] * len(self.params))
        # What AdamW updates: the parameter itself, or a copy of this rank's
        # shard of it.
        self.masters = [p if dim is None
                        else nn.Parameter(shard_of(p.detach(), dim, mesh).clone())
                        for p, dim in zip(self.params, self.shard_dims, strict=True)]
        alpha = eta_min / lr if lr > 0 else 0.0
        self.adamw = torch.optim.AdamW(self.masters, lr=lr, betas=(b1, b2), eps=1e-8,
                                       weight_decay=weight_decay)
        self.schedule = torch.optim.lr_scheduler.LambdaLR(
            self.adamw, lambda count: cosine_factor(count, total_steps, alpha))

    def step(self, grads: Sequence[Optional[torch.Tensor]]) -> None:
        """Apply `grads` (one per parameter, in order; None counts as zero,
        as JAX's gradient of an unused leaf is zero). Each parameter's
        ``.grad`` keeps its gradient (averaged over ``data``) until the next
        step."""
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self.params, grads, strict=True)]
        data_group = axis_group(self.mesh, DATA_AXIS)
        if data_group is not None:
            all_reduce_mean(grads, data_group, axis_size(self.mesh, DATA_AXIS))
        n_model = axis_size(self.mesh, MODEL_AXIS)
        for p, g, master, dim in zip(self.params, grads, self.masters, self.shard_dims):
            p.grad = g
            if dim is not None:
                # The parameter is authoritative (a checkpoint or a weight
                # load may have replaced it since the last step).
                with torch.no_grad():
                    master.copy_(shard_of(p, dim, self.mesh))
                moved = g.movedim(dim, 0).contiguous()
                shard = moved.new_empty((moved.shape[0] // n_model, *moved.shape[1:]))
                _reduce_scatter(shard, moved, group=axis_group(self.mesh, MODEL_AXIS))
                master.grad = shard.div_(n_model).movedim(0, dim).contiguous()
        if self.grad_clip:
            clip_by_global_norm(self.masters, self.grad_clip,
                                [dim is not None for dim in self.shard_dims],
                                axis_group(self.mesh, MODEL_AXIS))
        self.adamw.step()
        self.schedule.step()
        with torch.no_grad():
            for p, master, dim in zip(self.params, self.masters, self.shard_dims):
                if dim is not None:
                    p.copy_(self._gathered(master, dim))

    def _gathered(self, shard: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole tensor of which each rank of the model group holds a
        `shard` along `dim`."""
        moved = shard.movedim(dim, 0).contiguous()
        whole = moved.new_empty((moved.shape[0] * axis_size(self.mesh, MODEL_AXIS),
                                 *moved.shape[1:]))
        _all_gather(whole, moved, group=axis_group(self.mesh, MODEL_AXIS))
        return whole.movedim(0, dim)

    def state_dict(self) -> Dict[str, dict]:
        """AdamW's state, its moments gathered whole, and the schedule's: the
        single-process format. A collective when parameters are sharded:
        every rank calls it."""
        adamw = self.adamw.state_dict()
        for i, dim in enumerate(self.shard_dims):
            if dim is not None and i in adamw["state"]:
                adamw["state"][i] = {k: self._gathered(v, dim) if k in MOMENTS else v
                                     for k, v in adamw["state"][i].items()}
        return {"adamw": adamw, "schedule": self.schedule.state_dict()}

    def load_state_dict(self, state: Dict[str, dict]) -> None:
        """Load ``state_dict``'s format, keeping this rank's shards of the
        moments of sharded parameters."""
        adamw = dict(state["adamw"], state=dict(state["adamw"]["state"]))
        for i, dim in enumerate(self.shard_dims):
            if dim is not None and i in adamw["state"]:
                adamw["state"][i] = {
                    k: shard_of(v, dim, self.mesh).clone() if k in MOMENTS else v
                    for k, v in adamw["state"][i].items()}
        self.adamw.load_state_dict(adamw)
        self.schedule.load_state_dict(state["schedule"])


def all_reduce_mean(tensors: Sequence[torch.Tensor], group, size: int) -> None:
    """Average `tensors` in place over the `size` ranks of `group`, in flat
    buckets of one dtype and at most ``BUCKET_BYTES``."""
    bucket: List[torch.Tensor] = []

    def flush():
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat, group=group)
        flat.div_(size)
        for t, part in zip(bucket, flat.split([t.numel() for t in bucket])):
            t.copy_(part.view_as(t))
        bucket.clear()

    for t in tensors:
        if bucket and (t.dtype != bucket[0].dtype
                       or sum(b.nbytes for b in bucket) + t.nbytes > BUCKET_BYTES):
            flush()
        bucket.append(t)
    if bucket:
        flush()


def clip_by_global_norm(params: Sequence[nn.Parameter], max_norm: float,
                        sharded: Optional[Sequence[bool]] = None,
                        model_group=None) -> None:
    """optax ``clip_by_global_norm``: scale every gradient by
    max_norm / norm when the global norm reaches max_norm. The gradients
    that `sharded` marks are this rank's shards: their squares are summed
    over `model_group` into the norm."""
    grads = [p.grad for p in params]
    sharded = list(sharded or [False] * len(grads))
    norms = [torch.linalg.vector_norm(g.float()) for g in grads]
    norm = torch.linalg.vector_norm(torch.stack(
        [n for n, s in zip(norms, sharded) if not s] or [norms[0] * 0]))
    if any(sharded):
        parts = torch.stack([n * n for n, s in zip(norms, sharded) if s]).sum()
        dist.all_reduce(parts, group=model_group)
        norm = torch.sqrt(norm * norm + parts)
    factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(factor)


def make_optimizer(module: nn.Module, lr: float, total_steps: int,
                   eta_min: float = 1e-6, b1: float = 0.5, b2: float = 0.999,
                   weight_decay: float = 1e-2, grad_clip: Optional[float] = None,
                   mesh=None) -> Optimizer:
    """The optimiser of `module`'s trainable parameters, with the
    collectives of `mesh` (None: one rank)."""
    named = trainable_parameters(module)
    specs = fsdp_param_specs(module, mesh)
    return Optimizer((p for _, p in named), lr, total_steps, eta_min, b1, b2,
                     weight_decay, grad_clip, mesh=mesh,
                     shard_dims=[specs[name] for name, _ in named])


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
