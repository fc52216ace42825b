"""Process groups, the device mesh and data-parallel helpers (counterpart of
``megaportraits_tpu/parallel/mesh.py``).

JAX runs one process over every device and lets GSPMD shard the batch over
the mesh's ``data`` axis and the large parameters over ``model``. The port
runs one process a card, launched by ``torchrun``
(``torchrun --standalone --nproc-per-node N -m megaportraits_tpu_torch
train-base --config ...``), and makes each collective explicit:

  * ``init_distributed`` joins the process group that ``torchrun``'s
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``) describes: NCCL
    on the card, where rank r runs on ``cuda:LOCAL_RANK``, gloo when the
    caller asks for the CPU. Without that environment the world is one rank
    with no group;
  * ``make_mesh`` returns a ``DeviceMesh`` with the axes ``data`` and
    ``model`` over the group, or None for one rank without a group (the
    steps read None as one rank);
  * ``shard_batch`` gives each rank its rows of the global batch, and
    ``replicate`` broadcasts a module's state from rank 0: together they do
    what JAX's ``device_put`` with ``batch_sharding`` and
    ``replicated_sharding`` does;
  * ``all_reduce_sum`` is a sum over a group that autograd sees through
    (its backward sums the gradient over the group): the train-mode
    BatchNorm (``nn/layers.BatchNorm``) and the cycle loss's sum of
    negatives (``losses/cycle.cosine_loss``) reduce over ``data`` with it,
    as GSPMD's reductions over the global batch do in JAX.
The optimiser's collectives (gradients averaged over ``data``, sharded
parameters reduce-scattered and gathered over ``model``) are in
``train/state.py``; the rule for which parameters are sharded in
``parallel/sharding_rules.py``.
"""

from __future__ import annotations

import math
import os
import warnings
from typing import Any, Dict, Iterable, Mapping, Optional, Union

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from megaportraits_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
AXES = (DATA_AXIS, MODEL_AXIS)


def fit_mesh_shape(shape: Optional[Dict[str, int]], n_devices: int) -> Dict[str, int]:
    """Adapt a requested mesh shape to the devices actually available (JAX's
    function): keep the non-data axes if their product divides
    ``n_devices`` (the data axis takes the rest), otherwise halve the
    largest non-data axis (dropping it at 1) until a factorisation fits;
    ``{data: n_devices}`` as a last resort."""
    shape = dict(shape) if shape else {DATA_AXIS: n_devices}
    if DATA_AXIS not in shape:
        shape = {DATA_AXIS: 1, **shape}
    other = {k: v for k, v in shape.items() if k != DATA_AXIS}
    while other:
        prod = int(np.prod(list(other.values())))
        if prod <= n_devices and n_devices % prod == 0:
            return {DATA_AXIS: n_devices // prod, **other}
        k = max(other, key=other.get)
        if other[k] > 1:
            other[k] //= 2
        else:
            other.pop(k)
    return {DATA_AXIS: n_devices}


def init_distributed(device: Union[str, torch.device] = DEFAULT_DEVICE) -> torch.device:
    """Join the process group of ``torchrun``'s environment, once, and
    return this rank's device: ``cuda:LOCAL_RANK`` on the card (NCCL), the
    CPU when `device` asks for it (gloo). Without ``WORLD_SIZE`` in the
    environment there is one rank and no group, and `device` is returned
    as it is (resolved: a request for the card without one raises)."""
    dev = resolve_device(device)
    if "WORLD_SIZE" not in os.environ:
        return dev
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    return dev


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    """True on rank 0 and in a process without a group: the one process
    that logs, writes images, saves checkpoints and exports."""
    return not dist.is_initialized() or dist.get_rank() == 0


def make_mesh(shape: Optional[Dict[str, int]] = None, strict: bool = False,
              device: Union[str, torch.device] = DEFAULT_DEVICE):
    """A ``DeviceMesh`` over the process group with the axes ``data`` and
    ``model`` (``model`` is 1 unless `shape` asks for it); the ranks are
    laid out row-major, as JAX reshapes its devices: rank = data index *
    model size + model index. Unless `strict`, `shape` is adapted to the
    world size with ``fit_mesh_shape`` and a warning names the change, as
    in JAX; with `strict` a mismatch raises. Returns None when there is no
    process group (one rank): the steps read None as one rank."""
    n = world_size()
    requested = dict(shape) if shape else {DATA_AXIS: n}
    unknown = set(requested) - set(AXES)
    if unknown:
        raise ValueError(f"mesh axes {sorted(unknown)} are not among {AXES}")
    if strict:
        if math.prod(requested.values()) != n:
            raise ValueError(f"mesh shape {requested} does not match {n} processes")
        fitted = requested
    else:
        fitted = fit_mesh_shape(requested, n)
        if fitted != requested:
            warnings.warn(f"mesh shape {requested} adapted to {fitted} for {n} "
                          f"visible devices", stacklevel=2)
    if not dist.is_initialized():
        return None
    from torch.distributed.device_mesh import init_device_mesh

    dims = (fitted.get(DATA_AXIS, 1), fitted.get(MODEL_AXIS, 1))
    return init_device_mesh(torch.device(device).type, dims, mesh_dim_names=AXES)


def axis_size(mesh, axis: str) -> int:
    """The number of ranks along `axis` (1 without a mesh)."""
    return 1 if mesh is None else mesh.size(mesh.mesh_dim_names.index(axis))


def axis_group(mesh, axis: str):
    """The process group of this rank along `axis` (None without a mesh)."""
    return None if mesh is None else mesh.get_group(axis)


def axis_index(mesh, axis: str) -> int:
    """This rank's index along `axis` (0 without a mesh)."""
    return 0 if mesh is None else mesh.get_local_rank(axis)


def check_per_chip_batch(global_batch: int, mesh) -> int:
    """The per-card batch: the ceiling of `global_batch` over the data axis,
    with JAX's warning when the batch does not divide it. JAX also warns for
    per-chip batches of 2 to 7, a regime that its measurements found slow on
    the TPU's convolutions; that is a TPU measurement and is left out."""
    data = axis_size(mesh, DATA_AXIS)
    per_chip = max(1, -(-global_batch // data))
    if global_batch % data != 0:
        warnings.warn(
            f"global batch {global_batch} does not divide the data-axis size "
            f"{data}: the batch cannot be sharded evenly and the step will "
            f"fail. Use a multiple of the data-axis size.", stacklevel=2)
    return per_chip


def check_batch_divides(global_batch: int, mesh) -> None:
    """Raise unless the data axis divides `global_batch`. JAX's drivers
    shrink the data axis to the largest divisor of the batch instead; a
    launch of N processes cannot shrink, so the message names that
    divisor."""
    data = axis_size(mesh, DATA_AXIS)
    if global_batch % data:
        divisor = max(d for d in range(1, data + 1) if global_batch % d == 0)
        raise ValueError(
            f"batch_size {global_batch} does not divide over a data axis of "
            f"{data}: launch {divisor * axis_size(mesh, MODEL_AXIS)} processes "
            f"(a data axis of {divisor}, the largest divisor of the batch) or "
            f"change batch_size")


def shard_batch(batch: Mapping[str, Any], mesh, axis: int = 0) -> Dict[str, Any]:
    """This rank's rows of a global host batch: the data index d of D takes
    rows [d * B / D, (d + 1) * B / D) along `axis` of every array (the batch
    axis: 1 for batches stacked on a leading unroll axis). Concatenating
    the shards in rank order gives the global batch back. Raises when D
    does not divide B."""
    data = axis_size(mesh, DATA_AXIS)
    if data == 1:
        return dict(batch)
    d = axis_index(mesh, DATA_AXIS)
    out = {}
    for k, v in batch.items():
        b = v.shape[axis]
        if b % data:
            raise ValueError(f"'{k}': batch axis {b} does not divide over {data} ranks")
        rows = slice(d * (b // data), (d + 1) * (b // data))
        out[k] = v[(slice(None),) * axis + (rows,)]
    return out


def replicate(module: nn.Module, mesh) -> nn.Module:
    """Broadcast every parameter and buffer of `module` from rank 0, so
    that each rank starts from the same state (JAX's replicated
    ``device_put``). Nothing to do without a mesh."""
    if mesh is not None:
        with torch.no_grad():
            for tensor in module.state_dict().values():
                dist.broadcast(tensor, src=0)
    return module


def sync_batch_norm(module: nn.Module, mesh) -> nn.Module:
    """Make every train-mode BatchNorm of `module` take its statistics over
    the global batch (a sum over the data group, ``BatchNorm.sync_group``)."""
    from megaportraits_tpu_torch.nn.layers import BatchNorm

    group = axis_group(mesh, DATA_AXIS)
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.sync_group = group
    return module


def distribute(module: nn.Module, mesh) -> nn.Module:
    """`module` as every rank of `mesh` holds it: rank 0's state
    (``replicate``), its BatchNorms normalising over the data group
    (``sync_batch_norm``)."""
    return sync_batch_norm(replicate(module, mesh), mesh)


class _AllReduceSum(torch.autograd.Function):
    """Forward: the sum over `group`. Backward: the gradient summed over
    `group`, which is the gradient of the sum of every rank's loss."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over the ranks of `group`, differentiable. Every rank
    of the group must call it, in the same order, forward and backward."""
    return _AllReduceSum.apply(x, group)


def mean_over_ranks(metrics: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """The mean of each scalar metric over every rank (one all-reduce):
    each rank's loss is the mean over its rows, so the mean over equal
    shards is the loss of the global batch, what one process prints."""
    if mesh is None:
        return metrics
    keys = list(metrics)
    stacked = torch.stack([metrics[k].detach().float() for k in keys])
    dist.all_reduce(stacked)
    stacked /= world_size()
    return dict(zip(keys, stacked.unbind()))


def broadcast_from_main(values: Iterable[Any]) -> list:
    """Rank 0's `values` on every rank (a list of picklable objects), so
    that decisions made from host numbers (held-out scores, early
    stopping) are the same everywhere; the values as they are without a
    group."""
    values = list(values)
    if dist.is_initialized():
        dist.broadcast_object_list(values, src=0)
    return values
