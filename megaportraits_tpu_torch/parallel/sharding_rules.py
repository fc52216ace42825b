"""Which parameters are sharded over the ``model`` axis (counterpart of
``megaportraits_tpu/parallel/sharding_rules.py``).

JAX's rule: a parameter with at least `min_shard_size` elements is sharded
along its last axis if the model-axis size divides it, otherwise along its
largest divisible axis; everything else is replicated. It picks the axis in
JAX's layout (conv kernels HWIO/DHWIO, dense kernels [in, out]), which the
port stores transposed (OIHW/OIDHW, [out, in]: ``utils/jax_bridge.py``),
so the port applies the rule to the JAX-layout shape and maps the chosen
axis back through that permutation: JAX's output-feature axis is the
port's dim 0.

The port keeps every parameter whole on every rank between steps (the
forward needs it whole). Sharding applies to the optimiser
(``train/state.py``): a sharded parameter's gradient is reduce-scattered
over ``model``, each rank keeps AdamW's moments and the updated values of
its shard, and the shards are gathered into the parameter after each step.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from megaportraits_tpu_torch.parallel.mesh import MODEL_AXIS, axis_index, axis_size


def jax_layout(module: nn.Module, name: str, ndim: int) -> Tuple[int, ...]:
    """perm with ``port_shape[j] == jax_shape[perm[j]]`` for the parameter
    `name` of `module` (the bridge's transposes: conv and dense weights;
    embedding tables and every other leaf keep their layout)."""
    owner_name, _, leaf = name.rpartition(".")
    owner = module.get_submodule(owner_name) if owner_name else module
    if leaf != "weight" or ndim < 2 or isinstance(owner, nn.Embedding):
        return tuple(range(ndim))
    if ndim == 2:
        return (1, 0)
    nd = ndim - 2
    return (nd + 1, nd, *range(nd))


def jax_shard_axis(jax_shape: Sequence[int], n: int,
                   min_shard_size: int = 2**16) -> Optional[int]:
    """JAX's ``fsdp_param_specs`` for one leaf: the axis sharded over a
    model axis of size `n`, or None (replicated)."""
    if np.prod(jax_shape, dtype=np.int64) < min_shard_size:
        return None
    order = sorted(range(len(jax_shape)),
                   key=lambda i: (i != len(jax_shape) - 1, -jax_shape[i]))
    for axis in order:
        if jax_shape[axis] % n == 0 and jax_shape[axis] >= n:
            return axis
    return None


def fsdp_param_specs(module: nn.Module, mesh,
                     min_shard_size: int = 2**16) -> Dict[str, Optional[int]]:
    """Parameter name -> the port dim sharded over ``model``, or None
    (replicated); all None when the mesh has no model axis above 1."""
    n = axis_size(mesh, MODEL_AXIS)
    specs = {}
    for name, p in module.named_parameters():
        dim = None
        if n > 1:
            perm = jax_layout(module, name, p.ndim)
            jax_shape = [0] * p.ndim
            for j, a in enumerate(perm):
                jax_shape[a] = p.shape[j]
            axis = jax_shard_axis(jax_shape, n, min_shard_size)
            dim = None if axis is None else perm.index(axis)
        specs[name] = dim
    return specs


def shard_of(tensor: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """This rank's slice of `tensor` along `dim` (its model index of n
    equal slices), a view."""
    n = axis_size(mesh, MODEL_AXIS)
    size = tensor.shape[dim] // n
    return tensor.narrow(dim, axis_index(mesh, MODEL_AXIS) * size, size)


def shard_params(module: nn.Module, mesh,
                 min_shard_size: int = 2**16) -> Dict[str, torch.Tensor]:
    """Each parameter as this rank keeps it: its shard (a copy) where the
    rule selects it, the parameter itself otherwise."""
    specs = fsdp_param_specs(module, mesh, min_shard_size)
    return {name: p if specs[name] is None else shard_of(p.detach(), specs[name], mesh).clone()
            for name, p in module.named_parameters()}
