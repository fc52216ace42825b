"""Load JAX (Flax) variables into the port's modules.

The input is a Flax ``{'params': ..., 'batch_stats': ...}`` tree given as
nested dicts of **numpy** arrays (convert with
``jax.tree_util.tree_map(np.asarray, variables)``), so this module needs no
JAX. Module names match between the two packages; the rules are:

  * Flax's wrapper scopes ``Conv_<i>``, ``Dense_<i>``, ``BatchNorm_<i>``
    vanish (the port's layers hold their parameters directly);
  * the hand-rolled ResBlock2D leaves ``conv1_kernel``, ``bn1_scale``,
    ``bn1_mean``... become ``conv1.kernel``, ``bn1.scale``, ``bn1.mean``...;
  * ``kernel`` -> ``weight``: conv HWIO/DHWIO -> OIHW/OIDHW (grouped convs
    too: both keep ``in/groups`` inputs per filter), dense (in, out) ->
    (out, in); ``scale`` -> ``weight``; an ``nn.Embed`` table
    ``embedding`` -> the ``weight`` of ``torch.nn.Embedding`` (both
    [num, features]); ``mean`` / ``var`` -> ``running_mean`` /
    ``running_var``; other leaves keep their names.

Modules without parameters (InstanceNorm, GroupNorm32) have no leaves on
either side. The same rules cover the training modules (Discriminator,
PerceptualLoss with its VGG19 and LPIPS trunks). A gradient tree has the
params tree's structure, so it crosses the same way:
``jax_to_state_dict({"params": grads})`` gives each gradient under the
name of the port parameter it belongs to, in the port's layout.

The two flattens that feed a dense layer (Eapp's [B,2,2,512] descriptor and
Emtn's tiled expression pool) are computed in the same (h, w, c) order as
in JAX, so their weights need no permutation.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

_WRAPPER = re.compile(r"^(Conv|Dense|BatchNorm)_\d+$")
_PREFIXED = re.compile(r"^(.+)_(kernel|bias|scale|mean|var)$")
_RENAME = {"kernel": "weight", "scale": "weight", "embedding": "weight",
           "mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping, prefix=()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, np.asarray(value)


def _torch_key(path) -> str:
    parts = [p for p in path if not _WRAPPER.match(p)]
    leaf = parts[-1]
    m = _PREFIXED.match(leaf)
    if m and leaf != "adaptive_matrix_gamma":
        parts = parts[:-1] + [m.group(1), m.group(2)]
    parts[-1] = _RENAME.get(parts[-1], parts[-1])
    return ".".join(parts)


def _convert(path, value: np.ndarray) -> np.ndarray:
    leaf = path[-1]
    if leaf == "kernel" or leaf.endswith("_kernel"):
        if value.ndim == 2:                       # dense (in, out)
            return value.T
        nd = value.ndim - 2                       # conv (*spatial, in, out)
        return np.transpose(value, (nd + 1, nd, *range(nd)))
    return value


def jax_to_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """Flax {params, batch_stats} numpy tree -> the port's state_dict keys.

    Raises if two JAX leaves would land on one torch key.
    """
    out: Dict[str, torch.Tensor] = {}
    sources: Dict[str, str] = {}
    for collection in ("params", "batch_stats"):
        for path, value in _flatten(variables.get(collection, {})):
            key = _torch_key(path)
            if key in out:
                raise ValueError(f"{'/'.join(path)} and {sources[key]} both map "
                                 f"to {key}")
            out[key] = torch.from_numpy(np.array(_convert(path, value), copy=True))
            sources[key] = "/".join((collection,) + path)
    return out


def load_jax_variables(module: nn.Module, variables: Mapping) -> nn.Module:
    """Copy a Flax variable tree into `module` with ``strict=True`` (every
    JAX leaf must land in exactly one parameter or buffer, and every
    parameter and buffer must be covered); dtypes and device follow the
    module."""
    state = jax_to_state_dict(variables)
    own = module.state_dict()
    for key, value in state.items():
        if key in own and tuple(own[key].shape) != tuple(value.shape):
            raise ValueError(f"{key}: JAX shape {tuple(value.shape)} does not "
                             f"match {tuple(own[key].shape)}")
    module.load_state_dict(state, strict=True)
    return module
