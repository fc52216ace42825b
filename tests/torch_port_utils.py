"""Shared helpers of the port's parity tests (tests/test_torch_port_*.py).

Inputs are drawn with numpy from a seed and handed to both packages; JAX
variables cross to the port through utils/jax_bridge as numpy trees.
"""

import numpy as np
import jax
import torch
from flax.core import unfreeze

from megaportraits_tpu_torch.utils.jax_bridge import load_jax_variables


def numpy_tree(variables):
    return jax.tree_util.tree_map(np.asarray, unfreeze(variables))


def randomize_batch_stats(variables, seed=0):
    """Non-trivial BN statistics: means ~ N(0, 0.2), variances ~ U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    out = dict(variables)
    if "batch_stats" not in out:
        return out

    def draw(path, a):
        name = str(getattr(path[-1], "key", path[-1]))
        if name.endswith("var"):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return (rng.normal(size=a.shape) * 0.2).astype(np.float32)

    out["batch_stats"] = jax.tree_util.tree_map_with_path(draw, out["batch_stats"])
    return out


def init_jax(module, *inputs, seed=0, stats_seed=None, **kwargs):
    """Init a flax module on `inputs`; returns a numpy variable tree."""
    v = numpy_tree(module.init(jax.random.PRNGKey(seed), *inputs, **kwargs))
    if stats_seed is not None:
        v = randomize_batch_stats(v, stats_seed)
    return v


def bridged(torch_module, variables):
    """Load JAX variables into a torch module (strict) and return it."""
    return load_jax_variables(torch_module, variables)


def t(x):
    return torch.from_numpy(np.array(x, copy=True))


def n(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def uniform(rng, shape, lo=-1.0, hi=1.0):
    return rng.uniform(lo, hi, shape).astype(np.float32)

