"""Shared helpers of the port's parity tests (tests/test_torch_port_*.py).

Inputs are drawn with numpy from a seed and handed to both packages; JAX
variables cross to the port through utils/jax_bridge as numpy trees.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import torch
from flax.core import unfreeze

from megaportraits_tpu_torch.train.state import trainable_parameters
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


def numpy_init(module, *inputs, seed=0, stats_seed=None, **kwargs):
    """A flax module's variables drawn with numpy from `seed`, without
    compiling its ``init`` (``jax.eval_shape`` gives the tree): conv and
    dense kernels uniform +-1/sqrt(fan_in) (torch's default), norm scales
    and weights U(0.8, 1.2), embedding tables N(0, 1), other leaves (biases)
    N(0, 0.05). `stats_seed` as in ``init_jax``."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *inputs, **kwargs)
    v = numpy_fill(shapes, seed)
    return randomize_batch_stats(v, stats_seed) if stats_seed is not None else v


def numpy_fill(tree, seed=0):
    """``numpy_init``'s draws for every leaf of `tree` (arrays or shape
    structs): a numpy tree of float32 arrays of the same shapes."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        if name.endswith("kernel"):
            bound = 1.0 / np.sqrt(np.prod(s.shape[:-1]))
            a = rng.uniform(-bound, bound, s.shape)
        elif name.endswith(("scale", "weight")):
            a = rng.uniform(0.8, 1.2, s.shape)
        elif name == "embedding":
            a = rng.normal(size=s.shape)
        else:
            a = rng.normal(size=s.shape) * 0.05
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, unfreeze(tree))


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



def keep_gradients():
    """An optax transformation that applies no update and keeps the
    gradients as its state, so that a JAX train step hands its gradients
    out in ``opt_state``."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda grads, state, params=None: (
            jax.tree_util.tree_map(jnp.zeros_like, grads), grads))


def grad_errors(module, jax_grads):
    """Relative Frobenius error of each trainable parameter's ``.grad``
    against `jax_grads` (port keys, ``jax_to_state_dict`` of the gradient
    tree), for leaves above 1e-6 of the largest gradient norm, and over
    those leaves together."""
    named = trainable_parameters(module)
    norms = {k: np.linalg.norm(jax_grads[k].numpy()) for k, _ in named}
    floor = 1e-6 * max(norms.values())
    per_leaf, got_all, want_all = {}, [], []
    for k, p in named:
        if norms[k] <= floor:
            continue
        got, want = n(p.grad), jax_grads[k].numpy()
        per_leaf[k] = np.linalg.norm(got - want) / norms[k]
        got_all.append(got.ravel())
        want_all.append(want.ravel())
    got_all, want_all = np.concatenate(got_all), np.concatenate(want_all)
    return per_leaf, np.linalg.norm(got_all - want_all) / np.linalg.norm(want_all)


def frozen_bn_statistics(tree, seed=0):
    """`tree` (a numpy params tree) with every leaf named ``var`` or
    ``*_var`` drawn from U(0.5, 1.5) and every ``mean`` / ``*_mean`` from
    N(0, 0.2): the frozen networks (FAN, InceptionResnetV1) keep their
    BatchNorm statistics among their parameters, where ``numpy_fill``'s
    N(0, 0.05) would give negative variances."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "var" or name.endswith("_var"):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name == "mean" or name.endswith("_mean"):
            return (rng.normal(size=a.shape) * 0.2).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(draw, tree)


def numpy_state_dict(module, seed=0):
    """numpy draws for every tensor of a torch `module`'s state_dict, as a
    pretrained checkpoint holds them: BatchNorm variances U(0.5, 1.5),
    means U(-0.3, 0.3), scales U(0.8, 1.2), biases N(0, 0.1), weights
    N(0, 2/fan_in)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in module.state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("running_var"):
            a = rng.uniform(0.5, 1.5, shape)
        elif k.endswith("running_mean"):
            a = rng.uniform(-0.3, 0.3, shape)
        elif len(shape) == 1 and k.endswith("weight"):
            a = rng.uniform(0.8, 1.2, shape)
        elif len(shape) == 1:
            a = rng.normal(0, 0.1, shape)
        else:
            a = rng.normal(0, (2.0 / max(int(np.prod(shape[1:])), 1)) ** 0.5, shape)
        out[k] = torch.from_numpy(a.astype(np.float32))
    return out
