"""The JAX side of the full-width cases (``megaportraits_tpu_torch/utils/
seeded.py``) and the command that writes their golden.

``state_to_jax`` carries a port ``state_dict`` into the JAX variable tree:
it walks the JAX tree (from ``jax.eval_shape`` of the module's ``init``, so
nothing is compiled), names each leaf's port tensor with the bridge's own
key map (``utils/jax_bridge._torch_key``) and undoes the bridge's
transposes (``_convert``). ``jax_case`` runs a case in the JAX package on
the CPU in float32 (matmul precision 'highest').

Write the golden ``tests/data/torch_port_goldens.npz`` with

    python tests/torch_port_full_width.py

``--probe`` writes nothing: for each case it prints the output's std and
share of values in (0.01, 0.99), the port's gap to JAX, and how far one ulp
of input moves the port's output (the model's float32 gain); ``--probe
--he`` does so with weights N(0, 2/fan_in), the rule seeded.py turned down.

(under a minute on 8 CPU cores). Do so only after a change in the JAX
package or in seeded.py's draw rule, and say why in CHANGES.md: the golden
is what the port is held against on the card, and
tests/test_torch_port_full_width.py holds the JAX package against it.
"""

from __future__ import annotations

import os
import sys

import numpy as np

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "torch_port_goldens.npz")


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, dict):
            yield from _flatten(value, path)
        else:
            yield path, value


def _nest(items):
    out = {}
    for path, value in items:
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = value
    return out


def _unconvert(path, value: np.ndarray) -> np.ndarray:
    """The inverse of ``jax_bridge._convert``: dense [out, in] -> (in, out),
    conv OI* -> *IO."""
    leaf = path[-1]
    if leaf == "kernel" or leaf.endswith("_kernel"):
        if value.ndim == 2:
            return value.T
        nd = value.ndim - 2
        return np.transpose(value, (*range(2, nd + 2), 1, 0))
    return value


def state_to_jax(state, shapes):
    """Port `state` (key -> numpy array) as a JAX variable tree shaped like
    `shapes` ({'params': ..., 'batch_stats': ...} of arrays or shape
    structs). Raises unless every JAX leaf takes exactly one port tensor of
    its shape and every port tensor is taken."""
    from megaportraits_tpu_torch.utils.jax_bridge import _torch_key

    taken, tree = {}, {}
    for collection in ("params", "batch_stats"):
        items = []
        for path, leaf in _flatten(dict(shapes.get(collection, {}))):
            key = _torch_key(path)
            if key in taken:
                raise ValueError(f"{'/'.join(path)} and {taken[key]} both map to {key}")
            if key not in state:
                raise KeyError(f"{collection}/{'/'.join(path)} -> {key}: no port tensor")
            value = np.ascontiguousarray(_unconvert(path, np.asarray(state[key])))
            if value.shape != tuple(leaf.shape):
                raise ValueError(f"{key}: {value.shape} for JAX's {tuple(leaf.shape)}")
            taken[key] = "/".join((collection,) + path)
            items.append((path, value))
        if items:
            tree[collection] = _nest(items)
    unused = sorted(set(state) - set(taken))
    if unused:
        raise ValueError(f"port tensors no JAX leaf takes: {unused[:5]}")
    return tree


def jax_module(case):
    from megaportraits_tpu.core.arch import FULL
    from megaportraits_tpu.core.dtypes import FP32_POLICY
    from megaportraits_tpu.models.gbase import Gbase
    from megaportraits_tpu.models.genh import GHR
    from megaportraits_tpu.models.student import Student

    if case.name == "gbase":
        return Gbase(policy=FP32_POLICY, arch=FULL)
    if case.name == "ghr":
        return GHR(policy=FP32_POLICY, arch=FULL)
    return Student(case.num_avatars, policy=FP32_POLICY, arch=FULL)


def _init_args(case, images):
    if case.name == "student":
        return images, np.asarray(case.avatar_index, np.int32)
    return images[:1], images[1:2]


def jax_shapes(case, images):
    """The JAX variable tree of the case's module, as shape structs."""
    import jax
    from flax.core import unfreeze

    module = jax_module(case)
    return unfreeze(jax.eval_shape(module.init, jax.random.PRNGKey(0),
                                   *_init_args(case, images)))


def jax_case(case, variables, images):
    """The case in the JAX package: {'out'} and, for Gbase, 'vc2d' and
    'es', as numpy float32 (the port's ``seeded.run_case``)."""
    import jax

    from megaportraits_tpu.models.gbase import Gbase
    from megaportraits_tpu.ops.resize import linear_resize

    module = jax_module(case)
    if case.name == "gbase":
        state = jax.jit(lambda v, x: module.apply(v, x, method=Gbase.encode_source))(
            variables, images[:1])
        drive = jax.jit(lambda v, s, x: module.apply(v, s, x, method=Gbase.drive))
        out = np.concatenate([np.asarray(drive(variables, state, images[i:i + 1]))
                              for i in range(1, case.images)])
        return {"out": out, "vc2d": np.asarray(state["vc2d"]),
                "es": np.asarray(state["es"])}
    if case.name == "ghr":
        def hr(m, xs, xd):
            xhat, _ = m.gbase(xs, xd)
            up = linear_resize(xhat, (case.hr_size, case.hr_size), axes=(1, 2),
                               align_corners=False)
            return (m.genh(up) + 1.0) * 0.5

        return {"out": np.asarray(jax.jit(lambda v, a, b: module.apply(
            v, a, b, method=hr))(variables, images[:1], images[1:2]))}
    index = np.asarray(case.avatar_index, np.int32)
    return {"out": np.asarray(jax.jit(module.apply)(variables, images, index))}


def port_draws(case):
    """The case's seeded port weights and images, and their checksums."""
    from megaportraits_tpu_torch.utils import seeded

    state = seeded.case_state(case)
    images = seeded.seeded_images(case.image_seed, case.images, case.size)
    return state, images, seeded.checksum(state), seeded.checksum({"images": images})


def golden_entries(case, outputs, weights_sha, images_sha):
    """The golden's arrays of one case, under '<case>/<name>'."""
    from megaportraits_tpu_torch.utils import seeded

    out = {f"{case.name}/{k}": v for k, v in seeded.samples(outputs["out"]).items()}
    for name in ("vc2d", "es"):
        if name in outputs:
            out[f"{case.name}/{name}"] = seeded.summary(outputs[name])
    out[f"{case.name}/seeds"] = np.array([case.weight_seed, case.image_seed], np.int64)
    out[f"{case.name}/weights_sha256"] = np.array(weights_sha)
    out[f"{case.name}/images_sha256"] = np.array(images_sha)
    return out


def he_state(case):
    """``seeded.numpy_state``'s rule for the case, but with weights of two
    or more axes drawn N(0, 2/fan_in) instead of U(+-1/sqrt(fan_in))."""
    from megaportraits_tpu_torch.utils import seeded

    rng = np.random.default_rng(case.weight_seed)
    out = {}
    for key, value in seeded.case_state(case).items():
        shape = value.shape
        if key.endswith("running_var"):
            a = rng.uniform(0.5, 1.5, shape)
        elif key.endswith("running_mean"):
            a = rng.uniform(-0.3, 0.3, shape)
        elif len(shape) == 1 and key.endswith("weight"):
            a = rng.uniform(0.8, 1.2, shape)
        elif len(shape) == 1:
            a = rng.normal(0.0, 0.1, shape)
        else:
            a = rng.normal(0.0, (2.0 / max(int(np.prod(shape[1:])), 1)) ** 0.5, shape)
        out[key] = a.astype(np.float32)
    return out


def probe(case, state):
    """Print the case's non-triviality, the port's gap to JAX and the
    port's one-ulp gain for weights `state`."""
    import torch

    from megaportraits_tpu_torch.core.dtypes import FP32_POLICY
    from megaportraits_tpu_torch.utils import seeded

    images = seeded.seeded_images(case.image_seed, case.images, case.size)
    want = jax_case(case, state_to_jax(state, jax_shapes(case, images)), images)["out"]
    model = seeded.build_model(case, FP32_POLICY, state=state)
    got = seeded.run_case(case, model, torch.from_numpy(images))["out"].numpy()
    ulp = np.spacing(images) * np.random.default_rng(0).choice([-1, 1], images.shape)
    moved = seeded.run_case(case, model, torch.from_numpy(
        (images + ulp).astype(np.float32)))["out"].numpy()
    inside = ((want > 0.01) & (want < 0.99)).mean()
    print(f"{case.name}: std {want.std():.5f}, share in (0.01, 0.99) {inside:.5f}, "
          f"port vs JAX max abs {np.abs(got - want).max():.3g}, one ulp of input "
          f"moves the port's output by {np.abs(moved - got).max():.3g}", flush=True)


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
    from megaportraits_tpu_torch.utils import seeded

    if "--probe" in sys.argv:
        for case in seeded.CASES.values():
            probe(case, he_state(case) if "--he" in sys.argv else seeded.case_state(case))
        return
    entries = {}
    for case in seeded.CASES.values():
        state, images, weights_sha, images_sha = port_draws(case)
        variables = state_to_jax(state, jax_shapes(case, images))
        del state
        outputs = jax_case(case, variables, images)
        entries.update(golden_entries(case, outputs, weights_sha, images_sha))
        print(f"{case.name}: out std {outputs['out'].std():.5f}", flush=True)
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    np.savez_compressed(GOLDEN, **entries)
    print(f"wrote {GOLDEN}: {os.path.getsize(GOLDEN)} bytes")


if __name__ == "__main__":
    main()
