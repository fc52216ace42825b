"""Is the stage-1 step's gap to the JAX package rounding? A probe, not a test.

The draws are those of test_torch_port_train_base.py at FULL width:
``numpy_fill`` over JAX's trees (G, D and the perceptual loss),
``randomize_batch_stats`` for G's statistics, white-noise images, batch 2.

    python tests/torch_port_train_probe.py precision [--size 128]

takes the step in both packages in float32 and in float64 and prints the
gaps of xhat, the metrics and D's and G's gradients. Each side runs in its
own process: float64 needs ``jax_enable_x64`` and a float64 policy, and
both packages name float32 in places (``.float()``, ``jnp.float32``,
float32 numpy constants), which the float64 process redirects to float64
(nothing in either package changes). JAX keeps a few float32 constants
under x64 (the ImageNet statistics, its warp grids), so float64's gaps stop
near 1e-7, not at 1e-12. The JAX float64 step takes about 15 minutes at
128 on 8 CPU cores.

    python tests/torch_port_train_probe.py map [--size 256]

takes the float32 step on the port, on the port with every trainable G
weight scaled by (1 + 1e-6 x N(0, 1)), and in JAX, then holds D's gradient
on each xhat against the others and maps xhat's gaps by sample, channel,
row and column.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
IMAGES = ("source", "driving", "source_next", "source_star", "driving_star")
BATCH = 2


def draws(size):
    """The probe's variables (G, D, the loss) and batch, numpy float32."""
    import jax

    from megaportraits_tpu.core.config import Config
    from megaportraits_tpu.core.dtypes import FP32_POLICY
    from megaportraits_tpu.train import train_base

    from torch_port_utils import numpy_fill, randomize_batch_stats

    *_, p_vars, g_state, d_state = train_base.init_states(
        Config(), jax.random.PRNGKey(0), policy=FP32_POLICY, image_size=size, fast_init=True)
    g_vars = randomize_batch_stats({"params": numpy_fill(g_state.params, 1),
                                    "batch_stats": numpy_fill(g_state.batch_stats)}, seed=2)
    rng = np.random.default_rng(0)
    batch = {k: rng.random((BATCH, size, size, 3)).astype(np.float32) for k in IMAGES}
    return g_vars, {"params": numpy_fill(d_state.params, 3)}, numpy_fill(p_vars, 4), batch


def run_side(side, bits, size, out, perturb=False):
    """One step on `side` ('jax' or 'port') in float`bits`; xhat, the
    metrics ('m/') and D's and G's gradients ('d/', 'g/') into `out`."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    jax.config.update("jax_enable_x64", bits == 64)
    g_vars, d_vars, p_vars, batch = draws(size)
    if bits == 64:
        g_vars, d_vars, p_vars, batch = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64), (g_vars, d_vars, p_vars, batch))
    result = (jax_step if side == "jax" else port_step)(bits, g_vars, d_vars, p_vars, batch,
                                                        perturb)
    np.savez(out, **result)


def jax_step(bits, g_vars, d_vars, p_vars, batch, perturb):
    import jax
    import jax.numpy as jnp

    from megaportraits_tpu.core.arch import FULL
    from megaportraits_tpu.core.config import Config
    from megaportraits_tpu.core.dtypes import FP32_POLICY, Policy
    from megaportraits_tpu.losses.perceptual import PerceptualLoss
    from megaportraits_tpu.models.discriminator import Discriminator
    from megaportraits_tpu.ops import resize
    from megaportraits_tpu.train import train_base
    from megaportraits_tpu.train.state import TrainState

    from megaportraits_tpu_torch.losses.perceptual import DEFAULT_WEIGHTS
    from megaportraits_tpu_torch.utils.jax_bridge import jax_to_state_dict

    from torch_port_utils import keep_gradients

    policy = FP32_POLICY
    if bits == 64:
        jnp.float32 = jnp.float64
        kernel = resize.gaussian_kernel_2d
        resize.gaussian_kernel_2d = lambda s: (lambda k, a, b: (k.astype(np.float64), a, b))(
            *kernel(s))
        policy = Policy(param_dtype=jnp.float64, compute_dtype=jnp.float64,
                        norm_dtype=jnp.float64)
    cfg = Config()
    step = train_base.make_train_step(
        cfg.make_gbase(policy=policy, remat="selective"), Discriminator(policy=policy, arch=FULL),
        PerceptualLoss(weights=DEFAULT_WEIGHTS, policy=policy, arch=FULL), p_vars, cfg,
        donate=False)
    g, d, metrics, xhat = step(
        TrainState.create(g_vars["params"], g_vars["batch_stats"], keep_gradients()),
        TrainState.create(d_vars["params"], None, keep_gradients()), batch)
    out = {"xhat": np.asarray(xhat)}
    out.update({"m/" + k: np.asarray(v) for k, v in metrics.items()})
    for prefix, state in (("g/", g), ("d/", d)):
        grads = jax_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, state.opt_state)})
        out.update({prefix + k: v.numpy() for k, v in grads.items()})
    return out


def port_step(bits, g_vars, d_vars, p_vars, batch, perturb):
    import torch

    from megaportraits_tpu_torch.core.config import Config
    from megaportraits_tpu_torch.core.dtypes import FP32_POLICY, Policy
    from megaportraits_tpu_torch.train.state import trainable_parameters
    from megaportraits_tpu_torch.train.train_base import init_states, make_train_step
    from megaportraits_tpu_torch.utils.jax_bridge import load_jax_variables

    policy = FP32_POLICY
    if bits == 64:
        as_tensor, from_numpy = torch.as_tensor, torch.from_numpy

        def up(a):
            return a.astype(np.float64) if getattr(a, "dtype", None) == np.float32 else a

        torch.set_default_dtype(torch.float64)
        torch.Tensor.float = lambda self, *a, **k: self.to(torch.float64)
        torch.float32 = torch.float64
        torch.as_tensor = lambda a, *args, **kw: as_tensor(up(a), *args, **kw)
        torch.from_numpy = lambda a: from_numpy(up(a))
        policy = Policy(param_dtype=torch.float64, compute_dtype=torch.float64,
                        norm_dtype=torch.float64)
    cfg = Config()
    gbase, disc, ploss, g_state, d_state = init_states(cfg, policy=policy, device="cpu")
    for module, variables in ((gbase, g_vars), (disc, d_vars), (ploss, p_vars)):
        load_jax_variables(module, variables)
    if perturb:
        rng = np.random.default_rng(1234)
        with torch.no_grad():
            for _, p in trainable_parameters(gbase):
                noise = rng.standard_normal(tuple(p.shape)).astype(np.float32)
                p.mul_(1.0 + 1e-6 * torch.from_numpy(noise))
    tensors = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    _, _, metrics, xhat = make_train_step(ploss, cfg)(g_state, d_state, tensors)
    out = {"xhat": xhat.detach().numpy()}
    out.update({"m/" + k: v.numpy() for k, v in metrics.items()})
    for prefix, module in (("g/", gbase), ("d/", disc)):
        out.update({prefix + k: p.grad.numpy() for k, p in trainable_parameters(module)})
    return out


def side_process(side, bits, size, out, perturb=False):
    argv = [sys.executable, os.path.abspath(__file__), "_side", side, str(bits), str(size), out]
    subprocess.run(argv + (["--perturb"] if perturb else []), check=True)
    return dict(np.load(out))


def grad_gap(a, b, prefix):
    """(over all leaves, worst leaf, its name): relative Frobenius gaps of
    `a` against `b`, over the leaves above 1e-6 of the largest norm."""
    keys = [k for k in b if k.startswith(prefix)]
    norms = {k: np.linalg.norm(b[k].astype(np.float64)) for k in keys}
    keys = [k for k in keys if norms[k] > 1e-6 * max(norms.values())]
    d2 = {k: np.sum((a[k].astype(np.float64) - b[k]) ** 2) for k in keys}
    worst = max(keys, key=lambda k: d2[k] ** 0.5 / norms[k])
    total = (sum(d2.values()) / sum(norms[k] ** 2 for k in keys)) ** 0.5
    return total, d2[worst] ** 0.5 / norms[worst], worst


def precision(size, tmp):
    for bits in (32, 64):
        port = side_process("port", bits, size, os.path.join(tmp, f"port{bits}.npz"))
        want = side_process("jax", bits, size, os.path.join(tmp, f"jax{bits}.npz"))
        diff = np.abs(port["xhat"] - want["xhat"].astype(np.float64))
        metrics = max(abs(float(port[k]) - float(want[k])) / max(abs(float(want[k])), 1e-12)
                      for k in want if k.startswith("m/"))
        print(f"float{bits}, {size}: xhat max {diff.max():.3g} mean {diff.mean():.3g}; metrics "
              f"{metrics:.3g}; D's gradient {grad_gap(port, want, 'd/')[0]:.3g} overall, "
              f"{grad_gap(port, want, 'd/')[1]:.3g} worst leaf; G's "
              f"{grad_gap(port, want, 'g/')[0]:.3g} overall", flush=True)


def gap_map(size, tmp):
    import torch

    from megaportraits_tpu_torch.core.arch import FULL
    from megaportraits_tpu_torch.core.dtypes import FP32_POLICY
    from megaportraits_tpu_torch.losses.gan import discriminator_loss
    from megaportraits_tpu_torch.models.discriminator import Discriminator
    from megaportraits_tpu_torch.utils.jax_bridge import load_jax_variables

    port = side_process("port", 32, size, os.path.join(tmp, "port.npz"))["xhat"]
    moved = side_process("port", 32, size, os.path.join(tmp, "moved.npz"), True)["xhat"]
    want = side_process("jax", 32, size, os.path.join(tmp, "jax.npz"))["xhat"]
    _, d_vars, _, batch = draws(size)
    disc = load_jax_variables(Discriminator(policy=FP32_POLICY, arch=FULL, device="cpu"), d_vars)
    xs, xd = (torch.from_numpy(batch[k]) for k in ("source", "driving"))

    def d_grad(x):
        loss = discriminator_loss(disc(xd, xs), disc(torch.from_numpy(
            np.asarray(x, np.float32)), xs), "lsgan")
        grads = torch.autograd.grad(loss, list(disc.parameters()))
        return {f"d/{i}": g.numpy() for i, g in enumerate(grads)}

    ref = {k: v.astype(np.float64) for k, v in d_grad(want).items()}
    mine = d_grad(port)
    print(f"D's gradient on the port's xhat against JAX's: {grad_gap(mine, ref, 'd/')[0]:.3g}; "
          f"on the perturbed port's against the port's: "
          f"{grad_gap(d_grad(moved), {k: v.astype(np.float64) for k, v in mine.items()}, 'd/')[0]:.3g}")
    rng = np.random.default_rng(0)
    d = port.astype(np.float64) - want
    for name, x in (("with random signs", want + d * rng.choice([-1, 1], d.shape)),
                    ("only its mean a sample and channel", want + d.mean(axis=(1, 2), keepdims=True))):
        print(f"  the port-JAX gap of xhat {name}: D's gradient {grad_gap(d_grad(x), ref, 'd/')[0]:.3g}")
    for label, gap in (("port - JAX", d), ("perturbed port - port", moved - port.astype(np.float64))):
        blocks = gap.reshape(BATCH, size // 16, 16, size // 16, 16, 3).mean(axis=(2, 4))
        low = np.repeat(np.repeat(blocks, 16, 1), 16, 2)
        print(f"{label}: mean abs {np.abs(gap).mean():.3g}, a sample "
              f"{np.abs(gap).mean(axis=(1, 2, 3)).round(8).tolist()}, a channel "
              f"{np.abs(gap).mean(axis=(0, 1, 2)).round(8).tolist()}, the first/middle/last row "
              f"{np.abs(gap).mean(axis=(0, 2, 3))[[0, size // 2, -1]].round(8).tolist()}, "
              f"energy in 16x16 block means {(low ** 2).sum() / (gap ** 2).sum():.3f}")


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path[:0] = [HERE, os.path.join(HERE, "..")]
    if sys.argv[1] == "_side":
        side, bits, size, out = sys.argv[2:6]
        return run_side(side, int(bits), int(size), out, "--perturb" in sys.argv)
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("mode", choices=["precision", "map"])
    parser.add_argument("--size", type=int, default=None)
    args = parser.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        if args.mode == "precision":
            precision(args.size or 128, tmp)
        else:
            gap_map(args.size or 256, tmp)


if __name__ == "__main__":
    main()
