"""The JAX side of the full-width training cases (``megaportraits_tpu_torch/
utils/seeded.TRAIN_CASES``), the port's self-gaps, and the command that
writes their golden.

``jax_train_case`` takes a case's steps in the JAX package on the CPU, from
the port's seeded draws carried into JAX's variable trees by
``torch_port_full_width.state_to_jax``. Each JAX state carries
``keep_gradients()``, an optax transformation that applies nothing and
keeps the gradients as its state, so the step hands its gradients out.
JAX's steps return no prediction and no frozen output: they are
recomputed from the same variables (Genh's first pass and its input, the
frozen Gbase's upscaled image; the Student's output and the teacher's
target), as the step computes them. ``port_train_case`` takes the same steps on the port; ``self_gaps``
takes them again with every weight of every network of the case, frozen
ones too, scaled by (1 + 1e-6 x N(0, 1)) (``seeded.perturb_weights``), four
times (two seeds, a factor an element or a channel): the largest gaps that
float32 rounding alone makes, from which the tolerances come
(``seeded.tolerance``).

Write the golden ``tests/data/torch_port_train_goldens.npz`` with

    python tests/torch_port_train_full_width.py

(about 12 minutes on 8 CPU cores, 18 GB). ``--jax <case> <out.npz>`` and
``--port <case> <out.npz> [--chain-kernel]`` take one case's step in one
package, as the tests do in a child process. Write the
golden only after a change in the JAX package or in seeded.py's draw rule,
and say why in CHANGES.md: the
golden is what the port's training steps are held against on the card
(``chip_smoke.py``'s ``phase_train_full_width``), and
tests/test_torch_port_train_full_width*.py hold the JAX package against it.
It keeps, per case and run: the metrics, ``seeded.samples`` of the
prediction and of the frozen network's output, every BatchNorm running statistic after the step, per gradient
leaf its norm and a strided sample of at most 256 values, the self-gaps
(on whole outcomes, which the CPU tests read, and on those samples, which
the card is held with), and the draws' sha256.
"""

from __future__ import annotations

import contextlib
import fcntl
import os
import subprocess
import sys
import tempfile

import numpy as np

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "torch_port_train_goldens.npz")
# Taken while a test runs a case: the cases of two xdist workers take turns.
LOCK = os.path.join(tempfile.gettempdir(), "megaportraits_torch_port_train_full_width.lock")
# The self-gap's perturbations: (seed, one factor a channel).
PERTURBATIONS = ((1234, False), (5678, False), (1234, True), (5678, True))


def _numpy(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


def jax_modules(case):
    """The case's JAX modules in float32, by the port's network names."""
    from megaportraits_tpu.core.arch import FULL
    from megaportraits_tpu.core.config import Config
    from megaportraits_tpu.core.dtypes import FP32_POLICY
    from megaportraits_tpu.losses.perceptual import PerceptualLoss
    from megaportraits_tpu.models.discriminator import Discriminator
    from megaportraits_tpu.models.genh import GHR, Genh
    from megaportraits_tpu.models.student import Student

    from megaportraits_tpu_torch.losses.perceptual import DEFAULT_WEIGHTS
    from megaportraits_tpu_torch.train.train_hr import HR_LOSS_WEIGHTS

    p = FP32_POLICY
    cfg = Config()
    if case.name == "train_base":
        return {"gbase": cfg.make_gbase(policy=p, remat="selective"),
                "disc": Discriminator(policy=p, arch=FULL),
                "ploss": PerceptualLoss(weights=DEFAULT_WEIGHTS, policy=p, arch=FULL)}
    if case.name == "train_hr":
        return {"gbase": cfg.make_gbase(policy=p), "genh": Genh(policy=p, arch=FULL),
                "ploss": PerceptualLoss(weights=HR_LOSS_WEIGHTS, policy=p, arch=FULL)}
    return {"teacher": GHR(policy=p, arch=FULL),
            "student": Student(case.num_avatars, policy=p, arch=FULL)}


def _init_args(case, name, batch):
    xs = batch["source"][:1]
    if name == "genh":
        return (batch["target_hr"][:1],)
    if name == "ploss":
        x = batch["target_hr"][:1] if case.name == "train_hr" else xs
        return x, x
    if name == "student":
        return xs, np.zeros((1,), np.int32)
    return xs, xs


def jax_variables(case, state, batch, modules):
    """Each network's JAX variable tree from the port's draws `state`."""
    import jax
    from flax.core import unfreeze

    from torch_port_full_width import state_to_jax

    out = {}
    for name, module in modules.items():
        shapes = unfreeze(jax.eval_shape(module.init, jax.random.PRNGKey(0),
                                         *_init_args(case, name, batch)))
        out[name] = state_to_jax(state[name], shapes)
    return out


def _outcome(metrics, pred, states, trained_keys, frozen=None):
    """A JAX run in ``seeded.run_train_case``'s form."""
    from megaportraits_tpu_torch.utils.jax_bridge import jax_to_state_dict

    out = {"metrics": {k: float(v) for k, v in metrics.items()},
           "pred": np.asarray(pred, np.float32), "stats": {}, "grads": {}}
    if frozen is not None:
        out["frozen"] = np.asarray(frozen, np.float32)
    for name, state in states.items():
        if state.batch_stats is not None:
            stats = jax_to_state_dict({"batch_stats": _numpy(state.batch_stats)})
            out["stats"].update({f"{name}/{k}": v.numpy() for k, v in stats.items()})
        grads = jax_to_state_dict({"params": _numpy(state.opt_state)})
        out["grads"][name] = {k: grads[k].numpy() for k in trained_keys[name]}
    return out


def jax_train_case(case, state, batch):
    """The case's runs in the JAX package in float32, from the port's draws
    `state` and the numpy `batch` (``seeded.train_batch``), in
    ``seeded.run_train_case``'s form."""
    import jax

    from megaportraits_tpu.core.config import Config
    from megaportraits_tpu.ops.resize import linear_resize
    from megaportraits_tpu.train import train_base, train_hr, train_student
    from megaportraits_tpu.train.state import TrainState

    from megaportraits_tpu_torch.core.dtypes import FP32_POLICY
    from megaportraits_tpu_torch.train.state import trainable_parameters
    from megaportraits_tpu_torch.utils import seeded

    from torch_port_utils import keep_gradients

    modules = jax_modules(case)
    variables = jax_variables(case, state, batch, modules)
    meta = seeded._train_networks(case, FP32_POLICY, "meta")
    trained_keys = {name: [k for k, _ in trainable_parameters(meta[name])]
                    for name in case.trained}
    cfg = Config()

    def fresh(name):
        v = variables[name]
        return TrainState.create(v["params"], v.get("batch_stats"), keep_gradients())

    if case.name == "train_base":
        step = train_base.make_train_step(modules["gbase"], modules["disc"],
                                          modules["ploss"], variables["ploss"], cfg,
                                          donate=False)
        g, d, metrics, xhat = step(fresh("gbase"), fresh("disc"), dict(batch))
        return {"step": _outcome(metrics, xhat, {"gbase": g, "disc": d}, trained_keys)}
    if case.name == "train_hr":
        genh, gbase = modules["genh"], modules["gbase"]
        step = train_hr.make_hr_train_step(genh, gbase, variables["gbase"],
                                           modules["ploss"], variables["ploss"], cfg,
                                           donate=False)
        new, metrics = step(fresh("genh"), dict(batch))

        @jax.jit
        def first_pass(g_vars, e_vars, xs, xd):
            base, _ = gbase.apply(g_vars, xs, xd)
            hr = [s * 2 for s in base.shape[1:3]]
            base = linear_resize(base, hr, axes=(1, 2), align_corners=False)
            return genh.apply(e_vars, base, True, mutable=["batch_stats"])[0], base

        pred, base = first_pass(variables["gbase"], variables["genh"], batch["source"],
                                batch["driving"])
        return {"step": _outcome(metrics, pred, {"genh": new}, trained_keys, base)}
    student = modules["student"]
    step = train_student.make_student_train_step(student, modules["teacher"],
                                                 variables["teacher"], cfg, donate=False)
    index = np.asarray(batch["avatar_index"], np.int32)
    pred = jax.jit(lambda v, xd, i: student.apply(v, xd, i, True, mutable=["batch_stats"])[0])(
        variables["student"], batch["driving"], index)
    target = jax.jit(lambda v, xs, xd: (modules["teacher"].apply(v, xs, xd).astype(np.float32)
                                        + 1.0) * 0.5)(
        variables["teacher"], batch["source"], batch["driving"])
    out = {}
    for run in case.runs:
        keys = (("source", "driving") if run == "inline" else ("driving", "target01"))
        b = {k: batch[k] for k in keys}
        b["avatar_index"] = index
        new, metrics = step(fresh("student"), b)
        out[run] = _outcome(metrics, pred, {"student": new}, trained_keys,
                            target if run == "inline" else None)
    return out


@contextlib.contextmanager
def one_case_at_a_time(lock=LOCK):
    """Hold `lock` while the block runs. A case's JAX step takes up to 14
    GB and its port step up to 11 GB on the CPU: two test files running
    their cases at once on two workers would need both."""
    with open(lock, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _flat(outcomes):
    """``run_train_case``'s outcomes as one mapping of arrays, '|'-joined
    names (BatchNorm keys hold '/')."""
    out = {}
    for run, o in outcomes.items():
        out.update({f"{run}|metric|{k}": np.float64(v) for k, v in o["metrics"].items()})
        out.update({f"{run}|{k}": o[k] for k in ("pred", "frozen") if k in o})
        out.update({f"{run}|stats|{k}": v for k, v in o["stats"].items()})
        for net, grads in o["grads"].items():
            out.update({f"{run}|grad|{net}|{k}": v for k, v in grads.items()})
    return out


def _nested(flat):
    """The inverse of ``_flat``."""
    outcomes = {}
    for key, value in flat.items():
        run, kind, *rest = key.split("|")
        o = outcomes.setdefault(run, {"metrics": {}, "stats": {}, "grads": {}})
        if kind == "metric":
            o["metrics"][rest[0]] = float(value)
        elif kind in ("pred", "frozen"):
            o[kind] = value
        elif kind == "stats":
            o["stats"][rest[0]] = value
        else:
            o["grads"].setdefault(rest[0], {})[rest[1]] = value
    return outcomes


def _apart(*args):
    """This file's ``main`` with `args` in a child process, whose memory
    goes back to the system when it exits; returns what it saved. The
    child takes every core, not a test worker's share: it runs alone under
    ``LOCK`` on the tier-1 run's longest path, and a JAX step's pool takes
    every core anyway."""
    env = dict(os.environ, OMP_NUM_THREADS=str(os.cpu_count()))
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "outcomes.npz")
        subprocess.run([sys.executable, os.path.abspath(__file__), *args[:2], out, *args[2:]],
                       env=env, check=True, timeout=600)
        with np.load(out) as z:
            return {k: z[k] for k in z.files}


def jax_train_case_apart(case):
    """``jax_train_case`` of the case's own draws in a child process."""
    return _nested(_apart("--jax", case.name))


def port_train_case_apart(case, chain_kernel=False):
    """``port_train_case`` of the case's own draws in a child process, and
    how many times K2's wrapper was called there (its own counter counts
    only launches on the card)."""
    flat = _apart("--port", case.name, *(["--chain-kernel"] if chain_kernel else []))
    return _nested({k: v for k, v in flat.items() if k != "k2_calls"}), int(flat["k2_calls"])


def port_train_case(case, state, batch, perturb=None, chain_kernel=False):
    """The case's runs on the port on the CPU in float32 from the draws
    `state` (every weight perturbed by ``seeded.perturb_weights`` with
    `perturb`, a (seed, per_channel) pair, if given; the frozen Gbase's
    trunk through K2's wrapper with `chain_kernel`)."""
    import torch

    from megaportraits_tpu_torch.core.dtypes import FP32_POLICY
    from megaportraits_tpu_torch.utils import seeded

    nets = seeded.build_train_case(case, FP32_POLICY, "cpu", state, chain_kernel)
    if perturb is not None:
        seeded.perturb_weights(nets, *perturb)
    tensors = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
    threads = torch.get_num_threads()
    if case.name == "train_student":
        # PyTorch's multi-threaded CPU backward of the Student's strided 1x1
        # convolutions corrupts the heap (test_torch_port_train_stages.py,
        # one_cpu_thread): the Student steps on one thread.
        torch.set_num_threads(1)
    try:
        return seeded.run_train_case(case, nets, tensors)
    finally:
        torch.set_num_threads(threads)


def self_gaps(case, state, batch, chain_kernel=False):
    """Per run, the port's self-gaps: for each of ``PERTURBATIONS`` the gaps
    of the step with every weight perturbed to the step on the drawn
    weights, and per quantity the largest: {'whole': on the whole outcomes,
    'samples': on the golden's samples of them}. One perturbation gives a
    noisy gap a leaf: the stage-3 Student's avatar embedding in
    ``dec2.norm_1`` moved 0.0042 to 0.017 under the four, and the card's
    step is 0.017 from JAX's there."""
    from megaportraits_tpu_torch.utils import seeded

    def forms(a, b):
        return {"whole": seeded.train_gaps(seeded.comparable(a), seeded.comparable(b)),
                "samples": seeded.train_gaps(seeded.comparable(seeded.train_samples(a)),
                                             seeded.comparable(seeded.train_samples(b)))}

    drawn = port_train_case(case, state, batch, chain_kernel=chain_kernel)
    out = {run: {"whole": {}, "samples": {}} for run in case.runs}
    for perturb in PERTURBATIONS:
        moved = port_train_case(case, state, batch, perturb, chain_kernel)
        for run in case.runs:
            for form, gaps in forms(moved[run], drawn[run]).items():
                kept = out[run][form]
                for k, v in gaps.items():
                    kept[k] = max(kept.get(k, 0.0), v)
        del moved
    return out


def draws(case):
    """The case's seeded port weights and batch, and their checksums."""
    from megaportraits_tpu_torch.utils import seeded

    state = seeded.train_case_state(case)
    batch = seeded.train_batch(case)
    return state, batch, seeded.checksum(seeded.flat_state(state)), seeded.checksum(batch)


def golden_entries(case, outcomes, gaps, weights_sha, batch_sha):
    """The golden's arrays of one case, under '<case>/<run>/<name>'."""
    from megaportraits_tpu_torch.utils import seeded

    out = {}
    for run in case.runs:
        prefix = f"{case.name}/{run}/"
        out.update({prefix + k: v for k, v in seeded.train_samples(outcomes[run]).items()})
        for form, values in gaps[run].items():
            names = sorted(values)
            out[prefix + f"self_gap_names/{form}"] = np.array(names)
            out[prefix + f"self_gaps/{form}"] = np.array([values[k] for k in names],
                                                         np.float64)
    out[f"{case.name}/seeds"] = np.array([case.weight_seed, case.image_seed], np.int64)
    out[f"{case.name}/weights_sha256"] = np.array(weights_sha)
    out[f"{case.name}/batch_sha256"] = np.array(batch_sha)
    return out


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [here, os.path.join(here, "..")]
    from megaportraits_tpu_torch.utils import seeded

    if sys.argv[1] in ("--jax", "--port"):
        case = seeded.TRAIN_CASES[sys.argv[2]]
        state, batch, _, _ = draws(case)
        if sys.argv[1] == "--jax":
            return np.savez(sys.argv[3], **_flat(jax_train_case(case, state, batch)))
        from megaportraits_tpu_torch.ops.kernels import resblock_chain as k2

        calls, wrapped = [], k2.resblock_chain
        k2.resblock_chain = lambda *a: calls.append(1) or wrapped(*a)
        outcomes = port_train_case(case, state, batch,
                                   chain_kernel="--chain-kernel" in sys.argv)
        return np.savez(sys.argv[3], k2_calls=np.int64(len(calls)), **_flat(outcomes))
    entries = {}
    for case in seeded.TRAIN_CASES.values():
        state, batch, weights_sha, batch_sha = draws(case)
        outcomes = jax_train_case(case, state, batch)
        gaps = self_gaps(case, state, batch, chain_kernel=case.name != "train_base")
        entries.update(golden_entries(case, outcomes, gaps, weights_sha, batch_sha))
        print(f"{case.name}: {sorted(outcomes[case.runs[0]]['metrics'].items())}", flush=True)
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    np.savez_compressed(GOLDEN, **entries)
    print(f"wrote {GOLDEN}: {os.path.getsize(GOLDEN)} bytes")


if __name__ == "__main__":
    main()
