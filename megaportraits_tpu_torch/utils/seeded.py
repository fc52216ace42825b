"""Seeded weights, images and the full-width cases that hold the port
against the JAX package.

The FULL models are too large to ship (Gbase has 189.7M parameters), so
both sides rebuild the same ones from a seed with numpy:

  * ``numpy_state(module, seed)`` draws every tensor of a module's
    ``state_dict``, in key order, from one ``numpy.random.default_rng(seed)``
    as a pretrained checkpoint holds them: weights of two or more axes
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (torch's default bound, which
    ``nn.layers.init_parameters`` draws too), 1-D weights U(0.8, 1.2),
    biases N(0, 0.1), BatchNorm running means U(-0.3, 0.3) and running
    variances U(0.5, 1.5). Weights of N(0, 2/fan_in) saturate GHR's tanh
    and leave the Student so ill-conditioned that a change of one ulp in
    its input moves its output by 1e-2, more than any two float32
    implementations can be held to;
  * ``seeded_images(seed, n, size)`` makes smooth uint8 images (a 12x12
    grid of random colours, bilinearly interpolated with elementwise numpy
    arithmetic only, so every platform rounds alike), scaled to [0, 1].

``CASES`` are the three full-width cases: the main path (Gbase's
``encode_source`` of one source, then ``drive`` of 2 driving frames, at
512), stage-2 serving (GHR: Gbase at 256, bilinear x2 to 512, Genh at 512,
(tanh + 1) / 2) and stage-3 serving (the Student with 3 avatars at 512,
batch 2, avatars 2 and 0). Every width is the FULL arch's; (b) and (c) cut
the served 1024 to 256 -> 512 and 512 so that the JAX package runs them on
a CPU in a test's time. ``run_case`` runs a case on the port;
``samples`` keeps what ``tests/data/torch_port_goldens.npz`` stores of an
output (a stride-8 subsample, the central 64x64 crop, the per-channel mean
and std), which ``tests/torch_port_full_width.py`` writes from the JAX
package and ``chip_smoke.py`` holds the card's outputs against.

``TRAIN_CASES`` are three full-width training steps (stage 1, 2 and 3),
each at 256 (Genh's target at 512), batch 2, on networks drawn with
``numpy_state``. ``run_train_case`` takes a case's step on the port and
returns its metrics, prediction, BatchNorm statistics and gradients;
``train_samples`` keeps what ``tests/data/torch_port_train_goldens.npz``
stores of them, ``train_gaps`` measures two runs' gaps and ``tolerance``
gives each gap's limit from the golden's self-gaps (how far the port's
own step moves when every weight moves by a relative 1e-6).
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

GRID = 12          # seeded_images' coarse grid
SUBSAMPLE = 8      # stride of the stored subsample
CROP = 64          # side of the stored central crop


def numpy_state(module: nn.Module, seed: int) -> Dict[str, np.ndarray]:
    """float32 numpy draws for every tensor of `module`'s state_dict, in
    key order, from ``default_rng(seed)`` (the rule in the docstring)."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, value in module.state_dict().items():
        shape = tuple(value.shape)
        if key.endswith("running_var"):
            a = rng.uniform(0.5, 1.5, shape)
        elif key.endswith("running_mean"):
            a = rng.uniform(-0.3, 0.3, shape)
        elif len(shape) == 1 and key.endswith("weight"):
            a = rng.uniform(0.8, 1.2, shape)
        elif len(shape) == 1:
            a = rng.normal(0.0, 0.1, shape)
        else:
            bound = 1.0 / np.sqrt(max(int(np.prod(shape[1:])), 1))
            a = rng.uniform(-bound, bound, shape)
        out[key] = a.astype(np.float32)
    return out


def _interpolate(coarse: np.ndarray, size: int, axis: int) -> np.ndarray:
    """Linear interpolation of `coarse` along `axis` to `size` samples,
    corners aligned, in float64 elementwise arithmetic."""
    n = coarse.shape[axis]
    pos = np.arange(size, dtype=np.float64) * (n - 1) / (size - 1)
    lo = np.minimum(np.floor(pos).astype(np.int64), n - 2)
    frac = pos - lo
    shape = [1] * coarse.ndim
    shape[axis] = size
    frac = frac.reshape(shape)
    a = np.take(coarse, lo, axis=axis)
    b = np.take(coarse, lo + 1, axis=axis)
    return a * (1.0 - frac) + b * frac


def seeded_images(seed: int, n: int, size: int) -> np.ndarray:
    """`n` smooth RGB images [n, size, size, 3], float32 in [0, 1]: uint8
    values from a seeded 12x12 colour grid, divided by 255."""
    rng = np.random.default_rng(seed)
    coarse = rng.integers(0, 256, (n, GRID, GRID, 3)).astype(np.float64)
    img = _interpolate(_interpolate(coarse, size, 1), size, 2)
    u8 = np.clip(np.rint(img), 0, 255).astype(np.uint8)
    return u8.astype(np.float32) / np.float32(255.0)


def checksum(arrays: Mapping[str, np.ndarray]) -> str:
    """sha256 over the names, shapes and bytes of `arrays`, in order."""
    h = hashlib.sha256()
    for key, a in arrays.items():
        a = np.ascontiguousarray(a)
        h.update(f"{key}:{a.dtype.str}:{a.shape};".encode())
        h.update(memoryview(a).cast("B"))
    return h.hexdigest()


@dataclasses.dataclass(frozen=True)
class Case:
    """One full-width case: the model, the seeds of its weights and inputs,
    the size its inputs are drawn at and how many."""

    name: str
    weight_seed: int
    image_seed: int
    size: int
    images: int
    avatar_index: Optional[Tuple[int, ...]] = None
    num_avatars: int = 3
    hr_size: Optional[int] = None


CASES = {
    # (a) the main path: one source and 2 driving frames, batch 1 each.
    "gbase": Case("gbase", weight_seed=0, image_seed=1, size=512, images=3),
    # (b) stage-2 serving, cut from the served 512 -> 1024 to 256 -> 512.
    "ghr": Case("ghr", weight_seed=2, image_seed=3, size=256, images=2, hr_size=512),
    # (c) stage-3 serving, cut from the served 1024 to 512; batch 2.
    "student": Case("student", weight_seed=4, image_seed=5, size=512, images=2,
                    avatar_index=(2, 0)),
}


def _model(case: Case, policy, device) -> nn.Module:
    from megaportraits_tpu_torch.core.arch import FULL
    from megaportraits_tpu_torch.models.gbase import Gbase
    from megaportraits_tpu_torch.models.genh import GHR
    from megaportraits_tpu_torch.models.student import Student

    if case.name == "gbase":
        return Gbase(policy=policy, arch=FULL, device=device)
    if case.name == "ghr":
        return GHR(policy=policy, arch=FULL, device=device)
    return Student(case.num_avatars, policy=policy, arch=FULL, device=device)


def case_state(case: Case) -> Dict[str, np.ndarray]:
    """``numpy_state`` of the case's FULL model with the case's seed."""
    from megaportraits_tpu_torch.core.dtypes import FP32_POLICY

    return numpy_state(_model(case, FP32_POLICY, "meta"), case.weight_seed)


def build_model(case: Case, policy, device="cpu",
                state: Optional[Mapping[str, np.ndarray]] = None) -> nn.Module:
    """The case's FULL model with `policy` on `device`, in eval mode, its
    weights `state` (by default ``case_state(case)``)."""
    model = _model(case, policy, "cpu")
    state = case_state(case) if state is None else state
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return model.to(device).eval()


def run_case(case: Case, model: nn.Module, images: torch.Tensor
             ) -> Dict[str, torch.Tensor]:
    """The case on the port, without autograd: {'out': [N, H, W, 3] float32
    in [0, 1]} and, for Gbase, the source state's 'vc2d' and 'es'.
    `images` are ``seeded_images`` of the case on the model's device."""
    from megaportraits_tpu_torch.ops.resize import linear_resize

    with torch.no_grad():
        if case.name == "gbase":
            state = model.encode_source(images[:1])
            out = torch.cat([model.drive(state, images[i:i + 1])
                             for i in range(1, case.images)])
            return {"out": out.float(), "vc2d": state["vc2d"].float(),
                    "es": state["es"].float()}
        if case.name == "ghr":
            xhat = model.gbase.generate(images[:1], images[1:2])
            up = linear_resize(xhat, (case.hr_size, case.hr_size), axes=(1, 2),
                               align_corners=False)
            return {"out": (model.genh(up).float() + 1.0) * 0.5}
        index = torch.tensor(case.avatar_index, device=images.device)
        return {"out": model(images, index).float()}


def samples(out: np.ndarray) -> Dict[str, np.ndarray]:
    """What the golden keeps of an output [N, H, W, C]: 'sub' (every 8th
    row and column), 'crop' (the central 64x64), 'mean' and 'std' per
    channel, all float32."""
    out = np.asarray(out, np.float32)
    h, w = out.shape[1:3]
    top, left = (h - CROP) // 2, (w - CROP) // 2
    return {"sub": out[:, ::SUBSAMPLE, ::SUBSAMPLE],
            "crop": out[:, top:top + CROP, left:left + CROP],
            "mean": out.mean(axis=(0, 1, 2), dtype=np.float64).astype(np.float32),
            "std": out.std(axis=(0, 1, 2), dtype=np.float64).astype(np.float32)}


def summary(x: np.ndarray) -> np.ndarray:
    """[max, mean, std] of an intermediate tensor, float32."""
    x = np.asarray(x, np.float64)
    return np.array([x.max(), x.mean(), x.std()], np.float32)


# ---------------------------------------------------------------------------
# The full-width training cases
# ---------------------------------------------------------------------------

TRAIN_IMAGES = ("source", "driving", "source_next", "source_star", "driving_star")
GRAD_SAMPLES = 256  # most values of a gradient leaf the golden keeps
GRAD_FLOOR = 1e-6   # leaves whose norm is at most this share of the largest are skipped


@dataclasses.dataclass(frozen=True)
class TrainCase:
    """One full-width training case: one step of a stage's trainer on its
    FULL networks, batch `batch` at `size` (Genh's target at `hr_size`)."""

    name: str
    weight_seed: int
    image_seed: int
    size: int = 256
    batch: int = 2
    hr_size: Optional[int] = None
    avatar_index: Optional[Tuple[int, ...]] = None
    num_avatars: int = 3

    @property
    def runs(self) -> Tuple[str, ...]:
        """The steps of the case: the Student's takes one with the teacher
        inline and one with 'target01' given, each from the drawn weights."""
        return ("inline", "target01") if self.name == "train_student" else ("step",)

    @property
    def trained(self) -> Tuple[str, ...]:
        """The networks whose gradients the step takes."""
        return {"train_base": ("gbase", "disc"), "train_hr": ("genh",),
                "train_student": ("student",)}[self.name]


# Every width is the FULL arch's. The configs train at 512 (stage 1 and 3)
# and 512 -> 1024 (stage 2), batch 4 (stage1-base.yaml); these cases cut
# that to 256 (256 -> 512) and batch 2 so that the JAX package takes the
# three steps on a CPU in a test's time. Batch 2 keeps what couples the
# samples: train-mode BatchNorm over the batch, the cycle loss's negatives.
TRAIN_CASES = {
    # (d) stage 1: make_train_step on Gbase, the Discriminator and the
    # perceptual loss (VGG19 + LPIPS), Config() loss weights, lsgan.
    "train_base": TrainCase("train_base", weight_seed=6, image_seed=7),
    # (e) stage 2: make_hr_train_step, Genh trains behind a frozen Gbase on
    # running statistics.
    "train_hr": TrainCase("train_hr", weight_seed=9, image_seed=10, hr_size=512),
    # (f) stage 3: make_student_train_step, the GHR teacher inline, then
    # with 'target01' given; 3 avatars, indices [2, 0].
    "train_student": TrainCase("train_student", weight_seed=12, image_seed=13,
                               avatar_index=(2, 0)),
}


def _train_networks(case: TrainCase, policy, device) -> Dict[str, nn.Module]:
    from megaportraits_tpu_torch.core.arch import FULL
    from megaportraits_tpu_torch.losses.perceptual import DEFAULT_WEIGHTS, PerceptualLoss
    from megaportraits_tpu_torch.models.discriminator import Discriminator
    from megaportraits_tpu_torch.models.gbase import Gbase
    from megaportraits_tpu_torch.models.genh import GHR, Genh
    from megaportraits_tpu_torch.models.student import Student
    from megaportraits_tpu_torch.train.train_hr import HR_LOSS_WEIGHTS

    kw = dict(policy=policy, arch=FULL, device=device)
    if case.name == "train_base":
        # init_states' remat default at 256, as JAX's.
        return {"gbase": Gbase(remat="selective", **kw), "disc": Discriminator(**kw),
                "ploss": PerceptualLoss(DEFAULT_WEIGHTS, **kw)}
    if case.name == "train_hr":
        return {"gbase": Gbase(**kw), "genh": Genh(**kw),
                "ploss": PerceptualLoss(HR_LOSS_WEIGHTS, **kw)}
    return {"teacher": GHR(**kw), "student": Student(case.num_avatars, **kw)}


def train_case_state(case: TrainCase) -> Dict[str, Dict[str, np.ndarray]]:
    """``numpy_state`` of each of the case's FULL networks, the i-th (in
    ``_train_networks``' order) drawn from seed ``weight_seed + i``."""
    from megaportraits_tpu_torch.core.dtypes import FP32_POLICY

    nets = _train_networks(case, FP32_POLICY, "meta")
    return {name: numpy_state(net, case.weight_seed + i)
            for i, (name, net) in enumerate(nets.items())}


def flat_state(state: Mapping[str, Mapping[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """A case's draws as one mapping, '<network>/<key>'."""
    return {f"{net}/{k}": v for net, sd in state.items() for k, v in sd.items()}


def train_batch(case: TrainCase) -> Dict[str, np.ndarray]:
    """The case's batch as numpy: ``seeded_images`` from ``image_seed`` (and
    ``image_seed + 1`` for Genh's 'target_hr' and the Student's
    'target01'), the Student's 'avatar_index' as int64."""
    b, s = case.batch, case.size
    if case.name == "train_base":
        images = seeded_images(case.image_seed, len(TRAIN_IMAGES) * b, s)
        return {k: images[i * b:(i + 1) * b] for i, k in enumerate(TRAIN_IMAGES)}
    images = seeded_images(case.image_seed, 2 * b, s)
    batch = {"source": images[:b], "driving": images[b:]}
    if case.name == "train_hr":
        batch["target_hr"] = seeded_images(case.image_seed + 1, b, case.hr_size)
    else:
        batch["target01"] = seeded_images(case.image_seed + 1, b, s)
        batch["avatar_index"] = np.asarray(case.avatar_index, np.int64)
    return batch


def build_train_case(case: TrainCase, policy, device="cpu",
                     state: Optional[Mapping[str, Mapping[str, np.ndarray]]] = None
                     ) -> Dict[str, nn.Module]:
    """The case's FULL networks with `policy` on `device`, their weights
    `state` (by default ``train_case_state(case)``): the loss nets frozen,
    the frozen Gbase (stage 2, and the teacher's in stage 3) in eval mode."""
    nets = _train_networks(case, policy, "cpu")
    state = train_case_state(case) if state is None else state
    for name, net in nets.items():
        net.load_state_dict({k: torch.from_numpy(v) for k, v in state[name].items()})
        net.to(device)
    if "ploss" in nets:
        nets["ploss"].requires_grad_(False).eval()
    frozen = {"train_hr": "gbase", "train_student": "teacher"}.get(case.name)
    if frozen:
        nets[frozen].eval()
    return nets


def perturb_weights(nets: Mapping[str, nn.Module], seed: int = 0,
                    per_channel: bool = False) -> None:
    """Scale every weight of every network of a case, frozen ones too, by
    (1 + 1e-6 x N(0, 1)), drawn with numpy from `seed` in
    ``_train_networks``' order and parameter order, one factor an element
    or, with `per_channel`, one a slice of the leading (output) axis: how
    far float32 rounding alone moves each quantity of a step (its
    self-gap). The frozen networks count: another platform rounds the
    teacher's target and the frozen Gbase's image apart too; so do
    per-channel factors, which round alike over a whole channel (a
    BatchNorm's rsqrt, a folded scale)."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for net in nets.values():
            for p in net.parameters():
                shape = ((p.shape[0],) + (1,) * (p.ndim - 1) if per_channel and p.ndim
                         else tuple(p.shape))
                noise = rng.standard_normal(shape).astype(np.float32)
                p.mul_(1.0 + 1e-6 * torch.from_numpy(noise).to(p.device, p.dtype))


def _first_call(module: nn.Module, output: bool = True):
    """A forward hook that keeps what `module`'s first call returned (or,
    with ``output=False``, its first argument); returns (list, handle)."""
    kept = []

    def keep(x):
        if not kept:
            kept.append(x.detach())

    if output:
        return kept, module.register_forward_hook(lambda _, __, out: keep(out))
    return kept, module.register_forward_pre_hook(lambda _, args: keep(args[0]))


def run_train_case(case: TrainCase, nets: Mapping[str, nn.Module],
                   batch: Mapping[str, torch.Tensor]) -> Dict[str, dict]:
    """The case's steps on the port, each from the networks' weights as they
    are on entry (the trained networks are restored after each step). For
    each run: 'metrics' (floats), 'pred' (the step's prediction, float32
    numpy: xhat for stage 1, Genh's first pass for stage 2, the Student's
    output for stage 3), 'stats' (the trained networks' BatchNorm running
    statistics after the step), 'grads' ({network: {key: gradient}} of the
    trainable parameters) and, where a frozen network feeds the step,
    'frozen': its output as the step takes it (stage 2: the frozen Gbase's
    image, upscaled, Genh's input; stage 3: the teacher's target), numpy
    float32. `batch` holds the case's ``train_batch`` as tensors on the
    networks' device."""
    from megaportraits_tpu_torch.core.config import Config
    from megaportraits_tpu_torch.train.state import (
        TrainState,
        make_optimizer,
        trainable_parameters,
    )
    from megaportraits_tpu_torch.train.train_base import make_train_step
    from megaportraits_tpu_torch.train.train_hr import make_hr_train_step
    from megaportraits_tpu_torch.train.train_student import make_student_train_step

    cfg = Config()
    before = {name: {k: v.clone() for k, v in nets[name].state_dict().items()}
              for name in case.trained}
    states = {name: TrainState(nets[name], make_optimizer(nets[name], cfg.training.lr, 1))
              for name in case.trained}

    def outcome(metrics, pred, frozen=None):
        out = {"metrics": {k: float(v) for k, v in metrics.items()},
               "pred": pred.detach().float().cpu().numpy().copy(), "stats": {},
               "grads": {}}
        if frozen is not None:
            out["frozen"] = frozen.float().cpu().numpy().copy()
        for name in case.trained:
            out["stats"].update({f"{name}/{k}": v.float().cpu().numpy().copy()
                                 for k, v in nets[name].named_buffers()
                                 if k.endswith(("running_mean", "running_var"))})
            out["grads"][name] = {k: p.grad.float().cpu().numpy()
                                  for k, p in trainable_parameters(nets[name])}
        for name in case.trained:
            nets[name].load_state_dict(before[name])
            for p in nets[name].parameters():
                p.grad = None
        return out

    if case.name == "train_base":
        step = make_train_step(nets["ploss"], cfg)
        _, _, metrics, xhat = step(states["gbase"], states["disc"], dict(batch))
        return {"step": outcome(metrics, xhat)}
    if case.name == "train_hr":
        step = make_hr_train_step(nets["genh"], nets["gbase"], nets["ploss"], cfg)
        kept, handle = _first_call(nets["genh"])
        base, base_handle = _first_call(nets["genh"], output=False)
        try:
            _, metrics = step(states["genh"], dict(batch))
        finally:
            handle.remove()
            base_handle.remove()
        return {"step": outcome(metrics, kept[0], base[0])}
    step = make_student_train_step(nets["student"], nets["teacher"], cfg)
    out = {}
    for run in case.runs:
        keys = (("source", "driving", "avatar_index") if run == "inline"
                else ("driving", "avatar_index", "target01"))
        kept, handle = _first_call(nets["student"])
        target, target_handle = _first_call(nets["teacher"].genh)
        try:
            _, metrics = step(states["student"], {k: batch[k] for k in keys})
        finally:
            handle.remove()
            target_handle.remove()
        # The teacher's target as make_teacher_forward makes it.
        out[run] = outcome(metrics, kept[0],
                           (target[0].float() + 1.0) * 0.5 if target else None)
        states["student"] = TrainState(nets["student"], make_optimizer(
            nets["student"], cfg.training.lr, 1))
    return out


# What the golden keeps of a run, and the gaps between two runs.

FLOORS = {"metric": 1e-4, "pred": 1e-4, "frozen": 1e-4, "stats": 1e-4, "grad": 1e-4}


def _grad_sample(g: np.ndarray) -> np.ndarray:
    """At most ``GRAD_SAMPLES`` values of a gradient leaf, at a fixed stride
    through its flat (port) layout, NaN-padded to ``GRAD_SAMPLES``."""
    flat = np.asarray(g, np.float32).ravel()
    stride = -(-flat.size // GRAD_SAMPLES)
    out = np.full(GRAD_SAMPLES, np.nan, np.float32)
    picked = flat[::stride]
    out[:picked.size] = picked
    return out


def train_samples(outcome: Mapping[str, object]) -> Dict[str, np.ndarray]:
    """What the golden keeps of one run of ``run_train_case``: the metrics,
    ``samples`` of the prediction (and of the frozen network's output),
    every BatchNorm running statistic, and per gradient leaf its norm and
    ``_grad_sample``."""
    out = {"metric_names": np.array(sorted(outcome["metrics"])),
           "metrics": np.array([outcome["metrics"][k] for k in sorted(outcome["metrics"])],
                               np.float64)}
    out.update({f"pred/{k}": v for k, v in samples(outcome["pred"]).items()})
    if "frozen" in outcome:
        out.update({f"frozen/{k}": v for k, v in samples(outcome["frozen"]).items()})
    names = sorted(outcome["stats"])
    out["stat_names"] = np.array(names)
    out["stat_sizes"] = np.array([outcome["stats"][k].size for k in names], np.int64)
    out["stats"] = (np.concatenate([outcome["stats"][k].ravel() for k in names])
                    .astype(np.float32) if names else np.zeros(0, np.float32))
    for net, grads in outcome["grads"].items():
        keys = list(grads)
        out[f"grad/{net}/names"] = np.array(keys)
        out[f"grad/{net}/norm"] = np.array(
            [np.linalg.norm(grads[k].astype(np.float64)) for k in keys])
        out[f"grad/{net}/sub"] = np.stack([_grad_sample(grads[k]) for k in keys])
    return out


def comparable(outcome: Mapping[str, object]) -> Dict[str, object]:
    """A run in the form ``train_gaps`` compares: from ``run_train_case``'s
    outcome (the whole prediction, every gradient value) or from
    ``train_samples``' arrays (the golden's samples)."""
    if "metric_names" not in outcome:
        grads = outcome["grads"]
        out = {"metrics": dict(outcome["metrics"]), "pred": outcome["pred"],
               "stats": {k: np.asarray(v) for k, v in outcome["stats"].items()},
               "grads": {net: {k: (g, float(np.linalg.norm(g.astype(np.float64))))
                               for k, g in leaves.items()}
                         for net, leaves in grads.items()}}
        if "frozen" in outcome:
            out["frozen"] = outcome["frozen"]
        return out
    stats, at = {}, 0
    for name, size in zip(outcome["stat_names"], outcome["stat_sizes"]):
        stats[str(name)] = outcome["stats"][at:at + size]
        at += size
    nets = {k.split("/")[1] for k in outcome if k.startswith("grad/")}
    grads = {}
    for net in sorted(nets):
        sub, norm = outcome[f"grad/{net}/sub"], outcome[f"grad/{net}/norm"]
        grads[net] = {str(k): (s[~np.isnan(s)], float(v))
                      for k, s, v in zip(outcome[f"grad/{net}/names"], sub, norm)}
    out = {"metrics": {str(k): float(v) for k, v in
                       zip(outcome["metric_names"], outcome["metrics"])},
           "stats": stats, "grads": grads}
    for name in ("pred", "frozen"):
        if f"{name}/sub" in outcome:
            out[name] = np.concatenate([outcome[f"{name}/sub"].ravel(),
                                        outcome[f"{name}/crop"].ravel()])
    return out


def train_gaps(got: Mapping[str, object], want: Mapping[str, object]
               ) -> Dict[str, float]:
    """The gaps of `got` against `want` (both ``comparable``): per metric the
    relative gap ('metric/<name>'); the prediction's max abs ('pred') and
    mean abs ('pred_mean'), and the frozen network's output's where the run
    has one ('frozen', 'frozen_mean'); the largest and mean absolute gap of the
    BatchNorm running statistics ('stats', 'stats_mean'); per trained
    network the relative Frobenius
    gap of its gradient over every leaf ('grad/<net>') and per leaf
    ('grad/<net>/<key>'), over the leaves whose norm in `want` is above
    ``GRAD_FLOOR`` of the largest."""
    gaps = {}
    if set(got["metrics"]) != set(want["metrics"]):
        raise ValueError(f"metrics {sorted(got['metrics'])} against {sorted(want['metrics'])}")
    for k, w in want["metrics"].items():
        gaps[f"metric/{k}"] = abs(got["metrics"][k] - w) / max(abs(w), 1e-6)
    for name in ("pred", "frozen"):
        if name in want:
            diff = np.abs(np.asarray(got[name], np.float64)
                          - np.asarray(want[name], np.float64))
            gaps[name], gaps[f"{name}_mean"] = float(diff.max()), float(diff.mean())
    if set(got["stats"]) != set(want["stats"]):
        raise ValueError("the two runs have different BatchNorm statistics")
    diff = [np.abs(got["stats"][k] - w).ravel() for k, w in want["stats"].items()]
    diff = np.concatenate(diff) if diff else np.zeros(1)
    gaps["stats"], gaps["stats_mean"] = float(diff.max()), float(diff.mean())
    for net, leaves in want["grads"].items():
        if set(got["grads"][net]) != set(leaves):
            raise ValueError(f"{net}: the two runs have different gradient leaves")
        floor = GRAD_FLOOR * max(norm for _, norm in leaves.values())
        num = den = 0.0
        for k, (w, norm) in leaves.items():
            if norm <= floor:
                continue
            g = np.asarray(got["grads"][net][k][0], np.float64)
            w = np.asarray(w, np.float64)
            d2, w2 = float(np.sum((g - w) ** 2)), float(np.sum(w ** 2))
            gaps[f"grad/{net}/{k}"] = (d2 / w2) ** 0.5 if w2 else 0.0
            num, den = num + d2, den + w2
        gaps[f"grad/{net}"] = (num / den) ** 0.5
    return gaps


def tolerance(name: str, self_gaps: Mapping[str, float]) -> float:
    """The limit of gap `name`: the larger of twice the port's own
    self-gap and the quantity's floor (``FLOORS``)."""
    floor = FLOORS[name.split("/")[0].removesuffix("_mean")]
    return max(2.0 * self_gaps.get(name, 0.0), floor)


def golden_run(golden: Mapping[str, np.ndarray], name: str, run: str
               ) -> Dict[str, np.ndarray]:
    """A run's arrays in the training golden (``train_samples``' names)."""
    prefix = f"{name}/{run}/"
    return {k[len(prefix):]: v for k, v in golden.items()
            if k.startswith(prefix) and "self_gap" not in k}


def golden_self_gaps(golden: Mapping[str, np.ndarray], name: str, run: str,
                     whole: bool = False) -> Dict[str, float]:
    """{quantity: self-gap} of a run as the training golden keeps them:
    measured on the golden's samples, or with `whole` on whole outcomes."""
    prefix, form = f"{name}/{run}/", "whole" if whole else "samples"
    return {str(k): float(v) for k, v in zip(golden[prefix + f"self_gap_names/{form}"],
                                             golden[prefix + f"self_gaps/{form}"])}
