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
