"""Weights and images drawn on the device from a run's seed.

Every tensor of a module's ``state_dict`` is drawn, in key order, from one
uniform draw of all their elements (one call on the device), by the rule of
the port's full-width goldens: weights of two or more axes
U(+-1/sqrt(fan_in)); 1-D weights U(0.8, 1.2); other 1-D tensors (biases)
U(+-0.1*sqrt(3)), the standard deviation 0.1; BatchNorm running means
U(-0.3, 0.3) and running variances U(0.5, 1.5). N(0, 2/fan_in) weights
saturate the HR enhancer's tanh. The same seed gives the same tensors to
the program and to the reference, which draws them again for itself.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict

import torch
import torch.nn.functional as F

GRID = 12  # side of the coarse colour grid of a smooth image


def seed_for(seed: int, tag: str) -> int:
    """A 63-bit seed for one stream (`tag`) of a run's draws."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(device, seed: int, tag: str) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_for(seed, tag))
    return gen


def _bounds(key: str, shape) -> tuple:
    if key.endswith("running_var"):
        return 0.5, 1.5
    if key.endswith("running_mean"):
        return -0.3, 0.3
    if len(shape) == 1 and key.endswith("weight"):
        return 0.8, 1.2
    if len(shape) <= 1:
        b = 0.1 * math.sqrt(3.0)
        return -b, b
    b = 1.0 / math.sqrt(max(math.prod(shape[1:]), 1))
    return -b, b


def draw_state(module: torch.nn.Module, seed: int, tag: str, device,
               prefix: str = "") -> Dict[str, torch.Tensor]:
    """float32 tensors for `module`'s state_dict keys, on `device`; with
    `prefix`, only the keys under it, named without it (a submodule's share
    of its parent's draw; the parent may lie on the meta device)."""
    shapes = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    flat = torch.rand(sum(math.prod(s) for s in shapes.values()),
                      generator=generator(device, seed, tag), device=device)
    out, off = {}, 0
    for key, shape in shapes.items():
        n = math.prod(shape)
        if key.startswith(prefix):
            lo, hi = _bounds(key, shape)
            out[key[len(prefix):]] = flat[off:off + n].mul_(hi - lo).add_(lo).view(shape)
        off += n
    return out


def load_drawn(module: torch.nn.Module, seed: int, tag: str) -> torch.nn.Module:
    device = next(module.parameters()).device
    module.load_state_dict(draw_state(module, seed, tag, device))
    return module


def smooth_images(gen: torch.Generator, n: int, size: int, device) -> torch.Tensor:
    """`n` smooth RGB images in [0, 1], [n, size, size, 3]: a grid of random
    colours, bicubically interpolated and clamped."""
    coarse = torch.rand(n, 3, GRID, GRID, device=device, generator=gen)
    img = F.interpolate(coarse, size=(size, size), mode="bicubic",
                        align_corners=False).clamp(0, 1)
    return img.permute(0, 2, 3, 1).contiguous()
