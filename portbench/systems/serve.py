"""Avatar streams served in lockstep: one batch holds one frame of every
stream.

Stage 1 (a configuration without ``hr_size``): the port's
``ReenactmentSession`` over Gbase, the sources encoded once at set-up, then
one ``__call__`` (``Gbase.drive``) a step, with the G2d trunk on kernel K2
where the configuration sets ``use_chain_kernel``. Stage 2 (``hr_size``
set): each step's frames are then resized bilinearly to ``hr_size``
(``align_corners=False``, as stage-2 training feeds them) and enhanced by
Genh. The port has no session class for stage 2, so the step composes the
same calls the port's stage-2 serving makes.

``Program`` is the system under test; ``Reference`` is the plain float32
model of ``portbench/reference`` with the same weights, drawn again from the
seed. ``Reference(policy=FP8_CONTROL)`` put in the program's place is the
control of the correctness check.

Weights are drawn from the seed (``seeded.py``). The motion encoder's
BatchNorm statistics are then set from a float32 pass of the reference's
motion encoder over images drawn from the seed (``motion_statistics``), so
that its outputs follow the driving frame: with drawn statistics each of
its layers shrinks its input, and the pose and expression of two different
frames differed by less than bf16 rounding. Each side works them out
itself.

Both sides keep what each step's call computed from its driving frames
(``seen``): Emtn's expression vector, the c2d warp field (which holds the
pose and translation too), and the warped, depth-summed volume that G2d
takes. Forward hooks record them on every call; the window keeps them for
the steps it checks.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from portbench.spec import arch_fields

WEIGHT_TAGS = ("weights.gbase", "weights.genh")
CALIBRATION_IMAGES = 16
SEEN = ("expression", "warp", "g2d_in")


@torch.no_grad()
def motion_statistics(config: Dict, seed: int, device, arch: Optional[Dict] = None,
                      image_size: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """The motion encoder's BatchNorm running statistics: the batch
    statistics of a float32 train-mode pass of the reference's Emtn, with
    the seed's weights, over ``CALIBRATION_IMAGES`` smooth images drawn from
    the seed."""
    from portbench.reference.arch import Arch
    from portbench.reference.emtn import Emtn
    from portbench.reference.gbase import Gbase
    from portbench.reference.layers import BatchNorm
    from portbench.seeded import draw_state, generator, smooth_images

    a = Arch(**arch_fields(config, arch))
    shapes = Gbase(arch=a, device="meta")
    emtn = Emtn(arch=a, device=device)
    emtn.load_state_dict(draw_state(shapes, seed, WEIGHT_TAGS[0], device,
                                    prefix="motion_encoder."))
    images = smooth_images(generator(device, seed, "calibration"), CALIBRATION_IMAGES,
                           image_size or config["image_size"], device)
    norms = [m for m in emtn.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.momentum = 1.0  # the running statistics become this batch's
    emtn.train()
    emtn(images, True)
    return {k: v.clone() for k, v in emtn.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def load_statistics(module: torch.nn.Module, stats: Dict[str, torch.Tensor]) -> None:
    """Put `stats` (some of `module`'s buffers, by name) in place; every
    name has to be one of its buffers."""
    unexpected = module.load_state_dict(stats, strict=False).unexpected_keys
    if unexpected:
        raise KeyError(f"not buffers of {type(module).__name__}: {unexpected[:3]}")


class _Seen:
    """Forward hooks on a Gbase that record, for each call of its drive
    path, the per-stream quantities of ``SEEN``. ``_clear`` starts a step;
    the reference's blocks of rows each add theirs."""

    def _watch(self, gbase) -> None:
        self._seen: Dict[str, List[torch.Tensor]] = {k: [] for k in SEEN}

        def motion(_m, _a, out):
            self._seen["expression"].append(out[2])

        def warp(_m, _a, out):
            self._seen["warp"].append(out)

        def g2d_in(_m, args):
            self._seen["g2d_in"].append(args[0])

        gbase.motion_encoder.register_forward_hook(motion)
        gbase.warp_generator_c2d.register_forward_hook(warp)
        gbase.g2d.register_forward_pre_hook(g2d_in)

    def _clear(self) -> None:
        for v in self._seen.values():
            v.clear()

    def seen(self) -> Dict[str, torch.Tensor]:
        """The last step's quantities, rows in stream order, in float32."""
        return {k: torch.cat(v).float() for k, v in self._seen.items() if v}


class Program(_Seen):
    """The port, as a service would run it."""

    def __init__(self, config: Dict, seed: int, device, arch: Optional[Dict] = None,
                 image_size: Optional[int] = None):
        from megaportraits_tpu_torch.core.arch import Arch
        from megaportraits_tpu_torch.core.dtypes import DEFAULT_POLICY, FP32_POLICY
        from megaportraits_tpu_torch.infer.streaming import ReenactmentSession
        from megaportraits_tpu_torch.models.gbase import Gbase
        from megaportraits_tpu_torch.models.genh import Genh
        from megaportraits_tpu_torch.ops.resize import linear_resize

        from portbench.seeded import load_drawn

        a = Arch(**arch_fields(config, arch))
        # bf16 as configured on the card; float32 in the CPU tests, since the
        # CPU lacks bf16 kernels that the models use.
        bf16 = config["use_bf16"] and torch.device(device).type == "cuda"
        policy = DEFAULT_POLICY if bf16 else FP32_POLICY
        self.gbase = load_drawn(Gbase(policy=policy, arch=a, device=device),
                                seed, WEIGHT_TAGS[0])
        load_statistics(self.gbase.motion_encoder,
                        motion_statistics(config, seed, device, arch, image_size))
        self.gbase.g2d.use_chain_kernel = bool(config["use_chain_kernel"])
        self.session = ReenactmentSession(model=self.gbase, bn_mode="running")
        self.hr_size = config.get("hr_size")
        self.genh = None
        if self.hr_size:
            self.genh = load_drawn(Genh(policy=policy, arch=a, device=device),
                                   seed, WEIGHT_TAGS[1]).eval()
        self._resize = linear_resize
        self._watch(self.gbase)

    def encode(self, sources: torch.Tensor) -> None:
        self.session.set_source(sources)

    @torch.no_grad()
    def step(self, frames: torch.Tensor) -> torch.Tensor:
        self._clear()
        out = self.session(frames)
        if self.genh is not None:
            out = self.genh(self._resize(out, (self.hr_size, self.hr_size),
                                         axes=(1, 2), align_corners=False))
        return out

    def layers(self) -> Dict[str, torch.nn.Module]:
        """The submodules whose calls the traced run wraps in ranges."""
        g = self.gbase
        out = {"motion_encoder": g.motion_encoder,
               "warp_generator_c2d": g.warp_generator_c2d, "g2d": g.g2d}
        if self.genh is not None:
            out["genh"] = self.genh
        return out

    def trunk_owner(self):
        """The object whose ``trunk`` method the traced run wraps."""
        return self.gbase.g2d


class Reference(_Seen):
    """The plain float32 model, run in blocks of `block` rows."""

    def __init__(self, config: Dict, seed: int, device, arch: Optional[Dict] = None,
                 image_size: Optional[int] = None, policy=None, block: int = 4):
        from portbench.reference.arch import Arch
        from portbench.reference.dtypes import DEFAULT_POLICY
        from portbench.reference.gbase import Gbase
        from portbench.reference.genh import Genh
        from portbench.seeded import load_drawn

        a = Arch(**arch_fields(config, arch))
        policy = policy or DEFAULT_POLICY
        self.gbase = load_drawn(Gbase(policy=policy, arch=a, device=device),
                                seed, WEIGHT_TAGS[0]).eval()
        load_statistics(self.gbase.motion_encoder,
                        motion_statistics(config, seed, device, arch, image_size))
        self.hr_size = config.get("hr_size")
        self.genh = None
        if self.hr_size:
            self.genh = load_drawn(Genh(policy=policy, arch=a, device=device),
                                   seed, WEIGHT_TAGS[1]).eval()
        self.block = block
        self.state = None
        self._watch(self.gbase)

    def _rows(self, n: int):
        return [slice(i, min(i + self.block, n)) for i in range(0, n, self.block)]

    @torch.no_grad()
    def encode(self, sources: torch.Tensor) -> None:
        self.state = [self.gbase.encode_source(sources[r]) for r in self._rows(len(sources))]

    @torch.no_grad()
    def step(self, frames: torch.Tensor) -> torch.Tensor:
        from portbench.reference.resize import linear_resize

        self._clear()
        outs = []
        for r, state in zip(self._rows(len(frames)), self.state):
            out = self.gbase.drive(state, frames[r])
            if self.genh is not None:
                out = self.genh(linear_resize(out, (self.hr_size, self.hr_size),
                                              axes=(1, 2), align_corners=False))
            outs.append(out.float())
        return torch.cat(outs)


def control_policy():
    from portbench.reference.dtypes import FP8_CONTROL

    return FP8_CONTROL


def tiny_arch() -> Dict:
    """The reference's TINY preset as ``arch`` keywords (the CPU tests)."""
    from portbench.reference.arch import TINY

    return dataclasses.asdict(TINY)
