"""Gbase — the stage-1 one-shot reenactment generator (counterpart of
``megaportraits_tpu/models/gbase.py``).

    vs, es = Eapp(xs)                      # volume + appearance descriptor
    Rs, ts, zs = Emtn(xs); Rd, td, zd = Emtn(xd)
    w_s2c = WarpGenerator(invert=True)(Rs, ts, zs, es)
    vc = apply_warping_field(vs, w_s2c)    # -> canonical volume
    vc2d = G3d(vc)
    w_c2d = WarpGenerator(invert=False)(Rd, td, zd, es)
    projected = sum over depth of apply_warping_field(vc2d, w_c2d)
    xhat = G2d(projected)                  # [B, H, W, 3] in [0, 1]

``encode_source`` + ``drive`` split this for streaming: everything that
depends only on the source runs once, the rest once per driving frame.
``generate`` is the image without the pyramids (the frozen Gbase of the
stage-2 and stage-3 steps, GHR, single-pair inference). Training
(``train/train_base.py``) calls ``encode_appearance``,
``encode_motion`` and ``synthesize`` on batched descriptor mixes;
``pairwise_outputs`` is the pairwise-transfer pass on its own.
``build_gbase`` is the factory; it runs on the card unless asked otherwise.

``remat`` trades forward FLOPs for activation memory in training, with
JAX's modes: 'none'; 'selective' recomputes Eapp and G2d (the large
activations) in the backward pass; 'full' also Emtn, G3d and both warp
generators. Each call of such a submodule under autograd is a
``torch.utils.checkpoint`` (non-reentrant). The recompute runs the
submodule in ``.eval()`` with the same ``train`` flag: the same batch
statistics, but the BatchNorms do not record them a second time (JAX's
functional state cannot meet that problem).
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from megaportraits_tpu_torch.core.arch import FULL, Arch, get_arch
from megaportraits_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device
from megaportraits_tpu_torch.core.dtypes import DEFAULT_POLICY, Policy
from megaportraits_tpu_torch.models.eapp import Eapp
from megaportraits_tpu_torch.models.emtn import Emtn
from megaportraits_tpu_torch.models.g2d import G2d
from megaportraits_tpu_torch.models.g3d import G3d
from megaportraits_tpu_torch.models.warpgen import WarpGenerator
from megaportraits_tpu_torch.nn.layers import calibrate_batch_norm_with, init_parameters
from megaportraits_tpu_torch.ops.resize import anti_alias_downsample
from megaportraits_tpu_torch.ops.warp import apply_warping_field
from megaportraits_tpu_torch.utils.profiling import annotate

PYRAMID_SCALES = (0.5, 0.25)
REMAT_MODULES = {
    "none": (),
    "selective": ("appearance_encoder", "g2d"),
    "full": ("appearance_encoder", "g2d", "motion_encoder", "g3d",
             "warp_generator_s2c", "warp_generator_c2d"),
}


def remat_call(module: nn.Module, *args):
    """``module(*args)`` under a non-reentrant checkpoint whose recompute
    runs the module in ``.eval()`` (nothing of it reads the mode but the
    BatchNorms' recording of running statistics, which the first pass
    did)."""
    calls = 0

    def run(*inputs):
        nonlocal calls
        calls += 1
        if calls == 1:
            return module(*inputs)
        modes = [(m, m.training) for m in module.modules()]
        module.eval()
        try:
            return module(*inputs)
        finally:
            for m, mode in modes:
                m.training = mode

    return checkpoint(run, *args, use_reentrant=False)


class Gbase(nn.Module):
    def __init__(self, policy: Policy = DEFAULT_POLICY,
                 warp_normalize_mode: str = "reference",
                 rotation_input_size: int = 224,
                 descriptor_input_size: int = 256,
                 arch: Arch = FULL, device=None, remat: str = "none"):
        super().__init__()
        if remat not in REMAT_MODULES:
            raise ValueError(f"remat must be one of {sorted(REMAT_MODULES)}, got {remat!r}")
        self.policy = policy
        self.remat = remat  # read at every call: may be switched between steps
        # 'reference' replicates the reference's renormalization quirk
        # (needed for checkpoint parity); 'standard' is grid+flow sampling.
        self.warp_normalize_mode = warp_normalize_mode
        kw = dict(policy=policy, arch=arch, device=device)
        self.appearance_encoder = Eapp(**kw)
        self.motion_encoder = Emtn(rotation_input_size=rotation_input_size,
                                   descriptor_input_size=descriptor_input_size,
                                   **kw)
        self.warp_generator_s2c = WarpGenerator(invert=True, **kw)
        self.warp_generator_c2d = WarpGenerator(invert=False, **kw)
        self.g3d = G3d(**kw)
        self.g2d = G2d(**kw)

    def _run(self, name: str, *args):
        """Submodule `name` on `args`, checkpointed when the remat mode
        names it and autograd records."""
        module = getattr(self, name)
        if name in REMAT_MODULES[self.remat] and torch.is_grad_enabled():
            return remat_call(module, *args)
        return module(*args)

    def forward(self, xs: torch.Tensor, xd: torch.Tensor, train: bool = False
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        xhat = self.generate(xs, xd, train)
        return xhat, self.pyramids(xhat)

    def generate(self, xs: torch.Tensor, xd: torch.Tensor,
                 train: bool = False) -> torch.Tensor:
        """The generated image alone: ``forward`` without the pyramids."""
        vs, es = self._run("appearance_encoder", xs, train)
        rs, ts, zs = self._run("motion_encoder", xs, train)
        rd, td, zd = self._run("motion_encoder", xd, train)
        return self.synthesize(vs, es, rs, ts, zs, rd, td, zd, train)

    def synthesize(self, vs, es, rs, ts, zs, rd, td, zd, train: bool = False):
        """Synthesis from precomputed appearance/motion descriptors."""
        w_s2c = self._run("warp_generator_s2c", rs, ts, zs, es)
        vc = apply_warping_field(vs, w_s2c, self.warp_normalize_mode)
        vc2d = self._run("g3d", vc)
        w_c2d = self._run("warp_generator_c2d", rd, td, zd, es)
        vc2d_warped = apply_warping_field(vc2d, w_c2d, self.warp_normalize_mode)
        projected = vc2d_warped.sum(dim=1)  # orthographic projection
        return self._run("g2d", projected, train)

    def encode_motion(self, x: torch.Tensor, train: bool = False):
        return self._run("motion_encoder", x, train)

    def encode_appearance(self, x: torch.Tensor, train: bool = False):
        return self._run("appearance_encoder", x, train)

    def encode_source(self, xs: torch.Tensor, train: bool = False):
        """One-time source encoding for streaming reenactment: appearance
        volume, source motion, source->canonical warp and G3d."""
        vs, es = self._run("appearance_encoder", xs, train)
        rs, ts, zs = self._run("motion_encoder", xs, train)
        w_s2c = self._run("warp_generator_s2c", rs, ts, zs, es)
        vc = apply_warping_field(vs, w_s2c, self.warp_normalize_mode)
        return {"vc2d": self._run("g3d", vc), "es": es}

    def drive(self, source_state, xd: torch.Tensor, train: bool = False):
        """Per-driving-frame path given a precomputed source state; each
        stage a span (``utils/profiling.annotate``)."""
        with annotate("gbase.emtn"):
            rd, td, zd = self._run("motion_encoder", xd, train)
        with annotate("gbase.warpgen_c2d"):
            w_c2d = self._run("warp_generator_c2d", rd, td, zd, source_state["es"])
        with annotate("gbase.warp"):
            projected = apply_warping_field(source_state["vc2d"], w_c2d,
                                            self.warp_normalize_mode).sum(dim=1)
        with annotate("gbase.g2d"):
            return self._run("g2d", projected, train)

    def pairwise_outputs(self, i1: torch.Tensor, i2: torch.Tensor,
                         train: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """The pairwise-transfer passes: appearance of i1 with (pose of i2,
        expression of i1) and with (pose of i1, expression of i2) -> (I_pose,
        I_exp). Both warp generators get the same mixed descriptors, as in
        the reference."""
        vs1, es1 = self._run("appearance_encoder", i1, train)
        rs1, ts1, zs1 = self._run("motion_encoder", i1, train)
        rs2, ts2, zs2 = self._run("motion_encoder", i2, train)
        i_pose = self.synthesize(vs1, es1, rs2, ts2, zs1, rs2, ts2, zs1, train)
        i_exp = self.synthesize(vs1, es1, rs1, ts1, zs2, rs1, ts1, zs2, train)
        return i_pose, i_exp

    def pyramids(self, xhat: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {str(s): anti_alias_downsample(xhat, s) for s in PYRAMID_SCALES}


def build_gbase(arch: Union[str, Arch] = "full", policy: Policy = DEFAULT_POLICY,
                device: Union[str, torch.device] = DEFAULT_DEVICE, seed: int = 0,
                **kwargs) -> Gbase:
    """Gbase with seeded random weights on `device` (the card by default;
    raises if there is none and the caller did not ask for the CPU)."""
    dev = resolve_device(device)
    model = Gbase(policy=policy, arch=get_arch(arch), device=dev, **kwargs)
    return init_parameters(model, seed)


def calibrate_batch_norm(model: Gbase, xs: torch.Tensor, xd: torch.Tensor) -> int:
    """Calibrate every BatchNorm of `model` on one source/driving pair
    (``nn.layers.calibrate_batch_norm_with``): ``encode_source`` and
    ``drive`` with batch statistics. Returns the number of BatchNorms."""
    return calibrate_batch_norm_with(
        model, lambda: model.drive(model.encode_source(xs, train=True), xd,
                                   train=True))
