"""Streaming one-shot reenactment: encode the source once, drive per frame
(counterpart of ``megaportraits_tpu/infer/streaming.py``); and the stage-3
Student served the same way, each stream's avatar set once.

``ReenactmentSession``'s bn_mode 'running' normalises with the BatchNorm
running statistics (the reference convention); 'batch' uses each input's
own batch statistics. In both modes the model is in ``.eval()``, so the
running statistics are never written: the JAX session likewise throws its
mutated ``batch_stats`` away. The Student's session always uses the running
statistics.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from megaportraits_tpu_torch.core.arch import FULL, Arch
from megaportraits_tpu_torch.core.device import DEFAULT_DEVICE
from megaportraits_tpu_torch.core.dtypes import DEFAULT_POLICY, Policy
from megaportraits_tpu_torch.models.gbase import Gbase, build_gbase
from megaportraits_tpu_torch.models.student import Student, build_student
from megaportraits_tpu_torch.utils.profiling import annotate

BN_MODES = ("running", "batch")


def check_bn_mode(bn_mode: str) -> None:
    if bn_mode not in BN_MODES:
        raise ValueError(f"unknown bn_mode: {bn_mode!r}; expected one of {BN_MODES}")


class ReenactmentSession:
    def __init__(self, model: Optional[Gbase] = None,
                 policy: Policy = DEFAULT_POLICY, bn_mode: str = "running",
                 device: Union[str, torch.device] = DEFAULT_DEVICE,
                 arch: Arch = FULL, seed: int = 0):
        """With no `model`, builds a seeded random-weight Gbase on `device`
        (the card by default). A given model is used where it lies."""
        check_bn_mode(bn_mode)
        if model is None:
            model = build_gbase(arch, policy=policy, device=device, seed=seed)
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.train_bn = bn_mode == "batch"
        self.source_state = None

    @torch.no_grad()
    def set_source(self, xs: torch.Tensor) -> None:
        """xs: [B, H, W, 3] source image(s)."""
        with annotate("session.encode_source"):
            self.source_state = self.model.encode_source(xs.to(self.device),
                                                         self.train_bn)

    @torch.no_grad()
    def __call__(self, xd: torch.Tensor) -> torch.Tensor:
        """xd: [B, H, W, 3] driving frame -> [B, H, W, 3] reenacted frame."""
        if self.source_state is None:
            raise RuntimeError("call set_source first")
        with annotate("session.step"):
            return self.model.drive(self.source_state, xd.to(self.device),
                                    self.train_bn)


class StudentSession:
    """The distilled Student served per avatar: each stream's avatar index
    is set once and kept on the model's device, then every call renders one
    driving frame of every stream, row i under avatar ``indices[i]``."""

    def __init__(self, model: Optional[Student] = None, num_avatars: int = 4,
                 device: Union[str, torch.device] = DEFAULT_DEVICE, seed: int = 0):
        """With no `model`, builds a seeded random-weight FULL Student of
        `num_avatars` avatars on `device` (the card by default) under the
        default policy. A given model is used where it lies. BatchNorm
        normalises with its running statistics."""
        if model is None:
            model = build_student(num_avatars, device=device, seed=seed)
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.avatars = None

    def set_avatars(self, indices) -> None:
        """indices: [B] avatar indices (a sequence or a tensor), one a
        stream."""
        with annotate("session.set_avatars"):
            self.avatars = torch.as_tensor(indices, dtype=torch.long).to(self.device)

    @torch.no_grad()
    def __call__(self, xd: torch.Tensor) -> torch.Tensor:
        """xd: [B, H, W, 3] driving frames -> [B, H, W, 3] in [0, 1]."""
        if self.avatars is None:
            raise RuntimeError("call set_avatars first")
        if len(xd) != len(self.avatars):
            raise ValueError(f"{len(xd)} frames for {len(self.avatars)} avatars")
        with annotate("session.step"):
            return self.model(xd.to(self.device), self.avatars)
