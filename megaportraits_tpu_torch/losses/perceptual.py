"""Perceptual losses: VGG feature taps, LPIPS, and the reference's combined
PerceptualLoss (counterpart of ``megaportraits_tpu/losses/perceptual.py``).

The backbones are frozen: ``build_perceptual_loss`` turns their gradients
off, but gradients still flow through them to the prediction. Without a
converted pretrained bundle they run on seeded random weights, as the JAX
trainer does when its bundle is absent.

Reference quirks kept:
  * inputs are ImageNet-normalised once, and the SAME normalised tensors
    feed both the VGG19 tap loss and LPIPS, which applies its own shift and
    scale on top of them;
  * the gaze slot adds the constant ``weights['gaze']``.
The 'vggface' term (``use_vggface``, off by default as in JAX) adds
``weights['vggface']`` x the L1 of InceptionResnetV1's four taps
(losses/vggface.py) on the same normalised tensors.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from megaportraits_tpu_torch.core.arch import FULL, Arch, get_arch
from megaportraits_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device
from megaportraits_tpu_torch.core.dtypes import DEFAULT_POLICY, Policy
from megaportraits_tpu_torch.nn.layers import (
    TorchConv,
    init_parameters,
    to_channels_first,
    to_channels_last,
)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# LPIPS scaling layer.
LPIPS_SHIFT = (-0.030, -0.088, -0.188)
LPIPS_SCALE = (0.458, 0.448, 0.450)

# torchvision 'features' configs: convs per stage.
VGG_CFGS = {
    "vgg16": (2, 2, 3, 3, 3),
    "vgg19": (2, 2, 4, 4, 4),
}
VGG_WIDTHS = (64, 128, 256, 512, 512)

# Taps (stage, conv index within the stage), after the ReLU:
# relu{1_1,2_1,3_1,4_1,5_1} for the VGG19 loss, relu{1_2,2_2,3_3,4_3,5_3}
# for LPIPS.
VGG19_REFERENCE_TAPS = ((0, 0), (1, 0), (2, 0), (3, 0), (4, 0))
LPIPS_TAPS = ((0, 1), (1, 1), (2, 2), (3, 2), (4, 2))

DEFAULT_WEIGHTS = {"vgg19": 20.0, "vggface": 5.0, "gaze": 4.0, "lpips": 10.0}


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 max pool, stride 2, VALID, on NHWC."""
    return to_channels_last(F.max_pool2d(to_channels_first(x), 2, 2))


def _constant_buffer(module: nn.Module, name: str, values, device) -> None:
    """A per-channel float32 constant that moves with the module and stays
    out of its state_dict (the JAX tree has no such leaf)."""
    module.register_buffer(name, torch.tensor(values, dtype=torch.float32,
                                              device=device), persistent=False)


class VGG(nn.Module):
    """VGG-16/19 feature trunk returning the activations at `taps`; only
    the stages up to the last tap are built. ``arch.vgg_stages`` (0 = all)
    drops the taps of later stages."""

    def __init__(self, cfg: str = "vgg19",
                 taps: Sequence[Tuple[int, int]] = VGG19_REFERENCE_TAPS,
                 policy: Policy = DEFAULT_POLICY, arch: Arch = FULL, device=None):
        super().__init__()
        self.taps = tuple(taps)
        if arch.vgg_stages:
            self.taps = tuple(t for t in self.taps if t[0] < arch.vgg_stages)
        last = max(s for s, _ in self.taps)
        self.stages = []  # per stage, the names of its convs
        c_in = 3
        for stage, n_convs in enumerate(VGG_CFGS[cfg][:last + 1]):
            names = []
            c_out = arch.ch(VGG_WIDTHS[stage])
            for i in range(n_convs):
                name = f"conv{stage + 1}_{i + 1}"
                self.add_module(name, TorchConv(c_in, c_out, (3, 3), padding=1,
                                                policy=policy, device=device))
                names.append(name)
                c_in = c_out
            self.stages.append(names)

    def tap_channels(self):
        return [getattr(self, self.stages[s][i]).weight.shape[0] for s, i in self.taps]

    def forward(self, x: torch.Tensor):
        outputs = {}
        for stage, names in enumerate(self.stages):
            for i, name in enumerate(names):
                x = torch.relu(getattr(self, name)(x))
                if (stage, i) in self.taps:
                    outputs[(stage, i)] = x
            if stage < len(self.stages) - 1:  # no pool after the last tap
                x = max_pool_2x2(x)
        return [outputs[t] for t in self.taps]


class LPIPS(nn.Module):
    """LPIPS(net='vgg'): unit-normalised VGG16 taps, squared difference,
    bias-free 1x1 linear heads, spatial mean, summed over taps -> [B]."""

    def __init__(self, policy: Policy = DEFAULT_POLICY, arch: Arch = FULL,
                 device=None):
        super().__init__()
        self.policy = policy
        self.vgg16 = VGG("vgg16", LPIPS_TAPS, policy=policy, arch=arch, device=device)
        _constant_buffer(self, "shift", LPIPS_SHIFT, device)
        _constant_buffer(self, "scale", LPIPS_SCALE, device)
        for i, c in enumerate(self.vgg16.tap_channels()):
            self.add_module(f"lin{i}", TorchConv(c, 1, (1, 1), use_bias=False,
                                                 policy=policy, device=device))

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        p = self.policy
        fx = self.vgg16(p.cast_to_compute((x.float() - self.shift) / self.scale))
        fy = self.vgg16(p.cast_to_compute((y.float() - self.shift) / self.scale))
        total = 0.0
        for i, (a, b) in enumerate(zip(fx, fy)):
            a = a.float()
            b = b.float()
            a = a / torch.sqrt((a * a).sum(dim=-1, keepdim=True) + 1e-10)
            b = b / torch.sqrt((b * b).sum(dim=-1, keepdim=True) + 1e-10)
            head = getattr(self, f"lin{i}")(((a - b) ** 2).to(p.compute_dtype))
            total = total + head.float().mean(dim=(1, 2, 3))
        return total


class PerceptualLoss(nn.Module):
    """The reference's PerceptualLoss: ``weights['vgg19']`` x the L1 of the
    VGG19 taps + ``weights['vggface']`` x the L1 of InceptionResnetV1's taps
    (with `use_vggface`) + ``weights['lpips']`` x mean LPIPS +
    ``weights['gaze']``, plus the feature-matching L1 of the VGG19 taps when
    ``forward`` is asked for it. The VGG19 trunk is built when its weight is
    set or when `use_fm_loss` asks for the feature-matching term (JAX builds
    it from the call, ``w['vgg19'] or use_fm_loss``; torch must know at
    construction); LPIPS when its weight is set; the identity net
    (``vggface``, full width whatever the arch, as in JAX) when
    `use_vggface` and its weight are set."""

    def __init__(self, weights: Optional[Dict[str, float]] = None,
                 policy: Policy = DEFAULT_POLICY, arch: Arch = FULL, device=None,
                 use_fm_loss: bool = False, use_vggface: bool = False):
        super().__init__()
        self.weights = dict(weights or DEFAULT_WEIGHTS)
        self.policy = policy
        self.vgg19 = (VGG("vgg19", VGG19_REFERENCE_TAPS, policy=policy, arch=arch,
                          device=device)
                      if self.weights.get("vgg19", 0.0) or use_fm_loss else None)
        self.vggface = None
        if use_vggface and self.weights.get("vggface", 0.0):
            from megaportraits_tpu_torch.losses.vggface import InceptionResnetV1

            self.vggface = InceptionResnetV1(policy=policy, device=device)
        self.lpips = (LPIPS(policy=policy, arch=arch, device=device)
                      if self.weights.get("lpips", 0.0) else None)
        _constant_buffer(self, "mean", IMAGENET_MEAN, device)
        _constant_buffer(self, "std", IMAGENET_STD, device)

    def forward(self, predicted: torch.Tensor, target: torch.Tensor,
                use_fm_loss: bool = False) -> torch.Tensor:
        w = self.weights
        p = self.policy
        pred_n = (predicted.float() - self.mean) / self.std
        tgt_n = (target.float() - self.mean) / self.std

        total = torch.zeros((), dtype=torch.float32, device=predicted.device)
        if use_fm_loss and self.vgg19 is None:
            raise ValueError("use_fm_loss needs the VGG19 trunk: build the loss "
                             "with use_fm_loss=True")
        if self.vgg19 is not None:
            fp = self.vgg19(p.cast_to_compute(pred_n))
            ft = self.vgg19(p.cast_to_compute(tgt_n))
            vgg_loss = sum(torch.mean(torch.abs(a.float() - b.float()))
                           for a, b in zip(fp, ft))
            total = total + w.get("vgg19", 0.0) * vgg_loss
            if use_fm_loss:
                # Feature-matching variant: the target features detached.
                total = total + sum(
                    torch.mean(torch.abs(a.float() - b.float().detach()))
                    for a, b in zip(fp, ft))
        if self.vggface is not None:
            _, fa = self.vggface(p.cast_to_compute(pred_n), return_taps=True)
            _, fb = self.vggface(p.cast_to_compute(tgt_n), return_taps=True)
            face_loss = sum(torch.mean(torch.abs(a.float() - b.float()))
                            for a, b in zip(fa, fb))
            total = total + w["vggface"] * face_loss
        if self.lpips is not None:
            total = total + w["lpips"] * torch.mean(self.lpips(pred_n, tgt_n))
        # The reference's gaze slot: a constant.
        return total + float(w.get("gaze", 0.0))


def build_perceptual_loss(arch: Union[str, Arch] = "full",
                          policy: Policy = DEFAULT_POLICY,
                          device: Union[str, torch.device] = DEFAULT_DEVICE,
                          seed: int = 0,
                          weights: Optional[Dict[str, float]] = None,
                          use_vggface: bool = False) -> PerceptualLoss:
    """A frozen PerceptualLoss with seeded random weights on `device` (the
    card by default; raises if there is none and the caller did not ask
    for the CPU)."""
    model = PerceptualLoss(weights, policy=policy, arch=get_arch(arch),
                           device=resolve_device(device), use_vggface=use_vggface)
    init_parameters(model, seed)
    return model.requires_grad_(False).eval()
