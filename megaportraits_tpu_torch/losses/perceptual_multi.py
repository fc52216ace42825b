"""A perceptual loss with a choice of backbone: ROME's PerceptualLoss
surface (counterpart of ``megaportraits_tpu/losses/perceptual_multi.py``).

Backbones, by the names JAX accepts:
  vgg19, vgg16                       losses/perceptual.VGG (relu{1..5}_1 taps)
  alexnet                            AlexNetFeatures (below)
  resnet50, robust_resnet50,
  resnet50_scratch_dag               _ResNet50Taps (the stem and each stage)
  vgg_face_dag, vggface              losses/vggface.InceptionResnetV1's taps
The loss: ImageNet-normalise, take the backbone's taps, instance-normalise
them when asked, a layer-weighted L1, averaged over `num_scales`
anti-aliased scales (each half the last).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from megaportraits_tpu_torch.core.dtypes import DEFAULT_POLICY, Policy
from megaportraits_tpu_torch.losses.perceptual import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    VGG,
    VGG19_REFERENCE_TAPS,
    _constant_buffer,
)
from megaportraits_tpu_torch.losses.vggface import InceptionResnetV1, max_pool_3x3_s2_valid
from megaportraits_tpu_torch.models.resnet import Bottleneck, _ResNetTrunk, max_pool_3x3_s2
from megaportraits_tpu_torch.nn.layers import InstanceNorm, TorchConv
from megaportraits_tpu_torch.ops.resize import anti_alias_downsample

RESNET50_NAMES = ("resnet50", "robust_resnet50", "resnet50_scratch_dag")
VGGFACE_NAMES = ("vgg_face_dag", "vggface")


class AlexNetFeatures(nn.Module):
    """torchvision alexnet.features, returning the five post-ReLU taps."""

    def __init__(self, policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        kw = dict(policy=policy, device=device)
        self.conv1 = TorchConv(3, 64, (11, 11), strides=4, padding=2, **kw)
        self.conv2 = TorchConv(64, 192, (5, 5), padding=2, **kw)
        self.conv3 = TorchConv(192, 384, (3, 3), padding=1, **kw)
        self.conv4 = TorchConv(384, 256, (3, 3), padding=1, **kw)
        self.conv5 = TorchConv(256, 256, (3, 3), padding=1, **kw)

    def forward(self, x: torch.Tensor):
        taps = [torch.relu(self.conv1(x))]
        taps.append(torch.relu(self.conv2(max_pool_3x3_s2_valid(taps[-1]))))
        taps.append(torch.relu(self.conv3(max_pool_3x3_s2_valid(taps[-1]))))
        taps.append(torch.relu(self.conv4(taps[-1])))
        taps.append(torch.relu(self.conv5(taps[-1])))
        return taps


class _ResNet50Taps(_ResNetTrunk):
    """The resnet50 trunk (BatchNorm on its running statistics) returning
    the stem's activation and each stage's output."""

    def __init__(self, policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__(Bottleneck, (3, 4, 6, 3), policy=policy, device=device)

    def forward(self, x: torch.Tensor):
        x = torch.relu(self.bn1(self.conv1(x), False))
        taps = [x]
        x = max_pool_3x3_s2(x)
        stage = "layer1"
        for name in self.block_names:
            if not name.startswith(stage + "_"):
                taps.append(x)
                stage = name.split("_")[0]
            x = getattr(self, name)(x, False)
        taps.append(x)
        return taps


class RomePerceptualLoss(nn.Module):
    """Layer-weighted feature L1 over a chosen backbone (``net``), with
    optional per-feature instance normalisation, averaged over
    `num_scales` anti-aliased scales."""

    def __init__(self, backbone: str = "vgg19",
                 layer_weights: Optional[Tuple[float, ...]] = None,
                 num_scales: int = 1, normalize_features: bool = False,
                 policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        kw = dict(policy=policy, device=device)
        self.layer_weights = layer_weights
        self.num_scales = num_scales
        self.normalize_features = normalize_features
        self.policy = policy
        self.taps_only = False
        if backbone in ("vgg19", "vgg16"):
            self.net = VGG(backbone, VGG19_REFERENCE_TAPS, **kw)
        elif backbone == "alexnet":
            self.net = AlexNetFeatures(**kw)
        elif backbone in RESNET50_NAMES:
            self.net = _ResNet50Taps(**kw)
        elif backbone in VGGFACE_NAMES:
            self.net = InceptionResnetV1(**kw)
            self.taps_only = True
        else:
            raise ValueError(f"unknown backbone {backbone}")
        self.norm = InstanceNorm()
        _constant_buffer(self, "mean", IMAGENET_MEAN, device)
        _constant_buffer(self, "std", IMAGENET_STD, device)

    def features(self, x: torch.Tensor) -> Sequence[torch.Tensor]:
        if self.taps_only:
            return self.net(x, return_taps=True)[1]
        return self.net(x)

    def forward(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        p = self.policy
        total = torch.zeros((), dtype=torch.float32, device=pred.device)
        x, y = pred, target
        for scale in range(self.num_scales):
            if scale > 0:
                x = anti_alias_downsample(x, 0.5)
                y = anti_alias_downsample(y, 0.5)
            fx = self.features(p.cast_to_compute((x.float() - self.mean) / self.std))
            fy = self.features(p.cast_to_compute((y.float() - self.mean) / self.std))
            weights = self.layer_weights or (1.0,) * len(fx)
            for w, a, b in zip(weights, fx, fy):
                if self.normalize_features:
                    a, b = self.norm(a), self.norm(b)
                total = total + w * torch.mean(torch.abs(a.float() - b.float()))
        return total / self.num_scales
