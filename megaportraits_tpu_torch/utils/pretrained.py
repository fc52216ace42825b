"""The pretrained bundle: load it and graft it into the models (counterpart
of ``megaportraits_tpu/utils/pretrained.py``).

The bundle is ``<path>/torch_bundle.pt``, written by
``utils/convert_weights.py`` from the original ``.pth`` files: a dict
``{backbone: state_dict}`` under the port's module names, with keys among
vgg19, vgg16, lpips_heads, vggface, sixdrepnet, fan, resnet18, resnet50.

Grafting targets, as in JAX:
  * PerceptualLoss: the VGG19 trunk, LPIPS (VGG16 trunk and lin heads) and
    the identity net (vggface);
  * Gbase: Emtn's frozen SixDRepNet (``motion_encoder.rotation_net``) and
    the resnet18 trunks of the head-pose and expression nets, their running
    statistics too (their ``fc`` stays fresh: the reference replaces it).
The merge is loose: keys the target lacks are skipped, a shape mismatch
raises. The counts in the report are JAX's: the leaves of its 'params'
collection that were written, i.e. the port's parameters (BatchNorm
running statistics, JAX's 'batch_stats', are grafted but not counted).

JAX's bundle is an Orbax checkpoint, which the port cannot read (the
card's machine has no Orbax): a directory that holds only an Orbax step
raises ``NotImplementedError`` naming the converter, so that nothing trains
on random weights that were meant to be pretrained.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch
from torch import nn

from megaportraits_tpu_torch.utils.convert_weights import BUNDLE_FILE

CONVERTER = "python -m megaportraits_tpu_torch.utils.convert_weights"


def _holds_orbax_step(path: str) -> bool:
    """Whether `path` holds a bundle as JAX's ``load_bundle`` finds one: a
    subdirectory named by an integer (an Orbax step)."""
    return any(name.isdigit() and os.path.isdir(os.path.join(path, name))
               for name in os.listdir(path))


def load_bundle(path: str) -> Optional[Dict[str, Any]]:
    """The bundle dict at `path` (on the CPU), or None when there is none.
    Raises NotImplementedError where only JAX's Orbax bundle is."""
    path = os.path.abspath(path)
    if not os.path.isdir(path):
        return None
    file = os.path.join(path, BUNDLE_FILE)
    if os.path.isfile(file):
        return torch.load(file, map_location="cpu", weights_only=True)
    if _holds_orbax_step(path):
        raise NotImplementedError(
            f"{path} holds the JAX package's Orbax bundle, and the port has no loader "
            f"for it: convert the original .pth files with `{CONVERTER} --weights-dir "
            f"<dir of .pth files> --out {path}`")
    return None


def merge_loose(module: nn.Module, source: Dict[str, torch.Tensor],
                prefix: str = "", where: str = "") -> int:
    """Copy the tensors of `source` whose key (after `prefix`) names a
    parameter or buffer of `module`; unknown keys are skipped, a shape
    mismatch raises ValueError. Returns the number of parameters written."""
    params = dict(module.named_parameters())
    targets = {**dict(module.named_buffers()), **params}
    n = 0
    with torch.no_grad():
        for key, value in source.items():
            if not key.startswith(prefix) or key[len(prefix):] not in targets:
                continue
            name = key[len(prefix):]
            target = targets[name]
            if tuple(target.shape) != tuple(value.shape):
                raise ValueError(f"shape mismatch at {where}/{name}: "
                                 f"{tuple(target.shape)} vs {tuple(value.shape)}")
            target.copy_(value)
            n += name in params
    return n


def apply_to_perceptual(ploss: nn.Module, bundle: Dict[str, Any]) -> int:
    """Graft vgg19 / vgg16 + lpips_heads / vggface into a PerceptualLoss in
    place; returns the number of parameters written."""
    n = 0
    if "vgg19" in bundle and getattr(ploss, "vgg19", None) is not None:
        n += merge_loose(ploss.vgg19, bundle["vgg19"], where="vgg19")
    if getattr(ploss, "lpips", None) is not None:
        if "vgg16" in bundle:
            n += merge_loose(ploss.lpips.vgg16, bundle["vgg16"], where="lpips/vgg16")
        if "lpips_heads" in bundle:
            n += merge_loose(ploss.lpips, bundle["lpips_heads"], where="lpips")
    if "vggface" in bundle and getattr(ploss, "vggface", None) is not None:
        n += merge_loose(ploss.vggface, bundle["vggface"], where="vggface")
    return n


def apply_to_gbase(gbase: nn.Module, bundle: Dict[str, Any]) -> int:
    """Graft SixDRepNet and the resnet18 trunks (with their running
    statistics) into a Gbase in place; returns the number of parameters
    written."""
    emtn = gbase.motion_encoder
    n = 0
    if "sixdrepnet" in bundle:
        n += merge_loose(emtn.rotation_net, bundle["sixdrepnet"], where="rotation_net")
    if "resnet18" in bundle:
        r18 = bundle["resnet18"]
        # The trunks only: the heads' fc stays at its fresh init.
        n += merge_loose(emtn.head_pose_net.trunk, r18, prefix="trunk.",
                         where="head_pose_net/trunk")
        n += merge_loose(emtn.expression_net, r18, prefix="trunk.", where="expression_net")
    return n


def maybe_load_pretrained(bundle_path: Optional[str], gbase: Optional[nn.Module] = None,
                          ploss: Optional[nn.Module] = None):
    """Load the bundle at `bundle_path` and graft it into whichever models
    are given. Returns (gbase, ploss, report), the report word for word
    JAX's."""
    if not bundle_path:
        return gbase, ploss, "pretrained: none"
    bundle = load_bundle(bundle_path)
    if bundle is None:
        return gbase, ploss, f"pretrained: no bundle at {bundle_path}"
    parts = []
    if gbase is not None:
        parts.append(f"gbase leaves={apply_to_gbase(gbase, bundle)}")
    if ploss is not None:
        parts.append(f"ploss leaves={apply_to_perceptual(ploss, bundle)}")
    return gbase, ploss, "pretrained: " + ", ".join(parts)
