"""Original pretrained checkpoints -> the port's bundle (counterpart of
``scripts/convert_weights.py`` and the converters it calls).

    python -m megaportraits_tpu_torch.utils.convert_weights --weights-dir D --out P

Reads every ``*.pth`` / ``*.pt`` state_dict in D, identifies its backbone by
key signature (``identify``: file names do not matter), renames its tensors
onto the port's modules and writes one file, ``P/torch_bundle.pt``: a
``torch.save`` of ``{backbone: state_dict}`` under the JAX bundle's keys
(vgg19, vgg16, lpips_heads, vggface, sixdrepnet, fan, resnet18, resnet50),
which ``utils/pretrained.load_bundle`` reads.

Which file to put in D for each backbone:
  vgg19, vgg16  torchvision vgg{19,16}(pretrained).features.state_dict()
                (or the whole model's state_dict)
  lpips heads   lpips.LPIPS(net='vgg').state_dict()
  vggface       facenet_pytorch InceptionResnetV1(pretrained='vggface2')
  sixdrepnet    6DRepNet_300W_LP_AFLW2000.pth (deploy-mode RepVGG-B1g2)
  fan           face_alignment's 2DFAN-4 checkpoint
  resnet18/50   torchvision resnet{18,50}(pretrained).state_dict()

The port's convs keep torch's OIHW layout, so a conversion is a renaming:
each backbone has a table, original key -> port key (``table_for``). The
tables are data, so a synthetic original file can be written from any port
module (``original_state_dict``), as the tests and chip_smoke.py do. No
golden activation check is made here: it needs the original model code.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
from typing import Dict, Optional, Sequence, Tuple

import torch

BUNDLE_FILE = "torch_bundle.pt"
BN_LEAVES = ("weight", "bias", "running_mean", "running_var")
VGG_CONVS = {"vgg16": (2, 2, 3, 3, 3), "vgg19": (2, 2, 4, 4, 4)}
RESNET_LAYERS = {"resnet18": (2, 2, 2, 2), "resnet50": (3, 4, 6, 3)}
SIXDREPNET_BLOCKS = (4, 6, 16, 1)

Table = Dict[str, str]


def identify(sd: dict) -> str:
    """The backbone of a state_dict, by its key signature (the JAX
    package's rules, in their order)."""
    keys = set(sd.keys())
    if "linear_reg.weight" in keys and "layer0.rbr_reparam.weight" in keys:
        return "sixdrepnet"
    if "m0.b1_4.bn1.weight" in keys:
        return "fan"
    if "lins.0.model.1.weight" in keys or "lin0.model.1.weight" in keys:
        return "lpips"
    if "conv2d_1a.conv.weight" in keys and "last_linear.weight" in keys:
        return "vggface"
    if "features.34.weight" in keys:
        return "vgg19"
    if "features.28.weight" in keys:
        return "vgg16"
    if "34.weight" in keys:
        return "vgg19_features_only"
    if "28.weight" in keys:
        return "vgg16_features_only"
    if "layer1.0.conv1.weight" in keys:
        return "resnet50" if "layer1.0.conv3.weight" in keys else "resnet18"
    return "unknown"


# -- the tables: original key -> port key ------------------------------------


def _bn(table: Table, src: str, dst: str) -> None:
    for leaf in BN_LEAVES:
        table[f"{src}.{leaf}"] = f"{dst}.{leaf}"


def vgg_table(cfg: str) -> Table:
    """torchvision ``features.{i}`` -> ``conv{stage}_{k}`` of losses/perceptual.VGG."""
    table, layer = {}, 0
    for stage, n_convs in enumerate(VGG_CONVS[cfg]):
        for i in range(n_convs):
            for leaf in ("weight", "bias"):
                table[f"features.{layer}.{leaf}"] = f"conv{stage + 1}_{i + 1}.{leaf}"
            layer += 2  # conv + relu
        layer += 1  # max pool
    return table


def lpips_table() -> Table:
    """lpips' ``lins.{i}.model.1`` -> LPIPS's ``lin{i}``."""
    return {f"lins.{i}.model.1.weight": f"lin{i}.weight" for i in range(5)}


def resnet_table(kind: str) -> Table:
    """torchvision resnet18/50 -> models/resnet.ResNet18's layout
    (``trunk.layer{s}_block{i}``, ``fc``)."""
    bottleneck = kind == "resnet50"
    table = {"conv1.weight": "trunk.conv1.weight"}
    _bn(table, "bn1", "trunk.bn1")
    for stage, n_blocks in enumerate(RESNET_LAYERS[kind]):
        for block in range(n_blocks):
            src, dst = f"layer{stage + 1}.{block}", f"trunk.layer{stage + 1}_block{block}"
            for c in range(1, 4 if bottleneck else 3):
                table[f"{src}.conv{c}.weight"] = f"{dst}.conv{c}.weight"
                _bn(table, f"{src}.bn{c}", f"{dst}.bn{c}")
            if block == 0 and (stage > 0 or bottleneck):
                table[f"{src}.downsample.0.weight"] = f"{dst}.downsample_conv.weight"
                _bn(table, f"{src}.downsample.1", f"{dst}.downsample_bn")
    table["fc.weight"], table["fc.bias"] = "fc.weight", "fc.bias"
    return table


def sixdrepnet_table() -> Table:
    """Deploy-mode 6DRepNet (``layer0``, ``layer{s}.{i}.rbr_reparam``) ->
    models/repvgg.SixDRepNet (``trunk.stage{s}_block{i}``)."""
    table = {}
    blocks = [("layer0", "trunk.stage0")] + [
        (f"layer{s + 1}.{i}", f"trunk.stage{s + 1}_block{i}")
        for s, n in enumerate(SIXDREPNET_BLOCKS) for i in range(n)]
    for src, dst in blocks:
        for leaf in ("weight", "bias"):
            table[f"{src}.rbr_reparam.{leaf}"] = f"{dst}.rbr_reparam.{leaf}"
    table["linear_reg.weight"], table["linear_reg.bias"] = "linear_reg.weight", "linear_reg.bias"
    return table


def inception_table() -> Table:
    """facenet_pytorch InceptionResnetV1 -> losses/vggface.InceptionResnetV1
    (``repeat_1.0.branch1.0`` -> ``repeat_1_0.branch1_0``)."""
    table = {}

    def basic(src, dst):
        table[f"{src}.conv.weight"] = f"{dst}.conv.weight"
        _bn(table, f"{src}.bn", f"{dst}.bn")

    def block(src, dst, branches, residual=True):
        for name in branches:
            basic(f"{src}.{name}", f"{dst}.{name.replace('.', '_')}")
        if residual:
            for leaf in ("weight", "bias"):
                table[f"{src}.conv2d.{leaf}"] = f"{dst}.conv2d.{leaf}"

    for name in ("conv2d_1a", "conv2d_2a", "conv2d_2b", "conv2d_3b", "conv2d_4a",
                 "conv2d_4b"):
        basic(name, name)
    b35 = ("branch0", "branch1.0", "branch1.1", "branch2.0", "branch2.1", "branch2.2")
    b17_b8 = ("branch0", "branch1.0", "branch1.1", "branch1.2")
    for i in range(5):
        block(f"repeat_1.{i}", f"repeat_1_{i}", b35)
    block("mixed_6a", "mixed_6a", b17_b8, residual=False)
    for i in range(10):
        block(f"repeat_2.{i}", f"repeat_2_{i}", b17_b8)
    block("mixed_7a", "mixed_7a", ("branch0.0", "branch0.1", "branch1.0", "branch1.1",
                                    "branch2.0", "branch2.1", "branch2.2"), residual=False)
    for i in range(5):
        block(f"repeat_3.{i}", f"repeat_3_{i}", b17_b8)
    block("block8", "block8", b17_b8)
    table["last_linear.weight"] = "last_linear.weight"
    _bn(table, "last_bn", "last_bn")
    return table


def fan_table(num_modules: int) -> Table:
    """face_alignment 2DFAN-N -> models/fan.FAN (the same names, but a
    ConvBlock's ``downsample.0`` / ``downsample.2`` are ``down_bn`` /
    ``down_conv``)."""
    table = {}

    def conv(name, bias=True):
        for leaf in ("weight", "bias") if bias else ("weight",):
            table[f"{name}.{leaf}"] = f"{name}.{leaf}"

    def convblock(name, down=False):
        for k in (1, 2, 3):
            _bn(table, f"{name}.bn{k}", f"{name}.bn{k}")
            conv(f"{name}.conv{k}", bias=False)
        if down:
            _bn(table, f"{name}.downsample.0", f"{name}.down_bn")
            table[f"{name}.downsample.2.weight"] = f"{name}.down_conv.weight"

    conv("conv1")
    _bn(table, "bn1", "bn1")
    convblock("conv2", down=True)
    convblock("conv3")
    convblock("conv4", down=True)
    for i in range(num_modules):
        for lvl in (4, 3, 2, 1):
            for b in (1, 2, 3):
                convblock(f"m{i}.b{b}_{lvl}")
        convblock(f"m{i}.b2_plus_1")
        convblock(f"top_m_{i}")
        conv(f"conv_last{i}")
        _bn(table, f"bn_end{i}", f"bn_end{i}")
        conv(f"l{i}")
        if i < num_modules - 1:
            conv(f"bl{i}")
            conv(f"al{i}")
    return table


def fan_modules(keys) -> int:
    """The number of hourglass stacks of a 2DFAN state_dict (original or
    converted: the names of the stacks are the same)."""
    n = 0
    while f"m{n}.b1_4.bn1.weight" in keys:
        n += 1
    return n


def bundle_key(kind: str) -> str:
    """The bundle key of a kind ``identify`` names."""
    return "lpips_heads" if kind == "lpips" else kind


def table_for(kind: str, num_modules: int = 4) -> Table:
    """The table of a kind ``identify`` names (FAN's for `num_modules`
    hourglass stacks)."""
    if kind in ("vgg19", "vgg16"):
        return vgg_table(kind)
    if kind == "lpips":
        return lpips_table()
    if kind == "vggface":
        return inception_table()
    if kind == "sixdrepnet":
        return sixdrepnet_table()
    if kind == "fan":
        return fan_table(num_modules)
    if kind in RESNET_LAYERS:
        return resnet_table(kind)
    raise ValueError(f"cannot convert backbone kind {kind!r}")


def _canonical(kind: str, sd: dict) -> Tuple[str, dict]:
    """(kind, sd) with the key spellings the tables use: a bare VGG
    features file gains 'features.', lpips' ``lin{i}`` becomes
    ``lins.{i}``."""
    if kind.endswith("_features_only"):
        return kind[:-len("_features_only")], {f"features.{k}": v for k, v in sd.items()}
    if kind == "lpips":
        return kind, {(f"lins.{k[3:]}" if k.startswith("lin") and k[3:4].isdigit() else k): v
                      for k, v in sd.items()}
    return kind, sd


def convert(kind: str, sd: dict) -> Tuple[str, Dict[str, torch.Tensor]]:
    """(bundle key, the port's state_dict) of an original state_dict of
    `kind`. Every key of the table must be there (``KeyError``); other
    keys (a classifier, ``num_batches_tracked``) are left out."""
    kind, sd = _canonical(kind, sd)
    table = table_for(kind, fan_modules(sd))
    missing = [k for k in table if k not in sd]
    if missing:
        raise KeyError(f"{kind} state_dict lacks {len(missing)} keys, e.g. {missing[:3]}")
    return bundle_key(kind), {port: sd[orig].detach().clone() for orig, port in table.items()}


def original_state_dict(table: Table, port_state: Dict[str, torch.Tensor]) -> dict:
    """The original-named state_dict that ``convert`` turns back into
    `port_state` (a port module's state_dict that holds every table key)."""
    return {orig: port_state[port].detach().cpu().clone() for orig, port in table.items()}


def load_state_dict(path: str) -> dict:
    """A checkpoint's state_dict, with 'state_dict' unwrapped and DataParallel's
    'module.' prefixes removed (tensors only: no pickled code runs)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k.replace("module.", ""): v for k, v in sd.items()}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--weights-dir", required=True)
    ap.add_argument("--out", default="pretrained")
    args = ap.parse_args(argv)

    files = sorted(glob.glob(os.path.join(args.weights_dir, "*.pth"))
                   + glob.glob(os.path.join(args.weights_dir, "*.pt")))
    if not files:
        print(f"no .pth/.pt files in {args.weights_dir}", file=sys.stderr)
        return 1
    bundle = {}
    for path in files:
        name = os.path.basename(path)
        try:
            sd = load_state_dict(path)
        except Exception as e:  # an unreadable file: report it, go on
            print(f"SKIP {name}: {e}")
            continue
        kind = identify(sd)
        if kind == "unknown":
            print(f"SKIP {name}: unrecognized state_dict")
            continue
        key, tensors = convert(kind, sd)
        bundle[key] = tensors
        print(f"{name:30s} -> {key:12s} converted ({len(bundle[key])} tensors)")
    if not bundle:
        print("nothing converted", file=sys.stderr)
        return 1
    os.makedirs(args.out, exist_ok=True)
    torch.save(bundle, os.path.join(args.out, BUNDLE_FILE))
    print(f"saved bundle ({sorted(bundle)}) to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
