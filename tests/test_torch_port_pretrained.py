"""The weight converter and the bundle loader against the JAX package.

* The converter, backbone by backbone (vgg19, vgg16, the lpips heads,
  resnet18, resnet50, 6DRepNet; FAN and InceptionResnetV1 in their own
  files): a synthetic original-named state_dict, drawn with numpy at the
  real shapes, goes through JAX's converters (+ ``merge_params``, bridged)
  and through the port's table. The tensors are equal, and so are the
  outputs of the two grafted modules (1e-4 of the largest magnitude).
* ``identify`` on every kind, the command line end to end (a bundle file
  that ``load_bundle`` reads back, unknown and unreadable files skipped).
* ``maybe_load_pretrained`` at TINY against JAX's ``apply_to_gbase`` /
  ``apply_to_perceptual`` on the same in-memory bundle: the report word for
  word, the leaf counts, every grafted tensor. At FULL, the counts are
  fixed (``chip_smoke.FULL_GBASE_LEAVES`` / ``FULL_PLOSS_LEAVES``), which
  chip_smoke.py checks on the card.
* A directory with only an Orbax step still raises.
"""

import os
import sys
import types

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from megaportraits_tpu.core.arch import TINY as JTINY
from megaportraits_tpu.core.dtypes import FP32_POLICY as JP
from megaportraits_tpu.losses import perceptual as jperc
from megaportraits_tpu.models import repvgg as jrepvgg
from megaportraits_tpu.models import resnet as jresnet
from megaportraits_tpu.models.gbase import Gbase as JGbase
from megaportraits_tpu.utils import pretrained as jpretrained
from megaportraits_tpu.utils import torch_convert as tc

from megaportraits_tpu_torch.core.arch import FULL, TINY
from megaportraits_tpu_torch.core.dtypes import FP32_POLICY
from megaportraits_tpu_torch.losses import perceptual
from megaportraits_tpu_torch.models import repvgg, resnet
from megaportraits_tpu_torch.models.emtn import Emtn
from megaportraits_tpu_torch.models.gbase import Gbase
from megaportraits_tpu_torch.utils import convert_weights as cw
from megaportraits_tpu_torch.utils import pretrained
from megaportraits_tpu_torch.utils.jax_bridge import jax_to_state_dict, load_jax_variables

from torch_port_utils import frozen_bn_statistics, n, numpy_fill, numpy_init, numpy_state_dict, t

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402


def _close(got, want, rel=1e-4):
    want = np.asarray(want, dtype=np.float32)
    got = n(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


class _ResNetWithFc(nn.Module):
    """torchvision's resnet layout (``trunk`` + a 1000-class ``fc``), to
    draw a synthetic original file from."""

    def __init__(self, kind):
        super().__init__()
        block = resnet.Bottleneck if kind == "resnet50" else resnet.BasicBlock
        self.trunk = resnet._ResNetTrunk(block, cw.RESNET_LAYERS[kind], policy=FP32_POLICY,
                                         device="cpu")
        self.fc = resnet.TorchDense(self.trunk.out_channels, 1000, policy=FP32_POLICY,
                                    device="cpu")


def _source_module(kind):
    """A port module holding every key of `kind`'s table."""
    kw = dict(policy=FP32_POLICY, device="cpu")
    if kind in ("vgg19", "vgg16"):
        last = len(cw.VGG_CONVS[kind]) - 1
        return perceptual.VGG(kind, taps=((last, cw.VGG_CONVS[kind][-1] - 1),), **kw)
    if kind == "lpips":
        return perceptual.LPIPS(**kw)
    if kind == "sixdrepnet":
        return repvgg.SixDRepNet(**kw)
    return _ResNetWithFc(kind)


def synthetic_original(kind, seed):
    return cw.original_state_dict(cw.table_for(kind), numpy_state_dict(_source_module(kind), seed))


def _jax_convert(kind, sd):
    """JAX's converter output as the port's state_dict keys."""
    if kind in ("vgg19", "vgg16"):
        return {"params": tc.convert_vgg_features(sd, kind)}
    if kind == "lpips":
        return {"params": tc.convert_lpips_linear_heads(sd)}
    if kind == "sixdrepnet":
        return {"params": tc.convert_sixdrepnet(sd)}
    params, stats = tc.convert_torchvision_resnet(
        sd, layers=cw.RESNET_LAYERS[kind], bottleneck=kind == "resnet50")
    return {"params": params, "batch_stats": stats}


@pytest.mark.parametrize("kind", ["vgg19", "vgg16", "lpips", "resnet18", "resnet50",
                                  "sixdrepnet"])
def test_converter_tensors_match_jax(kind):
    sd = synthetic_original(kind, seed=len(kind))
    assert cw.identify(sd) == kind
    key, converted = cw.convert(kind, sd)
    assert key == {"lpips": "lpips_heads"}.get(kind, kind)
    want = jax_to_state_dict(_jax_convert(kind, sd))
    assert converted.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(converted[k], want[k], rtol=0, atol=0)


def _grafted_outputs(kind, converted, jtree, x):
    """(port output, JAX output) of the module each bundle entry grafts."""
    if kind in ("vgg19", "vgg16"):
        taps = jperc.VGG19_REFERENCE_TAPS if kind == "vgg19" else jperc.LPIPS_TAPS
        jm = jperc.VGG(cfg=kind, taps=taps, policy=JP)
        jv = tc.merge_params(numpy_init(jm, jnp.asarray(x))["params"], jtree["params"])
        want = jax.jit(jm.apply)({"params": jv}, jnp.asarray(x))
        port = perceptual.VGG(kind, taps, policy=FP32_POLICY, device="cpu")
        port.load_state_dict({k: v for k, v in converted.items()
                              if k in port.state_dict()})
        return port(t(x)), want
    if kind == "sixdrepnet":
        jm = jrepvgg.SixDRepNet(policy=JP)
        jv = tc.merge_params(numpy_init(jm, jnp.asarray(x))["params"], jtree["params"])
        want = jax.jit(jm.apply)({"params": jv}, jnp.asarray(x))[0]
        port = repvgg.SixDRepNet(policy=FP32_POLICY, device="cpu")
        port.load_state_dict(converted)
        return port(t(x))[0], want
    block = jresnet.Bottleneck if kind == "resnet50" else jresnet.BasicBlock
    jm = jresnet._ResNetTrunk(block, cw.RESNET_LAYERS[kind], policy=JP)
    want = jax.jit(lambda v, x: jm.apply(v, x, False))(
        {"params": jtree["params"]["trunk"], "batch_stats": jtree["batch_stats"]["trunk"]},
        jnp.asarray(x))
    port = _ResNetWithFc(kind)
    port.load_state_dict(converted)
    return port.trunk(t(x), False), want


@pytest.mark.parametrize("kind", ["vgg19", "vgg16", "resnet18", "resnet50", "sixdrepnet"])
def test_converted_modules_match_jax(kind):
    sd = synthetic_original(kind, seed=len(kind))
    _, converted = cw.convert(kind, sd)
    jtree = _jax_convert(kind, sd)
    x = np.random.default_rng(0).uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    got, want = _grafted_outputs(kind, converted, jtree, x)
    if isinstance(want, (list, tuple)):
        for a, b in zip(got, want, strict=True):
            _close(a, b)
    else:
        _close(got, want)


def test_lpips_heads_graft_matches_jax():
    """The heads with the VGG16 trunk: the whole LPIPS of both packages."""
    vgg16, heads = synthetic_original("vgg16", 1), synthetic_original("lpips", 2)
    heads = {k.replace("lins.", "lin"): v for k, v in heads.items()}  # the other spelling
    assert cw.identify(heads) == "lpips"
    x, y = (np.random.default_rng(s).uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
            for s in (3, 4))
    jm = jperc.LPIPS(policy=JP)
    init = numpy_init(jm, jnp.asarray(x), jnp.asarray(y))["params"]
    jv = tc.merge_params(init, {"vgg16": tc.convert_vgg_features(vgg16, "vgg16"),
                                **tc.convert_lpips_linear_heads(heads)})
    want = jax.jit(jm.apply)({"params": jv}, jnp.asarray(x), jnp.asarray(y))
    port = perceptual.LPIPS(policy=FP32_POLICY, device="cpu")
    port.vgg16.load_state_dict(cw.convert("vgg16", vgg16)[1])
    port.load_state_dict(cw.convert("lpips", heads)[1], strict=False)
    _close(port(t(x), t(y)), want, 1e-5)


def test_identify_matches_jax():
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import convert_weights as jconvert

    for kind in ("vgg19", "vgg16", "lpips", "resnet18", "resnet50", "sixdrepnet"):
        sd = synthetic_original(kind, 0)
        assert cw.identify(sd) == jconvert.identify(sd) == kind
        if kind.startswith("vgg"):
            bare = {k[len("features."):]: v for k, v in sd.items()}
            assert cw.identify(bare) == jconvert.identify(bare) == f"{kind}_features_only"
            assert cw.convert(cw.identify(bare), bare)[1].keys() == cw.convert(kind, sd)[1].keys()
    assert cw.identify({"x.weight": torch.zeros(1)}) == jconvert.identify({"x.weight": 0}) \
        == "unknown"
    with pytest.raises(KeyError, match="lacks"):
        cw.convert("resnet18", {"conv1.weight": torch.zeros(1)})


def test_command_line_writes_a_bundle(tmp_path, capsys):
    wd = tmp_path / "weights"
    wd.mkdir()
    vgg16 = synthetic_original("vgg16", 5)
    torch.save({k[len("features."):]: v for k, v in vgg16.items()}, wd / "trunk16.pth")
    torch.save(synthetic_original("lpips", 6), wd / "lpips_vgg.pth")
    r18 = synthetic_original("resnet18", 7)
    torch.save({"state_dict": {**{f"module.{k}": v for k, v in r18.items()},
                               "module.bn1.num_batches_tracked": torch.tensor(3)}},
               wd / "rn18.pt")
    torch.save({"x.weight": torch.zeros(2)}, wd / "other.pth")
    (wd / "broken.pth").write_bytes(b"not a checkpoint")
    out = tmp_path / "bundle"
    assert cw.main(["--weights-dir", str(wd), "--out", str(out)]) == 0
    text = capsys.readouterr().out
    assert "SKIP broken.pth" in text and "SKIP other.pth: unrecognized state_dict" in text
    assert "saved bundle (['lpips_heads', 'resnet18', 'vgg16'])" in text
    bundle = pretrained.load_bundle(str(out))
    assert sorted(bundle) == ["lpips_heads", "resnet18", "vgg16"]
    for key, kind, sd in (("vgg16", "vgg16", vgg16), ("resnet18", "resnet18", r18)):
        want = cw.convert(kind, sd)[1]
        assert bundle[key].keys() == want.keys()
        assert all(torch.equal(bundle[key][k], want[k]) for k in want)
    assert cw.main(["--weights-dir", str(tmp_path / "empty"), "--out", str(out)]) == 1


def test_load_bundle_cases(tmp_path):
    assert pretrained.load_bundle(str(tmp_path / "missing")) is None
    assert pretrained.load_bundle(str(tmp_path)) is None  # a directory without one
    (tmp_path / "0").mkdir()  # an Orbax step, and nothing the port reads
    with pytest.raises(NotImplementedError, match="convert_weights"):
        pretrained.load_bundle(str(tmp_path))
    with pytest.raises(NotImplementedError, match="no loader"):
        pretrained.maybe_load_pretrained(str(tmp_path))
    torch.save({"vgg16": {}}, tmp_path / cw.BUNDLE_FILE)  # the port's file wins
    assert pretrained.load_bundle(str(tmp_path)) == {"vgg16": {}}


# -- the loader at TINY, against JAX --------------------------------------------

SIZE = 64


def _tiny_bundle(gv, pv):
    """A JAX bundle at TINY shapes drawn with numpy: every backbone the
    loader grafts, plus a key no model has and a 1000-class fc the heads
    must not take."""
    me = gv["params"]["motion_encoder"]
    r18_params = numpy_fill(me["head_pose_net"], 11)
    width = me["head_pose_net"]["fc"]["Dense_0"]["kernel"].shape[0]
    r18_params["fc"] = {"Dense_0": {"kernel": np.ones((width, 1000), np.float32),
                                    "bias": np.zeros(1000, np.float32)}}
    stats = numpy_fill(gv["batch_stats"]["motion_encoder"]["head_pose_net"], 12)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: np.abs(a) + 0.5 if str(p[-1].key) == "var" else a, stats)
    vgg19 = numpy_fill(pv["params"]["vgg19"], 13)
    vgg19["conv9_1"] = {"Conv_0": {"kernel": np.ones((3, 3, 1, 1), np.float32)}}
    return {
        "vgg19": vgg19,
        "vgg16": numpy_fill(pv["params"]["lpips"]["vgg16"], 14),
        "lpips_heads": numpy_fill({k: v for k, v in pv["params"]["lpips"].items()
                                   if k.startswith("lin")}, 15),
        "vggface": frozen_bn_statistics(numpy_fill(pv["params"]["vggface"], 16), 17),
        "sixdrepnet": numpy_fill(me["rotation_net"], 18),
        "resnet18": {"params": r18_params, "batch_stats": stats},
    }


def _port_bundle(jbundle):
    return {k: jax_to_state_dict(v if k == "resnet18" else {"params": v})
            for k, v in jbundle.items()}


def test_maybe_load_pretrained_matches_jax_at_tiny(tmp_path, capsys):
    x = jnp.zeros((1, SIZE, SIZE, 3), jnp.float32)
    jg = JGbase(policy=JP, arch=JTINY)
    gv = numpy_init(jg, x, x, seed=0, stats_seed=1)
    jp = jperc.PerceptualLoss(use_vggface=True, policy=JP, arch=JTINY)
    pv = frozen_bn_statistics(numpy_init(jp, x, x, seed=2), 3)
    gbase = load_jax_variables(Gbase(policy=FP32_POLICY, arch=TINY, device="cpu"), gv)
    ploss = load_jax_variables(perceptual.PerceptualLoss(
        policy=FP32_POLICY, arch=TINY, device="cpu", use_vggface=True), pv)

    jbundle = _tiny_bundle(gv, pv)
    new_gv, n_g = jpretrained.apply_to_gbase(gv, jbundle)
    new_pv, n_p = jpretrained.apply_to_perceptual(pv, jbundle)
    want_report = f"pretrained: gbase leaves={n_g}, ploss leaves={n_p}"
    torch.save(_port_bundle(jbundle), tmp_path / cw.BUNDLE_FILE)
    _, _, report = pretrained.maybe_load_pretrained(str(tmp_path), gbase, ploss)
    assert report == want_report
    assert n_g > 0 and n_p > 0
    for module, variables in ((gbase, new_gv), (ploss, new_pv)):
        want = jax_to_state_dict(variables)
        got = module.state_dict()
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k].to(got[k].dtype)), k
    # The heads' fc stayed as it was.
    assert torch.equal(gbase.motion_encoder.head_pose_net.fc.weight,
                       jax_to_state_dict(gv)["motion_encoder.head_pose_net.fc.weight"])


def test_init_states_grafts_a_port_bundle(tmp_path, capsys):
    """The stage-1 driver's init_states prints the report of the graft."""
    from megaportraits_tpu_torch.core.config import Config
    from megaportraits_tpu_torch.train.train_base import init_states

    cfg = Config()
    cfg.model.arch = "tiny"
    cfg.training.pretrained_path = str(tmp_path)
    model = perceptual.build_perceptual_loss("tiny", policy=FP32_POLICY, device="cpu", seed=9)
    torch.save({"vgg19": {k: v + 1.0 for k, v in model.vgg19.state_dict().items()}},
               tmp_path / cw.BUNDLE_FILE)
    _, _, ploss, _, _ = init_states(cfg, policy=FP32_POLICY, device="cpu")
    n_leaves = len(model.vgg19.state_dict())
    assert capsys.readouterr().out.splitlines() == [
        f"pretrained: gbase leaves=0, ploss leaves={n_leaves}"]
    for k, v in model.vgg19.state_dict().items():
        assert torch.equal(ploss.vgg19.state_dict()[k], v + 1.0)


def test_full_leaf_counts():
    """A bundle of every grafted backbone at FULL width into FULL's Emtn
    and PerceptualLoss(use_vggface=True): the counts chip_smoke.py checks."""
    from megaportraits_tpu_torch.losses.vggface import InceptionResnetV1

    emtn = Emtn(policy=FP32_POLICY, arch=FULL, device="cpu")
    ploss = perceptual.PerceptualLoss(policy=FP32_POLICY, arch=FULL, device="cpu",
                                      use_vggface=True)
    bundle = {kind_key: cw.convert(kind, synthetic_original(kind, 0))[1]
              for kind, kind_key in (("vgg19", "vgg19"), ("vgg16", "vgg16"),
                                     ("lpips", "lpips_heads"), ("resnet18", "resnet18"),
                                     ("sixdrepnet", "sixdrepnet"))}
    bundle["vggface"] = InceptionResnetV1(policy=FP32_POLICY, device="cpu").state_dict()
    n_g = pretrained.apply_to_gbase(types.SimpleNamespace(motion_encoder=emtn), bundle)
    n_p = pretrained.apply_to_perceptual(ploss, bundle)
    assert (n_g, n_p) == (chip_smoke.FULL_GBASE_LEAVES, chip_smoke.FULL_PLOSS_LEAVES)
