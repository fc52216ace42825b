"""Kernel K4 (``ops/kernels/bn_act.py``): eval-mode BatchNorm (+ residual) (+
ReLU) in one pass, and the blocks' ``BatchNormEpilogue`` that calls it.

On the CPU: the plain version against the modules' own BatchNorm chain
(float32, within float32 reassociation: ``((y - m) * r) * w + b`` against
``(y - m) * (w * r) + b``), the kernels' gate ``kernel_engages``, the
operand cache, and the call sites of G2d, Genh and Emtn with the gate opened
on the CPU (where ``bn_act`` runs its plain version). The kernel itself is held against the
plain version on the card in tests/test_torch_port_cuda.py.
"""

import types

import pytest
import torch

from megaportraits_tpu_torch.core.arch import TINY
from megaportraits_tpu_torch.core.dtypes import FP32_POLICY
from megaportraits_tpu_torch.models.emtn import Emtn
from megaportraits_tpu_torch.models.g2d import G2d
from megaportraits_tpu_torch.models.genh import Genh
from megaportraits_tpu_torch.models.resnet import BasicBlock
from megaportraits_tpu_torch.nn import blocks
from megaportraits_tpu_torch.nn.layers import (
    BatchNorm,
    calibrate_batch_norm_with,
    init_parameters,
)
from megaportraits_tpu_torch.ops.kernels import bn_act as k4
from megaportraits_tpu_torch.utils import profiling

from torch_port_utils import engaged_on_cpu  # noqa: F401  (a fixture)

# float32 reassociation of a BatchNorm and a sum: a few float32 ulps.
REASSOCIATION = dict(atol=1e-5, rtol=1e-5)


def _randomize_batch_norms(module, seed):
    """Weights, biases and running statistics away from 1 and 0, so that a
    mix-up of operands shows."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for bn in module.modules():
            if isinstance(bn, BatchNorm):
                c = bn.weight.shape[0]
                bn.weight.copy_(torch.rand(c, generator=gen) + 0.5)
                bn.bias.copy_(torch.randn(c, generator=gen) * 0.2)
                bn.running_mean.copy_(torch.randn(c, generator=gen) * 0.3)
                bn.running_var.copy_(torch.rand(c, generator=gen) + 0.3)
    return module


def _batch_norm(c, seed):
    return _randomize_batch_norms(BatchNorm(c, policy=FP32_POLICY), seed).eval()


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("form", ["none", "identity", "shortcut"])
def test_bn_act_plain_equals_the_batch_norm_chain(form, relu):
    gen = torch.Generator().manual_seed(1)
    y = torch.randn(2, 5, 6, 24, generator=gen)
    r = torch.randn(2, 5, 6, 24, generator=gen)
    bn, bn_r = _batch_norm(24, 2), _batch_norm(24, 3)
    want = bn(y, False)
    ops = list(blocks.fold_batch_norm(bn))
    if form == "identity":
        want = want + r
        ops += [r]
    elif form == "shortcut":
        want = want + bn_r(r, False)
        ops += [r, *blocks.fold_batch_norm(bn_r)]
    want = torch.relu(want) if relu else want
    got = k4.bn_act_plain(y, *ops, relu=relu)
    torch.testing.assert_close(got, want, **REASSOCIATION)
    assert got.dtype == y.dtype
    # The wrapper runs the plain version on a CPU tensor, and counts nothing.
    before = k4.bn_act.launches
    torch.testing.assert_close(k4.bn_act(y, *ops, relu=relu), got, atol=0, rtol=0)
    assert k4.bn_act.launches == before


def test_bn_act_plain_rounds_once_to_bf16():
    gen = torch.Generator().manual_seed(4)
    y = torch.randn(3, 4, 16, generator=gen).bfloat16()
    r = torch.randn(3, 4, 16, generator=gen).bfloat16()
    ops = [*blocks.fold_batch_norm(_batch_norm(16, 5)), r,
           *blocks.fold_batch_norm(_batch_norm(16, 6))]
    got = k4.bn_act_plain(y, *ops)
    (m1, s1, b1), (m2, s2, b2) = ops[:3], ops[4:]
    f32 = torch.relu((y.float() - m1) * s1 + b1 + (r.float() - m2) * s2 + b2)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, f32.bfloat16())


def test_bn_act_rejects_what_it_does_not_take():
    y = torch.zeros(2, 4, 16)
    ops = [torch.zeros(16)] * 3
    with pytest.raises(ValueError, match=r"operands must be \[16\]"):
        k4.bn_act(y, torch.zeros(8), *ops[1:])
    with pytest.raises(ValueError, match="residual must be"):
        k4.bn_act(y, *ops, torch.zeros(2, 4, 8))
    with pytest.raises(ValueError, match="need a residual"):
        k4.bn_act(y, *ops, None, *ops)
    with pytest.raises(ValueError, match="together"):
        k4.bn_act(y, *ops, y, ops[0])
    with pytest.raises(ValueError, match="no kernel for device"):
        k4.bn_act(y.to("meta"), *(t.to("meta") for t in ops))


def _fake(shape=(2, 4, 4, 64), device="cuda", dtype=torch.bfloat16, grad=False):
    """What the gate reads of a tensor, without a card."""
    return types.SimpleNamespace(shape=shape, device=torch.device(device), dtype=dtype,
                                 requires_grad=grad)


@pytest.mark.parametrize("case,engaged", [
    ("bf16 on cuda, eval", True),
    ("cpu", False),
    ("float32", False),
    ("train", False),
    ("C % 8 != 0", True),
    ("y requires grad, grad on", False),
    ("y requires grad, grad off", True),
    ("residual requires grad, grad on", False),
    ("batch norm weight requires grad, grad on", False),
    ("batch norm weight frozen, grad on", True),
])
def test_k4_engages_by_device_dtype_train_and_autograd(case, engaged):
    y, r = _fake(), _fake()
    bn = _batch_norm(64, 0)
    bn.requires_grad_(False)
    train, grad = False, False
    if case == "cpu":
        r = _fake(device="cpu")
    elif case == "float32":
        y = _fake(dtype=torch.float32)
    elif case == "train":
        train = True
    elif case == "C % 8 != 0":  # not the gate's to decide: bn_act raises on it
        y = r = _fake(shape=(2, 4, 4, 12))
    elif case.startswith("y requires grad"):
        y, grad = _fake(grad=True), case.endswith("grad on")
    elif case.startswith("residual requires grad"):
        r, grad = _fake(grad=True), True
    elif case.startswith("batch norm weight requires grad"):
        bn.weight.requires_grad_(True)
        grad = True
    elif case.startswith("batch norm weight frozen"):
        grad = True
    with torch.set_grad_enabled(grad):
        sources = [bn.weight, bn.bias, bn.running_mean, bn.running_var]
        assert blocks.kernel_engages(train, [y, r], sources) is engaged


def _old_resblock2d(block, x, train):
    """ResBlock2D's norm-'batch' plain path as it was before the epilogues."""
    identity = x
    if block.in_channels != block.out_channels:
        identity = block.shortcut_bn(block.shortcut_conv(x), train)
    out = torch.relu(block.bn1(block.conv1(x), train))
    out = block.bn2(block.conv2(out), train)
    return torch.relu(out + identity)


def _old_basic_block(block, x, train):
    out = torch.relu(block.bn1(block.conv1(x), train))
    out = block.bn2(block.conv2(out), train)
    identity = x
    if block.has_downsample:
        identity = block.downsample_bn(block.downsample_conv(x), train)
    return torch.relu(out + identity)


@pytest.mark.parametrize("block", ["resblock2d identity", "resblock2d shortcut",
                                   "basic identity", "basic downsample"])
@pytest.mark.parametrize("case", ["cpu float32", "cpu bf16", "train", "autograd"])
def test_the_epilogue_keeps_todays_chain_where_k4_does_not_engage(block, case):
    cin = 16 if block.endswith("identity") else 8
    policy = FP32_POLICY if case != "cpu bf16" else blocks.DEFAULT_POLICY
    if block.startswith("resblock2d"):
        mod, old = blocks.ResBlock2D(cin, 16, policy=policy), _old_resblock2d
    else:
        mod = BasicBlock(cin, 16, stride=1 if block.endswith("identity") else 2,
                         policy=policy)
        old = _old_basic_block
    _randomize_batch_norms(init_parameters(mod, 7), 8).eval()
    x = torch.randn(2, 8, 8, cin, generator=torch.Generator().manual_seed(9))
    if policy is not FP32_POLICY:
        x = x.bfloat16()
    train = case == "train"
    folds = profiling.counters()["folds"]
    before = k4.bn_act.launches
    with torch.set_grad_enabled(case == "autograd"):
        got = mod(x, train)
        want = old(mod, x, train)
    assert torch.equal(got, want)
    assert got.requires_grad == (case == "autograd")
    assert k4.bn_act.launches == before
    assert profiling.counters()["folds"] == folds


def test_the_engaged_epilogue_matches_the_chain(engaged_on_cpu):
    gen = torch.Generator().manual_seed(10)
    for cin in (16, 8):
        mod = _randomize_batch_norms(
            init_parameters(blocks.ResBlock2D(cin, 16, policy=FP32_POLICY), 11), 12).eval()
        x = torch.randn(2, 8, 8, cin, generator=gen)
        with torch.no_grad():
            got = mod(x)
        torch.testing.assert_close(got, _old_resblock2d(mod, x, False), **REASSOCIATION)
    assert engaged_on_cpu == ["none", "identity", "none", "shortcut"]


@pytest.mark.parametrize("change", ["load_state_dict", "calibration", "in-place weight"])
def test_the_operand_cache_refolds_only_after_a_change(engaged_on_cpu, change):
    mod = _randomize_batch_norms(
        init_parameters(blocks.ResBlock2D(8, 16, policy=FP32_POLICY), 13), 14).eval()
    x = torch.randn(2, 8, 8, 8, generator=torch.Generator().manual_seed(15))
    folds = blocks.OperandCache.all_folds
    with torch.no_grad():
        first = mod(x)
        assert blocks.OperandCache.all_folds == folds + 2  # one each epilogue
        assert torch.equal(mod(x), first)
        assert blocks.OperandCache.all_folds == folds + 2  # a second call folds nothing
        if change == "load_state_dict":
            other = _randomize_batch_norms(
                init_parameters(blocks.ResBlock2D(8, 16, policy=FP32_POLICY), 13), 16)
            mod.load_state_dict(other.state_dict())
        elif change == "in-place weight":
            mod.shortcut_bn.weight.mul_(2.0)
    if change == "calibration":
        calibrate_batch_norm_with(mod, lambda: mod(x, train=True))
    with torch.no_grad():
        got = mod(x)
    # Each epilogue whose BatchNorms changed folds once more: the shortcut's
    # weight belongs to the second half's alone.
    assert blocks.OperandCache.all_folds == folds + (3 if change == "in-place weight" else 4)
    assert not torch.equal(got, first)
    torch.testing.assert_close(got, _old_resblock2d(mod, x, False), **REASSOCIATION)


def _tiny(cls, seed, **kw):
    return _randomize_batch_norms(
        init_parameters(cls(policy=FP32_POLICY, arch=TINY, **kw), seed), seed + 1).eval()


@pytest.mark.parametrize("name", ["g2d", "g2d with K2", "genh", "emtn"])
def test_a_tiny_forward_is_unchanged_on_the_cpu(name, monkeypatch):
    """At TINY width on the CPU the models compute what they did before the
    epilogues (K4 does not engage there), bit for bit."""
    x, model = _tiny_case(name)
    with torch.no_grad():
        got = model(x)
    monkeypatch.setattr(blocks.ResBlock2D, "forward",
                        lambda self, x, train=False: _old_resblock2d(self, x, train))
    monkeypatch.setattr(BasicBlock, "forward",
                        lambda self, x, train=False: _old_basic_block(self, x, train))
    stem = type(model.head_pose_net.trunk) if name == "emtn" else None
    if stem is not None:
        def old_trunk(self, x, train=False):
            from megaportraits_tpu_torch.models.resnet import max_pool_3x3_s2

            x = max_pool_3x3_s2(torch.relu(self.bn1(self.conv1(x), train)))
            for block in self.block_names:
                x = getattr(self, block)(x, train)
            return x

        monkeypatch.setattr(stem, "forward", old_trunk)
    with torch.no_grad():
        want = model(x)
    for g, w in zip(_flat(got), _flat(want)):
        assert torch.equal(g, w)


def _flat(out):
    return list(out) if isinstance(out, tuple) else [out]


def _tiny_case(name):
    gen = torch.Generator().manual_seed(20)
    if name.startswith("g2d"):
        # Sides of 12 keep the trunk off K2 (G2d asks for multiples of 8).
        side = 8 if name.endswith("K2") else 12
        model = _tiny(G2d, 21)
        x = torch.randn(2, side, side, TINY.volume_channels, generator=gen)
    elif name == "genh":
        model, x = _tiny(Genh, 22), torch.rand(2, 32, 32, 3, generator=gen)
    else:
        model, x = _tiny(Emtn, 23), torch.rand(2, 64, 64, 3, generator=gen)
    return x, model


def _epilogues_a_call(name, arch):
    """K4 calls of one forward, from the model's shape: two a ResBlock2D or
    BasicBlock, one a ResNet stem."""
    if name.startswith("g2d"):
        return 2 * 3 + (0 if name.endswith("K2") else 2 * arch.g2d_blocks)
    if name == "genh":
        n_mid = 8 if arch.width_div <= 1 else arch.g2d_blocks
        return 2 * (4 + n_mid + 3)
    return 2 * (1 + 2 * sum(arch.resnet18_layers))  # Emtn's two ResNet-18s


def test_the_counted_calls_of_a_served_step_at_full_width():
    """stream8's step: Emtn and G2d's decoder (the trunk is on K2); stream4
    adds Genh."""
    from megaportraits_tpu_torch.core.arch import FULL

    emtn, decoder = _epilogues_a_call("emtn", FULL), _epilogues_a_call("g2d with K2", FULL)
    assert (emtn, decoder) == (34, 6)
    assert emtn + decoder == 40
    assert emtn + decoder + _epilogues_a_call("genh", FULL) == 70


@pytest.mark.parametrize("name", ["g2d", "g2d with K2", "genh", "emtn"])
def test_every_eval_batch_norm_of_a_tiny_forward_goes_through_k4(name, engaged_on_cpu):
    x, model = _tiny_case(name)
    with torch.no_grad():
        want = model(x, train=False)
    calls = len(engaged_on_cpu)
    assert calls == _epilogues_a_call(name, TINY)
    # The same model with the gate shut (the modules' own chain) agrees
    # within float32 reassociation.
    for w, mod in zip(_flat(want), _flat(_plain_forward(model, x))):
        torch.testing.assert_close(w, mod, **REASSOCIATION)
    # A train-mode forward, and an eval forward that autograd records,
    # reach no K4 call.
    model(x, train=True)
    assert len(engaged_on_cpu) == calls
    model(x, train=False)
    assert len(engaged_on_cpu) == calls


def _plain_forward(model, x):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(blocks, "kernel_takes", lambda tensors: False)
        with torch.no_grad():
            return model(x, train=False)
