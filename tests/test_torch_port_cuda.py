"""The CUDA kernels K1, K2, K3 and K4 against their plain versions, on the card.

Marker ``cuda``; each test skips on a host without a card. This file
imports neither JAX nor the JAX package, so it also runs on a machine with
only PyTorch (the repo's conftest imports JAX; skip it there):

    python -m pytest tests/test_torch_port_cuda.py -m cuda --noconftest

The plain version convolves in float32 with TF32 off; the kernel
accumulates bf16 products in float32 and rounds once to bf16, so the two
differ by bf16 rounding: 2 bf16 ulps of the output's magnitude
(rtol 2**-7) plus atol 2e-2 for one conv; twice that for a 2-block chain.
K3 walks its tiles with K2's tile routine, sums in the same order and rounds
to bf16 at the same places (a residual that stays in shared memory is the
bf16 tile that was stored), so K3 equals K2 bit for bit. K4 (bn_act) rounds
its float32 result to bf16 once: within one bf16 ulp of its plain version
computed in float32, plus the few float32 ulps of the terms by which a fused
multiply-add and PyTorch's separate products differ.
"""

import os
import sys

import numpy as np
import pytest
import torch

from megaportraits_tpu_torch.ops.kernels import bn_act as k4
from megaportraits_tpu_torch.ops.kernels import conv3x3 as k1
from megaportraits_tpu_torch.ops.kernels import resblock_chain as k2
from megaportraits_tpu_torch.ops.kernels import resblock_chain_fused as k3

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
from chip_smoke import bf16_ulp_excess  # noqa: E402


def _conv_inputs(seed, h, w, c, f):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(h, w, c)).astype(np.float32)
    kern = (rng.normal(size=(3, 3, c, f)) / np.sqrt(9 * c)).astype(np.float32)
    s = rng.uniform(0.5, 1.5, (f,)).astype(np.float32)
    sh = (rng.normal(size=(f,)) * 0.1).astype(np.float32)
    res = rng.normal(size=(h, w, f)).astype(np.float32)
    return x, kern, s, sh, res


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _t(a, dev):
    return torch.from_numpy(a).to(dev)


def _bf16(a, dev):
    return _t(a, dev).bfloat16()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 64, 512, 512), (16, 16, 64, 64),
                                   (10, 12, 32, 40), (40, 24, 256, 256),
                                   (9, 65, 96, 136)])
@pytest.mark.parametrize("with_residual", [False, True])
def test_k1_kernel_matches_plain_on_card(cuda, shape, with_residual):
    h, w, c, f = shape
    x, kern, s, sh, res = _conv_inputs(6, h, w, c, f)
    args = (_bf16(x, cuda), _bf16(kern, cuda), _t(s, cuda), _t(sh, cuda),
            _bf16(res, cuda) if with_residual else None)
    before = k1.conv3x3_bn_act.launches
    got = k1.conv3x3_bn_act(*args)
    torch.cuda.synchronize()
    assert k1.conv3x3_bn_act.launches == before + 1
    want = k1.conv3x3_bn_act_plain(*args)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2**-7)


@pytest.mark.cuda
def test_k2_kernel_matches_plain_on_card(cuda):
    rng = np.random.default_rng(7)
    c = 512
    x = rng.normal(size=(64, 64, c)).astype(np.float32)
    wts = (rng.normal(size=(2, 2, 3, 3, c, c)) / np.sqrt(9 * c)).astype(np.float32)
    sc = rng.uniform(0.4, 0.6, (2, 2, c)).astype(np.float32)
    sh = (rng.normal(size=(2, 2, c)) * 0.05).astype(np.float32)
    args = (_bf16(x, cuda), _bf16(wts, cuda), _t(sc, cuda), _t(sh, cuda))
    before = (k1.conv3x3_bn_act.launches, k2.resblock_chain.launches)
    got = k2.resblock_chain(*args)
    torch.cuda.synchronize()
    assert (k1.conv3x3_bn_act.launches, k2.resblock_chain.launches) == (
        before[0] + 4, before[1] + 1)
    want = k2.resblock_chain_plain(*args)
    torch.testing.assert_close(got.float(), want.float(), atol=4e-2, rtol=2**-6)


def _chain_args(seed, h, w, c, nb, dev):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(h, w, c)).astype(np.float32)
    wts = (rng.normal(size=(nb, 2, 3, 3, c, c)) / np.sqrt(9 * c)).astype(np.float32)
    sc = rng.uniform(0.4, 0.6, (nb, 2, c)).astype(np.float32)
    sh = (rng.normal(size=(nb, 2, c)) * 0.05).astype(np.float32)
    return (_bf16(x, dev), _bf16(wts, dev), _t(sc, dev), _t(sh, dev))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(40, 24, 256, 2), (16, 16, 128, 3),
                                   (10, 12, 32, 1)])
@pytest.mark.parametrize("dependent_launch", [True, False])
def test_k2_chain_call_counts_and_ragged_shapes_on_card(cuda, shape,
                                                        dependent_launch):
    """One chain call enqueues 2N K1 launches and reports them; the input is
    not written; the result does not depend on the launches overlapping."""
    h, w, c, nb = shape
    args = _chain_args(12, h, w, c, nb, cuda)
    x_before = args[0].clone()
    before = (k1.conv3x3_bn_act.launches, k2.resblock_chain.launches)
    k2.resblock_chain.dependent_launch = dependent_launch
    try:
        got = k2.resblock_chain(*args)
        torch.cuda.synchronize()
    finally:
        k2.resblock_chain.dependent_launch = True
    assert (k1.conv3x3_bn_act.launches, k2.resblock_chain.launches) == (
        before[0] + 2 * nb, before[1] + 1)
    assert torch.equal(args[0], x_before)
    want = k2.resblock_chain_plain(*args)
    torch.testing.assert_close(got.float(), want.float(), atol=4e-2, rtol=2**-6)


@pytest.mark.cuda
def test_k2_chain_reuses_its_tensor_maps_on_card(cuda):
    """A second call on the same tensors encodes no tensor map for the
    weights (the scratch buffers may or may not come back at the same
    addresses)."""
    args = _chain_args(13, 16, 16, 64, 2, cuda)
    lib = k1.library()
    first = k2.resblock_chain(*args)
    torch.cuda.synchronize()
    encoded = lib.conv3x3_bn_act_maps_encoded()
    second = k2.resblock_chain(*args)
    torch.cuda.synchronize()
    # At most: x as input and residual, h as output and input, two buffers
    # as output, input and residual; never the 4 weight maps.
    assert lib.conv3x3_bn_act_maps_encoded() - encoded <= 10
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 64, 512, 2), (40, 24, 256, 2),
                                   (16, 16, 128, 3), (9, 65, 96, 2),
                                   (128, 128, 256, 2), (64, 64, 512, 1)])
def test_k3_kernel_matches_plain_and_k2_on_card(cuda, shape):
    """One launch a call, none of K1's; the input is not written. 40x24x256
    has 10 x 2 = 20 tiles a conv on the tap path, 9x65x96 a last row and a
    last column of one pixel on the haloed path, and 128x128x256 more tiles
    (256) than the card holds CTAs, so that CTAs take several tiles a conv
    and the residual comes by TMA."""
    h, w, c, nb = shape
    args = _chain_args(10, h, w, c, nb, cuda)
    x_before = args[0].clone()
    before = (k1.conv3x3_bn_act.launches, k3.fused_resblock_chain.launches)
    got = k3.fused_resblock_chain(*args)
    torch.cuda.synchronize()
    assert (k1.conv3x3_bn_act.launches, k3.fused_resblock_chain.launches) == (
        before[0], before[1] + 1)
    assert torch.equal(args[0], x_before)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert k3.grid_ctas(h, w, c) == k3.plan_grid(h, w, c, sms)
    want = k3.fused_resblock_chain_plain(*args)
    torch.testing.assert_close(got.float(), want.float(), atol=4e-2, rtol=2**-6)
    assert torch.equal(got, k2.resblock_chain(*args))  # bit for bit


@pytest.mark.cuda
def test_k3_kernel_takes_channels_in_multiples_of_8_on_card(cuda):
    """C = 40: K2's wrapper refuses it, the tile routine's boxes zero-fill."""
    args = _chain_args(14, 12, 20, 40, 2, cuda)
    got = k3.fused_resblock_chain(*args)
    torch.cuda.synchronize()
    want = k3.fused_resblock_chain_plain(*args)
    torch.testing.assert_close(got.float(), want.float(), atol=4e-2, rtol=2**-6)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 64, 512, 8), (128, 128, 256, 2)])
@pytest.mark.parametrize("queued", [False, True])
def test_k3_repeated_calls_are_identical_on_card(cuda, shape, queued):
    """A race between CTAs shows as a call that differs: 200 back-to-back
    calls all equal the first, launched onto an idle card and queued behind
    other work."""
    args = _chain_args(15, *shape, cuda)
    first = k3.fused_resblock_chain(*args)
    torch.cuda.synchronize()
    if queued:
        torch.cuda._sleep(20_000_000)
        k2.resblock_chain(*args)
    outs = [k3.fused_resblock_chain(*args) for _ in range(200)]
    torch.cuda.synchronize()
    assert all(torch.equal(out, first) for out in outs)
    assert torch.equal(first, k2.resblock_chain(*args))


@pytest.mark.cuda
def test_k3_reuses_its_tensor_maps_and_sync_words_on_card(cuda):
    """A second call on the same tensors encodes no map for x or the weights
    (the scratch buffers may come back at other addresses: at most 4 maps),
    and both calls share the stream's boundary words, left zeroed."""
    args = _chain_args(16, 16, 16, 64, 2, cuda)
    lib = k3._library()
    first = k3.fused_resblock_chain(*args)
    torch.cuda.synchronize()
    encoded = lib.resblock_chain_fused_maps_encoded()
    words = len(k3._SYNC_WORDS)
    second = k3.fused_resblock_chain(*args)
    torch.cuda.synchronize()
    assert lib.resblock_chain_fused_maps_encoded() - encoded <= 4
    assert len(k3._SYNC_WORDS) == words
    assert all(int(w.abs().sum()) == 0 for w in k3._SYNC_WORDS.values())
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_k3_kernel_rejects_what_it_does_not_take(cuda):
    x, wts, sc, sh = _chain_args(11, 8, 8, 32, 1, cuda)
    with pytest.raises(TypeError):  # float32 activations
        k3.fused_resblock_chain(x.float(), wts, sc, sh)
    with pytest.raises(ValueError):  # no blocks
        k3.fused_resblock_chain(x, wts[:0], sc[:0], sh[:0])
    x36, wts36, sc36, sh36 = _chain_args(17, 8, 8, 36, 1, cuda)
    with pytest.raises(ValueError):  # C % 8 != 0
        k3.fused_resblock_chain(x36, wts36, sc36, sh36)


@pytest.mark.cuda
def test_k1_kernel_rejects_what_it_does_not_take(cuda):
    x, kern, s, sh, _ = _conv_inputs(8, 8, 8, 32, 32)
    with pytest.raises(TypeError):  # float32 activations
        k1.conv3x3_bn_act(_t(x, cuda), _bf16(kern, cuda), _t(s, cuda),
                          _t(sh, cuda))
    x48, kern48, s48, sh48, _ = _conv_inputs(9, 8, 8, 48, 32)
    with pytest.raises(ValueError):  # C % 32 != 0
        k1.conv3x3_bn_act(_bf16(x48, cuda), _bf16(kern48, cuda), _t(s48, cuda),
                          _t(sh48, cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("operand", [0, 1, 2, 3])
def test_kernels_refuse_autograd_inputs_on_card(cuda, operand):
    """The kernels have no backward: with autograd on, an input, weight or
    folded operand that requires grad raises in K1, K2 and K3 before any
    launch, instead of cutting the gradient without a word. Under
    torch.no_grad() the same call launches."""
    chain = list(_chain_args(18, 8, 8, 32, 1, cuda))
    chain[operand] = chain[operand].requires_grad_(True)
    conv = [chain[0], chain[1][0, 0], chain[2][0, 0], chain[3][0, 0]]
    for fn, args in ((k1.conv3x3_bn_act, conv), (k2.resblock_chain, chain),
                     (k3.fused_resblock_chain, chain)):
        before = fn.launches
        with pytest.raises(RuntimeError, match="no backward"):
            fn(*args)
        assert fn.launches == before
        with torch.no_grad():
            fn(*args)
        torch.cuda.synchronize()
        assert fn.launches == before + 1


@pytest.mark.cuda
def test_prefetch_to_the_card_matches_the_cpu_path(cuda):
    """prefetch_to_device on the card: every leaf lands on the card, in
    order, equal to the CPU path's; a leaf that cannot be copied raises in
    the consumer."""
    from megaportraits_tpu_torch.data.prefetch import prefetch_to_device

    rng = np.random.default_rng(19)
    items = [{"x": rng.random((2, 64, 64, 3), dtype=np.float32),
              "i": np.arange(3, dtype=np.int32) + k} for k in range(6)]
    on_card = list(prefetch_to_device(iter(items), size=2, device=cuda))
    on_host = list(prefetch_to_device(iter(items), size=2, device="cpu"))
    assert len(on_card) == len(on_host) == 6
    for got, want in zip(on_card, on_host):
        for k in want:
            assert got[k].device.type == "cuda" and got[k].dtype == want[k].dtype
            assert torch.equal(got[k].cpu(), want[k])

    def broken():
        yield items[0]
        yield {"x": np.array([object()])}

    it = prefetch_to_device(broken(), device=cuda)
    assert next(it)["x"].device.type == "cuda"
    with pytest.raises(TypeError):
        next(it)


def _bn_act_inputs(seed, shape, form, dev):
    """y and r in bf16, BatchNorm-like operands in float32."""
    rng = np.random.default_rng(seed)
    c = shape[-1]

    def ops():
        return [_t(rng.normal(size=c).astype(np.float32) * 0.3, dev),
                _t(rng.uniform(0.3, 2.0, c).astype(np.float32), dev),
                _t(rng.normal(size=c).astype(np.float32) * 0.2, dev)]

    y = _bf16(rng.normal(size=shape).astype(np.float32), dev)
    args = [y, *ops()]
    if form != "none":
        args.append(_bf16(rng.normal(size=shape).astype(np.float32), dev))
    if form == "shortcut":
        args += ops()
    return args


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 16, 24, 64), (8, 32, 32, 512), (3, 5, 7, 8),
                                   (2, 9, 11, 24), (1, 4, 4, 2048)])
@pytest.mark.parametrize("form", ["none", "identity", "shortcut"])
@pytest.mark.parametrize("relu", [True, False])
def test_k4_kernel_matches_plain_on_card(cuda, shape, form, relu):
    args = _bn_act_inputs(30, shape, form, cuda)
    before = k4.bn_act.launches
    got = k4.bn_act(*args, relu=relu)
    torch.cuda.synchronize()
    assert k4.bn_act.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == args[0].shape
    assert bf16_ulp_excess(got, args, relu) <= 0


@pytest.mark.cuda
def test_k4_kernel_rejects_what_it_does_not_take(cuda):
    args = _bn_act_inputs(31, (2, 4, 4, 64), "identity", cuda)
    with pytest.raises(TypeError):  # float32 activations
        k4.bn_act(args[0].float(), *args[1:])
    with pytest.raises(ValueError, match="contiguous"):
        k4.bn_act(args[0].transpose(1, 2), *args[1:4], args[4].transpose(1, 2))
    odd = _bn_act_inputs(32, (2, 4, 4, 12), "none", cuda)
    with pytest.raises(ValueError, match="C % 8"):
        k4.bn_act(*odd)
    y = args[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        k4.bn_act(y, *args[1:])
    with torch.no_grad():
        k4.bn_act(y, *args[1:])
    torch.cuda.synchronize()
