"""The Student served through ``infer/streaming.StudentSession``, on the CPU
at an eighth of its widths, 64 pixels, batch 4, 4 avatars: against the
benchmark's plain float32 reference (``portbench/reference/student.py``) on
the same seeded draws, the per-row avatar routing, the ResBlockBN epilogues
(kernel K4 where it engages; its plain version runs here) and the spans.
"""

import pytest
import torch

from megaportraits_tpu_torch.core.arch import Arch
from megaportraits_tpu_torch.core.dtypes import DEFAULT_POLICY, FP32_POLICY
from megaportraits_tpu_torch.infer.streaming import StudentSession
from megaportraits_tpu_torch.models.student import Student
from megaportraits_tpu_torch.nn import blocks
from megaportraits_tpu_torch.nn.layers import BatchNorm, init_parameters
from megaportraits_tpu_torch.ops.kernels import bn_act as k4
from megaportraits_tpu_torch.utils import profiling
from portbench.reference.dtypes import FP8_CONTROL
from portbench.reference.student import Student as ReferenceStudent
from portbench.seeded import generator, load_drawn, smooth_images

SIZE, BATCH, AVATARS, WIDTH_DIV = 64, 4, 4, 8
SEED = 12
# Both sides compute in float32 with the same operations in the same order
# on the CPU (K4 does not engage there): they agree to the last bit; the
# bound leaves float32 reassociation room.
FLOAT32_ABS = 1e-5
# The frames' mean absolute gap at SEED of the bf16 policy (0.0044 on the
# CPU; 0.0032 to 0.0125 over seeds 10 to 21) and of fp8 (e4m3) operands in
# every conv (0.035; 0.024 to 0.044): a bound between them, with room on
# both sides.
BF16_MEAN_ABS = 0.012
# Kernel K4 launches a forward: the stem and each of the 11 ResBlockBNs' two.
EPILOGUES = 23
SPADES_AT_FULL_WIDTH = 15


def _port(policy):
    return load_drawn(Student(AVATARS, policy=policy, arch=Arch(width_div=WIDTH_DIV),
                              device="cpu"), SEED, "weights")


def _reference(policy=None):
    kw = {} if policy is None else {"policy": policy}
    return load_drawn(ReferenceStudent(AVATARS, width_div=WIDTH_DIV, device="cpu", **kw),
                      SEED, "weights").eval()


def _frames(tag="frames"):
    return smooth_images(generator("cpu", SEED, tag), BATCH, SIZE, "cpu")


def _session(policy, avatars=(0, 1, 2, 3)):
    session = StudentSession(model=_port(policy))
    session.set_avatars(list(avatars))
    return session


def test_the_draws_reach_both_sides_alike():
    port = _port(FP32_POLICY).state_dict()
    ref = _reference().state_dict()
    assert list(port) == list(ref)
    assert all(torch.equal(port[k], ref[k]) for k in port)


@pytest.mark.parametrize("policy, bound, statistic", [
    (FP32_POLICY, FLOAT32_ABS, "max"),
    (DEFAULT_POLICY, BF16_MEAN_ABS, "mean"),
    (FP8_CONTROL, BF16_MEAN_ABS, "mean")], ids=["float32", "bf16", "fp8 control"])
def test_the_session_against_the_reference(policy, bound, statistic):
    x = _frames()
    want = _reference()(x, torch.arange(BATCH))
    if policy is FP8_CONTROL:
        with torch.no_grad():
            got = _reference(policy)(x, torch.arange(BATCH))
    else:
        got = _session(policy)(x)
    gap = (got.float() - want).abs()
    gap = gap.max() if statistic == "max" else gap.mean()
    assert got.shape == (BATCH, SIZE, SIZE, 3)
    if policy is FP8_CONTROL:
        assert gap > bound  # a precision below bf16 fails the bound
    else:
        assert gap <= bound


def test_each_row_is_its_own_avatars_frame():
    x = _frames()
    avatars = (3, 0, 2, 1)
    got = _session(FP32_POLICY, avatars)(x)
    ref = _reference()
    with torch.no_grad():
        for i, a in enumerate(avatars):
            alone = ref(x[i:i + 1], torch.tensor([a]))
            torch.testing.assert_close(got[i:i + 1], alone, atol=FLOAT32_ABS, rtol=0)


def test_swapping_two_streams_avatars_moves_exactly_those_rows():
    x = _frames()
    session = _session(FP32_POLICY)
    first = session(x)
    session.set_avatars([1, 0, 2, 3])
    swapped = session(x)
    for i in (0, 1):
        assert (swapped[i] - first[i]).abs().mean() > 1e-3
    assert torch.equal(swapped[2:], first[2:])


def test_a_served_step_uploads_nothing():
    session = _session(FP32_POLICY)
    x = _frames()
    before = profiling.counters()["host_uploads"]
    session(x)
    assert profiling.counters()["host_uploads"] == before
    with pytest.raises(ValueError):
        session(x[:2])


def _old_res_block_bn(block, x, train):
    """ResBlockBN's forward before the epilogues: the modules' chain."""
    shortcut = x
    if block.shortcut_conv is not None:
        shortcut = block.shortcut_bn(block.shortcut_conv(x), train)
    out = torch.relu(block.bn1(block.conv1(x), train))
    out = torch.relu(block.bn2(block.conv2(out), train))
    return torch.relu(out + shortcut)


def _block(cin, cout, downsample):
    block = init_parameters(blocks.ResBlockBN(cin, cout, downsample, policy=FP32_POLICY), 5)
    gen = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for bn in block.modules():
            if isinstance(bn, BatchNorm):
                c = bn.weight.shape[0]
                bn.weight.copy_(torch.rand(c, generator=gen) + 0.5)
                bn.bias.copy_(torch.randn(c, generator=gen) * 0.2)
                bn.running_mean.copy_(torch.randn(c, generator=gen) * 0.3)
                bn.running_var.copy_(torch.rand(c, generator=gen) + 0.3)
    return block.eval()


@pytest.mark.parametrize("case", ["engaged", "train", "autograd"])
@pytest.mark.parametrize("shape", [(16, 16, False), (8, 16, False), (16, 16, True)],
                         ids=["identity", "width change", "downsample"])
def test_res_block_bn_epilogues_against_the_chain(monkeypatch, shape, case):
    """With the gate's device half opened on the CPU the eval-mode block goes
    through ``bn_act`` (its plain version here) twice and computes the
    chain's function; in train mode and under autograd it keeps the chain,
    bit for bit, and launches nothing."""
    cin, cout, downsample = shape
    block = _block(cin, cout, downsample)
    calls = []
    real = k4.bn_act

    def counting(*args, **kw):
        calls.append(args[4] if len(args) > 4 else kw.get("residual"))
        return real(*args, **kw)

    monkeypatch.setattr(blocks, "kernel_takes", lambda tensors: True)
    monkeypatch.setattr(k4, "bn_act", counting)
    x = torch.randn(2, 8, 8, cin, generator=torch.Generator().manual_seed(7))
    train = case == "train"
    with torch.set_grad_enabled(case == "autograd"):
        got = block(x, train)
        want = _old_res_block_bn(block, x, train)
    if case == "engaged":
        assert calls == [None, None]  # relu(bn(conv)) twice, no residual form
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    else:
        assert calls == [] and torch.equal(got, want)
        assert got.requires_grad == (case == "autograd")


def test_a_student_step_runs_every_epilogue_through_k4(monkeypatch):
    session = _session(FP32_POLICY)
    x = _frames()
    with torch.no_grad():
        want = session(x)  # the gate shut: the modules' chain
    calls = []
    real = k4.bn_act

    def counting(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(blocks, "kernel_takes", lambda tensors: True)
    monkeypatch.setattr(k4, "bn_act", counting)
    got = session(x)
    assert len(calls) == EPILOGUES
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    with torch.device("meta"):
        full = Student(AVATARS)
    assert 1 + 2 * sum(isinstance(m, blocks.ResBlockBN) for m in full.modules()) == EPILOGUES
    assert sum(isinstance(m, blocks.SPADE) for m in full.modules()) == SPADES_AT_FULL_WIDTH


def test_the_spans_of_a_step(tmp_path):
    session = _session(FP32_POLICY)
    x = _frames()
    first = len(profiling.spans())
    with profiling.trace(str(tmp_path)):
        session(x)
    records = [r for r in profiling.spans()[first:] if "end_ns" in r]
    names = {r["index"]: r["name"] for r in records}
    root = [r for r in records if r["parent"] is None]
    assert [r["name"] for r in root] == ["session.step"]
    children = [r["name"] for r in records if r["parent"] == root[0]["index"]]
    assert children == ["student.encoder", "student.decoder", "student.tail"]
    spades = [r for r in records if r["name"] == "student.spade"]
    assert {names[r["parent"]] for r in spades} == {"student.decoder"}
    assert len(spades) == sum(isinstance(m, blocks.SPADE) for m in session.model.modules())
    assert root[0]["counters"]["host_uploads"] == 0
