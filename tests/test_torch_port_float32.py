"""A float32 policy convolves in float32 whatever the TF32 flags say.

torch lets cuDNN round float32 convolution inputs to TF32 by default
(``torch.backends.cudnn.allow_tf32`` is True), which put the port's output
for ``configs/inference/parity.yaml`` (``use_bf16: false``) further from
the JAX package on the card than float32 allows. ``Policy.conv_scope``
turns TF32 off around every convolution of a float32 policy, and
``anti_alias_downsample`` (JAX: ``Precision.HIGHEST``) always; the flag is
put back after. On the CPU the flag does not change the arithmetic, so
these tests read the flag each convolution sees.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from megaportraits_tpu_torch.core.arch import TINY
from megaportraits_tpu_torch.core.dtypes import DEFAULT_POLICY, FP32_POLICY, cudnn_float32
from megaportraits_tpu_torch.models.gbase import build_gbase
from megaportraits_tpu_torch.nn.layers import TorchConv
from megaportraits_tpu_torch.ops.resize import anti_alias_downsample


@pytest.fixture(params=[True, False], ids=["tf32-on", "tf32-off"])
def global_tf32(request):
    """The process-wide cuDNN TF32 flag set to each value, restored after."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = request.param
    yield request.param
    torch.backends.cudnn.allow_tf32 = before


@pytest.fixture
def seen(monkeypatch):
    """The cuDNN TF32 flag at every F.conv2d / F.conv3d call."""
    flags = []

    def spy(fn):
        def conv(*args, **kwargs):
            flags.append(torch.backends.cudnn.allow_tf32)
            return fn(*args, **kwargs)
        return conv

    monkeypatch.setattr(F, "conv2d", spy(F.conv2d))
    monkeypatch.setattr(F, "conv3d", spy(F.conv3d))
    return flags


def test_cudnn_float32_scope(global_tf32):
    with cudnn_float32():
        assert torch.backends.cudnn.allow_tf32 is False
        with cudnn_float32():
            assert torch.backends.cudnn.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is global_tf32


def test_float32_gbase_convolves_without_tf32(global_tf32, seen):
    """Every convolution of a float32 Gbase's encode_source and drive (2D
    and 3D, weight-standardised too) sees TF32 off; the flag is back after."""
    rng = np.random.default_rng(0)
    xs, xd = (torch.from_numpy(rng.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32))
              for _ in range(2))
    model = build_gbase(TINY, policy=FP32_POLICY, device="cpu", seed=0).eval()
    with torch.no_grad():
        out = model.drive(model.encode_source(xs), xd)
        model.pyramids(out)
    assert len(seen) > 50
    assert not any(seen)
    assert torch.backends.cudnn.allow_tf32 is global_tf32


def test_bf16_policy_leaves_the_flag(global_tf32, seen):
    """bf16 has no TF32 mode: a bf16 conv runs as the flags say."""
    conv = TorchConv(8, 8, (3, 3), padding=1, policy=DEFAULT_POLICY, device="cpu")
    torch.nn.init.normal_(conv.weight)
    torch.nn.init.zeros_(conv.bias)
    with torch.no_grad():
        conv(torch.ones(1, 8, 8, 8))
    assert seen == [global_tf32]


def test_anti_alias_downsample_without_tf32(global_tf32, seen):
    anti_alias_downsample(torch.ones(1, 16, 16, 3, dtype=torch.bfloat16), 0.5)
    assert seen == [False]
    assert torch.backends.cudnn.allow_tf32 is global_tf32
