"""The port against the JAX package at FULL widths, on the CPU.

Three cases (``megaportraits_tpu_torch/utils/seeded.CASES``), each with the
FULL arch, float32 compute on both sides and BatchNorms on their running
statistics: (a) Gbase's ``encode_source`` of one source and ``drive`` of 2
driving frames at 512, (b) GHR (Gbase at 256, bilinear x2, Genh at 512)
and (c) the Student with 3 avatars at 512, batch 2. The widths are all
full; (b) and (c) cut the served 1024 so that JAX runs them here in
seconds. Weights and images are numpy draws from the cases' seeds
(``seeded.numpy_state`` over the port's state_dict, carried into JAX's
variable tree by ``torch_port_full_width.state_to_jax``).

  * the port's output agrees with JAX's to 1e-4 absolute on [0, 1]
    (measured 5e-6, 2e-6 and 3e-5: a change of one ulp in the Student's
    input moves its output by 2e-5); Gbase's ``vc2d`` and ``es`` to 1e-4
    absolute and relative;
  * every output is not trivial: std above 1e-2 and more than half of its
    values in (0.01, 0.99);
  * JAX's output equals the committed golden (tests/data/
    torch_port_goldens.npz, which chip_smoke.py holds the card against) to
    1e-5, and the port's draws match the golden's checksums;
  * the bridge's inverse is one-to-one over every leaf of the three FULL
    trees, and ``jax_to_state_dict`` carries it back unchanged.
"""

import numpy as np
import pytest
import torch

from megaportraits_tpu_torch.core.dtypes import FP32_POLICY
from megaportraits_tpu_torch.utils import seeded
from megaportraits_tpu_torch.utils.jax_bridge import jax_to_state_dict

import torch_port_full_width as fw

OUT_TOL = dict(atol=1e-4, rtol=0)
MID_TOL = dict(atol=1e-4, rtol=1e-4)
GOLDEN_TOL = dict(atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def golden():
    with np.load(fw.GOLDEN) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module", params=list(seeded.CASES))
def case(request):
    """The case's draws, JAX's variable tree and both packages' outputs."""
    c = seeded.CASES[request.param]
    state, images, weights_sha, images_sha = fw.port_draws(c)
    variables = fw.state_to_jax(state, fw.jax_shapes(c, images))
    want = fw.jax_case(c, variables, images)
    model = seeded.build_model(c, FP32_POLICY)
    got = {k: v.numpy() for k, v in
           seeded.run_case(c, model, torch.from_numpy(images)).items()}
    return dict(case=c, state=state, variables=variables, want=want, got=got,
                weights_sha=weights_sha, images_sha=images_sha)


def test_bridge_inverse_covers_every_leaf(case):
    """Every JAX leaf takes exactly one port tensor (``state_to_jax``
    raises otherwise) and the bridge carries the tree back to the same
    arrays."""
    state, variables = case["state"], case["variables"]
    leaves = [a for col in variables.values() for _, a in fw._flatten(col)]
    assert len(leaves) == len(state)
    back = jax_to_state_dict(variables)
    assert set(back) == set(state)
    for key, value in state.items():
        assert np.array_equal(back[key].numpy(), value), key


def test_port_matches_jax(case):
    want, got = case["want"], case["got"]
    assert set(got) == set(want)
    for out in (want["out"], got["out"]):
        assert out.std() > 1e-2
        assert ((out > 0.01) & (out < 0.99)).mean() > 0.5
    assert got["out"].shape == want["out"].shape
    np.testing.assert_allclose(got["out"], want["out"], **OUT_TOL)
    for name in ("vc2d", "es"):
        if name in want:
            np.testing.assert_allclose(got[name], want[name], **MID_TOL)


def test_jax_matches_golden(case, golden):
    c, want = case["case"], case["want"]
    expect = fw.golden_entries(c, want, case["weights_sha"], case["images_sha"])
    assert set(expect) == {k for k in golden if k.startswith(c.name + "/")}
    for key, value in expect.items():
        if value.dtype.kind == "f":
            np.testing.assert_allclose(value, golden[key], err_msg=key, **GOLDEN_TOL)


def test_draws_match_golden_checksums(case, golden):
    c = case["case"]
    assert list(golden[f"{c.name}/seeds"]) == [c.weight_seed, c.image_seed]
    assert str(golden[f"{c.name}/weights_sha256"]) == case["weights_sha"]
    assert str(golden[f"{c.name}/images_sha256"]) == case["images_sha"]
