"""The stage-2 and stage-3 training steps held against the JAX package at
FULL widths, on the CPU: cases (e) and (f) of
``megaportraits_tpu_torch/utils/seeded.TRAIN_CASES``.

(e) one ``make_hr_train_step`` step: Genh trains behind a frozen Gbase on
its running statistics, base 256, ``target_hr`` 512, batch 2 (the config
trains 512 -> 1024). (f) one ``make_student_train_step`` step of a Student
with 3 avatars, indices [2, 0], at 256, batch 2 (the config trains at
512): the frozen GHR teacher inline, then, from the same weights, with
'target01' given. Float32 on both sides; the kernels' gate is opened on
the CPU, so the frozen Gbase's G2d trunk runs through K2's wrapper (its
plain version on CPU tensors), once a sample, and its eval-mode
BatchNorms through K4's.
Weights and images are numpy draws from the cases' seeds, as in
test_torch_port_train_full_width.py, which states the rule of the
tolerances: the larger of twice the port's own self-gap (the golden's,
the largest move over four runs with every weight scaled by 1 + 1e-6 x
N(0, 1)) and a floor (metrics 1e-4 relative, the prediction and the frozen
network's output 1e-4 absolute, BatchNorm statistics 1e-4 absolute,
gradients 1e-4 relative, a leaf and overall).
The prediction is Genh's first pass (in [-1, 1]) and the Student's output.
Each package's step runs in a child process, under a lock file, as in
test_torch_port_train_full_width.py.

Measured (CPU, port against JAX, the self-gap in brackets): (e) metrics
7.8e-7 [1.8e-6], Genh's output 4.2e-4 [6.0e-4], the base image 2.1e-6
[6.3e-6], statistics 1.2e-6 [3.2e-6], Genh's gradient 5.4e-3 over all
leaves [6.0e-3], the worst leaf 3.1e-2 [3.6e-2]; (f) inline and on
'target01': the loss 0 and 2.3e-7 [1.2e-6], the Student's output 5.0e-5
[1.0e-4], the teacher's target 1.1e-6 [1.8e-6], statistics 4.2e-7
[6.3e-7], the gradient 1.1e-2 and 6.9e-3 [1.3e-2], the worst leaf 1.7e-2
and 9.3e-3. The worst gap is 0.72 of its limit.

  * the port against JAX within those tolerances: metrics, prediction,
    the frozen network's output as the step takes it (the frozen Gbase's
    image upscaled, the teacher's target), the trained network's BatchNorm
    running statistics, its gradient;
  * K2's wrapper once a sample wherever the frozen Gbase runs (none in
    the step on 'target01');
  * JAX against the committed golden within 1e-5; the draws against the
    golden's sha256.
"""

import numpy as np
import pytest

from megaportraits_tpu_torch.utils import seeded

import torch_port_train_full_width as tw

GOLDEN_GAP = 1e-5
CASES = ("train_hr", "train_student")


@pytest.fixture(scope="module")
def golden():
    with np.load(tw.GOLDEN) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module", params=CASES)
def outcomes(request):
    """Both packages' runs of the case, and K2's wrapper calls in the
    port's."""
    case = seeded.TRAIN_CASES[request.param]
    _, _, weights_sha, batch_sha = tw.draws(case)
    with tw.one_case_at_a_time():
        want = tw.jax_train_case_apart(case)
        port, calls = tw.port_train_case_apart(case, engaged=True)
    return dict(case=case, port=port, jax=want, calls=calls,
                weights_sha=weights_sha, batch_sha=batch_sha)


@pytest.fixture(scope="module")
def port_gaps(outcomes, golden):
    """Per run, the port's gaps to JAX and the golden's self-gaps."""
    c = outcomes["case"]
    return {run: (seeded.train_gaps(seeded.comparable(outcomes["port"][run]),
                                    seeded.comparable(outcomes["jax"][run])),
                  seeded.golden_self_gaps(golden, c.name, run, whole=True))
            for run in c.runs}


@pytest.mark.parametrize("quantity", ["metric/", "pred", "frozen", "stats", "grad/"])
def test_port_matches_jax(port_gaps, quantity):
    """Every run's gaps within their tolerances. The frozen network's output
    (the upscaled base image; the teacher's target) is in the runs it
    feeds."""
    held = 0
    for run, (gaps, self_gaps) in port_gaps.items():
        over = {k: (g, seeded.tolerance(k, self_gaps)) for k, g in gaps.items()
                if k.startswith(quantity) and g > seeded.tolerance(k, self_gaps)}
        assert not over, (run, over)
        held += any(k.startswith(quantity) for k in gaps)
    assert held == (1 if quantity == "frozen" else len(port_gaps))


def test_k2_wrapper_once_a_sample(outcomes):
    """The frozen Gbase's trunk goes through K2's wrapper, once a sample,
    in the one run that makes the base image."""
    c = outcomes["case"]
    assert outcomes["calls"] == c.batch


def test_step_is_not_trivial(outcomes):
    c = outcomes["case"]
    net = c.trained[0]
    for run in c.runs:
        o = outcomes["port"][run]
        assert all(np.isfinite(v) for v in o["metrics"].values())
        assert o["pred"].shape == (c.batch, c.hr_size or c.size, c.hr_size or c.size, 3)
        assert o["pred"].std() > 1e-2
        assert o["stats"] and all(k.startswith(net + "/") for k in o["stats"])
        assert len(o["grads"][net]) == {"genh": 124, "student": 278}[net]


def test_jax_matches_golden(outcomes, golden):
    c = outcomes["case"]
    for run in c.runs:
        got = seeded.comparable(seeded.train_samples(outcomes["jax"][run]))
        want = seeded.comparable(seeded.golden_run(golden, c.name, run))
        gaps = seeded.train_gaps(got, want)
        assert max(gaps.values()) <= GOLDEN_GAP, (run, max(gaps.items(),
                                                           key=lambda kv: kv[1]))


def test_draws_match_golden_checksums(outcomes, golden):
    c = outcomes["case"]
    assert list(golden[f"{c.name}/seeds"]) == [c.weight_seed, c.image_seed]
    assert str(golden[f"{c.name}/weights_sha256"]) == outcomes["weights_sha"]
    assert str(golden[f"{c.name}/batch_sha256"]) == outcomes["batch_sha"]
