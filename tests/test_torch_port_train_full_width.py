"""The stage-1 training step held against the JAX package at FULL widths,
on the CPU: case (d) of ``megaportraits_tpu_torch/utils/seeded.TRAIN_CASES``.

One ``make_train_step`` step in each package: Gbase (remat 'selective', as
``init_states`` picks at 256), the Discriminator and the perceptual loss
(VGG19 + LPIPS), ``Config()`` loss weights, lsgan, float32 on both sides,
batch 2 at 256 (the configs train at 512, batch 4: the cut lets JAX take
the step here in about a minute). Weights and images are numpy draws from
the case's seeds (``seeded.train_case_state``, carried into JAX's trees by
``torch_port_full_width.state_to_jax``); JAX's gradients come out through
``keep_gradients()``.
Each package's step runs in a child process (``jax_train_case_apart``,
``port_train_case_apart``), whose memory goes back to the system when it
exits, under a lock file (``one_case_at_a_time``): on the CPU a step takes
up to 14 GB, and the two files' cases take turns on two workers.

Every tolerance is the larger of twice the port's own self-gap and a
floor (``seeded.tolerance``): the self-gap is the largest move of the
port's quantity over four runs with every weight, frozen ones too, scaled
by (1 + 1e-6 x N(0, 1)) (two seeds, one factor an element or a channel),
which is what float32 rounding alone can do; the golden keeps it, measured
on whole outcomes and on the golden's samples. The floors: metrics 1e-4
relative, the prediction xhat 1e-4 absolute on [0, 1], BatchNorm running
statistics 1e-4 absolute, gradients 1e-4 relative (Frobenius, each leaf
above 1e-6 of the largest norm, and all of them together).

Measured (CPU, port against JAX, the self-gap in brackets): metrics at
most 5.7e-6 relative [3.8e-6]; xhat 5.3e-5 [7.2e-5]; G's BatchNorm
statistics 6.3e-6 [7.8e-6]; G's gradient 1.3e-2 over all leaves [2.3e-2],
its median leaf 1.0e-2 [1.3e-2], the worst 6.1e-2 [9.5e-2]; D's 2.3e-4
[2.8e-4]. The worst gap is 0.57 of its limit. G's gradient is as far from
JAX's as rounding moves it: at full width it passes many ReLU kinks, where
a rounding difference flips the odd activation
(test_torch_port_train_base.py states the mechanism). D's gradient answers
any rounding-level change of xhat alike; float64 on both sides takes its
gap to rounding's order (tests/torch_port_train_probe.py; PERF.md §6).

  * the port against JAX within those tolerances: metrics, xhat, every
    BatchNorm running statistic of G after the step, G's and D's
    gradients;
  * JAX against the committed golden (tests/data/
    torch_port_train_goldens.npz, which chip_smoke.py's
    phase_train_full_width holds the card against) within 1e-5: each gap
    of ``seeded.train_gaps`` on the golden's samples;
  * the draws against the golden's sha256.
"""

import numpy as np
import pytest

from megaportraits_tpu_torch.utils import seeded

import torch_port_train_full_width as tw

GOLDEN_GAP = 1e-5


@pytest.fixture(scope="module")
def golden():
    with np.load(tw.GOLDEN) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def outcomes():
    case = seeded.TRAIN_CASES["train_base"]
    _, _, weights_sha, batch_sha = tw.draws(case)
    with tw.one_case_at_a_time():
        want = tw.jax_train_case_apart(case)
        port, _ = tw.port_train_case_apart(case)
    return dict(case=case, port=port, jax=want, weights_sha=weights_sha,
                batch_sha=batch_sha)


def _held(gaps, self_gaps, prefix):
    """The gaps named `prefix`... that exceed their tolerance."""
    return {k: (g, seeded.tolerance(k, self_gaps)) for k, g in gaps.items()
            if k.startswith(prefix) and g > seeded.tolerance(k, self_gaps)}


@pytest.fixture(scope="module")
def port_gaps(outcomes, golden):
    run = "step"
    gaps = seeded.train_gaps(seeded.comparable(outcomes["port"][run]),
                             seeded.comparable(outcomes["jax"][run]))
    return gaps, seeded.golden_self_gaps(golden, "train_base", run, whole=True)


@pytest.mark.parametrize("quantity", ["metric/", "pred", "stats", "grad/gbase",
                                      "grad/disc"])
def test_port_matches_jax(port_gaps, quantity):
    gaps, self_gaps = port_gaps
    assert any(k.startswith(quantity) for k in gaps)
    assert not _held(gaps, self_gaps, quantity)


def test_step_is_not_trivial(outcomes):
    """Every metric finite, xhat spread over (0, 1), G's statistics and
    both gradients present, the rotation net frozen; no frozen network
    feeds stage 1."""
    o = outcomes["port"]["step"]
    assert "frozen" not in o
    assert all(np.isfinite(v) for v in o["metrics"].values())
    assert o["metrics"]["loss_G_gaze"] == 0.0
    assert o["pred"].shape == (2, 256, 256, 3)
    assert o["pred"].std() > 1e-2 and ((o["pred"] > 0.01) & (o["pred"] < 0.99)).mean() > 0.5
    assert len(o["stats"]) == 216 and all(k.startswith("gbase/") for k in o["stats"])
    assert len(o["grads"]["gbase"]) == 653 and len(o["grads"]["disc"]) == 9
    assert not any("rotation_net" in k for k in o["grads"]["gbase"])


def test_jax_matches_golden(outcomes, golden):
    got = seeded.comparable(seeded.train_samples(outcomes["jax"]["step"]))
    want = seeded.comparable(seeded.golden_run(golden, "train_base", "step"))
    gaps = seeded.train_gaps(got, want)
    assert max(gaps.values()) <= GOLDEN_GAP, max(gaps.items(), key=lambda kv: kv[1])


def test_draws_match_golden_checksums(outcomes, golden):
    c = outcomes["case"]
    assert list(golden[f"{c.name}/seeds"]) == [c.weight_seed, c.image_seed]
    assert str(golden[f"{c.name}/weights_sha256"]) == outcomes["weights_sha"]
    assert str(golden[f"{c.name}/batch_sha256"]) == outcomes["batch_sha"]
