"""Port parity on CPU for stage-1 training: the config, the optimiser and
one whole train step against the JAX package.

The step runs at TINY, 64x64, batch 1, FP32, on both sides with the same
weights (drawn with numpy, bridged to the port) and the same batch. The
JAX step runs once per module; its state carries an optax transformation
that applies no update and keeps the gradients as its state, so G's and
D's gradients are read from the step itself.

Tolerances:
  * metrics: 1e-4 relative (measured up to 3.3e-5, the cycle loss);
  * the prediction xhat: 1e-4 absolute on [0, 1] (measured 3.1e-5);
  * G's BatchNorm running statistics after the step: 1e-4 absolute
    (measured 6.5e-6);
  * D's gradient: 1e-4 relative Frobenius error per leaf (measured 8e-6);
  * G's gradient: 3e-2 relative Frobenius error over all leaves together
    and 1e-1 per leaf, for leaves whose norm is above 1e-6 of the largest
    (measured 7.5e-3 and 4.6e-2; the median leaf 2e-3). The gradient
    passes ReLU kinks (and the |.| of the L1 losses): where the two
    forwards differ by float32 rounding, the odd activation lands on the
    other side of a kink, and since a weight's gradient sums many terms of
    mixed sign, one such flip among N elements moves it by about
    1/sqrt(N). In a TINY G2d on its own, one flip among the 524,288
    elements after its last GroupNorm moved the cotangent there by 1.7e-3
    and the decoder's weight gradients by about as much. So the port's own
    G gradient moves by 2.4% over all leaves (7.7% in one leaf) when every
    G weight moves by a relative 1e-6. The metrics and the prediction see
    no such jump and are held tight;
  * the optimiser against optax on the same gradients: 1e-6 absolute on
    parameters of order 1 (a few float32 ulps: the two add the decay and
    the Adam term in another order).
"""

import copy
import dataclasses
import glob
import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from megaportraits_tpu.core import config as jconfig
from megaportraits_tpu.core.dtypes import FP32_POLICY as JP
from megaportraits_tpu.train import train_base as jtb
from megaportraits_tpu.train.state import TrainState as JTrainState
from megaportraits_tpu.train.state import make_optimizer as j_make_optimizer
from megaportraits_tpu.utils.pretrained import maybe_load_pretrained

from megaportraits_tpu_torch.core import config as tconfig
from megaportraits_tpu_torch.core.arch import TINY
from megaportraits_tpu_torch.core.dtypes import FP32_POLICY
from megaportraits_tpu_torch.losses.gan import discriminator_loss
from megaportraits_tpu_torch.train.state import (
    cosine_factor,
    make_optimizer,
    trainable_parameters,
)
from megaportraits_tpu_torch.train.train_base import init_states, make_train_step
from megaportraits_tpu_torch.utils.jax_bridge import jax_to_state_dict, load_jax_variables

from torch_port_utils import grad_errors, keep_gradients, n, numpy_fill, randomize_batch_stats, t

SIZE = 64
METRIC_KEYS = {"loss_G", "loss_G_per", "loss_G_adv", "loss_fm", "loss_G_cos",
               "loss_pairwise", "loss_identity", "loss_G_gaze", "loss_D"}
IMAGES = ("source", "driving", "source_next", "source_star", "driving_star")
CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "configs")


def _tiny(cfg):
    cfg.model.arch = "tiny"
    cfg.data.train_width = cfg.data.train_height = SIZE
    cfg.training.steps_per_epoch = 1
    return cfg


def _batch(seed=0, b=1):
    rng = np.random.default_rng(seed)
    return {k: rng.random((b, SIZE, SIZE, 3)).astype(np.float32) for k in IMAGES}


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def reference():
    """One JAX step on numpy-drawn weights; the variables, the batch and
    what the step gave."""
    cfg = _tiny(jconfig.Config())
    gbase, disc, ploss, p_vars, g_state, d_state = jtb.init_states(
        cfg, jax.random.PRNGKey(0), policy=JP, image_size=SIZE, fast_init=True)
    g_vars = randomize_batch_stats(
        {"params": numpy_fill(g_state.params, 1),
         "batch_stats": numpy_fill(g_state.batch_stats)}, seed=2)
    d_vars = {"params": numpy_fill(d_state.params, 3)}
    p_vars = numpy_fill(p_vars, 4)
    batch = _batch()
    step = jtb.make_train_step(gbase, disc, ploss, p_vars, cfg, donate=False)
    g2, d2, metrics, xhat = step(
        JTrainState.create(g_vars["params"], g_vars["batch_stats"], keep_gradients()),
        JTrainState.create(d_vars["params"], None, keep_gradients()), batch)
    return dict(g_vars=g_vars, d_vars=d_vars, p_vars=p_vars, batch=batch,
                metrics={k: float(v) for k, v in metrics.items()},
                xhat=np.asarray(xhat),
                g_grads=jax_to_state_dict({"params": _numpy(g2.opt_state)}),
                d_grads=jax_to_state_dict({"params": _numpy(d2.opt_state)}),
                stats=jax_to_state_dict({"batch_stats": _numpy(g2.batch_stats)}))


@pytest.fixture(scope="module")
def port(reference):
    """The port's step on the reference's weights and batch, and what it
    touched."""
    cfg = _tiny(tconfig.Config())
    gbase, disc, ploss, g_state, d_state = init_states(cfg, policy=FP32_POLICY,
                                                       device="cpu")
    load_jax_variables(gbase, reference["g_vars"])
    load_jax_variables(disc, reference["d_vars"])
    load_jax_variables(ploss, reference["p_vars"])
    before = {name: {k: v.clone() for k, v in m.state_dict().items()}
              for name, m in (("g", gbase), ("d", disc), ("p", ploss))}
    disc_before = copy.deepcopy(disc)
    gbase.g2d.cached_trunk_chain_params()
    folds_before = gbase.g2d.trunk_cache.folds
    batch = {k: t(v) for k, v in reference["batch"].items()}
    g_state, d_state, metrics, xhat = make_train_step(ploss, cfg)(g_state, d_state, batch)
    return dict(gbase=gbase, disc=disc, ploss=ploss, g_state=g_state,
                d_state=d_state, metrics=metrics, xhat=xhat, before=before,
                disc_before=disc_before, folds_before=folds_before, batch=batch)


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------


def test_config_defaults_match_jax():
    """Every JAX field with JAX's default, and no field of the port's own."""
    assert dataclasses.asdict(tconfig.Config()) == dataclasses.asdict(jconfig.Config())
    assert (dataclasses.asdict(tconfig.ModelConfig().parity())
            == dataclasses.asdict(jconfig.ModelConfig().parity()))
    for port, jax_cls in ((tconfig.Config, jconfig.Config),
                          (tconfig.ModelConfig, jconfig.ModelConfig)):
        assert ([f.name for f in dataclasses.fields(port)]
                == [f.name for f in dataclasses.fields(jax_cls)])


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(CONFIG_DIR, "*", "*.yaml"))),
                         ids=os.path.basename)
def test_load_config_matches_jax_field_for_field(path):
    got = dataclasses.asdict(tconfig.load_config(path))
    assert got == dataclasses.asdict(jconfig.load_config(path))


def test_make_arch_and_make_gbase():
    cfg = tconfig.Config()
    cfg.model.arch = "tiny"
    cfg.model.norm = "group"
    assert cfg.make_arch() == dataclasses.replace(TINY, norm="group")
    cfg.model.use_bf16 = False
    model = cfg.make_gbase(device="cpu")
    assert model.policy == FP32_POLICY
    assert model.motion_encoder.descriptor_input_size == 256


def test_make_gbase_use_chain_kernel(monkeypatch):
    """make_gbase's trunk engages K2 where the kernels' gate opens and
    JAX's rule allows (eval, norm 'batch', sides % 8): the wrapper is
    called once a sample there, and never in train mode, with the gate
    shut or with norm 'group'. On the CPU the wrapper runs its plain
    version, so the outputs equal the plain blocks'."""
    from megaportraits_tpu_torch.nn import blocks
    from megaportraits_tpu_torch.ops.kernels import resblock_chain as rc

    calls = []
    plain = rc.resblock_chain

    def counting(*args, **kwargs):
        calls.append(1)
        return plain(*args, **kwargs)

    monkeypatch.setattr(rc, "resblock_chain", counting)
    cfg = tconfig.Config()
    cfg.model.arch, cfg.model.use_bf16 = "tiny", False
    gbase = cfg.make_gbase(device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).random((2, 8, 8, cfg.make_arch().ch(512)),
                                                         dtype=np.float32))
    with torch.no_grad():
        shut = gbase.g2d.trunk(x)
        assert not calls
        monkeypatch.setattr(blocks, "kernel_takes", lambda tensors: True)
        got = gbase.g2d.trunk(x)
        assert len(calls) == 2
        torch.testing.assert_close(got, shut, rtol=1e-5, atol=1e-5)
        gbase.g2d.trunk(x, train=True)
        assert len(calls) == 2
    cfg.model.norm = "group"
    grouped = cfg.make_gbase(device="cpu")
    with torch.no_grad():
        grouped.g2d.trunk(x)
    assert len(calls) == 2


# ---------------------------------------------------------------------------
# Optimiser
# ---------------------------------------------------------------------------


class _Tree(torch.nn.Module):
    """A small module with a frozen 'rotation_net' subtree."""

    def __init__(self):
        super().__init__()
        self.head = torch.nn.Linear(4, 3)
        self.motion_encoder = torch.nn.Module()
        self.motion_encoder.rotation_net = torch.nn.Linear(3, 2)
        self.motion_encoder.fc = torch.nn.Linear(2, 5)


def _as_jax_tree(module):
    tree = {}
    for name, p in module.named_parameters():
        node = tree
        *path, leaf = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(p.detach().numpy())
    return tree


@pytest.mark.parametrize("grad_clip", [None, 1.5])
def test_optimizer_matches_optax(grad_clip):
    """5 steps with total_steps=4 (the schedule reaches its floor), large
    gradients (the clip acts on some steps), weight decay on, the
    rotation_net subtree frozen in both."""
    lr, total = 0.05, 4
    module = _Tree()
    rng = np.random.default_rng(7)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(t(rng.normal(size=p.shape).astype(np.float32)))
    params = _as_jax_tree(module)
    tx = j_make_optimizer(lr, total, params_example=params, grad_clip=grad_clip)
    opt_state = tx.init(params)
    opt = make_optimizer(module, lr, total, grad_clip=grad_clip)
    assert len(opt.params) == 4  # head and fc weights and biases
    frozen = {k: v.clone() for k, v in module.motion_encoder.rotation_net.state_dict().items()}
    for i in range(5):
        grads = {k: (rng.normal(size=p.shape) * (0.2 + i)).astype(np.float32)
                 for k, p in module.named_parameters()}
        jgrads = _as_jax_tree(module)
        for k, g in grads.items():
            node = jgrads
            *path, leaf = k.split(".")
            for part in path:
                node = node[part]
            node[leaf] = jnp.asarray(g)
        updates, opt_state = tx.update(jgrads, opt_state, params)
        params = optax.apply_updates(params, updates)
        named = dict(module.named_parameters())
        opt.step([t(grads[k]) for k, p in named.items() if p in set(opt.params)])
        for k, p in named.items():
            node = params
            for part in k.split("."):
                node = node[part]
            np.testing.assert_allclose(n(p), np.asarray(node), rtol=0, atol=1e-6,
                                       err_msg=f"step {i}: {k}")
    for k, v in module.motion_encoder.rotation_net.state_dict().items():
        assert torch.equal(v, frozen[k])


def test_cosine_factor_is_optax_schedule():
    lr, total, eta_min = 1e-3, 10, 1e-6
    sched = optax.cosine_decay_schedule(lr, total, alpha=eta_min / lr)
    for count in (0, 1, 5, 10, 12):
        assert abs(lr * cosine_factor(count, total, eta_min / lr)
                   - float(sched(count))) <= 1e-12 + 1e-6 * lr


# ---------------------------------------------------------------------------
# One whole step
# ---------------------------------------------------------------------------


def test_step_metrics_match_jax(reference, port):
    got = {k: v.item() for k, v in port["metrics"].items()}
    assert set(got) == set(reference["metrics"]) == METRIC_KEYS
    for k, want in reference["metrics"].items():
        assert np.isfinite(got[k]), k
        assert abs(got[k] - want) <= 1e-4 * max(abs(want), 1e-6), (k, got[k], want)
    assert got["loss_G_gaze"] == 0.0


def test_step_prediction_matches_jax(reference, port):
    assert port["xhat"].shape == (1, SIZE, SIZE, 3)
    np.testing.assert_allclose(n(port["xhat"]), reference["xhat"], atol=1e-4, rtol=0)


def test_step_generator_gradients_match_jax(reference, port):
    per_leaf, overall = grad_errors(port["gbase"], reference["g_grads"])
    assert len(per_leaf) > 250
    worst = max(per_leaf, key=per_leaf.get)
    assert overall <= 3e-2, overall
    assert per_leaf[worst] <= 1e-1, (worst, per_leaf[worst])
    # The frozen rotation net: no gradient in JAX, no parameter to train here.
    frozen = [k for k in reference["g_grads"] if "rotation_net" in k]
    assert frozen and all(not reference["g_grads"][k].any() for k in frozen)
    assert not any("rotation_net" in k for k, _ in trainable_parameters(port["gbase"]))


def test_step_discriminator_gradients_match_jax(reference, port):
    per_leaf, _ = grad_errors(port["disc"], reference["d_grads"])
    # All but the biases of convs that an InstanceNorm follows (zero).
    assert len(per_leaf) == len(list(port["disc"].parameters())) - (TINY.disc_stages - 1)
    for k, err in per_leaf.items():
        assert err <= 1e-4, (k, err)


def test_step_batch_norm_statistics_match_jax(reference, port):
    buffers = dict(port["gbase"].named_buffers())
    assert set(reference["stats"]) == set(buffers)
    moved = 0
    for k, want in reference["stats"].items():
        np.testing.assert_allclose(n(buffers[k]), want.numpy(), atol=1e-4, rtol=0,
                                   err_msg=k)
        moved += not torch.equal(buffers[k], port["before"]["g"][k])
    assert moved == len(buffers)  # every BatchNorm of G ran in train mode


def test_step_moves_trainable_and_keeps_frozen(port):
    """G and D take a step; the rotation net and the loss nets do not."""
    before = port["before"]
    for name, module in (("g", port["gbase"]), ("d", port["disc"])):
        state = module.state_dict()
        trainable = {k for k, _ in trainable_parameters(module)}
        for k in trainable:
            assert not torch.equal(state[k], before[name][k]), k
        for k in state:
            if "rotation_net" in k:
                assert torch.equal(state[k], before[name][k]), k
    for k, v in port["ploss"].state_dict().items():
        assert torch.equal(v, before["p"][k]), k
    assert port["g_state"].step == port["d_state"].step == 1


def test_discriminator_gradient_is_its_loss_on_the_detached_prediction(port):
    """D's gradient in the step equals the gradient of discriminator_loss
    alone, with D's pre-step weights, on the detached prediction: nothing
    of the G loss reaches D."""
    disc = port["disc_before"]
    xs, xd = port["batch"]["source"], port["batch"]["driving"]
    loss = discriminator_loss(disc(xd, xs), disc(port["xhat"], xs), "lsgan")
    want = torch.autograd.grad(loss, list(disc.parameters()))
    assert loss.item() == port["metrics"]["loss_D"].item()
    for p, w in zip(port["d_state"].params, want, strict=True):
        torch.testing.assert_close(p.grad, w, rtol=1e-6, atol=0)


def test_trunk_operands_fold_again_after_a_step(port):
    """The optimiser step and the BatchNorm updates move the trunk's
    tensors, so the cached K2 operands are folded again and equal a fresh
    fold."""
    g2d = port["gbase"].g2d
    got = g2d.cached_trunk_chain_params()
    assert g2d.trunk_cache.folds == port["folds_before"] + 1
    for a, b in zip(got, g2d.trunk_chain_params(), strict=True):
        assert torch.equal(a, b)
    g2d.cached_trunk_chain_params()
    assert g2d.trunk_cache.folds == port["folds_before"] + 1


def test_mask_branches():
    """A zero foreground mask leaves only the gaze constant of the two
    pyramid perceptual terms (2 x 4.0); all-ones gaze masks make the gaze
    term twice the pixel MSE."""
    cfg = _tiny(tconfig.Config())
    cfg.training.use_foreground_mask = True
    cfg.training.use_gaze_loss = True
    _, _, ploss, g_state, d_state = init_states(cfg, policy=FP32_POLICY, device="cpu")
    batch = {k: t(v) for k, v in _batch(seed=3).items()}
    batch["foreground_mask"] = torch.zeros(1, SIZE, SIZE, 1)
    batch["gaze_masks"] = torch.ones(1, SIZE, SIZE, 2)
    _, _, metrics, _ = make_train_step(ploss, cfg)(g_state, d_state, batch)
    assert metrics["loss_G_per"].item() == 2 * 4.0
    torch.testing.assert_close(metrics["loss_G_gaze"], 2 * metrics["loss_fm"])


def test_init_states_defaults_to_the_card():
    """Without a card, init_states raises unless asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_states(_tiny(tconfig.Config()))


@pytest.mark.parametrize("kind", ["empty", "missing", "no-step"])
def test_init_states_prints_the_pretrained_report_of_jax(kind, tmp_path, capsys):
    """An empty pretrained_path, one where nothing is, and a directory
    without an Orbax step: the port prints what JAX's loader reports."""
    path = {"empty": "", "missing": str(tmp_path / "nothing"),
            "no-step": str(tmp_path)}[kind]
    (tmp_path / "notes").mkdir()
    cfg = _tiny(tconfig.Config())
    cfg.training.pretrained_path = path
    init_states(cfg, policy=FP32_POLICY, device="cpu")
    _, _, want = maybe_load_pretrained(path)
    assert capsys.readouterr().out.splitlines() == [want]


def test_init_states_raises_on_a_pretrained_bundle(tmp_path):
    """A directory with an Orbax step (a subdirectory named by an integer,
    which Orbax's manager takes for one) holds a bundle the port cannot
    load yet: init_states refuses to train on random weights instead."""
    import orbax.checkpoint as ocp

    (tmp_path / "0").mkdir()
    assert ocp.CheckpointManager(str(tmp_path)).latest_step() == 0
    cfg = _tiny(tconfig.Config())
    cfg.training.pretrained_path = str(tmp_path)
    with pytest.raises(NotImplementedError, match="no loader"):
        init_states(cfg, policy=FP32_POLICY, device="cpu")
