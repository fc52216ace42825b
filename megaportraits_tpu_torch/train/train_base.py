"""Stage-1 base training: Gbase against the PatchGAN discriminator
(counterpart of ``megaportraits_tpu/train/train_base.py``).

One step does what the JAX step does, in its order:
  * every auxiliary pass rides one batched application of a sub-network:
    appearance once on [xs; xs*], motion once on [xs; xd; xs_next; xs*;
    xd*], ``synthesize`` once on the four descriptor mixes (main,
    cross-reenactment, pairwise pose, pairwise expression), motion once
    more on [xhat; xhat*]. Train-mode BatchNorm normalises over these
    concatenated batches, and the model (in ``.train()``) records its
    running statistics in the order of the calls;
  * the G loss: w_per x the pyramid perceptual loss (scales 0.5 and 0.25
    against the bilinearly resized driving frame) + w_adv x LSGAN through
    the frozen D + w_fm x pixel MSE + w_cos x the cycle cosine loss +
    w_pairwise x the pairwise-transfer L1 + w_identity x the perceptual
    loss between xs* and its cross-reenactment (+ lambda_gaze x the masked
    gaze MSE when enabled);
  * G's gradients reach xhat through D, none reach D's parameters;
  * the D loss on the detached xhat with D's pre-step parameters;
  * both optimisers step after both gradients exist.
Both gradients are taken under Gbase's ``Policy.backward_scope``: a float32
step convolves without TF32 backward as well as forward.
The step is the span ``train.step``, its phases the spans
``train.g_forward``, ``train.g_backward`` (remat's recompute falls in it),
``train.d_step`` and ``train.optimizer`` (``utils/profiling.annotate``).
The step trains on PyTorch convolutions under autograd: train-mode
BatchNorm cannot be folded into the kernels' epilogues, so the kernels'
gate (``nn/blocks.kernel_engages``) keeps K2 and K4 out when ``train`` is
set, as the JAX package bypasses its Pallas kernels (which have no
backward there).

``make_train_step`` keeps the JAX function's ``unroll`` (several steps on
batches stacked on a leading axis, in one call) and ``pool_index`` (a batch
pool kept on the device, indexed per step). JAX folds them into one jitted
device program; here they are plain loops and an index, with JAX's
signatures and results.

Data parallelism (``parallel/mesh.py``): with a mesh, each rank's batch is
its rows of the global batch (``shard_batch``), ``init_states`` broadcasts
the models from rank 0 and makes their BatchNorms normalise over the data
group, the cycle loss sums its negatives over it, the optimisers average
the gradients (and shard what ``model`` shards), and the metrics are the
mean over the ranks: the global batch's, as one process prints them.
``init_states`` also picks JAX's remat default: 'selective' at 256 pixels
and above, 'none' below.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import torch

from megaportraits_tpu_torch.core.config import Config
from megaportraits_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device
from megaportraits_tpu_torch.core.dtypes import DEFAULT_POLICY, Policy
from megaportraits_tpu_torch.losses.cycle import cosine_loss
from megaportraits_tpu_torch.losses.gan import (
    discriminator_loss,
    feature_matching_loss,
    generator_adversarial_loss,
)
from megaportraits_tpu_torch.losses.gaze import mp_gaze_loss
from megaportraits_tpu_torch.losses.perceptual import (
    DEFAULT_WEIGHTS,
    PerceptualLoss,
    build_perceptual_loss,
)
from megaportraits_tpu_torch.models.discriminator import Discriminator, build_discriminator
from megaportraits_tpu_torch.models.gbase import Gbase
from megaportraits_tpu_torch.ops.resize import linear_resize
from megaportraits_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    axis_group,
    distribute,
    is_main_process,
    mean_over_ranks,
)
from megaportraits_tpu_torch.train.state import TrainState, make_optimizer
from megaportraits_tpu_torch.utils.pretrained import maybe_load_pretrained
from megaportraits_tpu_torch.utils.profiling import annotate


class BaseTrainer(NamedTuple):
    """The stage-1 modules and step, bundled (JAX's ``BaseTrainer``)."""

    gbase: Gbase
    disc: Discriminator
    ploss: PerceptualLoss
    train_step: Any  # (g_state, d_state, batch) -> (g_state, d_state, metrics, xhat)


def init_states(cfg: Config, seed: int = 0, policy: Policy = DEFAULT_POLICY,
                device: Union[str, torch.device] = DEFAULT_DEVICE,
                image_size: Optional[int] = None, remat_mode: Optional[str] = None,
                mesh=None
                ) -> Tuple[Gbase, Discriminator, PerceptualLoss, TrainState, TrainState]:
    """Gbase, the discriminator and the frozen perceptual loss with seeded
    random weights on `device` (the card by default; raises if there is
    none and the caller did not ask for the CPU), the pretrained bundle at
    ``cfg.training.pretrained_path`` grafted into Gbase and the loss when
    there is one (JAX's report printed either way; a directory with only
    JAX's Orbax bundle raises), and the G and D states with their
    optimisers (``cfg.training.lr`` over ``base_epochs * steps_per_epoch``
    steps). Gbase's `remat_mode` defaults as in JAX: 'selective' when the
    training size (`image_size`, else ``cfg.data.train_width``) is at least
    256, else 'none'. With a `mesh`, the models are distributed over it
    (``distribute``) and the optimisers make its collectives."""
    dev = resolve_device(device)
    size = image_size or cfg.data.train_width
    if remat_mode is None:
        remat_mode = "selective" if size >= 256 else "none"
    arch = cfg.make_arch()
    gbase = cfg.make_gbase(policy=policy, device=dev, seed=seed, remat=remat_mode)
    disc = build_discriminator(arch, policy=policy, device=dev, seed=seed + 1)
    ploss = build_perceptual_loss(arch, policy=policy, device=dev, seed=seed + 2,
                                  weights=DEFAULT_WEIGHTS)
    gbase, ploss, report = maybe_load_pretrained(cfg.training.pretrained_path, gbase, ploss)
    if is_main_process():
        print(report)
    for model in (gbase, disc, ploss):
        distribute(model, mesh)
    t = cfg.training
    total_steps = t.base_epochs * (t.steps_per_epoch or 1)
    g_state = TrainState(gbase, make_optimizer(gbase, t.lr, total_steps, mesh=mesh))
    d_state = TrainState(disc, make_optimizer(disc, t.lr, total_steps, mesh=mesh))
    return gbase, disc, ploss, g_state, d_state


def make_train_step(ploss: PerceptualLoss, cfg: Config, unroll: int = 1,
                    pool_index: bool = False, mesh=None):
    """The stage-1 step ``(g_state, d_state, batch) -> (g_state, d_state,
    metrics, xhat)``. `batch` holds [B, H, W, 3] images in [0, 1] under
    'source', 'driving', 'source_next', 'source_star', 'driving_star', and
    'foreground_mask' [B, H, W, 1] / 'gaze_masks' [B, H, W, 2] when the
    config asks for them. The states are updated in place and returned;
    the metrics are detached float32 scalars.

    With ``unroll > 1`` the step takes batches stacked on a leading
    [unroll] axis, takes one step on each in order, and returns the last
    step's metrics and ``xhat=None`` (it steps once per entry of the
    leading axis, as JAX's scan does). With ``pool_index=True`` it is
    ``(g_state, d_state, pool, i)``: the step on batch `i` of `pool`, a
    batch dict with a leading pool axis that stays on the device. The two
    exclude each other (``ValueError``).

    With a `mesh` (from ``init_states(..., mesh=mesh)``) `batch` holds this
    rank's rows of the global batch (along the batch axis, the second one
    when unrolled) and the metrics are the mean over the ranks."""
    if pool_index and unroll > 1:
        raise ValueError("pool_index and unroll>1 are mutually exclusive")
    t = cfg.training
    w = dict(per=t.w_per, adv=t.w_adv, fm=t.w_fm, cos=t.w_cos,
             pairwise=t.w_pairwise, identity=t.w_identity)

    def g_losses(gbase: Gbase, disc: Discriminator, batch: Dict[str, torch.Tensor]):
        xs = batch["source"]
        xd = batch["driving"]
        xs_star = batch["source_star"]
        fg_mask = batch.get("foreground_mask") if t.use_foreground_mask else None
        gaze_masks = batch.get("gaze_masks") if t.use_gaze_loss else None
        b = xs.shape[0]

        def split(x, n):
            return [x[i * b:(i + 1) * b] for i in range(n)]

        # Appearance: [xs; xs*] in one pass.
        vs_all, es_all = gbase.encode_appearance(torch.cat([xs, xs_star]), True)
        (vs_s, vs_star), (es_s, es_star) = split(vs_all, 2), split(es_all, 2)
        # Motion: the five input images in one pass.
        r_all, t_all, z_all = gbase.encode_motion(torch.cat(
            [xs, xd, batch["source_next"], xs_star, batch["driving_star"]]), True)
        rs, rd, rn, rst, _ = split(r_all, 5)
        ts, td, tn, tst, _ = split(t_all, 5)
        zs, zd, zn, zst, zd_star = split(z_all, 5)
        # Synthesis: the four descriptor mixes in one pass -- main, cross-
        # reenactment (xs* appearance), pairwise pose (pose of xs_next,
        # expression of xs), pairwise expression (pose of xs, expression of
        # xs_next); both warp generators get the same mixed descriptors.
        out = gbase.synthesize(
            torch.cat([vs_s, vs_star, vs_s, vs_s]), torch.cat([es_s, es_star, es_s, es_s]),
            torch.cat([rs, rst, rn, rs]), torch.cat([ts, tst, tn, ts]),
            torch.cat([zs, zst, zs, zn]),
            torch.cat([rd, rd, rn, rs]), torch.cat([td, td, tn, ts]),
            torch.cat([zd, zd, zs, zn]), True)
        xhat, xhat_star, i_pose, i_exp = split(out, 4)

        # Pyramid perceptual loss against the driving frame.
        loss_per = 0.0
        for pred_scaled in gbase.pyramids(xhat).values():
            size = pred_scaled.shape[1:3]
            tgt = linear_resize(xd, size, axes=(1, 2), align_corners=False)
            if fg_mask is not None:
                m = linear_resize(fg_mask.to(pred_scaled.dtype), size, axes=(1, 2),
                                  align_corners=False)
                pred_scaled = pred_scaled * m
                tgt = tgt * m
            loss_per = loss_per + ploss(pred_scaled, tgt)

        # Adversarial through D; the caller takes gradients for G only.
        loss_adv = generator_adversarial_loss(disc(xhat, xs), "lsgan")
        loss_fm = feature_matching_loss(xhat, xd)
        # Cycle cosine: motion descriptors of both predictions in one pass.
        _, _, z_pred_all = gbase.encode_motion(torch.cat([xhat, xhat_star]), True)
        z_pred, z_star_pred = split(z_pred_all, 2)
        loss_cos = cosine_loss([(z_pred, zd), (z_star_pred, zd)],
                               [(z_pred, zd_star), (z_star_pred, zd_star)],
                               group=axis_group(mesh, DATA_AXIS))
        loss_pairwise = torch.mean(torch.abs(i_pose.float() - i_exp.float()))
        loss_identity = ploss(xhat_star, xs_star)

        total = (w["per"] * loss_per + w["adv"] * loss_adv + w["fm"] * loss_fm
                 + w["cos"] * loss_cos + w["pairwise"] * loss_pairwise
                 + w["identity"] * loss_identity)
        loss_gaze = torch.zeros((), dtype=torch.float32, device=xs.device)
        if gaze_masks is not None:
            m = gaze_masks.float()
            loss_gaze = mp_gaze_loss(xhat, xd, m[..., 0:1], m[..., 1:2])
            total = total + t.lambda_gaze * loss_gaze
        metrics = {"loss_G": total, "loss_G_per": loss_per, "loss_G_adv": loss_adv,
                   "loss_fm": loss_fm, "loss_G_cos": loss_cos,
                   "loss_pairwise": loss_pairwise, "loss_identity": loss_identity,
                   "loss_G_gaze": loss_gaze}
        return total, metrics, xhat

    def step(g_state: TrainState, d_state: TrainState, batch: Dict[str, torch.Tensor]):
        with annotate("train.step"):
            gbase, disc = g_state.model, d_state.model
            gbase.train()
            with annotate("train.g_forward"):
                total, metrics, xhat = g_losses(gbase, disc, batch)
            with annotate("train.g_backward"), gbase.policy.backward_scope():
                g_grads = torch.autograd.grad(total, g_state.params, allow_unused=True)

            # D on the detached prediction, with its parameters as they were.
            with annotate("train.d_step"):
                xhat = xhat.detach()
                xs, xd = batch["source"], batch["driving"]
                loss_d = discriminator_loss(disc(xd, xs), disc(xhat, xs), "lsgan")
                with gbase.policy.backward_scope():
                    d_grads = torch.autograd.grad(loss_d, d_state.params,
                                                  allow_unused=True)
                metrics["loss_D"] = loss_d

            with annotate("train.optimizer"):
                g_state.apply_gradients(g_grads)
                d_state.apply_gradients(d_grads)
                metrics = mean_over_ranks({k: v.detach() for k, v in metrics.items()},
                                          mesh)
            return g_state, d_state, metrics, xhat

    if pool_index:
        def pool_step(g_state: TrainState, d_state: TrainState,
                      pool: Dict[str, torch.Tensor], i):
            return step(g_state, d_state, {k: v[i] for k, v in pool.items()})

        return pool_step
    if unroll <= 1:
        return step

    def multi_step(g_state: TrainState, d_state: TrainState,
                   batches: Dict[str, torch.Tensor]):
        for j in range(len(next(iter(batches.values())))):
            g_state, d_state, metrics, _ = step(
                g_state, d_state, {k: v[j] for k, v in batches.items()})
        return g_state, d_state, metrics, None

    return multi_step
