"""The stage-1 training step, plain: a frozen copy of the port's step
(``train/train_base.py``) for one process, without the optional gaze and
foreground-mask terms (the stage-1 config sets neither), with AdamW from
``torch.optim`` at the port's settings: betas (0.5, 0.999), eps 1e-8,
decoupled weight decay 1e-2, the rate on the cosine schedule
``lr * ((1 - a) * 0.5 * (1 + cos(pi * min(t, T) / T)) + a)``, a = 1e-6 / lr,
T = ``base_epochs`` steps. Parameters under ``rotation_net`` (the frozen
SixDRepNet) are not trained. A gradient that does not reach a trained
parameter counts as zero, as in the port.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
from torch import nn

from portbench.reference.cycle import cosine_loss
from portbench.reference.gan import (
    discriminator_loss,
    feature_matching_loss,
    generator_adversarial_loss,
)
from portbench.reference.resize import linear_resize

FROZEN_KEYS = ("rotation_net",)
ETA_MIN = 1e-6


def _trained(name: str) -> bool:
    return not any(f in part for part in name.split(".") for f in FROZEN_KEYS)


def trainable(module: nn.Module) -> List[nn.Parameter]:
    return [p for name, p in module.named_parameters() if _trained(name)]


def trainable_names(module: nn.Module) -> List[str]:
    return [name for name, _ in module.named_parameters() if _trained(name)]


def optimizer(params: List[nn.Parameter], lr: float, total_steps: int):
    alpha = ETA_MIN / lr if lr > 0 else 0.0
    t = max(total_steps, 1)
    opt = torch.optim.AdamW(params, lr=lr, betas=(0.5, 0.999), eps=1e-8,
                            weight_decay=1e-2)
    schedule = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda c: (1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * min(c, t) / t)) + alpha)
    return opt, schedule


def g_losses(gbase, disc, ploss, batch: Dict[str, torch.Tensor], w: Dict[str, float]):
    xs, xd, xs_star = batch["source"], batch["driving"], batch["source_star"]
    b = xs.shape[0]

    def split(x, n):
        return [x[i * b:(i + 1) * b] for i in range(n)]

    vs_all, es_all = gbase.encode_appearance(torch.cat([xs, xs_star]), True)
    (vs_s, vs_star), (es_s, es_star) = split(vs_all, 2), split(es_all, 2)
    r_all, t_all, z_all = gbase.encode_motion(torch.cat(
        [xs, xd, batch["source_next"], xs_star, batch["driving_star"]]), True)
    rs, rd, rn, rst, _ = split(r_all, 5)
    ts, td, tn, tst, _ = split(t_all, 5)
    zs, zd, zn, zst, zd_star = split(z_all, 5)
    out = gbase.synthesize(
        torch.cat([vs_s, vs_star, vs_s, vs_s]), torch.cat([es_s, es_star, es_s, es_s]),
        torch.cat([rs, rst, rn, rs]), torch.cat([ts, tst, tn, ts]),
        torch.cat([zs, zst, zs, zn]),
        torch.cat([rd, rd, rn, rs]), torch.cat([td, td, tn, ts]),
        torch.cat([zd, zd, zs, zn]), True)
    xhat, xhat_star, i_pose, i_exp = split(out, 4)

    loss_per = 0.0
    for pred_scaled in gbase.pyramids(xhat).values():
        tgt = linear_resize(xd, pred_scaled.shape[1:3], axes=(1, 2), align_corners=False)
        loss_per = loss_per + ploss(pred_scaled, tgt)
    loss_adv = generator_adversarial_loss(disc(xhat, xs), "lsgan")
    loss_fm = feature_matching_loss(xhat, xd)
    _, _, z_pred_all = gbase.encode_motion(torch.cat([xhat, xhat_star]), True)
    z_pred, z_star_pred = split(z_pred_all, 2)
    loss_cos = cosine_loss([(z_pred, zd), (z_star_pred, zd)],
                           [(z_pred, zd_star), (z_star_pred, zd_star)])
    loss_pairwise = torch.mean(torch.abs(i_pose.float() - i_exp.float()))
    loss_identity = ploss(xhat_star, xs_star)
    total = (w["per"] * loss_per + w["adv"] * loss_adv + w["fm"] * loss_fm
             + w["cos"] * loss_cos + w["pairwise"] * loss_pairwise
             + w["identity"] * loss_identity)
    return total, xhat


class Trainer:
    """Gbase and the discriminator with their optimisers; ``step(batch)``
    takes one step and returns {'loss_G', 'loss_D'} as float32 scalars."""

    def __init__(self, gbase, disc, ploss, training: Dict):
        self.gbase, self.disc, self.ploss = gbase, disc, ploss
        self.w = {k: float(training[f"w_{k}"])
                  for k in ("per", "adv", "fm", "cos", "pairwise", "identity")}
        total = int(training["base_epochs"]) * int(training.get("steps_per_epoch") or 1)
        self.g_params = trainable(gbase)
        self.d_params = trainable(disc)
        self.g_opt = optimizer(self.g_params, float(training["lr"]), total)
        self.d_opt = optimizer(self.d_params, float(training["lr"]), total)

    def step(self, batch: Dict[str, torch.Tensor]):
        self.gbase.train()
        total, xhat = g_losses(self.gbase, self.disc, self.ploss, batch, self.w)
        with self.gbase.policy.conv_scope():
            g_grads = torch.autograd.grad(total, self.g_params, allow_unused=True)
        xhat = xhat.detach()
        xs, xd = batch["source"], batch["driving"]
        loss_d = discriminator_loss(self.disc(xd, xs), self.disc(xhat, xs), "lsgan")
        with self.gbase.policy.conv_scope():
            d_grads = torch.autograd.grad(loss_d, self.d_params, allow_unused=True)
        for params, grads, (opt, schedule) in ((self.g_params, g_grads, self.g_opt),
                                               (self.d_params, d_grads, self.d_opt)):
            for p, g in zip(params, grads):
                p.grad = torch.zeros_like(p) if g is None else g
            opt.step()
            schedule.step()
        return {"loss_G": total.detach().float(), "loss_D": loss_d.detach().float()}
