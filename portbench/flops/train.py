"""Operations of one stage-1 training step, counted from shapes: the plain
reference's step (G's losses with VGG19 and LPIPS, G's gradients, D's
loss and gradients; forward and backward, no recompute: remat 'none')
under ``torch.utils.flop_counter`` on the meta device. The optimiser's
elementwise work is not counted."""

from __future__ import annotations

from typing import Dict

import torch
from torch.utils.flop_counter import FlopCounterMode

KEYS = ("source", "driving", "source_next", "source_star", "driving_star")


def train_flops_per_step(config: Dict, batch: int) -> float:
    from portbench.reference.arch import Arch
    from portbench.reference.discriminator import Discriminator
    from portbench.reference.gan import discriminator_loss
    from portbench.reference.gbase import Gbase
    from portbench.reference.perceptual import DEFAULT_WEIGHTS, PerceptualLoss
    from portbench.reference.train_base import g_losses, trainable
    from portbench.spec import arch_fields

    a = Arch(**arch_fields(config))
    s = config["image_size"]
    t = config["training"]
    w = {k: float(t[f"w_{k}"]) for k in ("per", "adv", "fm", "cos", "pairwise", "identity")}
    with torch.device("meta"):
        gbase = Gbase(arch=a).train()
        disc = Discriminator(arch=a)
        ploss = PerceptualLoss(DEFAULT_WEIGHTS, arch=a).requires_grad_(False).eval()
    b = {k: torch.empty(batch, s, s, 3, device="meta") for k in KEYS}
    with FlopCounterMode(display=False) as counter:
        total, xhat = g_losses(gbase, disc, ploss, b, w)
        torch.autograd.grad(total, trainable(gbase), allow_unused=True)
        loss_d = discriminator_loss(disc(b["driving"], b["source"]),
                                    disc(xhat.detach(), b["source"]), "lsgan")
        torch.autograd.grad(loss_d, trainable(disc), allow_unused=True)
    return float(counter.get_total_flops())
