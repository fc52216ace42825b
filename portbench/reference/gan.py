"""Adversarial objectives (counterpart of ``megaportraits_tpu/losses/gan.py``).

Every loss computes in float32 whatever the dtype of its inputs.
``loss_type`` is 'lsgan', 'vanilla' (sigmoid cross-entropy on logits) or
'hinge'.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def discriminator_loss(real_pred: torch.Tensor, fake_pred: torch.Tensor,
                       loss_type: str = "lsgan") -> torch.Tensor:
    """Mean of the real and the fake term."""
    real_pred = real_pred.float()
    fake_pred = fake_pred.float()
    if loss_type == "lsgan":
        real_loss = torch.mean((real_pred - 1.0) ** 2)
        fake_loss = torch.mean(fake_pred ** 2)
    elif loss_type == "vanilla":
        real_loss = F.binary_cross_entropy_with_logits(
            real_pred, torch.ones_like(real_pred))
        fake_loss = F.binary_cross_entropy_with_logits(
            fake_pred, torch.zeros_like(fake_pred))
    elif loss_type == "hinge":
        real_loss = torch.mean(torch.relu(1.0 - real_pred))
        fake_loss = torch.mean(torch.relu(1.0 + fake_pred))
    else:
        raise NotImplementedError(loss_type)
    return (real_loss + fake_loss) * 0.5


def generator_adversarial_loss(fake_pred: torch.Tensor,
                               loss_type: str = "lsgan") -> torch.Tensor:
    """The generator wants D(fake) -> real."""
    fake_pred = fake_pred.float()
    if loss_type == "lsgan":
        return torch.mean((fake_pred - 1.0) ** 2)
    if loss_type == "vanilla":
        return F.binary_cross_entropy_with_logits(fake_pred,
                                                  torch.ones_like(fake_pred))
    if loss_type == "hinge":
        return -torch.mean(fake_pred)
    raise NotImplementedError(loss_type)


def feature_matching_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """The reference's 'feature matching' is plain pixel MSE."""
    return torch.mean((pred.float() - target.float()) ** 2)
