"""Disentanglement losses (counterpart of ``megaportraits_tpu/losses/pairwise.py``).

Pairwise transfer: two frames of the same video re-mixed through Gbase's
synthesis (``Gbase.pairwise_outputs``), pose of i2 with the expression of
i1 against pose of i1 with the expression of i2, and the L1 between the
two outputs. Identity similarity: the negative cosine similarity of two
identity embeddings.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.nn.functional as F


def pairwise_transfer_loss(
        pairwise_fn: Callable[[torch.Tensor, torch.Tensor, bool],
                              Tuple[torch.Tensor, torch.Tensor]],
        i1: torch.Tensor, i2: torch.Tensor, train: bool = False) -> torch.Tensor:
    """L1 between the pose-transfer and the expression-transfer outputs of
    ``pairwise_fn(i1, i2, train)`` (e.g. ``Gbase.pairwise_outputs``)."""
    i_pose, i_exp = pairwise_fn(i1, i2, train)
    return torch.mean(torch.abs(i_pose.float() - i_exp.float()))


def identity_similarity_loss(embed_fn: Callable[[torch.Tensor], torch.Tensor],
                             source: torch.Tensor,
                             transferred: torch.Tensor) -> torch.Tensor:
    """Negative cosine similarity between identity embeddings."""
    a = F.normalize(embed_fn(source).float(), dim=-1, eps=1e-12)
    b = F.normalize(embed_fn(transferred).float(), dim=-1, eps=1e-12)
    return -torch.mean((a * b).sum(dim=-1))
