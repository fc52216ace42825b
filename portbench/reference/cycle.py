"""Cycle-consistency cosine contrastive loss (counterpart of
``megaportraits_tpu/losses/cycle.py``).

Positive pairs P = [(z_pred, z_d), (z*_pred, z_d)], negative pairs
N = [(z_pred, z_d*), (z*_pred, z_d*)]; cosine similarities minus a margin of
0.5, scaled by 5; loss = -log(exp(pos) / (exp(pos) + sum(exp(neg)))),
averaged. As in the reference, exp(neg) is summed over ALL negative
elements, pairs and batch together.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F


def _cosine_distance(z_i: torch.Tensor, z_j: torch.Tensor, margin: float,
                     scale: float) -> torch.Tensor:
    z_i = F.normalize(z_i, dim=-1, eps=1e-12)
    z_j = F.normalize(z_j, dim=-1, eps=1e-12)
    return scale * ((z_i * z_j).sum(dim=-1) - margin)


def cosine_loss(positive_pairs: List[Tuple[torch.Tensor, torch.Tensor]],
                negative_pairs: List[Tuple[torch.Tensor, torch.Tensor]],
                margin: float = 0.5, scale: float = 5.0) -> torch.Tensor:
    pos = torch.stack([_cosine_distance(a.float(), b.float(), margin, scale)
                       for a, b in positive_pairs])
    neg = torch.stack([_cosine_distance(a.float(), b.float(), margin, scale)
                       for a, b in negative_pairs])
    neg_sum = torch.exp(neg).sum()
    return torch.mean(-(pos - torch.log(torch.exp(pos) + neg_sum)))
