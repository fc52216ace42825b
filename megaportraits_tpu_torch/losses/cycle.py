"""Cycle-consistency cosine contrastive loss (counterpart of
``megaportraits_tpu/losses/cycle.py``).

Positive pairs P = [(z_pred, z_d), (z*_pred, z_d)], negative pairs
N = [(z_pred, z_d*), (z*_pred, z_d*)]; cosine similarities minus a margin of
0.5, scaled by 5; loss = -log(exp(pos) / (exp(pos) + sum(exp(neg)))),
averaged. As in the reference, exp(neg) is summed over ALL negative
elements, pairs and batch together: under data parallelism that sum spans
the global batch, summed over the data group (`group`) by a reduction that
autograd differentiates, as JAX's GSPMD sums it.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

from megaportraits_tpu_torch.parallel.mesh import all_reduce_sum


def _cosine_distance(z_i: torch.Tensor, z_j: torch.Tensor, margin: float,
                     scale: float) -> torch.Tensor:
    z_i = F.normalize(z_i, dim=-1, eps=1e-12)
    z_j = F.normalize(z_j, dim=-1, eps=1e-12)
    return scale * ((z_i * z_j).sum(dim=-1) - margin)


def cosine_loss(positive_pairs: List[Tuple[torch.Tensor, torch.Tensor]],
                negative_pairs: List[Tuple[torch.Tensor, torch.Tensor]],
                margin: float = 0.5, scale: float = 5.0, group=None) -> torch.Tensor:
    """The loss over this rank's rows; with `group` (the data-parallel
    group) the negatives' sum is the global batch's, so that the mean of
    the ranks' losses is the loss of the global batch."""
    pos = torch.stack([_cosine_distance(a.float(), b.float(), margin, scale)
                       for a, b in positive_pairs])
    neg = torch.stack([_cosine_distance(a.float(), b.float(), margin, scale)
                       for a, b in negative_pairs])
    neg_sum = torch.exp(neg).sum()
    if group is not None:
        neg_sum = all_reduce_sum(neg_sum, group)
    return torch.mean(-(pos - torch.log(torch.exp(pos) + neg_sum)))
