"""The ROME loss catalogue (counterpart of ``megaportraits_tpu/losses/rome.py``):
multi-discriminator hinge, PSNR, the random affine + TPS ``Transform`` with
its jacobian, the equivariance, Laplacian-mesh, feature-matching, weighted
68-keypoint, segmentation, silhouette, lip/eye closure and head-pose losses,
the chamfer distance and the ImageNet normalisation. Channels last, float32
math, as in JAX.

``Transform`` draws its parameters from a ``torch.Generator`` (or takes them
given), and its jacobian is ``torch.func.jacfwd`` under ``torch.func.vmap``,
where JAX uses ``jax.jacfwd`` under ``jax.vmap``.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from megaportraits_tpu_torch.ops.resize import linear_resize, nearest_resize
from megaportraits_tpu_torch.ops.warp import grid_sample_2d

Tensor = torch.Tensor
ScoreLists = Sequence[Sequence[Tensor]]


def _zero(like: Tensor) -> Tensor:
    return torch.zeros((), dtype=torch.float32, device=like.device)


def adversarial_loss(fake_scores: ScoreLists, real_scores: Optional[ScoreLists] = None,
                     mode: str = "gen", loss_type: str = "hinge") -> Tensor:
    """Multi-discriminator, multi-output hinge loss."""
    assert loss_type == "hinge", "the reference implements hinge only"
    loss = _zero(fake_scores[0][0])
    if mode == "dis":
        for real_net, fake_net in zip(real_scores, fake_scores):
            lr = sum(torch.mean(torch.relu(1.0 - r)) for r in real_net)
            lf = sum(torch.mean(torch.relu(1.0 + f)) for f in fake_net)
            loss = loss + lr / len(real_net) + lf / len(fake_net)
    elif mode == "gen":
        for fake_net in fake_scores:
            loss = loss + sum(-torch.mean(f) for f in fake_net) / len(fake_net)
    else:
        raise ValueError(mode)
    return loss / len(fake_scores)


def psnr(pred: Tensor, target: Tensor, data_range: float = 1.0) -> Tensor:
    mse = torch.mean((pred.float() - target.float()) ** 2)
    return 10.0 * torch.log10(data_range**2 / mse)


@functools.lru_cache(maxsize=None)
def make_grid(h: int, w: int) -> np.ndarray:
    """[1, h*w, 2] identity grid in [-1, 1], (x, y)."""
    xs = np.linspace(-1.0, 1.0, w)
    ys = np.linspace(-1.0, 1.0, h)
    return np.stack(np.meshgrid(xs, ys), axis=-1).reshape(1, -1, 2).astype(np.float32)


class Transform:
    """Random affine + TPS image transform.

    ``theta`` [b, 1, 2, 3] = the identity affine + N(0, sigma_affine);
    ``control_params`` [b, 1, points_tps**2] ~ N(0, sigma_tps), both drawn
    from `generator` on `device` unless given.
    """

    def __init__(self, batch: int, sigma_affine: float, sigma_tps: float,
                 points_tps: int, generator: Optional[torch.Generator] = None,
                 device=None, theta: Optional[Tensor] = None,
                 control_params: Optional[Tensor] = None):
        dev = torch.device(device) if device is not None else (
            generator.device if generator is not None else torch.device("cpu"))
        if theta is None:
            noise = torch.randn(batch, 2, 3, generator=generator, device=dev) * sigma_affine
            eye = torch.cat([torch.eye(2, device=dev), torch.zeros(2, 1, device=dev)], dim=1)
            theta = (noise + eye[None])[:, None]
        if control_params is None:
            control_params = torch.randn(batch, 1, points_tps**2, generator=generator,
                                         device=dev) * sigma_tps
        self.theta = theta.float().to(dev)
        self.control_params = control_params.float().to(dev)
        self.control_grid = torch.as_tensor(make_grid(points_tps, points_tps), device=dev)

    def warp_pts(self, pts: Tensor) -> Tensor:
        """pts [1 or b, n, 2] -> [b, n, 2]: the affine part, plus one TPS
        radial term added to both coordinates (JAX's einsum sums its
        leading point axis, and so does this one)."""
        pts_t = torch.einsum("boij,pnj->bni", self.theta[..., :2], pts)
        pts_t = pts_t + self.theta[:, 0, :, 2][:, None, :]
        pdists = torch.abs(pts[:, :, None] - self.control_grid[:, None]).sum(-1)
        radial = pdists**2 * torch.log(pdists + 1e-5)
        return pts_t + torch.sum(radial * self.control_params, dim=-1, keepdim=True)

    def transform_img(self, img: Tensor) -> Tensor:
        """img [B, H, W, C] -> the TPS-warped image (reflection padding)."""
        b, h, w, _ = img.shape
        grid = torch.as_tensor(make_grid(h, w), device=img.device)
        warped = self.warp_pts(grid).reshape(b, h, w, 2)
        return grid_sample_2d(img, warped, align_corners=False, padding_mode="reflection")

    def jacobian(self, pts: Tensor) -> Tensor:
        """d warp_pts / d pts per point: [b, n, 2, 2]."""
        def single(p):  # [2] -> [b, 2]
            return self.warp_pts(p[None, None, :])[:, 0, :]

        jac = torch.func.vmap(torch.func.jacfwd(single))(pts.reshape(-1, 2))
        return jac.permute(1, 0, 2, 3)


def equivariance_loss(img: Tensor, kp: Tensor, jac: Tensor,
                      kp_detector: Callable[[Tensor], Tuple[Tensor, Tensor]],
                      transform: Transform):
    """(loss_kp, loss_jac, img_t, kp_t, kp_recon); kp [b, n, 2] in
    [-1, 1], jac [b, n, 2, 2]."""
    img_t = transform.transform_img(img)
    kp_t, jac_t = kp_detector(img_t)
    kp_recon = transform.warp_pts(kp_t)
    loss_kp = torch.mean(torch.abs(kp - kp_recon))
    jac_recon = torch.matmul(transform.jacobian(kp_t), jac_t)
    eye = torch.eye(2, device=img.device)[None, None]
    loss_jac = torch.mean(torch.abs(torch.matmul(torch.linalg.inv(jac), jac_recon) - eye))
    return loss_kp, loss_jac, img_t, kp_t, kp_recon


def laplace_mesh_loss(verts: Tensor, faces: np.ndarray) -> Tensor:
    """Mean norm of the uniform Laplacian of the vertices [B, V, 3];
    faces [F, 3] int."""
    v = verts.float()
    nv = v.shape[1]
    edges = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]], axis=0)
    edges = np.unique(np.sort(edges, axis=1), axis=0)
    adj = np.zeros((nv, nv), dtype=np.float32)
    adj[edges[:, 0], edges[:, 1]] = 1.0
    adj[edges[:, 1], edges[:, 0]] = 1.0
    lap = torch.as_tensor(adj / np.maximum(adj.sum(1, keepdims=True), 1.0), device=v.device)
    delta = torch.einsum("vu,buc->bvc", lap, v) - v
    return torch.mean(torch.linalg.vector_norm(delta, dim=-1))


def feature_matching_loss(real_features, fake_features, loss_type: str = "l1") -> Tensor:
    """Nested (network, layer, input) feature-matching loss."""
    loss = _zero(fake_features[0][0][0])
    for real_net, fake_net in zip(real_features, fake_features):
        loss_net = _zero(loss)
        for real_layer, fake_layer in zip(real_net, fake_net):
            if len(real_layer) == 1:
                real_layer = [real_layer[0]] * len(fake_layer)
            for r, f in zip(real_layer, fake_layer):
                diff = f.float() - r.float()
                loss_net = loss_net + (torch.mean(torch.abs(diff)) if loss_type == "l1"
                                       else torch.mean(diff**2))
        loss = loss + loss_net / len(fake_layer) / len(fake_net)
    return loss / len(real_features)


KP68_WEIGHTS = np.ones(68, dtype=np.float32)
KP68_WEIGHTS[5:7] = 2.0
KP68_WEIGHTS[10:12] = 2.0
KP68_WEIGHTS[27:36] = 1.5
KP68_WEIGHTS[30] = 3.0
KP68_WEIGHTS[31] = 3.0
KP68_WEIGHTS[35] = 3.0
KP68_WEIGHTS[60:68] = 1.5
KP68_WEIGHTS[48:60] = 1.5
KP68_WEIGHTS[48] = 3.0
KP68_WEIGHTS[54] = 3.0


def keypoints_matching_loss(pred_keypoints: Tensor, keypoints: Tensor) -> Tensor:
    """Weighted 68-landmark L1."""
    w = torch.as_tensor(KP68_WEIGHTS, device=keypoints.device)
    diff = torch.abs(pred_keypoints - keypoints).mean(-1)  # [b, 68]
    return torch.mean(torch.sum(diff * w[None] / w.sum(), dim=-1))


def segmentation_loss(pred_seg_logits: Tensor, target_segs: Tensor,
                      loss_type: str = "bce_with_logits") -> Tensor:
    """NHWC masks; the target resized (bilinear) to the logits' size."""
    if target_segs.shape[1] != pred_seg_logits.shape[1]:
        target_segs = linear_resize(target_segs, pred_seg_logits.shape[1:3], axes=(1, 2),
                                    align_corners=False)
    p, t = pred_seg_logits.float(), target_segs.float()
    if loss_type == "bce_with_logits":
        return F.binary_cross_entropy_with_logits(p, t)
    if loss_type == "dice":
        pred = torch.sigmoid(p).reshape(p.shape[0], -1)
        tgt = t.reshape(t.shape[0], -1)
        inter = torch.mean(pred * tgt, dim=1)
        card = torch.mean(pred**2 + tgt**2, dim=1)
        return 1.0 - torch.mean(2.0 * inter / (card + 1e-7))
    raise ValueError(loss_type)


def multi_scale_silhouette_loss(inputs: Tensor, targets: Tensor, num_scales: int = 1,
                                loss_type: str = "bce") -> Tensor:
    """NHWC silhouettes in [0, 1], over `num_scales` nearest-resized scales."""
    size = targets.shape[1]
    loss = _zero(inputs)
    x, gt = inputs.float(), targets.float()
    for i in range(num_scales):
        if i > 0:
            s = size // (2**i)
            x = nearest_resize(inputs.float(), (s, s), axes=(1, 2))
            gt = nearest_resize(targets.float(), (s, s), axes=(1, 2))
        if loss_type == "iou":
            inter = torch.mean((x * gt).reshape(x.shape[0], -1), dim=1)
            union = torch.mean((x + gt).reshape(x.shape[0], -1), dim=1)
            loss = loss + 1.0 - torch.mean(inter / (union - inter))
        elif loss_type == "mse":
            loss = loss + torch.mean((x - gt) ** 2)
        elif loss_type == "bce":
            xc = torch.clamp(x, 1e-7, 1 - 1e-7)
            loss = loss - torch.mean(gt * torch.log(xc) + (1 - gt) * torch.log(1 - xc))
        else:
            raise ValueError(loss_type)
    return loss / num_scales


_UPPER_LIPS = [61, 62, 63]
_LOWER_LIPS = [67, 66, 65]
_UPPER_LIDS = [37, 38, 43, 44]
_LOWER_LIDS = [41, 40, 47, 46]


def _closure_loss(pred_kp: Tensor, kp: Tensor, upper, lower) -> Tensor:
    dp = pred_kp[:, upper] - pred_kp[:, lower]
    dt = kp[:, upper] - kp[:, lower]
    return torch.mean(torch.abs(torch.abs(dp).sum(-1) - torch.abs(dt).sum(-1)))


def lip_closure_loss(pred_keypoints: Tensor, keypoints: Tensor) -> Tensor:
    return _closure_loss(pred_keypoints, keypoints, _UPPER_LIPS, _LOWER_LIPS)


def eye_closure_loss(pred_keypoints: Tensor, keypoints: Tensor) -> Tensor:
    return _closure_loss(pred_keypoints, keypoints, _UPPER_LIDS, _LOWER_LIDS)


def head_pose_matching_loss(pred_thetas, target_thetas, loss_type: str = "l2") -> Tensor:
    if not isinstance(pred_thetas, (list, tuple)):
        pred_thetas, target_thetas = [pred_thetas], [target_thetas]
    loss = _zero(pred_thetas[0])
    for p, t in zip(pred_thetas, target_thetas):
        d = p.float() - t.float()
        loss = loss + (torch.mean(torch.abs(d)) if loss_type == "l1" else torch.mean(d**2))
    return loss


def chamfer_distance(x: Tensor, y: Tensor) -> Tuple[Tensor, Tensor]:
    """Symmetric chamfer distance between point sets [B, N, D] and [B, M, D]
    (dense distances)."""
    d2 = torch.sum((x.float()[:, :, None, :] - y.float()[:, None, :, :]) ** 2, dim=-1)
    return torch.mean(torch.amin(d2, dim=2)), torch.mean(torch.amin(d2, dim=1))


def apply_imagenet_normalization(x: Tensor) -> Tensor:
    mean = torch.tensor([0.485, 0.456, 0.406], device=x.device)
    std = torch.tensor([0.229, 0.224, 0.225], device=x.device)
    return (x.float() - mean) / std
