"""Gaze and blink losses (counterpart of ``megaportraits_tpu/losses/gaze.py``).

* ``GazeBlinkLoss``: a VGG16 eye backbone (tap relu5_3), a keypoint MLP and
  the gaze and blink heads. The reference's heads expect 256-d eye features
  while its backbone gives 512 after pooling; ``eye_proj`` projects them, as
  in JAX.
* ``mp_gaze_loss``: the per-eye masked MSE of the stage-1 step.
* The host side: ``gaze_masks_for_batch`` rasterises left and right eye
  masks from the installed 68-point landmark provider
  (``data/landmarks.py``) with ``eye_masks_from_landmarks``, a numpy polygon
  fill that gives ``cv2.fillPoly(mask, [pts], 1.0)`` pixel for pixel (the
  card's machine has no cv2).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from megaportraits_tpu_torch.core.dtypes import DEFAULT_POLICY, Policy
from megaportraits_tpu_torch.losses.perceptual import VGG
from megaportraits_tpu_torch.nn.layers import TorchDense


class GazeBlinkLoss(nn.Module):
    """Gaze + blink prediction loss. ``forward(left_eye, right_eye,
    keypoints [B, 136], target_gaze [B, 2], target_blink [B, 1])`` returns
    (loss, predicted_gaze, predicted_blink)."""

    def __init__(self, w_mae: float = 15.0, w_mse: float = 10.0,
                 policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        self.w_mae, self.w_mse, self.policy = w_mae, w_mse, policy
        kw = dict(policy=policy, device=device)
        self.backbone = VGG("vgg16", taps=((4, 2),), **kw)
        self.eye_proj = TorchDense(512, 256, **kw)
        for i, c in enumerate((136, 64, 64)):
            self.add_module(f"kp_fc{i}", TorchDense(c, 64, **kw))
        self.gaze_fc0 = TorchDense(256 + 64, 256, **kw)
        self.gaze_fc1 = TorchDense(256, 2, **kw)
        self.blink_fc0 = TorchDense(256, 256, **kw)
        self.blink_fc1 = TorchDense(256, 1, **kw)

    def forward(self, left_eye: torch.Tensor, right_eye: torch.Tensor,
                keypoints: torch.Tensor, target_gaze: torch.Tensor,
                target_blink: torch.Tensor):
        p = self.policy

        def eye_features(eye):
            return self.backbone(p.cast_to_compute(eye))[0].mean(dim=(1, 2))

        eye = self.eye_proj(eye_features(left_eye) + eye_features(right_eye))
        kp = keypoints.to(p.compute_dtype)
        for i in range(3):
            kp = torch.relu(getattr(self, f"kp_fc{i}")(kp))
        g = torch.relu(self.gaze_fc0(torch.cat([eye, kp], dim=-1)))
        predicted_gaze = self.gaze_fc1(g)
        predicted_blink = self.blink_fc1(torch.relu(self.blink_fc0(eye)))

        pg, tg = predicted_gaze.float(), target_gaze.float()
        gaze_loss = (self.w_mae * torch.mean(torch.abs(pg - tg))
                     + self.w_mse * torch.mean((pg - tg) ** 2))
        blink_loss = F.binary_cross_entropy_with_logits(
            predicted_blink.float(), target_blink.float())
        return gaze_loss + blink_loss, predicted_gaze, predicted_blink


def mp_gaze_loss(predicted: torch.Tensor, target: torch.Tensor,
                 left_mask: torch.Tensor, right_mask: torch.Tensor) -> torch.Tensor:
    """Per-eye masked MSE in float32; masks are [B, H, W, 1]."""
    pg = predicted.float()
    tg = target.float()
    left = torch.mean((pg * left_mask - tg * left_mask) ** 2)
    right = torch.mean((pg * right_mask - tg * right_mask) ** 2)
    return left + right


def gaze_masks_for_batch(images: np.ndarray) -> Optional[np.ndarray]:
    """Left/right eye masks [B, H, W, 2] float32 (channel 0 the left eye)
    of [B, H, W, 3] frames, from the installed landmark provider; None when
    it gives no 68-point landmarks (a box proxy has no eye geometry: the
    gaze term is then skipped, as in the reference)."""
    from megaportraits_tpu_torch.data.landmarks import (
        LEFT_EYE,
        RIGHT_EYE,
        get_landmark_provider,
    )

    provider = get_landmark_provider()
    if getattr(provider, "num_points", 0) < 68:
        return None
    b, h, w = images.shape[:3]
    out = np.zeros((b, h, w, 2), np.float32)
    for i in range(b):
        lm = provider.detect(images[i])
        if lm is None or lm.shape[0] < 68:
            return None
        for ch, idx in ((0, LEFT_EYE), (1, RIGHT_EYE)):
            pts = lm[list(idx)].astype(np.int32)
            out[i, :, :, ch:ch + 1] = eye_masks_from_landmarks(
                [tuple(p) for p in pts], h, w)
    return out


# -- the polygon fill -------------------------------------------------------
# cv2.fillPoly on integer vertices (shift 0, 8-connected outline): every edge
# is drawn as a clipped 8-connected Bresenham line, then the scanlines are
# filled between pairs of edges in 16.16 fixed point. An edge that leaves
# the image takes its x (and its y, unless they coincide) from the clipped
# line. A span covers ceil(left) to floor(right), clipped to the image.

_XY_SHIFT = 16
_XY_ONE = 1 << _XY_SHIFT


def _c_div(a: int, b: int) -> int:
    """Integer division truncating toward zero, as C's."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """cv2.clipLine: (whether any part is inside, the clipped end points)."""
    right, bottom = w - 1, h - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1, c1 = a, 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2, c2 = a, 0
    return (c1 | c2) == 0, (x1, y1, x2, y2)


def _inside(w: int, h: int, x0: int, y0: int, x1: int, y1: int) -> bool:
    return 0 <= x0 < w and 0 <= x1 < w and 0 <= y0 < h and 0 <= y1 < h


def _draw_line(mask: np.ndarray, x0: int, y0: int, x1: int, y1: int) -> None:
    """The 8-connected line, clipped to the image, drawn left to right."""
    h, w = mask.shape
    if not _inside(w, h, x0, y0, x1, y1):
        ok, (x0, y0, x1, y1) = _clip_line(w, h, x0, y0, x1, y1)
        if not ok:
            return
    if x1 < x0:
        x0, y0, x1, y1 = x1, y1, x0, y0
    dx, dy, sy = x1 - x0, abs(y1 - y0), (1 if y1 >= y0 else -1)
    vertical = dy > dx
    major, minor = (dy, dx) if vertical else (dx, dy)
    err = major - 2 * minor
    x, y = x0, y0
    for _ in range(major + 1):
        mask[y, x] = 1.0
        step = err < 0
        err += 2 * major * step - 2 * minor
        if vertical:
            y, x = y + sy, x + step
        else:
            x, y = x + 1, y + sy * step


def eye_masks_from_landmarks(landmarks_px: Sequence[Tuple[int, int]],
                             height: int, width: int) -> np.ndarray:
    """The polygon of integer pixel vertices `landmarks_px` filled with 1.0,
    outline included, as a [H, W, 1] float32 mask: ``cv2.fillPoly`` pixel
    for pixel, convex or not, degenerate or clipped by the image edge."""
    mask = np.zeros((height, width), np.float32)
    pts = [(int(x), int(y)) for x, y in landmarks_px]
    h, w = height, width
    edges = []  # [y0, y1, x at y0 (16.16), dx per row]
    px0, py0 = pts[-1]
    for px1, py1 in pts:
        _draw_line(mask, px0, py0, px1, py1)
        fx0, fx1, cy0, cy1 = px0 << _XY_SHIFT, px1 << _XY_SHIFT, py0, py1
        if not _inside(w, h, px0, py0, px1, py1):
            _, (tx0, ty0, tx1, ty1) = _clip_line(w, h, px0, py0, px1, py1)
            fx0, fx1 = tx0 << _XY_SHIFT, tx1 << _XY_SHIFT
            if ty0 != ty1:
                cy0, cy1 = ty0, ty1
        if py0 != py1:
            dx = _c_div(fx1 - fx0, cy1 - cy0)
            if py0 < py1:
                edges.append((py0, py1, fx0 + (py0 - cy0) * dx, dx))
            else:
                edges.append((py1, py0, fx1 + (py1 - cy1) * dx, dx))
        px0, py0 = px1, py1
    if len(edges) < 2:
        return mask[..., None]
    y_min = min(e[0] for e in edges)
    y_max = max(e[1] for e in edges)
    xs = [x for y0, y1, x0, dx in edges for x in (x0, x0 + (y1 - y0) * dx)]
    if y_max < 0 or y_min >= h or max(xs) < 0 or min(xs) >= (w << _XY_SHIFT):
        return mask[..., None]
    for y in range(max(y_min, 0), min(y_max, h)):
        active = sorted(x0 + (y - y0) * dx for y0, y1, x0, dx in edges if y0 <= y < y1)
        for left, right in zip(active[0::2], active[1::2]):
            x1 = (left + _XY_ONE - 1) >> _XY_SHIFT
            x2 = right >> _XY_SHIFT
            if x1 < w and x2 >= 0:
                mask[y, max(x1, 0):min(x2, w - 1) + 1] = 1.0
    return mask[..., None]
