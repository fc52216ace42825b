"""Facial-landmark providers (counterpart of
``megaportraits_tpu/data/landmarks.py``).

The host-side landmark interface that eval/metrics.py (AKD, AED) and the
gaze masks (losses/gaze.py) consume: a registry of the active provider and
two providers:
  * ``FANLandmarkProvider``: 68 points from the FAN network
    (models/fan.py) on a device, with converted face_alignment weights from
    the pretrained bundle (key 'fan') or seeded random ones;
  * ``BoxLandmarkProvider``: 5 corner-and-centre points of a detected face
    box, or of a fixed centre-prior box, marked ``is_proxy``.

``set_landmark_provider`` installs the active provider for the process, as
the JAX registry does; a test that installs one puts the default back.
The resizes are the port's bilinear (``ops/resize.linear_resize``:
half-pixel centres, edge clamp, no antialias), which is what cv2's
``INTER_LINEAR`` computes on float32 images, up- or down-scaling.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from megaportraits_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device

# 68-point iBUG indexing.
RIGHT_EYE = tuple(range(36, 42))
LEFT_EYE = tuple(range(42, 48))
FAN_INPUT_SIZE = 256


def bilinear_resize(image: np.ndarray, height: int, width: int) -> np.ndarray:
    """[H, W, C] float -> [height, width, C] float32, cv2.resize's
    INTER_LINEAR (on the CPU)."""
    from megaportraits_tpu_torch.ops.resize import linear_resize

    x = torch.from_numpy(np.ascontiguousarray(image, dtype=np.float32))[None]
    return linear_resize(x, (height, width), axes=(1, 2),
                         align_corners=False)[0].numpy()


class BoxLandmarkProvider:
    """Face-box corner proxy (5 points); ``is_proxy``: AKD/AED from it are
    not comparable to 68-point numbers. With `center_prior_fallback` an
    undetected face takes a fixed centre box (the central 60% of a
    face-centred crop) instead of None; ``n_center_prior`` and
    ``n_detected`` count the two cases."""

    is_proxy = True
    num_points = 5

    def __init__(self, center_prior_fallback: bool = True):
        self.center_prior_fallback = center_prior_fallback
        self.n_center_prior = 0
        self.n_detected = 0

    def detect(self, image: np.ndarray) -> Optional[np.ndarray]:
        from megaportraits_tpu_torch.data.dataset import detect_face

        box = detect_face(image)
        if box is None:
            if not self.center_prior_fallback:
                return None
            h, w = image.shape[:2]
            box = (int(0.2 * w), int(0.15 * h), int(0.6 * w), int(0.65 * h))
            self.n_center_prior += 1
        else:
            self.n_detected += 1
        x, y, w, h = box
        return np.array([[x, y], [x + w, y], [x, y + h], [x + w, y + h],
                         [x + w / 2, y + h / 2]], dtype=np.float64)


class FANLandmarkProvider:
    """68-point landmarks from FAN on `device`.

    `variables`: a FAN state_dict (the bundle's 'fan'); without it the FAN
    is drawn from `generator` (a ``torch.Generator`` on `device`, seeded 0
    when not given) and ``trained`` is False. With `crop_to_face` the face
    box of ``detect_face`` (padded by a quarter on each side) is cropped
    first, as face_alignment's detector + FAN pipeline does. On a card the
    forward runs on a stream of the provider's own, so that a provider
    called from another thread (the stage-1 driver's prefetch producer)
    does not queue behind the training step on the default stream.
    """

    is_proxy = False
    num_points = 68

    def __init__(self, variables=None, num_modules: int = 4, crop_to_face: bool = True,
                 trained: bool = True, device: Union[str, torch.device] = DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        from megaportraits_tpu_torch.core.dtypes import FP32_POLICY
        from megaportraits_tpu_torch.models.fan import FAN, HEATMAP_SIZE
        from megaportraits_tpu_torch.nn.layers import init_parameters

        self.device = resolve_device(device)
        self.model = FAN(num_modules=num_modules, policy=FP32_POLICY, device=self.device)
        if variables is None:
            trained = False
            init_parameters(self.model, seed=0, generator=generator)
        else:
            self.model.load_state_dict(variables, strict=True)
        self.model.requires_grad_(False).eval()
        self.trained = trained
        self.crop_to_face = crop_to_face
        self._hm_size = HEATMAP_SIZE
        self.stream = None
        if self.device.type == "cuda":
            self.stream = torch.cuda.Stream(self.device)
            self.stream.wait_stream(torch.cuda.current_stream(self.device))

    def landmarks(self, crop: np.ndarray) -> np.ndarray:
        """[68, 2] (x, y) in heatmap pixels of one [h, w, 3] crop: resized
        to 256x256 on the device, FAN, the heatmap decode."""
        from megaportraits_tpu_torch.models.fan import heatmaps_to_landmarks
        from megaportraits_tpu_torch.ops.resize import linear_resize

        with torch.no_grad(), torch.cuda.stream(self.stream):
            x = torch.from_numpy(np.ascontiguousarray(crop, dtype=np.float32))
            x = linear_resize(x[None].to(self.device), (FAN_INPUT_SIZE, FAN_INPUT_SIZE),
                              axes=(1, 2), align_corners=False)
            lm = heatmaps_to_landmarks(self.model(x))[0].cpu().numpy()
        return lm

    def detect(self, image: np.ndarray) -> Optional[np.ndarray]:
        h, w = image.shape[:2]
        x0 = y0 = 0
        crop = image
        if self.crop_to_face:
            from megaportraits_tpu_torch.data.dataset import detect_face

            box = detect_face(image)
            if box is not None:
                bx, by, bw, bh = box
                pad_x, pad_y = int(0.25 * bw), int(0.25 * bh)
                x0, y0 = max(0, bx - pad_x), max(0, by - pad_y)
                x1, y1 = min(w, bx + bw + pad_x), min(h, by + bh + pad_y)
                crop = image[y0:y1, x0:x1]
        ch, cw = crop.shape[:2]
        lm = self.landmarks(crop)
        # Heatmap cell centres (+0.5) to image pixels.
        lm[:, 0] = (lm[:, 0] + 0.5) / self._hm_size * cw + x0
        lm[:, 1] = (lm[:, 1] + 0.5) / self._hm_size * ch + y0
        return lm.astype(np.float64)


_PROVIDER: Optional[object] = None


def set_landmark_provider(provider) -> None:
    global _PROVIDER
    _PROVIDER = provider


def get_landmark_provider():
    """The active provider; the box proxy until one is installed."""
    global _PROVIDER
    if _PROVIDER is None:
        _PROVIDER = BoxLandmarkProvider()
    return _PROVIDER


def provider_from_bundle(bundle_path: str,
                         device: Union[str, torch.device] = DEFAULT_DEVICE):
    """Install a FANLandmarkProvider on `device` when the pretrained bundle
    at `bundle_path` holds converted FAN weights; returns it, or None."""
    from megaportraits_tpu_torch.utils.convert_weights import fan_modules
    from megaportraits_tpu_torch.utils.pretrained import load_bundle

    bundle = load_bundle(bundle_path)
    if not bundle or "fan" not in bundle:
        return None
    provider = FANLandmarkProvider(variables=bundle["fan"],
                                   num_modules=fan_modules(bundle["fan"]),
                                   trained=True, device=device)
    set_landmark_provider(provider)
    return provider


def eye_crops_from_landmarks(image: np.ndarray, landmarks: np.ndarray,
                             out_size: int = 32, pad: float = 0.6):
    """Left and right eye crops [out_size, out_size, 3] and the [136]
    keypoint vector for GazeBlinkLoss (a proxy's points tiled to 68)."""
    h, w = image.shape[:2]

    def crop(idx):
        pts = landmarks[list(idx)]
        cx, cy = pts[:, 0].mean(), pts[:, 1].mean()
        half = max(np.ptp(pts[:, 0]), np.ptp(pts[:, 1])) * (0.5 + pad)
        half = max(half, 4.0)
        x0, x1 = int(max(0, cx - half)), int(min(w, cx + half))
        y0, y1 = int(max(0, cy - half)), int(min(h, cy + half))
        return bilinear_resize(image[y0:y1, x0:x1], out_size, out_size)

    right = crop(RIGHT_EYE)
    left = crop(LEFT_EYE)
    kp = landmarks.astype(np.float32)
    if kp.shape[0] < 68:
        reps = int(np.ceil(68 / kp.shape[0]))
        kp = np.tile(kp, (reps, 1))[:68]
    return left, right, kp.reshape(-1)
