"""EMODataset: the host-side video pipeline (a copy of
``megaportraits_tpu/data/dataset.py``, which holds the same numpy/cv2 code).

It makes the same bytes as the JAX package: the same ``np.random
.default_rng`` draws in the same order, the same npz cache
``{video_id}_{W}x{H}_tensors.npz`` next to the clips (or in `cache_dir`),
the same ``__getitem__`` items and ``frame_batches`` batches. In short:
  * the clip list comes from the CelebV-HQ style JSON (``clips``), else
    from the mp4 files of `video_dir`;
  * each clip is decoded at `sample_rate` up to `n_sample_frames` frames,
    cropped around the face with 0.5 x face-size padding, the driving crop
    warped by a random thin-plate spline, and every frame of a clip
    augmented alike (flip and colour jitter);
  * a cache hit skips all of it, and needs neither cv2 nor PIL: that is
    how a host without them (the card's machine) reads prepared clips.
The PNG caches and frame dumps are read and written without PIL
(``utils/image.py``), with the pixels PIL reads and writes.
Frames are float32 [0, 1], channels last, as the models take them.

``area_downsample`` is cv2's ``INTER_AREA`` at an integer factor (the box
mean), in numpy: the stage-2 driver and its held-out evaluator downsample
with it, so that they run without cv2.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from megaportraits_tpu_torch.utils.image import load_image, write_image

try:
    import cv2
except Exception:  # pragma: no cover
    cv2 = None

try:
    from rembg import remove as _rembg_remove  # type: ignore
except Exception:  # pragma: no cover
    _rembg_remove = None


# ---------------------------------------------------------------------------
# Thin-plate-spline warp (replaces skimage PiecewiseAffineTransform)
# ---------------------------------------------------------------------------


def _tps_kernel(r2: np.ndarray) -> np.ndarray:
    out = np.zeros_like(r2)
    mask = r2 > 0
    out[mask] = 0.5 * r2[mask] * np.log(r2[mask])
    return out


def tps_warp(
    image: np.ndarray,
    rng: np.random.Generator,
    warp_strength: float = 0.01,
    grid: int = 4,
) -> np.ndarray:
    """Random TPS warp: perturb a control grid, solve the spline, remap.

    Mirrors the reference's random PiecewiseAffine warp of the driving crop
    (EmoDataset.py:133-158) — degrades facial geometry slightly while
    keeping expression (per the MegaPortraits augmentation recipe).
    """
    h, w = image.shape[:2]
    xs = np.linspace(0, w - 1, grid)
    ys = np.linspace(0, h - 1, grid)
    src = np.stack(np.meshgrid(xs, ys), axis=-1).reshape(-1, 2)
    dst = src + rng.normal(0, warp_strength * min(h, w), src.shape)

    n = src.shape[0]
    d2 = ((src[:, None, :] - src[None, :, :]) ** 2).sum(-1)
    k = _tps_kernel(d2)
    p = np.concatenate([np.ones((n, 1)), src], axis=1)
    a = np.zeros((n + 3, n + 3))
    a[:n, :n] = k
    a[:n, n:] = p
    a[n:, :n] = p.T
    b = np.concatenate([dst, np.zeros((3, 2))], axis=0)
    coef = np.linalg.solve(a + 1e-8 * np.eye(n + 3), b)

    gy, gx = np.mgrid[0:h, 0:w]
    pts = np.stack([gx.ravel(), gy.ravel()], axis=-1).astype(np.float64)
    d2p = ((pts[:, None, :] - src[None, :, :]) ** 2).sum(-1)
    kp = _tps_kernel(d2p)
    mapped = kp @ coef[:n] + coef[n] + pts @ coef[n + 1:]
    map_x = mapped[:, 0].reshape(h, w).astype(np.float32)
    map_y = mapped[:, 1].reshape(h, w).astype(np.float32)
    if cv2 is not None:
        return cv2.remap(image, map_x, map_y, cv2.INTER_LINEAR,
                         borderMode=cv2.BORDER_REFLECT)
    # numpy fallback: nearest sampling
    xi = np.clip(np.round(map_x).astype(int), 0, w - 1)
    yi = np.clip(np.round(map_y).astype(int), 0, h - 1)
    return image[yi, xi]


# ---------------------------------------------------------------------------
# Face detection / sweet-spot crop
# ---------------------------------------------------------------------------

_FACE_DETECTOR = None
FACE_MODEL_ENV = "MEGAPORTRAITS_FACE_MODEL"  # path to a YuNet .onnx


def _get_face_detector():
    """cv2.FaceDetectorYN when a model file is supplied; else None.

    This cv2 build (5.0) has no Haar cascades and no bundled detector
    weights; face_recognition/dlib are unavailable. Detection degrades to
    the skin-tone heuristic below, then to a center crop (CelebV-HQ clips
    are face-centered already, EmoDataset.md).
    """
    global _FACE_DETECTOR
    if _FACE_DETECTOR is None and cv2 is not None:
        model = os.environ.get(FACE_MODEL_ENV, "")
        if model and os.path.exists(model) and hasattr(cv2, "FaceDetectorYN"):
            _FACE_DETECTOR = cv2.FaceDetectorYN.create(model, "", (320, 320))
    return _FACE_DETECTOR


def detect_face(frame: np.ndarray):
    """Best-effort face box (x, y, w, h) in pixels, or None."""
    img8 = (np.clip(frame, 0, 1) * 255).astype(np.uint8) \
        if frame.dtype != np.uint8 else frame
    det = _get_face_detector()
    if det is not None:
        h, w = img8.shape[:2]
        det.setInputSize((w, h))
        _, faces = det.detect(cv2.cvtColor(img8, cv2.COLOR_RGB2BGR))
        if faces is not None and len(faces):
            x, y, fw, fh = faces[0][:4]
            return int(x), int(y), int(fw), int(fh)
    # Skin-tone heuristic: YCrCb mask -> largest blob.
    if cv2 is not None:
        ycrcb = cv2.cvtColor(img8, cv2.COLOR_RGB2YCrCb)
        mask = cv2.inRange(ycrcb, (0, 133, 77), (255, 173, 127))
        mask = cv2.morphologyEx(mask, cv2.MORPH_OPEN, np.ones((5, 5), np.uint8))
        contours, _ = cv2.findContours(mask, cv2.RETR_EXTERNAL,
                                       cv2.CHAIN_APPROX_SIMPLE)
        if contours:
            big = max(contours, key=cv2.contourArea)
            area = cv2.contourArea(big)
            h, w = img8.shape[:2]
            if area > 0.02 * h * w:
                return cv2.boundingRect(big)
    return None


def sweet_spot_crop(
    frame: np.ndarray, out_size: Tuple[int, int],
    face_box: Optional[Tuple[int, int, int, int]] = None,
) -> np.ndarray:
    """Crop around the face with 0.5 * face-size padding, then resize.

    Reference 'sweet spot' logic (EmoDataset.py:106-131). Falls back to a
    square center crop when no face is detected.
    """
    h, w = frame.shape[:2]
    box = face_box if face_box is not None else detect_face(frame)
    if box is not None:
        x, y, fw, fh = box
        pad_w, pad_h = int(0.5 * fw), int(0.5 * fh)
        x0, y0 = max(0, x - pad_w), max(0, y - pad_h)
        x1, y1 = min(w, x + fw + pad_w), min(h, y + fh + pad_h)
    else:
        side = min(h, w)
        y0, x0 = (h - side) // 2, (w - side) // 2
        y1, x1 = y0 + side, x0 + side
    crop = frame[y0:y1, x0:x1]
    if cv2 is not None:
        return cv2.resize(crop, out_size, interpolation=cv2.INTER_AREA)
    # crude nearest fallback
    yy = np.linspace(0, crop.shape[0] - 1, out_size[1]).astype(int)
    xx = np.linspace(0, crop.shape[1] - 1, out_size[0]).astype(int)
    return crop[yy][:, xx]


def area_downsample(frames: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """[..., H, W, C] -> [..., h, w, C] with `size` = (w, h) dividing (W, H):
    the mean of each box of (H / h) x (W / w) pixels, which is what
    ``cv2.resize(..., interpolation=cv2.INTER_AREA)`` computes at an integer
    factor (to float32 rounding)."""
    *lead, hh, ww, c = frames.shape
    w, h = size
    if hh % h or ww % w:
        raise ValueError(f"area_downsample needs an integer factor, got "
                         f"{ww}x{hh} -> {w}x{h}")
    boxes = frames.reshape(*lead, h, hh // h, w, ww // w, c)
    return boxes.mean(axis=(-4, -2), dtype=np.float32).astype(frames.dtype)


def remove_background(
    frame: np.ndarray, greenscreen: bool = False
) -> np.ndarray:
    """Background removal with optional greenscreen composite
    (EmoDataset.py:265-282). Uses rembg when available, else the host
    segmentation provider (data/segmentation.py); identity as last resort.
    """
    alpha = None
    if _rembg_remove is not None:
        rgba = _rembg_remove((frame * 255).astype(np.uint8))
        rgba = np.asarray(rgba).astype(np.float32) / 255.0
        frame, alpha = rgba[..., :3], rgba[..., 3:4]
    else:
        try:
            from megaportraits_tpu_torch.data.segmentation import get_foreground_mask

            alpha = get_foreground_mask(frame)
        except Exception:
            return frame
    if greenscreen:
        green = np.zeros_like(frame)
        green[..., 1] = 1.0
        return frame * alpha + green * (1.0 - alpha)
    return frame * alpha


def crop_and_warp_face(
    image: np.ndarray,
    out_size: Tuple[int, int] = (512, 512),
    apply_warp: bool = True,
    warp_strength: float = 0.01,
    rng: Optional[np.random.Generator] = None,
    cache_path: Optional[str] = None,
) -> np.ndarray:
    """Standalone sweet-spot crop (+ optional TPS warp) with PNG result
    caching — the reference's crop_and_warp_face helper (model.py:2040-2135).
    """
    if cache_path and os.path.exists(cache_path):
        return load_image(cache_path)
    rng = rng or np.random.default_rng(0)
    crop = sweet_spot_crop(image, out_size)
    if apply_warp:
        crop = tps_warp(crop, rng, warp_strength)
    if cache_path:
        write_image((np.clip(crop, 0, 1) * 255).astype(np.uint8), cache_path)
    return crop


def remove_background_and_convert_to_rgb(
    image: np.ndarray, cache_path: Optional[str] = None
) -> np.ndarray:
    """Standalone background removal with PNG caching (model.py:2096-2135)."""
    if cache_path and os.path.exists(cache_path):
        return load_image(cache_path)
    out = remove_background(image)
    if cache_path:
        write_image((np.clip(out, 0, 1) * 255).astype(np.uint8), cache_path)
    return out


# ---------------------------------------------------------------------------
# Shared-RNG augmentation (flip + color jitter)
# ---------------------------------------------------------------------------


def augment_pair(
    frames: np.ndarray, rng: np.random.Generator
) -> np.ndarray:
    """Apply one sampled augmentation to every frame of a clip (shared RNG
    state across paired frames, EmoDataset.py:249-263)."""
    out = frames
    if rng.random() < 0.5:
        out = out[:, :, ::-1, :]
    brightness = rng.uniform(0.8, 1.2)
    contrast = rng.uniform(0.8, 1.2)
    saturation = rng.uniform(0.8, 1.2)
    mean = out.mean(axis=(1, 2, 3), keepdims=True)
    out = (out - mean) * contrast + mean
    gray = out.mean(axis=-1, keepdims=True)
    out = gray + (out - gray) * saturation
    out = out * brightness
    return np.clip(out, 0.0, 1.0)


# ---------------------------------------------------------------------------
# Dataset
# ---------------------------------------------------------------------------


class EMODataset:
    def __init__(
        self,
        width: int = 512,
        height: int = 512,
        n_sample_frames: int = 16,
        sample_rate: int = 25,
        video_dir: str = "./junk",
        json_file: str = "./data/overfit.json",
        cache_dir: Optional[str] = None,
        remove_background_flag: bool = False,
        use_greenscreen: bool = False,
        save_frame_pngs: bool = False,
        apply_crop_warping: bool = True,
        warp_strength: float = 0.01,
        use_gpu: bool = False,  # reference-schema compat; unused
        transform=None,  # reference-schema compat
        img_scale: Tuple[float, float] = (1.0, 1.0),
        seed: int = 0,
        driving_mode: str = "cross_frame",
        n_driving_videos: int = 2,
    ):
        """driving_mode selects where driving frames come from:

        * ``"cross_frame"`` (default): driving frames are OTHER frames of the
          same video — the training sampler (frame_batches) guarantees the
          driving index differs from the source index, so the objective is
          real cross-frame motion transfer. The TPS warp stays as a pure
          augmentation of the driving crop.
        * ``"separate_video"``: reference-parity behavior — a shared set of
          driving videos is picked randomly at init (EmoDataset.py:50-61) and
          __getitem__ returns their frames as driving_frames
          (EmoDataset.py:325-330).
        """
        self.width = width
        self.height = height
        self.n_sample_frames = n_sample_frames
        self.sample_rate = sample_rate
        self.video_dir = video_dir
        self.cache_dir = cache_dir or video_dir
        self.remove_background_flag = remove_background_flag
        self.use_greenscreen = use_greenscreen
        self.save_frame_pngs = save_frame_pngs
        self.apply_crop_warping = apply_crop_warping
        self.warp_strength = warp_strength
        self.rng = np.random.default_rng(seed)

        if driving_mode not in ("cross_frame", "separate_video"):
            raise ValueError(f"unknown driving_mode {driving_mode!r}")
        self.driving_mode = driving_mode

        with open(json_file) as f:
            meta = json.load(f)
        self.video_ids: List[str] = list(meta.get("clips", {}).keys())
        if not self.video_ids:
            # Fall back to whatever videos exist in video_dir.
            self.video_ids = sorted(
                os.path.splitext(f)[0]
                for f in os.listdir(video_dir)
                if f.endswith(".mp4")
            )
        self._cache: Dict[str, Dict[str, np.ndarray]] = {}
        # Reference parity: shared driving videos picked randomly at init
        # (EmoDataset.py:50-61); every item returns frames from these.
        self.driving_video_ids: List[str] = []
        if driving_mode == "separate_video":
            # The reference draws each shared driving video INDEPENDENTLY
            # (random.choice twice, EmoDataset.py:50,57 — replacement
            # possible), one for driving_frames and one for
            # driving_frames_star; match that. The reference semantics
            # need exactly 2 draws, so fewer is not honorable — say so
            # instead of silently bumping (advisor finding, round 3).
            if n_driving_videos < 2:
                import warnings

                warnings.warn(
                    f"separate_video mode needs 2 driving-video draws "
                    f"(driving + driving_star, EmoDataset.py:50,57); "
                    f"n_driving_videos={n_driving_videos} raised to 2.",
                    stacklevel=2,
                )
            k = max(2, n_driving_videos)
            picks = self.rng.choice(len(self.video_ids), size=k, replace=True)
            self.driving_video_ids = [self.video_ids[int(p)] for p in picks]

    def __len__(self) -> int:
        return len(self.video_ids)

    # -- preprocessing ------------------------------------------------------

    def _cache_path(self, video_id: str) -> str:
        # Reference contract is `{video_id}_tensors.npz` (EmoDataset.py:189)
        # — but the reference only ever decodes at one resolution, so an
        # unsized key silently returns stale tensors when the same cache
        # dir is reused at another size (real bug hit by the HR harness:
        # a 512 decode got cached 256 frames). Keyed by WxH here.
        return os.path.join(
            self.cache_dir,
            f"{video_id}_{self.width}x{self.height}_tensors.npz",
        )

    def _decode_video(self, path: str) -> np.ndarray:
        assert cv2 is not None, "cv2 required for video decoding"
        cap = cv2.VideoCapture(path)
        frames = []
        idx = 0
        while len(frames) < self.n_sample_frames:
            ok, frame = cap.read()
            if not ok:
                break
            if idx % max(self.sample_rate, 1) == 0:
                frames.append(
                    cv2.cvtColor(frame, cv2.COLOR_BGR2RGB).astype(np.float32)
                    / 255.0
                )
            idx += 1
        cap.release()
        if not frames:
            raise IOError(f"no frames decoded from {path}")
        return np.stack(frames)

    def load_and_process_video(self, video_id: str) -> Dict[str, np.ndarray]:
        """npz-cached video -> {'source_frames', 'driving_frames'}."""
        if video_id in self._cache:
            return self._cache[video_id]
        cache_path = self._cache_path(video_id)
        if os.path.exists(cache_path):
            data = np.load(cache_path)
            out = {
                "source_frames": data["source_frames"],
                "driving_frames": data["driving_frames"],
            }
            self._cache[video_id] = out
            return out

        raw = self._decode_video(os.path.join(self.video_dir, f"{video_id}.mp4"))
        source, driving = [], []
        for i, frame in enumerate(raw):
            if self.remove_background_flag:
                frame = remove_background(frame, self.use_greenscreen)
            crop = sweet_spot_crop(frame, (self.width, self.height))
            source.append(crop)
            drv = crop
            if self.apply_crop_warping:
                drv = tps_warp(crop, self.rng, self.warp_strength)
            driving.append(drv)
            if self.save_frame_pngs:
                # Reference PNG frame dumps (EmoDataset.py:224-240).
                png_dir = os.path.join(self.cache_dir, f"{video_id}_frames")
                write_image((np.clip(crop, 0, 1) * 255).astype(np.uint8),
                            os.path.join(png_dir, f"frame_{i}.png"))
        source = augment_pair(np.stack(source), self.rng).astype(np.float32)
        driving = augment_pair(np.stack(driving), self.rng).astype(np.float32)
        out = {"source_frames": source, "driving_frames": driving}
        try:
            np.savez_compressed(cache_path, **out)
        except OSError:
            pass  # read-only cache dir: keep in memory only
        self._cache[video_id] = out
        return out

    # -- access -------------------------------------------------------------

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        video_id = self.video_ids[index]
        video_id_star = self.video_ids[(index + 1) % len(self.video_ids)]
        main = self.load_and_process_video(video_id)
        star = self.load_and_process_video(video_id_star)
        drv = main["driving_frames"]
        drv_star = star["driving_frames"]
        if self.driving_mode == "separate_video" and self.driving_video_ids:
            # Shared driving clips as in the reference (EmoDataset.py:325-330):
            # EVERY item returns the same init-picked clip pair — clip 0 for
            # driving_frames, clip 1 for driving_frames_star.
            drv = self.load_and_process_video(
                self.driving_video_ids[0])["driving_frames"]
            drv_star = self.load_and_process_video(
                self.driving_video_ids[1])["driving_frames"]
        return {
            "video_id": video_id,
            "source_frames": main["source_frames"],
            "driving_frames": drv,
            "video_id_star": video_id_star,
            "source_frames_star": star["source_frames"],
            "driving_frames_star": drv_star,
        }

    def frame_batches(
        self, batch_size: int, frame_offset: int = 20, seed: int = 0,
        holdout: int = 0,
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Yield batched training dicts — the device-batched replacement for
        the reference's per-frame Python loop (train.py:179).

        In cross_frame mode the driving index is guaranteed to DIFFER from
        the source index, so each pair carries real cross-frame motion (the
        degenerate 'undo a 0.01-strength warp of the input' objective of a
        same-index pairing cannot occur).

        With holdout > 0, the LAST `holdout` frames of every clip are
        excluded from sampling — reserved as the held-out eval tail
        (the hr_quality.py convention) for early stopping.
        """
        rng = np.random.default_rng(seed)
        n = len(self)
        while True:
            src, drv, src_next, src_star, drv_star = [], [], [], [], []
            for _ in range(batch_size):
                item = self[int(rng.integers(n))]
                s = item["source_frames"]
                d = item["driving_frames"]
                ss = item["source_frames_star"]
                ds = item["driving_frames_star"]
                ns = max(1, len(s) - holdout)
                nd = max(1, len(d) - holdout)
                i = int(rng.integers(ns))
                if self.driving_mode == "cross_frame" and nd > 1:
                    # uniform over indices != i
                    k = int((i + 1 + rng.integers(nd - 1)) % nd)
                else:
                    k = int(rng.integers(nd))
                src.append(s[i % len(s)])
                drv.append(d[k])
                src_next.append(s[(i + frame_offset) % ns])
                j = int(rng.integers(max(1, len(ds) - holdout)))
                src_star.append(ss[j % len(ss)])
                drv_star.append(ds[j % len(ds)])
            yield {
                "source": np.stack(src),
                "driving": np.stack(drv),
                "source_next": np.stack(src_next),
                "source_star": np.stack(src_star),
                "driving_star": np.stack(drv_star),
            }
