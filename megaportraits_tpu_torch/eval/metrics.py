"""The evaluation metrics: L1, PSNR, SSIM, LPIPS, AKD, AED (counterpart of
``megaportraits_tpu/eval/metrics.py``).

The host metrics (L1, PSNR, SSIM, AKD, the Procrustes AED, FID, CSIM, the
memorisation index) are numpy in float64 as in JAX, SSIM with scipy's
``convolve2d``. LPIPS, FAN (the 68-point landmarks of AKD) and the identity
net (the embedding AED) run on a device, with the converted pretrained
bundle's weights (``make_eval_callables``); without a bundle LPIPS is None,
AKD uses the installed landmark provider (the 5-point box proxy by default)
and AED the Procrustes landmark-shape distance. PNGs are read without PIL
(``utils/image.load_image``).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Union

import numpy as np
import torch

from megaportraits_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device
from megaportraits_tpu_torch.utils.image import load_image

EMBEDDING_INPUT = 160  # InceptionResnetV1's input side for the AED embedding


def calculate_l1(pred: np.ndarray, target: np.ndarray) -> float:
    return float(np.mean(np.abs(pred.astype(np.float64) - target.astype(np.float64))))


def calculate_psnr(pred: np.ndarray, target: np.ndarray, data_range: float = 1.0) -> float:
    mse = np.mean((pred.astype(np.float64) - target.astype(np.float64)) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range**2 / mse))


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    g = np.exp(-((np.arange(size) - size // 2) ** 2) / (2 * sigma**2))
    g /= g.sum()
    return np.outer(g, g)


def calculate_ssim(pred: np.ndarray, target: np.ndarray, data_range: float = 1.0) -> float:
    """SSIM (Wang et al.) with an 11x11 gaussian window, per channel."""
    from scipy.signal import convolve2d

    c1, c2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2
    win = _gaussian_window()
    if pred.ndim == 2:
        pred, target = pred[..., None], target[..., None]
    vals = []
    for ch in range(pred.shape[-1]):
        x = pred[..., ch].astype(np.float64)
        y = target[..., ch].astype(np.float64)
        mx = convolve2d(x, win, mode="valid")
        my = convolve2d(y, win, mode="valid")
        mxx = convolve2d(x * x, win, mode="valid") - mx**2
        myy = convolve2d(y * y, win, mode="valid") - my**2
        mxy = convolve2d(x * y, win, mode="valid") - mx * my
        s = ((2 * mx * my + c1) * (2 * mxy + c2)) / ((mx**2 + my**2 + c1) * (mxx + myy + c2))
        vals.append(s.mean())
    return float(np.mean(vals))


def extract_keypoints(image: np.ndarray) -> Optional[np.ndarray]:
    """Facial keypoints from the installed landmark provider."""
    from megaportraits_tpu_torch.data.landmarks import get_landmark_provider

    return get_landmark_provider().detect(image)


def calculate_akd(pred: np.ndarray, target: np.ndarray) -> Optional[float]:
    """Average keypoint distance: the mean L2 over matched landmarks."""
    kp, kt = extract_keypoints(pred), extract_keypoints(target)
    if kp is None or kt is None or kp.shape != kt.shape:
        return None
    return float(np.mean(np.linalg.norm(kp - kt, axis=1)))


def procrustes_shape_distance(a: np.ndarray, b: np.ndarray,
                              eps: float = 1e-8) -> Optional[float]:
    """Landmark shape distance after full Procrustes alignment
    (translation, scale and rotation removed)."""
    a = a.astype(np.float64) - a.mean(axis=0)
    b = b.astype(np.float64) - b.mean(axis=0)
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    if na < eps or nb < eps:
        return None
    a, b = a / na, b / nb
    u, _, vt = np.linalg.svd(a.T @ b)
    return float(np.linalg.norm(a @ (u @ vt) - b))


def calculate_aed(pred: np.ndarray, target: np.ndarray,
                  embedding_apply=None) -> Optional[float]:
    """Average embedding distance: with `embedding_apply` ([1, H, W, 3] in
    [0, 1] -> [1, D]) the L2 between identity embeddings, else the
    Procrustes landmark-shape distance."""
    if embedding_apply is not None:
        def embed(img):
            out = embedding_apply(torch.as_tensor(img, dtype=torch.float32)[None])
            return out.detach().cpu().numpy()

        return float(np.linalg.norm(embed(pred)[0] - embed(target)[0]))
    kp, kt = extract_keypoints(pred), extract_keypoints(target)
    if kp is None or kt is None or kp.shape != kt.shape:
        return None
    return procrustes_shape_distance(kp, kt)


def memorization_index(pred: np.ndarray, clips: Dict[str, np.ndarray]) -> Dict[str, object]:
    """The training clip nearest to `pred` (per clip, the least mean L1
    over its frames): {'nearest_clip', 'nearest_l1', 'margin_l1' (the
    runner-up's distance less the nearest's), 'per_clip'}."""
    p = pred.astype(np.float32)
    per_clip: Dict[str, float] = {}
    for vid, frames in clips.items():
        f = np.asarray(frames, dtype=np.float32)
        per_clip[vid] = float(np.min(np.mean(np.abs(f - p[None]), axis=(1, 2, 3))))
    ranked = sorted(per_clip, key=per_clip.get)
    nearest = ranked[0]
    margin = per_clip[ranked[1]] - per_clip[nearest] if len(ranked) > 1 else float("inf")
    return {"nearest_clip": nearest, "nearest_l1": per_clip[nearest],
            "margin_l1": float(margin), "per_clip": per_clip}


def calculate_fid(real_features: np.ndarray, fake_features: np.ndarray) -> float:
    """FID over feature matrices [N, D]."""
    from scipy.linalg import sqrtm

    mu1, mu2 = real_features.mean(axis=0), fake_features.mean(axis=0)
    sigma1 = np.cov(real_features, rowvar=False)
    sigma2 = np.cov(fake_features, rowvar=False)
    covmean = sqrtm(sigma1.dot(sigma2))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(np.sum((mu1 - mu2) ** 2) + np.trace(sigma1 + sigma2 - 2.0 * covmean))


def calculate_csim(real_features: np.ndarray, fake_features: np.ndarray) -> float:
    """Mean pairwise cosine similarity."""
    a = real_features / np.maximum(np.linalg.norm(real_features, axis=1, keepdims=True), 1e-12)
    b = fake_features / np.maximum(np.linalg.norm(fake_features, axis=1, keepdims=True), 1e-12)
    return float(np.mean(a @ b.T))


def calculate_lpips(pred: np.ndarray, target: np.ndarray, lpips_apply) -> float:
    """lpips_apply: ([1, H, W, 3] x 2 in [-1, 1]) -> [1]."""
    p = torch.as_tensor(pred, dtype=torch.float32)[None] * 2 - 1
    t = torch.as_tensor(target, dtype=torch.float32)[None] * 2 - 1
    return float(lpips_apply(p, t)[0])


def _load_strict(module: torch.nn.Module, state: Dict[str, torch.Tensor], where: str):
    """Every key of `state` must name a parameter of `module` (JAX's
    ``merge_params``); what `state` lacks keeps its value."""
    unexpected = module.load_state_dict(state, strict=False).unexpected_keys
    if unexpected:
        raise KeyError(f"unknown keys in {where}: {unexpected[:3]}")


def make_eval_callables(pretrained_path: str,
                        device: Union[str, torch.device] = DEFAULT_DEVICE):
    """(lpips_apply, embedding_apply) on `device` from the converted bundle
    at `pretrained_path`, each None where the bundle lacks its weights; the
    FAN landmark provider installed when the bundle has FAN weights."""
    from megaportraits_tpu_torch.core.dtypes import FP32_POLICY
    from megaportraits_tpu_torch.data.landmarks import provider_from_bundle
    from megaportraits_tpu_torch.utils.pretrained import load_bundle

    dev = resolve_device(device)
    bundle = load_bundle(pretrained_path) or {}
    lpips_apply = embedding_apply = None
    provider_from_bundle(pretrained_path, device=dev)
    if "vgg16" in bundle and "lpips_heads" in bundle:
        from megaportraits_tpu_torch.losses.perceptual import LPIPS

        lp = LPIPS(policy=FP32_POLICY, device=dev)
        _load_strict(lp.vgg16, bundle["vgg16"], "vgg16")
        _load_strict(lp, bundle["lpips_heads"], "lpips_heads")
        lp.requires_grad_(False).eval()

        def lpips_apply(a, b):
            with torch.no_grad():
                return lp(a.to(dev), b.to(dev)).cpu()
    if "vggface" in bundle:
        from megaportraits_tpu_torch.losses.vggface import InceptionResnetV1
        from megaportraits_tpu_torch.ops.resize import linear_resize

        face = InceptionResnetV1(policy=FP32_POLICY, device=dev)
        _load_strict(face, bundle["vggface"], "vggface")
        face.requires_grad_(False).eval()

        def embedding_apply(img):
            with torch.no_grad():
                img = linear_resize(img.to(dev), (EMBEDDING_INPUT, EMBEDDING_INPUT),
                                    axes=(1, 2), align_corners=False)
                return face(img * 2.0 - 1.0).cpu()
    return lpips_apply, embedding_apply


def evaluate_metrics(output_dir: str, target_dir: str, lpips_apply=None,
                     embedding_apply=None, pretrained_path: str = "./pretrained",
                     device: Union[str, torch.device] = DEFAULT_DEVICE
                     ) -> Dict[str, Optional[float]]:
    """The metrics over the ``pred_frame*`` / ``cross_reenactment_images*``
    PNGs of `output_dir` that have a namesake in `target_dir`. When neither
    callable is given, the bundle at `pretrained_path` is installed (on
    `device`) and what is active is printed. The dict carries
    'AED_formula' ('identity_embedding' | 'procrustes_landmark_shape') and
    'AKD_provider' (the provider, with its centre-prior and detected
    counts for the box proxy)."""
    if lpips_apply is None and embedding_apply is None and pretrained_path:
        lpips_apply, embedding_apply = make_eval_callables(pretrained_path, device)
        print(
            "evaluate_metrics: auto-install from "
            f"{pretrained_path!r}: LPIPS "
            f"{'REAL (vgg16+lin heads)' if lpips_apply else 'absent -> None'}"
            f", AED "
            + ("identity_embedding (vggface)" if embedding_apply
               else "procrustes landmark-shape (near-constant under the "
                    "box proxy — see AKD_provider)")
        )
    scores: Dict[str, list] = {k: [] for k in ("L1", "LPIPS", "PSNR", "SSIM", "AKD", "AED")}
    for filename in sorted(os.listdir(output_dir)):
        if not (filename.startswith("cross_reenactment_images")
                or filename.startswith("pred_frame")):
            continue
        target_path = os.path.join(target_dir, filename)
        if not os.path.exists(target_path):
            continue
        pred = load_image(os.path.join(output_dir, filename))
        target = load_image(target_path)
        scores["L1"].append(calculate_l1(pred, target))
        scores["PSNR"].append(calculate_psnr(pred, target))
        scores["SSIM"].append(calculate_ssim(pred, target))
        if lpips_apply is not None:
            scores["LPIPS"].append(calculate_lpips(pred, target, lpips_apply))
        akd = calculate_akd(pred, target)
        if akd is not None:
            scores["AKD"].append(akd)
        aed = calculate_aed(pred, target, embedding_apply)
        if aed is not None:
            scores["AED"].append(aed)
    out: Dict[str, Optional[float]] = {
        k: (float(np.mean(v)) if v else None) for k, v in scores.items()}
    out["AED_formula"] = ("identity_embedding" if embedding_apply is not None
                          else "procrustes_landmark_shape")
    from megaportraits_tpu_torch.data.landmarks import get_landmark_provider

    prov = get_landmark_provider()
    out["AKD_provider"] = (
        f"{type(prov).__name__}"
        + (f" (center_prior {prov.n_center_prior}, detected {prov.n_detected})"
           if hasattr(prov, "n_center_prior") else ""))
    return out
