"""Student quality validation (counterpart of ``scripts/validate_student.py``):

    python -m megaportraits_tpu_torch.scripts.validate_student [--size 256]
        [--steps 300] [--out output_images/student_quality] [--device cuda]

Distils the Student (bf16 on the card, float32 on the CPU) against the
frozen GHR teacher (float32) on the clips' frames, one avatar a clip, and
reports LPIPS(student, teacher) and the pixel MSE on each avatar's held-out
last frame (the sampler draws from the first n - 1), with side-by-side
PNGs (teacher left) and ``RESULTS.txt`` in ``--out``. The JAX script's
flags, defaults and console lines, but for ``--out``, whose default is
under ``output_images/`` (git ignores it) instead of ``benchmarks/``.

The teacher's weights are seeded random unless ``--gbase-ckpt`` names a
trained export (``{'g_variables': ...}``, as ``overfit --export`` and
``train-base`` write it; ``<dir>/export`` is tried first) and
``--genh-ckpt`` one of Genh (``{'genh_variables': ...}``). Without a Genh
export and with a Gbase one, the teacher is Gbase alone (a random Genh
collapses the target).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import tempfile
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from megaportraits_tpu_torch.core.checkpoint import CheckpointManager
from megaportraits_tpu_torch.core.config import Config
from megaportraits_tpu_torch.core.debug import apply_platform_env
from megaportraits_tpu_torch.core.device import resolve_device
from megaportraits_tpu_torch.core.dtypes import FP32_POLICY, policy_for
from megaportraits_tpu_torch.data.dataset import EMODataset
from megaportraits_tpu_torch.losses.perceptual import LPIPS
from megaportraits_tpu_torch.models.genh import build_ghr
from megaportraits_tpu_torch.nn.layers import init_parameters
from megaportraits_tpu_torch.scripts.overfit import (
    REFERENCE_CLIP_LIST,
    REFERENCE_CLIPS,
    cache_dir,
    require,
)
from megaportraits_tpu_torch.train.train_student import (
    init_student_state,
    make_student_train_step,
    make_teacher_forward,
)
from megaportraits_tpu_torch.utils.image import write_image


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--num-avatars", type=int, default=2)
    ap.add_argument("--out", default="output_images/student_quality")
    ap.add_argument("--video-dir", default=REFERENCE_CLIPS)
    ap.add_argument("--json-file", default=REFERENCE_CLIP_LIST)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--gbase-ckpt", default="",
                    help="export of a TRAINED Gbase ({'g_variables': ...}) grafted "
                         "into the teacher")
    ap.add_argument("--norm", choices=["batch", "group"], default="batch",
                    help="teacher Gbase/Genh ResBlock2D norm flavor; must match the "
                         "grafted checkpoints (overfit --norm)")
    ap.add_argument("--teacher-bn-mode", choices=["batch", "running"], default="batch",
                    help="teacher forward convention; 'running' (serving) is right "
                         "for norm=group teachers")
    ap.add_argument("--genh-ckpt", default="",
                    help="export of a TRAINED Genh ({'genh_variables': ...}); without "
                         "it the teacher is Gbase-only")
    ap.add_argument("--device", default=None,
                    help="torch device (default: $MEGAPORTRAITS_PLATFORM, else cuda)")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    dev = resolve_device(apply_platform_env(args.device))

    cfg = Config()
    cfg.model.norm = args.norm
    cfg.data.train_width = cfg.data.train_height = args.size
    cfg.training.steps_per_epoch = args.steps
    cfg.training.student_epochs = 1
    cfg.training.num_avatars = args.num_avatars
    cfg.training.lr = args.lr

    frames = _load_frames(args)
    print(f"loaded {sum(len(f) for f in frames)} frames over "
          f"{len(frames)} avatars")

    # A float32 teacher: the higher-fidelity distillation reference. The
    # Student trains at the device's policy.
    teacher = build_ghr(cfg.make_arch(), policy=FP32_POLICY, device=dev, seed=0)
    if args.gbase_ckpt:
        _graft(teacher.gbase, args.gbase_ckpt, "g_variables", "--gbase-ckpt", "Gbase")
    if args.genh_ckpt:
        _graft(teacher.genh, args.genh_ckpt, "genh_variables", "--genh-ckpt", "Genh")
    include_enh = bool(args.genh_ckpt) or not args.gbase_ckpt
    if not include_enh:
        print("teacher: Gbase-only (no trained Genh provided — a random "
              "Genh would collapse the target distribution)")

    student, state = init_student_state(cfg, seed=0, policy=policy_for(dev),
                                        image_size=args.size, device=dev)
    step = make_student_train_step(student, teacher, cfg)
    teacher_fwd = make_teacher_forward(teacher, include_enh=include_enh,
                                       bn_mode=args.teacher_bn_mode)

    def on_device(a):
        return torch.from_numpy(np.asarray(a)).to(dev)

    rngn = np.random.default_rng(0)
    t0 = time.time()
    loss_curve = []
    for it in range(args.steps):
        batch = {k: on_device(v) for k, v in _sample_batch(frames, args.batch, rngn).items()}
        batch["target01"] = teacher_fwd(batch["source"], batch["driving"])
        state, metrics = step(state, batch)
        if it % 50 == 0 or it == args.steps - 1:
            loss = float(metrics["loss_student"])
            loss_curve.append((it, loss))
            print(f"step {it}: distill MSE {loss:.5f} "
                  f"({(time.time() - t0):.0f}s)")

    # Held-out eval: the LAST frame of each avatar (never sampled: the
    # sampler draws from [0, n-1)).
    lp = init_parameters(LPIPS(policy=FP32_POLICY, device=dev), 0)
    os.makedirs(args.out, exist_ok=True)
    rows = []
    student.eval()
    for a, fs in enumerate(frames):
        xd, xs = on_device(fs[-1][None]), on_device(fs[0][None])
        with torch.no_grad():
            tgt01 = teacher_fwd(xs, xd)
            pred = student(xd, on_device(np.asarray([a], np.int32))).float()
            lpips_val = float(lp(pred * 2 - 1, tgt01 * 2 - 1)[0])
        tgt01, pred = tgt01.cpu().numpy(), pred.cpu().numpy()
        mse = float(np.mean((pred - tgt01) ** 2))
        rows.append((a, mse, lpips_val))
        _save_png(np.concatenate([tgt01[0], pred[0]], axis=1),
                  os.path.join(args.out, f"avatar{a}_teacher_vs_student.png"))
        print(f"avatar {a}: held-out MSE {mse:.5f}  LPIPS {lpips_val:.4f}")

    with open(os.path.join(args.out, "RESULTS.txt"), "w") as f:
        f.write(f"steps={args.steps} size={args.size} "
                f"avatars={args.num_avatars}\n")
        f.write(f"gbase_ckpt={args.gbase_ckpt or 'RANDOM-INIT'} "
                f"genh_ckpt={args.genh_ckpt or 'none'} "
                f"teacher={'GHR' if include_enh else 'Gbase-only'} "
                f"norm={args.norm} "
                f"teacher_bn_mode={args.teacher_bn_mode}\n")
        f.write("loss curve: " + ", ".join(
            f"{i}:{v:.5f}" for i, v in loss_curve) + "\n")
        for a, mse, lpips_val in rows:
            f.write(f"avatar {a}: heldout MSE {mse:.5f} "
                    f"LPIPS {lpips_val:.4f}\n")
    print(f"wrote {args.out}/RESULTS.txt")
    return 0


def _graft(model: torch.nn.Module, ckpt_path: str, key: str, flag: str, what: str) -> None:
    """Restore an export ``{key: ...}`` into `model`: from ``<ckpt>/export``
    if it holds one, else from `ckpt`."""
    restored = None
    for path in (os.path.join(ckpt_path, "export"), ckpt_path):
        try:
            restored = CheckpointManager(path).restore({key: model})
        except Exception as e:
            print(f"note: no restorable {'genh ' if what == 'Genh' else ''}export at "
                  f"{path}: {e}")
            restored = None
        if restored is not None:
            break
    if restored is None:
        raise SystemExit(f"{flag}: nothing restorable at {ckpt_path}")
    print(f"teacher: grafted trained {what} from {ckpt_path}")


def _load_frames(args) -> List[np.ndarray]:
    """One avatar a video: every clip in --video-dir (by its .mp4 name),
    8 frames at sample rate 25, through the npz cache."""
    require(args.video_dir, "--video-dir")
    ids = sorted(os.path.splitext(os.path.basename(p))[0]
                 for p in glob.glob(os.path.join(args.video_dir, "*.mp4")))
    tmp_json = os.path.join(tempfile.gettempdir(), "student_clips.json")
    with open(tmp_json, "w") as f:
        json.dump({"clips": {i: {} for i in ids}}, f)
    os.makedirs(cache_dir(), exist_ok=True)
    ds = EMODataset(width=args.size, height=args.size, n_sample_frames=8, sample_rate=25,
                    video_dir=args.video_dir, json_file=tmp_json, cache_dir=cache_dir())
    return [ds.load_and_process_video(ds.video_ids[a])["source_frames"]
            for a in range(min(args.num_avatars, len(ds)))]


def _sample_batch(frames, batch, rngn):
    xs, xd, idx = [], [], []
    for _ in range(batch):
        a = int(rngn.integers(len(frames)))
        fs = frames[a]
        xs.append(fs[int(rngn.integers(len(fs) - 1))])
        xd.append(fs[int(rngn.integers(len(fs) - 1))])
        idx.append(a)
    return {"source": np.stack(xs), "driving": np.stack(xd),
            "avatar_index": np.asarray(idx, np.int32)}


def _save_png(img01, path):
    write_image((np.clip(img01, 0, 1) * 255).astype(np.uint8), path)


if __name__ == "__main__":
    raise SystemExit(main())
