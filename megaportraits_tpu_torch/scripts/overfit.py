"""Overfit harness: stage-1 training on a few clips (counterpart of
``scripts/overfit.py``; BASELINE.json configs[2], 'train_base overfit run
on data/overfit.json'):

    python -m megaportraits_tpu_torch.scripts.overfit [--size 256] [--steps 60]
        [--batch 2] [--pool N] [--eval-every N] [--export DIR] [--device cuda]

The JAX script's flags, defaults and console lines. It preprocesses the
clips into the npz cache (``megaportraits_cache`` under the temporary
directory, ``$TMPDIR``), trains the fused stage-1 step on the device
(bf16 on the card, float32 on the CPU), prints the loss trajectory and
dumps sample frames to ``output_images/``. ``--pool N`` keeps N batches on
the device and draws one a step with numpy's generator seeded 1, as JAX
does (``make_train_step(pool_index=True)``). ``--eval-every`` scores the
held-out self-reenactment PSNR (``eval/heldout.py``) and keeps the best
snapshot, which ``--export`` writes as soon as it improves, with the
``{'g_variables': ...}`` schema of ``train/main_base``'s export
(``core/checkpoint.py``); the final state goes to ``<export>_final`` when
the best is an earlier step. The default clips are the JAX script's, the
reference implementation's, which this repo does not hold; a missing one
raises naming its path. Nothing is fetched.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from typing import Optional, Sequence

import numpy as np
import torch

from megaportraits_tpu_torch.core.checkpoint import CheckpointManager
from megaportraits_tpu_torch.core.config import Config
from megaportraits_tpu_torch.core.debug import apply_platform_env
from megaportraits_tpu_torch.core.device import resolve_device
from megaportraits_tpu_torch.core.dtypes import policy_for
from megaportraits_tpu_torch.data.dataset import EMODataset
from megaportraits_tpu_torch.eval.heldout import HeldoutEvaluator
from megaportraits_tpu_torch.train.train_base import init_states, make_train_step
from megaportraits_tpu_torch.utils.image import save_image

# The JAX scripts' default clips (the reference implementation's tree).
REFERENCE_CLIPS = "/root/reference/junk"
REFERENCE_CLIP_LIST = "/root/reference/data/overfit.json"


def cache_dir() -> str:
    """The npz cache the JAX script keeps under /tmp, here under the
    temporary directory."""
    return os.path.join(tempfile.gettempdir(), "megaportraits_cache")


def require(path: str, flag: str) -> None:
    if not os.path.exists(path):
        raise FileNotFoundError(f"{flag} {path} does not exist (the reference's clips are "
                                "not in this repo; pass clips of your own)")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--size", type=int, default=256)
    parser.add_argument("--steps", type=int, default=60)
    parser.add_argument("--batch", type=int, default=2)
    parser.add_argument("--video-dir", default=REFERENCE_CLIPS)
    parser.add_argument("--json-file", default=REFERENCE_CLIP_LIST)
    parser.add_argument("--frames", type=int, default=8)
    parser.add_argument("--sample-rate", type=int, default=10,
                        help="decode every Nth frame")
    parser.add_argument("--log-every", type=int, default=10)
    parser.add_argument("--pool", type=int, default=0,
                        help="precompute N batches, keep them on the device, and "
                             "sample one of them per step")
    parser.add_argument("--export", default="",
                        help="export dir for the trained Gbase ({'g_variables': ...}, "
                             "the main_base export schema)")
    parser.add_argument("--eval-every", type=int, default=0,
                        help="held-out self-reenactment PSNR every N steps; keeps the "
                             "best-PSNR snapshot and exports THAT (early stopping)")
    parser.add_argument("--eval-bn-mode", choices=["batch", "running"], default="batch",
                        help="held-out eval forward: 'batch' = batch statistics, "
                             "'running' = the serving forward")
    parser.add_argument("--eval-burn-in", type=int, default=0,
                        help="ignore held-out evals before this step when tracking "
                             "the best snapshot")
    parser.add_argument("--holdout", type=int, default=4,
                        help="frames reserved per clip as the held-out eval tail "
                             "(excluded from training batches when --eval-every is set)")
    parser.add_argument("--norm", choices=["batch", "group"], default="batch",
                        help="ResBlock2D norm flavor (core/arch.py)")
    parser.add_argument("--export-clean", action="store_true",
                        help="wipe a non-empty --export dir at startup instead of "
                             "refusing")
    parser.add_argument("--all-clips", action="store_true",
                        help="train on every video in --video-dir instead of only the "
                             "clips listed in --json-file")
    parser.add_argument("--device", default=None,
                        help="torch device (default: $MEGAPORTRAITS_PLATFORM, else cuda)")
    return parser.parse_args(argv)


def open_export(args) -> Optional[CheckpointManager]:
    """One manager for the whole run; a non-empty dir is refused (or wiped
    with --export-clean), so that an earlier run's steps can neither collide
    with this run's saves nor shadow its result."""
    if not args.export:
        return None
    mgr = CheckpointManager(args.export)
    if mgr.latest_step() is not None:
        if not args.export_clean:
            sys.exit(f"--export dir {args.export} already holds step "
                     f"{mgr.latest_step()}; pass --export-clean to wipe it or choose a "
                     "fresh dir")
        shutil.rmtree(args.export)
        mgr = CheckpointManager(args.export)
    return mgr


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the harness; returns the first and last loss_G, the best
    held-out step and score, and the export step (None without --export)."""
    args = parse_args(argv)
    dev = resolve_device(apply_platform_env(args.device))
    require(args.video_dir, "--video-dir")
    if args.all_clips:
        # An empty clip list makes EMODataset list --video-dir.
        args.json_file = os.path.join(tempfile.gettempdir(), "overfit_all.json")
        with open(args.json_file, "w") as f:
            json.dump({"clips": {}}, f)
    require(args.json_file, "--json-file")

    cache = cache_dir()
    os.makedirs(cache, exist_ok=True)
    t0 = time.time()
    dataset = EMODataset(
        width=args.size, height=args.size,
        n_sample_frames=args.frames, sample_rate=args.sample_rate,
        video_dir=args.video_dir, json_file=args.json_file,
        cache_dir=cache,
    )
    for vid in dataset.video_ids:
        dataset.load_and_process_video(vid)
        print(f"preprocessed {vid} ({time.time() - t0:.1f}s)", flush=True)

    cfg = Config()
    cfg.data.train_width = cfg.data.train_height = args.size
    cfg.training.steps_per_epoch = args.steps
    cfg.training.lr = 3e-5
    cfg.model.norm = args.norm

    export_mgr = open_export(args)
    last_saved_step = None

    gbase, disc, ploss, g_state, d_state = init_states(
        cfg, seed=0, policy=policy_for(dev), device=dev, image_size=args.size)
    print(f"init done ({time.time() - t0:.1f}s)", flush=True)
    step = make_train_step(ploss, cfg, pool_index=bool(args.pool))

    holdout = args.holdout if args.eval_every else 0
    batches = dataset.frame_batches(args.batch, frame_offset=3, seed=0, holdout=holdout)
    first_g = None

    evaluator = None
    if args.eval_every:
        clips = {vid: dataset.load_and_process_video(vid)["source_frames"]
                 for vid in dataset.video_ids}
        evaluator = HeldoutEvaluator.for_gbase(gbase, clips, holdout, args.batch,
                                               burn_in=args.eval_burn_in,
                                               bn_mode=args.eval_bn_mode)
        if not evaluator.n_pairs:
            print("WARNING: no held-out eval pairs — check --holdout "
                  "vs clip lengths", flush=True)

    def to_device(b):
        return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}

    if args.pool:
        pool_list = [next(batches) for _ in range(args.pool)]
        pool = to_device({k: np.stack([b[k] for b in pool_list]) for k in pool_list[0]})
        rng = np.random.default_rng(1)
        print(f"pool of {args.pool} batches uploaded "
              f"({time.time() - t0:.1f}s)", flush=True)

    for i in range(args.steps):
        if args.pool:
            pi = int(rng.integers(args.pool))
            g_state, d_state, metrics, xhat = step(g_state, d_state, pool, pi)
            driving_img = pool_list[pi]["driving"]
        else:
            batch = next(batches)
            g_state, d_state, metrics, xhat = step(g_state, d_state, to_device(batch))
            driving_img = batch["driving"]
        if i == 0 or (i + 1) % args.log_every == 0:
            m = {k: round(float(v), 4) for k, v in metrics.items()}
            if first_g is None:
                first_g = m["loss_G"]
            print(f"step {i + 1}: {m} ({time.time() - t0:.1f}s)", flush=True)
            save_image(xhat, f"output_images/overfit_pred_{i + 1}.png")
            save_image(driving_img, f"output_images/overfit_target_{i + 1}.png")
        if evaluator is not None and (i + 1) % args.eval_every == 0:
            psnr, improved = evaluator.consider(g_state, i + 1)
            print(f"step {i + 1}: held-out self-PSNR {psnr:.2f} dB"
                  f"{'  <- best' if improved else ''} "
                  f"({time.time() - t0:.1f}s)", flush=True)
            if improved and export_mgr is not None:
                # The best snapshot goes to disk as soon as it improves.
                export_mgr.save(i + 1, {"g_variables": evaluator.best_variables})
                last_saved_step = i + 1
    final_g = float(metrics["loss_G"])
    print(f"loss_G: {first_g:.4f} -> {final_g:.4f} "
          f"({'DECREASED' if final_g < first_g else 'NOT DECREASED'})", flush=True)
    if evaluator is not None and evaluator.best_variables is not None:
        print(f"best held-out self-PSNR {evaluator.best_psnr:.2f} dB at "
              f"step {evaluator.best_step} (exporting THAT snapshot)", flush=True)

    export_step = None
    if export_mgr is not None:
        final_variables = HeldoutEvaluator.variables_of(g_state)
        export_step = args.steps
        g_variables = final_variables
        if evaluator is not None:
            g_variables, best_step, is_best = evaluator.export_variables(g_state)
            if is_best:
                export_step = best_step
        if last_saved_step != export_step:
            export_mgr.save(export_step, {"g_variables": g_variables}, wait=True)
        export_mgr.close()
        print(f"exported trained Gbase (step {export_step}) to {args.export}", flush=True)
        if evaluator is not None and export_step != args.steps:
            # Keep the final state too: one early noise spike can pin "best"
            # to an undertrained snapshot.
            mgr = CheckpointManager(args.export.rstrip("/") + "_final")
            mgr.save(args.steps, {"g_variables": final_variables}, wait=True)
            mgr.close()
            print(f"exported FINAL-state Gbase (step {args.steps}) to "
                  f"{args.export}_final", flush=True)
    return {"first_loss_G": first_g, "final_loss_G": final_g,
            "best_step": evaluator.best_step if evaluator is not None else None,
            "best_psnr": evaluator.best_psnr if evaluator is not None else None,
            "export_step": export_step}


if __name__ == "__main__":
    main()
