"""Stage-2 training driver (counterpart of ``megaportraits_tpu/train/main_hr.py``):

    python -m megaportraits_tpu_torch.train.main_hr [--config configs/training/stage2-hr.yaml]
        [--max-steps N] [--gbase-ckpt DIR] [--upscale 2] [--synthetic-targets]
        [--device cuda]

A frozen Gbase (restored from ``<gbase-ckpt>/export``, else from
``<gbase-ckpt>``, when given) makes the base image; Genh learns the x`upscale`
enhancement. With native-resolution targets (the default) the clips are
decoded at ``size * upscale``, the driving frame at that resolution is the
target, and Gbase takes box-mean downsamples (``data/dataset.area_downsample``,
cv2's ``INTER_AREA`` at an integer factor, in numpy: the card's machine has
no cv2). ``--synthetic-targets`` keeps JAX's placeholder: the driving frame
upsampled by repetition. Checkpoints ``{"genh": state}``, held-out early
stopping (native targets only), the export ``{"genh_variables"}``.

The frozen Gbase runs in eval mode under ``torch.no_grad()`` inside the step
(``train/train_hr.py``) and in the evaluator, so with
``G2d.use_chain_kernel`` set its trunk runs on K2, once a sample.

Under ``torchrun`` the driver is data-parallel as ``train/main_base.py``
is: each rank keeps its rows of every global batch, the frozen Gbase is
rank 0's, rank 0 alone logs and writes, and the held-out decision is rank
0's.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Union

import numpy as np
import torch

from megaportraits_tpu_torch.core.checkpoint import CheckpointManager
from megaportraits_tpu_torch.core.config import Config, load_config
from megaportraits_tpu_torch.core.debug import apply_platform_env
from megaportraits_tpu_torch.core.device import DEFAULT_DEVICE
from megaportraits_tpu_torch.core.dtypes import DEFAULT_POLICY, FP32_POLICY
from megaportraits_tpu_torch.data.dataset import area_downsample
from megaportraits_tpu_torch.data.prefetch import prefetch_to_device
from megaportraits_tpu_torch.eval.heldout import HeldoutEvaluator
from megaportraits_tpu_torch.infer.inference import restore_gbase
from megaportraits_tpu_torch.parallel.mesh import distribute, is_main_process, shard_batch
from megaportraits_tpu_torch.train.main_base import (
    consider,
    make_dataset,
    set_steps_per_epoch,
    setup_mesh,
)
from megaportraits_tpu_torch.train.train_hr import init_hr_state, make_hr_train_step
from megaportraits_tpu_torch.utils.logging import MetricsWriter


def train_hr(cfg: Config, max_steps: Optional[int] = None,
             gbase_ckpt: Optional[str] = None, upscale: int = 2,
             native_hr: bool = True,
             device: Union[str, torch.device] = DEFAULT_DEVICE) -> dict:
    """Train Genh for `max_steps` steps (``hr_epochs`` epochs by default) on
    `device` (the card by default; raises if there is none and the caller
    did not ask for the CPU; under ``torchrun`` this rank's card). Returns
    the last metrics, the mean over the ranks."""
    dev, mesh = setup_mesh(cfg, device)
    main = is_main_process()
    policy = DEFAULT_POLICY if cfg.training.use_bf16 else FP32_POLICY
    seed = cfg.training.seed
    size = cfg.data.train_width
    native_hr = native_hr and upscale > 1

    gbase = cfg.make_gbase(policy=policy, device=dev, seed=seed)
    if gbase_ckpt:
        restore_gbase(gbase, (gbase_ckpt + "/export", gbase_ckpt))
    distribute(gbase, mesh)

    decode_size = size * upscale if native_hr else size
    dataset = make_dataset(cfg, decode_size, decode_size)
    set_steps_per_epoch(cfg, dataset)

    genh, ploss, state = init_hr_state(cfg, seed=seed, policy=policy, image_size=size,
                                       upscale=upscale, device=dev, mesh=mesh)
    step_fn = make_hr_train_step(genh, gbase, ploss, cfg, upscale=upscale, mesh=mesh)
    ckpt = CheckpointManager(cfg.training.checkpoint_path)
    writer = MetricsWriter("runs/hr_logs") if main else None

    evaluator = None
    holdout = cfg.training.holdout_frames if cfg.training.eval_interval else 0
    if cfg.training.eval_interval and native_hr:
        clips_hr = {
            vid: dataset.load_and_process_video(vid)["source_frames"]
            for vid in dataset.video_ids
        }
        evaluator = HeldoutEvaluator.for_genh(
            genh, gbase, clips_hr, holdout,
            cfg.training.batch_size, base_size=size, upscale=upscale,
        )
        if main:
            print(f"held-out early stopping: {evaluator.n_pairs} eval pairs, "
                  f"every {cfg.training.eval_interval} steps")
    elif cfg.training.eval_interval:
        if main:
            print("WARNING: eval_interval ignored — held-out HR eval needs "
                  "native_hr targets (synthetic targets carry no held-out "
                  "signal)")
        holdout = 0

    def hr_batches():
        for batch in dataset.frame_batches(cfg.training.batch_size,
                                           cfg.training.frame_offset,
                                           seed=seed, holdout=holdout):
            if native_hr:
                # Super-resolution supervision: the native-resolution
                # driving frame is the target; Gbase sees box-mean
                # downsamples at the base size.
                yield {"source": area_downsample(batch["source"], (size, size)),
                       "driving": area_downsample(batch["driving"], (size, size)),
                       "target_hr": batch["driving"]}
                continue
            # Placeholder path: the driving frame upsampled by repetition.
            target = batch["driving"]
            if upscale != 1:
                target = np.repeat(np.repeat(target, upscale, 1), upscale, 2)
            yield {"source": batch["source"], "driving": batch["driving"],
                   "target_hr": target}

    batches = prefetch_to_device((shard_batch(b, mesh) for b in hr_batches()), device=dev)
    total = max_steps or cfg.training.hr_epochs * cfg.training.steps_per_epoch
    metrics = {}
    t0 = time.time()
    for step_idx, batch in zip(range(total), batches):
        state, metrics = step_fn(state, batch)
        if main and (step_idx + 1) % cfg.training.log_interval == 0:
            host = {k: float(v) for k, v in metrics.items()}
            writer.write(step_idx, host)
            print(f"hr step {step_idx + 1}/{total}: {host} "
                  f"({(step_idx + 1) / (time.time() - t0):.2f} it/s)")
        if (step_idx + 1) % cfg.training.save_interval == 0:
            ckpt.save(step_idx + 1, {"genh": state})
        if evaluator is not None and (
                step_idx + 1) % cfg.training.eval_interval == 0:
            score, improved = consider(evaluator, state, step_idx + 1)
            if main:
                writer.write(step_idx, {"heldout_psnr": score})
                print(f"hr step {step_idx + 1}: held-out HR PSNR {score:.2f} dB"
                      f"{'  <- best' if improved else ''}")
    batches.close()
    ckpt.save(total, {"genh": state}, wait=True)

    # The inference payload ({'genh_variables': ...}, the convention of the
    # downstream tools). With early stopping on, the best held-out snapshot.
    export = CheckpointManager(cfg.training.checkpoint_path + "/export")
    export_step = total
    if evaluator is not None:
        genh_variables, best_step, is_best = evaluator.export_variables(state)
        if is_best:
            export_step = best_step
            if main:
                print(f"exporting best snapshot (step {best_step}, "
                      f"held-out {evaluator.best_psnr:.2f} dB)")
    else:
        genh_variables = state.model
    export.save(export_step, {"genh_variables": genh_variables}, wait=True)
    if main:
        writer.close()
    return {k: float(v) for k, v in metrics.items()}


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="configs/training/stage2-hr.yaml")
    parser.add_argument("--max-steps", type=int, default=None)
    parser.add_argument("--gbase-ckpt", default=None)
    parser.add_argument("--upscale", type=int, default=2)
    parser.add_argument(
        "--synthetic-targets", action="store_true",
        help="use the legacy nearest-upsampled targets instead of "
             "native-resolution decode",
    )
    parser.add_argument("--device", default=None,
                        help="torch device (default: $MEGAPORTRAITS_PLATFORM, else cuda)")
    args = parser.parse_args()
    train_hr(load_config(args.config), args.max_steps, args.gbase_ckpt,
             args.upscale, native_hr=not args.synthetic_targets,
             device=apply_platform_env(args.device))


if __name__ == "__main__":
    main()
