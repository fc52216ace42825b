"""Stage-1 training driver (counterpart of ``megaportraits_tpu/train/main_base.py``):

    python -m megaportraits_tpu_torch.train.main_base [--config configs/training/stage1-base.yaml]
        [--max-steps N] [--device cuda]

EMODataset (the npz-cached host pipeline) -> ``prefetch_to_device`` (pinned
host memory, copies on a side stream) -> the fused stage-1 step ->
TensorBoard metrics and console lines, PNG debug dumps, checkpoints
``{"g", "d"}`` with resume from the latest, held-out early stopping, and the
export ``{"g_variables"}`` under ``<checkpoint_path>/export`` (the best
held-out snapshot when ``eval_interval`` is set).

With ``use_gaze_loss`` each batch gets eye masks ``gaze_masks`` [B, H, W, 2]
from its driving frames (``losses/gaze.gaze_masks_for_batch``), made on the
host before batches are grouped and prefetched, so in the prefetch's
producer thread. The landmarks come from the installed provider: the FAN
provider of the pretrained bundle when ``pretrained_path`` holds FAN
weights (installed here, as ``eval`` does). FAN runs on the card on a CUDA
stream of the provider's own, not on the training step's stream, so the
producer's forwards overlap the step. Without a 68-point provider the term
is skipped (one console line); once masks have been seen, a batch without
them gets zero masks, so that the step's batch keeps its keys.

Runs on one card (or on the CPU when asked). A ``mesh_shape`` of more than
one device raises ``NotImplementedError``: data parallelism waits for
``parallel/`` (ROADMAP Queue A item 5). Not ported: JAX's
``check_per_chip_batch`` and ``apply_platform_env``, TPU housekeeping with
no counterpart on a card.
"""

from __future__ import annotations

import argparse
import math
import time
from typing import Iterator, Optional, Union

import numpy as np
import torch

from megaportraits_tpu_torch.core.checkpoint import CheckpointManager
from megaportraits_tpu_torch.core.config import Config, load_config
from megaportraits_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device
from megaportraits_tpu_torch.core.dtypes import DEFAULT_POLICY, FP32_POLICY
from megaportraits_tpu_torch.data.dataset import EMODataset
from megaportraits_tpu_torch.data.landmarks import provider_from_bundle
from megaportraits_tpu_torch.data.prefetch import prefetch_to_device
from megaportraits_tpu_torch.eval.heldout import HeldoutEvaluator
from megaportraits_tpu_torch.losses.gaze import gaze_masks_for_batch
from megaportraits_tpu_torch.train.train_base import init_states, make_train_step
from megaportraits_tpu_torch.utils.image import save_image
from megaportraits_tpu_torch.utils.logging import MetricsWriter


def check_single_device(cfg: Config) -> None:
    """Raise where the config asks for a mesh of more than one device."""
    shape = cfg.training.mesh_shape
    if shape and math.prod(shape.values()) > 1:
        raise NotImplementedError(
            f"mesh_shape {shape} asks for {math.prod(shape.values())} devices; the "
            f"port trains on one (data parallelism waits for parallel/, ROADMAP "
            f"Queue A item 5)")


def make_dataset(cfg: Config, width: int, height: int) -> EMODataset:
    """The config's clips, decoded (or read from the npz cache) at
    `width` x `height`."""
    return EMODataset(
        width=width, height=height,
        n_sample_frames=cfg.training.n_sample_frames,
        sample_rate=cfg.training.sample_rate,
        video_dir=cfg.training.video_dir,
        json_file=cfg.training.json_file,
        seed=cfg.training.seed,
    )


def set_steps_per_epoch(cfg: Config, dataset: EMODataset) -> int:
    """``steps_per_epoch`` as JAX derives it when the config has none,
    written into the config (the optimisers' cosine schedules read it)."""
    t = cfg.training
    t.steps_per_epoch = t.steps_per_epoch or max(
        1, len(dataset) * t.n_sample_frames // t.batch_size)
    return t.steps_per_epoch


def with_gaze_masks(batches: Iterator[dict]) -> Iterator[dict]:
    """`batches` with 'gaze_masks' rasterised from each batch's driving
    frames by the installed landmark provider (JAX's ``with_gaze``)."""
    warned = had_masks = False
    for b in batches:
        masks = gaze_masks_for_batch(b["driving"])
        if masks is None:
            if had_masks:
                b["gaze_masks"] = np.zeros((*b["driving"].shape[:3], 2), np.float32)
            elif not warned:
                print("use_gaze_loss: no 68-point landmark provider (converted FAN "
                      "weights absent) — gaze term skipped")
                warned = True
        else:
            had_masks = True
            b["gaze_masks"] = masks
        yield b


def train_base(cfg: Config, max_steps: Optional[int] = None,
               device: Union[str, torch.device] = DEFAULT_DEVICE) -> dict:
    """Train stage 1 for `max_steps` steps (``base_epochs`` epochs by
    default) on `device` (the card by default; raises if there is none and
    the caller did not ask for the CPU). Returns the last metrics."""
    check_single_device(cfg)
    dev = resolve_device(device)
    policy = DEFAULT_POLICY if cfg.training.use_bf16 else FP32_POLICY

    dataset = make_dataset(cfg, cfg.data.train_width, cfg.data.train_height)
    steps_per_epoch = set_steps_per_epoch(cfg, dataset)

    gbase, disc, ploss, g_state, d_state = init_states(
        cfg, seed=cfg.training.seed, policy=policy, device=dev)

    ckpt = CheckpointManager(cfg.training.checkpoint_path)
    latest = ckpt.latest_step()
    if latest is not None:
        ckpt.restore({"g": g_state, "d": d_state}, latest)
        print(f"Resumed from checkpoint step {latest}")

    unroll = max(1, cfg.training.unroll_steps)
    step_fn = make_train_step(ploss, cfg, unroll=unroll)
    writer = MetricsWriter()

    holdout = cfg.training.holdout_frames if cfg.training.eval_interval else 0
    raw_batches = dataset.frame_batches(
        cfg.training.batch_size, cfg.training.frame_offset,
        seed=cfg.training.seed, holdout=holdout,
    )

    evaluator = None
    if cfg.training.eval_interval:
        clips = {
            vid: dataset.load_and_process_video(vid)["source_frames"]
            for vid in dataset.video_ids
        }
        evaluator = HeldoutEvaluator.for_gbase(
            gbase, clips, holdout, cfg.training.batch_size)
        print(f"held-out early stopping: {evaluator.n_pairs} eval pairs, "
              f"every {cfg.training.eval_interval} steps")

    if cfg.training.use_gaze_loss:
        if cfg.training.pretrained_path:
            provider_from_bundle(cfg.training.pretrained_path, device=dev)
        raw_batches = with_gaze_masks(raw_batches)

    def grouped():
        if unroll == 1:
            yield from raw_batches
            return
        while True:
            group = [next(raw_batches) for _ in range(unroll)]
            yield {
                k: np.stack([g[k] for g in group]) for k in group[0]
            }

    batches = prefetch_to_device(grouped(), device=dev)

    total_steps = max_steps or cfg.training.base_epochs * steps_per_epoch
    start = int(g_state.step)
    t0 = time.time()
    metrics = {}
    for call_idx, batch in zip(
        range(start // unroll, -(-total_steps // unroll)), batches
    ):
        g_state, d_state, metrics, xhat = step_fn(g_state, d_state, batch)
        step_idx = (call_idx + 1) * unroll
        if step_idx % cfg.training.log_interval < unroll:
            host = {k: float(v) for k, v in metrics.items()}
            host["steps_per_sec"] = (step_idx - start) / (time.time() - t0)
            writer.write(step_idx, host)
            print(f"step {step_idx}/{total_steps}: "
                  f"G={host['loss_G']:.4f} D={host['loss_D']:.4f} "
                  f"({host['steps_per_sec']:.2f} it/s)")
            if xhat is not None:
                save_image(xhat, f"output_images/pred_frame_{step_idx}.png")
        if step_idx % cfg.training.save_interval < unroll:
            ckpt.save(step_idx, {"g": g_state, "d": d_state})
        if evaluator is not None and (
                step_idx % cfg.training.eval_interval < unroll):
            score, improved = evaluator.consider(g_state, step_idx)
            writer.write(step_idx, {"heldout_psnr": score})
            print(f"step {step_idx}: held-out self-PSNR {score:.2f} dB"
                  f"{'  <- best' if improved else ''}")
    batches.close()
    ckpt.save(total_steps, {"g": g_state, "d": d_state}, wait=True)

    # The inference payload (weights and statistics: the reference's
    # Gbase.pth). With early stopping on, the best held-out snapshot.
    export = CheckpointManager(cfg.training.checkpoint_path + "/export")
    export_step = total_steps
    if evaluator is not None:
        g_variables, best_step, is_best = evaluator.export_variables(g_state)
        if is_best:
            export_step = best_step
            print(f"exporting best snapshot (step {best_step}, "
                  f"held-out {evaluator.best_psnr:.2f} dB)")
    else:
        g_variables = g_state.model
    export.save(export_step, {"g_variables": g_variables}, wait=True)
    writer.close()
    return {k: float(v) for k, v in metrics.items()}


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="configs/training/stage1-base.yaml")
    parser.add_argument("--max-steps", type=int, default=None)
    parser.add_argument("--device", default=DEFAULT_DEVICE,
                        help="torch device (default: cuda)")
    args = parser.parse_args()
    train_base(load_config(args.config), args.max_steps, args.device)


if __name__ == "__main__":
    main()
