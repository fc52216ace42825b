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

Data parallelism: launched by ``torchrun`` (``torchrun --standalone
--nproc-per-node N -m megaportraits_tpu_torch train-base --config ...``),
each rank joins the process group (``parallel/mesh.init_distributed``), the
mesh is ``make_mesh(cfg.training.mesh_shape)`` as in JAX, and every rank
reads the same global batches and keeps its rows (``shard_batch``; with
``unroll_steps > 1`` along the batch axis of the stacked batches, where
JAX shards the leading unroll axis). The data axis must divide
``batch_size``: JAX shrinks its data axis to the largest divisor of the
batch, a launch cannot shrink, so the driver raises before the first step
and names that divisor. Rank 0 alone logs, writes PNGs and writes
checkpoints and the export (every rank calls ``save``: the optimiser
gathers its shards into the single-process format); the held-out score and
its decision are rank 0's on every rank. Without ``torchrun`` it runs on
one card, or on the CPU when asked; a ``mesh_shape`` larger than the world
is adapted with a warning, as JAX does. Without ``--device``, the device is
``MEGAPORTRAITS_PLATFORM``'s when it is set (``core/debug.apply_platform_env``).
"""

from __future__ import annotations

import argparse
import time
from typing import Iterator, Optional, Union

import numpy as np
import torch

from megaportraits_tpu_torch.core.checkpoint import CheckpointManager
from megaportraits_tpu_torch.core.config import Config, load_config
from megaportraits_tpu_torch.core.debug import apply_platform_env
from megaportraits_tpu_torch.core.device import DEFAULT_DEVICE
from megaportraits_tpu_torch.core.dtypes import DEFAULT_POLICY, FP32_POLICY
from megaportraits_tpu_torch.data.dataset import EMODataset
from megaportraits_tpu_torch.data.landmarks import provider_from_bundle
from megaportraits_tpu_torch.data.prefetch import prefetch_to_device
from megaportraits_tpu_torch.eval.heldout import HeldoutEvaluator
from megaportraits_tpu_torch.losses.gaze import gaze_masks_for_batch
from megaportraits_tpu_torch.parallel.mesh import (
    broadcast_from_main,
    check_batch_divides,
    check_per_chip_batch,
    init_distributed,
    is_main_process,
    make_mesh,
    shard_batch,
)
from megaportraits_tpu_torch.train.train_base import init_states, make_train_step
from megaportraits_tpu_torch.utils.image import save_image
from megaportraits_tpu_torch.utils.logging import MetricsWriter


def setup_mesh(cfg: Config, device: Union[str, torch.device]):
    """(this rank's device, the mesh) for a driver: the process group of
    ``torchrun``'s environment if any, ``make_mesh(cfg.training.mesh_shape)``,
    and JAX's per-chip batch check; raises unless the data axis divides
    ``batch_size``."""
    dev = init_distributed(device)
    mesh = make_mesh(cfg.training.mesh_shape, device=dev)
    check_batch_divides(cfg.training.batch_size, mesh)
    check_per_chip_batch(cfg.training.batch_size, mesh)
    return dev, mesh


def consider(evaluator: HeldoutEvaluator, state, step: int):
    """The evaluator's (score, improved) at `step`, rank 0's on every rank."""
    return tuple(broadcast_from_main(evaluator.consider(state, step)))


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
    the caller did not ask for the CPU; under ``torchrun`` this rank's
    card). Returns the last metrics, the mean over the ranks."""
    dev, mesh = setup_mesh(cfg, device)
    main = is_main_process()
    policy = DEFAULT_POLICY if cfg.training.use_bf16 else FP32_POLICY

    dataset = make_dataset(cfg, cfg.data.train_width, cfg.data.train_height)
    steps_per_epoch = set_steps_per_epoch(cfg, dataset)

    gbase, disc, ploss, g_state, d_state = init_states(
        cfg, seed=cfg.training.seed, policy=policy, device=dev, mesh=mesh)

    ckpt = CheckpointManager(cfg.training.checkpoint_path)
    latest = ckpt.latest_step()
    if latest is not None:
        ckpt.restore({"g": g_state, "d": d_state}, latest)
        if main:
            print(f"Resumed from checkpoint step {latest}")

    unroll = max(1, cfg.training.unroll_steps)
    step_fn = make_train_step(ploss, cfg, unroll=unroll, mesh=mesh)
    writer = MetricsWriter() if main else None

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
        if main:
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

    batch_axis = 0 if unroll == 1 else 1
    batches = prefetch_to_device(
        (shard_batch(b, mesh, batch_axis) for b in grouped()), device=dev)

    total_steps = max_steps or cfg.training.base_epochs * steps_per_epoch
    start = int(g_state.step)
    t0 = time.time()
    metrics = {}
    for call_idx, batch in zip(
        range(start // unroll, -(-total_steps // unroll)), batches
    ):
        g_state, d_state, metrics, xhat = step_fn(g_state, d_state, batch)
        step_idx = (call_idx + 1) * unroll
        if main and step_idx % cfg.training.log_interval < unroll:
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
            score, improved = consider(evaluator, g_state, step_idx)
            if main:
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
            if main:
                print(f"exporting best snapshot (step {best_step}, "
                      f"held-out {evaluator.best_psnr:.2f} dB)")
    else:
        g_variables = g_state.model
    export.save(export_step, {"g_variables": g_variables}, wait=True)
    if main:
        writer.close()
    return {k: float(v) for k, v in metrics.items()}


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="configs/training/stage1-base.yaml")
    parser.add_argument("--max-steps", type=int, default=None)
    parser.add_argument("--device", default=None,
                        help="torch device (default: $MEGAPORTRAITS_PLATFORM, else cuda)")
    args = parser.parse_args()
    train_base(load_config(args.config), args.max_steps, apply_platform_env(args.device))


if __name__ == "__main__":
    main()
