"""Stage-3 training driver (counterpart of ``megaportraits_tpu/train/main_student.py``):

    python -m megaportraits_tpu_torch.train.main_student
        [--config configs/training/stage3-student.yaml] [--max-steps N]
        [--teacher-ckpt DIR] [--device cuda]

The frozen GHR teacher (restored from ``{"ghr_variables"}`` when a
checkpoint is given) makes the targets inline; the per-avatar SPADE Student
learns them by MSE. Batches draw avatars among the first
``min(num_avatars, len(dataset))`` clips with JAX's numpy draws; the
Student itself is built for ``cfg.training.num_avatars``, as in JAX.
Checkpoints ``{"student": state}``.

The teacher runs in eval mode under ``torch.no_grad()``
(``train/train_student.py``), so in bf16 on the card its Gbase's trunk
runs on K2, once a sample.

Under ``torchrun`` the driver is data-parallel as ``train/main_base.py``
is: each rank keeps its rows of every global batch (the avatar draws are
the same on every rank), the teacher is rank 0's, and rank 0 alone logs
and writes.
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
from megaportraits_tpu_torch.data.prefetch import prefetch_to_device
from megaportraits_tpu_torch.models.genh import build_ghr
from megaportraits_tpu_torch.parallel.mesh import distribute, is_main_process, shard_batch
from megaportraits_tpu_torch.train.main_base import make_dataset, set_steps_per_epoch, setup_mesh
from megaportraits_tpu_torch.train.train_student import (
    init_student_state,
    make_student_train_step,
)
from megaportraits_tpu_torch.utils.logging import MetricsWriter


def train_student(cfg: Config, max_steps: Optional[int] = None,
                  teacher_ckpt: Optional[str] = None,
                  device: Union[str, torch.device] = DEFAULT_DEVICE) -> dict:
    """Distil the Student for `max_steps` steps (``student_epochs`` epochs
    by default) on `device` (the card by default; raises if there is none
    and the caller did not ask for the CPU; under ``torchrun`` this rank's
    card). Returns the last metrics, the mean over the ranks."""
    dev, mesh = setup_mesh(cfg, device)
    main = is_main_process()
    policy = DEFAULT_POLICY if cfg.training.use_bf16 else FP32_POLICY
    seed = cfg.training.seed
    size = cfg.data.train_width

    teacher = build_ghr(cfg.make_arch(), policy=policy, device=dev, seed=seed)
    if teacher_ckpt:
        CheckpointManager(teacher_ckpt).restore({"ghr_variables": teacher})
    distribute(teacher, mesh)

    dataset = make_dataset(cfg, size, size)
    set_steps_per_epoch(cfg, dataset)
    num_avatars = min(cfg.training.num_avatars, len(dataset))

    student, state = init_student_state(cfg, seed=seed, policy=policy, image_size=size,
                                        device=dev, mesh=mesh)
    step_fn = make_student_train_step(student, teacher, cfg, mesh=mesh)
    ckpt = CheckpointManager(cfg.training.checkpoint_path)
    writer = MetricsWriter("runs/student_logs") if main else None

    def avatar_batches():
        rng_np = np.random.default_rng(seed)
        b = cfg.training.batch_size
        while True:
            idx = rng_np.integers(num_avatars, size=b)
            src, drv = [], []
            for avatar in idx:
                item = dataset[int(avatar)]
                fi = int(rng_np.integers(len(item["driving_frames"])))
                src.append(item["source_frames"][fi % len(item["source_frames"])])
                drv.append(item["driving_frames"][fi])
            yield {"source": np.stack(src), "driving": np.stack(drv),
                   "avatar_index": idx.astype(np.int32)}

    batches = prefetch_to_device((shard_batch(b, mesh) for b in avatar_batches()),
                                 device=dev)
    total = max_steps or (cfg.training.student_epochs
                          * cfg.training.steps_per_epoch)
    metrics = {}
    t0 = time.time()
    for step_idx, batch in zip(range(total), batches):
        state, metrics = step_fn(state, batch)
        if main and (step_idx + 1) % cfg.training.log_interval == 0:
            host = {k: float(v) for k, v in metrics.items()}
            writer.write(step_idx, host)
            print(f"student step {step_idx + 1}/{total}: {host} "
                  f"({(step_idx + 1) / (time.time() - t0):.2f} it/s)")
        if (step_idx + 1) % cfg.training.save_interval == 0:
            ckpt.save(step_idx + 1, {"student": state})
    batches.close()
    ckpt.save(total, {"student": state}, wait=True)
    if main:
        writer.close()
    return {k: float(v) for k, v in metrics.items()}


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--config",
                        default="configs/training/stage3-student.yaml")
    parser.add_argument("--max-steps", type=int, default=None)
    parser.add_argument("--teacher-ckpt", default=None)
    parser.add_argument("--device", default=None,
                        help="torch device (default: $MEGAPORTRAITS_PLATFORM, else cuda)")
    args = parser.parse_args()
    train_student(load_config(args.config), args.max_steps, args.teacher_ckpt,
                  apply_platform_env(args.device))


if __name__ == "__main__":
    main()
