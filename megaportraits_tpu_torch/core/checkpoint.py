"""Checkpoints: one directory per step, written with ``torch.save``
(counterpart of ``megaportraits_tpu/core/checkpoint.py``, which wraps an
Orbax ``CheckpointManager``).

The manager keeps the Orbax manager's contract:
  * a checkpoint is the directory ``<directory>/<step>``, and
    ``latest_step()`` is the largest such step (None when there is none);
  * ``save`` writes nothing and returns False for a step that is not newer
    than the latest one (Orbax refuses it the same way); otherwise it writes
    into a temporary directory and renames it into place, so that a step
    directory is whole or absent, then keeps the newest `max_to_keep`;
  * ``restore(payload_like)`` returns None without a checkpoint; otherwise
    it fills `payload_like` from the step and returns it.

A payload is a dict (nested dicts allowed) whose leaves are modules,
``TrainState``s, tensors or plain values. A module saves its
``state_dict``; a ``TrainState`` its model's ``state_dict``, AdamW's state
(moments and step counts), the cosine schedule's count and ``step``.
Restoring loads them in place (strict) into the modules and states of
`payload_like`; a tensor leaf comes back on the device of its counterpart.
The payload keys are those of the JAX package's training scripts
(``train/main_*.py``): ``g_variables``, ``genh_variables``, ``genh``,
``student``, ``ghr_variables``.

Orbax checkpoints written by the JAX package are not read: weights cross
from JAX only through ``utils/jax_bridge.py``.

Under a process group (``parallel/mesh.py``) every rank calls ``save``: the
optimiser gathers the moments of sharded parameters (a collective), so the
file has the single-process format and restores in one process; rank 0
alone writes, and all ranks leave ``save`` once the step is on disk.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Optional

import torch
import torch.distributed as dist
from torch import nn

from megaportraits_tpu_torch.parallel.mesh import is_main_process
from megaportraits_tpu_torch.train.state import TrainState

FILE_NAME = "checkpoint.pt"


def _to_saved(value: Any) -> Any:
    if isinstance(value, TrainState):
        return {"model": value.model.state_dict(), **value.tx.state_dict(),
                "step": value.step}
    if isinstance(value, nn.Module):
        return value.state_dict()
    if isinstance(value, dict):
        return {k: _to_saved(v) for k, v in value.items()}
    return value


def _fill(like: Any, saved: Any, path: str) -> Any:
    if isinstance(like, TrainState):
        like.model.load_state_dict(saved["model"], strict=True)
        like.tx.load_state_dict(saved)
        like.step = saved["step"]
        return like
    if isinstance(like, nn.Module):
        like.load_state_dict(saved, strict=True)
        return like
    if isinstance(like, dict):
        missing = [k for k in like if k not in saved]
        if missing:
            raise KeyError(f"the checkpoint has no {missing} under '{path}'")
        return {k: _fill(v, saved[k], f"{path}/{k}") for k, v in like.items()}
    if isinstance(like, torch.Tensor):
        return saved.to(like.device)
    return saved


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be at least 1, got {max_to_keep}")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep

    def _steps(self) -> list:
        """The steps on disk, in increasing order."""
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit()
                      and os.path.isdir(os.path.join(self.directory, name)))

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def save(self, step: int, payload: Any, wait: bool = False) -> bool:
        """Write `payload` as `step`; False (nothing written) if `step` is
        not newer than the latest step. The write is done when this
        returns: `wait` is the JAX manager's switch for its asynchronous
        saves and changes nothing here. Under a process group every rank
        calls it and rank 0 writes."""
        del wait
        saved = _to_saved(payload)
        written = is_main_process() and self._write(step, saved)
        if dist.is_initialized():
            dist.barrier()
        return written

    def _write(self, step: int, saved: Any) -> bool:
        latest = self.latest_step()
        if latest is not None and step <= latest:
            return False
        os.makedirs(self.directory, exist_ok=True)
        final = os.path.join(self.directory, str(step))
        tmp = os.path.join(self.directory, f".{step}.tmp-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(saved, os.path.join(tmp, FILE_NAME))
        os.rename(tmp, final)
        for old in self._steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))
        return True

    def restore(self, payload_like: Any, step: Optional[int] = None) -> Any:
        """`payload_like` filled from `step` (the latest by default), or
        None when there is no checkpoint. Raises KeyError when the
        checkpoint lacks a key of `payload_like`."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        saved = torch.load(os.path.join(self.directory, str(step), FILE_NAME),
                           map_location="cpu", weights_only=True)
        return _fill(payload_like, saved, "")

    def close(self) -> None:
        """Nothing to wait for: every save is on disk when it returns (JAX's
        manager finishes its asynchronous saves here)."""
