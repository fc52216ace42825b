"""Held-out self-reenactment PSNR and best-snapshot early stopping
(counterpart of ``megaportraits_tpu/eval/heldout.py``).

The drivers reserve the last frames of every clip, score PSNR on them every
``eval_interval`` steps and export the best-scoring snapshot: at small data
scale the stage-1 GAN keeps lowering its training loss while held-out
quality falls. ``train/main_base.py`` uses ``HeldoutEvaluator.for_gbase``,
``train/main_hr.py`` ``HeldoutEvaluator.for_genh``.

Where the port differs from JAX, and why:
  * JAX snapshots immutable arrays. The port's models are updated in place,
    so a snapshot is a cloned host copy of the model's ``state_dict``;
    otherwise the "best" export would silently be the final weights.
  * JAX throws away the BatchNorm statistics a scoring forward mutates. The
    port scores with the model in ``.eval()`` (``train=True`` where JAX
    scores with batch statistics, so that nothing is recorded) under
    ``torch.no_grad()``, and puts the model back in its mode afterwards.
  * The tail batch is padded by repeating its last row, as in JAX. The port
    has no jitted shape to keep, but with batch statistics the padded rows
    take part in the normalisation, and with it in the score.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from megaportraits_tpu_torch.data.dataset import area_downsample
from megaportraits_tpu_torch.ops.resize import linear_resize


class HeldoutEvaluator:
    """Score held-out PSNR with a model forward; track the best snapshot.

    The core takes ``fwd(model, src, drv) -> pred`` (tensors on the model's
    device, pred in [0, 1]) and aligned host arrays (src, drv, tgt); the
    ``for_*`` constructors build the stage-specific forwards. A state is a
    ``TrainState``: its ``model`` is scored."""

    def __init__(
        self,
        fwd: Callable,
        src: np.ndarray,
        drv: np.ndarray,
        tgt: np.ndarray,
        batch_size: int,
        burn_in: int = 0,
    ):
        self._fwd = fwd
        self.src, self.drv, self.tgt = src, drv, tgt
        self.n_pairs = int(src.shape[0]) if src.ndim > 1 else 0
        self.batch_size = batch_size
        # Evaluations before `burn_in` steps are scored but never
        # snapshotted: an early noise spike would otherwise pin "best" to an
        # undertrained model for the rest of the run.
        self.burn_in = burn_in
        self.best_psnr: float = float("-inf")
        self.best_step: int = 0
        self.best_variables: Optional[Dict[str, torch.Tensor]] = None

    # -- stage-specific constructors ------------------------------------

    @staticmethod
    def _tail_pairs(
        clips: Dict[str, np.ndarray], holdout: int
    ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """(first training frame, reserved tail frame) per clip."""
        pairs: List[Tuple[np.ndarray, np.ndarray]] = []
        for frames in clips.values():
            if len(frames) <= holdout:
                continue
            for t in range(holdout):
                pairs.append((frames[0], frames[len(frames) - holdout + t]))
        return pairs

    @classmethod
    def for_gbase(cls, gbase: nn.Module, clips: Dict[str, np.ndarray], holdout: int,
                  batch_size: int, burn_in: int = 0,
                  bn_mode: str = "batch") -> "HeldoutEvaluator":
        """Stage-1 self-reenactment: source = the clip's first training
        frame, driving (and target) = each reserved tail frame.

        bn_mode 'batch' scores with per-batch BatchNorm statistics (the
        GAN-generator convention: at small batch and data scale the
        running-statistics output is a washed blob); 'running' scores the
        serving forward (running statistics), the right choice for
        norm='group' models. `gbase` names the model the forward applies;
        the scored weights are those of the state given to ``psnr``."""
        del gbase  # the scored model is the state's
        pairs = cls._tail_pairs(clips, holdout)
        if pairs:
            src = np.stack([p[0] for p in pairs])
            drv = np.stack([p[1] for p in pairs])
        else:
            src = drv = np.zeros((0,))
        train = bn_mode != "running"

        def fwd(model, a, b):
            return model.generate(a, b, train=train)

        return cls(fwd, src, drv, drv, batch_size, burn_in=burn_in)

    @classmethod
    def for_genh(cls, genh: nn.Module, gbase: nn.Module,
                 clips_hr: Dict[str, np.ndarray], holdout: int,
                 batch_size: int, base_size: int,
                 upscale: int = 2) -> "HeldoutEvaluator":
        """Stage-2 super-resolution self-reenactment, composed as the HR
        step is (``train/train_hr.py``): the frozen Gbase in eval mode at
        base resolution (its trunk on K2 in bf16 on the card, once a row),
        bilinear x`upscale` with ``align_corners=False``, Genh
        with batch statistics; scored against the native-resolution tail
        frame. The inputs are the box-mean downsamples of the tail pairs."""
        del genh  # the scored model is the state's
        pairs = cls._tail_pairs(clips_hr, holdout)
        if pairs:
            tgt = np.stack([p[1] for p in pairs])
            src = area_downsample(np.stack([p[0] for p in pairs]), (base_size, base_size))
            drv = area_downsample(tgt, (base_size, base_size))
        else:
            src = drv = tgt = np.zeros((0,))

        def fwd(model, a, b):
            gbase_mode = gbase.training
            gbase.eval()
            try:
                xhat = gbase.generate(a, b)
            finally:
                gbase.train(gbase_mode)
            if upscale != 1:
                hr = [s * upscale for s in xhat.shape[1:3]]
                xhat = linear_resize(xhat, hr, axes=(1, 2), align_corners=False)
            # Genh outputs tanh [-1, 1]; targets are [0, 1].
            return (model(xhat, train=True).float() + 1.0) * 0.5

        return cls(fwd, src, drv, tgt, batch_size)

    # -- scoring / tracking ---------------------------------------------

    @staticmethod
    def variables_of(g_state) -> Dict[str, torch.Tensor]:
        """A host copy of the state's model weights and statistics, which
        later steps do not touch."""
        return {k: v.detach().to("cpu", copy=True)
                for k, v in g_state.model.state_dict().items()}

    @torch.no_grad()
    def psnr(self, g_state) -> float:
        """Mean held-out PSNR (dB); -inf with no pairs."""
        if not self.n_pairs:
            return float("-inf")
        model = g_state.model
        dev = next(model.parameters()).device
        bs = self.batch_size
        psnrs: List[float] = []
        mode = model.training
        model.eval()
        try:
            for s0 in range(0, self.n_pairs, bs):
                src, drv = self.src[s0:s0 + bs], self.drv[s0:s0 + bs]
                tgt = self.tgt[s0:s0 + bs]
                n_valid = src.shape[0]
                if n_valid < bs:
                    # Pad the tail by repetition, as JAX does; only the
                    # valid rows are scored.
                    pad = [(0, bs - n_valid)] + [(0, 0)] * (src.ndim - 1)
                    src = np.pad(src, pad, mode="edge")
                    drv = np.pad(drv, pad, mode="edge")
                pred = self._fwd(model, torch.from_numpy(src).to(dev),
                                 torch.from_numpy(drv).to(dev))
                pred = pred.float().cpu().numpy()
                mse = np.mean(
                    (pred[:n_valid] - tgt[:n_valid].astype(np.float32)) ** 2,
                    axis=tuple(range(1, pred.ndim)),
                )
                psnrs.extend(10.0 * np.log10(1.0 / np.maximum(mse, 1e-10)))
        finally:
            model.train(mode)
        return float(np.mean(psnrs))

    def consider(self, g_state, step: int) -> Tuple[float, bool]:
        """Evaluate; snapshot the weights when the score improves."""
        score = self.psnr(g_state)
        improved = score > self.best_psnr and step >= self.burn_in
        if improved:
            self.best_psnr, self.best_step = score, step
            self.best_variables = self.variables_of(g_state)
        return score, improved

    def export_variables(self, g_state) -> Tuple[Dict[str, torch.Tensor], int, bool]:
        """(weights, step, is_best): the best snapshot when one exists,
        else the current state's (the caller supplies the fallback step).
        The weights are a ``state_dict``: ``CheckpointManager`` saves them,
        and restores them into a model of the same shape."""
        if self.best_variables is not None:
            return self.best_variables, self.best_step, True
        return self.variables_of(g_state), -1, False
