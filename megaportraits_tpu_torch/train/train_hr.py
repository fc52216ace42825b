"""Stage-2 training: the high-resolution enhancer Genh behind a frozen
Gbase (counterpart of ``megaportraits_tpu/train/train_hr.py``).

One step does what the JAX step does:
  * the frozen Gbase makes the base image in eval mode (running BatchNorm
    statistics) under ``torch.no_grad()``, JAX's ``stop_gradient``. There
    the G2d trunk may run on kernel K2 (``G2d.use_chain_kernel``), which has
    no backward and needs none;
  * the base image is pre-upscaled x`upscale` bilinearly with
    ``align_corners=False`` (Genh's own upsamples use True);
  * Genh (in ``.train()``) enhances it with batch statistics and records
    them; a second, cycle pass Genh(Genh(x)) normalises with batch
    statistics too but records nothing, as JAX keeps only the first pass's
    statistics: the port runs it with Genh in ``.eval()`` and
    ``train=True``;
  * the loss is w_sup x L1(pred01, target) + w_unsup x L1(cycle01, base) +
    w_per x the VGG19-only perceptual loss(pred01, target), where Genh's
    tanh output is compared in [0, 1]: pred01 = (xhat_hr + 1) / 2;
  * AdamW on a cosine schedule over ``hr_epochs * steps_per_epoch`` steps.
With a mesh (``parallel/mesh.py``) each rank's batch is its rows of the
global batch: Genh is distributed from rank 0 with its BatchNorms
normalising over the data group (both passes), its optimiser averages the
gradients, and the metrics are the mean over the ranks.
Not ported: ``donate`` and the frozen variables threaded as jit arguments,
which serve XLA's buffers and the TPU compile service.
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

import torch

from megaportraits_tpu_torch.core.config import Config
from megaportraits_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device
from megaportraits_tpu_torch.core.dtypes import DEFAULT_POLICY, Policy
from megaportraits_tpu_torch.losses.perceptual import PerceptualLoss, build_perceptual_loss
from megaportraits_tpu_torch.models.gbase import Gbase
from megaportraits_tpu_torch.models.genh import Genh, build_genh
from megaportraits_tpu_torch.ops.resize import linear_resize
from megaportraits_tpu_torch.parallel.mesh import distribute, mean_over_ranks
from megaportraits_tpu_torch.train.state import TrainState, make_optimizer

HR_LOSS_WEIGHTS = {"vgg19": 1.0, "vggface": 0.0, "gaze": 0.0, "lpips": 0.0}


def init_hr_state(cfg: Config, seed: int = 0, policy: Policy = DEFAULT_POLICY,
                  image_size: int = 512, upscale: int = 2,
                  device: Union[str, torch.device] = DEFAULT_DEVICE, mesh=None
                  ) -> Tuple[Genh, PerceptualLoss, TrainState]:
    """Genh, the frozen VGG19-only perceptual loss (seeded random weights on
    `device`, the card by default) and Genh's state with its optimiser
    (``cfg.training.lr`` over ``hr_epochs * steps_per_epoch`` steps). Genh
    runs at ``image_size * upscale``, which must be a multiple of 8. With a
    `mesh`, Genh is distributed over it and its optimiser makes its
    collectives."""
    if (image_size * upscale) % 8:
        raise ValueError(f"Genh needs a size divisible by 8, got "
                         f"{image_size} x {upscale}")
    dev = resolve_device(device)
    arch = cfg.make_arch()
    genh = build_genh(arch, policy=policy, device=dev, seed=seed)
    ploss = build_perceptual_loss(arch, policy=policy, device=dev, seed=seed + 1,
                                  weights=HR_LOSS_WEIGHTS)
    distribute(genh, mesh)
    steps = (cfg.training.steps_per_epoch or 1) * cfg.training.hr_epochs
    return genh, ploss, TrainState(genh, make_optimizer(genh, cfg.training.lr, steps,
                                                        mesh=mesh))


def make_hr_train_step(genh: Genh, gbase: Gbase, ploss: PerceptualLoss, cfg: Config,
                       upscale: int = 2, w_sup: float = 1.0, w_unsup: float = 1.0,
                       w_per: float = 1.0, mesh=None):
    """The stage-2 step ``(state, batch) -> (state, metrics)``. `batch`
    holds 'source' and 'driving' [B, H, W, 3] and 'target_hr' [B, H *
    upscale, W * upscale, 3], images in [0, 1]. `state` is Genh's (from
    ``init_hr_state``), updated in place and returned; the metrics
    'loss_hr', 'loss_sup', 'loss_unsup' and 'loss_per' are detached
    float32 scalars (the mean over the ranks of `mesh`). Gbase and the
    loss nets stay as they are."""
    del cfg  # the JAX step takes it too and reads nothing of it

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        target_hr = batch["target_hr"]
        gbase.eval()
        with torch.no_grad():
            xhat_base = gbase.generate(batch["source"], batch["driving"])
            if upscale != 1:
                hr_size = [s * upscale for s in xhat_base.shape[1:3]]
                xhat_base = linear_resize(xhat_base, hr_size, axes=(1, 2),
                                          align_corners=False)

        genh.train()
        xhat_hr = genh(xhat_base, train=True)
        genh.eval()  # the cycle pass: batch statistics, none recorded
        x_cycle = genh(xhat_hr, train=True)

        pred01 = (xhat_hr.float() + 1.0) * 0.5
        loss_sup = torch.mean(torch.abs(pred01 - target_hr.float()))
        cycle01 = (x_cycle.float() + 1.0) * 0.5
        loss_unsup = torch.mean(torch.abs(cycle01 - xhat_base.float()))
        loss_per = ploss(pred01, target_hr)
        total = w_sup * loss_sup + w_unsup * loss_unsup + w_per * loss_per
        state.apply_gradients(torch.autograd.grad(total, state.params, allow_unused=True))
        metrics = {"loss_hr": total, "loss_sup": loss_sup, "loss_unsup": loss_unsup,
                   "loss_per": loss_per}
        return state, mean_over_ranks({k: v.detach() for k, v in metrics.items()}, mesh)

    return step
