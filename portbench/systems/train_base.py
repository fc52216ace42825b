"""The stage-1 training step (Gbase against the PatchGAN discriminator,
with the VGG19 and LPIPS perceptual losses frozen), as a trainer runs it.

``Program`` is the port's step from ``train/train_base.make_train_step``
with ``pool_index``: the batches stay on the card and the step takes the
index of its batch. ``Reference`` is the plain float32 step of
``portbench/reference/train_base.py`` on the same weights, drawn again
from the seed. Both offer ``step(pool, i)`` (the losses of the step),
``params()`` and ``param_names()`` (the trained parameters of G and D, in
order, and their names) and
``optimizers()`` (their ``torch.optim.AdamW``), so that the same code reads
both.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from portbench.spec import arch_fields

WEIGHT_TAGS = {"gbase": "weights.gbase", "disc": "weights.disc", "ploss": "weights.ploss"}


class Program:
    def __init__(self, config: Dict, seed: int, device, arch: Optional[Dict] = None):
        from megaportraits_tpu_torch.core.arch import Arch
        from megaportraits_tpu_torch.core.config import Config, TrainingConfig
        from megaportraits_tpu_torch.core.dtypes import DEFAULT_POLICY, FP32_POLICY
        from megaportraits_tpu_torch.losses.perceptual import DEFAULT_WEIGHTS, PerceptualLoss
        from megaportraits_tpu_torch.models.discriminator import Discriminator
        from megaportraits_tpu_torch.models.gbase import Gbase
        from megaportraits_tpu_torch.train.state import TrainState, make_optimizer
        from megaportraits_tpu_torch.train.train_base import make_train_step

        from portbench.seeded import load_drawn

        a = Arch(**arch_fields(config, arch))
        # bf16 as configured on the card; float32 in the CPU tests.
        bf16 = config["use_bf16"] and torch.device(device).type == "cuda"
        policy = DEFAULT_POLICY if bf16 else FP32_POLICY
        t = config["training"]
        cfg = Config(training=TrainingConfig(**t))
        gbase = load_drawn(Gbase(policy=policy, arch=a, device=device,
                                 remat=config["remat"]), seed, WEIGHT_TAGS["gbase"])
        disc = load_drawn(Discriminator(policy=policy, arch=a, device=device),
                          seed, WEIGHT_TAGS["disc"])
        ploss = load_drawn(PerceptualLoss(DEFAULT_WEIGHTS, policy=policy, arch=a,
                                          device=device), seed, WEIGHT_TAGS["ploss"])
        self.ploss = ploss.requires_grad_(False).eval()
        total = t["base_epochs"] * (t.get("steps_per_epoch") or 1)
        self.g = TrainState(gbase, make_optimizer(gbase, t["lr"], total))
        self.d = TrainState(disc, make_optimizer(disc, t["lr"], total))
        self._step = make_train_step(self.ploss, cfg, pool_index=True)

    def step(self, pool: Dict[str, torch.Tensor], i: int) -> Dict[str, torch.Tensor]:
        self.g, self.d, metrics, _ = self._step(self.g, self.d, pool, i)
        return {"loss_G": metrics["loss_G"], "loss_D": metrics["loss_D"]}

    def params(self) -> Dict[str, List[torch.nn.Parameter]]:
        return {"G": self.g.params, "D": self.d.params}

    def param_names(self) -> Dict[str, List[str]]:
        from megaportraits_tpu_torch.train.state import trainable_parameters

        return {k: [n for n, _ in trainable_parameters(s.model)]
                for k, s in (("G", self.g), ("D", self.d))}

    def optimizers(self) -> Dict[str, torch.optim.Optimizer]:
        return {"G": self.g.tx.adamw, "D": self.d.tx.adamw}

    def layers(self) -> Dict[str, torch.nn.Module]:
        return {"perceptual": self.ploss}

    def trunk_owner(self):
        return None


class Reference:
    def __init__(self, config: Dict, seed: int, device, arch: Optional[Dict] = None,
                 policy=None):
        from portbench.reference.arch import Arch
        from portbench.reference.discriminator import Discriminator
        from portbench.reference.dtypes import DEFAULT_POLICY
        from portbench.reference.gbase import Gbase
        from portbench.reference.perceptual import DEFAULT_WEIGHTS, PerceptualLoss
        from portbench.reference.train_base import Trainer
        from portbench.seeded import load_drawn

        a = Arch(**arch_fields(config, arch))
        policy = policy or DEFAULT_POLICY
        gbase = load_drawn(Gbase(policy=policy, arch=a, device=device,
                                 remat=config["reference_remat"]), seed, WEIGHT_TAGS["gbase"])
        disc = load_drawn(Discriminator(policy=policy, arch=a, device=device),
                          seed, WEIGHT_TAGS["disc"])
        ploss = load_drawn(PerceptualLoss(DEFAULT_WEIGHTS, policy=policy, arch=a,
                                          device=device), seed, WEIGHT_TAGS["ploss"])
        self.trainer = Trainer(gbase, disc, ploss.requires_grad_(False).eval(),
                               config["training"])

    def step(self, pool: Dict[str, torch.Tensor], i: int) -> Dict[str, torch.Tensor]:
        return self.trainer.step({k: v[i] for k, v in pool.items()})

    def params(self) -> Dict[str, List[torch.nn.Parameter]]:
        return {"G": self.trainer.g_params, "D": self.trainer.d_params}

    def param_names(self) -> Dict[str, List[str]]:
        from portbench.reference.train_base import trainable_names

        return {"G": trainable_names(self.trainer.gbase),
                "D": trainable_names(self.trainer.disc)}

    def optimizers(self) -> Dict[str, torch.optim.Optimizer]:
        return {"G": self.trainer.g_opt[0], "D": self.trainer.d_opt[0]}

    def layers(self) -> Dict[str, torch.nn.Module]:
        return {"perceptual": self.trainer.ploss}

    def trunk_owner(self):
        return None


def control_policy():
    from portbench.reference.dtypes import FP8_CONTROL

    return FP8_CONTROL
