"""Configuration: the reference's YAML schema as dataclasses (a copy of
``megaportraits_tpu/core/config.py``).

The same keys and defaults as the JAX package, so one YAML file configures
either package. ``load_config`` imports PyYAML only when it is called, so
a ``Config()`` built in code needs no YAML package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Union

import torch

from megaportraits_tpu_torch.core.device import DEFAULT_DEVICE


@dataclasses.dataclass
class DataConfig:
    train_width: int = 512
    train_height: int = 512
    sample_rate: int = 25
    n_sample_frames: int = 1
    n_motion_frames: int = 2


@dataclasses.dataclass
class TrainingConfig:
    # Mirrors reference configs/training/stage1-base.yaml:7-41.
    frame_offset: int = 20
    checkpoint_path: str = "./checkpoints"
    save_interval: int = 50
    log_interval: int = 100
    batch_size: int = 4
    num_workers: int = 0
    lr: float = 1.0e-5
    base_epochs: int = 100
    hr_epochs: int = 50
    student_epochs: int = 100
    use_gpu_video_tensor: bool = True
    prev_frames: int = 2
    video_dir: str = "./junk"
    sample_rate: int = 25
    n_sample_frames: int = 100
    json_file: str = "./data/overfit.json"
    # Loss weights (stage1-base.yaml:34-41).
    w_per: float = 20.0
    w_adv: float = 1.0
    w_fm: float = 40.0
    w_cos: float = 2.0
    w_pairwise: float = 1.0
    w_identity: float = 1.0
    w_cyc: float = 1.0
    # lambda_* family kept for schema compatibility.
    lambda_perceptual: float = 1.0
    lambda_adversarial: float = 1.0
    lambda_cosine: float = 1.0
    lambda_keypoints: float = 1.0
    lambda_gaze: float = 1.0
    lambda_supervised: float = 1.0
    lambda_unsupervised: float = 1.0
    # Mask prediction and target with the host-computed foreground mask
    # before the perceptual terms; batches then carry 'foreground_mask'.
    use_foreground_mask: bool = False
    # Opt-in gaze term: batches carry host-rasterised eye-region masks
    # 'gaze_masks' [B, H, W, 2]; the step adds lambda_gaze * mp_gaze_loss.
    use_gaze_loss: bool = False
    pretrained_path: str = "./pretrained"
    seed: int = 0
    use_bf16: bool = True
    eval_interval: int = 0
    holdout_frames: int = 4
    unroll_steps: int = 1
    mesh_shape: Optional[Dict[str, int]] = None
    steps_per_epoch: Optional[int] = None
    num_avatars: int = 4


@dataclasses.dataclass
class ModelConfig:
    """Model knobs. The serving defaults (224px rotation input, 256px
    descriptor input, bf16) change activations against the reference;
    ``parity()`` gives the full-resolution float32 preset."""

    # Emtn input resolutions; 0 = feed full resolution (parity mode).
    rotation_input_size: int = 224
    descriptor_input_size: int = 256
    # Width/depth preset (core/arch.py): 'full' or 'tiny'.
    arch: str = "full"
    # 'reference' replicates the reference warp renormalisation quirk;
    # 'standard' is textbook grid+flow.
    warp_normalize_mode: str = "reference"
    use_bf16: bool = True
    # Norm of the ResBlock2D family: 'batch' (reference) or 'group'.
    norm: str = "batch"

    def parity(self) -> "ModelConfig":
        return dataclasses.replace(
            self, rotation_input_size=0, descriptor_input_size=0,
            warp_normalize_mode="reference", use_bf16=False, norm="batch",
        )


@dataclasses.dataclass
class InferenceConfig:
    checkpoint_path: str = ""
    source_image: str = ""
    driving_image: str = ""
    output_image: str = "output_base.jpg"
    # Images are [0, 1] end to end; set only to reproduce the reference's
    # [-1, 1] inference input transform.
    reference_normalize: bool = False
    # BatchNorm statistics at inference: 'running' or 'batch'.
    bn_mode: str = "running"


@dataclasses.dataclass
class Config:
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    training: TrainingConfig = dataclasses.field(default_factory=TrainingConfig)
    inference: InferenceConfig = dataclasses.field(default_factory=InferenceConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)

    def make_gbase(self, policy=None, device: Union[str, torch.device] = DEFAULT_DEVICE,
                   seed: int = 0, remat: str = "none"):
        """Gbase from the model section with seeded random weights on
        `device` (the card by default; raises if there is none and the
        caller did not ask for the CPU) and the `remat` mode ('none',
        'selective', 'full': ``models/gbase.py``)."""
        from megaportraits_tpu_torch.core.dtypes import DEFAULT_POLICY, FP32_POLICY
        from megaportraits_tpu_torch.models.gbase import build_gbase

        if policy is None:
            policy = DEFAULT_POLICY if self.model.use_bf16 else FP32_POLICY
        return build_gbase(
            self.make_arch(), policy=policy, device=device, seed=seed,
            warp_normalize_mode=self.model.warp_normalize_mode,
            rotation_input_size=self.model.rotation_input_size,
            descriptor_input_size=self.model.descriptor_input_size,
            remat=remat,
        )

    def make_arch(self):
        """Arch preset with the config's norm decision applied."""
        from megaportraits_tpu_torch.core.arch import get_arch

        return dataclasses.replace(get_arch(self.model.arch), norm=self.model.norm)


def _filter_fields(cls, d: Dict[str, Any]) -> Dict[str, Any]:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


def load_config(path: str) -> Config:
    """Load a reference-schema YAML file into a validated Config."""
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    cfg = Config()
    if raw.get("data"):
        cfg.data = DataConfig(**_filter_fields(DataConfig, raw["data"]))
    if raw.get("training"):
        cfg.training = TrainingConfig(**_filter_fields(TrainingConfig, raw["training"]))
    if raw.get("inference"):
        cfg.inference = InferenceConfig(
            **_filter_fields(InferenceConfig, raw["inference"]))
    if raw.get("model"):
        cfg.model = ModelConfig(**_filter_fields(ModelConfig, raw["model"]))
    return cfg
