"""Head-pose dataset loaders for training or fine-tuning the SixDRepNet pose
estimator (counterpart of ``megaportraits_tpu/data/pose_datasets.py``).

Host-side numpy pipelines of (image [H, W, 3] float in [0, 1], rotation
matrix [3, 3], (pitch, yaw, roll) degrees):
  * 300W-LP / AFLW2000: the pose from each image's ``.mat`` 'Pose_Para'
    (pitch, yaw, roll in radians), its matrix from the port's
    ``ops/affine_grid.rotation_matrix_from_euler_deg``;
  * BIWI: the rotation matrix read from each frame's ``_pose.txt``.
Nothing downloads. scipy is imported where a file is read; images are read
and resized without PIL (``utils/image.py``: PNG or baseline JPEG, PIL's
bilinear resize), which the machine with the card lacks.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from megaportraits_tpu_torch.ops.affine_grid import rotation_matrix_from_euler_deg
from megaportraits_tpu_torch.utils.image import pil_bilinear_resize, read_image


def _load_image(path: str, size: Optional[Tuple[int, int]] = None) -> np.ndarray:
    img = read_image(path)
    if size:
        img = pil_bilinear_resize(img, size)
    return img.astype(np.float32) / 255.0


def _euler_to_matrix_deg(pitch: float, yaw: float, roll: float) -> np.ndarray:
    angles = torch.tensor([[pitch, yaw, roll]], dtype=torch.float32)
    return rotation_matrix_from_euler_deg(angles)[0].numpy()


class Pose300WLP:
    """300W-LP style: an image and a ``.mat`` with 'Pose_Para' per name."""

    def __init__(self, data_dir: str, filename_list: Optional[List[str]] = None,
                 img_size: int = 224, img_ext: str = ".jpg"):
        self.data_dir = data_dir
        self.img_size = img_size
        self.img_ext = img_ext
        if filename_list is None:
            filename_list = sorted(os.path.splitext(f)[0] for f in os.listdir(data_dir)
                                   if f.endswith(".mat"))
        self.files = filename_list

    def __len__(self):
        return len(self.files)

    def __getitem__(self, index: int):
        from scipy.io import loadmat

        name = self.files[index]
        mat = loadmat(os.path.join(self.data_dir, name + ".mat"))
        pose = mat["Pose_Para"][0][:3]  # pitch, yaw, roll in radians
        pitch, yaw, roll = [float(a) * 180.0 / np.pi for a in pose]
        img = _load_image(os.path.join(self.data_dir, name + self.img_ext),
                          (self.img_size, self.img_size))
        return img, _euler_to_matrix_deg(pitch, yaw, roll), (pitch, yaw, roll)


class AFLW2000(Pose300WLP):
    """AFLW2000-3D: the 300W-LP schema."""


class BIWI:
    """BIWI kinect head pose: frame_XXXXX_rgb.png + frame_XXXXX_pose.txt
    (the rotation's 9 values, then the translation)."""

    def __init__(self, data_dir: str, img_size: int = 224):
        self.data_dir = data_dir
        self.img_size = img_size
        self.samples: List[Tuple[str, str]] = []
        for root, _, files in os.walk(data_dir):
            for f in sorted(files):
                if f.endswith("_pose.txt"):
                    img = os.path.join(root, f.replace("_pose.txt", "_rgb.png"))
                    if os.path.exists(img):
                        self.samples.append((img, os.path.join(root, f)))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, index: int):
        img_path, pose_path = self.samples[index]
        with open(pose_path) as f:
            vals = [float(v) for v in f.read().split()]
        rot = np.array(vals[:9], dtype=np.float32).reshape(3, 3)
        img = _load_image(img_path, (self.img_size, self.img_size))
        # Euler degrees from R, in the detector's convention.
        sy = np.sqrt(rot[0, 0] ** 2 + rot[1, 0] ** 2)
        pitch = np.degrees(np.arctan2(rot[2, 1], rot[2, 2]))
        yaw = np.degrees(np.arctan2(-rot[2, 0], sy))
        roll = np.degrees(np.arctan2(rot[1, 0], rot[0, 0]))
        return img, rot, (pitch, yaw, roll)


def pose_batches(dataset, batch_size: int, seed: int = 0) -> Iterator[dict]:
    """Endless batches {'image': [B, H, W, 3], 'rotation': [B, 3, 3]} of
    items drawn uniformly with numpy from `seed`."""
    rng = np.random.default_rng(seed)
    n = len(dataset)
    while True:
        idx = rng.integers(n, size=batch_size)
        imgs, rots = [], []
        for i in idx:
            img, rot, _ = dataset[int(i)]
            imgs.append(img)
            rots.append(rot)
        yield {"image": np.stack(imgs), "rotation": np.stack(rots)}
