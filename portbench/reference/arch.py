"""Architecture scale presets (a copy of ``megaportraits_tpu/core/arch.py``).

``FULL`` is the reference architecture. ``TINY`` divides channel widths by 8
(floored at 32 and rounded up to a multiple of 32, since every GroupNorm in
the block zoo uses 32 groups) and trims depths; the tests run at ``TINY``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Arch:
    name: str = "full"
    # Global channel divisor; ch() floors at 32 and rounds up to a multiple
    # of 32 (GroupNorm(32) compatibility).
    width_div: int = 1
    # Volumetric representation: 1536 channels split into C96 x D16.
    volume_channels: int = 96
    volume_depth: int = 16
    # Appearance/expression descriptor width.
    compress_dim: int = 512
    # Rotation/translation warp grid.
    grid_size: int = 64
    # Depths.
    eapp_rounds3d: int = 3
    resnet18_layers: Tuple[int, ...] = (2, 2, 2, 2)
    resnet50_layers: Tuple[int, ...] = (3, 4, 6, 3)
    repvgg_blocks: Optional[Tuple[int, ...]] = None  # None = per-config
    g2d_blocks: int = 8
    g3d_stages: int = 3
    vgg_stages: int = 0
    disc_stages: int = 4
    # Norm of the ResBlock2D family: 'batch' (reference) or 'group'.
    norm: str = "batch"

    def ch(self, c: int) -> int:
        """Scale a reference channel count."""
        if self.width_div <= 1:
            return c
        scaled = -(-c // self.width_div)       # ceil div
        return max(32, -(-scaled // 32) * 32)  # round up to multiple of 32


FULL = Arch()

TINY = Arch(
    name="tiny",
    width_div=8,
    volume_channels=32,
    volume_depth=4,
    compress_dim=64,
    grid_size=16,
    eapp_rounds3d=1,
    resnet18_layers=(1, 1, 1, 1),
    resnet50_layers=(1, 1, 1, 1),
    repvgg_blocks=(1, 1, 1, 1),
    g2d_blocks=2,
    g3d_stages=1,
    vgg_stages=2,
    disc_stages=2,
)
