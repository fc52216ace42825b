"""Operations and bytes of the stage-3 Student, counted from shapes.

``student_flops_per_frame``: the plain reference's forward under
``torch.utils.flop_counter`` on the meta device (no memory, no arithmetic),
two operations a multiply-add, as ``flops/model.py`` counts a drive.

``bn_act_bytes_per_step``: what kernel K4 must move in one served step of
`batch` frames, one launch for each eval BatchNorm epilogue of the encoder
(the stem's and each ResBlockBN's two ``relu(BN(conv))``: 23): the conv's
bf16 output read once and the bf16 result written once, and the three
float32 ``[C]`` operands read once a launch.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode


def _meta_student(config: Dict):
    from portbench.reference.student import Student

    with torch.device("meta"):
        return Student(config["num_avatars"], width_div=config["arch"]["width_div"]).eval()


def student_flops_per_frame(config: Dict) -> float:
    s = config["image_size"]
    model = _meta_student(config)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(torch.empty(1, s, s, 3, device="meta"),
              torch.zeros(1, dtype=torch.long, device="meta"))
    return float(counter.get_total_flops())


def epilogue_shapes(config: Dict) -> List[Tuple[int, ...]]:
    """The [1, H, W, C] shape of each K4 epilogue of one frame's forward:
    the stem's BatchNorm and each ResBlockBN's ``bn1`` and ``bn2``."""
    from portbench.reference.student import ResBlockBN

    s = config["image_size"]
    model = _meta_student(config)
    norms = [model.stem_bn] + [bn for m in model.modules() if isinstance(m, ResBlockBN)
                               for bn in (m.bn1, m.bn2)]
    shapes: List[Tuple[int, ...]] = []
    handles = [bn.register_forward_hook(lambda _m, _a, out: shapes.append(tuple(out.shape)))
               for bn in norms]
    with torch.no_grad():
        model.encode(torch.empty(1, s, s, 3, device="meta"))
    for h in handles:
        h.remove()
    return shapes


def bn_act_bytes_per_step(config: Dict, batch: int) -> float:
    act = 2 if config["use_bf16"] else 4
    total = 0
    for shape in epilogue_shapes(config):
        elems = batch * shape[1] * shape[2] * shape[3]
        total += 2 * elems * act + 3 * shape[3] * 4
    return float(total)
