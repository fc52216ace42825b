"""The stage-3 Student served per avatar: lockstep streams, one batch holds
one frame of every stream, each row rendered under its stream's avatar.

``Program`` is the port's ``StudentSession`` over a Student of the
configuration's ``num_avatars``: ``encode`` sets each stream's avatar once
(stream i serves avatar i mod ``num_avatars``; the sources are not used),
then one ``__call__`` a step. ``Reference`` is the plain float32 Student of
``portbench/reference/student.py`` with the same weights, drawn again from
the seed, run in blocks of rows. ``Reference(policy=FP8_CONTROL)`` put in
the program's place is the control of the correctness check.

Weights are drawn from the seed (``seeded.py``). Every BatchNorm's running
statistics (they all lie in the encoder) are then set from a float32
train-mode pass of the reference's encoder over images drawn from the seed
(``student_statistics``), each side its own. With drawn statistics each
layer shrinks its input, so that the Student's output hardly follows the
driving frame: on the card two frames' encoder outputs differed by 3.9
times the bf16 program's largest own gap over ten seeds, set statistics
part them by 6.6 times over 26; the frames' and the decoder's checks part
the program from the control by 1.9 and 2.7 times drawn, 1.6 and 1.8 set.

Both sides keep what each step's call computed (``seen``), one row a
stream: ``encoder``, the encoder's output (24 channels at /8), which
follows the driving frame; ``decoder``, the decoder's output (192 channels
at /4) averaged over the map, channel by channel, which follows the frame
and the row's avatar (its single bf16 values are ill-conditioned against
float32 at random weights on smooth frames, so that the rows differ by
about their own norm; their means part the program from the control by
1.8 times, on the card); ``avatar``, every avatar embedding the row took, the
three of each of the 15 SPADEs one after another. Forward hooks record
them on every call; the window keeps them for the steps it checks.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from portbench.spec import arch_fields
from portbench.systems import serve
from portbench.systems.serve import load_statistics

WEIGHT_TAG = "weights.student"
CALIBRATION_IMAGES = 16
SEEN = ("encoder", "decoder", "avatar")


def avatars_for(streams: int, num_avatars: int, device) -> torch.Tensor:
    """Stream i's avatar, i mod `num_avatars`, made on the device."""
    return torch.arange(streams, device=device) % num_avatars


def _width_div(config: Dict, arch: Optional[Dict]) -> int:
    return int(arch_fields(config, arch).get("width_div", 1))


@torch.no_grad()
def student_statistics(config: Dict, seed: int, device, arch: Optional[Dict] = None,
                       image_size: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Every BatchNorm's running statistics: the batch statistics of a
    float32 train-mode pass of the reference's encoder, with the seed's
    weights, over ``CALIBRATION_IMAGES`` smooth images drawn from the seed."""
    from portbench.reference.layers import BatchNorm
    from portbench.reference.student import Student
    from portbench.seeded import generator, load_drawn, smooth_images

    ref = load_drawn(Student(config["num_avatars"], width_div=_width_div(config, arch),
                             device=device), seed, WEIGHT_TAG)
    images = smooth_images(generator(device, seed, "calibration"), CALIBRATION_IMAGES,
                           image_size or config["image_size"], device)
    for m in ref.modules():
        if isinstance(m, BatchNorm):
            m.momentum = 1.0  # the running statistics become this batch's
    ref.train()
    ref.encode(images, True)
    return {k: v.clone() for k, v in ref.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


class _Seen(serve._Seen):
    """Forward hooks on a Student that keep, for each call, the last
    encoder block's output, the last decoder block's output and the avatar
    embeddings of every lookup, as they were computed; ``seen`` reduces
    them (the decoder's channel means, the lookups side by side), so that
    a step the window does not check launches nothing more."""

    def _watch(self, student) -> None:
        self._seen: Dict[str, List] = {k: [] for k in SEEN}
        lookups: List[torch.Tensor] = []

        def record(key):
            return lambda _m, _a, out: self._seen[key].append(out)

        getattr(student, student.enc_names[-1]).register_forward_hook(record("encoder"))
        getattr(student, student.dec_names[-1]).register_forward_hook(record("decoder"))
        for m in student.modules():
            if isinstance(m, torch.nn.Embedding):
                m.register_forward_hook(lambda _m, _a, out: lookups.append(out))

        def call_done(_m, _a, _out):
            self._seen["avatar"].append(list(lookups))
            lookups.clear()

        student.register_forward_hook(call_done)

    def seen(self) -> Dict[str, torch.Tensor]:
        """The last step's quantities, rows in stream order, in float32."""
        reduce = {"decoder": lambda out: out.mean((1, 2), dtype=torch.float32),
                  "avatar": lambda lookups: torch.cat(lookups, dim=1)}
        return {k: torch.cat([reduce.get(k, lambda t: t)(t) for t in v]).float()
                for k, v in self._seen.items() if v}


class Program(_Seen):
    """The port, as a service would run it."""

    def __init__(self, config: Dict, seed: int, device, arch: Optional[Dict] = None,
                 image_size: Optional[int] = None):
        from megaportraits_tpu_torch.core.arch import Arch
        from megaportraits_tpu_torch.core.dtypes import DEFAULT_POLICY, FP32_POLICY
        from megaportraits_tpu_torch.infer.streaming import StudentSession
        from megaportraits_tpu_torch.models.student import Student

        from portbench.seeded import load_drawn

        # bf16 as configured on the card; float32 in the CPU tests, since the
        # CPU lacks bf16 kernels that the models use.
        bf16 = config["use_bf16"] and torch.device(device).type == "cuda"
        policy = DEFAULT_POLICY if bf16 else FP32_POLICY
        self.num_avatars = config["num_avatars"]
        self.student = load_drawn(
            Student(self.num_avatars, policy=policy, arch=Arch(**arch_fields(config, arch)),
                    device=device), seed, WEIGHT_TAG)
        load_statistics(self.student,
                        student_statistics(config, seed, device, arch, image_size))
        self.session = StudentSession(model=self.student)
        self._watch(self.student)

    def encode(self, sources: torch.Tensor) -> None:
        self.session.set_avatars(avatars_for(len(sources), self.num_avatars,
                                             sources.device))

    @torch.no_grad()
    def step(self, frames: torch.Tensor) -> torch.Tensor:
        self._clear()
        return self.session(frames)

    def layers(self) -> Dict[str, torch.nn.Module]:
        """No harness ranges: the Student's parts are the program's spans."""
        return {}

    def trunk_owner(self):
        return None


class Reference(_Seen):
    """The plain float32 Student, run in blocks of `block` rows."""

    def __init__(self, config: Dict, seed: int, device, arch: Optional[Dict] = None,
                 image_size: Optional[int] = None, policy=None, block: int = 4):
        from portbench.reference.dtypes import DEFAULT_POLICY
        from portbench.reference.student import Student
        from portbench.seeded import load_drawn

        self.num_avatars = config["num_avatars"]
        self.student = load_drawn(
            Student(self.num_avatars, policy=policy or DEFAULT_POLICY,
                    width_div=_width_div(config, arch), device=device),
            seed, WEIGHT_TAG).eval()
        load_statistics(self.student,
                        student_statistics(config, seed, device, arch, image_size))
        self.block = block
        self.avatars = None
        self._watch(self.student)

    def encode(self, sources: torch.Tensor) -> None:
        self.avatars = avatars_for(len(sources), self.num_avatars, sources.device)

    @torch.no_grad()
    def step(self, frames: torch.Tensor) -> torch.Tensor:
        self._clear()
        outs = []
        for i in range(0, len(frames), self.block):
            rows = slice(i, min(i + self.block, len(frames)))
            outs.append(self.student(frames[rows], self.avatars[rows]).float())
        return torch.cat(outs)


def wrong_avatar(program_cls):
    """A fault of this system: stream 0 served under avatar 1 (the next
    avatar), every other stream under its own."""
    class WrongAvatar(program_cls):
        def encode(self, sources):
            super().encode(sources)
            avatars = self.session.avatars.clone()
            avatars[0] = (avatars[0] + 1) % self.num_avatars
            self.session.set_avatars(avatars)
    return WrongAvatar


def misrouted_lookup(program_cls):
    """A fault of this system: one lookup of 45 misrouted, the last SPADE's
    beta embedding taken for stream 0 under avatar 1; every other lookup,
    and every other stream, under its own avatar."""
    class MisroutedLookup(program_cls):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            emb = getattr(self.student, self.student.dec_names[-1]).norm_1.avatar_beta_emb
            lookup = emb.forward

            def misrouted(index):
                index = index.clone()
                index[0] = (index[0] + 1) % self.num_avatars
                return lookup(index)

            emb.forward = misrouted
    return MisroutedLookup


FAULTS = {"wrong_avatar": wrong_avatar, "misrouted_lookup": misrouted_lookup}


def control_policy():
    from portbench.reference.dtypes import FP8_CONTROL

    return FP8_CONTROL


def tiny_arch() -> Dict:
    """The CPU tests' widths: every width divided by 8 (floored at 8)."""
    return {"name": "tiny", "width_div": 8}
