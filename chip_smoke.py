#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check its kernels.

    python3 chip_smoke.py            # from the root of a checkout

Phases, in order; any failure exits non-zero:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build the CUDA kernels from csrc/ with nvcc (seconds printed);
  3. K1 (conv3x3_bn_act) against its plain version at 64x64x512 -> 512,
     bf16, with and without the residual: errors, kernel / plain / library
     times (cuDNN conv + epilogue, with its min and max, and the cuDNN conv
     alone) and the bound; then at ragged shapes (errors only);
  4. K2 (resblock_chain) and K3 (fused_resblock_chain, the chain in one
     persistent launch on the same tile routine) likewise at 64x64x512,
     N=8, on the same inputs; K2 with and without dependent launches; K3
     equal to K2 bit for bit, there and on ragged shapes (the tap path, the
     haloed path, several tiles a CTA), and against its plain version alone
     where C is no multiple of 32; K3's grid, shared memory and launch
     counts; 200 repeated K3 calls identical, on an idle card and queued
     behind other work; what K3's conv boundary costs (the chain with its
     tiles left out, and with its waits left out, built by
     utils/probe_conv3x3.py);
  4b. K4 (bn_act, eval-mode BatchNorm + residual + ReLU in one pass) against
     its plain version in float32 at the served cells' shapes (G2d's up3
     at batch 8 with its shortcut, a Genh block at 1024^2 at batch 4, Emtn's
     stem) and the main path's batch-1 shapes (Emtn's downsampling blocks at
     128 to 512 channels, up3): one bf16 ulp; kernel, plain and library
     (PyTorch's BatchNorm chain) times and the bytes' bound;
  5. the main path: FULL Gbase, 512x512, batch 1, bf16 compute, seeded
     random weights with BatchNorm running statistics calibrated once from
     batch statistics; ReenactmentSession.set_source, then 8 drive frames
     with the G2d trunk on K2; launch counts, the trunk operands folded
     once, output checks, one frame against the plain trunk (its blocks
     run in place of K2), one frame with the kernels' gate shut (the
     BatchNorms' float32 chain) against K4's on the plain trunk, the
     trunk's time inside a frame, drive frames/s;
  6. K3's path, its own entry point (no model calls it, in JAX either):
     fused_resblock_chain on the G2d trunk input of each of those frames
     with the model's folded trunk parameters; launch counts, and each
     result equal to K2's on the same input bit for bit;
  7. the full-width cases of utils/seeded.py (phase_full_width): Gbase's
     encode_source + 2 drive frames at 512, GHR (Gbase at 256, bilinear x2,
     Genh at 512) and the Student (3 avatars, 512, batch 2), FULL widths,
     weights and images rebuilt from their seeds (checksums against the
     golden's) and held against the JAX package's outputs that
     tests/data/torch_port_goldens.npz keeps (a stride-8 subsample and the
     central 64x64 crop): float32 with TF32 off within 1e-4 (and Gbase's
     vc2d and es summaries within 1e-4 absolute and relative); float32 at
     torch's own TF32 flags, as `infer --config parity.yaml` runs, within
     1e-4 (and, printed, without Policy.conv_scope, which turns TF32 off
     for a float32 policy's convolutions); bf16 with the trunk on K2 (Gbase, and GHR's Gbase) no further
     from the golden than twice the plain bf16 trunk and within
     FRAME_MAX_ABS / FRAME_MEAN_ABS (the Student's bf16 gap printed: no
     kernel runs there); one line a comparison (case, precision, max and mean abs error, limit,
     seconds); K2's launches there count in the JSON line;
  7b. the full-width training cases of utils/seeded.py
     (phase_train_full_width): one step each of stage 1 (Gbase, D, the
     perceptual loss), stage 2 (Genh behind a frozen Gbase; target 512)
     and stage 3 (the Student, 3 avatars, the GHR teacher inline, then on
     'target01'), FULL widths at 256, batch 2, rebuilt from their seeds
     (checksums against the golden's) and held against the JAX package's
     steps that tests/data/torch_port_train_goldens.npz keeps (metrics,
     samples of the prediction and of the frozen network's output, every
     BatchNorm statistic, a strided sample of each gradient leaf): float32
     with TF32 off and float32 at torch's own TF32 flags, each quantity
     within the larger of twice the golden's self-gap and its floor
     (seeded.tolerance); the latter also without Policy.backward_scope,
     printed, with what TF32 in the backward alone moves; bf16 printed, its
     frozen Gbase's trunk on K2 within twice the plain trunk's gaps of the
     frozen output and the prediction on the same step (K2 once a sample,
     counted in the JSON line); one line a
     run, precision and quantity (max and mean gap, limit, seconds);
  8. stage-2 HR serving: FULL Gbase + Genh (GHR), batch 1; set_source at
     512, 4 drive frames at 512 with the trunk on K2, bilinear to 1024x1024
     (align_corners=False), Genh at 1024; launch counts, output checks,
     ms/frame and Genh's share of it;
  9. stage-3 serving: FULL Student, 4 avatars, 1024x1024, batch 1; 4 frames
     with two avatar indices; output checks, ms/frame;
  9b. the Student's session (infer/streaming.StudentSession), FULL, 4
     avatars, 1024x1024, batch 8 (streams on avatars 0,1,2,3,0,1,2,3),
     BatchNorms with random statistics: each of the 23 eval BatchNorm
     epilogues of a step (the stem's and the ResBlockBNs') launches K4,
     whose output lies within one bf16 ulp of its plain version in float32
     and of the modules' chain; the frames with K4 shut against K4's, by
     their mean absolute gap (a few pixels of the Student's bf16 frames are
     ill-conditioned, so not by the widest); ms/step;
  10. stage-1 training: init_states + make_train_step, FULL, 512x512, batch
     2, bf16 compute, Config() defaults, seeded weights and batches; 1
     warm-up and 3 timed steps, which the kernels' gate keeps off every
     kernel (0 launches of K1, K2, K3, K4); every metric of every step,
     ms/step, steps/s and peak memory beside the card's name and power
     limit; G and D moved, the rotation net and the loss nets bit for bit,
     G2d's BatchNorm statistics moved;
  11. serving from the trained weights: ReenactmentSession(bn_mode=
     'running'), set_source + 2 frames with the trunk on K2; the trunk's
     operands folded once more than before the steps, K2 once a frame,
     frames finite, the K2 trunk against float32 as in phase 5;
  12. Gbase remat (phase_remat): the stage-1 step of phase 10 under remat
     'none', 'selective' and 'full' at batch 2 and 'selective' at batch 4
     (stage1-base.yaml's batch), 1 warm-up and 2 timed steps each: ms/step
     and peak memory; 'selective' and 'full' must peak below 'none', and
     their first steps' metrics agree with 'none''s within 1e-3 relative.
     (Phase 10 and the drivers train with init_states' default, JAX's:
     'selective' at 512.)
  13. stage-2 training: init_hr_state + make_hr_train_step, FULL,
     stage2-hr.yaml's shapes (base 512, Genh at 1024, batch 2, lr 1e-5),
     bf16 compute, a seeded frozen Gbase with calibrated BatchNorms and its
     trunk on K2; 1 warm-up and 3 timed steps: every metric, ms/step,
     steps/s and peak memory beside the card's name and power limit; K2
     twice a step (once a sample) and K1 16 times each K2; Genh and its
     statistics moved, Gbase and VGG19 bit for bit; Genh's state through
     CheckpointManager and back into a fresh state, bit for bit, and one
     Genh frame from it within 1e-6;
  14. stage-3 training: init_student_state + make_student_train_step,
     FULL, stage3-student.yaml's shapes (512, batch 4, 4 avatars, lr 1e-4),
     the inline GHR teacher (calibrated, its trunk on K2); 1 warm-up and 3
     timed steps as in 13, K2 four times a step, the Student and its
     statistics moved, the teacher bit for bit; make_teacher_forward in
     'running' (K2 once a sample), 'batch' (no K2, no statistic changed)
     and include_enh=False ([0, 1]); one step on a batch with 'target01'
     (no teacher, no kernel);
  15. the training drivers (train/main_{base,hr,student}.py), FULL, in a
     temporary working directory, on 2 clips of 6 smooth frames written
     straight into EMODataset's npz cache at 512 and 1024 (no cv2 on the
     card's machine to decode mp4s). Each runs as `python -m
     megaportraits_tpu_torch train-<stage> --config <yaml>` in this process,
     on a YAML file written here as text (read by the port's own reader:
     the card's machine has no PyYAML); their frozen Gbase's trunk runs on
     K2 by itself (eval, bf16, no autograd).
     - stage 1: train_base at 512, batch 2, unroll 2, save, log and
       evaluate every 2 steps on 2 tail frames a clip, 4 steps; then again
       to step 6 at unroll 1: it must print the resume line, go on from
       step 4 and write the debug PNG. K1, K2 and K3 launch 0 times in both
       calls. The export restores into a fresh Gbase bit for bit equal to
       the evaluator's best snapshot, and serves 2 frames with K2;
     - stage 2: train_hr, base 512 with Genh at 1024, batch 2, 4 steps,
       evaluation every 2, the frozen Gbase from the stage-1 export (bit for
       bit); K2 2 a step plus one a row of every evaluated batch; the
       genh_variables export restores bit for bit;
     - the serving commands (phase_cli, after stage 1), from YAML files,
       on the stage-1 export with its
       BatchNorm statistics calibrated: `infer` PNG in and .png out, JPEG
       in and .jpg out (K2 once each; the PNG the in-process
       inference_base bit for bit, the JPEG its bytes), `infer` from a
       progressive JPEG source and a palette PNG driving frame (K2 once,
       the in-process result bit for bit), the port's read_image of
       progressive JPEGs at 512 and 1024, a palette PNG and a 16-bit PNG
       that PIL wrote in a subprocess, each PIL's convert("RGB") bit for
       bit, with its seconds; `infer` again as a
       subprocess (a fresh interpreter: its PNG the same), `reenact` on 8
       PNG frames of a pattern into an output pattern (K2 8 times; the
       frames within 1/255 of a ReenactmentSession's on the same decoded
       inputs; frames/s beside the session's), `eval` on those frames
       (finite, no kernel); every output decodes, 512x512x3, not flat; no
       yaml, PIL or cv2 in sys.modules; each command's seconds split into
       config, model build, restore, device compute and host I/O, and the
       JPEG codec's seconds an image at 512 and 1024 on the host;
     - stage 3: train_student at 512, batch 4, 4 steps, the teacher from a
       ghr_variables checkpoint written from the two exports (bit for bit
       after the steps); K2 4 a step.
     For each: steps/s on the host clock from the first batch request to
     the return, beside the bare step's CUDA-event ms of phases 10, 12 and
     13 (the gap is data, prefetch, logging, evaluation and saving), the
     time in checkpoint saves and in held-out evaluations (each timed on
     the host clock after a synchronise), the set-up time, the time the
     driver waited on the prefetch per step, the bytes copied
     host-to-device per step and the peak memory;
  16. the data-parallel path (phase_distributed), in phase 15's directory:
     an in-process NCCL group of one rank and a mesh over it; two plain
     stage-1 steps (FULL 512, batch 2) and one through the data-parallel
     path from the same state, whose gap to the plain step (metrics,
     parameters; both gaps printed) must be no larger than twice the two
     plain steps' gap; then the stage-3 driver for 2 steps under the group
     (mesh_shape {data: 1}) with K2 in the teacher (4 launches a step,
     counted in the JSON line), its checkpoint restored into a plain
     Student bit for bit;
  17. the scripts/ tools (phase_scripts), each through its main() in a
     temporary working directory with $TMPDIR in it: check_device (every
     kernel builds), train_smoke (FULL 512, batch 2, 3 steps after the
     first; finite metrics that move, each step's CUDA-event ms),
     overfit (FULL 256 on 2 clips in the npz cache, --pool 2,
     --eval-every 2, --export: loss_G finite and moving, the export at
     the best held-out step and restoring bit for bit, no kernel) and
     validate_student (256, 3 steps, behind that export, with
     --teacher-bn-mode running: its float32 teacher never on K2, finite
     moving losses, the PNGs and RESULTS.txt; then that teacher in bf16
     with its trunk on K2 against the float32 one, beside the plain
     trunk); each command's seconds and launches;
  18. the pretrained bundle and eval (phase_bundle_eval): synthetic
     original .pth files at their real sizes (2DFAN-4, InceptionResnetV1,
     VGG16 with the LPIPS heads, VGG19, resnet18, 6DRepNet) made from
     seeded port modules through the converter's tables, converted,
     load_bundle checked; 8 frames of the stage-1 ReenactmentSession at
     512 on K2 written as PNGs beside their driving frames; the eval
     command in process with --pretrained (real LPIPS, identity-embedding
     AED, the FAN provider, finite metrics, every PNG read back as
     written); a scored pair's seconds split into PNG I/O, host metrics,
     LPIPS, FAN and the identity net; FAN ms/image at 256 and
     InceptionResnetV1 at 160; the graft report against the FULL leaf
     counts; PerceptualLoss(use_vggface=True) forward + backward at 512,
     batch 2, and its peak memory;
  19. the stage-1 driver with use_gaze_loss (phase_driver_gaze): 512, batch
     2, 2 steps, pretrained_path at the bundle: the FAN provider
     installed, gaze_masks on every batch with their coverage, loss_G_gaze
     finite, the masks' ms a batch, the prefetch wait, steps/s;
  20. one JSON line listing every kernel with its numbers, the launches
     summed over the driven paths (phases 5, 7, 7b, 8, 11 and 13 to 19,
     the serving commands of phase 15 included);
  21. last line: {"ok": true, "device": {...}}.

Times are CUDA-event medians of 5 samples after 2 warm-ups (a training
step: of 3 after 1); the kernels, their plain versions and the library
yardsticks are timed with their launches queued behind a spinning card
(time_stats), the frames and the steps are not.
The plain versions are the float32 references (TF32 off for both cuDNN and
matmul). The library yardsticks run cuDNN with cudnn.benchmark on.
"""

import ast
import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
FRAMES = 8
TRUNK_BLOCKS = 8
HR_FRAMES = 4
HR_SIZE = 1024
STUDENT_FRAMES = 4
STUDENT_AVATARS = 4
TRAIN_SIZE = 512
TRAIN_BATCH = 2
TRAIN_STEPS = 3  # timed, after one warm-up step
SERVE_FRAMES = 2
# One frame through the chain kernels vs the same frame through the plain
# (cuDNN bf16) trunk. Both round activations to bf16, at different places,
# across 16 convs, then 3 upsample blocks and a sigmoid; a first run on an
# H100 measured 0.062 max / 0.0078 mean abs between them. The sharp check is
# the trunk's: each bf16 trunk against a float32 trunk on the same input.
FRAME_MAX_ABS = 0.15
FRAME_MEAN_ABS = 0.02
# Parameters a bundle of every grafted backbone writes into a FULL Gbase
# and a FULL PerceptualLoss(use_vggface=True) (JAX's leaf counts; fixed by
# tests/test_torch_port_pretrained.py).
FULL_GBASE_LEAVES = 178
FULL_PLOSS_LEAVES = 665
VGGFACE_LEAVES = 602  # of FULL_PLOSS_LEAVES, InceptionResnetV1's
# The full-width cases against the JAX package's golden: float32 outputs
# within 1e-4 absolute on the golden's sampled pixels (the CPU test holds
# the port to the same against JAX itself); Gbase's vc2d and es summaries
# (max, mean, std) within 1e-4 absolute and relative.
FULL_WIDTH_ABS = 1e-4
GOLDEN = ROOT / "tests" / "data" / "torch_port_goldens.npz"
TRAIN_GOLDEN = ROOT / "tests" / "data" / "torch_port_train_goldens.npz"


def die(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        die(msg)


def time_stats(fn, reps=10, queued=False):
    """(median, min, max) over 5 samples of the mean of `reps` back-to-back
    calls, in ms, after 2 warm-up calls. With `queued`, the card first spins
    for about a millisecond while the host enqueues the calls, so that a
    kernel shorter than its own launch call is timed on the device and not
    by the rate at which the host can launch it."""
    import torch

    for _ in range(2):
        fn()
    samples = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(2_000_000)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(end) / reps)
    return statistics.median(samples), min(samples), max(samples)


def time_ms(fn, reps=10, queued=False):
    return time_stats(fn, reps, queued)[0]


def library_stats(fn, reps=10):
    """time_stats of a cuDNN yardstick with cudnn.benchmark on, so that the
    library's fastest algorithm for the shape is timed (the warm-up calls
    pick it), not the heuristic's choice of the moment."""
    import torch

    with torch.backends.cudnn.flags(enabled=True, benchmark=True,
                                    deterministic=False, allow_tf32=False):
        return time_stats(fn, reps, queued=True)


def bound_ms(flops, nbytes):
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def errors(got, want):
    diff = (got.float() - want.float()).abs()
    return diff.max().item(), (diff.max() / want.float().abs().max()).item()


def conv3x3_library(x, w_oihw, scale, shift, residual=None):
    """K1's function through PyTorch's own bf16 conv (cuDNN) with the
    epilogue in PyTorch: the speed yardstick (library_ms). The port never
    calls it."""
    import torch
    import torch.nn.functional as F

    y = F.conv2d(x.permute(2, 0, 1)[None], w_oihw, padding=1)[0].permute(1, 2, 0)
    y = y.float() * scale + shift
    if residual is not None:
        y = y + residual.float()
    return torch.relu(y).to(x.dtype)


# K1's ragged shapes: C and F below and off the 64-wide boxes, images
# narrower and wider than a pixel box, a last tile of one row or column.
K1_RAGGED = [(10, 12, 32, 40), (16, 16, 64, 64), (40, 24, 256, 256),
             (9, 65, 96, 136)]


def k1_inputs(torch, dev, gen, h, w, c, f):
    """Variance-preserving weights keep bf16 activations in range."""
    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    return (randn(h, w, c).bfloat16(), (randn(3, 3, c, f) / (9 * c) ** 0.5).bfloat16(),
            torch.rand(f, device=dev, generator=gen) * 0.5 + 0.5, randn(f) * 0.1,
            randn(h, w, f).bfloat16())


def phase_kernels(torch, dev):
    import torch.nn.functional as F

    from megaportraits_tpu_torch.ops.kernels import conv3x3 as k1

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    h = w = 64
    c = 512

    x, w1, s1, t1, res = k1_inputs(torch, dev, gen, h, w, c, c)
    w1_oihw = w1.permute(3, 2, 0, 1).contiguous()
    x_nchw = x.permute(2, 0, 1)[None]
    flops = 2.0 * h * w * c * c * 9
    conv_only = library_stats(lambda: F.conv2d(x_nchw, w1_oihw, padding=1))

    k1_rows = []
    for r in (None, res):
        got = k1.conv3x3_bn_act(x, w1, s1, t1, r)
        torch.cuda.synchronize()
        want = k1.conv3x3_bn_act_plain(x, w1, s1, t1, r)
        err, rel = errors(got, want)
        check(torch.isfinite(got.float()).all().item(), "K1 output not finite")
        # One conv output rounds once to bf16 (8 bits): 2 ulps of the max.
        check(rel <= 2 ** -7, f"K1 disagrees with its plain version: rel {rel}")
        out = torch.empty_like(got)
        ms = time_ms(lambda: k1.launch_conv3x3(x, w1, s1, t1, r, out, True),
                     queued=True)
        plain = time_ms(lambda: k1.conv3x3_bn_act_plain(x, w1, s1, t1, r),
                        queued=True)
        lib, lib_lo, lib_hi = library_stats(
            lambda: conv3x3_library(x, w1_oihw, s1, t1, r))
        bms, by = bound_ms(flops, nbytes(x, w1, s1, t1, r, got))
        k1_rows.append(dict(residual=r is not None, max_abs_err=err, rel_err=rel,
                            ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms,
                            bound_by=by))
        print(f"K1 conv3x3_bn_act 64x64x512->512 residual={r is not None}: "
              f"max_abs_err {err:.6g} rel {rel:.3g} | kernel {ms:.4f} ms, "
              f"plain {plain:.4f} ms, library {lib:.4f} ms (min {lib_lo:.4f}, "
              f"max {lib_hi:.4f}; the cuDNN conv alone {conv_only[0]:.4f}, min "
              f"{conv_only[1]:.4f}, max {conv_only[2]:.4f}), bound {bms:.4f} ms "
              f"({by}) -> {bms / ms:.1%} of bound")
    staged = k1.staged_bytes(h, w, c, c)
    print(f"K1 loads {staged / 1e6:.1f} MB a conv from L2 into shared memory "
          f"({staged / nbytes(x, w1):.1f} times x and w), "
          f"{staged / 1e9 / k1_rows[0]['ms']:.2f} TB/s at the kernel's time")

    for rh, rw, rc, rf in K1_RAGGED:
        xr, wr, sr, tr, rr = k1_inputs(torch, dev, gen, rh, rw, rc, rf)
        for r in (None, rr):
            got = k1.conv3x3_bn_act(xr, wr, sr, tr, r)
            torch.cuda.synchronize()
            err, rel = errors(got, k1.conv3x3_bn_act_plain(xr, wr, sr, tr, r))
            print(f"K1 ragged {rh}x{rw}x{rc}->{rf} (box {k1.tile_box(rh, rw)}) "
                  f"residual={r is not None}: max_abs_err {err:.6g} rel {rel:.3g}")
            check(torch.isfinite(got.float()).all().item(), "K1 ragged not finite")
            check(rel <= 2 ** -7, f"K1 ragged disagrees with its plain version: {rel}")
            k1_rows[0]["max_abs_err"] = max(k1_rows[0]["max_abs_err"], err)

    chain_rows = phase_chains(torch, dev, gen, flops)
    return k1_rows, chain_rows


# K4 at the served cells' shapes: G2d's up3 second half at batch 8 (the
# shortcut conv's BatchNorm), a Genh block at 1024^2 at batch 4 (the
# identity), and Emtn's stem at batch 8 (no residual).
K4_SHAPES = [("G2d up3, shortcut", (8, 512, 512, 64), "shortcut"),
             ("Genh 1024, identity", (4, 1024, 1024, 64), "identity"),
             ("Emtn stem", (8, 128, 128, 64), "none"),
             # The batch-1 drive frame of the main path: Emtn's downsampling
             # BasicBlocks (the descriptor net at 256, the head-pose net's
             # last stage at 224), its identity blocks at 512, and up3.
             ("Emtn layer2 downsample, batch 1", (1, 32, 32, 128), "shortcut"),
             ("Emtn layer3 downsample, batch 1", (1, 16, 16, 256), "shortcut"),
             ("Emtn layer4 downsample, batch 1", (1, 8, 8, 512), "shortcut"),
             ("Emtn head-pose layer4, batch 1", (1, 7, 7, 512), "identity"),
             ("G2d up3, batch 1", (1, 512, 512, 64), "shortcut")]
# K4 launches a batch-1 drive frame: Emtn's two ResNet-18s (a stem and 8
# BasicBlocks each: 2 x 17) and G2d's decoder (3 blocks: 6); the trunk is on K2.
K4_A_FRAME = 40


def bn_act_library(torch, y, bn, r, bn_r):
    """K4's function as the modules computed it before K4: eval BatchNorm's
    float32 chain, the residual's sum and ReLU (the speed yardstick,
    library_ms)."""
    out = bn(y, False)
    if r is not None:
        out = out + (r if bn_r is None else bn_r(r, False))
    return torch.relu(out)


def bf16_ulp_excess(got, args, relu=True):
    """How far K4's output `got` for ``bn_act(*args, relu=relu)`` lies
    beyond one bf16 ulp (of the float32 result) from the plain version
    computed in float32, and beyond a float32 slack of 2**-21 of the terms'
    magnitude, by which a fused multiply-add and PyTorch's separate products
    may differ; <= 0 where every element is within."""
    import torch

    from megaportraits_tpu_torch.ops.kernels.bn_act import bn_act_plain

    f32 = [a.float() for a in args]
    want = bn_act_plain(*f32, relu=relu)
    y, m1, s1, b1 = f32[:4]
    mag = ((y - m1) * s1).abs() + b1.abs()
    if len(f32) == 5:
        mag = mag + f32[4].abs()
    elif len(f32) == 8:
        r, m2, s2, b2 = f32[4:]
        mag = mag + ((r - m2) * s2).abs() + b2.abs()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(2.0 ** -126))) - 7)
    return ((got.float() - want).abs() - ulp - mag * 2.0 ** -21).max().item()


def phase_bn_act(torch, dev):
    """K4 (bn_act) against its plain version in float32 at K4_SHAPES: one
    bf16 ulp; kernel, plain and library times and the bytes' bound."""
    from megaportraits_tpu_torch.nn.blocks import fold_batch_norm
    from megaportraits_tpu_torch.nn.layers import BatchNorm
    from megaportraits_tpu_torch.ops.kernels import bn_act as k4

    gen = torch.Generator(device=dev)
    gen.manual_seed(4)

    def batch_norm(c):
        bn = BatchNorm(c, device=dev).eval()
        with torch.no_grad():
            bn.weight.uniform_(0.5, 1.5, generator=gen)
            bn.bias.normal_(0.0, 0.2, generator=gen)
            bn.running_mean.normal_(0.0, 0.3, generator=gen)
            bn.running_var.uniform_(0.3, 2.0, generator=gen)
        return bn

    rows = []
    with torch.no_grad():
        for name, shape, form in K4_SHAPES:
            c = shape[-1]
            y = torch.randn(shape, device=dev, generator=gen).bfloat16()
            r = None if form == "none" else torch.randn(
                shape, device=dev, generator=gen).bfloat16()
            bn = batch_norm(c)
            bn_r = batch_norm(c) if form == "shortcut" else None
            args = [y, *fold_batch_norm(bn)]
            if r is not None:
                args.append(r)
            if bn_r is not None:
                args += fold_batch_norm(bn_r)
            got = k4.bn_act(*args)
            torch.cuda.synchronize()
            excess = bf16_ulp_excess(got, args)
            err = (got.float() - k4.bn_act_plain(*[a.float() for a in args])).abs().max().item()
            check(torch.isfinite(got.float()).all().item(), "K4 output not finite")
            check(excess <= 0, f"K4 {name}: {excess:.3g} beyond one bf16 ulp of its "
                  f"plain version in float32")
            ms = time_ms(lambda: k4.bn_act(*args), queued=True)
            plain = time_ms(lambda: k4.bn_act_plain(*args), queued=True)
            lib = time_ms(lambda: bn_act_library(torch, y, bn, r, bn_r), queued=True)
            moved = nbytes(*args, got)
            bms = moved / PEAK_BYTES * 1e3
            rows.append(dict(name=name, shape=shape, form=form, max_abs_err=err,
                             ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms,
                             bound_by="bytes"))
            print(f"K4 bn_act {name} {'x'.join(map(str, shape))}: max_abs_err "
                  f"{err:.6g} (within one bf16 ulp) | kernel {ms:.4f} ms, plain "
                  f"{plain:.4f} ms, library (PyTorch's BatchNorm chain) {lib:.4f} ms, "
                  f"bound {bms:.4f} ms (bytes, {moved / 1e6:.1f} MB) -> "
                  f"{bms / ms:.1%} of bound, {moved / ms / 1e9:.3f} TB/s")
            del y, r, got, args
    return rows


def chain_inputs(torch, dev, gen, h, w, c, n):
    """Trunk-like chain inputs: variance-preserving weights, BN-like scales
    and shifts."""
    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    return (randn(h, w, c).bfloat16(),
            (randn(n, 2, 3, 3, c, c) / (9 * c) ** 0.5).bfloat16(),
            torch.rand(n, 2, c, device=dev, generator=gen) * 0.2 + 0.4,
            randn(n, 2, c) * 0.05)


def phase_chains(torch, dev, gen, conv_flops):
    """K2 and K3 on the same trunk-shaped inputs: each against the plain
    version, K3 against K2, both on ragged shapes; times and bounds. K3 and
    K2 walk their tiles with one tile routine and sum in one order, so K3
    must equal K2 bit for bit."""
    from megaportraits_tpu_torch.ops.kernels import conv3x3 as k1
    from megaportraits_tpu_torch.ops.kernels import resblock_chain as k2
    from megaportraits_tpu_torch.ops.kernels import resblock_chain_fused as k3

    h = w = 64
    c = 512
    n = TRUNK_BLOCKS
    xs, wts, scs, shs = chain_inputs(torch, dev, gen, h, w, c, n)
    x_before = xs.clone()
    wts_oihw = [[wts[b, i].permute(3, 2, 0, 1).contiguous() for i in range(2)]
                for b in range(n)]
    want = k2.resblock_chain_plain(xs, wts, scs, shs)

    def library_chain():
        cur = xs
        for b in range(n):
            hh = conv3x3_library(cur, wts_oihw[b][0], scs[b, 0], shs[b, 0])
            cur = conv3x3_library(hh, wts_oihw[b][1], scs[b, 1], shs[b, 1], cur)
        return cur

    plain = time_ms(lambda: k2.resblock_chain_plain(xs, wts, scs, shs), reps=3,
                    queued=True)
    lib, lib_lo, lib_hi = library_stats(library_chain, reps=3)
    rows = {}
    outs = {}
    for name, fn in (("K2", k2.resblock_chain), ("K3", k3.fused_resblock_chain)):
        counts = (k1.conv3x3_bn_act.launches, fn.launches)
        got = fn(xs, wts, scs, shs)
        torch.cuda.synchronize()
        delta = (k1.conv3x3_bn_act.launches - counts[0], fn.launches - counts[1])
        err, rel = errors(got, want)
        check(torch.isfinite(got.float()).all().item(), f"{name} output not finite")
        # 16 convs, each rounding to bf16; the errors compound through residuals.
        check(rel <= 2 ** -5, f"{name} disagrees with its plain version: rel {rel}")
        ms = time_ms(lambda: fn(xs, wts, scs, shs), reps=3, queued=True)
        bms, by = bound_ms(conv_flops * 2 * n, nbytes(xs, wts, scs, shs, got))
        print(f"{name} {fn.__name__} 64x64x512 N={n}: max_abs_err {err:.6g} "
              f"rel {rel:.3g} | kernel {ms:.4f} ms, plain {plain:.4f} ms, library "
              f"(cuDNN chain) {lib:.4f} ms (min {lib_lo:.4f}, max {lib_hi:.4f}), "
              f"bound {bms:.4f} ms ({by}) -> "
              f"{bms / ms:.1%} of bound | one call launches K1 {delta[0]} times, "
              f"itself {delta[1]}")
        rows[name] = dict(max_abs_err=err, rel_err=rel, ms=ms, plain_ms=plain,
                          library_ms=lib, bound_ms=bms, bound_by=by, per_call=delta)
        outs[name] = got
    check(rows["K2"]["per_call"] == (2 * n, 1), f"K2 launches {rows['K2']['per_call']}")
    check(rows["K3"]["per_call"] == (0, 1), f"K3 launches {rows['K3']['per_call']}")
    check(torch.equal(xs, x_before), "a chain kernel wrote its input")
    d32 = (outs["K3"].float() - outs["K2"].float()).abs().max().item()
    grid = k3.grid_ctas(h, w, c)
    kept = k3.residual_stays_in_shared(h, w, c, grid)
    print(f"K3 vs K2 on the same inputs: max abs {d32:.6g} (must be equal bit "
          f"for bit); K3 grid {grid} CTAs of {k3.conv_tiles(h, w, c)} tiles a "
          f"conv, {k3.shared_memory_bytes()} B of shared memory a CTA, the "
          f"block's residual {'stays in shared memory' if kept else 'comes by TMA'}")
    check(torch.equal(outs["K3"], outs["K2"]), "K3 differs from K2")
    print(f"K3 {rows['K3']['ms']:.4f} ms beside K2 {rows['K2']['ms']:.4f} ms "
          f"({rows['K3']['ms'] / rows['K2']['ms']:.3f} of K2) and the cuDNN chain "
          f"{lib:.4f} ms (min {lib_lo:.4f}, max {lib_hi:.4f}: K3 is "
          f"{lib_lo / rows['K3']['ms']:.2f}x faster than its fastest sample)")
    k3_repeats(torch, k2, k3, (xs, wts, scs, shs), outs["K3"])
    k3_boundary_cost()

    # The same chain without programmatic dependent launches, in turns.
    pdl = {True: [], False: []}
    for dependent in (True, False, False, True):
        k2.resblock_chain.dependent_launch = dependent
        pdl[dependent].append(
            time_ms(lambda: k2.resblock_chain(xs, wts, scs, shs), reps=3,
                    queued=True))
    k2.resblock_chain.dependent_launch = True
    print(f"K2 with dependent launches {pdl[True][0]:.4f} and {pdl[True][1]:.4f} "
          f"ms, without {pdl[False][0]:.4f} and {pdl[False][1]:.4f} ms")

    for rh, rw, rc, rn in CHAIN_RAGGED:
        rargs = chain_inputs(torch, dev, gen, rh, rw, rc, rn)
        rx_before = rargs[0].clone()
        before = (k3.fused_resblock_chain.launches, k1.conv3x3_bn_act.launches,
                  k2.resblock_chain.launches)
        got = k3.fused_resblock_chain(*rargs)
        torch.cuda.synchronize()
        check(k3.fused_resblock_chain.launches == before[0] + 1
              and k1.conv3x3_bn_act.launches == before[1], "K3 ragged launch count")
        want_r = k2.resblock_chain_plain(*rargs)
        err_r, rel_r = errors(got, want_r)
        grid = k3.grid_ctas(rh, rw, rc)
        kept = k3.residual_stays_in_shared(rh, rw, rc, grid)
        line = (f"ragged {rh}x{rw}x{rc} N={rn} (box {k1.tile_box(rh, rw)}): K3 "
                f"(grid {grid} CTAs of {k3.conv_tiles(rh, rw, rc)} tiles, residual "
                f"{'kept' if kept else 'by TMA'}) max_abs_err {err_r:.6g} rel "
                f"{rel_r:.3g}")
        check(rel_r <= 2 ** -5, f"K3 ragged disagrees with its plain version: {rel_r}")
        rows["K3"]["max_abs_err"] = max(rows["K3"]["max_abs_err"], err_r)
        if rc % 32 == 0:  # K2 takes C % 32 == 0, K3 C % 8 == 0
            ref2 = k2.resblock_chain(*rargs)
            torch.cuda.synchronize()
            check((k1.conv3x3_bn_act.launches, k2.resblock_chain.launches)
                  == (before[1] + 2 * rn, before[2] + 1), "K2 ragged launch count")
            err2_r, rel2_r = errors(ref2, want_r)
            line += (f"; K2 max_abs_err {err2_r:.6g} rel {rel2_r:.3g}; K3 equals "
                     f"K2 bit for bit: {torch.equal(got, ref2)}")
            check(rel2_r <= 2 ** -5,
                  f"K2 ragged disagrees with its plain version: {rel2_r}")
            check(torch.equal(got, ref2), "K3 ragged differs from K2")
            rows["K2"]["max_abs_err"] = max(rows["K2"]["max_abs_err"], err2_r)
        print(line)
        check(torch.equal(rargs[0], rx_before), "a chain kernel wrote its input (ragged)")
    return rows


# Chains off the trunk shape: 40x24x256 has 20 tiles a conv on the tap path
# (10 boxes of 4 x 32 pixels by 2 channel tiles); 9x65x96 is on the haloed
# path with a last column of one pixel and a last row of one; 128x128x256 has
# 256 tiles, more than the card holds CTAs, so CTAs take 1 or 2 tiles a conv
# and the residual comes by TMA; 12x20x40 has a C that is no multiple of 32;
# 32x32x512 N=8 is the trunk at 256 (validate_student's teacher in
# phase_scripts).
CHAIN_RAGGED = [(40, 24, 256, 2), (9, 65, 96, 2), (128, 128, 256, 2),
                (12, 20, 40, 1), (32, 32, 512, TRUNK_BLOCKS)]
K3_REPEATS = 200


def k3_repeats(torch, k2, k3, args, first):
    """A race shows as a call that differs from the others: K3_REPEATS
    back-to-back calls on the same inputs must all equal the first, bit for
    bit, launched onto an idle card and queued behind other work."""
    for queued in (False, True):
        torch.cuda.synchronize()
        if queued:
            torch.cuda._sleep(20_000_000)  # the card spins; the launches queue up
            k2.resblock_chain(*args)
        outs = [k3.fused_resblock_chain(*args) for _ in range(K3_REPEATS)]
        torch.cuda.synchronize()
        same = sum(torch.equal(out, first) for out in outs)
        print(f"K3 {K3_REPEATS} repeated calls "
              f"{'queued behind other work' if queued else 'onto an idle card'}: "
              f"{same} equal the first bit for bit")
        check(same == K3_REPEATS, "K3 calls on the same inputs differ: a race")
        del outs


def k3_boundary_cost():
    """What lies between two convs of K3, from variants of the kernel built
    by utils/probe_conv3x3.py, in turns: the chain with its tiles left out
    (the arrivals, the waits and the loop around them), and the chain as it
    is against per-tile dependencies (a counter a pixel box) and against
    waiting for no other CTA (results garbage)."""
    from megaportraits_tpu_torch.utils import probe_conv3x3 as probe

    names = ("K3 as it is", "K3 a counter a pixel box", "K3 no boundary",
             "K3 boundary only")
    ms = probe.time_variants(names, rounds=2)
    n_convs = 2 * TRUNK_BLOCKS
    as_is, boxed, free, bare = (min(ms[name]) for name in names)
    print(f"K3 conv boundary, 64x64x512 N={TRUNK_BLOCKS}: the chain with its "
          f"tiles left out {bare:.4f} ms = {bare / (n_convs - 1) * 1e3:.2f} us a "
          f"boundary; as it is (one counter for the grid) {as_is:.4f} ms, with a "
          f"counter a pixel box (a tile waits only for the boxes around it) "
          f"{boxed:.4f} ms, with no CTA waiting for another {free:.4f} ms: "
          f"waiting costs {(as_is - free) / (n_convs - 1) * 1e3:.2f} us a boundary "
          f"(samples {ms})")


def smooth_image(torch, gen, dev, size):
    """A seeded smooth RGB image in [0, 1], [1, size, size, 3]."""
    import torch.nn.functional as F

    coarse = torch.rand(1, 3, 12, 12, device=dev, generator=gen)
    img = F.interpolate(coarse, size=(size, size), mode="bicubic",
                        align_corners=False).clamp(0, 1)
    return img.permute(0, 2, 3, 1).contiguous()


def trunk_input(torch, model, session, xd):
    """The G2d trunk's input [1, 64, 64, 512] for driving frame `xd`: the
    drive path up to the trunk."""
    from megaportraits_tpu_torch.ops.warp import apply_warping_field

    g2d = model.g2d
    with torch.no_grad():
        rd, td, zd = model.motion_encoder(xd)
        state = session.source_state
        w_c2d = model.warp_generator_c2d(rd, td, zd, state["es"])
        projected = apply_warping_field(state["vc2d"], w_c2d,
                                        model.warp_normalize_mode).sum(dim=1)
        return g2d.conv1x1(g2d.reshape_conv(projected))


@contextlib.contextmanager
def plain_trunk(g2d):
    """G2d's trunk through its ResBlock2D blocks (cuDNN convolutions, K4
    where the gate opens) in place of K2, as G2d.trunk runs where K2 does
    not engage. Yields that trunk."""
    def blocks(x, train=False):
        for name in g2d.trunk_names:
            x = getattr(g2d, name)(x, train)
        return x

    g2d.trunk = blocks
    try:
        yield blocks
    finally:
        del g2d.trunk  # back to the class's method


@contextlib.contextmanager
def kernels_shut():
    """The kernels' gate (nn/blocks.kernel_engages) shut: K2 and K4 run
    nowhere, the modules' own chains everywhere."""
    from megaportraits_tpu_torch.nn import blocks

    takes = blocks.kernel_takes
    blocks.kernel_takes = lambda tensors: False
    try:
        yield
    finally:
        blocks.kernel_takes = takes


def trunk_against_float32(torch, model, session, xd):
    """The G2d trunk of one frame three ways on the same input and bf16
    weights: K2, the plain bf16 blocks (cuDNN), and float32 activations
    (K2's plain version on float32). K2 must be no further from float32
    than twice the plain bf16 trunk is."""
    from megaportraits_tpu_torch.ops.kernels import resblock_chain as k2

    g2d = model.g2d
    x = trunk_input(torch, model, session, xd)
    with torch.no_grad(), plain_trunk(g2d) as blocks:
        weights, scales, shifts = g2d.trunk_chain_params()
        ref = k2.resblock_chain_plain(x[0].float(), weights.float(), scales, shifts)
        kern = k2.resblock_chain(x[0].contiguous(), weights, scales, shifts)
        plain = blocks(x)[0]
    scale = ref.abs().max().item()
    e_k = (kern.float() - ref).abs()
    e_p = (plain.float() - ref).abs()
    print(f"trunk vs float32 (max |ref| {scale:.4g}): K2 max abs "
          f"{e_k.max().item():.5g} mean {e_k.mean().item():.5g}; plain bf16 "
          f"trunk max abs {e_p.max().item():.5g} mean {e_p.mean().item():.5g}")
    check(e_k.mean().item() <= 2 * e_p.mean().item() + 1e-6,
          "K2 trunk is further from float32 than the plain bf16 trunk")
    check(e_k.max().item() <= 2 * e_p.max().item() + 1e-6,
          "K2 trunk max error exceeds twice the plain bf16 trunk's")


def k4_against_its_chain(torch, model, session, xd, k4_out):
    """One drive frame with the kernels' gate shut (every eval BatchNorm
    epilogue the modules' own float32 chain) against the same frame through
    K4 (both with the plain trunk, `k4_out`): K4 at every shape of Emtn, the
    trunk and the decoder in one comparison, at the frame limits."""
    from megaportraits_tpu_torch.ops.kernels import bn_act as k4
    from megaportraits_tpu_torch.ops.kernels import resblock_chain as k2

    with kernels_shut():
        before = k4.bn_act.launches + k2.resblock_chain.launches
        shut = session(xd)
        torch.cuda.synchronize()
        shut_launches = k4.bn_act.launches + k2.resblock_chain.launches - before
    check(shut_launches == 0, f"K2 and K4 ran {shut_launches} times with the gate shut")
    diff = (shut - k4_out).abs()
    print(f"K4 vs the BatchNorm chain, one frame: max abs {diff.max().item():.6g}, "
          f"mean abs {diff.mean().item():.6g} (limits {FRAME_MAX_ABS}, "
          f"{FRAME_MEAN_ABS})")
    check(diff.max().item() <= FRAME_MAX_ABS, "K4 frame differs from the chain's (max)")
    check(diff.mean().item() <= FRAME_MEAN_ABS,
          "K4 frame differs from the chain's (mean)")


def phase_main_path(torch, dev):
    from megaportraits_tpu_torch.core.dtypes import DEFAULT_POLICY
    from megaportraits_tpu_torch.infer.streaming import ReenactmentSession
    from megaportraits_tpu_torch.models.gbase import build_gbase, calibrate_batch_norm
    from megaportraits_tpu_torch.ops.kernels import bn_act as k4
    from megaportraits_tpu_torch.ops.kernels import conv3x3 as k1
    from megaportraits_tpu_torch.ops.kernels import resblock_chain as k2

    size = 512
    t0 = time.perf_counter()
    model = build_gbase("full", policy=DEFAULT_POLICY, device=dev, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    xs = smooth_image(torch, gen, dev, size)
    frames = [smooth_image(torch, gen, dev, size) for _ in range(FRAMES)]
    n_bn = calibrate_batch_norm(model, xs, frames[0])
    torch.cuda.synchronize()
    print(f"main path: FULL Gbase, {n_params} parameters, bf16 compute, "
          f"{n_bn} BatchNorms calibrated, set-up {time.perf_counter() - t0:.1f} s")

    session = ReenactmentSession(model=model, bn_mode="running")
    k1.conv3x3_bn_act.launches = 0
    k2.resblock_chain.launches = 0
    session.set_source(xs)
    folds_before = model.g2d.trunk_cache.folds
    k4_before = k4.bn_act.launches
    outs = [session(frames[0])]
    folds_first = model.g2d.trunk_cache.folds - folds_before
    outs += [session(xd) for xd in frames[1:]]
    torch.cuda.synchronize()
    launches = {"conv3x3_bn_act": k1.conv3x3_bn_act.launches,
                "resblock_chain": k2.resblock_chain.launches}
    k4_frames = k4.bn_act.launches - k4_before
    folds_later = model.g2d.trunk_cache.folds - folds_before - folds_first
    print(f"main path launches over {FRAMES} drive frames: {launches}, K4 "
          f"{k4_frames}; trunk operands folded {folds_first} time(s) in the first "
          f"frame, {folds_later} in the {FRAMES - 1} after it")
    check(k4_frames == K4_A_FRAME * FRAMES,
          f"K4 ran {k4_frames} times, want {K4_A_FRAME * FRAMES}")
    check(folds_first == 1, f"the first frame folded {folds_first} times")
    check(folds_later == 0, f"later frames folded {folds_later} times")
    check(launches["resblock_chain"] == FRAMES,
          f"K2 ran {launches['resblock_chain']} times, want {FRAMES}")
    check(launches["conv3x3_bn_act"] == 2 * TRUNK_BLOCKS * FRAMES,
          f"K1 ran {launches['conv3x3_bn_act']} times, want "
          f"{2 * TRUNK_BLOCKS * FRAMES}")

    for out in outs:
        check(tuple(out.shape) == (1, size, size, 3), f"output shape {out.shape}")
        check(torch.isfinite(out).all().item(), "non-finite output")
        check(out.min().item() >= 0.0 and out.max().item() <= 1.0,
              "output outside [0, 1]")
    stack = torch.cat(outs)
    saturated = ((stack < 1e-3) | (stack > 1 - 1e-3)).float().mean().item()
    print(f"outputs: std {stack.std().item():.5f}, mean {stack.mean().item():.5f},"
          f" saturated share {saturated:.5f}, frame-to-frame std "
          f"{stack.std(dim=0).mean().item():.5f}")
    check(stack.std().item() > 1e-3, "outputs are flat")

    trunk_against_float32(torch, model, session, frames[0])
    with plain_trunk(model.g2d):
        plain_out = session(frames[0])
    diff = (plain_out - outs[0]).abs()
    print(f"chain vs plain trunk, one frame: max abs {diff.max().item():.6g}, "
          f"mean abs {diff.mean().item():.6g} (limits {FRAME_MAX_ABS}, "
          f"{FRAME_MEAN_ABS})")
    check(diff.max().item() <= FRAME_MAX_ABS, "chain frame differs (max)")
    check(diff.mean().item() <= FRAME_MEAN_ABS, "chain frame differs (mean)")
    k4_against_its_chain(torch, model, session, frames[0], plain_out)

    # The trunk's time inside a frame: CUDA events around G2d.trunk, the
    # operand cache warm.
    trunk_events = []

    def timed(trunk):
        def run(x, train=False):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = trunk(x, train)
            end.record()
            trunk_events.append((start, end))
            return out
        return run

    timings, trunk_ms = {}, {}
    k2_trunk = model.g2d.trunk
    for chain in (True, False):
        with plain_trunk(model.g2d) as blocks:
            model.g2d.trunk = timed(k2_trunk if chain else blocks)
            trunk_events.clear()
            timings[chain] = time_ms(lambda: session(frames[1]), reps=1)
            trunk_ms[chain] = statistics.median(
                a.elapsed_time(b) for a, b in trunk_events[2:])
    print(f"G2d trunk inside a drive frame: {trunk_ms[True]:.3f} ms on K2 "
          f"(operands cached), {trunk_ms[False]:.3f} ms on the plain (cuDNN) "
          f"blocks")
    print(f"drive: {timings[True]:.3f} ms/frame = {1e3 / timings[True]:.2f} "
          f"frames/s with the trunk on K2; {timings[False]:.3f} ms/frame = "
          f"{1e3 / timings[False]:.2f} frames/s with the plain (cuDNN) trunk")
    return launches, model, session, frames


def phase_k3_path(torch, model, session, frames):
    """K3's own entry point, as a user calls it: the chain in one launch on
    the G2d trunk input of each drive frame, with the model's folded trunk
    parameters. Counts are read around these calls only; each result is
    then held against K2's on the same input."""
    from megaportraits_tpu_torch.ops.kernels import conv3x3 as k1
    from megaportraits_tpu_torch.ops.kernels import resblock_chain as k2
    from megaportraits_tpu_torch.ops.kernels import resblock_chain_fused as k3

    cdt = model.policy.compute_dtype
    with torch.no_grad():
        weights, scales, shifts = model.g2d.cached_trunk_chain_params()
        inputs = [trunk_input(torch, model, session, xd)[0].to(cdt).contiguous()
                  for xd in frames]
        torch.cuda.synchronize()
        k1.conv3x3_bn_act.launches = 0
        k2.resblock_chain.launches = 0
        k3.fused_resblock_chain.launches = 0
        outs = [k3.fused_resblock_chain(x, weights, scales, shifts) for x in inputs]
        torch.cuda.synchronize()
        launches = {"conv3x3_bn_act": k1.conv3x3_bn_act.launches,
                    "resblock_chain": k2.resblock_chain.launches,
                    "fused_resblock_chain": k3.fused_resblock_chain.launches}
        print(f"K3 path launches over {len(frames)} trunk calls: {launches}")
        check(launches == {"conv3x3_bn_act": 0, "resblock_chain": 0,
                           "fused_resblock_chain": len(frames)},
              f"K3 path launches {launches}")
        worst = 0.0
        for x, out in zip(inputs, outs):
            check(torch.isfinite(out.float()).all().item(), "K3 trunk not finite")
            ref = k2.resblock_chain(x, weights, scales, shifts)
            want = k2.resblock_chain_plain(x.float(), weights.float(), scales, shifts)
            worst = max(worst, (out.float() - want).abs().max().item())
            check(torch.equal(out, ref), "K3 trunk differs from K2's")
    print(f"K3 path: each frame's trunk equals K2's bit for bit (max abs error "
          f"against the float32 trunk {worst:.6g})")
    return launches["fused_resblock_chain"]


def golden_gap(np, seeded, golden, name, out):
    """(max, mean) absolute error of an output's sampled pixels (the
    golden's stride-8 subsample and central crop) against the golden."""
    got = seeded.samples(out.cpu().numpy())
    diff = np.concatenate([np.abs(got[k] - golden[f"{name}/{k}"]).ravel()
                           for k in ("sub", "crop")])
    return float(diff.max()), float(diff.mean())


@contextlib.contextmanager
def without_conv_scope():
    """A float32 policy's convolutions as the TF32 flags say, as they ran
    before ``Policy.conv_scope`` existed."""
    from megaportraits_tpu_torch.core.dtypes import Policy

    scope = Policy.conv_scope
    Policy.conv_scope = lambda self: contextlib.nullcontext()
    try:
        yield
    finally:
        Policy.conv_scope = scope


def phase_full_width(torch, dev):
    """The full-width cases of utils/seeded.py rebuilt on the card from their
    seeds and held against the JAX package's golden, in float32 with TF32
    off, in float32 at torch's own TF32 flags (parity.yaml as the commands
    run it) and in bf16 with and without K2. Every comparison prints its
    line before any check fails. Returns the kernel counts of the K2 runs."""
    import numpy as np

    from megaportraits_tpu_torch.core.dtypes import DEFAULT_POLICY, FP32_POLICY
    from megaportraits_tpu_torch.utils import seeded

    with np.load(GOLDEN) as z:
        golden = {k: z[k] for k in z.files}
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    smoke_flags = (cudnn.allow_tf32, matmul.allow_tf32)
    failures, launches = [], []

    def run(case, model, images):
        t0 = time.perf_counter()
        out = seeded.run_case(case, model, images)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def report(name, precision, gap, limit, seconds, ok):
        print(f"full width {name}, {precision}: max abs {gap[0]:.6g}, mean abs "
              f"{gap[1]:.6g} (limit {limit}), {seconds:.2f} s")
        if not ok:
            failures.append(f"{name}, {precision}: {gap} over {limit}")

    def float32_run(case, model, images, precision):
        out, secs = run(case, model, images)
        gap = golden_gap(np, seeded, golden, case.name, out["out"])
        report(case.name, precision, gap, f"max {FULL_WIDTH_ABS}", secs,
               gap[0] <= FULL_WIDTH_ABS)
        for key in ("vc2d", "es"):
            if key in out:
                got = seeded.summary(out[key].cpu().numpy())
                want = golden[f"{case.name}/{key}"]
                err = np.abs(got - want) / (FULL_WIDTH_ABS * (1 + np.abs(want)))
                print(f"full width {case.name}, {precision}: {key} max/mean/std "
                      f"{got.tolist()} against {want.tolist()}")
                if err.max() > 1:
                    failures.append(f"{case.name}, {precision}: {key} summary "
                                    f"{got.tolist()} vs {want.tolist()}")

    for case in seeded.CASES.values():
        t0 = time.perf_counter()
        state = seeded.case_state(case)
        images = seeded.seeded_images(case.image_seed, case.images, case.size)
        check(seeded.checksum(state) == str(golden[f"{case.name}/weights_sha256"]),
              f"{case.name}: the seeded weights differ from the golden's "
              f"(numpy {np.__version__})")
        check(seeded.checksum({"images": images})
              == str(golden[f"{case.name}/images_sha256"]),
              f"{case.name}: the seeded images differ from the golden's")
        images = torch.from_numpy(images).to(dev)
        model = seeded.build_model(case, FP32_POLICY, dev, state)
        print(f"full width {case.name}: weights and images drawn, checked and "
              f"loaded in {time.perf_counter() - t0:.1f} s")
        float32_run(case, model, images, "float32, TF32 off")
        cudnn.allow_tf32, matmul.allow_tf32 = True, False  # torch's defaults
        try:
            float32_run(case, model, images,
                        "float32 at torch's TF32 defaults (parity.yaml)")
            with without_conv_scope():
                out, secs = run(case, model, images)
            report(case.name, "float32 at torch's TF32 defaults without "
                   "Policy.conv_scope", golden_gap(np, seeded, golden, case.name,
                                                   out["out"]),
                   "none: the gap the scope closes", secs, True)
        finally:
            cudnn.allow_tf32, matmul.allow_tf32 = smoke_flags
        del model

        model = seeded.build_model(case, DEFAULT_POLICY, dev, state)
        g2d = None  # the trunk K2 can carry; the Student has none
        if case.name == "gbase":
            g2d = model.g2d
        elif case.name == "ghr":
            g2d = model.gbase.g2d
        frame_limit = f"max {FRAME_MAX_ABS}, mean {FRAME_MEAN_ABS}"
        if g2d is None:
            # No kernel runs in the Student: its bf16 gap is bf16's own
            # rounding through the model's gain, printed without a limit.
            out, secs = run(case, model, images)
            plain = golden_gap(np, seeded, golden, case.name, out["out"])
            report(case.name, "bf16", plain, "none: no kernel", secs, True)
        else:
            with plain_trunk(g2d):
                out, secs = run(case, model, images)
            plain = golden_gap(np, seeded, golden, case.name, out["out"])
            report(case.name, "bf16, plain trunk", plain, frame_limit, secs,
                   plain[0] <= FRAME_MAX_ABS and plain[1] <= FRAME_MEAN_ABS)
            reset_counts()
            out, secs = run(case, model, images)
            launches.append(counts())
            k2 = golden_gap(np, seeded, golden, case.name, out["out"])
            report(case.name, "bf16, trunk on K2", k2,
                   f"twice the plain trunk's ({2 * plain[0]:.6g}, "
                   f"{2 * plain[1]:.6g}) and {frame_limit}", secs,
                   k2[0] <= min(2 * plain[0], FRAME_MAX_ABS)
                   and k2[1] <= min(2 * plain[1], FRAME_MEAN_ABS))
            want_k2 = case.images - 1 if case.name == "gbase" else 1
            ran = launches[-1]["resblock_chain"]
            if ran != want_k2:
                failures.append(f"{case.name}: K2 ran {ran} times, want {want_k2}")
        del model, state, images, out
        torch.cuda.empty_cache()
    check(not failures, "full width: " + "; ".join(failures))
    return launches


@contextlib.contextmanager
def without_backward_scope():
    """A float32 step's backward convolutions as the TF32 flags say, as they
    ran before the trainers took their gradients under
    ``Policy.backward_scope``."""
    from megaportraits_tpu_torch.core.dtypes import Policy

    scope = Policy.backward_scope
    Policy.backward_scope = lambda self: contextlib.nullcontext()
    try:
        yield
    finally:
        Policy.backward_scope = scope


def train_gap_groups(gaps):
    """The gaps of ``seeded.train_gaps`` by quantity: {quantity: (the names
    held, the name of the largest gap, max, mean)}. The metrics' max and
    mean are over the metrics, a gradient's over its leaves (its overall
    gap is held too); the prediction's, the frozen network's output's and
    the statistics' are their max and mean absolute gaps."""
    metrics = [k for k in gaps if k.startswith("metric/")]
    out = {"metrics": (metrics, max(metrics, key=gaps.get), max(gaps[k] for k in metrics),
                       statistics.mean(gaps[k] for k in metrics)),
           "prediction": (["pred", "pred_mean"], "pred", gaps["pred"], gaps["pred_mean"]),
           "stats": (["stats", "stats_mean"], "stats", gaps["stats"], gaps["stats_mean"])}
    if "frozen" in gaps:
        out["frozen output"] = (["frozen", "frozen_mean"], "frozen", gaps["frozen"],
                                gaps["frozen_mean"])
    for net in sorted({k.split("/")[1] for k in gaps if k.startswith("grad/")}):
        leaves = [k for k in gaps if k.startswith(f"grad/{net}/")]
        out[f"grad {net}"] = (leaves + [f"grad/{net}"], max(leaves, key=gaps.get),
                              max(gaps[k] for k in leaves),
                              statistics.mean(gaps[k] for k in leaves))
    return out


def phase_train_full_width(torch, dev):
    """The full-width training cases of utils/seeded.py (stage 1, 2 and 3
    at 256, batch 2, FULL widths) rebuilt on the card from their seeds and
    held against the JAX package's golden (tests/data/
    torch_port_train_goldens.npz): float32 with TF32 off and float32 at
    torch's own TF32 flags, each quantity within the larger of twice the
    golden's self-gap and its floor (``seeded.tolerance``); the latter
    also without ``Policy.backward_scope``, printed. Then bf16, as the
    training configs run: every gap printed; in stages 2 and 3 with the
    frozen Gbase's trunk plain and on K2, K2's gaps of the frozen network's
    output and of the prediction (max and mean) no larger than twice the
    plain trunk's on the same step, the metrics' printed beside them. One line
    a comparison, every one printed before any check fails. Returns the
    kernel counts of the K2 runs."""
    import numpy as np

    from megaportraits_tpu_torch.core.dtypes import DEFAULT_POLICY, FP32_POLICY
    from megaportraits_tpu_torch.utils import seeded

    with np.load(TRAIN_GOLDEN) as z:
        golden = {k: z[k] for k in z.files}
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    smoke_flags = (cudnn.allow_tf32, matmul.allow_tf32)
    failures, launches = [], []

    def steps(case, nets, batch):
        t0 = time.perf_counter()
        out = seeded.run_train_case(case, nets, batch)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def compare(case, precision, out, secs, held):
        """Print each quantity's gaps to the golden; hold them if `held`.
        Returns {run: gaps}."""
        result = {}
        for run in case.runs:
            want = seeded.comparable(seeded.golden_run(golden, case.name, run))
            self_gaps = seeded.golden_self_gaps(golden, case.name, run)
            gaps = seeded.train_gaps(seeded.comparable(seeded.train_samples(out[run])),
                                     want)
            result[run] = gaps
            for quantity, (names, top, worst, mean) in train_gap_groups(gaps).items():
                over = [f"{k} {gaps[k]:.3g} > {seeded.tolerance(k, self_gaps):.3g}"
                        for k in names if gaps[k] > seeded.tolerance(k, self_gaps)]
                limit = (f"max {seeded.tolerance(top, self_gaps):.3g}" if held
                         else "none: printed")
                if quantity.startswith("grad"):
                    net = f"grad/{quantity.split()[1]}"
                    limit += (f"; overall {gaps[net]:.6g}, limit "
                              f"{seeded.tolerance(net, self_gaps):.3g}")
                print(f"train full width {case.name}/{run}, {precision}, {quantity}: "
                      f"max {worst:.6g}, mean {mean:.6g} (limit {limit}), {secs:.2f} s"
                      + (f"; over: {over[0]}" if held and over else ""))
                if held and over:
                    failures.append(f"{case.name}/{run}, {precision}, {quantity}: "
                                    + "; ".join(over[:5]))
        return result

    for case in seeded.TRAIN_CASES.values():
        t0 = time.perf_counter()
        state = seeded.train_case_state(case)
        batch = seeded.train_batch(case)
        check(seeded.checksum(seeded.flat_state(state))
              == str(golden[f"{case.name}/weights_sha256"]),
              f"{case.name}: the seeded weights differ from the golden's "
              f"(numpy {np.__version__})")
        check(seeded.checksum(batch) == str(golden[f"{case.name}/batch_sha256"]),
              f"{case.name}: the seeded batch differs from the golden's")
        batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                 for k, v in batch.items()}
        nets = seeded.build_train_case(case, FP32_POLICY, dev, state)
        print(f"train full width {case.name}: weights and batch drawn, checked and "
              f"loaded in {time.perf_counter() - t0:.1f} s")
        out, secs = steps(case, nets, batch)
        compare(case, "float32, TF32 off", out, secs, True)
        cudnn.allow_tf32, matmul.allow_tf32 = True, False  # torch's defaults
        try:
            scoped, secs = steps(case, nets, batch)
            compare(case, "float32 at torch's TF32 defaults", scoped, secs, True)
            with without_backward_scope():
                out, secs = steps(case, nets, batch)
            compare(case, "float32 at torch's TF32 defaults without "
                    "Policy.backward_scope", out, secs, False)
        finally:
            cudnn.allow_tf32, matmul.allow_tf32 = smoke_flags
        for run in case.runs:
            # What TF32 in the backward alone moves: the two runs' forwards
            # are alike, whole gradients compared.
            moved = seeded.train_gaps(seeded.comparable(out[run]),
                                      seeded.comparable(scoped[run]))
            for net in case.trained:
                leaves = [v for k, v in moved.items() if k.startswith(f"grad/{net}/")]
                print(f"train full width {case.name}/{run}: TF32 in the backward moves "
                      f"{net}'s gradient by {moved[f'grad/{net}']:.6g} overall, "
                      f"{max(leaves):.6g} in its worst leaf; the prediction by "
                      f"{moved['pred']:.6g}")
        del nets, out, scoped
        torch.cuda.empty_cache()

        nets = seeded.build_train_case(case, DEFAULT_POLICY, dev, state)
        frozen = None  # the Gbase whose trunk K2 can carry; stage 1 trains its own
        if case.name == "train_hr":
            frozen = nets["gbase"]
        elif case.name == "train_student":
            frozen = nets["teacher"].gbase
        with plain_trunk(frozen.g2d) if frozen else contextlib.nullcontext():
            out, secs = steps(case, nets, batch)
        plain = compare(case, "bf16" if case.name == "train_base"
                        else "bf16, plain trunk", out, secs, False)
        if frozen:
            reset_counts()
            out, secs = steps(case, nets, batch)
            launches.append(counts())
            k2 = compare(case, "bf16, trunk on K2", out, secs, False)
            for run in case.runs:
                # The images are held; a metric, a sum whose rounding errors
                # cancel by chance, is printed.
                for name in [k for k in plain[run] if k.startswith(("pred", "frozen", "metric/"))]:
                    held = not name.startswith("metric/")
                    limit = f"limit {2 * plain[run][name]:.6g}" if held else "printed"
                    print(f"train full width {case.name}/{run}, bf16, {name}: trunk on K2 "
                          f"{k2[run][name]:.6g}, plain trunk {plain[run][name]:.6g} ({limit})")
                    if held and k2[run][name] > 2 * plain[run][name]:
                        failures.append(f"{case.name}/{run}: K2's {name} gap "
                                        f"{k2[run][name]:.3g} over twice the plain trunk's")
            ran = launches[-1]["resblock_chain"]
            if ran != case.batch:
                failures.append(f"{case.name}: K2 ran {ran} times, want {case.batch}")
        del nets, out, state, batch
        torch.cuda.empty_cache()
    check(not failures, "train full width: " + "; ".join(failures))
    return launches


def phase_hr(torch, dev):
    """Stage-2 HR serving: Gbase drive at 512, bilinear x2 to 1024, Genh."""
    from megaportraits_tpu_torch.core.dtypes import DEFAULT_POLICY
    from megaportraits_tpu_torch.infer.streaming import ReenactmentSession
    from megaportraits_tpu_torch.models.gbase import calibrate_batch_norm
    from megaportraits_tpu_torch.models.genh import build_ghr
    from megaportraits_tpu_torch.nn.layers import calibrate_batch_norm_with
    from megaportraits_tpu_torch.ops.kernels import conv3x3 as k1
    from megaportraits_tpu_torch.ops.kernels import resblock_chain as k2
    from megaportraits_tpu_torch.ops.resize import linear_resize

    size = 512
    t0 = time.perf_counter()
    model = build_ghr("full", policy=DEFAULT_POLICY, device=dev, seed=0)
    n_params = sum(p.numel() for p in model.genh.parameters())
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    xs = smooth_image(torch, gen, dev, size)
    frames = [smooth_image(torch, gen, dev, size) for _ in range(HR_FRAMES)]
    n_bn = calibrate_batch_norm(model.gbase, xs, frames[0])
    session = ReenactmentSession(model=model.gbase, bn_mode="running")
    session.set_source(xs)

    def upsample(xhat):
        return linear_resize(xhat, (HR_SIZE, HR_SIZE), axes=(1, 2),
                             align_corners=False)

    n_bn += calibrate_batch_norm_with(
        model.genh, lambda: model.genh(upsample(session(frames[0])), train=True))
    model.eval()
    torch.cuda.synchronize()
    print(f"stage-2 HR: FULL Gbase + Genh ({n_params} Genh parameters), bf16 "
          f"compute, {n_bn} BatchNorms calibrated, set-up "
          f"{time.perf_counter() - t0:.1f} s")

    def frame(xd):
        with torch.no_grad():
            return model.genh(upsample(session(xd)))

    k1.conv3x3_bn_act.launches = 0
    k2.resblock_chain.launches = 0
    outs = [frame(xd) for xd in frames]
    torch.cuda.synchronize()
    launches = {"conv3x3_bn_act": k1.conv3x3_bn_act.launches,
                "resblock_chain": k2.resblock_chain.launches}
    print(f"stage-2 HR launches over {HR_FRAMES} frames: {launches}")
    check(launches == {"conv3x3_bn_act": 2 * TRUNK_BLOCKS * HR_FRAMES,
                       "resblock_chain": HR_FRAMES}, f"HR launches {launches}")
    for out in outs:
        check(tuple(out.shape) == (1, HR_SIZE, HR_SIZE, 3), f"HR shape {out.shape}")
        check(torch.isfinite(out).all().item(), "non-finite HR output")
        check(out.min().item() >= -1.0 and out.max().item() <= 1.0,
              "HR output outside [-1, 1]")
    stack = torch.cat(outs)
    saturated = (stack.abs() > 1 - 1e-3).float().mean().item()
    print(f"HR outputs: std {stack.std().item():.5f}, mean {stack.mean().item():.5f},"
          f" saturated share {saturated:.5f}")
    check(stack.std().item() > 1e-3, "HR outputs are flat")

    ms = time_ms(lambda: frame(frames[1]), reps=1)
    up = upsample(session(frames[1]))
    with torch.no_grad():
        genh_ms = time_ms(lambda: model.genh(up), reps=1)
    print(f"stage-2 HR: {ms:.3f} ms/frame = {1e3 / ms:.2f} frames/s at "
          f"{HR_SIZE}x{HR_SIZE} (drive at {size} with the trunk on K2 + "
          f"bilinear x2 + Genh); Genh alone {genh_ms:.3f} ms = "
          f"{genh_ms / ms:.1%} of the frame")
    return dict(ms=ms, genh_ms=genh_ms, launches=launches)


def phase_student(torch, dev):
    """Stage-3 serving: the Student at 1024, batch 1, per-avatar."""
    from megaportraits_tpu_torch.core.dtypes import DEFAULT_POLICY
    from megaportraits_tpu_torch.models.student import build_student
    from megaportraits_tpu_torch.nn.layers import calibrate_batch_norm_with

    t0 = time.perf_counter()
    model = build_student(STUDENT_AVATARS, "full", policy=DEFAULT_POLICY,
                          device=dev, seed=3)
    n_params = sum(p.numel() for p in model.parameters())
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    frames = [smooth_image(torch, gen, dev, HR_SIZE) for _ in range(STUDENT_FRAMES)]
    avatars = [torch.tensor([a], device=dev) for a in (1, 3) * (STUDENT_FRAMES // 2)]
    n_bn = calibrate_batch_norm_with(
        model, lambda: model(frames[0], avatars[0], train=True))
    torch.cuda.synchronize()
    print(f"stage-3 Student: FULL, {STUDENT_AVATARS} avatars, {n_params} "
          f"parameters, bf16 compute, {n_bn} BatchNorms calibrated, set-up "
          f"{time.perf_counter() - t0:.1f} s")
    with torch.no_grad():
        outs = [model(xd, av) for xd, av in zip(frames, avatars)]
        swapped = model(frames[0], avatars[1])
    torch.cuda.synchronize()
    for out in outs:
        check(tuple(out.shape) == (1, HR_SIZE, HR_SIZE, 3),
              f"Student shape {out.shape}")
        check(torch.isfinite(out).all().item(), "non-finite Student output")
        check(out.min().item() >= 0.0 and out.max().item() <= 1.0,
              "Student output outside [0, 1]")
    stack = torch.cat(outs)
    avatar_diff = (swapped - outs[0]).abs().mean().item()
    print(f"Student outputs: std {stack.std().item():.5f}, mean "
          f"{stack.mean().item():.5f}; same frame, avatar {avatars[1].item()} "
          f"vs {avatars[0].item()}: mean abs difference {avatar_diff:.5f}")
    check(stack.std().item() > 1e-3, "Student outputs are flat")
    check(avatar_diff > 1e-3, "two avatars give the same frame")
    with torch.no_grad():
        ms = time_ms(lambda: model(frames[1], avatars[1]), reps=1)
    print(f"stage-3 Student: {ms:.3f} ms/frame = {1e3 / ms:.2f} frames/s at "
          f"{HR_SIZE}x{HR_SIZE}, batch 1")
    return dict(ms=ms)


STUDENT_STREAMS = 8
STUDENT_EPILOGUES = 23  # the stem and 11 ResBlockBNs' two
# The frames with K4 shut against K4's: mean absolute gap 0.00259 on an H100
# (the widest is 1.0, a few ill-conditioned pixels); about 4 times that.
STUDENT_SHUT_MEAN_ABS = 0.01


def phase_student_session(torch, dev):
    """The Student's session at 1024, batch 8: every ResBlockBN and stem
    epilogue through K4, each within one bf16 ulp of its plain version and
    of the modules' own chain."""
    from megaportraits_tpu_torch.infer.streaming import StudentSession
    from megaportraits_tpu_torch.nn import blocks
    from megaportraits_tpu_torch.nn.layers import BatchNorm
    from megaportraits_tpu_torch.ops.kernels import bn_act as k4

    session = StudentSession(num_avatars=STUDENT_AVATARS, device=dev, seed=5)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    with torch.no_grad():
        for bn in session.model.modules():
            if isinstance(bn, BatchNorm):
                bn.weight.uniform_(0.5, 1.5, generator=gen)
                bn.bias.normal_(0.0, 0.2, generator=gen)
                bn.running_mean.normal_(0.0, 0.3, generator=gen)
                bn.running_var.uniform_(0.3, 2.0, generator=gen)
    session.set_avatars([i % STUDENT_AVATARS for i in range(STUDENT_STREAMS)])
    frames = torch.cat([smooth_image(torch, gen, dev, HR_SIZE)
                        for _ in range(STUDENT_STREAMS)])
    seen = []
    epilogue = blocks.BatchNormEpilogue.__call__

    def recording(self, train, y, bn, residual=None, residual_bn=None):
        out = epilogue(self, train, y, bn, residual, residual_bn)
        seen.append((y, bn, out))
        return out

    before = k4.bn_act.launches
    blocks.BatchNormEpilogue.__call__ = recording
    try:
        out = session(frames)
    finally:
        blocks.BatchNormEpilogue.__call__ = epilogue
    torch.cuda.synchronize()
    launches = k4.bn_act.launches - before
    check(launches == len(seen) == STUDENT_EPILOGUES,
          f"K4 ran {launches} times over {len(seen)} epilogues, want {STUDENT_EPILOGUES}")
    worst_plain = worst_chain = err = 0.0
    with torch.no_grad():
        for y, bn, got in seen:
            args = [y, *blocks.fold_batch_norm(bn)]
            worst_plain = max(worst_plain, bf16_ulp_excess(got, args))
            # One bf16 ulp of the chain's value, and the float32 slack of
            # bf16_ulp_excess (the chain multiplies by rsqrt and the weight
            # apart, K4 by their folded product).
            chain = torch.relu(bn(y, False)).float()
            ulp = torch.exp2(torch.floor(torch.log2(chain.abs().clamp_min(2.0 ** -126))) - 7)
            m, sc, b = args[1:]
            mag = ((y.float() - m) * sc).abs() + b.abs()
            worst_chain = max(worst_chain, ((got.float() - chain).abs() - ulp
                                            - mag * 2.0 ** -21).max().item())
            err = max(err, (got.float() - chain.float()).abs().max().item())
    shapes = sorted({tuple(y.shape) for y, _, _ in seen}, key=lambda t: -t[1])
    print(f"Student session K4 epilogues: {launches} a step at shapes {shapes}; "
          f"max abs against the modules' chain {err:.6g}")
    check(worst_plain <= 0, f"K4 in the Student: {worst_plain:.3g} beyond one bf16 ulp "
          "of its plain version in float32")
    check(worst_chain <= 0, f"K4 in the Student: {worst_chain:.3g} beyond one bf16 ulp "
          "of the modules' chain")
    with kernels_shut():
        before = k4.bn_act.launches
        shut = session(frames)
        check(k4.bn_act.launches == before, "K4 ran with the gate shut")
    check(torch.isfinite(out).all().item() and tuple(out.shape) ==
          (STUDENT_STREAMS, HR_SIZE, HR_SIZE, 3), "Student session output")
    diff = (shut - out).abs()
    print(f"Student session, K4 shut against K4: frames max abs {diff.max().item():.6g}, "
          f"mean {diff.mean().item():.6g}")
    check(diff.mean().item() <= STUDENT_SHUT_MEAN_ABS,
          f"Student session frames with K4 shut: mean abs {diff.mean().item():.3g} "
          f"from K4's > {STUDENT_SHUT_MEAN_ABS}")
    ms = time_ms(lambda: session(frames), reps=5)
    print(f"Student session: {ms:.3f} ms/step = {STUDENT_STREAMS * 1e3 / ms:.2f} frames/s "
          f"at {HR_SIZE}x{HR_SIZE}, batch {STUDENT_STREAMS}")
    return dict(ms=ms, launches=launches)


TRAIN_IMAGES = ("source", "driving", "source_next", "source_star", "driving_star")


def kernel_counters():
    from megaportraits_tpu_torch.ops.kernels import conv3x3 as k1
    from megaportraits_tpu_torch.ops.kernels import resblock_chain as k2
    from megaportraits_tpu_torch.ops.kernels import resblock_chain_fused as k3

    return (k1.conv3x3_bn_act, k2.resblock_chain, k3.fused_resblock_chain)


def reset_counts():
    for fn in kernel_counters():
        fn.launches = 0


def counts():
    """Launches of K1, K2 and K3 since the last reset_counts()."""
    return {fn.__name__: fn.launches for fn in kernel_counters()}


def cuda_timed(torch, fn):
    """(fn(), ms between CUDA events around it)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def phase_train(torch, dev, smi, arch="full", size=TRAIN_SIZE, batch=TRAIN_BATCH,
                policy=None):
    """Stage-1 training, then serving from the trained weights.

    init_states + make_train_step at `arch`, `size`, `batch`, Config()
    defaults, seeded weights and batches; 1 warm-up and TRAIN_STEPS timed
    steps, which the kernels' gate keeps off every kernel (train mode): K1,
    K2, K3 and K4 launch 0 times in the steps. G
    and D move, the rotation net and the loss nets stay bit for bit, G2d's
    BatchNorm statistics move. Then ReenactmentSession(bn_mode='running')
    on the trained Gbase: set_source + SERVE_FRAMES frames, the trunk's
    operands folded once more than before the steps (one frame was served
    before them), K2 once a frame, and the K2 trunk against float32."""
    from megaportraits_tpu_torch.core.config import Config
    from megaportraits_tpu_torch.core.dtypes import DEFAULT_POLICY
    from megaportraits_tpu_torch.infer.streaming import ReenactmentSession
    from megaportraits_tpu_torch.ops.kernels.bn_act import bn_act
    from megaportraits_tpu_torch.train.state import trainable_parameters
    from megaportraits_tpu_torch.train.train_base import init_states, make_train_step

    cfg = Config()
    cfg.model.arch = arch
    cfg.training.steps_per_epoch = 1
    t0 = time.perf_counter()
    gbase, disc, ploss, g_state, d_state = init_states(
        cfg, seed=0, policy=policy or DEFAULT_POLICY, device=dev)
    n_g = sum(p.numel() for p in gbase.parameters())
    n_frozen = sum(p.numel() for name, p in gbase.named_parameters()
                   if "rotation_net" in name)
    n_d = sum(p.numel() for p in disc.parameters())
    n_p = sum(p.numel() for p in ploss.parameters())
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    batches = [{k: torch.cat([smooth_image(torch, gen, dev, size) for _ in range(batch)])
                for k in TRAIN_IMAGES} for _ in range(1 + TRAIN_STEPS)]
    xs = smooth_image(torch, gen, dev, size)
    frames = [smooth_image(torch, gen, dev, size) for _ in range(SERVE_FRAMES)]
    print(f"train: {arch.upper()} at {size}x{size}, batch {batch}, G {n_g} parameters "
          f"({n_frozen} of them the frozen rotation net), D {n_d}, frozen loss nets "
          f"{n_p}; lr {cfg.training.lr}, {cfg.training.base_epochs} steps in the "
          f"schedule; set-up {time.perf_counter() - t0:.1f} s")

    # One frame before training, so that the trunk's operands are cached.
    session = ReenactmentSession(model=gbase, bn_mode="running")
    session.set_source(xs)
    session(frames[0])
    folds_before = gbase.g2d.trunk_cache.folds
    del session

    g_leaf, d_leaf = "g2d.res0.conv1.weight", "block0_conv.weight"
    g_before = gbase.get_parameter(g_leaf).detach().clone()
    d_before = disc.get_parameter(d_leaf).detach().clone()
    frozen_before = {name: p.detach().clone() for name, p in gbase.named_parameters()
                     if "rotation_net" in name}
    ploss_before = [p.detach().clone() for p in ploss.parameters()]
    stats_before = {name: b.clone() for name, b in gbase.g2d.named_buffers()}
    check(len(trainable_parameters(gbase)) < len(list(gbase.parameters())),
          "the rotation net is not frozen")

    step = make_train_step(ploss, cfg)
    reset_counts()
    k4_before = bn_act.launches
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for i, b in enumerate(batches):
        (g_state, d_state, metrics, xhat), ms = cuda_timed(
            torch, lambda: step(g_state, d_state, b))
        step_ms.append(ms)
        values = {k: v.item() for k, v in metrics.items()}
        print(f"train step {i}{' (warm-up)' if i == 0 else ''}: {ms:.3f} ms, "
              + ", ".join(f"{k} {v:.6g}" for k, v in values.items()))
        for k, v in values.items():
            check(math.isfinite(v), f"step {i}: {k} is not finite ({v})")
        check(tuple(xhat.shape) == (batch, size, size, 3), f"xhat shape {xhat.shape}")
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    ms = statistics.median(step_ms[1:])
    print(f"train launches over {len(batches)} steps: {launches} (K1, K2 and K3 must "
          f"stay 0: train-mode BatchNorm cannot fold into them)")
    print(f"train: {ms:.3f} ms/step (median of {TRAIN_STEPS} after 1 warm-up; "
          f"samples {[round(t, 3) for t in step_ms]}) = {1e3 / ms:.3f} steps/s, "
          f"{batch * 1e3 / ms:.3f} samples/s; peak memory "
          f"{peak / 2 ** 30:.2f} GiB (max_memory_allocated) | {smi}")
    check(all(n == 0 for n in launches.values()), f"kernels launched in training: {launches}")
    k4_steps = bn_act.launches - k4_before
    print(f"train: K4 launched {k4_steps} times over the steps (train-mode BatchNorm "
          f"bypasses it)")
    check(k4_steps == 0, f"K4 launched {k4_steps} times in training")
    check(not torch.equal(gbase.get_parameter(g_leaf), g_before), f"G's {g_leaf} did not move")
    check(not torch.equal(disc.get_parameter(d_leaf), d_before), f"D's {d_leaf} did not move")
    for name, p in gbase.named_parameters():
        if name in frozen_before:
            check(torch.equal(p, frozen_before[name]), f"frozen {name} moved")
    for p, q in zip(ploss.parameters(), ploss_before, strict=True):
        check(torch.equal(p, q), "a loss-net parameter moved")
    moved = sum(not torch.equal(b, stats_before[name])
                for name, b in gbase.g2d.named_buffers())
    print(f"train: G and D moved; the rotation net ({len(frozen_before)} tensors) and "
          f"the loss nets ({len(ploss_before)} tensors) are bit for bit as before; "
          f"{moved} of {len(stats_before)} G2d BatchNorm statistics moved")
    check(moved > 0, "no G2d BatchNorm statistic moved")

    # Serve from the trained weights, the trunk on K2.
    del batches, xhat, metrics
    session = ReenactmentSession(model=gbase, bn_mode="running")
    reset_counts()
    session.set_source(xs)
    outs = [session(xd) for xd in frames]
    served = counts()
    folds = gbase.g2d.trunk_cache.folds - folds_before
    print(f"serve after train: {SERVE_FRAMES} frames, launches {served}, trunk operands "
          f"folded {folds} more time(s) than before the steps")
    check(folds == 1, f"the trunk's operands folded {folds} times after training, want 1")
    check(served["resblock_chain"] == SERVE_FRAMES,
          f"K2 ran {served['resblock_chain']} times, want {SERVE_FRAMES}")
    for out in outs:
        check(tuple(out.shape) == (1, size, size, 3), f"served frame shape {out.shape}")
        check(torch.isfinite(out).all().item(), "served frame not finite")
    stack = torch.cat(outs)
    print(f"served frames: std {stack.std().item():.5f}, mean {stack.mean().item():.5f}")
    trunk_against_float32(torch, gbase, session, frames[0])
    return dict(ms=ms, peak=peak, launches=served)


DIST_TIMED_STEPS = 3  # of each, in turns, after the one compared step
REMAT_RUNS = (("none", 2), ("selective", 2), ("full", 2), ("selective", 4))
REMAT_STEPS = 2  # timed, after one warm-up step


def phase_remat(torch, dev, smi, arch="full", size=TRAIN_SIZE, policy=None,
                runs=REMAT_RUNS):
    """Gbase remat: the stage-1 step (init_states + make_train_step, `arch`,
    `size`, seeded weights and batches) under each (remat mode, batch) of
    `runs`, 1 warm-up and REMAT_STEPS timed steps each: ms/step and peak
    memory. The peaks of 'selective' and 'full' must be below that of
    'none' at the same batch, and their first steps' metrics within 1e-3
    relative of 'none''s (the recompute is the same forward)."""
    from megaportraits_tpu_torch.core.config import Config
    from megaportraits_tpu_torch.core.dtypes import DEFAULT_POLICY
    from megaportraits_tpu_torch.train.train_base import init_states, make_train_step

    results = {}
    for mode, batch in runs:
        cfg = Config()
        cfg.model.arch = arch
        cfg.training.steps_per_epoch = 1
        gbase, disc, ploss, g_state, d_state = init_states(
            cfg, seed=0, policy=policy or DEFAULT_POLICY, device=dev, remat_mode=mode)
        gen = torch.Generator(device=dev)
        gen.manual_seed(5)
        batches = [{k: torch.cat([smooth_image(torch, gen, dev, size) for _ in range(batch)])
                    for k in TRAIN_IMAGES} for _ in range(1 + REMAT_STEPS)]
        step = make_train_step(ploss, cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_ms, first = [], None
        for b in batches:
            (g_state, d_state, metrics, _), ms = cuda_timed(
                torch, lambda: step(g_state, d_state, b))
            step_ms.append(ms)
            first = first or {k: v.item() for k, v in metrics.items()}
        peak = torch.cuda.max_memory_allocated()
        ms = statistics.median(step_ms[1:])
        results[(mode, batch)] = dict(ms=ms, peak=peak, first=first)
        print(f"remat {mode}, batch {batch}: {ms:.3f} ms/step (median of {REMAT_STEPS} "
              f"after 1 warm-up; samples {[round(t, 3) for t in step_ms]}) = "
              f"{1e3 / ms:.3f} steps/s; peak memory {peak / 2 ** 30:.2f} GiB "
              f"(max_memory_allocated); first step loss_G {first['loss_G']:.6g} | {smi}")
        for k, v in first.items():
            check(math.isfinite(v), f"remat {mode}: {k} is not finite ({v})")
        del gbase, disc, ploss, g_state, d_state, batches, step, metrics
        torch.cuda.empty_cache()
    for (mode, batch), r in results.items():
        base = results.get(("none", batch))
        if mode == "none" or base is None:
            continue
        worst = max(abs(v - base["first"][k]) / max(abs(base["first"][k]), 1e-6)
                    for k, v in r["first"].items())
        print(f"remat {mode} against none at batch {batch}: peak {r['peak'] / 2 ** 30:.2f} "
              f"/ {base['peak'] / 2 ** 30:.2f} GiB, {r['ms']:.3f} / {base['ms']:.3f} ms/step, "
              f"first-step metrics within {worst:.3g} relative")
        check(r["peak"] < base["peak"], f"remat {mode} peaks at {r['peak']}, none at "
                                        f"{base['peak']}")
        check(worst <= 1e-3, f"remat {mode}: first-step metrics {worst:.3g} relative from "
                             f"none's")
    return results


# configs/training/stage2-hr.yaml and stage3-student.yaml (read by hand: the
# card's machine has no YAML package).
HR_TRAIN = dict(size=512, batch=2, lr=1.0e-5)
STUDENT_TRAIN = dict(size=512, batch=4, lr=1.0e-4, avatars=4)


def stage_config(arch, lr, avatars=4):
    from megaportraits_tpu_torch.core.config import Config

    cfg = Config()
    cfg.model.arch = arch
    cfg.training.lr = lr
    cfg.training.num_avatars = avatars
    cfg.training.steps_per_epoch = 1
    return cfg


def state_copy(*modules):
    return [{k: v.detach().clone() for k, v in m.state_dict().items()} for m in modules]


def same_state(torch, module, before):
    return all(torch.equal(v, before[k]) for k, v in module.state_dict().items())


def moved(torch, module, before):
    """(parameters that moved, buffers that moved, buffers)."""
    params = sum(not torch.equal(p, before[k]) for k, p in module.named_parameters())
    bufs = list(module.named_buffers())
    return params, sum(not torch.equal(b, before[k]) for k, b in bufs), len(bufs)


def timed_steps(torch, step, state, batches, name):
    """Run step(state, b) over batches (the first a warm-up) with CUDA
    events; check every metric finite. Returns (state, ms per step)."""
    step_ms = []
    for i, b in enumerate(batches):
        (state, metrics), ms = cuda_timed(torch, lambda: step(state, b))
        step_ms.append(ms)
        values = {k: v.item() for k, v in metrics.items()}
        print(f"{name} step {i}{' (warm-up)' if i == 0 else ''}: {ms:.3f} ms, "
              + ", ".join(f"{k} {v:.6g}" for k, v in values.items()))
        for k, v in values.items():
            check(math.isfinite(v), f"{name} step {i}: {k} is not finite ({v})")
    return state, step_ms


def report_steps(torch, name, step_ms, batch, smi):
    ms = statistics.median(step_ms[1:])
    peak = torch.cuda.max_memory_allocated()
    print(f"{name}: {ms:.3f} ms/step (median of {len(step_ms) - 1} after 1 warm-up; "
          f"samples {[round(t, 3) for t in step_ms]}) = {1e3 / ms:.3f} steps/s, "
          f"{batch * 1e3 / ms:.3f} samples/s; peak memory {peak / 2 ** 30:.2f} GiB "
          f"(max_memory_allocated) | {smi}")
    return ms, peak


def check_trunk_launches(name, launches, k2_calls, trunk_blocks):
    """K2 `k2_calls` times, K1 2 x trunk_blocks times each, K3 never."""
    want = {"conv3x3_bn_act": 2 * trunk_blocks * k2_calls, "resblock_chain": k2_calls,
            "fused_resblock_chain": 0}
    check(launches == want, f"{name} launches {launches}, want {want}")


def phase_train_hr(torch, dev, smi, arch="full", size=HR_TRAIN["size"],
                   batch=HR_TRAIN["batch"], policy=None):
    """Stage-2 training: init_hr_state + make_hr_train_step at `arch`, base
    `size`, HR 2 x size, `batch`, stage2-hr.yaml's lr; a seeded Gbase with
    its BatchNorms calibrated, frozen, its trunk on K2. 1 warm-up and
    TRAIN_STEPS timed steps: every metric finite, K2 `batch` times a step
    and K1 16 times each K2, Genh and its statistics moved, Gbase and VGG19
    bit for bit. Then Genh's state through CheckpointManager and back into
    a fresh init_hr_state: parameters, buffers and AdamW's state bit for
    bit, one Genh frame within 1e-6."""
    import tempfile

    from megaportraits_tpu_torch.core.checkpoint import CheckpointManager
    from megaportraits_tpu_torch.core.dtypes import DEFAULT_POLICY
    from megaportraits_tpu_torch.models.gbase import calibrate_batch_norm
    from megaportraits_tpu_torch.train.train_hr import init_hr_state, make_hr_train_step

    policy = policy or DEFAULT_POLICY
    cfg = stage_config(arch, HR_TRAIN["lr"])
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    gbase = cfg.make_gbase(policy=policy, device=dev, seed=0)
    calibrate_batch_norm(gbase, smooth_image(torch, gen, dev, size),
                         smooth_image(torch, gen, dev, size))
    gbase.requires_grad_(False)
    genh, ploss, state = init_hr_state(cfg, seed=1, policy=policy, image_size=size,
                                       device=dev)

    def images(n, s):
        return torch.cat([smooth_image(torch, gen, dev, s) for _ in range(n)])

    batches = [{"source": images(batch, size), "driving": images(batch, size),
                "target_hr": images(batch, 2 * size)} for _ in range(1 + TRAIN_STEPS)]
    gbase_before, ploss_before, genh_before = state_copy(gbase, ploss, genh)
    print(f"train HR: {arch.upper()}, base {size}x{size} -> Genh at {2 * size}x{2 * size}, "
          f"batch {batch}, Genh {sum(p.numel() for p in genh.parameters())} parameters, "
          f"frozen Gbase {sum(p.numel() for p in gbase.parameters())} (trunk on K2), "
          f"VGG19 {sum(p.numel() for p in ploss.parameters())}; lr {cfg.training.lr}, "
          f"{cfg.training.hr_epochs} steps in the schedule; set-up "
          f"{time.perf_counter() - t0:.1f} s")

    step = make_hr_train_step(genh, gbase, ploss, cfg)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    state, step_ms = timed_steps(torch, step, state, batches, "train HR")
    launches = counts()
    ms, peak = report_steps(torch, "train HR", step_ms, batch, smi)
    print(f"train HR launches over {len(batches)} steps: {launches}")
    check_trunk_launches("train HR", launches, batch * len(batches),
                         len(gbase.g2d.trunk_names))
    n_moved, stats_moved, n_stats = moved(torch, genh, genh_before)
    print(f"train HR: {n_moved} of {len(genh_before) - n_stats} Genh parameters and "
          f"{stats_moved} of {n_stats} BatchNorm statistics moved; Gbase and VGG19 bit "
          f"for bit: {same_state(torch, gbase, gbase_before)}, {same_state(torch, ploss, ploss_before)}")
    check(n_moved > 0 and stats_moved > 0, "Genh or its statistics did not move")
    check(same_state(torch, gbase, gbase_before), "the frozen Gbase changed")
    check(same_state(torch, ploss, ploss_before), "the VGG19 loss net changed")
    del batches

    with tempfile.TemporaryDirectory() as directory:
        check(CheckpointManager(directory).save(state.step, {"genh": state}),
              "CheckpointManager refused the save")
        size_mb = sum(f.stat().st_size for f in Path(directory).rglob("*")
                      if f.is_file()) / 1e6
        genh2, _, state2 = init_hr_state(cfg, seed=2, policy=policy, image_size=size,
                                         device=dev)
        CheckpointManager(directory).restore({"genh": state2})
    same_model = all(torch.equal(v, genh2.state_dict()[k])
                     for k, v in genh.state_dict().items())
    same_adamw = all(
        state.tx.adamw.state[p].keys() == state2.tx.adamw.state[q].keys()
        and all(torch.equal(v, state2.tx.adamw.state[q][k])
                for k, v in state.tx.adamw.state[p].items())
        for p, q in zip(state.params, state2.params, strict=True))
    same_count = (state.tx.schedule.last_epoch == state2.tx.schedule.last_epoch
                  and state.step == state2.step)
    x = smooth_image(torch, gen, dev, 2 * size)
    genh.eval()
    genh2.eval()
    with torch.no_grad():
        frame_diff = (genh(x) - genh2(x)).abs().max().item()
    print(f"checkpoint round trip ({size_mb:.1f} MB at step {state.step}): parameters "
          f"and buffers bit for bit {same_model}, AdamW state {same_adamw}, schedule and "
          f"step {same_count}; one Genh frame max abs {frame_diff:.3g} (limit 1e-6)")
    check(same_model and same_adamw and same_count, "the restored state differs")
    check(frame_diff <= 1e-6, f"the restored Genh's frame differs by {frame_diff}")
    return dict(ms=ms, peak=peak, launches=launches)


def phase_train_student(torch, dev, smi, arch="full", size=STUDENT_TRAIN["size"],
                        batch=STUDENT_TRAIN["batch"], policy=None):
    """Stage-3 training: init_student_state + make_student_train_step at
    `arch`, `size`, `batch`, stage3-student.yaml's lr and avatars; the
    inline GHR teacher with calibrated BatchNorms, its trunk on K2. 1
    warm-up and TRAIN_STEPS timed steps: K2 `batch` times a step, the
    Student and its statistics moved, the teacher bit for bit. Then
    make_teacher_forward once in each mode ('running': K2 `batch` times;
    'batch': no K2, no statistic changed; include_enh=False: in [0, 1]),
    and one step on a batch that carries 'target01' (no teacher, no
    kernel)."""
    from megaportraits_tpu_torch.core.dtypes import DEFAULT_POLICY
    from megaportraits_tpu_torch.models.gbase import calibrate_batch_norm
    from megaportraits_tpu_torch.models.genh import build_ghr
    from megaportraits_tpu_torch.nn.layers import calibrate_batch_norm_with
    from megaportraits_tpu_torch.train.train_student import (
        init_student_state,
        make_student_train_step,
        make_teacher_forward,
    )

    policy = policy or DEFAULT_POLICY
    avatars = STUDENT_TRAIN["avatars"]
    cfg = stage_config(arch, STUDENT_TRAIN["lr"], avatars)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)

    def images(n):
        return torch.cat([smooth_image(torch, gen, dev, size) for _ in range(n)])

    teacher = build_ghr(arch, policy=policy, device=dev, seed=2)
    xs, xd = images(1), images(1)
    n_bn = calibrate_batch_norm(teacher.gbase, xs, xd)
    n_bn += calibrate_batch_norm_with(
        teacher.genh, lambda: teacher.genh(teacher.gbase.generate(xs, xd), train=True))
    teacher.requires_grad_(False)
    student, state = init_student_state(cfg, seed=3, policy=policy, image_size=size,
                                        device=dev)
    index = torch.arange(batch, device=dev) % avatars
    batches = [{"source": images(batch), "driving": images(batch), "avatar_index": index}
               for _ in range(1 + TRAIN_STEPS)]
    teacher_before, student_before = state_copy(teacher, student)
    trunk_blocks = len(teacher.gbase.g2d.trunk_names)
    print(f"train Student: {arch.upper()} at {size}x{size}, batch {batch}, {avatars} "
          f"avatars, Student {sum(p.numel() for p in student.parameters())} parameters, "
          f"GHR teacher {sum(p.numel() for p in teacher.parameters())} ({n_bn} "
          f"BatchNorms calibrated, trunk on K2); lr {cfg.training.lr}, "
          f"{cfg.training.student_epochs} steps in the schedule; set-up "
          f"{time.perf_counter() - t0:.1f} s")

    step = make_student_train_step(student, teacher, cfg)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    state, step_ms = timed_steps(torch, step, state, batches, "train Student")
    launches = counts()
    ms, peak = report_steps(torch, "train Student", step_ms, batch, smi)
    print(f"train Student launches over {len(batches)} steps (teacher inline): {launches}")
    check_trunk_launches("train Student", launches, batch * len(batches), trunk_blocks)
    n_moved, stats_moved, n_stats = moved(torch, student, student_before)
    print(f"train Student: {n_moved} of {len(student_before) - n_stats} parameters and "
          f"{stats_moved} of {n_stats} BatchNorm statistics moved; the teacher bit for "
          f"bit: {same_state(torch, teacher, teacher_before)}")
    check(n_moved > 0 and stats_moved > 0, "the Student or its statistics did not move")
    check(same_state(torch, teacher, teacher_before), "the teacher changed in the steps")

    b = batches[-1]
    total = dict(launches)
    targets = {}
    for include_enh, bn_mode in ((True, "running"), (True, "batch"), (False, "running")):
        reset_counts()
        out = make_teacher_forward(teacher, include_enh, bn_mode)(b["source"], b["driving"])
        torch.cuda.synchronize()
        got = counts()
        total = {k: total[k] + got[k] for k in total}
        k2_calls = batch if bn_mode == "running" else 0
        print(f"teacher forward include_enh={include_enh} bn_mode={bn_mode}: launches "
              f"{got}; output [{out.min().item():.4f}, {out.max().item():.4f}], mean "
              f"{out.mean().item():.5f}, std {out.std().item():.5f}")
        check_trunk_launches(f"teacher forward {bn_mode}", got, k2_calls, trunk_blocks)
        check(tuple(out.shape) == (batch, size, size, 3) and out.dtype == torch.float32,
              f"teacher target {tuple(out.shape)} {out.dtype}")
        check(torch.isfinite(out).all().item(), "teacher target not finite")
        check(out.min().item() >= 0.0 and out.max().item() <= 1.0,
              "teacher target outside [0, 1]")
        check(same_state(torch, teacher, teacher_before),
              f"the teacher changed in bn_mode={bn_mode}")
        targets[(include_enh, bn_mode)] = out
    check(not torch.equal(targets[(True, "running")], targets[(True, "batch")]),
          "the two bn_modes give the same target")

    reset_counts()
    given = {"driving": b["driving"], "avatar_index": index,
             "target01": targets[(True, "running")]}
    state, metrics = step(state, given)
    got = counts()
    print(f"train Student step with target01: loss_student "
          f"{metrics['loss_student'].item():.6g}, launches {got}")
    check(math.isfinite(metrics["loss_student"].item()), "loss_student not finite")
    check_trunk_launches("train Student with target01", got, 0, trunk_blocks)
    return dict(ms=ms, peak=peak, launches=total)


# The drivers (train/main_*.py) on 2 clips of DRIVER_FRAMES smooth frames,
# written straight into EMODataset's npz cache (the card's machine has no cv2
# to decode mp4s), each run as `python -m megaportraits_tpu_torch <command>
# --config <yaml>` in this process, on a YAML file written here as text.
DRIVER_CLIPS = 2
DRIVER_FRAMES = 6
DRIVER_STEPS = 4
DRIVER_RESUMED_STEPS = 6
DRIVER_HOLDOUT = 2
# The model and training keys of every YAML file this script writes (a CPU
# rehearsal adds arch tiny and use_bf16 false).
DRIVER_MODEL = {}
DRIVER_TRAINING = {}


def write_clips(torch, dev, directory, sizes):
    """The npz caches of DRIVER_CLIPS clips at each of `sizes`, and the clip
    list (meta.json)."""
    import numpy as np

    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    ids = [f"clip{i}" for i in range(DRIVER_CLIPS)]
    for vid in ids:
        for size in sizes:
            frames = {k: torch.cat([smooth_image(torch, gen, dev, size)
                                    for _ in range(DRIVER_FRAMES)]).cpu().numpy()
                      for k in ("source_frames", "driving_frames")}
            np.savez(directory / f"{vid}_{size}x{size}_tensors.npz", **frames)
    (directory / "meta.json").write_text(json.dumps({"clips": {vid: {} for vid in ids}}))


def yaml_scalar(value):
    """`value` as YAML text that PyYAML and the port read back as `value`:
    a float always with a dot ('1e-05' would be a string), a dict as a
    flow mapping, a string single-quoted."""
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        mantissa, e, exponent = repr(value).partition("e")
        if "." not in mantissa:
            mantissa += ".0"
        return mantissa + e + exponent
    if isinstance(value, dict):
        return "{" + ", ".join(f"{k}: {yaml_scalar(v)}" for k, v in value.items()) + "}"
    return "'" + str(value).replace("'", "''") + "'"


def write_yaml(path, sections):
    """A config file of {section: {key: value}}, as a user writes one."""
    lines = ["# written by chip_smoke.py"]
    for name, body in sections.items():
        lines.append(f"{name}:")
        lines.extend(f"  {k}: {yaml_scalar(v)}" for k, v in body.items())
    Path(path).write_text("\n".join(lines) + "\n")
    return str(path)


def driver_yaml(work, name, batch=TRAIN_BATCH, size=None, **training):
    """work/<name>.yaml: FULL at `size` (TRAIN_SIZE by default), the
    drivers' own defaults otherwise; clips from work/clips, checkpoints in
    work/<name>."""
    size = size or TRAIN_SIZE
    return write_yaml(work / f"{name}.yaml", {
        "data": {"train_width": size, "train_height": size},
        "model": dict(DRIVER_MODEL),
        "training": {"video_dir": str(work / "clips"),
                     "json_file": str(work / "clips" / "meta.json"),
                     "checkpoint_path": str(work / name), "batch_size": batch,
                     "n_sample_frames": DRIVER_FRAMES, **DRIVER_TRAINING, **training}})


def run_command(argv, module=None, fn=None):
    """``python -m megaportraits_tpu_torch <argv>`` in this process (its
    rc must be 0). With `module` and `fn`, what module.fn returned inside
    it (a driver's last metrics)."""
    from megaportraits_tpu_torch.__main__ import main as cli

    results, patches = [], {}
    if fn is not None:
        inner = getattr(module, fn)

        def recording(*args, **kwargs):
            results.append(inner(*args, **kwargs))
            return results[-1]

        patches[fn] = recording
    argv_before = sys.argv[:]
    try:
        with Patched(module or sys, **patches):
            rc = cli([str(a) for a in argv])
    finally:
        sys.argv = argv_before
    check(rc == 0, f"'{' '.join(map(str, argv))}' returned {rc}")
    return results[-1] if results else None


class Patched:
    """Set module attributes for the length of a `with`, then put back the
    originals."""

    def __init__(self, module, **attrs):
        self.module, self.attrs, self.saved = module, attrs, {}

    def __enter__(self):
        for k, v in self.attrs.items():
            self.saved[k] = getattr(self.module, k)
            setattr(self.module, k, v)
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            setattr(self.module, k, v)


class PrefetchProbe:
    """Wraps a driver's prefetch_to_device: the time the driver waited on
    each batch (the consumer's next()), the bytes of each batch (what went
    host-to-device), the time of the first request."""

    def __init__(self, prefetch):
        self.prefetch = prefetch
        self.waits, self.bytes, self.first = [], 0, None

    def __call__(self, iterator, **kwargs):
        from megaportraits_tpu_torch.data.prefetch import map_leaves

        inner = self.prefetch(iterator, **kwargs)

        def probed():
            try:
                while True:
                    t0 = time.perf_counter()
                    if self.first is None:
                        self.first = t0
                    try:
                        batch = next(inner)
                    except StopIteration:
                        return
                    self.waits.append(time.perf_counter() - t0)
                    sizes = []
                    map_leaves(lambda t: sizes.append(t.numel() * t.element_size()), batch)
                    self.bytes += sum(sizes)
                    yield batch
            finally:
                inner.close()

        return probed()


class Tee:
    """stdout that is also kept, so that a driver's lines can be checked."""

    def __init__(self, out):
        self.out, self.text = out, []

    def write(self, s):
        self.text.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def timed(torch, cls, method, calls):
    """A subclass of `cls` whose `method` appends (the instance, its
    host-clock seconds) to `calls`, timed after the card has finished what
    was queued before the call (the method would wait for it anyway: it
    reads the weights back)."""

    def call(self, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = getattr(cls, method)(self, *args, **kwargs)
        calls.append((self, time.perf_counter() - t0))
        return out

    return type(cls.__name__, (cls,), {method: call})


def run_driver(torch, module, fn, steps):
    """fn() with module.prefetch_to_device probed, the checkpoint saves and
    the held-out evaluations timed (the evaluators kept), launch counts
    zeroed, peak memory reset and stdout kept. Returns (result, numbers)."""
    import contextlib

    probe = PrefetchProbe(module.prefetch_to_device)
    tee = Tee(sys.stdout)
    saves, evals = [], []
    patches = dict(prefetch_to_device=probe, CheckpointManager=timed(
        torch, module.CheckpointManager, "save", saves))
    if hasattr(module, "HeldoutEvaluator"):
        patches["HeldoutEvaluator"] = timed(torch, module.HeldoutEvaluator, "consider",
                                            evals)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with Patched(module, **patches), contextlib.redirect_stdout(tee):
        out = fn()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    check(probe.first is not None and probe.waits, "the driver took no batch")
    return out, dict(
        launches=counts(), peak=torch.cuda.max_memory_allocated(), text="".join(tee.text),
        setup_s=probe.first - t0, loop_s=t1 - probe.first, steps=steps,
        batches=len(probe.waits), wait_ms=[w * 1e3 for w in probe.waits],
        bytes=probe.bytes, save_ms=[x * 1e3 for _, x in saves],
        eval_ms=[x * 1e3 for _, x in evals],
        evaluators=list({id(e): e for e, _ in evals}.values()))


def report_driver(name, n, bare_ms, smi):
    """Print a driver's host-clock rate beside the bare step's CUDA-event
    time: the gap is data, prefetch, logging, evaluation and saving (the
    saves, exports included, and the evaluations are timed apart)."""
    steps = n["steps"]
    per_step = n["loop_s"] * 1e3 / steps
    waits, saves, evals = n["wait_ms"], n["save_ms"], n["eval_ms"]
    print(f"{name}: {steps} steps in {n['loop_s']:.3f} s from the first batch "
          f"request to the return (host clock) = {steps / n['loop_s']:.3f} steps/s, "
          f"{per_step:.3f} ms/step; the bare step {bare_ms:.3f} ms (CUDA events, "
          f"phase above), gap {per_step - bare_ms:.3f} ms/step: saving "
          f"{sum(saves) / steps:.3f} ms/step ({len(saves)} saves, ms "
          f"{[round(x, 1) for x in saves]}), evaluating {sum(evals) / steps:.3f} ms/step "
          f"({[round(x, 1) for x in evals]}), prefetch wait {sum(waits) / steps:.3f} "
          f"ms/step (first batch {waits[0]:.3f} ms, then {[round(w, 3) for w in waits[1:]]}); "
          f"set-up {n['setup_s']:.3f} s; host-to-device {n['bytes'] / steps / 2 ** 20:.3f} "
          f"MiB/step over {n['batches']} batches; peak memory {n['peak'] / 2 ** 30:.2f} GiB "
          f"(max_memory_allocated) | {smi}")


def step_dirs(path):
    return sorted(int(p.name) for p in Path(path).iterdir() if p.name.isdigit())


def same_weights(torch, module, state_dict):
    got = module.state_dict()
    return got.keys() == state_dict.keys() and all(
        torch.equal(v.cpu(), state_dict[k]) for k, v in got.items())


def phase_driver_base(torch, dev, smi, work, bare_ms):
    """Stage-1 driver: train_base at FULL 512x512, batch 2, unroll 2,
    evaluation every 2 steps on DRIVER_HOLDOUT tail frames of each clip,
    DRIVER_STEPS steps; then a second call to DRIVER_RESUMED_STEPS at unroll
    1 that must resume from step DRIVER_STEPS and write the debug PNG. No K1,
    K2 or K3 in either call (train mode and batch-statistics evaluation
    bypass them). The export restores into a fresh Gbase bit for bit equal
    to the evaluator's best snapshot; 2 frames served from it with K2."""
    from megaportraits_tpu_torch.core.config import load_config
    from megaportraits_tpu_torch.infer.inference import restore_gbase
    from megaportraits_tpu_torch.infer.streaming import ReenactmentSession
    from megaportraits_tpu_torch.train import main_base

    numbers, evaluators = [], []
    for unroll, max_steps, start in ((2, DRIVER_STEPS, 0),
                                     (1, DRIVER_RESUMED_STEPS, DRIVER_STEPS)):
        path = driver_yaml(work, "base", unroll_steps=unroll, save_interval=2,
                           log_interval=2, eval_interval=2, holdout_frames=DRIVER_HOLDOUT)
        argv = ["train-base", "--config", path, "--max-steps", max_steps, "--device", dev]
        metrics, n = run_driver(torch, main_base, lambda: run_command(
            argv, main_base, "train_base"), max_steps - start)
        numbers.append(n)
        evaluators.extend(n["evaluators"])
        print(f"driver stage 1 (unroll {unroll}, to step {max_steps}): launches "
              f"{n['launches']}, last metrics {metrics}")
        check(all(v == 0 for v in n["launches"].values()),
              f"kernels launched in the stage-1 driver: {n['launches']}")
        check(all(math.isfinite(v) for v in metrics.values()), f"metrics {metrics}")
        check(n["batches"] == (max_steps - start) // unroll,
              f"{n['batches']} batches for {max_steps - start} steps at unroll {unroll}")
    resumed = f"Resumed from checkpoint step {DRIVER_STEPS}"
    check(resumed in numbers[1]["text"], f"the second call did not print '{resumed}'")
    check(step_dirs(work / "base") == [2, 4, 6], f"checkpoints {step_dirs(work / 'base')}")
    png = Path("output_images") / f"pred_frame_{DRIVER_RESUMED_STEPS}.png"
    check(png.is_file() and png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n",
          f"no debug PNG at {png}")
    check(len(evaluators) == 2 and all(e.n_pairs == DRIVER_CLIPS * DRIVER_HOLDOUT
                                       for e in evaluators), "held-out pairs")
    best = evaluators[-1]
    check(best.best_variables is not None, "the resumed run kept no snapshot")
    exports = step_dirs(work / "base" / "export")
    for i, n in enumerate(numbers):
        report_driver(f"driver stage 1, call {i + 1}", n, bare_ms, smi)

    gbase = load_config(str(work / "base.yaml")).make_gbase(device=dev, seed=99)
    check(restore_gbase(gbase, [str(work / "base" / "export")]), "no stage-1 export")
    same = same_weights(torch, gbase, best.best_variables)
    print(f"driver stage 1: exports at steps {exports}; the latest restored into a fresh "
          f"Gbase equals the evaluator's best snapshot (step {best.best_step}, "
          f"{best.best_psnr:.3f} dB) bit for bit: {same}; {png} written")
    check(same, "the stage-1 export differs from the best snapshot")
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    session = ReenactmentSession(model=gbase, bn_mode="running")
    reset_counts()
    session.set_source(smooth_image(torch, gen, dev, TRAIN_SIZE))
    outs = [session(smooth_image(torch, gen, dev, TRAIN_SIZE)) for _ in range(SERVE_FRAMES)]
    served = counts()
    print(f"driver stage 1: {SERVE_FRAMES} frames served from the export, launches {served}")
    check_trunk_launches("serving the stage-1 export", served, SERVE_FRAMES,
                         len(gbase.g2d.trunk_names))
    for out in outs:
        check(tuple(out.shape) == (1, TRAIN_SIZE, TRAIN_SIZE, 3)
              and torch.isfinite(out).all().item(), "a served frame")
    return dict(launches=served, best=best.best_variables)


def phase_driver_hr(torch, dev, smi, work, bare_ms, gbase_export):
    """Stage-2 driver: train_hr, FULL, base 512 with Genh at 1024, batch 2,
    DRIVER_STEPS steps, evaluation every 2, the frozen Gbase restored from
    the stage-1 export (its trunk on K2). K2 twice a step plus once a row of
    every evaluated batch (padded rows included); the genh_variables export
    restores into a fresh Genh bit for bit equal to the best snapshot."""
    from megaportraits_tpu_torch.core.checkpoint import CheckpointManager
    from megaportraits_tpu_torch.core.config import load_config
    from megaportraits_tpu_torch.models.genh import build_genh
    from megaportraits_tpu_torch.train import main_hr

    path = driver_yaml(work, "hr", save_interval=2, log_interval=2, eval_interval=2,
                       holdout_frames=DRIVER_HOLDOUT, lr=HR_TRAIN["lr"])
    cfg = load_config(path)
    frozen = []
    build_step = main_hr.make_hr_train_step

    def keeping_gbase(genh, gbase, *args, **kwargs):
        frozen.append(gbase)
        return build_step(genh, gbase, *args, **kwargs)

    with Patched(main_hr, make_hr_train_step=keeping_gbase):
        metrics, n = run_driver(torch, main_hr, lambda: run_command(
            ["train-hr", "--config", path, "--max-steps", DRIVER_STEPS, "--gbase-ckpt",
             work / "base", "--device", dev], main_hr, "train_hr"), DRIVER_STEPS)
    (ev,) = n["evaluators"]
    evals = DRIVER_STEPS // 2
    rows = -(-ev.n_pairs // ev.batch_size) * ev.batch_size
    k2_calls = HR_TRAIN["batch"] * DRIVER_STEPS + evals * rows
    print(f"driver stage 2: launches {n['launches']}; K2 expected {k2_calls} = "
          f"{HR_TRAIN['batch']} a step x {DRIVER_STEPS} + {evals} evaluations x {rows} rows "
          f"({ev.n_pairs} pairs in batches of {ev.batch_size}); last metrics {metrics}")
    check(all(math.isfinite(v) for v in metrics.values()), f"metrics {metrics}")
    check_trunk_launches("driver stage 2", n["launches"], k2_calls,
                         len(frozen[0].g2d.trunk_names))
    check(same_weights(torch, frozen[0], gbase_export),
          "the frozen Gbase is not the stage-1 export")
    check(step_dirs(work / "hr") == [2, 4], f"checkpoints {step_dirs(work / 'hr')}")
    genh = build_genh(cfg.make_arch(), device=dev, seed=98)
    restored = CheckpointManager(str(work / "hr" / "export")).restore({"genh_variables": genh})
    same = restored is not None and same_weights(torch, genh, ev.best_variables)
    print(f"driver stage 2: the frozen Gbase is the stage-1 export bit for bit; exports "
          f"at {step_dirs(work / 'hr' / 'export')}, restored into a fresh Genh equal to "
          f"the best snapshot (step {ev.best_step}, {ev.best_psnr:.3f} dB) bit for bit: "
          f"{same}")
    check(same, "the stage-2 export differs from the best snapshot")
    report_driver("driver stage 2", n, bare_ms, smi)
    return dict(launches=n["launches"])


def keeping_teacher(main_student, teachers):
    """main_student.make_student_train_step that also keeps its teacher, so
    that it can be checked after the driver returns."""
    build_step = main_student.make_student_train_step

    def keep(student, teacher, *args, **kwargs):
        teachers.append(teacher)
        return build_step(student, teacher, *args, **kwargs)

    return keep


def phase_driver_student(torch, dev, smi, work, bare_ms):
    """Stage-3 driver: train_student, FULL, 512, batch 4, 4 avatars,
    DRIVER_STEPS steps; the teacher restored from a {"ghr_variables"}
    checkpoint written here from the stage-1 and stage-2 exports, its
    trunk on K2 (eval, bf16, no autograd). K2 4 times a step;
    the teacher bit for bit as saved, before and after the steps."""
    from megaportraits_tpu_torch.core.checkpoint import CheckpointManager
    from megaportraits_tpu_torch.infer.inference import restore_gbase
    from megaportraits_tpu_torch.models.genh import build_ghr
    from megaportraits_tpu_torch.train import main_student

    ghr = build_ghr(DRIVER_MODEL.get("arch", "full"), device=dev, seed=2)
    check(restore_gbase(ghr.gbase, [str(work / "base" / "export")]), "no stage-1 export")
    check(CheckpointManager(str(work / "hr" / "export")).restore(
        {"genh_variables": ghr.genh}) is not None, "no stage-2 export")
    check(CheckpointManager(str(work / "teacher")).save(0, {"ghr_variables": ghr}),
          "the teacher was not saved")
    saved = {k: v.detach().cpu().clone() for k, v in ghr.state_dict().items()}
    del ghr

    path = driver_yaml(work, "student", batch=STUDENT_TRAIN["batch"], save_interval=2,
                       log_interval=2, lr=STUDENT_TRAIN["lr"],
                       num_avatars=STUDENT_TRAIN["avatars"])
    teachers = []
    with Patched(main_student,
                 make_student_train_step=keeping_teacher(main_student, teachers)):
        metrics, n = run_driver(torch, main_student, lambda: run_command(
            ["train-student", "--config", path, "--max-steps", DRIVER_STEPS,
             "--teacher-ckpt", work / "teacher", "--device", dev],
            main_student, "train_student"), DRIVER_STEPS)
    (teacher,) = teachers
    k2_calls = STUDENT_TRAIN["batch"] * DRIVER_STEPS
    same = same_weights(torch, teacher, saved)
    print(f"driver stage 3: launches {n['launches']}, K2 expected {k2_calls}; the teacher "
          f"is the saved ghr_variables bit for bit after the steps: {same}; last metrics "
          f"{metrics}")
    check(all(math.isfinite(v) for v in metrics.values()), f"metrics {metrics}")
    check_trunk_launches("driver stage 3", n["launches"], k2_calls,
                         len(teacher.gbase.g2d.trunk_names))
    check(same, "the teacher differs from its checkpoint")
    check(step_dirs(work / "student") == [2, 4], f"checkpoints {step_dirs(work / 'student')}")
    report_driver("driver stage 3", n, bare_ms, smi)
    return dict(launches=n["launches"])


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def param_gap(torch, a, b):
    """The largest absolute difference between two lists of tensors."""
    return max((x - y).abs().max().item() for x, y in zip(a, b, strict=True))


def phase_distributed(torch, dev, smi, work, arch="full", size=TRAIN_SIZE,
                      batch=TRAIN_BATCH, policy=None, student_batch=STUDENT_TRAIN["batch"],
                      driver_steps=2):
    """The data-parallel path on the card: an in-process process group of
    one rank (NCCL; gloo on the CPU) and the mesh over it.

    The stage-1 step (`arch`, `size`, `batch`, seeded) from one state: two
    plain steps, then the step through the data-parallel path (the models
    broadcast from rank 0, BatchNorm and the cycle loss reducing over the
    data group, the optimisers all-reducing the gradients, the metrics
    averaged). Its gap to the first plain step (metrics, relative;
    parameters, absolute) must be no larger than twice the gap between the
    two plain steps, the card's run-to-run noise (nondeterministic backward
    kernels), and zero when that is zero. Then DIST_TIMED_STEPS more steps
    of each in turns (the overhead of the data-parallel path at world size
    1, and its all-reduces a step counted). Then the stage-3 driver for
    `driver_steps` steps under the group (mesh_shape {data: 1}), the teacher
    of work/teacher with its trunk on K2 (student_batch launches a step);
    its checkpoint restores into a plain state bit for bit."""
    import torch.distributed as dist

    from megaportraits_tpu_torch.core.checkpoint import CheckpointManager
    from megaportraits_tpu_torch.core.config import Config, load_config
    from megaportraits_tpu_torch.core.dtypes import DEFAULT_POLICY
    from megaportraits_tpu_torch.parallel.mesh import make_mesh
    from megaportraits_tpu_torch.train import main_student
    from megaportraits_tpu_torch.train.state import TrainState, make_optimizer
    from megaportraits_tpu_torch.train.train_base import init_states, make_train_step
    from megaportraits_tpu_torch.train.train_student import init_student_state

    policy = policy or DEFAULT_POLICY
    backend = "nccl" if dev.type == "cuda" else "gloo"
    t0 = time.perf_counter()
    dist.init_process_group(backend, init_method=f"tcp://localhost:{free_port()}",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh({"data": 1}, device=dev)
        print(f"distributed: {backend} group of {dist.get_world_size()} rank, mesh "
              f"{dict(zip(mesh.mesh_dim_names, mesh.shape))} in "
              f"{time.perf_counter() - t0:.2f} s")
        check(mesh is not None and mesh.mesh_dim_names == ("data", "model"),
              "no mesh over the group")
        cfg = Config()
        cfg.model.arch = arch
        cfg.training.steps_per_epoch = 1
        gen = torch.Generator(device=dev)
        gen.manual_seed(6)
        b = {k: torch.cat([smooth_image(torch, gen, dev, size) for _ in range(batch)])
             for k in TRAIN_IMAGES}
        gbase, disc, ploss, g_state, d_state = init_states(cfg, seed=0, policy=policy,
                                                           device=dev)
        start = state_copy(gbase, disc)
        total = cfg.training.base_epochs

        def run(gbase, disc, ploss, g_state, d_state, step_mesh):
            gbase.load_state_dict(start[0])
            disc.load_state_dict(start[1])
            if g_state is None:
                g_state = TrainState(gbase, make_optimizer(gbase, cfg.training.lr, total))
                d_state = TrainState(disc, make_optimizer(disc, cfg.training.lr, total))
            (_, _, metrics, _), ms = cuda_timed(torch, lambda: make_train_step(
                ploss, cfg, mesh=step_mesh)(g_state, d_state, b))
            params = [p.detach().clone() for m in (gbase, disc) for p in m.parameters()]
            return {k: v.item() for k, v in metrics.items()}, params, ms

        plain = [run(gbase, disc, ploss, None, None, None) for _ in range(2)]
        parts = init_states(cfg, seed=0, policy=policy, device=dev, mesh=mesh)
        calls = []
        all_reduce = dist.all_reduce
        with Patched(dist, all_reduce=lambda *a, **k: calls.append(1) or all_reduce(*a, **k)):
            dp = run(*parts, mesh)

        def metric_gap(a, b):
            return max(abs(v - b[k]) / max(abs(b[k]), 1e-6) for k, v in a.items())

        gaps = dict(plain_metrics=metric_gap(plain[1][0], plain[0][0]),
                    dp_metrics=metric_gap(dp[0], plain[0][0]),
                    plain_params=param_gap(torch, plain[1][1], plain[0][1]),
                    dp_params=param_gap(torch, dp[1], plain[0][1]))
        print(f"distributed step ({arch.upper()} {size}x{size}, batch {batch}): plain "
              f"{plain[0][2]:.3f} and {plain[1][2]:.3f} ms, data-parallel {dp[2]:.3f} ms "
              f"(CUDA events, one step each, the first of its models); gaps to the first "
              f"plain step: the second plain step metrics {gaps['plain_metrics']:.3g} "
              f"relative, parameters {gaps['plain_params']:.3g} absolute; the "
              f"data-parallel step metrics {gaps['dp_metrics']:.3g}, parameters "
              f"{gaps['dp_params']:.3g} | {smi}")
        for kind in ("metrics", "params"):
            check(gaps[f"dp_{kind}"] <= 2 * gaps[f"plain_{kind}"],
                  f"the data-parallel step's {kind} are {gaps[f'dp_{kind}']:.3g} from the "
                  f"plain step's, two plain steps {gaps[f'plain_{kind}']:.3g}")
        # The overhead: steps of both in turns (plain, data-parallel, ...),
        # each set of models going on from its own state.
        steps = {"plain": (make_train_step(ploss, cfg), g_state, d_state),
                 "data-parallel": (make_train_step(parts[2], cfg, mesh=mesh), *parts[3:])}
        turns = {name: [] for name in steps}
        for _ in range(DIST_TIMED_STEPS):
            for name, (step, g, d) in steps.items():
                turns[name].append(cuda_timed(torch, lambda: step(g, d, b))[1])
        medians = {name: statistics.median(ms) for name, ms in turns.items()}
        print(f"distributed step overhead at world size 1: plain "
              f"{medians['plain']:.3f} ms/step, data-parallel {medians['data-parallel']:.3f} "
              f"ms/step (medians of {DIST_TIMED_STEPS} in turns; samples "
              f"{ {k: [round(x, 3) for x in v] for k, v in turns.items()} }) = "
              f"{medians['data-parallel'] - medians['plain']:+.3f} ms; {len(calls)} "
              f"all-reduces in one data-parallel step | {smi}")
        del gbase, disc, ploss, g_state, d_state, parts, steps, plain, dp
        torch.cuda.empty_cache()

        path = driver_yaml(work, "student_dp", batch=student_batch, size=size,
                           save_interval=2, log_interval=1, lr=STUDENT_TRAIN["lr"],
                           num_avatars=STUDENT_TRAIN["avatars"], mesh_shape={"data": 1})
        cfg = load_config(path)
        teachers = []
        with Patched(main_student,
                     make_student_train_step=keeping_teacher(main_student, teachers)):
            metrics, n = run_driver(torch, main_student, lambda: run_command(
                ["train-student", "--config", path, "--max-steps", driver_steps,
                 "--teacher-ckpt", work / "teacher", "--device", dev],
                main_student, "train_student"), driver_steps)
        (teacher,) = teachers
        k2_calls = student_batch * driver_steps
        print(f"distributed driver stage 3 ({driver_steps} steps under the group): "
              f"launches {n['launches']}, K2 expected {k2_calls}; last metrics {metrics}; "
              f"{n['loop_s'] * 1e3 / driver_steps:.3f} ms/step on the host clock; peak "
              f"{n['peak'] / 2 ** 30:.2f} GiB | {smi}")
        check(all(math.isfinite(v) for v in metrics.values()), f"metrics {metrics}")
        check_trunk_launches("distributed driver stage 3", n["launches"], k2_calls,
                             len(teacher.gbase.g2d.trunk_names))
        check(step_dirs(work / "student_dp") == [driver_steps],
              f"checkpoints {step_dirs(work / 'student_dp')}")
    finally:
        dist.destroy_process_group()

    saved = torch.load(work / "student_dp" / str(driver_steps) / "checkpoint.pt",
                       map_location="cpu", weights_only=True)["student"]
    _, state = init_student_state(cfg, seed=1, policy=policy, image_size=size,
                                  device=dev)
    CheckpointManager(str(work / "student_dp")).restore({"student": state})
    same = same_weights(torch, state.model, saved["model"])
    moments = state.tx.state_dict()["adamw"]["state"]
    same_moments = all(torch.equal(moments[i][k].cpu(), v)
                       for i, m in saved["adamw"]["state"].items() for k, v in m.items())
    print(f"distributed checkpoint restored into a plain Student: weights bit for bit "
          f"{same}, AdamW state bit for bit {same_moments}, step {state.step}")
    check(same and same_moments and state.step == driver_steps,
          "the distributed checkpoint does not restore bit for bit")
    return dict(launches=n["launches"], gaps=gaps)


# phase_cli: the serving commands from YAML files, at FULL width.
CLI_FRAMES = 8
CLI_FLAT_LEVELS = 2.0  # an output whose pixels' std is below this many levels is flat
CLI_SESSION_LEVELS = 1  # reenact's frames against the session's, in levels (1/255)


HOST_LIBRARIES = ("yaml", "PIL", "cv2")  # what the port's commands must not need

# A fresh interpreter writes, with PIL, the files a user's tools write that
# the port's readers must take as PIL does (a progressive JPEG at 512 and
# 1024, a palette PNG, a 16-bit gray PNG), and PIL's convert("RGB") of each
# as .npy beside it; this process never imports PIL.
PIL_INPUTS = r"""
import sys
import numpy as np
import PIL
from PIL import Image
d = sys.argv[1]
src, drv = np.load(d + "/source.npy"), np.load(d + "/driving.npy")
big = np.repeat(np.repeat(src, 2, axis=0), 2, axis=1)
Image.fromarray(src).save(d + "/source_progressive.jpg", progressive=True, quality=90,
                          optimize=True)
Image.fromarray(big).save(d + "/big_progressive.jpg", progressive=True, quality=90,
                          optimize=True)
Image.fromarray(drv).convert("P", palette=Image.ADAPTIVE, colors=256).save(
    d + "/driving_palette.png")
Image.fromarray((src[..., 0].astype(np.uint16) * 3)).save(d + "/gray16.png")
for name in ("source_progressive.jpg", "big_progressive.jpg", "driving_palette.png",
             "gray16.png"):
    im = Image.open(d + "/" + name)
    np.save(d + "/" + name + ".npy", np.asarray(im.convert("RGB")))
    print(name, im.mode, im.size)
print("PIL", PIL.__version__)
"""


class Blocked:
    """For the length of a `with`, an import of any of `names` raises
    ImportError (sys.modules holds None for it), whether or not it is
    installed; what was there before is put back."""

    def __init__(self, names=HOST_LIBRARIES):
        self.names, self.saved = names, {}

    def __enter__(self):
        for name in self.names:
            self.saved[name] = sys.modules.get(name)
            sys.modules[name] = None
        return self

    def __exit__(self, *exc):
        for name, module in self.saved.items():
            if module is None:
                del sys.modules[name]
            else:
                sys.modules[name] = module


class Stopwatch:
    """Host-clock seconds by label of the wrapped calls, each taken between
    two synchronises of the card, so that a label owns the device work it
    queued."""

    def __init__(self, torch, dev):
        self.sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
        self.seconds = {}

    def wrap(self, label, fn):
        def timed(*args, **kwargs):
            self.sync()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            self.sync()
            self.seconds[label] = self.seconds.get(label, 0.0) + time.perf_counter() - t0
            return out
        return timed

    def patches(self, owner, labels):
        """{attribute: timed attribute} for Patched(owner, ...)."""
        return {name: self.wrap(label, getattr(owner, name)) for name, label in labels.items()}


def timed_command(torch, dev, argv, patch_sets):
    """run_command(argv) with the calls of `patch_sets` [(owner, {attribute:
    label})] timed; returns (seconds by label, total seconds, launches)."""
    import contextlib

    watch = Stopwatch(torch, dev)
    reset_counts()
    with contextlib.ExitStack() as stack:
        for owner, labels in patch_sets:
            stack.enter_context(Patched(owner, **watch.patches(owner, labels)))
        watch.sync()
        t0 = time.perf_counter()
        with Blocked():
            run_command(argv)
        watch.sync()
        total = time.perf_counter() - t0
    return watch.seconds, total, counts()


def report_command(name, seconds, total, launches, smi, extra=""):
    parts = ("config", "model build", "restore", "device compute", "host I/O")
    split = " + ".join(f"{p} {seconds.get(p, 0.0):.3f}" for p in parts)
    rest = total - sum(seconds.get(p, 0.0) for p in parts)
    print(f"cli {name}: {total:.3f} s (host clock) = {split} + the rest {rest:.3f} "
          f"(arguments, imports, set-up); launches {launches}{extra} | {smi}")


def phase_cli(torch, dev, smi, work, size=None, frames=CLI_FRAMES):
    """The serving commands as a user runs them, `python -m
    megaportraits_tpu_torch <command> --config <yaml>`, at `size`
    (TRAIN_SIZE by default), from YAML
    files written as text. They serve the
    stage-1 driver's export (work/base/export) with its BatchNorm running
    statistics calibrated on the source/driving pair and saved as a
    checkpoint of its own (after a few steps the running statistics are
    still near their start, and the frames would saturate):
      * `infer` in process: PNG source and driving in, .png out; JPEG in,
        .jpg out; a progressive JPEG source and a palette PNG driving frame
        in, .png out. K2 once each; the PNGs equal to the in-process
        inference_base of the same checkpoint bit for bit, the JPEG the
        bytes of that result encoded (PIL's default JPEG);
      * the files PIL writes that the port reads as PIL does, written by
        PIL in a subprocess (PIL_INPUTS): a progressive JPEG at `size` and
        at twice it, a palette PNG and a 16-bit gray PNG, each read by
        read_image (yaml, PIL and cv2 blocked) equal to PIL's
        convert("RGB") bit for bit, with its seconds;
      * `infer` as a subprocess (a fresh interpreter, the default device):
        its PNG equal to the in-process one;
      * `reenact`: `frames` PNG frames of a pattern (pred_frame_%04d.png
        from 1) into an output pattern; K2 once a frame, the frames within
        CLI_SESSION_LEVELS of a ReenactmentSession's on the same decoded
        inputs; frames/s of the command beside the session's own;
      * `eval` on the reenacted frames against the driving ones: finite
        metrics, no kernel;
      * every output decodes, is 512 x 512 x 3, and is not flat;
      * every command runs with yaml, PIL and cv2 blocked (the card's
        machine has them installed; an import of one raises), the
        subprocess too; yaml and PIL are in no sys.modules after.
    Each command's seconds are split into config, model build, restore,
    device compute and host I/O."""
    import ast
    import contextlib
    import io

    import numpy as np

    from megaportraits_tpu_torch.core.checkpoint import CheckpointManager
    from megaportraits_tpu_torch.core.config import Config, load_config
    from megaportraits_tpu_torch.data import landmarks
    from megaportraits_tpu_torch.infer import inference, video
    from megaportraits_tpu_torch.infer.streaming import ReenactmentSession
    from megaportraits_tpu_torch.models.gbase import Gbase, calibrate_batch_norm
    from megaportraits_tpu_torch.utils import image, jpeg

    size = size or TRAIN_SIZE
    cli_dir = work / "cli"
    frames_dir, out_dir = cli_dir / "frames", cli_dir / "out"
    frames_dir.mkdir(parents=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)

    def uint8(x):
        return (x[0].clamp(0, 1) * 255).round().to(torch.uint8).cpu().numpy()

    source, driving = (uint8(smooth_image(torch, gen, dev, size)) for _ in range(2))
    drives = [uint8(smooth_image(torch, gen, dev, size)) for _ in range(frames)]
    inputs = {}
    t0 = time.perf_counter()
    for kind in ("png", "jpg"):
        for name, arr in (("source", source), ("driving", driving)):
            inputs[name, kind] = str(cli_dir / f"{name}.{kind}")
            image.write_image(arr, inputs[name, kind])
    for i, arr in enumerate(drives, start=1):
        image.write_image(arr, str(frames_dir / f"pred_frame_{i:04d}.png"))
    print(f"cli: inputs written in {time.perf_counter() - t0:.3f} s (host clock)")
    big = np.repeat(np.repeat(source, 2, axis=0), 2, axis=1)
    for arr in (source, big):
        t0 = time.perf_counter()
        data = jpeg.encode(arr)
        t1 = time.perf_counter()
        check(jpeg.decode(data).shape == arr.shape, "a JPEG decodes to another shape")
        t2 = time.perf_counter()
        print(f"cli: JPEG (quality 75, 4:2:0) of {arr.shape[1]}x{arr.shape[0]} ({len(data)} "
              f"bytes): encode {t1 - t0:.3f} s, decode {t2 - t1:.3f} s an image (host "
              "clock; the decoder walks the Huffman bits in Python)")
    for name, arr in (("source", source), ("driving", driving)):
        np.save(cli_dir / f"{name}.npy", arr)
    proc = subprocess.run([sys.executable, "-c", PIL_INPUTS, str(cli_dir)], capture_output=True,
                          text=True, timeout=300)
    print(f"cli: PIL wrote a progressive JPEG at {size} and {2 * size}, a palette PNG and a "
          f"16-bit gray PNG (a subprocess, rc {proc.returncode}): "
          f"{proc.stdout.strip().splitlines()}{' ' + proc.stderr[-1500:] if proc.returncode else ''}")
    check(proc.returncode == 0, "PIL could not write the progressive, palette and 16-bit inputs")
    for name in ("source_progressive.jpg", "big_progressive.jpg", "driving_palette.png",
                 "gray16.png"):
        path = str(cli_dir / name)
        t0 = time.perf_counter()
        with Blocked():
            got = image.read_image(path)
        took = time.perf_counter() - t0
        want = np.load(path + ".npy")
        same = got.shape == want.shape and np.array_equal(got, want)
        print(f"cli: read_image of {name} ({want.shape[1]}x{want.shape[0]}, "
              f"{Path(path).stat().st_size} bytes) in {took:.3f} s (host clock): PIL's "
              f"convert('RGB') bit for bit: {same}")
        check(same, f"{name} decodes otherwise than PIL's convert('RGB')")
    inputs["source", "mixed"] = str(cli_dir / "source_progressive.jpg")
    inputs["driving", "mixed"] = str(cli_dir / "driving_palette.png")

    serve = str(cli_dir / "serve")
    serve_yaml = write_yaml(cli_dir / "serve.yaml", {
        "data": {"train_width": size, "train_height": size},
        "model": dict(DRIVER_MODEL), "inference": {"checkpoint_path": serve}})
    model = load_config(serve_yaml).make_gbase(device=dev, seed=0)
    check(inference.restore_gbase(model, [str(work / "base" / "export")]),
          "no stage-1 export")
    n_bn = calibrate_batch_norm(model, *(torch.from_numpy(a.astype(np.float32) / 255.0)[None]
                                         .to(dev) for a in (source, driving)))
    CheckpointManager(serve).save(0, {"g_variables": model})
    trunk_blocks = len(model.g2d.trunk_names)
    del model
    print(f"cli: the stage-1 export with {n_bn} BatchNorms calibrated, saved to {serve}")

    def fresh_model(path):
        cfg = load_config(path)
        m = cfg.make_gbase(device=dev, seed=0)
        check(inference.restore_gbase(m, [cfg.inference.checkpoint_path]), "no checkpoint")
        return m

    def decoded(path):
        arr = image.read_image(path)
        check(arr.shape == (size, size, 3), f"{path}: shape {arr.shape}")
        check(arr.std() >= CLI_FLAT_LEVELS, f"{path} is flat (std {arr.std():.3f} levels)")
        return arr

    infer_timers = [(inference, {"load_config": "config", "restore_gbase": "restore",
                                 "read_image": "host I/O", "pil_bilinear_resize": "host I/O",
                                 "write_image": "host I/O"}),
                    (Config, {"make_gbase": "model build"}),
                    (Gbase, {"generate": "device compute"})]
    served, measured = {}, []
    for kind, ext in (("png", ".png"), ("jpg", ".jpg"), ("mixed", ".png")):
        out = str(cli_dir / f"infer_{kind}{ext}")
        path = write_yaml(cli_dir / f"infer_{kind}.yaml", {
            "data": {"train_width": size, "train_height": size},
            "model": dict(DRIVER_MODEL),
            "inference": {"checkpoint_path": serve, "source_image": inputs["source", kind],
                          "driving_image": inputs["driving", kind], "output_image": out}})
        seconds, total, launches = timed_command(
            torch, dev, ["infer", "--config", path, "--device", dev], infer_timers)
        report_command(f"infer ({kind} in, {ext} out)", seconds, total, launches, smi)
        check_trunk_launches(f"infer ({kind})", launches, 1, trunk_blocks)
        measured.append(launches)
        want = inference.inference_base(inputs["source", kind], inputs["driving", kind],
                                        fresh_model(path), size=(size, size))
        if ext == ".png":
            same = np.array_equal(decoded(out), want)
        else:
            decoded(out)
            same = Path(out).read_bytes() == jpeg.encode(want)
        print(f"cli infer ({kind}): the output equals the in-process inference_base "
              f"{'bit for bit' if ext == '.png' else 'encoded, byte for byte'}: {same}")
        check(same, f"infer's {ext} differs from the in-process result")
        served[kind] = out

    out_png = served["png"]
    sub_out = str(cli_dir / "infer_subprocess.png")
    sub_yaml = write_yaml(cli_dir / "infer_subprocess.yaml", {
        "data": {"train_width": size, "train_height": size}, "model": dict(DRIVER_MODEL),
        "inference": {"checkpoint_path": serve, "source_image": inputs["source", "png"],
                      "driving_image": inputs["driving", "png"], "output_image": sub_out}})
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS=str(torch.get_num_threads()))
    if dev.type == "cpu":
        env["MEGAPORTRAITS_PLATFORM"] = "cpu"
    # `python -m megaportraits_tpu_torch infer --config ...` in a fresh
    # interpreter whose imports of the host libraries raise; it prints
    # which of them it holds when the command returns.
    script = ("import runpy, sys\n"
              f"for name in {HOST_LIBRARIES!r}:\n"
              "    sys.modules[name] = None\n"
              "sys.argv = ['-m', 'infer', '--config', sys.argv[1]]\n"
              "try:\n"
              "    runpy.run_module('megaportraits_tpu_torch', run_name='__main__')\n"
              "except SystemExit as e:\n"
              "    if e.code:\n"
              "        raise\n"
              f"print('held:', [n for n in {HOST_LIBRARIES!r} if sys.modules.get(n)])\n")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", script, sub_yaml], cwd=str(ROOT), env=env,
                          capture_output=True, text=True, timeout=600)
    sub_s = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    print(f"cli infer (a subprocess: python -m megaportraits_tpu_torch infer --config ..., "
          f"{', '.join(HOST_LIBRARIES)} blocked): rc {proc.returncode} in {sub_s:.3f} s (host "
          f"clock, the interpreter's start and imports included); its output {lines[-2:]}"
          f"{' stderr ' + proc.stderr[-2000:] if proc.returncode else ''}")
    check(proc.returncode == 0, "the infer subprocess failed")
    check(lines[-1:] == ["held: []"], f"the subprocess holds {lines[-1:]}")
    gap = np.abs(decoded(sub_out).astype(int) - decoded(out_png).astype(int)).max()
    same = gap == 0
    print(f"cli infer (subprocess): its PNG equals the in-process command's bit for bit: "
          f"{same} (max {gap} levels)")
    check(same, "the subprocess's PNG differs from the in-process one")

    # reenact: the frame pattern into an output pattern.
    pattern = str(frames_dir / "pred_frame_%04d.png")
    out_pattern = str(out_dir / "pred_frame_%04d.png")
    stamps = []
    session_timer = Stopwatch(torch, dev)
    reenact_timers = [(video, {"load_config": "config", "load_image": "host I/O",
                               "read_image": "host I/O", "cv2_linear_resize_u8": "host I/O",
                               "write_image": "host I/O"}),
                      (Config, {"make_gbase": "model build"}),
                      (CheckpointManager, {"restore": "restore"}),
                      (ReenactmentSession, {"set_source": "device compute",
                                            "__call__": "device compute"})]
    loop = video.reenact_video

    def stamped(*args, **kwargs):
        stamps.append(time.perf_counter())
        n = loop(*args, **kwargs)
        session_timer.sync()
        stamps.append(time.perf_counter())
        return n

    with Patched(video, reenact_video=stamped):
        seconds, total, launches = timed_command(
            torch, dev, ["reenact", "--config", serve_yaml, "--source", inputs["source", "png"],
                         "--driving", pattern, "--output", out_pattern, "--size", size,
                         "--device", dev], reenact_timers)
    written = sorted(p.name for p in out_dir.iterdir())
    check(written == [f"pred_frame_{i:04d}.png" for i in range(1, frames + 1)],
          f"reenact wrote {written}")
    command_fps = frames / (stamps[1] - stamps[0])
    check_trunk_launches("reenact", launches, frames, trunk_blocks)
    measured.append(launches)

    model = fresh_model(serve_yaml)
    session = ReenactmentSession(model=model, bn_mode="running")
    session.set_source(inference.load_image(inputs["source", "png"], (size, size)))
    worst, outs = 0, []
    drive_inputs = [torch.from_numpy(image.cv2_linear_resize_u8(
        image.read_image(str(frames_dir / f"pred_frame_{i:04d}.png")), (size, size))
        .astype(np.float32) / 255.0)[None] for i in range(1, frames + 1)]
    session_call = session_timer.wrap("frames", session.__call__)
    for i, xd in enumerate(drive_inputs, start=1):
        xhat = session_call(xd)
        check(bool(torch.isfinite(xhat).all()), "a session frame is not finite")
        want = (xhat[0].float().cpu().numpy() * 255).clip(0, 255).astype(np.uint8)
        got = decoded(str(out_dir / f"pred_frame_{i:04d}.png"))
        worst = max(worst, int(np.abs(got.astype(int) - want.astype(int)).max()))
    session_fps = frames / session_timer.seconds["frames"]
    report_command(f"reenact ({frames} PNG frames of a pattern)", seconds, total, launches,
                   smi, extra=f"; {command_fps:.3f} frames/s over reenact_video (the "
                   f"source read and encoded once, then each frame read, resized, driven "
                   f"and written; host clock) beside the session's own {session_fps:.3f} "
                   f"frames/s (the drive alone, synchronised, on the same inputs)")
    print(f"cli reenact: frames against the session's on the same decoded inputs: max "
          f"{worst} levels (limit {CLI_SESSION_LEVELS})")
    check(worst <= CLI_SESSION_LEVELS, f"reenact's frames are {worst} levels from the session's")
    del model, session

    # eval: the reenacted frames against the driving frames.
    landmarks.set_landmark_provider(None)
    text = io.StringIO()
    t0 = time.perf_counter()
    reset_counts()
    with contextlib.redirect_stdout(text), Blocked():
        run_command(["eval", "--output-dir", out_dir, "--target-dir", frames_dir,
                     "--device", dev])
    eval_s = time.perf_counter() - t0
    scores = ast.literal_eval(text.getvalue().strip().splitlines()[-1])
    eval_launches = counts()
    print(f"cli eval ({frames} pairs): {eval_s:.3f} s (host clock); {scores}; launches "
          f"{eval_launches} | {smi}")
    for k in ("L1", "PSNR", "SSIM"):
        check(scores[k] is not None and math.isfinite(scores[k]), f"eval {k} {scores[k]}")
    check(all(v == 0 for v in eval_launches.values()), f"kernels in eval: {eval_launches}")
    held = [m for m in HOST_LIBRARIES if sys.modules.get(m)]
    print(f"cli: every command ran with {', '.join(HOST_LIBRARIES)} blocked (an import "
          f"raises); of them this process holds {held} (data/dataset.py takes cv2 where it "
          "is installed, as JAX's does, and the card's machine has it)")
    check("yaml" not in held and "PIL" not in held, f"{held} got imported")
    return dict(launches={k: sum(m[k] for m in measured) for k in measured[0]})


def phase_drivers(torch, dev, smi, bare):
    """The three drivers in a temporary working directory (runs/,
    output_images/ and the checkpoints land there), on clips written into
    the npz cache at 512 and 1024. `bare` holds the bare steps' ms."""
    import os
    import shutil
    import tempfile

    here = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        (work / "clips").mkdir()
        t0 = time.perf_counter()
        write_clips(torch, dev, work / "clips", (TRAIN_SIZE, 2 * TRAIN_SIZE))
        print(f"drivers: {DRIVER_CLIPS} clips of {DRIVER_FRAMES} frames written to the npz "
              f"cache at {TRAIN_SIZE} and {2 * TRAIN_SIZE} in "
              f"{time.perf_counter() - t0:.2f} s; {shutil.disk_usage(tmp).free / 2 ** 30:.1f} "
              f"GiB free there")
        os.chdir(tmp)
        try:
            base = phase_driver_base(torch, dev, smi, work, bare["base"])
            torch.cuda.empty_cache()
            cli = phase_cli(torch, dev, smi, work)
            torch.cuda.empty_cache()
            hr = phase_driver_hr(torch, dev, smi, work, bare["hr"], base.pop("best"))
            torch.cuda.empty_cache()
            student = phase_driver_student(torch, dev, smi, work, bare["student"])
            torch.cuda.empty_cache()
            distributed = phase_distributed(torch, dev, smi, work)
        finally:
            os.chdir(here)
    return [base["launches"], cli["launches"], hr["launches"], student["launches"],
            distributed["launches"]]


SCRIPT_SIZE = 256  # overfit and validate_student, as their defaults
SCRIPT_STEPS = 4  # overfit: evaluated and exported every 2
SCRIPT_STUDENT_STEPS = 3
SMOKE_STEPS = 3  # train_smoke, after its first step


def script_losses(pattern, text):
    return [float(x) for x in re.findall(pattern, text)]


def finite_and_moving(name, first, last):
    ok = math.isfinite(first) and math.isfinite(last) and first != last
    print(f"scripts {name}: loss {first!r} -> {last!r} (finite and moving: {ok})")
    check(ok, f"{name}'s loss is not finite or does not move: {first} -> {last}")


def run_tool(torch, dev, smi, name, fn):
    """fn() with its launches counted from 0, its stdout kept and its host
    seconds; prints the line of numbers."""
    import contextlib

    tee = Tee(sys.stdout)
    reset_counts()
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        out = fn()
    sync()
    seconds = time.perf_counter() - t0
    launches = counts()
    print(f"scripts {name}: {seconds:.3f} s (host clock, set-up included); launches "
          f"{launches} | {smi}")
    return out, "".join(tee.text), launches, seconds


def teacher_against_float32(torch, dev, export, frames):
    """validate_student's teacher as the tool builds it (float32 GHR, the
    overfit export grafted into Gbase, Gbase-only, running statistics) on
    each avatar's first frame driven by its held-out last one: it must run
    no K2 (a float32 policy computes in float32). The same teacher in bf16
    (the port's DEFAULT_POLICY) runs its trunk on K2: K2 against its plain
    version on that teacher's own trunk input, and the bf16 teacher's
    output with its trunk on K2 against the float32 teacher, beside the
    bf16 teacher with the plain trunk. The teacher with K2 must be no
    further from float32 than twice the plain-trunk teacher is. Returns
    K2's max abs error. Launches here are comparisons and are not
    counted."""
    from megaportraits_tpu_torch.core.config import Config
    from megaportraits_tpu_torch.core.dtypes import DEFAULT_POLICY, FP32_POLICY
    from megaportraits_tpu_torch.models.genh import build_ghr
    from megaportraits_tpu_torch.ops.kernels import resblock_chain as k2
    from megaportraits_tpu_torch.scripts import validate_student
    from megaportraits_tpu_torch.train.train_student import make_teacher_forward

    def teacher(policy):
        model = build_ghr(Config().make_arch(), policy=policy, device=dev, seed=0)
        validate_student._graft(model.gbase, str(export), "g_variables", "--gbase-ckpt",
                                "Gbase")
        return model, make_teacher_forward(model, include_enh=False, bn_mode="running")

    f32, f32_fwd = teacher(FP32_POLICY)
    b16, b16_fwd = teacher(DEFAULT_POLICY)
    g2d = b16.gbase.g2d
    trunk_in = []
    hook = g2d.conv1x1.register_forward_hook(lambda m, i, out: trunk_in.append(out))
    k2_err, gaps = 0.0, {"K2 trunk": [], "plain trunk": []}
    for fs in frames:
        xs = torch.from_numpy(fs[0][None]).to(dev)
        xd = torch.from_numpy(fs[-1][None]).to(dev)
        before = k2.resblock_chain.launches
        ref = f32_fwd(xs, xd)
        check(k2.resblock_chain.launches == before, "K2 ran in the float32 teacher")
        with_k2 = b16_fwd(xs, xd)
        with plain_trunk(g2d):
            plain = b16_fwd(xs, xd)
        for name, out in (("K2 trunk", with_k2), ("plain trunk", plain)):
            check(torch.isfinite(out).all().item(), f"{name} teacher output not finite")
            gaps[name].append((out - ref).abs())
        with torch.no_grad():
            x = trunk_in[-1][0].contiguous()
            weights, scales, shifts = g2d.cached_trunk_chain_params()
            got = k2.resblock_chain(x, weights, scales, shifts)
            want = k2.resblock_chain_plain(x, weights, scales, shifts)
        err, rel = errors(got, want)
        print(f"scripts validate_student's teacher trunk {tuple(x.shape)} N="
              f"{weights.shape[0]}: K2 max_abs_err {err:.6g} rel {rel:.3g} against its "
              f"plain version on the same bf16 operands")
        check(rel <= 2 ** -5, f"K2 on the teacher's trunk disagrees with its plain "
                              f"version: rel {rel}")
        k2_err = max(k2_err, err)
    hook.remove()
    stats = {name: (torch.stack(g).max().item(), torch.stack(g).mean().item())
             for name, g in gaps.items()}
    print(f"scripts validate_student's teacher in bf16 against itself in float32, output "
          f"in [0, 1] over {len(frames)} held-out frames: trunk on K2 max abs "
          f"{stats['K2 trunk'][0]:.6g} mean {stats['K2 trunk'][1]:.6g}; plain trunk "
          f"max abs {stats['plain trunk'][0]:.6g} mean {stats['plain trunk'][1]:.6g}")
    for i, what in ((0, "max"), (1, "mean")):
        check(stats["K2 trunk"][i] <= 2 * stats["plain trunk"][i] + 1e-6,
              f"the teacher with its trunk on K2 is further from float32 ({what}) than "
              f"twice the teacher with the plain trunk")
    return k2_err


def phase_scripts(torch, dev, smi, work, size=SCRIPT_SIZE, smoke_size=TRAIN_SIZE,
                  smoke_batch=TRAIN_BATCH):
    """The repo's scripts/ tools on the port, each through its main() as
    `python -m megaportraits_tpu_torch.scripts.<name>` calls it, in `work`
    (output_images/ lands there) with $TMPDIR at work/tmp (the tools' npz
    cache and clip lists):
      * check_device: exit 0, the card and every kernel built;
      * train_smoke at `smoke_size`, `smoke_batch`, SMOKE_STEPS steps after
        the first: finite metrics that move, each step's CUDA-event ms;
      * overfit at `size` on 2 clips written into the npz cache, --pool 2,
        --eval-every 2, --export: finite loss_G that moves, the export at
        the best held-out step, restored into a fresh Gbase bit for bit;
        no kernel (train mode, batch-statistics evaluation);
      * validate_student at `size` behind that export with
        --teacher-bn-mode running: the float32 teacher's trunk never on K2,
        finite distillation losses that move, the side-by-side PNGs and
        RESULTS.txt; then that teacher against itself in bf16 with its
        trunk on K2 (``teacher_against_float32``).
    The clips' ids name empty .mp4 files in the clip directory
    (validate_student lists clips by their .mp4; the cache is read first,
    so no video is decoded). Returns the launches of all four and K2's max
    abs error on the teacher's trunk."""
    import tempfile

    from megaportraits_tpu_torch.core.checkpoint import CheckpointManager
    from megaportraits_tpu_torch.scripts import check_device, overfit, train_smoke
    from megaportraits_tpu_torch.scripts import validate_student

    tmp, clips = work / "tmp", work / "script_clips"
    cache = tmp / "megaportraits_cache"
    cache.mkdir(parents=True)
    clips.mkdir()
    write_clips(torch, dev, cache, (size,))
    meta = json.loads((cache / "meta.json").read_text())
    (clips / "overfit.json").write_text(json.dumps(meta))
    for vid in meta["clips"]:
        (clips / f"{vid}.mp4").write_bytes(b"")
    device = ["--device", str(dev)]
    measured = []
    with Patched(tempfile, tempdir=str(tmp)):
        if dev.type == "cuda":
            rc, text, launches, _ = run_tool(torch, dev, smi, "check_device",
                                             lambda: check_device.main([]))
            check(rc == 0, f"check_device returned {rc}")
            check(text.count(": builds") == 3, f"check_device: {text}")

        result, _, launches, seconds = run_tool(
            torch, dev, smi, f"train_smoke {smoke_size} {smoke_batch} {SMOKE_STEPS}",
            lambda: train_smoke.main([str(smoke_size), str(smoke_batch), str(SMOKE_STEPS)]
                                     + device))
        measured.append(launches)
        ms = [x * 1e3 for x in result["step_s"]]
        print(f"scripts train_smoke: first step {result['first_step_s'] * 1e3:.3f} ms, then "
              f"{[round(x, 3) for x in ms]} ms (CUDA events) = "
              f"{len(ms) / sum(result['step_s']):.3f} steps/s at {smoke_size}, batch "
              f"{smoke_batch} | {smi}")
        check(all(math.isfinite(v) for v in result["metrics"].values()),
              f"train_smoke metrics {result['metrics']}")
        finite_and_moving("train_smoke loss_G", result["metrics_first"]["loss_G"],
                          result["metrics"]["loss_G"])
        check(all(v == 0 for v in launches.values()), f"kernels in training: {launches}")

        export = work / "script_export"
        result, text, launches, seconds = run_tool(
            torch, dev, smi, f"overfit {size}",
            lambda: overfit.main(["--size", str(size), "--steps", str(SCRIPT_STEPS),
                                  "--batch", "2", "--video-dir", str(clips), "--json-file",
                                  str(clips / "overfit.json"), "--pool", "2",
                                  "--eval-every", "2", "--log-every", "2", "--export",
                                  str(export)] + device))
        measured.append(launches)
        print(f"scripts overfit: {SCRIPT_STEPS / seconds:.3f} steps/s over the whole "
              f"command (host clock: caches, model build, pool, {SCRIPT_STEPS // 2} "
              f"held-out evaluations and exports included); best held-out "
              f"{result['best_psnr']:.3f} dB at step {result['best_step']}, exported step "
              f"{result['export_step']}")
        finite_and_moving("overfit loss_G", result["first_loss_G"], result["final_loss_G"])
        check(all(v == 0 for v in launches.values()), f"kernels in overfit: {launches}")
        check(result["export_step"] == result["best_step"] == step_dirs(export)[-1],
              f"overfit exported {result['export_step']}, best {result['best_step']}, "
              f"on disk {step_dirs(export)}")
        saved = torch.load(export / str(result["export_step"]) / "checkpoint.pt",
                           weights_only=True)["g_variables"]
        fresh = overfit.Config().make_gbase(device=dev, seed=7)
        CheckpointManager(str(export)).restore({"g_variables": fresh})
        same = same_weights(torch, fresh, saved)
        print(f"scripts overfit: the export restores into a fresh Gbase bit for bit: {same}")
        check(same, "overfit's export does not restore bit for bit")
        del fresh, saved

        out = work / "student_quality"
        avatars = len(meta["clips"])
        rc, text, launches, seconds = run_tool(
            torch, dev, smi, f"validate_student {size}",
            lambda: validate_student.main([
                "--size", str(size), "--steps", str(SCRIPT_STUDENT_STEPS), "--batch", "2",
                "--num-avatars", str(avatars), "--video-dir", str(clips), "--gbase-ckpt",
                str(export), "--teacher-bn-mode", "running",
                "--out", str(out)] + device))
        measured.append(launches)
        check(rc == 0, f"validate_student returned {rc}")
        losses = script_losses(r"distill MSE (\S+)", text)
        check(len(losses) == 2, f"validate_student printed {losses}")
        finite_and_moving("validate_student distill MSE", losses[0], losses[-1])
        scores = script_losses(r"held-out MSE (\S+)", text) + script_losses(r"LPIPS (\S+)",
                                                                            text)
        check(len(scores) == 2 * avatars and all(math.isfinite(x) for x in scores),
              f"validate_student scores {scores}")
        written = sorted(p.name for p in out.iterdir())
        check(written == ["RESULTS.txt"] + [f"avatar{a}_teacher_vs_student.png"
                                             for a in range(avatars)], f"wrote {written}")
        print(f"scripts validate_student: {SCRIPT_STUDENT_STEPS / seconds:.3f} steps/s over "
              f"the whole command (host clock: model builds, the teacher's restore, "
              f"{avatars} held-out frames with LPIPS included); {written}")
        k2_err = None
        if dev.type == "cuda":
            # The teacher is float32: its trunk stays off K2.
            check_trunk_launches("validate_student's teacher", launches, 0, TRUNK_BLOCKS)
            frames = validate_student._load_frames(validate_student.parse_args(
                ["--size", str(size), "--num-avatars", str(avatars), "--video-dir",
                 str(clips)]))
            k2_err = teacher_against_float32(torch, dev, export, frames)
    return dict(launches={k: sum(m[k] for m in measured) for k in measured[0]},
                k2_max_abs_err=k2_err)


# phase_bundle_eval: a synthetic pretrained bundle at the real sizes, the
# eval command on frames served through K2, and the identity term.
EVAL_FRAMES = 8
FAN_STACKS = 4  # 2DFAN-4
IDENTITY_SIZE = 512  # PerceptualLoss(use_vggface=True) timed at 512, batch 2
IDENTITY_BATCH = 2


def write_synthetic_weights(torch, dev, directory, fan_stacks=FAN_STACKS):
    """Original-named .pth files made from seeded port modules through the
    converter's tables: 2DFAN-N, InceptionResnetV1, VGG16 features with the
    LPIPS heads, VGG19 features, resnet18 and 6DRepNet, at their real sizes.
    Returns {file name: the kind identify() must give}."""
    from megaportraits_tpu_torch.core.dtypes import FP32_POLICY
    from megaportraits_tpu_torch.losses.perceptual import LPIPS, VGG
    from megaportraits_tpu_torch.losses.vggface import InceptionResnetV1
    from megaportraits_tpu_torch.models.fan import FAN
    from megaportraits_tpu_torch.models.repvgg import SixDRepNet
    from megaportraits_tpu_torch.models.resnet import ResNet18
    from megaportraits_tpu_torch.nn.layers import init_parameters
    from megaportraits_tpu_torch.utils import convert_weights as cw

    kw = dict(policy=FP32_POLICY, device=dev)
    files = {
        "2DFAN4.pth": ("fan", cw.fan_table(fan_stacks), lambda: FAN(fan_stacks, **kw)),
        "vggface2.pth": ("vggface", cw.inception_table(), lambda: InceptionResnetV1(**kw)),
        "vgg16.pth": ("vgg16", cw.vgg_table("vgg16"), lambda: VGG("vgg16", ((4, 2),), **kw)),
        "lpips_vgg.pth": ("lpips", cw.lpips_table(), lambda: LPIPS(**kw)),
        "vgg19.pth": ("vgg19", cw.vgg_table("vgg19"), lambda: VGG("vgg19", ((4, 3),), **kw)),
        "resnet18.pth": ("resnet18", cw.resnet_table("resnet18"),
                         lambda: ResNet18(num_classes=1000, **kw)),
        "6DRepNet_300W_LP_AFLW2000.pth": ("sixdrepnet", cw.sixdrepnet_table(),
                                          lambda: SixDRepNet(**kw)),
    }
    for i, (name, (_, table, make)) in enumerate(files.items()):
        module = init_parameters(make(), seed=20 + i)
        torch.save(cw.original_state_dict(table, module.state_dict()), directory / name)
        del module
    return {name: kind for name, (kind, _, _) in files.items()}


def phase_bundle_eval(torch, dev, smi, work, arch="full", size=TRAIN_SIZE,
                      frames=EVAL_FRAMES, fan_stacks=FAN_STACKS,
                      identity_size=IDENTITY_SIZE, policy=None):
    """The pretrained bundle and the eval command, at `arch` (FULL on the
    card): synthetic original files -> the converter -> load_bundle; the
    stage-1 ReenactmentSession at `size` serves `frames` frames with its
    trunk on K2, written as pred_frame_{i}.png beside the driving frames as
    targets; `eval --pretrained` in-process (real LPIPS, identity-embedding
    AED, the FAN provider, finite metrics, every PNG read back as written);
    the time of a scored pair split into its parts, FAN and
    InceptionResnetV1 per image; then the bundle grafted into a Gbase and
    a PerceptualLoss(use_vggface=True), whose forward and backward are
    timed at `identity_size`, batch 2. Returns the bundle's path and the
    launches of the serving."""
    import contextlib
    import io

    import numpy as np

    from megaportraits_tpu_torch import __main__ as cli
    from megaportraits_tpu_torch.core.dtypes import DEFAULT_POLICY, FP32_POLICY
    from megaportraits_tpu_torch.data import landmarks
    from megaportraits_tpu_torch.eval import metrics
    from megaportraits_tpu_torch.infer.streaming import ReenactmentSession
    from megaportraits_tpu_torch.losses.perceptual import build_perceptual_loss
    from megaportraits_tpu_torch.models.gbase import build_gbase, calibrate_batch_norm
    from megaportraits_tpu_torch.utils import convert_weights as cw
    from megaportraits_tpu_torch.utils.image import save_image
    from megaportraits_tpu_torch.utils.pretrained import load_bundle, maybe_load_pretrained

    weights, bundle, out_dir, tgt_dir = (work / d for d in ("weights", "bundle", "out", "tgt"))
    for d in (weights, out_dir, tgt_dir):
        d.mkdir()
    t0 = time.perf_counter()
    kinds = write_synthetic_weights(torch, dev, weights, fan_stacks)
    t1 = time.perf_counter()
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        rc = cw.main(["--weights-dir", str(weights), "--out", str(bundle)])
    t2 = time.perf_counter()
    print(text.getvalue().rstrip())
    check(rc == 0, f"the converter returned {rc}")
    check("SKIP" not in text.getvalue(), "the converter skipped a file")
    for name, kind in kinds.items():
        key = cw.bundle_key(kind)
        check(f"{name:30s} -> {key:12s} converted" in text.getvalue(),
              f"{name} was not converted as {key}")
    loaded = load_bundle(str(bundle))
    want_keys = {"fan", "vggface", "vgg16", "lpips_heads", "vgg19", "resnet18", "sixdrepnet"}
    check(loaded is not None and set(loaded) == want_keys, f"bundle keys {sorted(loaded or {})}")
    n_bytes = sum(f.stat().st_size for f in weights.iterdir())
    print(f"bundle: {len(kinds)} original files ({n_bytes / 2 ** 20:.1f} MiB) written in "
          f"{t1 - t0:.2f} s, converted in {t2 - t1:.2f} s; load_bundle gives "
          f"{sorted(loaded)}, FAN with {fan_stacks} stacks")
    face_weights = loaded["vggface"]
    del loaded

    # Serve the frames that eval scores, the trunk on K2.
    policy = policy or DEFAULT_POLICY
    model = build_gbase(arch, policy=policy, device=dev, seed=0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    xs = smooth_image(torch, gen, dev, size)
    drives = [smooth_image(torch, gen, dev, size) for _ in range(frames)]
    calibrate_batch_norm(model, xs, drives[0])
    session = ReenactmentSession(model=model, bn_mode="running")
    reset_counts()
    session.set_source(xs)
    preds = [session(xd) for xd in drives]
    torch.cuda.synchronize()
    served = counts()
    print(f"eval serving: {frames} frames at {size}x{size}, launches {served}")
    check(served["resblock_chain"] == frames,
          f"K2 ran {served['resblock_chain']} times serving {frames} frames")
    written = {}
    for i, (pred, xd) in enumerate(zip(preds, drives)):
        name = f"pred_frame_{i}.png"
        for d, img in ((out_dir, pred), (tgt_dir, xd)):
            arr = img[0].float().cpu().numpy()
            save_image(arr, str(d / name))
            written[str(d / name)] = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
    del session, preds

    # Score: the eval command, in process.
    landmarks.set_landmark_provider(None)
    text = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text):
        rc = cli.main(["eval", "--output-dir", str(out_dir), "--target-dir", str(tgt_dir),
                       "--pretrained", str(bundle), "--device", str(dev)])
    eval_s = time.perf_counter() - t0
    lines = text.getvalue().strip().splitlines()
    print("\n".join(f"  eval | {line}" for line in lines))
    check(rc == 0, f"eval returned {rc}")
    check(lines[:2] == ["eval: converted LPIPS active",
                        "eval: vggface identity embeddings active (AED)"],
          f"eval did not report real LPIPS and identity AED: {lines[:2]}")
    result = ast.literal_eval(lines[-1])
    check(result["AED_formula"] == "identity_embedding", f"AED_formula {result['AED_formula']}")
    check(result["AKD_provider"] == "FANLandmarkProvider",
          f"AKD_provider {result['AKD_provider']}")
    for k in ("L1", "LPIPS", "PSNR", "SSIM", "AKD", "AED"):
        check(result[k] is not None and math.isfinite(result[k]), f"eval {k} = {result[k]}")
    for path, arr in written.items():
        check(np.array_equal(metrics.load_image(path), arr.astype(np.float32) / 255.0),
              f"{path} does not read back as written")
    print(f"eval: {frames} pairs scored in {eval_s:.3f} s (host clock, the callables' "
          f"set-up included) = {eval_s / frames:.3f} s a pair; every PNG read back as "
          f"written ({len(written)} files)")

    # Where a scored pair's time goes (host clock, each part after a
    # synchronise; the device parts return host arrays, which waits for them).
    provider = landmarks.get_landmark_provider()
    lpips_apply, embedding_apply = metrics.make_eval_callables(str(bundle), dev)
    landmarks.set_landmark_provider(provider)
    parts = {k: [] for k in ("png", "host", "lpips", "fan", "identity")}
    for i in range(frames):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred = metrics.load_image(str(out_dir / f"pred_frame_{i}.png"))
        tgt = metrics.load_image(str(tgt_dir / f"pred_frame_{i}.png"))
        t1 = time.perf_counter()
        for fn in (metrics.calculate_l1, metrics.calculate_psnr, metrics.calculate_ssim):
            fn(pred, tgt)
        t2 = time.perf_counter()
        metrics.calculate_lpips(pred, tgt, lpips_apply)
        t3 = time.perf_counter()
        metrics.calculate_akd(pred, tgt)
        t4 = time.perf_counter()
        metrics.calculate_aed(pred, tgt, embedding_apply)
        t5 = time.perf_counter()
        for k, v in zip(parts, (t1 - t0, t2 - t1, t3 - t2, t4 - t3, t5 - t4)):
            parts[k].append(v)
    med = {k: statistics.median(v) for k, v in parts.items()}
    print(f"eval, one scored pair at {size}x{size} (host-clock medians of {frames}): "
          f"{sum(med.values()):.4f} s = PNG I/O {med['png']:.4f} + host metrics (L1, PSNR, "
          f"SSIM) {med['host']:.4f} + LPIPS {med['lpips']:.4f} + FAN, two images "
          f"{med['fan']:.4f} + identity net, two images {med['identity']:.4f} | {smi}")

    fan_in = torch.rand(1, 256, 256, 3, device=dev, generator=gen)
    face_in = torch.rand(1, 160, 160, 3, device=dev, generator=gen) * 2 - 1
    from megaportraits_tpu_torch.losses.vggface import InceptionResnetV1

    face = InceptionResnetV1(policy=FP32_POLICY, device=dev)
    face.load_state_dict(face_weights)
    from torch.utils.flop_counter import FlopCounterMode

    with torch.no_grad():
        fan_ms = time_ms(lambda: provider.model(fan_in), reps=1)
        face_ms = time_ms(lambda: face(face_in), reps=1)
        gflop = {}
        for name, fn in (("fan", lambda: provider.model(fan_in)), ("face", lambda: face(face_in))):
            with FlopCounterMode(display=False) as counter:
                fn()
            gflop[name] = counter.get_total_flops() / 1e9
    print(f"FAN ({fan_stacks} stacks, float32) {fan_ms:.3f} ms/image at 256x256, "
          f"{gflop['fan']:.3f} GFLOP = {gflop['fan'] / fan_ms:.3f} TFLOP/s; InceptionResnetV1 "
          f"(float32) {face_ms:.3f} ms/image at 160x160, {gflop['face']:.3f} GFLOP = "
          f"{gflop['face'] / face_ms:.3f} TFLOP/s (CUDA-event medians of 5 after 2 warm-ups; "
          f"FLOPs by torch.utils.flop_counter) | {smi}")
    del face, lpips_apply, embedding_apply

    # The graft, and the identity term's cost in the perceptual loss.
    ploss = build_perceptual_loss(arch, policy=policy, device=dev, seed=3,
                                  use_vggface=True)
    _, _, report = maybe_load_pretrained(str(bundle), model, ploss)
    want = (f"pretrained: gbase leaves={FULL_GBASE_LEAVES}, "
            f"ploss leaves={FULL_PLOSS_LEAVES}")
    print(f"graft: {report} (want {want!r} at FULL)")
    check(arch != "full" or report == want, f"graft report {report!r}, want {want!r}")
    del model
    plain = build_perceptual_loss(arch, policy=policy, device=dev, seed=3)
    maybe_load_pretrained(str(bundle), None, plain)
    pred = torch.rand(IDENTITY_BATCH, identity_size, identity_size, 3, device=dev,
                      generator=gen).requires_grad_(True)
    tgt = torch.rand(IDENTITY_BATCH, identity_size, identity_size, 3, device=dev,
                     generator=gen)
    timing = {}
    for name, loss_net in (("with vggface", ploss), ("without", plain)):
        def fwd_bwd():
            pred.grad = None
            loss_net(pred, tgt).backward()

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(fwd_bwd, reps=1)
        peak = torch.cuda.max_memory_allocated()
        with FlopCounterMode(display=False) as counter:
            fwd_bwd()
        timing[name] = (ms, peak, counter.get_total_flops() / 1e12)
        check(pred.grad is not None and torch.isfinite(pred.grad).all().item(),
              f"PerceptualLoss ({name}) gradient")
    (ms_v, peak_v, tf_v), (ms_p, _, tf_p) = timing["with vggface"], timing["without"]
    print(f"PerceptualLoss forward + backward at {identity_size}x{identity_size}, batch "
          f"{IDENTITY_BATCH}, {policy.compute_dtype} compute: {ms_v:.3f} ms with the vggface "
          f"term ({tf_v:.3f} TFLOP), {ms_p:.3f} ms without ({tf_p:.3f} TFLOP; the identity "
          f"term {ms_v - ms_p:.3f} ms for {tf_v - tf_p:.3f} TFLOP); peak memory "
          f"{peak_v / 2 ** 30:.2f} GiB with it (CUDA-event medians of 5) | {smi}")
    return dict(bundle=bundle, launches=served)


def phase_driver_gaze(torch, dev, smi, work, bundle, bare_ms, size=TRAIN_SIZE, steps=2):
    """The stage-1 driver with use_gaze_loss at `size`, batch 2, `steps`
    steps, pretrained_path at the bundle: the FAN provider installed from
    it, every batch with gaze_masks [2, size, size, 2] (their coverage
    printed), loss_G_gaze finite in every step, the masks' ms a batch (host
    clock, in the prefetch's producer), the consumer's prefetch wait, and
    steps/s beside phase_train's bare step."""
    from megaportraits_tpu_torch.data import landmarks
    from megaportraits_tpu_torch.train import main_base

    clips = work / "clips"
    clips.mkdir()
    write_clips(torch, dev, clips, (size,))
    path = driver_yaml(work, "gaze", size=size, use_gaze_loss=True,
                       pretrained_path=str(bundle), log_interval=1, save_interval=steps)
    mask_ms, seen = [], []
    make_masks, build_step = main_base.gaze_masks_for_batch, main_base.make_train_step

    def timed_masks(images):
        t0 = time.perf_counter()
        out = make_masks(images)
        mask_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def recording_step(*args, **kwargs):
        step = build_step(*args, **kwargs)

        def run(g, d, batch):
            m = batch.get("gaze_masks")
            g, d, metrics, xhat = step(g, d, batch)
            seen.append((None if m is None else (tuple(m.shape), m.float().mean().item()),
                         metrics["loss_G_gaze"].item()))
            return g, d, metrics, xhat
        return run

    landmarks.set_landmark_provider(None)
    here = os.getcwd()
    os.chdir(work)
    try:
        with Patched(main_base, gaze_masks_for_batch=timed_masks,
                     make_train_step=recording_step):
            metrics, n = run_driver(torch, main_base, lambda: run_command(
                ["train-base", "--config", path, "--max-steps", steps, "--device", dev],
                main_base, "train_base"), steps)
    finally:
        os.chdir(here)
    provider = landmarks.get_landmark_provider()
    pretrained_line = [ln for ln in n["text"].splitlines() if ln.startswith("pretrained:")]
    print(f"driver gaze: {pretrained_line}; provider {type(provider).__name__} on "
          f"{getattr(provider, 'device', None)}, trained {getattr(provider, 'trained', None)}; "
          f"launches {n['launches']}; per step (mask shape, mask mean, loss_G_gaze) {seen}; "
          f"masks {[round(x, 3) for x in mask_ms]} ms a batch (host clock, in the prefetch "
          f"producer, FAN on its own stream)")
    check(isinstance(provider, landmarks.FANLandmarkProvider) and provider.trained,
          "the FAN provider of the bundle is not installed")
    check(len(seen) == steps, f"{len(seen)} steps seen")
    for shape_mean, gaze in seen:
        check(shape_mean is not None and shape_mean[0] == (TRAIN_BATCH, size, size, 2),
              f"gaze_masks {shape_mean}")
        check(math.isfinite(gaze), f"loss_G_gaze {gaze}")
    check(all(v == 0 for v in n["launches"].values()), f"kernels in training: {n['launches']}")
    check("gaze term skipped" not in n["text"], "the driver skipped the gaze term")
    check(DRIVER_MODEL.get("arch", "full") != "full" or pretrained_line == [
        f"pretrained: gbase leaves={FULL_GBASE_LEAVES}, "
        f"ploss leaves={FULL_PLOSS_LEAVES - VGGFACE_LEAVES}"],
        f"the driver grafted {pretrained_line}")
    report_driver("driver stage 1 with use_gaze_loss", n, bare_ms, smi)
    return dict(launches=n["launches"])


def main():
    import torch

    if not torch.cuda.is_available():
        die("no CUDA device")
    sys.path.insert(0, str(ROOT))
    try:
        import megaportraits_tpu_torch  # noqa: F401
    except ImportError:
        die("megaportraits_tpu_torch not found next to chip_smoke.py")
    dev = torch.device("cuda")
    # The plain versions are float32 references: no TF32 anywhere.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")

    from megaportraits_tpu_torch.ops.kernels import build

    secs = build.timed_build()
    print(f"kernels built in {secs:.2f} s from {[p.name for p in build.sources()]}")
    for src in build.sources():
        for line in build.build_log(src.stem).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {src.name}: {line.strip()}")

    k1_rows, chain_rows = phase_kernels(torch, dev)
    k4_rows = phase_bn_act(torch, dev)
    torch.cuda.empty_cache()
    from megaportraits_tpu_torch.ops.kernels.bn_act import bn_act

    k4_start = bn_act.launches
    launches, model, session, frames = phase_main_path(torch, dev)
    k3_launches = phase_k3_path(torch, model, session, frames)
    del model, session, frames
    torch.cuda.empty_cache()
    paths = [launches]
    paths.extend(phase_full_width(torch, dev))
    torch.cuda.empty_cache()
    paths.extend(phase_train_full_width(torch, dev))
    paths.append(phase_hr(torch, dev)["launches"])
    torch.cuda.empty_cache()
    phase_student(torch, dev)
    torch.cuda.empty_cache()
    phase_student_session(torch, dev)
    torch.cuda.empty_cache()
    bare = {}
    for name, phase in (("base", phase_train), ("hr", phase_train_hr),
                        ("student", phase_train_student)):
        result = phase(torch, dev, smi)
        paths.append(result["launches"])
        bare[name] = result["ms"]
        torch.cuda.empty_cache()
        if name == "base":
            phase_remat(torch, dev, smi)
            torch.cuda.empty_cache()
    paths.extend(phase_drivers(torch, dev, smi, bare))
    torch.cuda.empty_cache()
    import tempfile

    here = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            result = phase_scripts(torch, dev, smi, Path(tmp))
            paths.append(result["launches"])
            chain_rows["K2"]["max_abs_err"] = max(chain_rows["K2"]["max_abs_err"],
                                                  result["k2_max_abs_err"])
        finally:
            os.chdir(here)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        result = phase_bundle_eval(torch, dev, smi, work)
        paths.append(result["launches"])
        torch.cuda.empty_cache()
        paths.append(phase_driver_gaze(torch, dev, smi, work, result["bundle"],
                                       bare["base"])["launches"])
    # Launches over every driven path: stage 1, the full-width cases' bf16
    # runs on K2 (serving and training), HR serving, serving after
    # stage-1 training, the HR step, the Student step and its teacher, the
    # three drivers (serving the stage-1 export included), the serving
    # commands (infer twice and reenact, in this process), the stage-3
    # driver under the process group, the frames that eval scores and the
    # stage-1 driver with the gaze term, and the scripts/ tools
    # (validate_student's teacher).
    launches = {k: sum(p.get(k, 0) for p in paths) for k in launches}
    print(f"launches over every driven path: {launches}")

    k1_main = k1_rows[0]
    kernels = [
        dict(name="conv3x3_bn_act", route="cuda",
             source="megaportraits_tpu_torch/csrc/conv3x3_wgmma.cuh",
             replaces="megaportraits_tpu/ops/pallas/conv2d.py:65",
             launches=launches["conv3x3_bn_act"],
             max_abs_err=max(r["max_abs_err"] for r in k1_rows),
             ms=k1_main["ms"], plain_ms=k1_main["plain_ms"],
             bound_ms=k1_main["bound_ms"], bound_by=k1_main["bound_by"],
             library_ms=k1_main["library_ms"]),
    ]
    for name, source, replaces, n in (
            ("resblock_chain", "megaportraits_tpu_torch/csrc/conv3x3_bn_act.cu",
             "megaportraits_tpu/ops/pallas/g2d_chain_v2.py:233",
             launches["resblock_chain"]),
            ("fused_resblock_chain", "megaportraits_tpu_torch/csrc/resblock_chain_fused.cu",
             "megaportraits_tpu/ops/pallas/g2d_chain.py:122", k3_launches)):
        row = chain_rows["K2" if name == "resblock_chain" else "K3"]
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, launches=n,
                            max_abs_err=row["max_abs_err"], ms=row["ms"],
                            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                            bound_by=row["bound_by"], library_ms=row["library_ms"]))
    k4_main = k4_rows[0]
    kernels.append(dict(name="bn_act", route="cuda",
                        source="megaportraits_tpu_torch/csrc/bn_act.cu",
                        replaces=None, launches=bn_act.launches - k4_start,
                        max_abs_err=max(r["max_abs_err"] for r in k4_rows),
                        ms=k4_main["ms"], plain_ms=k4_main["plain_ms"],
                        bound_ms=k4_main["bound_ms"], bound_by=k4_main["bound_by"],
                        library_ms=k4_main["library_ms"]))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
