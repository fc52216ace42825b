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
  5. the main path: FULL Gbase, 512x512, batch 1, bf16 compute, seeded
     random weights with BatchNorm running statistics calibrated once from
     batch statistics; ReenactmentSession.set_source, then 8 drive frames
     with the G2d trunk on K2; launch counts, the trunk operands folded
     once, output checks, one frame against the plain trunk, the trunk's
     time inside a frame, drive frames/s;
  6. K3's path, its own entry point (no model calls it, in JAX either):
     fused_resblock_chain on the G2d trunk input of each of those frames
     with the model's folded trunk parameters; launch counts, and each
     result equal to K2's on the same input bit for bit;
  7. stage-2 HR serving: FULL Gbase + Genh (GHR), batch 1; set_source at
     512, 4 drive frames at 512 with the trunk on K2, bilinear to 1024x1024
     (align_corners=False), Genh at 1024; launch counts, output checks,
     ms/frame and Genh's share of it;
  8. stage-3 serving: FULL Student, 4 avatars, 1024x1024, batch 1; 4 frames
     with two avatar indices; output checks, ms/frame;
  9. stage-1 training: init_states + make_train_step, FULL, 512x512, batch
     2, bf16 compute, Config() defaults, seeded weights and batches; 1
     warm-up and 3 timed steps with K1 and K2 switched on, which train mode
     must bypass (0 launches of K1, K2, K3); every metric of every step,
     ms/step, steps/s and peak memory beside the card's name and power
     limit; G and D moved, the rotation net and the loss nets bit for bit,
     G2d's BatchNorm statistics moved;
  10. serving from the trained weights: ReenactmentSession(bn_mode=
     'running'), set_source + 2 frames with the trunk on K2; the trunk's
     operands folded once more than before the steps, K2 once a frame,
     frames finite, the K2 trunk against float32 as in phase 5;
  11. Gbase remat (phase_remat): the stage-1 step of phase 9 under remat
     'none', 'selective' and 'full' at batch 2 and 'selective' at batch 4
     (stage1-base.yaml's batch), 1 warm-up and 2 timed steps each: ms/step
     and peak memory; 'selective' and 'full' must peak below 'none', and
     their first steps' metrics agree with 'none''s within 1e-3 relative.
     (Phase 9 and the drivers train with init_states' default, JAX's:
     'selective' at 512.)
  12. stage-2 training: init_hr_state + make_hr_train_step, FULL,
     stage2-hr.yaml's shapes (base 512, Genh at 1024, batch 2, lr 1e-5),
     bf16 compute, a seeded frozen Gbase with calibrated BatchNorms and its
     trunk on K2; 1 warm-up and 3 timed steps: every metric, ms/step,
     steps/s and peak memory beside the card's name and power limit; K2
     twice a step (once a sample) and K1 16 times each K2; Genh and its
     statistics moved, Gbase and VGG19 bit for bit; Genh's state through
     CheckpointManager and back into a fresh state, bit for bit, and one
     Genh frame from it within 1e-6;
  13. stage-3 training: init_student_state + make_student_train_step,
     FULL, stage3-student.yaml's shapes (512, batch 4, 4 avatars, lr 1e-4),
     the inline GHR teacher (calibrated, its trunk on K2); 1 warm-up and 3
     timed steps as in 11, K2 four times a step, the Student and its
     statistics moved, the teacher bit for bit; make_teacher_forward in
     'running' (K2 once a sample), 'batch' (no K2, no statistic changed)
     and include_enh=False ([0, 1]); one step on a batch with 'target01'
     (no teacher, no kernel);
  14. the training drivers (train/main_{base,hr,student}.py), FULL, in a
     temporary working directory, on 2 clips of 6 smooth frames written
     straight into EMODataset's npz cache at 512 and 1024 (no cv2 or PyYAML
     on the card's machine: Configs built here). Their Gbase's trunk is put
     on K2 from outside: a Config subclass whose make_gbase sets
     use_chain_kernel, and a wrapper of main_student's build_ghr.
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
     - stage 3: train_student at 512, batch 4, 4 steps, the teacher from a
       ghr_variables checkpoint written from the two exports (bit for bit
       after the steps); K2 4 a step.
     For each: steps/s on the host clock from the first batch request to
     the return, beside the bare step's CUDA-event ms of phases 9, 11 and
     12 (the gap is data, prefetch, logging, evaluation and saving), the
     time in checkpoint saves and in held-out evaluations (each timed on
     the host clock after a synchronise), the set-up time, the time the
     driver waited on the prefetch per step, the bytes copied
     host-to-device per step and the peak memory;
  15. the data-parallel path (phase_distributed), in phase 14's directory:
     an in-process NCCL group of one rank and a mesh over it; two plain
     stage-1 steps (FULL 512, batch 2) and one through the data-parallel
     path from the same state, whose gap to the plain step (metrics,
     parameters; both gaps printed) must be no larger than twice the two
     plain steps' gap; then the stage-3 driver for 2 steps under the group
     (mesh_shape {data: 1}) with K2 in the teacher (4 launches a step,
     counted in the JSON line), its checkpoint restored into a plain
     Student bit for bit;
  16. the pretrained bundle and eval (phase_bundle_eval): synthetic
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
  17. the stage-1 driver with use_gaze_loss (phase_driver_gaze): 512, batch
     2, 2 steps, pretrained_path at the bundle: the FAN provider
     installed, gaze_masks on every batch with their coverage, loss_G_gaze
     finite, the masks' ms a batch, the prefetch wait, steps/s;
  18. one JSON line listing every kernel with its numbers, the launches
     summed over the driven paths (phases 5, 7, 10 and 12 to 17);
  19. last line: {"ok": true, "device": {...}}.

Times are CUDA-event medians of 5 samples after 2 warm-ups (a training
step: of 3 after 1); the kernels, their plain versions and the library
yardsticks are timed with their launches queued behind a spinning card
(time_stats), the frames and the steps are not.
The plain versions are the float32 references (TF32 off for both cuDNN and
matmul). The library yardsticks run cuDNN with cudnn.benchmark on.
"""

import ast
import json
import math
import os
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
# and the residual comes by TMA; 12x20x40 has a C that is no multiple of 32.
CHAIN_RAGGED = [(40, 24, 256, 2), (9, 65, 96, 2), (128, 128, 256, 2),
                (12, 20, 40, 1)]
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


def trunk_against_float32(torch, model, session, xd):
    """The G2d trunk of one frame three ways on the same input and bf16
    weights: K2, the plain bf16 blocks (cuDNN), and float32 activations
    (K2's plain version on float32). K2 must be no further from float32
    than twice the plain bf16 trunk is."""
    from megaportraits_tpu_torch.ops.kernels import resblock_chain as k2

    g2d = model.g2d
    x = trunk_input(torch, model, session, xd)
    with torch.no_grad():
        weights, scales, shifts = g2d.trunk_chain_params()
        ref = k2.resblock_chain_plain(x[0].float(), weights.float(), scales, shifts)
        kern = k2.resblock_chain(x[0].contiguous(), weights, scales, shifts)
        plain = x
        for name in g2d.trunk_names:
            plain = getattr(g2d, name)(plain)
        plain = plain[0]
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


def phase_main_path(torch, dev):
    from megaportraits_tpu_torch.core.dtypes import DEFAULT_POLICY
    from megaportraits_tpu_torch.infer.streaming import ReenactmentSession
    from megaportraits_tpu_torch.models.gbase import build_gbase, calibrate_batch_norm
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
    model.g2d.use_chain_kernel = True
    k1.conv3x3_bn_act.launches = 0
    k2.resblock_chain.launches = 0
    session.set_source(xs)
    folds_before = model.g2d.trunk_cache.folds
    outs = [session(frames[0])]
    folds_first = model.g2d.trunk_cache.folds - folds_before
    outs += [session(xd) for xd in frames[1:]]
    torch.cuda.synchronize()
    launches = {"conv3x3_bn_act": k1.conv3x3_bn_act.launches,
                "resblock_chain": k2.resblock_chain.launches}
    folds_later = model.g2d.trunk_cache.folds - folds_before - folds_first
    print(f"main path launches over {FRAMES} drive frames: {launches}; trunk "
          f"operands folded {folds_first} time(s) in the first frame, "
          f"{folds_later} in the {FRAMES - 1} after it")
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
    model.g2d.use_chain_kernel = False
    plain_out = session(frames[0])
    diff = (plain_out - outs[0]).abs()
    print(f"chain vs plain trunk, one frame: max abs {diff.max().item():.6g}, "
          f"mean abs {diff.mean().item():.6g} (limits {FRAME_MAX_ABS}, "
          f"{FRAME_MEAN_ABS})")
    check(diff.max().item() <= FRAME_MAX_ABS, "chain frame differs (max)")
    check(diff.mean().item() <= FRAME_MEAN_ABS, "chain frame differs (mean)")

    # The trunk's time inside a frame: CUDA events around G2d.trunk, the
    # operand cache warm.
    trunk_events = []
    g2d_trunk = model.g2d.trunk

    def timed_trunk(x, train=False):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = g2d_trunk(x, train)
        end.record()
        trunk_events.append((start, end))
        return out

    timings, trunk_ms = {}, {}
    model.g2d.trunk = timed_trunk
    for chain in (True, False):
        model.g2d.use_chain_kernel = chain
        trunk_events.clear()
        timings[chain] = time_ms(lambda: session(frames[1]), reps=1)
        trunk_ms[chain] = statistics.median(
            a.elapsed_time(b) for a, b in trunk_events[2:])
    del model.g2d.trunk  # back to the class's method
    model.g2d.use_chain_kernel = True
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
    model.gbase.g2d.use_chain_kernel = True
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
    steps with K2 (use_chain_kernel) and K1 (use_pallas) switched on, which
    train mode must bypass: K1, K2 and K3 launch 0 times in the steps. G
    and D move, the rotation net and the loss nets stay bit for bit, G2d's
    BatchNorm statistics move. Then ReenactmentSession(bn_mode='running')
    on the trained Gbase: set_source + SERVE_FRAMES frames, the trunk's
    operands folded once more than before the steps (one frame was served
    before them), K2 once a frame, and the K2 trunk against float32."""
    from megaportraits_tpu_torch.core.config import Config
    from megaportraits_tpu_torch.core.dtypes import DEFAULT_POLICY
    from megaportraits_tpu_torch.infer.streaming import ReenactmentSession
    from megaportraits_tpu_torch.nn.blocks import ResBlock2D
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
    gbase.g2d.use_chain_kernel = True
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
    blocks = [m for m in gbase.modules() if isinstance(m, ResBlock2D)]
    for m in blocks:
        m.use_pallas = True
    check(len(trainable_parameters(gbase)) < len(list(gbase.parameters())),
          "the rotation net is not frozen")

    step = make_train_step(ploss, cfg)
    reset_counts()
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
    for m in blocks:
        m.use_pallas = False
    ms = statistics.median(step_ms[1:])
    print(f"train launches over {len(batches)} steps: {launches} (K1, K2 and K3 must "
          f"stay 0: train-mode BatchNorm cannot fold into them)")
    print(f"train: {ms:.3f} ms/step (median of {TRAIN_STEPS} after 1 warm-up; "
          f"samples {[round(t, 3) for t in step_ms]}) = {1e3 / ms:.3f} steps/s, "
          f"{batch * 1e3 / ms:.3f} samples/s; peak memory "
          f"{peak / 2 ** 30:.2f} GiB (max_memory_allocated) | {smi}")
    check(all(n == 0 for n in launches.values()), f"kernels launched in training: {launches}")
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
    gbase.g2d.use_chain_kernel = True
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
    gbase.g2d.use_chain_kernel = True
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
    teacher.gbase.g2d.use_chain_kernel = True
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
# written straight into EMODataset's npz cache: the card's machine has no cv2
# to decode mp4s, and no PyYAML, so each driver gets a Config built here.
DRIVER_CLIPS = 2
DRIVER_FRAMES = 6
DRIVER_STEPS = 4
DRIVER_RESUMED_STEPS = 6
DRIVER_HOLDOUT = 2


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


def driver_config(work, name, batch=TRAIN_BATCH, **training):
    """A FULL Config at TRAIN_SIZE whose Gbase runs its G2d trunk on K2
    (use_chain_kernel), the drivers' own defaults otherwise; clips from
    work/clips, checkpoints in work/name."""
    from megaportraits_tpu_torch.core.config import Config

    class K2Config(Config):
        def make_gbase(self, *args, **kwargs):
            gbase = super().make_gbase(*args, **kwargs)
            gbase.g2d.use_chain_kernel = True
            return gbase

    cfg = K2Config()
    cfg.data.train_width = cfg.data.train_height = TRAIN_SIZE
    t = cfg.training
    t.video_dir = str(work / "clips")
    t.json_file = str(work / "clips" / "meta.json")
    t.checkpoint_path = str(work / name)
    t.batch_size, t.n_sample_frames = batch, DRIVER_FRAMES
    for k, v in training.items():
        setattr(t, k, v)
    return cfg


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
    from megaportraits_tpu_torch.infer.inference import restore_gbase
    from megaportraits_tpu_torch.infer.streaming import ReenactmentSession
    from megaportraits_tpu_torch.train import main_base

    numbers, evaluators = [], []
    for unroll, max_steps, start in ((2, DRIVER_STEPS, 0),
                                     (1, DRIVER_RESUMED_STEPS, DRIVER_STEPS)):
        cfg = driver_config(work, "base", unroll_steps=unroll, save_interval=2,
                            log_interval=2, eval_interval=2,
                            holdout_frames=DRIVER_HOLDOUT)
        metrics, n = run_driver(torch, main_base, lambda: main_base.train_base(
            cfg, max_steps, device=dev), max_steps - start)
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

    gbase = driver_config(work, "base").make_gbase(device=dev, seed=99)
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
    from megaportraits_tpu_torch.models.genh import build_genh
    from megaportraits_tpu_torch.train import main_hr

    cfg = driver_config(work, "hr", save_interval=2, log_interval=2, eval_interval=2,
                        holdout_frames=DRIVER_HOLDOUT, lr=HR_TRAIN["lr"])
    frozen = []
    build_step = main_hr.make_hr_train_step

    def keeping_gbase(genh, gbase, *args, **kwargs):
        frozen.append(gbase)
        return build_step(genh, gbase, *args, **kwargs)

    with Patched(main_hr, make_hr_train_step=keeping_gbase):
        metrics, n = run_driver(torch, main_hr, lambda: main_hr.train_hr(
            cfg, DRIVER_STEPS, gbase_ckpt=str(work / "base"), device=dev), DRIVER_STEPS)
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


def phase_driver_student(torch, dev, smi, work, bare_ms):
    """Stage-3 driver: train_student, FULL, 512, batch 4, 4 avatars,
    DRIVER_STEPS steps; the teacher restored from a {"ghr_variables"}
    checkpoint written here from the stage-1 and stage-2 exports, its
    trunk switched onto K2 by wrapping the driver's build_ghr. K2 4 times a
    step; the teacher bit for bit as saved, before and after the steps."""
    from megaportraits_tpu_torch.core.checkpoint import CheckpointManager
    from megaportraits_tpu_torch.infer.inference import restore_gbase
    from megaportraits_tpu_torch.models.genh import build_ghr
    from megaportraits_tpu_torch.train import main_student

    ghr = build_ghr("full", device=dev, seed=2)
    check(restore_gbase(ghr.gbase, [str(work / "base" / "export")]), "no stage-1 export")
    check(CheckpointManager(str(work / "hr" / "export")).restore(
        {"genh_variables": ghr.genh}) is not None, "no stage-2 export")
    check(CheckpointManager(str(work / "teacher")).save(0, {"ghr_variables": ghr}),
          "the teacher was not saved")
    saved = {k: v.detach().cpu().clone() for k, v in ghr.state_dict().items()}
    del ghr

    teachers = []

    def k2_teacher(*args, **kwargs):
        teacher = build_ghr(*args, **kwargs)
        teacher.gbase.g2d.use_chain_kernel = True
        teachers.append(teacher)
        return teacher

    cfg = driver_config(work, "student", batch=STUDENT_TRAIN["batch"], save_interval=2,
                        log_interval=2, lr=STUDENT_TRAIN["lr"],
                        num_avatars=STUDENT_TRAIN["avatars"])
    with Patched(main_student, build_ghr=k2_teacher):
        metrics, n = run_driver(torch, main_student, lambda: main_student.train_student(
            cfg, DRIVER_STEPS, teacher_ckpt=str(work / "teacher"), device=dev),
            DRIVER_STEPS)
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
    from megaportraits_tpu_torch.core.config import Config
    from megaportraits_tpu_torch.core.dtypes import DEFAULT_POLICY
    from megaportraits_tpu_torch.models.genh import build_ghr
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

        teachers = []

        def k2_teacher(*args, **kwargs):
            teacher = build_ghr(*args, **kwargs)
            teacher.gbase.g2d.use_chain_kernel = True
            teachers.append(teacher)
            return teacher

        cfg = driver_config(work, "student_dp", batch=student_batch, save_interval=2,
                            log_interval=1, lr=STUDENT_TRAIN["lr"],
                            num_avatars=STUDENT_TRAIN["avatars"], mesh_shape={"data": 1})
        with Patched(main_student, build_ghr=k2_teacher):
            metrics, n = run_driver(torch, main_student, lambda: main_student.train_student(
                cfg, driver_steps, teacher_ckpt=str(work / "teacher"), device=dev),
                driver_steps)
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
    _, state = init_student_state(cfg, seed=1, policy=policy, image_size=TRAIN_SIZE,
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
            hr = phase_driver_hr(torch, dev, smi, work, bare["hr"], base.pop("best"))
            torch.cuda.empty_cache()
            student = phase_driver_student(torch, dev, smi, work, bare["student"])
            torch.cuda.empty_cache()
            distributed = phase_distributed(torch, dev, smi, work)
        finally:
            os.chdir(here)
    return [base["launches"], hr["launches"], student["launches"], distributed["launches"]]


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
    model.g2d.use_chain_kernel = True
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
    cfg = driver_config(work, "gaze", use_gaze_loss=True, pretrained_path=str(bundle),
                        log_interval=1, save_interval=steps)
    cfg.data.train_width = cfg.data.train_height = size
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
            metrics, n = run_driver(torch, main_base, lambda: main_base.train_base(
                cfg, steps, device=dev), steps)
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
    check(cfg.model.arch != "full" or pretrained_line == [
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
    launches, model, session, frames = phase_main_path(torch, dev)
    k3_launches = phase_k3_path(torch, model, session, frames)
    del model, session, frames
    torch.cuda.empty_cache()
    paths = [launches]
    paths.append(phase_hr(torch, dev)["launches"])
    torch.cuda.empty_cache()
    phase_student(torch, dev)
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

    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        result = phase_bundle_eval(torch, dev, smi, work)
        paths.append(result["launches"])
        torch.cuda.empty_cache()
        paths.append(phase_driver_gaze(torch, dev, smi, work, result["bundle"],
                                       bare["base"])["launches"])
    # Launches over every driven path: stage 1, HR serving, serving after
    # stage-1 training, the HR step, the Student step and its teacher, the
    # three drivers (serving the stage-1 export included), the stage-3
    # driver under the process group, the frames that eval scores and the
    # stage-1 driver with the gaze term.
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
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
