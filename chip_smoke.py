#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check its kernels.

    python3 chip_smoke.py            # from the root of a checkout

Phases, in order; any failure exits non-zero:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build the CUDA kernels from csrc/ with nvcc (seconds printed);
  3. K1 (conv3x3_bn_act) against its plain version at 64x64x512 -> 512,
     bf16, with and without the residual: errors, kernel / plain / library
     (cuDNN conv + epilogue) times and the bound;
  4. K2 (resblock_chain) likewise at 64x64x512, N=8;
  5. the main path: FULL Gbase, 512x512, batch 1, bf16 compute, seeded
     random weights with BatchNorm running statistics calibrated once from
     batch statistics; ReenactmentSession.set_source, then 8 drive frames
     with the G2d trunk on K2; launch counts, output checks, one frame
     against the plain trunk, drive frames/s;
  6. one JSON line listing every kernel with its numbers;
  7. last line: {"ok": true, "device": {...}}.

Times are CUDA-event medians of 5 samples after 2 warm-ups. The plain
versions are the float32 references (TF32 off for both cuDNN and matmul).
"""

import json
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
# One frame through the chain kernels vs the same frame through the plain
# (cuDNN bf16) trunk. Both round activations to bf16, at different places,
# across 16 convs, then 3 upsample blocks and a sigmoid; a first run on an
# H100 measured 0.062 max / 0.0078 mean abs between them. The sharp check is
# the trunk's: each bf16 trunk against a float32 trunk on the same input.
FRAME_MAX_ABS = 0.15
FRAME_MEAN_ABS = 0.02


def die(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        die(msg)


def time_ms(fn, reps=10):
    """Median over 5 samples of the mean of `reps` back-to-back calls."""
    import torch

    for _ in range(2):
        fn()
    samples = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(end) / reps)
    return statistics.median(samples)


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


def phase_kernels(torch, dev):
    from megaportraits_tpu_torch.ops.kernels import conv3x3 as k1
    from megaportraits_tpu_torch.ops.kernels import resblock_chain as k2

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    h = w = 64
    c = 512

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    # Variance-preserving weights keep bf16 activations in range.
    x = randn(h, w, c).bfloat16()
    w1 = (randn(3, 3, c, c) / (9 * c) ** 0.5).bfloat16()
    s1 = torch.rand(c, device=dev, generator=gen) * 0.5 + 0.5
    t1 = randn(c) * 0.1
    res = randn(h, w, c).bfloat16()
    w1_oihw = w1.permute(3, 2, 0, 1).contiguous()
    flops = 2.0 * h * w * c * c * 9

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
        ms = time_ms(lambda: k1.launch_conv3x3(x, w1, s1, t1, r, out, True))
        plain = time_ms(lambda: k1.conv3x3_bn_act_plain(x, w1, s1, t1, r))
        lib = time_ms(lambda: conv3x3_library(x, w1_oihw, s1, t1, r))
        bms, by = bound_ms(flops, nbytes(x, w1, s1, t1, r, got))
        k1_rows.append(dict(residual=r is not None, max_abs_err=err, rel_err=rel,
                            ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms,
                            bound_by=by))
        print(f"K1 conv3x3_bn_act 64x64x512->512 residual={r is not None}: "
              f"max_abs_err {err:.6g} rel {rel:.3g} | kernel {ms:.4f} ms, "
              f"plain {plain:.4f} ms, library {lib:.4f} ms, bound {bms:.4f} ms "
              f"({by}) -> {bms / ms:.1%} of bound")

    n = TRUNK_BLOCKS
    xs = randn(h, w, c).bfloat16()
    wts = (randn(n, 2, 3, 3, c, c) / (9 * c) ** 0.5).bfloat16()
    scs = torch.rand(n, 2, c, device=dev, generator=gen) * 0.2 + 0.4
    shs = randn(n, 2, c) * 0.05
    wts_oihw = [[wts[b, i].permute(3, 2, 0, 1).contiguous() for i in range(2)]
                for b in range(n)]
    got = k2.resblock_chain(xs, wts, scs, shs)
    torch.cuda.synchronize()
    want = k2.resblock_chain_plain(xs, wts, scs, shs)
    err, rel = errors(got, want)
    check(torch.isfinite(got.float()).all().item(), "K2 output not finite")
    # 16 convs, each rounding to bf16; the errors compound through residuals.
    check(rel <= 2 ** -5, f"K2 disagrees with its plain version: rel {rel}")

    def library_chain():
        cur = xs
        for b in range(n):
            hh = conv3x3_library(cur, wts_oihw[b][0], scs[b, 0], shs[b, 0])
            cur = conv3x3_library(hh, wts_oihw[b][1], scs[b, 1], shs[b, 1], cur)
        return cur

    ms = time_ms(lambda: k2.resblock_chain(xs, wts, scs, shs), reps=3)
    plain = time_ms(lambda: k2.resblock_chain_plain(xs, wts, scs, shs), reps=3)
    lib = time_ms(library_chain, reps=3)
    bms, by = bound_ms(flops * 2 * n, nbytes(xs, wts, scs, shs, got))
    print(f"K2 resblock_chain 64x64x512 N={n}: max_abs_err {err:.6g} rel {rel:.3g}"
          f" | kernel {ms:.4f} ms, plain {plain:.4f} ms, library (cuDNN chain) "
          f"{lib:.4f} ms, bound {bms:.4f} ms ({by}) -> {bms / ms:.1%} of bound")
    k2_row = dict(max_abs_err=err, rel_err=rel, ms=ms, plain_ms=plain,
                  library_ms=lib, bound_ms=bms, bound_by=by)
    return k1_rows, k2_row


def smooth_image(torch, gen, dev, size):
    """A seeded smooth RGB image in [0, 1], [1, size, size, 3]."""
    import torch.nn.functional as F

    coarse = torch.rand(1, 3, 12, 12, device=dev, generator=gen)
    img = F.interpolate(coarse, size=(size, size), mode="bicubic",
                        align_corners=False).clamp(0, 1)
    return img.permute(0, 2, 3, 1).contiguous()


def trunk_against_float32(torch, model, session, xd):
    """The G2d trunk of one frame three ways on the same input and bf16
    weights: K2, the plain bf16 blocks (cuDNN), and float32 activations
    (K2's plain version on float32). K2 must be no further from float32
    than twice the plain bf16 trunk is."""
    from megaportraits_tpu_torch.ops.kernels import resblock_chain as k2
    from megaportraits_tpu_torch.ops.warp import apply_warping_field

    g2d = model.g2d
    with torch.no_grad():
        rd, td, zd = model.motion_encoder(xd)
        state = session.source_state
        w_c2d = model.warp_generator_c2d(rd, td, zd, state["es"])
        projected = apply_warping_field(state["vc2d"], w_c2d,
                                        model.warp_normalize_mode).sum(dim=1)
        x = g2d.conv1x1(g2d.reshape_conv(projected))
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
    outs = [session(xd) for xd in frames]
    torch.cuda.synchronize()
    launches = {"conv3x3_bn_act": k1.conv3x3_bn_act.launches,
                "resblock_chain": k2.resblock_chain.launches}
    print(f"main path launches over {FRAMES} drive frames: {launches}")
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

    timings = {}
    for chain in (True, False):
        model.g2d.use_chain_kernel = chain
        timings[chain] = time_ms(lambda: session(frames[1]), reps=1)
    model.g2d.use_chain_kernel = True
    print(f"drive: {timings[True]:.3f} ms/frame = {1e3 / timings[True]:.2f} "
          f"frames/s with the trunk on K2; {timings[False]:.3f} ms/frame = "
          f"{1e3 / timings[False]:.2f} frames/s with the plain (cuDNN) trunk")
    return launches


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

    k1_rows, k2_row = phase_kernels(torch, dev)
    launches = phase_main_path(torch, dev)

    k1_main = k1_rows[0]
    kernels = [
        dict(name="conv3x3_bn_act", route="cuda",
             source="megaportraits_tpu_torch/csrc/conv3x3_bn_act.cu",
             replaces="megaportraits_tpu/ops/pallas/conv2d.py:65",
             launches=launches["conv3x3_bn_act"],
             max_abs_err=max(r["max_abs_err"] for r in k1_rows),
             ms=k1_main["ms"], plain_ms=k1_main["plain_ms"],
             bound_ms=k1_main["bound_ms"], bound_by=k1_main["bound_by"],
             library_ms=k1_main["library_ms"]),
        dict(name="resblock_chain", route="cuda",
             source="megaportraits_tpu_torch/ops/kernels/resblock_chain.py",
             replaces="megaportraits_tpu/ops/pallas/g2d_chain_v2.py:233",
             launches=launches["resblock_chain"], max_abs_err=k2_row["max_abs_err"],
             ms=k2_row["ms"], plain_ms=k2_row["plain_ms"],
             bound_ms=k2_row["bound_ms"], bound_by=k2_row["bound_by"],
             library_ms=k2_row["library_ms"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
