"""Where the time of one streaming drive frame goes, on the card.

    python -m megaportraits_tpu_torch.utils.profile_drive [--frames 5] [--trace DIR]

FULL Gbase, 512x512, batch 1, bf16 compute, seeded random weights with
calibrated BatchNorm statistics (as in chip_smoke.py). For the G2d trunk
on K2 and on the plain (cuDNN) blocks in turn, it prints:
  * wall ms/frame (host clock around frames ending in a synchronize);
  * the CUDA-event time of each stage of ``Gbase.drive``, run one by one;
  * from ``torch.profiler``: device kernel time per frame, the device's busy
    share of the wall time, and the kernels that take the most time.
"""

from __future__ import annotations

import argparse
import statistics
import time
from pathlib import Path

import torch


def _event_ms(fn, samples=5):
    for _ in range(2):
        fn()
    out = []
    for _ in range(samples):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def _stages(model, state, xd):
    """The stages of Gbase.drive as separately callable steps."""
    from megaportraits_tpu_torch.models.g2d import _up2
    from megaportraits_tpu_torch.ops.warp import apply_warping_field

    g2d = model.g2d
    memo = {}

    def emtn():
        memo["m"] = model.motion_encoder(xd)

    def warpgen():
        rd, td, zd = memo["m"]
        memo["w"] = model.warp_generator_c2d(rd, td, zd, state["es"])

    def warp():
        memo["p"] = apply_warping_field(state["vc2d"], memo["w"],
                                        model.warp_normalize_mode).sum(dim=1)

    def head():
        memo["h"] = g2d.conv1x1(g2d.reshape_conv(memo["p"]))

    def trunk():
        memo["t"] = g2d.trunk(memo["h"])

    def decoder():
        x = g2d.up3(_up2(g2d.up2(_up2(g2d.up1(_up2(memo["t"]))))))
        torch.sigmoid(g2d.final_conv(torch.relu(g2d.norm(x))).float())

    return [("Emtn", emtn), ("WarpGenerator c2d", warpgen),
            ("warp + depth sum", warp), ("G2d 1x1 head", head),
            ("G2d trunk", trunk), ("G2d decoder", decoder)]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--frames", type=int, default=5)
    parser.add_argument("--trace", type=Path, default=None,
                        help="directory for Chrome traces")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")

    from torch.profiler import ProfilerActivity, profile

    from megaportraits_tpu_torch.infer.streaming import ReenactmentSession
    from megaportraits_tpu_torch.models.gbase import build_gbase, calibrate_batch_norm

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    xs = torch.rand(1, 512, 512, 3, device=dev, generator=gen)
    xd = torch.rand(1, 512, 512, 3, device=dev, generator=gen)
    model = build_gbase("full", device=dev, seed=0)
    calibrate_batch_norm(model, xs, xd)
    session = ReenactmentSession(model=model)
    session.set_source(xs)
    print(f"device: {torch.cuda.get_device_name(0)}")

    for chain in (True, False):
        model.g2d.use_chain_kernel = chain
        label = "trunk on K2" if chain else "plain (cuDNN) trunk"
        for _ in range(3):
            session(xd)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.frames):
            session(xd)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / args.frames
        print(f"\n== {label}: wall {wall:.3f} ms/frame ({1e3 / wall:.2f} frames/s)")

        with torch.no_grad():
            for name, fn in _stages(model, session.source_state, xd):
                print(f"  stage {name:<20s} {_event_ms(fn):8.3f} ms")

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(args.frames):
                session(xd)
            torch.cuda.synchronize()
            pwall = (time.perf_counter() - t0) * 1e3 / args.frames
        events = prof.key_averages()
        dev_us = sum(e.self_device_time_total for e in events
                     if e.device_type == torch.autograd.DeviceType.CUDA)
        dev_ms = dev_us / 1e3 / args.frames
        if dev_ms == 0.0:
            print("  profiler: no device time recorded (busy share not measured)")
        else:
            print(f"  profiler: wall {pwall:.3f} ms/frame, device kernels "
                  f"{dev_ms:.3f} ms/frame, busy share {dev_ms / pwall:.1%}")
        top = sorted((e for e in events
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)[:12]
        for e in top:
            print(f"    {e.self_device_time_total / 1e3 / args.frames:8.3f} ms "
                  f"x{e.count / args.frames:5.1f}  {e.key[:90]}")
        if args.trace is not None:
            args.trace.mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(str(args.trace / f"drive_chain{int(chain)}.json"))


if __name__ == "__main__":
    main()
