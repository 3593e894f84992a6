#!/usr/bin/env python3
"""Where the time of the PyTorch port's main path goes, on one CUDA card.

    python3 scripts/profile_torch_main_path.py [--src DIR] [--label NAME]
        [--backends fused,ref]

Imports ``repro_torch`` from ``--src`` (default: this checkout's ``src``),
so that a parent tree unpacked beside this one and this one can be
profiled in turns in one call on one card.  Builds the stream and networks
of ``chip_smoke.py`` (same seed; its helpers come from this checkout), then,
for each backend of ``--backends`` (default ``"fused"``, the default, and
``"ref"``): one warm-up session, one timed session (host clock, no
profiler), one session under ``torch.profiler``.  Prints per backend: wall
time per frame, device busy time per frame (the sum of the device-side
events: kernels, copies, sets) and the idle share it leaves of the
unprofiled wall time, device launches per frame, device busy time and
launches per processed frame, and the device time by kernel.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--src", default=str(ROOT / "src"))
    parser.add_argument("--label", default="")
    parser.add_argument("--backends", default="fused,ref")
    args = parser.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(Path(args.src).resolve()), str(ROOT)]
    import chip_smoke

    from repro_torch.api import EPICCompressor, SensorChunk, iter_chunks
    from repro_torch.core import pipeline as pipe

    device = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False  # as chip_smoke.py phase 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    print(chip_smoke.card_line(), args.label, args.src)
    stream, _, models = chip_smoke.main_path_inputs(torch, device)
    n_frames = stream[0].shape[0]

    for backend in args.backends.split(","):
        comp = EPICCompressor(pipe.EPICConfig(backend=backend), models,
                              device=device)

        def session():
            state = comp.init()
            processed = 0
            for chunk in iter_chunks(SensorChunk(*stream), chip_smoke.CHUNK):
                state, stats = comp.step(state, chunk)
                processed += int(stats.processed.sum())
            torch.cuda.synchronize()
            return processed

        session()  # warm-up
        t0 = time.perf_counter()
        processed = session()
        wall_us = (time.perf_counter() - t0) * 1e6
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            session()
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        busy_us = sum(e.self_device_time_total for e in rows)
        launches = sum(e.count for e in rows)
        print(f"\n[{backend}] {n_frames} frames ({processed} processed): "
              f"wall {wall_us / n_frames:.1f} us/frame, device busy "
              f"{busy_us / n_frames:.1f} us/frame, idle share "
              f"{1 - busy_us / wall_us:.3f}, device launches "
              f"{launches / n_frames:.1f}/frame; per processed frame: "
              f"device busy {busy_us / processed:.2f} us, device launches "
              f"{launches / processed:.2f}")
        for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:15]:
            print(f"  {e.self_device_time_total / n_frames:9.2f} us/frame "
                  f"{e.count:6d} x  {e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
