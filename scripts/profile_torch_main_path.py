#!/usr/bin/env python3
"""Where the time of the PyTorch port's main path goes, on one CUDA card.

    python3 scripts/profile_torch_main_path.py

Builds the stream and networks of ``chip_smoke.py`` (same seed), then, for
the default ``"fused"`` backend and for ``"ref"``: one warm-up session, one
timed session (host clock, no profiler), one session under
``torch.profiler``.  Prints per backend: wall time per frame, device busy
time per frame (the sum of the device-side events: kernels, copies, sets)
and the idle share it leaves of the unprofiled wall time, device launches
per frame, and the device time by kernel.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke

    from repro_torch.api import EPICCompressor, SensorChunk, iter_chunks
    from repro_torch.core import pipeline as pipe

    device = torch.device("cuda", 0)
    print(chip_smoke.card_line())
    chip_smoke.phase_build(torch)
    stream, _, models = chip_smoke.main_path_inputs(torch, device)
    n_frames = stream[0].shape[0]

    for backend in ("fused", "ref"):
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
              f"{launches / n_frames:.1f}/frame")
        for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:15]:
            print(f"  {e.self_device_time_total / n_frames:9.2f} us/frame "
                  f"{e.count:6d} x  {e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
