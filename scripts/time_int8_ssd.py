#!/usr/bin/env python3
"""Time the int8 depth stage and the Mamba-2 SSD scan, with the paths that
run them, on one CUDA card.

    python3 scripts/time_int8_ssd.py [--src DIR] [--label NAME]

Imports ``repro_torch`` from ``--src`` (default: this checkout's ``src``),
so that two trees, say a parent commit unpacked beside this one and this
one, can be timed in turns (parent, change, change, parent) in one call on
one card.  Uses only what every version of the port since the int8 and
SSD kernels has: ``int8_matmul_pallas``, ``forward_int8`` on
``matmul_backend="pallas"`` through ``predict_fullres``, ``EPICCompressor``,
``mamba2_ssd_pallas``, ``build_model`` / ``jit_prefill``.  The helpers
(inputs, ``device_ms``, ``device_profile``) come from this checkout's
``chip_smoke.py``.
Prints the card's name and power limit, then one JSON line:

* ``i8_products_us``: ``int8_matmul_pallas`` at the depth network's 8
  shapes of one frame (random int8 operands), CUDA-graph replay between
  CUDA events (``chip_smoke.device_ms``), summed;
* ``depth_us`` / ``depth_launches``: the int8 depth stage
  (``predict_fullres`` of one 128x128 frame on ``"pallas"``) in CUDA-graph
  replay, and its device kernels counted under ``torch.profiler``;
* ``int8_fps``: the int8 compressor (``EPICConfig()``, 96 frames in chunks
  of 8, as ``chip_smoke.py`` phase 11), frames/s on the host clock;
* ``ssd_ms`` / ``ssd_max_abs_err``: ``mamba2_ssd_pallas`` at x (4, 80,
  1024, 64) float32 in the model's (B, T, H, P) layout, N 64, chunk 64,
  and its largest difference from ``mamba2_ssd_chunked``;
* ``prefill_ms``: Zamba2-2.7B bf16 prefill of 4 prompts of 1024 seeded
  token ids on ``scan_backend="pallas"`` (seeded random weights), host
  clock around each of ``--prefills`` synchronised runs after a warm-up;
  ``prefill_busy_us`` / ``prefill_ssd_us`` / ``prefill_launches``: one
  more prefill under ``torch.profiler``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--src", default=str(ROOT / "src"))
    parser.add_argument("--label", default="")
    parser.add_argument("--prefills", type=int, default=3)
    args = parser.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_int8_ssd: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(Path(args.src).resolve()), str(ROOT)]
    import chip_smoke as smoke
    from repro_torch.api import EPICCompressor
    from repro_torch.configs import get_config
    from repro_torch.core import depth as depth_mod
    from repro_torch.core import pipeline as pipe
    from repro_torch.kernels.int8_matmul.kernel import int8_matmul_pallas
    from repro_torch.kernels.mamba2_ssd.chunked import mamba2_ssd_chunked
    from repro_torch.kernels.mamba2_ssd.kernel import mamba2_ssd_pallas
    from repro_torch.models import build_model
    from repro_torch.serve.efm import jit_prefill

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smoke.card_line())
    out = {"label": args.label, "src": args.src}

    g = torch.Generator(device=device).manual_seed(smoke.SEED)
    products = []
    for _, m, k, n in smoke.DEPTH_GEMMS:
        a, b = (torch.randint(-127, 128, shape, generator=g, device=device,
                              dtype=torch.int8) for shape in ((m, k), (k, n)))
        products.append(smoke.device_ms(torch,
                                        lambda: int8_matmul_pallas(a, b)))
    out["i8_products_us"] = sum(products) * 1e3

    stream, _, models = smoke.main_path_inputs(torch, device)
    qmodels = smoke.quantised_models(torch, device, models)
    qmodels.depth_model.matmul_backend = "pallas"
    frame = stream[0][0]
    out["depth_us"] = smoke.device_ms(
        torch, lambda: depth_mod.predict_fullres(qmodels.depth_model, frame),
        per_graph=20) * 1e3
    out["depth_launches"] = smoke.device_profile(
        torch, lambda: depth_mod.predict_fullres(qmodels.depth_model,
                                                 frame))[1]
    comp = EPICCompressor(pipe.EPICConfig(), qmodels, device=device)
    smoke.run_session(torch, comp, tuple(x[:smoke.CHUNK] for x in stream),
                      device)
    secs = smoke.run_session(torch, comp, stream, device)[-1]
    out["int8_fps"] = smoke.N_FRAMES / secs
    del comp, qmodels, models, stream

    *dims, chunk = smoke.SSD_FULL
    ssd_args = smoke.ssd_inputs(torch, device, *dims, torch.float32,
                                smoke.SEED, native=True)
    y, s = mamba2_ssd_pallas(*ssd_args, chunk=chunk)
    py, ps = mamba2_ssd_chunked(*ssd_args, chunk=chunk)
    out["ssd_max_abs_err"] = max(float((y - py).abs().max()),
                                 float((s - ps).abs().max()))
    del y, s, py, ps
    out["ssd_ms"] = smoke.device_ms(
        torch, lambda: mamba2_ssd_pallas(*ssd_args, chunk=chunk),
        per_graph=5, replays=10)
    del ssd_args

    cfg = get_config("zamba2-2.7b").replace(
        param_dtype="bfloat16", compute_dtype="bfloat16",
        cache_dtype="bfloat16")
    model = build_model(cfg, device=device, scan_backend="pallas")
    params = model.init(torch.Generator(device=device).manual_seed(smoke.SEED))
    rng = np.random.default_rng(smoke.SEED)
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab, (smoke.EFM_BATCH, smoke.EFM_PROMPT)),
        device=device)}
    prefill = jit_prefill(model)
    prefill(params, batch)  # warm-up
    torch.cuda.synchronize()
    out["prefill_ms"] = []
    for _ in range(args.prefills):
        t0 = time.perf_counter()
        prefill(params, batch)
        torch.cuda.synchronize()
        out["prefill_ms"].append((time.perf_counter() - t0) * 1e3)
    busy, launches, rows = smoke.device_profile(
        torch, lambda: prefill(params, batch))
    ssd = sum(e.self_device_time_total for e in rows if "ssd" in e.key)
    out.update(prefill_busy_us=busy, prefill_ssd_us=ssd,
               prefill_ssd_share=ssd / busy, prefill_launches=launches)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
