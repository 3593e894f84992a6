#!/usr/bin/env python3
"""Time flash attention and the dense prefill that runs it, on one CUDA card.

    python3 scripts/time_flash_attention.py [--src DIR] [--label NAME]

Imports ``repro_torch`` from ``--src`` (default: this checkout's ``src``),
so that two trees, say a parent commit unpacked beside this one and this
one, can be timed in turns (parent, change, change, parent) in one call on
one card.  Uses only what every version of the port has:
``flash_attention_pallas`` on contiguous inputs and ``build_model`` /
``jit_prefill``.  Prints the card's name and power limit, then one JSON
line:

* ``kernel_ms``: ``flash_attention_pallas`` at the main path's shape (q
  ``(4, 32, 1024, 64)`` bf16, kv heads 4, causal), a CUDA graph of 20
  launches replayed between CUDA events (``chip_smoke.device_ms``), with
  its TFLOP/s and its max |kernel - plain version|;
* ``prefill_ms``: TinyLlama-1.1B bf16 prefill of 4 prompts of 1024 seeded
  token ids on ``attn_backend="pallas"`` (seeded random weights), host
  clock around each of ``--prefills`` synchronised runs after a warm-up;
* ``prefill_busy_us`` / ``prefill_flash_us``: one more prefill under
  ``torch.profiler``, its device busy time and the flash kernel's share.
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
    parser.add_argument("--prefills", type=int, default=5)
    args = parser.parse_args()

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("time_flash_attention: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(Path(args.src).resolve()), str(ROOT)]
    import chip_smoke as smoke
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_pallas, flash_attention_plain)
    from repro_torch.models import build_model
    from repro_torch.serve.efm import jit_prefill

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(smoke.card_line())

    shape = (smoke.EFM_BATCH, 32, 4, smoke.EFM_PROMPT, 64, True)
    q, k, v = smoke.fa_inputs(torch, device, *shape[:5], torch.bfloat16, 0)
    err = float((flash_attention_pallas(q, k, v).float()
                 - flash_attention_plain(q, k, v).float()).abs().max())
    kernel_ms = smoke.device_ms(torch, lambda: flash_attention_pallas(q, k, v),
                                per_graph=20)
    _, _, flop = smoke.fa_bound(*shape, 2, smoke.BF16_FLOP_PER_S)
    del q, k, v

    cfg = get_config(smoke.EFM_ARCH).replace(
        attn_backend="pallas", param_dtype="bfloat16",
        compute_dtype="bfloat16", cache_dtype="bfloat16")
    model = build_model(cfg, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(smoke.SEED))
    rng = np.random.default_rng(smoke.SEED)
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab, (smoke.EFM_BATCH, smoke.EFM_PROMPT)),
        device=device)}
    prefill = jit_prefill(model)
    prefill(params, batch)  # warm-up
    torch.cuda.synchronize()
    prefill_ms = []
    for _ in range(args.prefills):
        t0 = time.perf_counter()
        prefill(params, batch)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prefill(params, batch)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in rows)
    flash = sum(e.self_device_time_total for e in rows
                if "flash" in e.key or "fa_wgmma" in e.key)
    print(json.dumps({
        "label": args.label, "src": args.src, "kernel_ms": kernel_ms,
        "kernel_tflops": flop / (kernel_ms * 1e-3) / 1e12,
        "kernel_max_abs_err": err, "prefill_ms": prefill_ms,
        "prefill_busy_us": busy, "prefill_flash_us": flash,
        "prefill_flash_share": flash / busy,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
