#!/usr/bin/env python3
"""Time flash attention and the prefills that run it, on one CUDA card.

    python3 scripts/time_flash_attention.py [--src DIR] [--label NAME]

Imports ``repro_torch`` from ``--src`` (default: this checkout's ``src``),
so that two trees, say a parent commit unpacked beside this one and this
one, can be timed in turns (parent, change, change, parent) in one call on
one card.  Uses only what every version of the port has:
``flash_attention_pallas`` on contiguous inputs and ``build_model`` /
``jit_prefill``.  Prints the card's name and power limit, then one JSON
line; kernel times are CUDA graphs of many launches replayed between CUDA
events (``chip_smoke.device_ms``), prefill times the host clock around
each of ``--prefills`` synchronised runs after a warm-up:

* ``kernel_ms``: ``flash_attention_pallas`` at the main path's shape (q
  ``(4, 32, 1024, 64)`` bf16, kv heads 4, causal), with its TFLOP/s and
  its max |kernel - plain version|; ``f32_kernel_ms``: the same in float32;
  ``d160_kernel_ms``: bf16 at Zamba2-2.7B's shared attention (q ``(4, 32,
  1024, 160)``, kv heads 32, causal), null where the tree has no instance
  for it; each with ``*_sdpa_ms``, ``F.scaled_dot_product_attention`` on
  the same inputs (a yardstick the port never calls);
* ``prefill_ms`` / ``f32_prefill_ms``: TinyLlama-1.1B prefill of 4 prompts
  of 1024 seeded token ids on ``attn_backend="pallas"`` (seeded random
  weights) in bf16 and in float32; ``prefill_busy_us`` /
  ``prefill_flash_us``: one more bf16 prefill under ``torch.profiler``,
  its device busy time and the flash kernel's share;
* ``zamba_prefill_ms``: Zamba2-2.7B bf16 prefill of the same prompts on
  ``scan_backend="pallas"`` and ``attn_backend="pallas"`` (a tree whose
  hybrid prefill ignores ``attn_backend`` runs its attention on the masked
  path), with ``zamba_busy_us`` / ``zamba_flash_us`` from one profiled
  prefill.
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
    import torch.nn.functional as F
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
    out = {"label": args.label, "src": args.src}

    def kernel(key, shape, dtype, peak):
        q, k, v = smoke.fa_inputs(torch, device, *shape[:5], dtype, 0)
        try:
            o = flash_attention_pallas(q, k, v)
        except ValueError as e:  # no instance for this (dtype, head dim)
            print(f"{key}: {e}")
            out.update({f"{key}_ms": None, f"{key}_sdpa_ms": None})
            return
        out[f"{key}_max_abs_err"] = float(
            (o.float() - flash_attention_plain(q, k, v).float()).abs().max())
        ms = smoke.device_ms(torch, lambda: flash_attention_pallas(q, k, v),
                             per_graph=10)
        _, _, flop = smoke.fa_bound(*shape, q.element_size(), peak)
        out[f"{key}_ms"] = ms
        out[f"{key}_tflops"] = flop / (ms * 1e-3) / 1e12
        out[f"{key}_sdpa_ms"] = smoke.device_ms(
            torch, lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), per_graph=10)
        del q, k, v, o
        torch.cuda.empty_cache()

    main = (smoke.EFM_BATCH, 32, 4, smoke.EFM_PROMPT, 64, True)
    kernel("kernel", main, torch.bfloat16, smoke.BF16_FLOP_PER_S)
    kernel("f32_kernel", main, torch.float32, smoke.FP32_FLOP_PER_S)
    kernel("d160_kernel", smoke.ZAMBA_ATTN, torch.bfloat16,
           smoke.BF16_FLOP_PER_S)

    rng = np.random.default_rng(smoke.SEED)
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, 32000, (smoke.EFM_BATCH, smoke.EFM_PROMPT)),
        device=device)}

    def prefill_times(arch, dtype, key, **kw):
        cfg = get_config(arch).replace(
            attn_backend="pallas", param_dtype=dtype, compute_dtype=dtype,
            cache_dtype=dtype)
        assert cfg.vocab >= 32000
        model = build_model(cfg, device=device, **kw)
        params = model.init(
            torch.Generator(device=device).manual_seed(smoke.SEED))
        prefill = jit_prefill(model)
        prefill(params, batch)  # warm-up
        torch.cuda.synchronize()
        times = []
        for _ in range(args.prefills):
            t0 = time.perf_counter()
            prefill(params, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[f"{key}_ms"] = times
        return prefill, params

    def profile_prefill(prefill, params, key):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            prefill(params, batch)
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in rows)
        flash = sum(e.self_device_time_total for e in rows
                    if "flash" in e.key or "fa_" in e.key)
        out.update({f"{key}_busy_us": busy, f"{key}_flash_us": flash,
                    f"{key}_flash_share": flash / busy})

    prefill, params = prefill_times(smoke.EFM_ARCH, "bfloat16", "prefill")
    profile_prefill(prefill, params, "prefill")
    del prefill, params
    torch.cuda.empty_cache()
    prefill_times(smoke.EFM_ARCH, "float32", "f32_prefill")
    torch.cuda.empty_cache()
    prefill, params = prefill_times("zamba2-2.7b", "bfloat16",
                                    "zamba_prefill", scan_backend="pallas")
    profile_prefill(prefill, params, "zamba")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
