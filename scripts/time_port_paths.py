#!/usr/bin/env python3
"""Time the reproject-match launches, the int8 depth stage and the two scans
(Mamba-2 SSD, RWKV6), with the paths that run them, on one CUDA card.

    python3 scripts/time_port_paths.py [--src DIR] [--label NAME]
        [--paths rm,int8,solo,ssd,rwkv,efm] [--prefills N] [--sessions N]
        [--decodes N]

Imports ``repro_torch`` from ``--src`` (default: this checkout's ``src``),
so that two trees, say a parent commit unpacked beside this one and this
one, can be timed in turns (parent, change, change, parent) in one call on
one card.  Uses only what every version of the port since the int8 and
scan kernels has: ``int8_matmul_pallas``, ``forward_int8`` on
``matmul_backend="pallas"`` through ``predict_fullres``, ``EPICCompressor``,
``mamba2_ssd_pallas``, ``rwkv6_scan_pallas``, ``build_model`` /
``jit_prefill``.  The helpers (inputs, ``device_ms``, ``device_profile``)
come from this checkout's ``chip_smoke.py``.  ``--paths`` picks what is
timed (int8, ssd and rwkv by default).
Prints the card's name and power limit, then one JSON line:

* ``launch_floor_us``: a one-element elementwise launch (``add_``) in
  CUDA-graph replay between CUDA events, the least a launch costs there;
* ``rm_{pallas,tiled,fused}_us``: the three reproject-match wrappers at
  the main path's shapes (``chip_smoke.make_inputs``: N = 192, K = 24 for
  the tiled launch, P = 16, 128x128 frame, window 32), in CUDA-graph
  replay (``rm_pallas_k24_us``: the per-entry launch on the tiled launch's
  inputs, K = 24, timed right after it); ``..._scale_us``: the same at
  N = 3072 and a 512x512 frame (scale, not the main path); ``..._launches``: device kernels of one call
  at the main shape under ``torch.profiler``; ``rm_fused_host_us``: host
  time of one solo ``reproject_match_fused`` call at the main shape (the
  mean of 2000 calls in a row, which the host, not the card, paces) and,
  where the tree has it, ``rm_fused_op_host_us``: the same launch through
  the custom op ``repro_torch::rm_fused`` on a slot of one (the serving
  pool's route);
* ``i8_products_us``: ``int8_matmul_pallas`` at the depth network's 8
  shapes of one frame (random int8 operands), CUDA-graph replay between
  CUDA events (``chip_smoke.device_ms``), summed;
* ``depth_us`` / ``depth_launches``: the int8 depth stage
  (``predict_fullres`` of one 128x128 frame on ``"pallas"``) in CUDA-graph
  replay, and its device kernels counted under ``torch.profiler``;
* ``int8_fps``: the int8 compressor (``EPICConfig()``, 96 frames in chunks
  of 8, as ``chip_smoke.py`` phase 11), frames/s on the host clock;
* ``solo_{fp32,int8}_fps``: one solo ``EPICCompressor`` session
  (``EPICConfig()``, the default ``"fused"`` backend, the depth and HIR
  networks; fp32 depth as ``chip_smoke.py`` phase 4's first run, int8
  depth on the fused launch as phase 11's), 96 frames in chunks of 8,
  frames/s on the host clock for each of ``--sessions`` runs after a
  warm-up chunk; ``solo_{fp32,int8}_chunk_ms``: the median step of one
  chunk in a run that synchronises after every chunk (what a live stream
  waits for);
* ``ssd_ms`` / ``ssd_max_abs_err``: ``mamba2_ssd_pallas`` at x (4, 80,
  1024, 64) float32 in the model's (B, T, H, P) layout, N 64, chunk 64,
  and its largest difference from ``mamba2_ssd_chunked``;
* ``ssd_prefill_ms``: Zamba2-2.7B bf16 prefill of 4 prompts of 1024
  seeded token ids on ``scan_backend="pallas"`` (seeded random weights),
  host clock around each of ``--prefills`` synchronised runs after a
  warm-up; ``ssd_prefill_busy_us`` / ``_scan_us`` / ``_scan_share`` /
  ``_launches``: one more prefill under ``torch.profiler`` (its device
  time, the time and share of the kernels whose name holds ``ssd``, its
  device launches);
* ``rwkv_ms`` / ``rwkv_max_abs_err``: ``rwkv6_scan_pallas`` at r (4, 40,
  1024, 64) bf16 in the model's (B, T, H, K) layout, chunk 32, and its
  largest difference from ``rwkv6_scan_chunked``; ``rwkv_prefill_*``: the
  same as for the SSD, for RWKV6-3B (kernels whose name holds ``rwkv``);
* ``efm_decode_ms_step``: ``chip_smoke.py`` phase 7's bf16 ``"pallas"``
  run (TinyLlama-1.1B, ``mesh=None``, 4 prompts of 1024 seeded token
  ids, seeded random weights): ``greedy_decode_loop`` of 32 tokens after
  one prefill, host clock over the loop divided by its steps, for each of
  ``--decodes`` runs after a warm-up run, each from a fresh copy of the
  prefill's padded cache.
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
    parser.add_argument("--paths", default="int8,ssd,rwkv")
    parser.add_argument("--sessions", type=int, default=5)
    parser.add_argument("--decodes", type=int, default=5)
    args = parser.parse_args()
    paths = set(args.paths.split(","))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_port_paths: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(Path(args.src).resolve()), str(ROOT)]
    import chip_smoke as smoke
    from repro_torch.api import EPICCompressor, SensorChunk, iter_chunks
    from repro_torch.configs import get_config
    from repro_torch.core import depth as depth_mod
    from repro_torch.core import pipeline as pipe
    from repro_torch.kernels.int8_matmul.kernel import int8_matmul_pallas
    from repro_torch.kernels.mamba2_ssd.chunked import mamba2_ssd_chunked
    from repro_torch.kernels.mamba2_ssd.kernel import mamba2_ssd_pallas
    from repro_torch.kernels.rwkv6_scan.chunked import rwkv6_scan_chunked
    from repro_torch.kernels.rwkv6_scan.kernel import rwkv6_scan_pallas
    from repro_torch.models import build_model
    from repro_torch.serve.efm import (greedy_decode_loop, jit_prefill,
                                       pad_for_decode)

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smoke.card_line())
    out = {"label": args.label, "src": args.src}

    def scan(key, make, kernel, plain, shape, dtype):
        *dims, chunk = shape
        scan_args = make(torch, device, *dims, dtype, smoke.SEED,
                         native=True)
        o, s = kernel(*scan_args, chunk=chunk)
        po, ps = plain(*scan_args, chunk=chunk)
        out[f"{key}_max_abs_err"] = max(float((o - po).abs().max()),
                                        float((s - ps).abs().max()))
        del o, s, po, ps
        out[f"{key}_ms"] = smoke.device_ms(
            torch, lambda: kernel(*scan_args, chunk=chunk), per_graph=5,
            replays=10)

    def prefill(key, arch, focus):
        cfg = get_config(arch).replace(
            param_dtype="bfloat16", compute_dtype="bfloat16",
            cache_dtype="bfloat16")
        model = build_model(cfg, device=device, scan_backend="pallas")
        params = model.init(
            torch.Generator(device=device).manual_seed(smoke.SEED))
        rng = np.random.default_rng(smoke.SEED)
        batch = {"tokens": torch.as_tensor(
            rng.integers(0, cfg.vocab, (smoke.EFM_BATCH, smoke.EFM_PROMPT)),
            device=device)}
        run = jit_prefill(model)
        run(params, batch)  # warm-up
        torch.cuda.synchronize()
        walls = []
        for _ in range(args.prefills):
            t0 = time.perf_counter()
            run(params, batch)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        busy, launches, rows = smoke.device_profile(
            torch, lambda: run(params, batch))
        mine = sum(e.self_device_time_total for e in rows if focus in e.key)
        out.update({f"{key}_prefill_ms": walls,
                    f"{key}_prefill_busy_us": busy,
                    f"{key}_prefill_scan_us": mine,
                    f"{key}_prefill_scan_share": mine / busy,
                    f"{key}_prefill_launches": launches})
        del params, model
        torch.cuda.empty_cache()

    def host_us(call, key, calls=2000):
        for _ in range(100):
            call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
        out[key] = (time.perf_counter() - t0) / calls * 1e6

    if "rm" in paths:
        out["launch_floor_us"] = smoke.launch_floor_ms(torch, device) * 1e3
        for label, (n_main, p, hw), per_graph in (
                ("", (None, 16, 128), 50), ("_scale", smoke.RM_SCALE, 20)):
            for name, short in (("reproject_match_pallas", "pallas"),
                                ("reproject_match_pallas_tiled", "tiled"),
                                ("reproject_match_fused", "fused")):
                n = n_main or smoke.RM_SHAPES[name]
                rm_args, intr = smoke.make_inputs(torch, device, n, p, hw,
                                                  smoke.SEED)
                call = smoke.rm_calls(torch, rm_args, intr)[name][0]
                out[f"rm_{short}{label}_us"] = smoke.device_ms(
                    torch, call, per_graph=per_graph) * 1e3
                if not label:
                    out[f"rm_{short}_launches"] = smoke.device_profile(
                        torch, call)[1]
                if short == "fused" and not label:
                    host_us(call, "rm_fused_host_us")
                    op = getattr(sys.modules[
                        "repro_torch.kernels.reproject_match.fused"],
                        "rm_fused", None)
                    if op is not None:
                        host_us(lambda: op(
                            *(x[None] for x in rm_args), intr.f, intr.cx,
                            intr.cy, 32, smoke.TAU, smoke.O_MIN,
                            smoke.C_MIN), "rm_fused_op_host_us")
                if short == "tiled" and not label:  # on the same inputs
                    out["rm_pallas_k24_us"] = smoke.device_ms(
                        torch, smoke.rm_calls(torch, rm_args, intr)[
                            "reproject_match_pallas"][0]) * 1e3
    if "int8" in paths:
        g = torch.Generator(device=device).manual_seed(smoke.SEED)
        products = []
        for _, m, k, n in smoke.DEPTH_GEMMS:
            a, b = (torch.randint(-127, 128, shape, generator=g,
                                  device=device, dtype=torch.int8)
                    for shape in ((m, k), (k, n)))
            products.append(smoke.device_ms(
                torch, lambda: int8_matmul_pallas(a, b)))
        out["i8_products_us"] = sum(products) * 1e3

        stream, _, models = smoke.main_path_inputs(torch, device)
        qmodels = smoke.quantised_models(torch, device, models)
        qmodels.depth_model.matmul_backend = "pallas"
        frame = stream[0][0]
        out["depth_us"] = smoke.device_ms(
            torch,
            lambda: depth_mod.predict_fullres(qmodels.depth_model, frame),
            per_graph=20) * 1e3
        out["depth_launches"] = smoke.device_profile(
            torch, lambda: depth_mod.predict_fullres(qmodels.depth_model,
                                                     frame))[1]
        comp = EPICCompressor(pipe.EPICConfig(), qmodels, device=device)
        smoke.run_session(torch, comp, tuple(x[:smoke.CHUNK]
                                             for x in stream), device)
        secs = smoke.run_session(torch, comp, stream, device)[-1]
        out["int8_fps"] = smoke.N_FRAMES / secs
        del comp, qmodels, models, stream
    if "solo" in paths:
        stream, _, models = smoke.main_path_inputs(torch, device)
        qmodels = smoke.quantised_models(torch, device, models)
        qmodels.depth_model.matmul_backend = "pallas"
        for key, run_models in (("fp32", models), ("int8", qmodels)):
            comp = EPICCompressor(pipe.EPICConfig(), run_models,
                                  device=device)
            smoke.run_session(torch, comp, tuple(x[:smoke.CHUNK]
                                                 for x in stream), device)
            out[f"solo_{key}_fps"] = [
                smoke.N_FRAMES / smoke.run_session(torch, comp, stream,
                                                   device)[-1]
                for _ in range(args.sessions)]
            state, steps = comp.init(), []
            for chunk in iter_chunks(SensorChunk(*stream), smoke.CHUNK):
                torch.cuda.synchronize(device)
                t0 = time.perf_counter()
                state, _ = comp.step(state, chunk)
                torch.cuda.synchronize(device)
                steps.append((time.perf_counter() - t0) * 1e3)
            out[f"solo_{key}_chunk_ms"] = sorted(steps)[len(steps) // 2]
        del comp, qmodels, models, stream
    if "ssd" in paths:
        scan("ssd", smoke.ssd_inputs, mamba2_ssd_pallas, mamba2_ssd_chunked,
             smoke.SSD_FULL, torch.float32)
        prefill("ssd", "zamba2-2.7b", "ssd")
    if "rwkv" in paths:
        scan("rwkv", smoke.rwkv_inputs, rwkv6_scan_pallas, rwkv6_scan_chunked,
             smoke.RWKV_FULL, torch.bfloat16)
        prefill("rwkv", "rwkv6-3b", "rwkv")
    if "efm" in paths:
        cfg = get_config(smoke.EFM_ARCH).replace(
            attn_backend="pallas", param_dtype="bfloat16",
            compute_dtype="bfloat16", cache_dtype="bfloat16")
        model = build_model(cfg, device=device)
        params = model.init(
            torch.Generator(device=device).manual_seed(smoke.SEED))
        rng = np.random.default_rng(smoke.SEED)
        batch = {"tokens": torch.as_tensor(
            rng.integers(0, cfg.vocab, (smoke.EFM_BATCH, smoke.EFM_PROMPT)),
            device=device)}
        logits, cache = jit_prefill(model)(params, batch)
        first = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        walls = []
        for _ in range(1 + args.decodes):
            state = pad_for_decode(model, cache, smoke.EFM_NEW)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            greedy_decode_loop(model, params, state, first, smoke.EFM_PROMPT,
                               smoke.EFM_NEW)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3 / smoke.EFM_NEW)
        out["efm_decode_ms_step"] = walls[1:]  # the first warms up
        del params, model, cache, state
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
