#!/usr/bin/env python3
"""Sweep the 3xTF32 flash kernel's tile configuration on one CUDA card.

    python3 scripts/sweep_flash_tf32.py

``csrc/flash_attention_tf32.cu`` picks, per instance, the m16 tiles a
warp takes (``kM``), the warps of a CTA (``kWarps``) and the keys of a
tile (``kBlockK``) in its ``Smem`` struct, and leaves the registers a
thread takes to the compiler.  This script builds one copy of the source
per variant, with those three lines replaced by one value each for every
instance (None keeps the source's line) and, where a variant names CTAs
an SM, that minimum as the second ``__launch_bounds__`` argument (``"source"`` keeps the source's own choice; ``"cvt"``
is the source's choice with the operands split by two ``cvt.rna``,
``tf32_tiles.cuh`` ``split_tf32``, instead of on the bits), one ``nvcc``
each, in parallel, under ``build/flash_tf32_sweep/`` (ignored by git).
It prints each build's registers and spills (``-Xptxas -v``), then times
each variant (CUDA-graph replay between CUDA events,
``chip_smoke.device_ms``), with its max |kernel - plain version|, at four
causal shapes in the models' layout: the float32 main path's, q (4, 32,
1024, 64) with 4 kv heads; Zamba2-2.7B's shared attention, q (4, 32,
1024, 160) with 32 kv heads, in bf16 and float32; and q (1, 8, 2048, 128)
float32.  A variant whose launch is refused (too much shared memory)
gets null.  Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = (ROOT / "src/repro_torch/kernels/flash_attention/csrc"
          / "flash_attention_tf32.cu")
OUT = ROOT / "build" / "flash_tf32_sweep"
# name: (m16 tiles a warp, warps a CTA, keys a tile, CTAs an SM), or None
VARIANTS = {"source": None, "cvt": None,
            "source_min1": (None, None, None, 1),
            "m2_w4_k32": (2, 4, 32, None), "m1_w4_k32": (1, 4, 32, None),
            "m1_w8_k32": (1, 8, 32, None), "m1_w8_k64": (1, 8, 64, None),
            "m2_w4_k64": (2, 4, 64, None), "m2_w4_k32_min2": (2, 4, 32, 2),
            "m2_w4_k32_min3": (2, 4, 32, 3), "m1_w8_k32_min2": (1, 8, 32, 2)}
LINES = (r"static constexpr int kM = [^;]+;",
         r"static constexpr int kWarps = [^;]+;",
         r"static constexpr int kBlockK = [^;]+;")
BOUNDS = "__launch_bounds__(Smem<T, D>::kThreads)"


def variant_source(text: str, name: str) -> str:
    if name == "cvt":
        return text.replace("split_tf32_bits(", "split_tf32(")
    if VARIANTS[name] is None:
        return text
    *tiles, min_blocks = VARIANTS[name]
    for pattern, value in zip(LINES, tiles):
        if value is None:
            continue
        text, n = re.subn(pattern, pattern.split(" = ")[0].replace("\\", "")
                          + f" = {value};", text)
        if n != 1:
            raise RuntimeError(f"no line {pattern!r} in {SOURCE}")
    if min_blocks is not None:
        if text.count(BOUNDS) != 1:
            raise RuntimeError(f"no {BOUNDS} in {SOURCE}")
        text = text.replace(BOUNDS, BOUNDS[:-1] + f", {min_blocks})")
    return text


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("sweep_flash_tf32: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from concurrent.futures import ThreadPoolExecutor

    import chip_smoke as smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    print(smoke.card_line(), flush=True)
    text = SOURCE.read_text()
    text = text.replace("using tf32_tiles::split_tf32_bits;",
                        "using tf32_tiles::split_tf32;\n"
                        "using tf32_tiles::split_tf32_bits;")
    libs = {}
    for name in VARIANTS:
        csrc = OUT / name / "csrc"
        csrc.mkdir(parents=True, exist_ok=True)
        (csrc / SOURCE.name).write_text(variant_source(text, name))
        libs[name] = _build.CudaLibrary(
            f"fa_tf32_{name}", csrc,
            {"fa_tf32_launch": fa.LIBRARY.signatures["fa_tf32_launch"]},
            include=(_build.SHARED_CSRC,))
    with ThreadPoolExecutor(len(libs)) as pool:
        paths = dict(zip(libs, pool.map(lambda lib: lib.build(),
                                        libs.values())))
    builds = {}
    for name, path in paths.items():
        log = path.with_suffix(".log").read_text().replace("\n", " ")
        found = re.findall(r"tf32_kernelI(f|13__nv_bfloat16)Li(\d+)EE.*?"
                           r"(\d+) bytes spill stores.*?Used (\d+) registers",
                           log)
        builds[name] = {f"{'f32' if t == 'f' else 'bf16'}_d{d}":
                        dict(registers=int(r), spill_bytes=int(sp))
                        for t, d, sp, r in found}
        print(name, builds[name], flush=True)
    device = torch.device("cuda", 0)
    shapes = {"f32_main": ((4, 32, 4, 1024, 64), torch.float32),
              "bf16_d160": ((4, 32, 32, 1024, 160), torch.bfloat16),
              "f32_d160": ((4, 32, 32, 1024, 160), torch.float32),
              "f32_d128_s2048": ((1, 8, 8, 2048, 128), torch.float32)}
    times = {name: {} for name in libs}
    for key, (shape, dtype) in shapes.items():
        q, k, v = smoke.fa_inputs(torch, device, *shape, dtype, 0, bshd=True)
        plain = fa.flash_attention_plain(q, k, v)
        # in turns, forwards then backwards
        for name in list(libs) + list(libs)[::-1]:
            fa.LIBRARY = libs[name]
            try:
                out = fa.flash_attention_pallas(q, k, v)
                torch.cuda.synchronize()
            except RuntimeError as e:
                print(f"{name} {key}: {e}", flush=True)
                times[name].setdefault(key, None)
                continue
            err = float((out.float() - plain.float()).abs().max())
            ms = smoke.device_ms(torch, lambda: fa.flash_attention_pallas(
                q, k, v), per_graph=5, replays=10)
            entry = times[name].setdefault(key, {"ms": [], "max_abs_err": err})
            entry["ms"].append(ms)
            print(f"{name} {key}: {ms:.6f} ms, max|err| {err:.3g}",
                  flush=True)
        del q, k, v, plain
        torch.cuda.empty_cache()
    print(json.dumps({"builds": builds, "times": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
