#!/usr/bin/env python3
"""Sweep the tensor-core flash kernel's tile configuration on one CUDA card.

    python3 scripts/sweep_flash_tiles.py

``csrc/flash_attention_wgmma.cu`` fixes, per head dim, the (K, V) tiles in
flight (``kStages``) and the CTAs an SM (``kMinBlocks``, which caps the
registers a thread may take) in its ``Tile`` structs.  This script builds
one copy of the source per variant (the ``Tile`` line substituted; one
``nvcc`` each, in parallel, under ``build/flash_sweep/``, ignored by git),
reads each build's registers and spills from ``-Xptxas -v``, and times
each variant that spills nothing beside ``F.scaled_dot_product_attention``
(CUDA-graph replay between CUDA events, ``chip_smoke.device_ms``), with
its max |kernel - plain version|, at two causal bf16 shapes: the main
path's, q (4, 32, 1024, 64) with 4 kv heads, and q (4, 16, 1024, 128)
with 2 kv heads.  Prints the card's name and power limit, then one JSON
line per variant.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = (ROOT / "src/repro_torch/kernels/flash_attention/csrc"
          / "flash_attention_wgmma.cu")
OUT = ROOT / "build" / "flash_sweep"
# (head dim, kStages, kMinBlocks); the source's own choice is among them.
VARIANTS = ((64, 2, 1), (64, 2, 2), (64, 3, 2), (64, 4, 2), (64, 4, 1),
            (128, 2, 1), (128, 3, 1), (128, 4, 1))
SHAPES = {64: (4, 32, 4, 1024, 64), 128: (4, 16, 2, 1024, 128)}


def variant_source(text: str, d: int, stages: int, min_blocks: int) -> str:
    pattern = (r"(struct Tile<%d> \{\s*static constexpr int kBlockN = "
               r"\d+, )kStages = \d+, kMinBlocks = \d+;" % d)
    new, n = re.subn(pattern, r"\g<1>kStages = %d, kMinBlocks = %d;"
                     % (stages, min_blocks), text)
    if n != 1:
        raise RuntimeError(f"no Tile<{d}> line in {SOURCE}")
    return new


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("sweep_flash_tiles: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as fa

    print(smoke.card_line())
    OUT.mkdir(parents=True, exist_ok=True)
    text = SOURCE.read_text()
    procs = {}
    for d, stages, min_blocks in VARIANTS:
        name = f"d{d}_stages{stages}_ctas{min_blocks}"
        src = OUT / f"{name}.cu"
        src.write_text(variant_source(text, d, stages, min_blocks))
        cmd = [_build._nvcc(), *fa.LIBRARY.flags, "-o",
               str(OUT / f"{name}.so"), str(src)]
        procs[name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True))
    device = torch.device("cuda", 0)
    for name, (d, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            print(json.dumps({"variant": name, "built": False}))
            continue
        block = log.split(f"fa_wgmma_kernelILi{d}E")[-1].split(
            "Compiling entry function")[0]
        regs = int(re.search(r"Used (\d+) registers", block).group(1))
        spills = sum(map(int, re.findall(r"(\d+) bytes spill", block)))
        row = {"variant": name, "registers": regs, "spill_bytes": spills}
        if spills == 0:
            lib = ctypes.CDLL(str(OUT / f"{name}.so"))
            entry = lib.fa_tensor_core_launch
            entry.argtypes = list(fa.LIBRARY.signatures[
                "fa_tensor_core_launch"])
            entry.restype = ctypes.c_int
            b, hq, hkv, s, _ = SHAPES[d]
            q, k, v = smoke.fa_inputs(torch, device, b, hq, hkv, s, d,
                                      torch.bfloat16, 0)
            out = torch.empty((b, s, hq, d), dtype=q.dtype,
                              device=device).transpose(1, 2)
            strides = [n for t in (q, k, v, out) for n in fa.kernel_strides(t)]

            def launch():
                _build.check(entry(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    b, hq, hkv, s, d, 1, d ** -0.5, *strides,
                    torch.cuda.current_stream().cuda_stream), name)

            launch()
            plain = fa.flash_attention_plain(q, k, v)
            _, _, flop = smoke.fa_bound(b, hq, hkv, s, d, True, 2,
                                        smoke.BF16_FLOP_PER_S)
            ms = smoke.device_ms(torch, launch, per_graph=20)
            sdpa_ms = smoke.device_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True), per_graph=20)
            row.update(shape=[b, hq, hkv, s, d], ms=ms,
                       tflops=flop / (ms * 1e-3) / 1e12, sdpa_ms=sdpa_ms,
                       max_abs_err=float((out.float()
                                          - plain.float()).abs().max()))
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
