#!/usr/bin/env python3
"""Where one warp's time goes in the reproject-match kernel, on one CUDA card.

    python3 scripts/profile_rm_stages.py

Builds a copy of ``csrc/reproject_match.cu`` in which the source's
``RM_STAGE(i)`` marks (the stage boundaries of ``warp_entry_scores`` and
the end of the fused launch) write ``clock64()`` from lane 0 of each warp,
under the kernel's ``build/`` directory.  Launches it through the port's
wrappers at the main path's shapes (``chip_smoke.make_inputs``: N = 192,
P = 16, 128x128 frame, window 32) and at the scale shape (N = 3072,
512x512), and prints, per launch, the median SM cycles of each
stage over the entries, and of the whole function:

  loads    the entry's constants, depth and rgb issued (and the constants
           waited for);
  corners  the column and row quotients, the corner warp, the window;
  warp     every pixel's transform and division by z;
  taps     the 4-tap gathers issued (the fused launch's overlap row);
  sample   the bilinear samples and channel sums (the taps waited for);
  mean     the divisions by 3;
  reduce   the masked sum, the butterfly, diff and coverage;
  rows     (fused) the score row and the match row.

The stamps cost a few instructions each; the times are for reading
proportions, not for the kernel's time (``chip_smoke.py`` phase 3).
"""

from __future__ import annotations

import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
STAGES = ("loads", "corners", "warp", "taps", "sample", "mean", "reduce")
MARKS = 9  # RM_STAGE(0) .. RM_STAGE(8) in the source
SLOTS = 4096  # entries stamped


def instrumented(src: str) -> str:
    """The source with ``RM_STAGE(i)`` defined to stamp ``g_prof``."""
    marks = sorted({int(i) for i in re.findall(r"RM_STAGE\((\d)\);", src)})
    if marks != list(range(MARKS)):
        raise SystemExit(f"the kernel marks stages {marks}, "
                         f"not 0..{MARKS - 1}")
    head = (f"__device__ long long g_prof[{SLOTS} * {MARKS}];\n"
            "#define RM_STAGE(i) if ((threadIdx.x & 31) == 0 && "
            f"e < {SLOTS}) g_prof[e * {MARKS} + (i)] = clock64()\n")
    tail = ('\nextern "C" int rm_stages_read(long long* out) {\n'
            "  return (int)cudaMemcpyFromSymbol(out, g_prof, "
            "sizeof(g_prof));\n}\n")
    return head + src + tail


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_rm_stages: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as smoke
    from repro_torch.kernels._build import PTR, CudaLibrary
    from repro_torch.kernels.reproject_match import fused, kernel

    device = torch.device("cuda", 0)
    print(smoke.card_line())
    csrc = kernel.LIBRARY.csrc
    stage_dir = csrc.parent / "build" / "stages" / "csrc"
    stage_dir.mkdir(parents=True, exist_ok=True)
    (stage_dir / "reproject_match.cu").write_text(
        instrumented((csrc / "reproject_match.cu").read_text()))
    lib = CudaLibrary("reproject_match_stages", stage_dir,
                      {**kernel.LIBRARY.signatures, "rm_stages_read": (PTR,)},
                      flags=("--fmad=false",))
    kernel.LIBRARY = fused.LIBRARY = lib  # the wrappers launch the copy
    out = np.zeros(SLOTS * MARKS, np.int64)
    for label, name, (n, p, hw) in (
            ("main", "reproject_match_pallas", (192, 16, 128)),
            ("main", "reproject_match_fused", (192, 16, 128)),
            ("scale", "reproject_match_pallas", smoke.RM_SCALE)):
        args, intr = smoke.make_inputs(torch, device, n, p, hw, smoke.SEED)
        call = smoke.rm_calls(torch, args, intr)[name][0]
        for _ in range(3):  # the last launch's stamps are read
            call()
        torch.cuda.synchronize()
        if lib.library().rm_stages_read(out.ctypes.data) != 0:
            raise RuntimeError("rm_stages_read failed")
        st = out.reshape(SLOTS, MARKS)[:n].astype(np.float64)
        cycles = np.diff(st[:, :8], axis=1)
        row = dict(zip(STAGES, np.median(cycles, 0).tolist()))
        if name == "reproject_match_fused":
            row["rows"] = float(np.median(st[:, 8] - st[:, 7]))
        row["total"] = float(np.median(st[:, -1 if "rows" in row else 7]
                                       - st[:, 0]))
        print(json.dumps({"launch": name, "shape": label, "n": n,
                          "median_cycles": row}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
