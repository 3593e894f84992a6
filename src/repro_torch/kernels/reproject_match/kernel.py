"""Reproject-match on the card: wrappers of the hand-written CUDA kernel.

``reproject_match_pallas`` and ``reproject_match_pallas_tiled`` keep the
names and the op contract of the JAX package's Pallas kernels
(``repro/kernels/reproject_match/kernel.py``); both launch
``csrc/reproject_match.cu``, one CTA per entry or one CTA per ``TILE_N``
entries, and return bitwise the same scores (one shared device function).
The source's header says what bounds the kernel and how it is built.

Each wrapper takes the plain version (``ref.py``) for tensors on the CPU
and launches the kernel for tensors on a CUDA device; it raises on
anything else.  ``<wrapper>.launches`` counts its kernel launches.
"""

from __future__ import annotations

from pathlib import Path
from typing import Tuple

import torch
from torch import Tensor

from repro_torch.core import geometry as geo
from repro_torch.kernels._build import FLOAT, INT, PTR, CudaLibrary, check
from repro_torch.kernels.reproject_match.ref import reproject_match_ref

# --fmad=false: see the precision note in csrc/reproject_match.cu.
LIBRARY = CudaLibrary(
    "reproject_match",
    Path(__file__).resolve().parent / "csrc",
    {
        # intr rgb depth origin trel frame out, n patch window h w, stream
        "rm_pallas_launch": (PTR,) * 7 + (INT,) * 5 + (PTR,),
        # ... out, n tile_n patch window h w, stream
        "rm_tiled_launch": (PTR,) * 7 + (INT,) * 6 + (PTR,),
        # ... out match ovok, n patch window h w, tau o_min c_min, stream
        "rm_fused_launch": (PTR,) * 9 + (INT,) * 5 + (FLOAT,) * 3 + (PTR,),
    },
    flags=("--fmad=false",),
)

# Entries per CTA of the tiled launch (the Pallas kernel's entries per grid
# step).
TILE_N = 8
MAX_PATCH = 32  # one thread per pixel: at most 1024 threads a block


def check_inputs(
    entry_rgb: Tensor,
    entry_depth: Tensor,
    entry_origin: Tensor,
    t_rel: Tensor,
    frame: Tensor,
    intr: geo.Intrinsics,
    window: int,
) -> Tuple[int, int, int, int, torch.device]:
    """Validate the op's inputs; returns ``(N, P, H, W, device)``."""
    named = {
        "entry_rgb": entry_rgb,
        "entry_depth": entry_depth,
        "entry_origin": entry_origin,
        "t_rel": t_rel,
        "frame": frame,
        "intr.f": intr.f,
        "intr.cx": intr.cx,
        "intr.cy": intr.cy,
    }
    devices = {t.device for t in named.values()}
    if len(devices) != 1:
        raise ValueError(
            "reproject_match inputs lie on different devices: "
            + ", ".join(f"{k}={v.device}" for k, v in named.items())
        )
    device = devices.pop()
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"reproject_match runs on cpu or cuda, not {device}")
    for name, t in named.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if entry_rgb.ndim != 4 or entry_rgb.shape[3] != 3:
        raise ValueError(f"entry_rgb must be (N, P, P, 3), got {tuple(entry_rgb.shape)}")
    n, p = entry_rgb.shape[0], entry_rgb.shape[1]
    expected = {
        "entry_rgb": (n, p, p, 3),
        "entry_depth": (n, p, p),
        "entry_origin": (n, 2),
        "t_rel": (n, 4, 4),
    }
    for name, shape in expected.items():
        if tuple(named[name].shape) != shape:
            raise ValueError(
                f"{name} must be {shape}, got {tuple(named[name].shape)}"
            )
    if frame.ndim != 3 or frame.shape[2] != 3:
        raise ValueError(f"frame must be (H, W, 3), got {tuple(frame.shape)}")
    h, w = frame.shape[0], frame.shape[1]
    if not 2 <= p <= MAX_PATCH:
        raise ValueError(f"patch must be in [2, {MAX_PATCH}], got {p}")
    if not 2 <= window <= min(h, w):
        raise ValueError(
            f"window must be in [2, min(H, W) = {min(h, w)}], got {window}"
        )
    if device.type == "cuda":
        for name, t in named.items():
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous for the kernel")
    return n, p, h, w, device


def launch_pointers(entry_rgb, entry_depth, entry_origin, t_rel, frame, intr):
    """``(intr_vec, pointers)``: keep ``intr_vec`` alive until the launch."""
    intr_vec = intr.vector()
    ptrs = [
        t.data_ptr()
        for t in (intr_vec, entry_rgb, entry_depth, entry_origin, t_rel, frame)
    ]
    return intr_vec, ptrs


def stream_of(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def split_rows(out: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Unpack ``(N, 8)`` rows ``[diff, coverage, vmin, umin, vmax, umax, 0, 0]``."""
    return out[:, 0], out[:, 1], out[:, 2:6]


def reproject_match_pallas(
    entry_rgb: Tensor,  # (N, P, P, 3)
    entry_depth: Tensor,  # (N, P, P)
    entry_origin: Tensor,  # (N, 2)
    t_rel: Tensor,  # (N, 4, 4)
    frame: Tensor,  # (H, W, 3)
    intr: geo.Intrinsics,
    *,
    window: int = 64,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Reproject-match, one CTA per entry.  Returns diff, coverage, bbox.

    Replaces ``repro/kernels/reproject_match/kernel.py ::
    reproject_match_pallas``; same contract as :func:`reproject_match_ref`.
    """
    n, p, h, w, device = check_inputs(
        entry_rgb, entry_depth, entry_origin, t_rel, frame, intr, window
    )
    if device.type == "cpu":
        return reproject_match_ref(
            entry_rgb, entry_depth, entry_origin, t_rel, frame, intr, window
        )
    out = torch.empty((n, 8), dtype=torch.float32, device=device)
    if n:
        _keep, ptrs = launch_pointers(
            entry_rgb, entry_depth, entry_origin, t_rel, frame, intr
        )
        err = LIBRARY.library().rm_pallas_launch(
            *ptrs, out.data_ptr(), n, p, window, h, w, stream_of(device)
        )
        check(err, "rm_pallas_launch")
        reproject_match_pallas.launches += 1
    return split_rows(out)


reproject_match_pallas.launches = 0


def reproject_match_pallas_tiled(
    entry_rgb: Tensor,
    entry_depth: Tensor,
    entry_origin: Tensor,
    t_rel: Tensor,
    frame: Tensor,
    intr: geo.Intrinsics,
    *,
    window: int = 64,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Reproject-match, ``TILE_N`` entries per CTA.

    Replaces ``repro/kernels/reproject_match/kernel.py ::
    reproject_match_pallas_tiled``.  The ragged tail is masked by index
    inside the kernel: no padding entries are made.
    """
    n, p, h, w, device = check_inputs(
        entry_rgb, entry_depth, entry_origin, t_rel, frame, intr, window
    )
    if device.type == "cpu":
        return reproject_match_ref(
            entry_rgb, entry_depth, entry_origin, t_rel, frame, intr, window
        )
    out = torch.empty((n, 8), dtype=torch.float32, device=device)
    if n:
        _keep, ptrs = launch_pointers(
            entry_rgb, entry_depth, entry_origin, t_rel, frame, intr
        )
        err = LIBRARY.library().rm_tiled_launch(
            *ptrs, out.data_ptr(), n, TILE_N, p, window, h, w,
            stream_of(device),
        )
        check(err, "rm_tiled_launch")
        reproject_match_pallas_tiled.launches += 1
    return split_rows(out)


reproject_match_pallas_tiled.launches = 0
