"""Reproject-match on the card: wrappers of the hand-written CUDA kernel.

``reproject_match_pallas`` and ``reproject_match_pallas_tiled`` keep the
names and the op contract of the JAX package's Pallas kernels
(``repro/kernels/reproject_match/kernel.py``); both make the same launch of
``csrc/reproject_match.cu``, one warp and one CTA per entry (CTAs of the
Pallas grid's 8 entries a step were slower on the card), so they return
bitwise the same scores.  The source's header says what bounds the
kernel and how it is built; ``warp_order.py`` is the plain version in the
kernel's summation order, which the kernel equals bitwise.

Each wrapper takes the plain version (``ref.py``) for tensors on the CPU
and launches the kernel for tensors on a CUDA device; it raises on
anything else.  ``<wrapper>.launches`` counts its kernel launches; each
call launches one device kernel and nothing else.
"""

from __future__ import annotations

from pathlib import Path
from typing import Tuple

import torch
from torch import Tensor

from repro_torch.core import geometry as geo
from repro_torch.kernels._build import FLOAT, I64, INT, PTR, CudaLibrary, check
from repro_torch.kernels.reproject_match.ref import reproject_match_ref

# --fmad=false: see the precision note in csrc/reproject_match.cu.
LIBRARY = CudaLibrary(
    "reproject_match",
    Path(__file__).resolve().parent / "csrc",
    {
        # f cx cy rgb depth origin trel frame out, n patch window h w, stream
        "rm_scores_launch": (PTR,) * 9 + (INT,) * 5 + (PTR,),
        # ... out match ovok, n patch window h w, tau o_min c_min, stream
        "rm_fused_launch": (PTR,) * 11 + (INT,) * 5 + (FLOAT,) * 3 + (PTR,),
        # a b q, n, stream: the kernel's division, for the card's tests
        "rm_divide_launch": (PTR,) * 3 + (I64,) + (PTR,),
    },
    flags=("--fmad=false",),
)

MAX_PATCH = 32  # lane j of the warp holds column j and row j's quotient


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
    """Device pointers of ``f``, ``cx``, ``cy`` (each read through its own
    pointer, so no stacked copy is launched) and of the five inputs."""
    return [
        t.data_ptr()
        for t in (intr.f, intr.cx, intr.cy, entry_rgb, entry_depth,
                  entry_origin, t_rel, frame)
    ]


def stream_of(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def split_rows(out: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Unpack ``(N, 8)`` rows ``[diff, coverage, vmin, umin, vmax, umax, 0, 0]``."""
    return out[:, 0], out[:, 1], out[:, 2:6]


def launch_scores(wrapper, entry_rgb, entry_depth, entry_origin, t_rel,
                  frame, intr, window) -> Tuple[Tensor, Tensor, Tensor]:
    """The scores of both wrappers: the plain version on the CPU, else one
    ``rm_scores_launch`` counted on ``wrapper.launches``."""
    n, p, h, w, device = check_inputs(
        entry_rgb, entry_depth, entry_origin, t_rel, frame, intr, window
    )
    if device.type == "cpu":
        return reproject_match_ref(
            entry_rgb, entry_depth, entry_origin, t_rel, frame, intr, window
        )
    out = torch.empty((n, 8), dtype=torch.float32, device=device)
    if n:
        ptrs = launch_pointers(
            entry_rgb, entry_depth, entry_origin, t_rel, frame, intr
        )
        err = LIBRARY.library().rm_scores_launch(
            *ptrs, out.data_ptr(), n, p, window, h, w, stream_of(device)
        )
        check(err, "rm_scores_launch")
        wrapper.launches += 1
    return split_rows(out)


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
    """Reproject-match, one warp and one CTA per entry.  Returns diff,
    coverage, bbox.

    Replaces ``repro/kernels/reproject_match/kernel.py ::
    reproject_match_pallas``; same contract as :func:`reproject_match_ref`.
    """
    return launch_scores(reproject_match_pallas, entry_rgb, entry_depth,
                         entry_origin, t_rel, frame, intr, window)


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
    """Reproject-match for the sparse path's few candidates: the same
    launch as :func:`reproject_match_pallas`, counted apart.

    Replaces ``repro/kernels/reproject_match/kernel.py ::
    reproject_match_pallas_tiled``.
    """
    return launch_scores(reproject_match_pallas_tiled, entry_rgb,
                         entry_depth, entry_origin, t_rel, frame, intr,
                         window)


reproject_match_pallas_tiled.launches = 0
