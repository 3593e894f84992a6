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

A launch takes any leading slot axes on the entries and the frame (none
for one frame).  Under the serving pool's ``torch.func.vmap`` it goes
through a ``torch.library`` custom op (``repro_torch::rm_scores`` /
``rm_scores_tiled``), whose vmap rule hands it the vmapped dimension as a
slot axis (``kernels/_slots.py``): one launch serves every slot, each slot
with its own frame, entries and transforms and the intrinsics shared, and
slot b of that launch is bitwise a launch on slot b alone.  Outside vmap a
wrapper calls the op's implementation straight, on the tensors it was
given.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Tuple

import torch
from torch import Tensor

from repro_torch.core import geometry as geo
from repro_torch.kernels import _slots
from repro_torch.kernels._build import (FLOAT, I64, INT, PTR, CudaLibrary,
                                        check, check_contiguous,
                                        refuse_grad)
from repro_torch.kernels.reproject_match.ref import reproject_match_ref

# --fmad=false: see the precision note in csrc/reproject_match.cu.
LIBRARY = CudaLibrary(
    "reproject_match",
    Path(__file__).resolve().parent / "csrc",
    {
        # f cx cy rgb depth origin trel frame out, slots n patch window h w,
        # stream
        "rm_scores_launch": (PTR,) * 9 + (INT,) * 6 + (PTR,),
        # ... out match ovok, slots n patch window h w, tau o_min c_min,
        # stream
        "rm_fused_launch": (PTR,) * 11 + (INT,) * 6 + (FLOAT,) * 3 + (PTR,),
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
    """Validate the op's inputs; returns ``(N, P, H, W, device)``.  The
    launch checks the contiguity of the tensors it reads."""
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
    return n, p, h, w, device


def launch_pointers(entry_rgb, entry_depth, entry_origin, t_rel, frame, f,
                    cx, cy):
    """Device pointers of ``f``, ``cx``, ``cy`` (each read through its own
    pointer, so no stacked copy is launched) and of the five inputs."""
    return [
        t.data_ptr()
        for t in (f, cx, cy, entry_rgb, entry_depth, entry_origin, t_rel,
                  frame)
    ]


def stream_of(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def slot_shape(entry_rgb: Tensor, frame: Tensor):
    """``(lead, slots, N, P, H, W)`` of a launch: ``(*lead, N, P, P, 3)``
    entries against ``(*lead, H, W, 3)`` frames, ``slots`` the product of
    the leading (slot) axes, 1 for none."""
    lead = tuple(entry_rgb.shape[:-4])
    if tuple(frame.shape[:-3]) != lead:
        raise ValueError(f"entries {tuple(entry_rgb.shape)} and frame "
                         f"{tuple(frame.shape)} differ in their slot axes")
    n, p = entry_rgb.shape[-4], entry_rgb.shape[-3]
    return (lead, math.prod(lead), n, p, frame.shape[-3], frame.shape[-2])


def split_rows(out: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Unpack ``(..., 8)`` rows ``[diff, coverage, vmin, umin, vmax, umax,
    0, 0]``."""
    return out[..., 0], out[..., 1], out[..., 2:6]


def pack_rows(diff: Tensor, coverage: Tensor, bbox: Tensor) -> Tensor:
    """The kernel's ``(N, 8)`` rows from the plain version's outputs."""
    return torch.cat([diff[:, None], coverage[:, None], bbox,
                      torch.zeros_like(bbox[:, :2])], dim=1)


def plain_scores(entry_rgb, entry_depth, entry_origin, t_rel, frame, f, cx,
                 cy, window: int) -> Tensor:
    """The plain version with any leading slot axes: ``(..., N, 8)`` rows,
    slot by slot what :func:`reproject_match_ref` gives (a vmap over the
    slots)."""
    intr = geo.Intrinsics(f, cx, cy)

    def one(rgb, depth, origin, trel, fr):
        return pack_rows(*reproject_match_ref(rgb, depth, origin, trel, fr,
                                              intr, window))

    return _slots.over_slots(one, frame.ndim - 3)(
        entry_rgb, entry_depth, entry_origin, t_rel, frame)


def _scores_op(name: str, counted):
    """The slot-batched scores op ``repro_torch::<name>``: ``(..., N,
    ...)`` entries and ``(..., H, W, 3)`` frames -> ``(..., N, 8)`` rows,
    one ``rm_scores_launch`` counted on ``counted.launches`` for CUDA
    tensors, :func:`plain_scores` for CPU tensors; its vmap rule makes the
    vmapped dimension a leading slot axis.  Returns ``(op, its CUDA
    implementation)``."""

    @torch.library.custom_op(f"repro_torch::{name}", mutates_args=(),
                             device_types="cpu")
    def op(entry_rgb: Tensor, entry_depth: Tensor, entry_origin: Tensor,
           t_rel: Tensor, frame: Tensor, f: Tensor, cx: Tensor, cy: Tensor,
           window: int) -> Tensor:
        return plain_scores(entry_rgb, entry_depth, entry_origin, t_rel,
                            frame, f, cx, cy, window)

    @op.register_kernel("cuda")
    def launch(entry_rgb, entry_depth, entry_origin, t_rel, frame, f, cx, cy,
               window):
        check_contiguous(entry_rgb=entry_rgb, entry_depth=entry_depth,
                         entry_origin=entry_origin, t_rel=t_rel, frame=frame)
        lead, slots, n, p, h, w = slot_shape(entry_rgb, frame)
        out = torch.empty(lead + (n, 8), dtype=torch.float32,
                          device=frame.device)
        if slots and n:
            err = LIBRARY.library().rm_scores_launch(
                *launch_pointers(entry_rgb, entry_depth, entry_origin, t_rel,
                                 frame, f, cx, cy),
                out.data_ptr(), slots, n, p, window, h, w,
                stream_of(frame.device),
            )
            check(err, "rm_scores_launch")
            counted.launches += 1
        return out

    @op.register_fake
    def _(entry_rgb, entry_depth, entry_origin, t_rel, frame, f, cx, cy,
          window):
        return entry_rgb.new_empty(entry_rgb.shape[:-3] + (8,))

    def vmap_rule(info, in_dims, entry_rgb, entry_depth, entry_origin, t_rel,
                  frame, f, cx, cy, window):
        _slots.require_shared(name, in_dims, ((5, "f"), (6, "cx"),
                                              (7, "cy")))
        args = [_slots.lead(x, d, info.batch_size) for x, d in zip(
            (entry_rgb, entry_depth, entry_origin, t_rel, frame), in_dims)]
        return op(*args, f, cx, cy, window), 0

    torch.library.register_vmap(op, vmap_rule)
    return op, launch


def launch_scores(op, launch, entry_rgb, entry_depth, entry_origin, t_rel,
                  frame, intr, window) -> Tuple[Tensor, Tensor, Tensor]:
    """The scores of both wrappers: ``op`` on one frame (the plain version
    on the CPU, one counted ``rm_scores_launch`` on the card; ``launch`` is
    its CUDA implementation)."""
    check_inputs(entry_rgb, entry_depth, entry_origin, t_rel, frame, intr,
                 window)
    op = _slots.pick(op, plain_scores, launch, frame.device)
    return split_rows(op(entry_rgb, entry_depth, entry_origin, t_rel, frame,
                         intr.f, intr.cx, intr.cy, window))


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
    refuse_grad("reproject_match_pallas", entry_rgb, entry_depth,
                entry_origin, t_rel, frame)
    return launch_scores(rm_scores, rm_scores_launch, entry_rgb,
                         entry_depth, entry_origin, t_rel, frame, intr,
                         window)


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
    refuse_grad("reproject_match_pallas_tiled", entry_rgb, entry_depth,
                entry_origin, t_rel, frame)
    return launch_scores(rm_scores_tiled, rm_scores_tiled_launch,
                         entry_rgb, entry_depth, entry_origin, t_rel, frame,
                         intr, window)


reproject_match_pallas_tiled.launches = 0

rm_scores, rm_scores_launch = _scores_op("rm_scores", reproject_match_pallas)
rm_scores_tiled, rm_scores_tiled_launch = _scores_op(
    "rm_scores_tiled", reproject_match_pallas_tiled)
