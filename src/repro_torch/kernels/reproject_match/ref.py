"""Plain PyTorch version of the reproject-match op (EPIC TRD hot spot).

Port of ``repro.kernels.reproject_match.ref``, written over the batch of
``N`` DC-buffer entries instead of through ``vmap``.  It is the op's
definition in the port: the CPU path of every kernel wrapper, and what
the CUDA kernel is held to on the card.

For each entry: warp its PxP pixel grid into the current view (Eq. 1),
bilinearly sample the current frame inside a ``window x window`` region
centred on the warped corner bounding box and clamped inside the frame,
and reduce the masked mean-absolute RGB difference against the entry's
stored pixels.  Warped pixels outside the window are invalid.

Outputs per entry:
  * ``diff``     — masked mean |I_c - F_t(warp(.))| over valid pixels
                   (1.0 where nothing is valid),
  * ``coverage`` — fraction of the entry's pixels that warped in front of
                   the camera and inside the window (0 if any corner is
                   behind the camera),
  * ``bbox``     — warped corner bounding box (vmin, umin, vmax, umax).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor

from repro_torch.core import geometry as geo


def window_origin(bbox: Tensor, window: int, frame_hw: Tuple[int, int]) -> Tensor:
    """Top-left (row, col) of the sampling window, clamped inside the frame.

    Centred on the warped bbox centre; integer-valued float32.
    """
    h, w = frame_hw
    cy = 0.5 * (bbox[..., 0] + bbox[..., 2])
    cx = 0.5 * (bbox[..., 1] + bbox[..., 3])
    oy = torch.floor(cy - window / 2.0).clamp(0.0, float(h - window))
    ox = torch.floor(cx - window / 2.0).clamp(0.0, float(w - window))
    return torch.stack([oy, ox], dim=-1)


def entry_pixels(
    entry_rgb: Tensor,  # (N, P, P, 3)
    entry_depth: Tensor,  # (N, P, P)
    entry_origin: Tensor,  # (N, 2) row, col
    t_rel: Tensor,  # (N, 4, 4) source -> current camera
    frame: Tensor,  # (H, W, 3)
    intr: geo.Intrinsics,
    window: int,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """The op's per-pixel terms, before any reduction over pixels.

    Returns ``absdiff (N, P, P, 3)`` (|sampled - entry| per channel),
    ``valid (N, P, P)`` (in front and inside the window), ``bbox (N, 4)``
    and ``bbox_valid (N,)`` (all four corners in front).
    """
    p = entry_rgb.shape[1]
    h, w = frame.shape[0], frame.shape[1]

    coords, in_front = geo.warp_patch_coords(
        entry_origin, entry_depth, intr, t_rel, p
    )  # (N, P, P, 2), (N, P, P)
    corner_d = torch.stack(
        [
            entry_depth[:, 0, 0],
            entry_depth[:, 0, p - 1],
            entry_depth[:, p - 1, 0],
            entry_depth[:, p - 1, p - 1],
        ],
        dim=-1,
    )
    bbox, bbox_valid = geo.reproject_bbox(
        entry_origin, corner_d, intr, t_rel, p
    )

    # Window-local coordinates; the window's taps are gathered straight
    # from the frame (the window lies inside it by construction).
    worig = window_origin(bbox, window, (h, w))  # (N, 2)
    oy = worig[:, 0, None, None]
    ox = worig[:, 1, None, None]
    lu = coords[..., 0] - ox
    lv = coords[..., 1] - oy
    u0, v0 = torch.floor(lu), torch.floor(lv)
    du, dv = lu - u0, lv - v0
    in_win = (
        (u0 >= 0) & (u0 + 1 <= window - 1) & (v0 >= 0) & (v0 + 1 <= window - 1)
    )
    col = (u0.clamp(0.0, float(window - 2)) + ox).long()
    row = (v0.clamp(0.0, float(window - 2)) + oy).long()
    p00 = frame[row, col]
    p01 = frame[row, col + 1]
    p10 = frame[row + 1, col]
    p11 = frame[row + 1, col + 1]
    w00 = ((1 - du) * (1 - dv))[..., None]
    w01 = (du * (1 - dv))[..., None]
    w10 = ((1 - du) * dv)[..., None]
    w11 = (du * dv)[..., None]
    sampled = p00 * w00 + p01 * w01 + p10 * w10 + p11 * w11
    return (sampled - entry_rgb).abs(), in_front & in_win, bbox, bbox_valid


def reproject_match_ref(
    entry_rgb: Tensor,  # (N, P, P, 3)
    entry_depth: Tensor,  # (N, P, P)
    entry_origin: Tensor,  # (N, 2) row, col
    t_rel: Tensor,  # (N, 4, 4) source -> current camera
    frame: Tensor,  # (H, W, 3)
    intr: geo.Intrinsics,
    window: int,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Returns ``diff (N,)``, ``coverage (N,)``, ``bbox (N, 4)``."""
    p = entry_rgb.shape[1]
    absdiff, valid, bbox, bbox_valid = entry_pixels(
        entry_rgb, entry_depth, entry_origin, t_rel, frame, intr, window
    )
    nvalid = valid.sum(dim=(1, 2))
    absdiff = absdiff.mean(dim=-1)  # (N, P, P)
    total = torch.where(valid, absdiff, torch.zeros_like(absdiff)).sum((1, 2))
    diff = total / nvalid.clamp_min(1)
    diff = torch.where(nvalid > 0, diff, torch.ones_like(diff))
    coverage = nvalid / float(p * p)
    coverage = torch.where(bbox_valid, coverage, torch.zeros_like(coverage))
    return diff, coverage, bbox
