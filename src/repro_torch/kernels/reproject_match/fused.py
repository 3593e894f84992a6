"""Fused TSRC match on the card: warp + match + thresholds + update mask.

Port of ``repro/kernels/reproject_match/fused.py``.  One warp (one CTA)
per DC-buffer entry emits, in one pass, the
``[diff, coverage, bbox]`` row (bitwise the ``"pallas"`` launch's: both
run the same device function) plus two rows over the frame's implicit
row-major ``(H/P) x (W/P)`` patch grid:

  * the **overlap row**: bbox overlap fraction >= ``o_min`` per patch,
  * the **update-mask row**: overlap AND ``diff <= tau`` AND
    ``coverage >= c_min``.

The kernel writes both rows as ``bool`` directly, four to a 32-bit store
where a row is 4-byte aligned.  Registration: the standard-contract
backend registers as ``"fused"`` and carries the whole-step entry point
as its ``fused_match`` attribute, which ``tsrc_step`` reads with
``getattr``.  The entry axis is any length, so
the sparse prefilter feeds it the gathered ``(K, ...)`` candidate slabs.
Under the serving pool's vmap the launch goes through the slot-batched
custom op ``repro_torch::rm_fused`` (as ``kernel.py``'s scores), and one
launch covers every slot; outside vmap the wrapper calls the op's
implementation straight.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor

from repro_torch.api.registry import register_backend
from repro_torch.core import geometry as geo
from repro_torch.kernels import _slots
from repro_torch.kernels._build import check, check_contiguous, refuse_grad
from repro_torch.kernels.reproject_match.kernel import (
    LIBRARY,
    check_inputs,
    launch_pointers,
    pack_rows,
    slot_shape,
    split_rows,
    stream_of,
)
from repro_torch.kernels.reproject_match.ref import reproject_match_ref


def patch_grid_origins(h: int, w: int, patch: int, device) -> Tensor:
    """``(M, 2)`` top-left (row, col) of the row-major patch grid, in the
    order of ``tsrc.extract_patches``."""
    oy, ox = torch.meshgrid(
        torch.arange(h // patch, dtype=torch.float32, device=device) * patch,
        torch.arange(w // patch, dtype=torch.float32, device=device) * patch,
        indexing="ij",
    )
    return torch.stack([oy.reshape(-1), ox.reshape(-1)], dim=-1)


def reproject_match_fused_ref(
    entry_rgb: Tensor,
    entry_depth: Tensor,
    entry_origin: Tensor,
    t_rel: Tensor,
    frame: Tensor,
    intr: geo.Intrinsics,
    *,
    window: int,
    tau: float,
    o_min: float,
    c_min: float,
) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Plain fused version: the plain scores, thresholded in PyTorch."""
    diff, coverage, bbox = reproject_match_ref(
        entry_rgb, entry_depth, entry_origin, t_rel, frame, intr, window
    )
    p = entry_rgb.shape[1]
    origins = patch_grid_origins(frame.shape[0], frame.shape[1], p, frame.device)
    overlap_ok = (
        geo.bbox_overlap_fraction(bbox[:, None, :], origins[None], p) >= o_min
    )
    entry_ok = (diff <= tau) & (coverage >= c_min)
    return diff, coverage, bbox, entry_ok[:, None] & overlap_ok, overlap_ok


def rm_fused_plain(entry_rgb: Tensor, entry_depth: Tensor,
                   entry_origin: Tensor, t_rel: Tensor, frame: Tensor,
                   f: Tensor, cx: Tensor, cy: Tensor, window: int,
                   tau: float, o_min: float,
                   c_min: float) -> Tuple[Tensor, Tensor, Tensor]:
    """The slot-batched fused op: ``(..., N, ...)`` entries and ``(..., H,
    W, 3)`` frames, with any leading slot axes -> ``(..., N, 8)`` score
    rows, ``(..., N, M)`` match and overlap rows.  CPU tensors take the
    plain version, slot by slot what :func:`reproject_match_fused_ref`
    gives (a vmap over the slots)."""
    intr = geo.Intrinsics(f, cx, cy)

    def one(rgb, depth, origin, trel, fr):
        diff, cov, bbox, match, ovok = reproject_match_fused_ref(
            rgb, depth, origin, trel, fr, intr, window=window, tau=tau,
            o_min=o_min, c_min=c_min,
        )
        return pack_rows(diff, cov, bbox), match, ovok

    return _slots.over_slots(one, frame.ndim - 3)(
        entry_rgb, entry_depth, entry_origin, t_rel, frame)


rm_fused = torch.library.custom_op("repro_torch::rm_fused", mutates_args=(),
                                   device_types="cpu")(rm_fused_plain)


@rm_fused.register_kernel("cuda")
def rm_fused_launch(entry_rgb, entry_depth, entry_origin, t_rel, frame, f, cx,
                    cy, window, tau, o_min, c_min):
    check_contiguous(entry_rgb=entry_rgb, entry_depth=entry_depth,
                     entry_origin=entry_origin, t_rel=t_rel, frame=frame)
    lead, slots, n, p, h, w = slot_shape(entry_rgb, frame)
    m = (h // p) * (w // p)
    device = frame.device
    out = torch.empty(lead + (n, 8), dtype=torch.float32, device=device)
    match = torch.empty(lead + (n, m), dtype=torch.bool, device=device)
    ovok = torch.empty(lead + (n, m), dtype=torch.bool, device=device)
    if slots and n:
        err = LIBRARY.library().rm_fused_launch(
            *launch_pointers(entry_rgb, entry_depth, entry_origin, t_rel,
                             frame, f, cx, cy),
            out.data_ptr(), match.data_ptr(), ovok.data_ptr(),
            slots, n, p, window, h, w, tau, o_min, c_min, stream_of(device),
        )
        check(err, "rm_fused_launch")
        reproject_match_fused.launches += 1
    return out, match, ovok


@rm_fused.register_fake
def _(entry_rgb, entry_depth, entry_origin, t_rel, frame, f, cx, cy, window,
      tau, o_min, c_min):
    lead, _, n, p, h, w = slot_shape(entry_rgb, frame)
    m = (h // p) * (w // p)
    return (entry_rgb.new_empty(lead + (n, 8)),
            entry_rgb.new_empty(lead + (n, m), dtype=torch.bool),
            entry_rgb.new_empty(lead + (n, m), dtype=torch.bool))


def _rm_fused_vmap(info, in_dims, entry_rgb, entry_depth, entry_origin, t_rel,
                   frame, f, cx, cy, window, tau, o_min, c_min):
    _slots.require_shared("rm_fused", in_dims, ((5, "f"), (6, "cx"),
                                                (7, "cy")))
    args = [_slots.lead(x, d, info.batch_size) for x, d in zip(
        (entry_rgb, entry_depth, entry_origin, t_rel, frame), in_dims)]
    return rm_fused(*args, f, cx, cy, window, tau, o_min, c_min), (0, 0, 0)


torch.library.register_vmap(rm_fused, _rm_fused_vmap)


def reproject_match_fused(
    entry_rgb: Tensor,  # (N, P, P, 3)
    entry_depth: Tensor,  # (N, P, P)
    entry_origin: Tensor,  # (N, 2)
    t_rel: Tensor,  # (N, 4, 4)
    frame: Tensor,  # (H, W, 3)
    intr: geo.Intrinsics,
    *,
    window: int = 64,
    tau: float = 0.08,
    o_min: float = 0.5,
    c_min: float = 0.6,
) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Fused TSRC match: one kernel pass per DC-buffer entry.

    Replaces ``repro/kernels/reproject_match/fused.py ::
    reproject_match_fused``.

    Returns:
      diff (N,), coverage (N,), bbox (N, 4),
      pair_ok (N, M) bool — overlap AND the diff/coverage thresholds (the
        caller still ANDs buffer validity and saliency),
      overlap_ok (N, M) bool — the bare bbox-overlap bits.
    """
    refuse_grad("reproject_match_fused", entry_rgb, entry_depth, entry_origin,
                t_rel, frame)
    check_inputs(entry_rgb, entry_depth, entry_origin, t_rel, frame, intr,
                 window)
    op = _slots.pick(rm_fused, rm_fused_plain, rm_fused_launch, frame.device)
    rows, match, ovok = op(entry_rgb, entry_depth, entry_origin, t_rel, frame,
                           intr.f, intr.cx, intr.cy, window, tau, o_min, c_min)
    diff, coverage, bbox = split_rows(rows)
    return diff, coverage, bbox, match, ovok


reproject_match_fused.launches = 0


@register_backend("fused")
def _fused_backend(
    entry_rgb, entry_depth, entry_origin, t_rel, frame, intr, *, window
):
    """Standard reproject-match contract (diff, coverage, bbox) served by
    the fused kernel — the thresholds do not affect these outputs."""
    diff, coverage, bbox, _, _ = reproject_match_fused(
        entry_rgb, entry_depth, entry_origin, t_rel, frame, intr,
        window=window,
    )
    return diff, coverage, bbox


# Capability attribute: tsrc_step detects it and runs the whole match
# (thresholds + update mask) as one kernel — see core/tsrc.py.
_fused_backend.fused_match = reproject_match_fused
