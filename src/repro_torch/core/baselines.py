"""Baseline video-compression methods from the paper's evaluation
(Section 5), port of ``repro.core.baselines``.

  * FV — Full Video: all frames at original FPS and resolution.
  * SD — Spatial Downsample: original FPS, frames uniformly downsampled to a
         target memory budget.
  * TD — Temporal Downsample: original resolution, frames uniformly skipped
         to the target memory budget.
  * GC — Gaze Crop: a square region centred at the gaze point per frame,
         sized to the target memory budget.

Each baseline emits the same retained-patch record as EPIC's DC buffer, so
the EFM tokenizer (``core/packing.py``) is method-agnostic.  These are the
one-shot (whole stream at once) formulations; the streaming equivalents
are the ``fv`` / ``sd`` / ``td`` / ``gc`` compressors of
``repro_torch.api.compressor``.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import Tensor

from repro_torch.core import dc_buffer as dcb
from repro_torch.core import depth as depth_mod
from repro_torch.core.retained import RetainedPatches


def _grid_patches(frames: Tensor, patch: int) -> Tuple[Tensor, Tensor, Tensor]:
    """All patches of all frames: (T*G*G, P, P, 3), t, origins."""
    t, h, w, c = frames.shape
    g = h // patch
    x = frames[:, : g * patch, : g * patch]
    x = x.reshape(t, g, patch, g, patch, c).permute(0, 1, 3, 2, 4, 5)
    patches = x.reshape(t * g * g, patch, patch, c)
    f32 = dict(dtype=torch.float32, device=frames.device)
    oy, ox = torch.meshgrid(
        torch.arange(g, **f32) * patch, torch.arange(g, **f32) * patch,
        indexing="ij",
    )
    origins = torch.stack([oy.reshape(-1), ox.reshape(-1)], -1).repeat(t, 1)
    ts = torch.arange(t, **f32).repeat_interleave(g * g)
    return patches, ts, origins


def per_frame_grid(t: int, g: int, budget_patches: int) -> int:
    """Side, in patches, of the square each of ``t`` frames keeps within
    ``budget_patches`` (SD's downsampled grid, GC's crop), at most the
    frame's ``g``."""
    per_frame_budget = max(1, budget_patches // t)
    return min(max(1, int(math.floor(math.sqrt(per_frame_budget)))), g)


def full_video(frames: Tensor, patch: int) -> RetainedPatches:
    """FV: retain everything (the memory-unbounded reference)."""
    patches, ts, origins = _grid_patches(frames, patch)
    valid = torch.ones(patches.shape[0], dtype=torch.bool,
                       device=frames.device)
    return RetainedPatches(patches, ts, origins, valid)


def temporal_downsample(
    frames: Tensor, patch: int, budget_patches: int
) -> RetainedPatches:
    """TD: keep every k-th frame at full resolution, k set by the budget."""
    t, h, w, _ = frames.shape
    g = h // patch
    per_frame = g * g
    n_keep_frames = max(1, budget_patches // per_frame)
    stride = max(1, t // n_keep_frames)
    kept = frames[::stride][:n_keep_frames]
    patches, ts, origins = _grid_patches(kept, patch)
    ts = ts * stride  # restore original timestamps
    return _pad_to(patches, ts, origins, budget_patches)


def spatial_downsample(
    frames: Tensor, patch: int, budget_patches: int
) -> RetainedPatches:
    """SD: keep all frames, downsample each so total patches fit the budget
    (antialiased bilinear, as ``jax.image.resize``)."""
    t, h, w, _ = frames.shape
    gg = per_frame_grid(t, h // patch, budget_patches)
    new_hw = gg * patch
    small = depth_mod.resize_image(frames, new_hw)
    patches, ts, origins = _grid_patches(small, patch)
    scale = h / new_hw
    return _pad_to(patches, ts, origins * scale, budget_patches)


def gaze_crop(
    frames: Tensor, gazes: Tensor, patch: int, budget_patches: int
) -> RetainedPatches:
    """GC: crop a square around the gaze point in every frame."""
    t, h, w, _ = frames.shape
    per_frame_budget = max(1, budget_patches // t)
    gg = max(1, int(math.floor(math.sqrt(per_frame_budget))))
    crop = min(gg * patch, h)
    cy = (gazes[:, 1] - crop / 2).clamp(0, h - crop).to(torch.int32)
    cx = (gazes[:, 0] - crop / 2).clamp(0, w - crop).to(torch.int32)
    span = torch.arange(crop, dtype=torch.int32, device=frames.device)
    rows = (cy[:, None] + span)[:, :, None]  # (T, crop, 1)
    cols = (cx[:, None] + span)[:, None, :]  # (T, 1, crop)
    frame_idx = torch.arange(t, device=frames.device)[:, None, None]
    regions = frames[frame_idx, rows, cols]  # (T, crop, crop, 3)
    corners = torch.stack([cy, cx], -1).to(torch.float32)
    patches, ts, origins = _grid_patches(regions, patch)
    gg2 = crop // patch
    frame_corner = corners.repeat_interleave(gg2 * gg2, dim=0)
    return _pad_to(patches, ts, origins + frame_corner, budget_patches)


def _pad_to(patches, ts, origins, budget) -> RetainedPatches:
    """Pad/trim a patch list to exactly ``budget`` entries (masked)."""
    n, p = patches.shape[0], patches.shape[1]
    dev = patches.device
    if n >= budget:
        return RetainedPatches(
            patches[:budget], ts[:budget], origins[:budget],
            torch.ones(budget, dtype=torch.bool, device=dev),
        )
    pad = budget - n
    f32 = dict(dtype=torch.float32, device=dev)
    return RetainedPatches(
        torch.cat([patches, torch.zeros(pad, p, p, 3, **f32)], 0),
        torch.cat([ts, torch.zeros(pad, **f32)], 0),
        torch.cat([origins, torch.zeros(pad, 2, **f32)], 0),
        torch.cat([torch.ones(n, dtype=torch.bool, device=dev),
                   torch.zeros(pad, dtype=torch.bool, device=dev)], 0),
    )


def from_dc_buffer(buf) -> RetainedPatches:
    """Adapt an EPIC DC buffer to the common retained-patch record (with
    its saliency / popularity / last-use metadata)."""
    return dcb.to_retained(buf)
