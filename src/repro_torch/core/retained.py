"""Method-agnostic retained representation + unified byte accounting.

Port of ``repro.core.retained`` with the same constants.  Every
compressor exports a :class:`RetainedPatches` record.

* :func:`retained_patch_bytes` — the EFM-visible retained record (uint8
  RGB + light metadata), charged identically to every method (Table 1).
* :func:`dc_entry_bytes` — a full on-device DC-buffer entry at the ASIC
  storage precisions (uint8 RGB, fp16 depth, pose/score metadata — the
  10:5:1 bank split of Section 4.1.2), for Figure-6 accounting.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import Tensor

# Storage precisions (ASIC, Section 4.1.2). The simulation computes in
# float32 but footprint is charged at deployment precision.
RGB_BYTES_PER_PX = 3  # uint8 x RGB
DEPTH_BYTES_PER_PX = 2  # fp16
RETAINED_META_BYTES = 16  # timestamp + origin + mask bits (EFM record)
DC_ENTRY_META_BYTES = 64  # + pose (12 floats), saliency, popularity


def patch_rgb_bytes(patch: int) -> int:
    """Raw pixel payload of one PxP RGB patch."""
    return patch * patch * RGB_BYTES_PER_PX


def retained_patch_bytes(patch: int) -> int:
    """One EFM-visible retained-patch record (any method)."""
    return patch_rgb_bytes(patch) + RETAINED_META_BYTES


def dc_entry_bytes(patch: int) -> int:
    """One full DC-buffer entry (RGB + depth map + metadata banks)."""
    return (
        patch_rgb_bytes(patch)
        + patch * patch * DEPTH_BYTES_PER_PX
        + DC_ENTRY_META_BYTES
    )


def bbox_row_bytes() -> int:
    """One warped-bbox metadata row (4 x fp32: vmin, umin, vmax, umax)."""
    return 4 * 4


class RetainedPatches(NamedTuple):
    """Method-agnostic retained representation (fixed capacity, masked).

    ``saliency`` / ``popularity`` / ``t_last`` are set by EPIC's DC buffer
    (:func:`repro_torch.core.dc_buffer.to_retained`).
    """

    rgb: Tensor  # (N, P, P, 3)
    t: Tensor  # (N,) frame timestamp
    origin: Tensor  # (N, 2) patch top-left (row, col) in its frame
    valid: Tensor  # (N,) bool
    saliency: Optional[Tensor] = None  # (N,) HIR score S_c
    popularity: Optional[Tensor] = None  # (N,) match counter P_c
    t_last: Optional[Tensor] = None  # (N,) last-use timestamp

    @property
    def patch_size(self) -> int:
        return self.rgb.shape[1]

    def memory_bytes(self) -> Tensor:
        """Table-1 accounting: EFM-visible record, valid entries only."""
        per = retained_patch_bytes(self.patch_size)
        return self.valid.sum(dtype=torch.int32) * per
