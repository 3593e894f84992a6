"""Plain reproject-match in the CUDA kernel's summation order.

The per-pixel terms are ``ref.py``'s (:func:`entry_pixels`: each product
and sum rounded on its own, as the kernel built with ``--fmad=false``
rounds them); what differs from :func:`reproject_match_ref` is only the
order of the two sums the kernel takes in ``csrc/reproject_match.cu``:

* the channel mean of a pixel, ``((a0 + a1) + a2) / 3``;
* the masked sum over an entry's pixels: lane ``l`` of the entry's warp
  adds pixels ``l, l + 32, ...`` in that order, then the warp's 32
  partial sums meet in an xor butterfly over lane distances 16, 8, 4, 2, 1.

:func:`reproject_match_fused_warp_order` thresholds these scores into the
fused launch's two rows, with the overlap fraction divided as the kernel
divides it.

Every division is by a tensor on the data's device: on a CUDA device
PyTorch divides by a Python scalar as a product with its reciprocal,
which is not the kernel's IEEE division.  On the card the kernel equals
this function bitwise; on the CPU it stands for the kernel in the tests,
so that a threshold decided by the kernel's order can be checked against
the JAX package.  Nothing on the main path calls it.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import Tensor

from repro_torch.core import geometry as geo
from repro_torch.kernels.reproject_match.fused import patch_grid_origins
from repro_torch.kernels.reproject_match.ref import entry_pixels

WARP = 32


def warp_sum(x: Tensor) -> Tensor:
    """``(N, K)`` -> ``(N,)``: lane ``l`` sums ``x[:, l::32]`` in order,
    then the lanes meet in the xor butterfly (16, 8, 4, 2, 1)."""
    n, k = x.shape
    steps = -(-k // WARP)
    lanes = F.pad(x, (0, steps * WARP - k)).reshape(n, steps, WARP)
    part = torch.zeros((n, WARP), dtype=x.dtype, device=x.device)
    for s in range(steps):
        part = part + lanes[:, s]
    lane = torch.arange(WARP, device=x.device)
    for off in (16, 8, 4, 2, 1):
        part = part + part[:, lane ^ off]
    return part[:, 0]


def reproject_match_warp_order(
    entry_rgb: Tensor,  # (N, P, P, 3)
    entry_depth: Tensor,  # (N, P, P)
    entry_origin: Tensor,  # (N, 2) row, col
    t_rel: Tensor,  # (N, 4, 4) source -> current camera
    frame: Tensor,  # (H, W, 3)
    intr: geo.Intrinsics,
    window: int,
) -> Tuple[Tensor, Tensor, Tensor]:
    """:func:`reproject_match_ref`'s contract, summed as the kernel sums.

    Returns ``diff (N,)``, ``coverage (N,)``, ``bbox (N, 4)``.
    """
    n, p = entry_rgb.shape[0], entry_rgb.shape[1]
    absdiff, valid, bbox, bbox_valid = entry_pixels(
        entry_rgb, entry_depth, entry_origin, t_rel, frame, intr, window
    )

    three = _const(3.0, frame.device)
    contrib = (absdiff[..., 0] + absdiff[..., 1] + absdiff[..., 2]) / three
    contrib = torch.where(valid, contrib, torch.zeros_like(contrib))
    total = warp_sum(contrib.reshape(n, p * p))
    nvalid = valid.reshape(n, p * p).sum(dim=1).to(torch.float32)
    diff = torch.where(nvalid > 0, total / nvalid.clamp_min(1.0),
                       torch.ones_like(total))
    coverage = torch.where(bbox_valid,
                           nvalid / _const(float(p * p), frame.device),
                           torch.zeros_like(nvalid))
    return diff, coverage, bbox


def reproject_match_fused_warp_order(
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
    """:func:`reproject_match_fused`'s contract in the kernel's order:
    ``diff, coverage, bbox, pair_ok (N, M), overlap_ok (N, M)``."""
    diff, coverage, bbox = reproject_match_warp_order(
        entry_rgb, entry_depth, entry_origin, t_rel, frame, intr, window
    )
    p = entry_rgb.shape[1]
    origins = patch_grid_origins(frame.shape[0], frame.shape[1], p,
                                 frame.device)
    pv0, pu0 = origins[None, :, 0], origins[None, :, 1]
    iv = (torch.minimum(bbox[:, None, 2], pv0 + p)
          - torch.maximum(bbox[:, None, 0], pv0)).clamp_min(0.0)
    iu = (torch.minimum(bbox[:, None, 3], pu0 + p)
          - torch.maximum(bbox[:, None, 1], pu0)).clamp_min(0.0)
    overlap_ok = iv * iu / _const(float(p * p), frame.device) >= o_min
    entry_ok = (diff <= tau) & (coverage >= c_min)
    return diff, coverage, bbox, entry_ok[:, None] & overlap_ok, overlap_ok


def _const(v: float, device) -> Tensor:
    """A 0-dim float32 divisor on ``device`` (see the module's note)."""
    return torch.tensor(v, dtype=torch.float32, device=device)
