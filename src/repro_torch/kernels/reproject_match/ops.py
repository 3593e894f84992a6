"""Dispatching wrapper for the reproject-match op.

Backends are looked up by name in :mod:`repro_torch.api.registry`, with the
JAX package's keys:

``"ref"`` — the plain PyTorch version (``ref.py``), an explicit choice.

``"pallas"`` — the CUDA kernel, one warp and one CTA per entry
(``kernel.py``).

``"pallas_tiled"`` — the same launch under the JAX package's key for the
small candidate counts of the sparse TRD.

``"fused"`` (registered in ``fused.py``) — the same scores plus the
overlap and update-mask rows in one pass; the port's default.

The kernel backends take the plain version only for CPU tensors.
"""

from __future__ import annotations

from typing import Tuple

from torch import Tensor

from repro_torch.api.registry import get_backend, register_backend
from repro_torch.core import geometry as geo
from repro_torch.kernels.reproject_match.kernel import (
    reproject_match_pallas,
    reproject_match_pallas_tiled,
)
from repro_torch.kernels.reproject_match.ref import reproject_match_ref


@register_backend("ref")
def _ref_backend(
    entry_rgb, entry_depth, entry_origin, t_rel, frame, intr, *, window
):
    return reproject_match_ref(
        entry_rgb, entry_depth, entry_origin, t_rel, frame, intr, window
    )


@register_backend("pallas")
def _pallas_backend(
    entry_rgb, entry_depth, entry_origin, t_rel, frame, intr, *, window
):
    return reproject_match_pallas(
        entry_rgb, entry_depth, entry_origin, t_rel, frame, intr,
        window=window,
    )


@register_backend("pallas_tiled")
def _pallas_tiled_backend(
    entry_rgb, entry_depth, entry_origin, t_rel, frame, intr, *, window
):
    return reproject_match_pallas_tiled(
        entry_rgb, entry_depth, entry_origin, t_rel, frame, intr,
        window=window,
    )


def reproject_match(
    entry_rgb: Tensor,
    entry_depth: Tensor,
    entry_origin: Tensor,
    t_rel: Tensor,
    frame: Tensor,
    intr: geo.Intrinsics,
    *,
    window: int = 64,
    backend: str = "fused",
) -> Tuple[Tensor, Tensor, Tensor]:
    """Warp buffered patches into the current view and score redundancy.

    Args:
      entry_rgb: (N, P, P, 3) buffered patch pixels I_c.
      entry_depth: (N, P, P) buffered per-pixel depth d_c.
      entry_origin: (N, 2) patch top-left (row, col) in the source frame.
      t_rel: (N, 4, 4) source->current camera transforms.
      frame: (H, W, 3) current frame F_t.
      intr: camera intrinsics.
      window: sampling window side (op semantics; see ref.py).
      backend: registry name.

    Returns:
      diff (N,), coverage (N,), bbox (N, 4).
    """
    fn = get_backend(backend)
    return fn(
        entry_rgb, entry_depth, entry_origin, t_rel, frame, intr,
        window=window,
    )
