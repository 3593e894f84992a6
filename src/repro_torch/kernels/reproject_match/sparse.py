"""Two-phase sparse reproject-match (EPIC accelerator, Section 4.1.1).

Port of ``repro/kernels/reproject_match/sparse.py``.

Phase 1 — :func:`bbox_prefilter` (cheap, all ``N`` entries): warp only the
four patch corners, intersect the bbox with the frame's patch grid, mark
the entries whose bbox overlaps some salient patch with ``overlap >=
o_min``, and take the ``K`` newest of them as candidates.

Phase 2 — :func:`sparse_reproject_match` (``K`` entries): run the
registered backend on the gathered candidate slabs and scatter the
scores back, non-candidates forced non-matching (``diff = 1``,
``coverage = 0``).

Patch side — :func:`compact_salient_patches`: the same composite top-K
on the patch axis, so the association runs on ``(K, P_k)`` slabs.

The sparse path is bit-identical to the dense one whenever at most K
entries pass and at most P_k patches are salient; beyond that it is
conservative (extra insertions, never false matches).  Both selections
rank like ``jax.lax.top_k``, lower index first among equal keys (same-
frame timestamps, patch keys in {0, 1, 2}).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch import Tensor

from repro_torch.core import geometry as geo
from repro_torch.core.dc_buffer import top_k_indices


class PrefilterResult(NamedTuple):
    """Phase-1 output: per-entry spatial association + the candidate set."""

    bbox: Tensor  # (N, 4) corner-warp bbox of every entry
    overlap_ok: Tensor  # (N, M) bool — bbox overlap >= o_min per patch
    passes: Tensor  # (N,) bool — valid AND overlaps some salient patch
    cand_idx: Tensor  # (K,) int64 — candidate entry indices (newest first)
    cand_real: Tensor  # (K,) bool — slot holds an actual passing entry
    n_pass: Tensor  # () int32 — entries passing the prefilter
    n_full: Tensor  # () int32 — candidates pixel-scored = min(n_pass, K)
    n_overflow: Tensor  # () int32 — passing entries truncated


def bbox_prefilter(
    entry_origin: Tensor,  # (N, 2)
    corner_depths: Tensor,  # (N, 4) depth at [tl, tr, bl, br]
    t_rel: Tensor,  # (N, 4, 4)
    entry_t: Tensor,  # (N,) capture timestamps
    entry_valid: Tensor,  # (N,) occupancy
    patch_origins: Tensor,  # (M, 2) current-frame patch grid top-lefts
    salient: Tensor,  # (M,) bool
    intr: geo.Intrinsics,
    patch: int,
    *,
    o_min: float,
    k: int,
) -> PrefilterResult:
    """Corner-warp prefilter + top-K newest candidate selection (phase 1).

    ``k`` is clamped to ``N``: more candidates than entries is the dense set.
    """
    k = min(k, entry_t.shape[0])
    bbox, _ = geo.reproject_bbox(entry_origin, corner_depths, intr, t_rel, patch)
    overlap = geo.bbox_overlap_fraction(
        bbox[:, None, :], patch_origins[None, :, :], patch
    )  # (N, M)
    overlap_ok = overlap >= o_min
    passes = (overlap_ok & salient[None, :]).any(dim=1) & entry_valid

    # Composite (pass-flag, timestamp) key: passing entries rank by
    # recency; the others sink to -inf and only fill unused slots.
    key = torch.where(passes, entry_t, torch.full_like(entry_t, -torch.inf))
    cand_idx = top_k_indices(key, k)
    cand_real = passes[cand_idx]
    n_pass = passes.sum(dtype=torch.int32)
    n_full = cand_real.sum(dtype=torch.int32)
    return PrefilterResult(
        bbox=bbox,
        overlap_ok=overlap_ok,
        passes=passes,
        cand_idx=cand_idx,
        cand_real=cand_real,
        n_pass=n_pass,
        n_full=n_full,
        n_overflow=n_pass - n_full,
    )


class PatchCompaction(NamedTuple):
    """Patch-axis mirror of the candidate set: top-``P_k`` salient slots."""

    idx: Tensor  # (P_k,) int64 — compacted patch-slot indices
    real: Tensor  # (P_k,) bool — slot holds an actual salient patch
    n_salient: Tensor  # () int32
    n_compacted: Tensor  # () int32 — salient patches that won a slot
    n_overflow: Tensor  # () int32 — salient patches truncated


def compact_salient_patches(
    salient: Tensor,  # (M,) bool
    overlap_ok: Tensor,  # (N, M) bool — phase-1 bbox-overlap bits
    passes: Tensor,  # (N,) bool — phase-1 pass flags
    *,
    k: int,
) -> PatchCompaction:
    """Top-``P_k`` gather of the salient patch slots.

    Key: salient patches that some passing entry overlaps rank first,
    bare salient patches next, the rest last (they only fill unused
    slots, masked out via ``real``).
    """
    k = min(k, salient.shape[0])
    has_entry = (overlap_ok & passes[:, None]).any(dim=0)  # (M,)
    key = salient.to(torch.int32) + (salient & has_entry).to(torch.int32)
    idx = top_k_indices(key, k)
    real = salient[idx]
    n_salient = salient.sum(dtype=torch.int32)
    n_compacted = real.sum(dtype=torch.int32)
    return PatchCompaction(
        idx=idx,
        real=real,
        n_salient=n_salient,
        n_compacted=n_compacted,
        n_overflow=n_salient - n_compacted,
    )


def sparse_reproject_match(
    entry_rgb: Tensor,
    entry_depth: Tensor,
    entry_origin: Tensor,
    t_rel: Tensor,
    frame: Tensor,
    intr: geo.Intrinsics,
    pre: PrefilterResult,
    *,
    window: int,
    backend: str = "fused",
) -> Tuple[Tensor, Tensor, Tensor]:
    """Candidate gather -> backend reproject-match -> scatter (phase 2).

    Returns dense ``(N,)`` diff/coverage and ``(N, 4)`` bbox; entries that
    are not real candidates get ``diff = 1``, ``coverage = 0`` and their
    phase-1 corner bbox.
    """
    from repro_torch.kernels.reproject_match.ops import reproject_match

    idx = pre.cand_idx
    c_diff, c_cov, c_bbox = reproject_match(
        entry_rgb[idx],
        entry_depth[idx],
        entry_origin[idx],
        t_rel[idx],
        frame,
        intr,
        window=window,
        backend=backend,
    )
    n = entry_rgb.shape[0]
    real = pre.cand_real
    diff = torch.ones(n, dtype=torch.float32, device=frame.device)
    diff[idx] = torch.where(real, c_diff, torch.ones_like(c_diff))
    coverage = torch.zeros(n, dtype=torch.float32, device=frame.device)
    coverage[idx] = torch.where(real, c_cov, torch.zeros_like(c_cov))
    bbox = pre.bbox.clone()
    bbox[idx] = torch.where(real[:, None], c_bbox, pre.bbox[idx])
    return diff, coverage, bbox
