"""Temporal-Spatial Redundancy Check (TSRC) — EPIC paper Section 3.4.

Port of ``repro.core.tsrc``.  Per processed frame:

  1. SRD: the HIR module marks salient patches (Section 3.3).
  2. TRD: every valid DC-buffer entry is warped into the current view
     (Eq. 1, the reproject-match op) and scored against the frame.
  3. Bounding-box overlap associates warped entries with current patches.
  4. A current patch *matches* the newest entry that is RGB-close
     (diff <= tau), covering (coverage >= c_min) and overlapping
     (overlap >= o_min).  Matches bump the entry's popularity; unmatched
     salient patches are inserted.

Three branches, as in the JAX package: dense; dense with the backend's
``fused_match`` (one kernel for scores, thresholds and mask rows); and the
two-phase sparse TRD (``prefilter_k`` / ``patch_k``), fused or not.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
from torch import Tensor

from repro_torch.api.registry import BackendValidatedConfig, get_backend
from repro_torch.core import dc_buffer as dcb
from repro_torch.core import geometry as geo
from repro_torch.kernels.reproject_match import sparse as sparse_mod
from repro_torch.kernels.reproject_match.ops import reproject_match


class _TSRCConfig(NamedTuple):
    tau: float = 0.08  # RGB-difference match threshold (paper's tau)
    o_min: float = 0.5  # min bbox overlap fraction of a patch
    c_min: float = 0.6  # min warped-pixel coverage of an entry
    window: int = 64  # reproject-match sampling window
    backend: str = "fused"  # reproject-match backend (registry key)
    prefilter_k: int = 0  # 0 = dense TRD; K > 0 = sparse top-K candidates
    patch_k: int = 0  # 0 = dense patch axis; P_k > 0 = salient compaction


class TSRCConfig(BackendValidatedConfig, _TSRCConfig):
    """TSRC thresholds + backend selection, validated on construction.

    The default backend is the fused CUDA kernel; ``"ref"`` (the plain
    PyTorch version) is an explicit choice.  ``prefilter_k = K > 0`` runs
    the two-phase sparse TRD, ``patch_k = P_k > 0`` compacts the patch
    axis of the match algebra as well.
    """

    __slots__ = ()


class TSRCStats(NamedTuple):
    """Per-frame counters (int32 0-dim tensors)."""

    n_salient: Tensor  # patches passing SRD
    n_matched: Tensor  # patches found redundant (popularity bumped)
    n_inserted: Tensor  # new DC-buffer entries
    n_bbox_checks: Tensor  # bbox reprojections performed (= valid entries)
    n_full_checks: Tensor  # entries fully pixel-scored (sparse: real
    #   candidates; dense: entries bbox-overlapping a salient patch)
    buffer_valid: Tensor  # occupancy after the step
    n_prefilter_overflow: Tensor  # passing entries truncated by top-K
    n_patch_overflow: Tensor  # salient patches truncated by top-P_k
    n_patch_checked: Tensor  # compacted patch slots gathered


def extract_patches(frame: Tensor, patch: int) -> Tuple[Tensor, Tensor]:
    """Split ``(H, W, 3)`` into row-major PxP patches.

    Returns ``patches (G*G, P, P, 3)`` and ``origins (G*G, 2)`` (row, col).
    """
    h, w, c = frame.shape
    gy, gx = h // patch, w // patch
    x = frame[: gy * patch, : gx * patch]
    x = x.reshape(gy, patch, gx, patch, c).permute(0, 2, 1, 3, 4)
    patches = x.reshape(gy * gx, patch, patch, c)
    oy, ox = torch.meshgrid(
        torch.arange(gy, dtype=torch.float32, device=frame.device) * patch,
        torch.arange(gx, dtype=torch.float32, device=frame.device) * patch,
        indexing="ij",
    )
    return patches, torch.stack([oy.reshape(-1), ox.reshape(-1)], dim=-1)


def extract_depth_patches(depth: Tensor, patch: int) -> Tensor:
    """Split ``(H, W)`` depth into ``(G*G, P, P)`` crops (same order)."""
    h, w = depth.shape
    gy, gx = h // patch, w // patch
    d = depth[: gy * patch, : gx * patch]
    d = d.reshape(gy, patch, gx, patch).permute(0, 2, 1, 3)
    return d.reshape(gy * gx, patch, patch)


def tsrc_step(
    buf: dcb.DCBuffer,
    buf_cfg: dcb.DCBufferConfig,
    cfg: TSRCConfig,
    frame: Tensor,
    depth_map: Tensor,
    saliency_mask: Tensor,
    saliency_score: Tensor,
    pose: Tensor,
    t_now: Tensor,
    intr: geo.Intrinsics,
) -> Tuple[dcb.DCBuffer, TSRCStats]:
    """One TSRC update (paper Figure 3 (c), dark-gray steps 1-3).

    Args:
      frame: (H, W, 3) current frame F_t.
      depth_map: (H, W) depth of F_t (for inserted entries).
      saliency_mask: (G*G,) bool S_t from HIR.
      saliency_score: (G*G,) float saliency strength.
      pose: (4, 4) current camera pose U_t.
      t_now: () float32 timestamp.

    Returns:
      Updated buffer and per-frame stats.
    """
    patch = buf.patch_size
    patches, origins = extract_patches(frame, patch)
    device = frame.device

    # --- TRD: warp buffered entries into the current view. ------------------
    t_rel = geo.invert_pose(pose) @ buf.pose
    fused_match = getattr(get_backend(cfg.backend), "fused_match", None)
    n_patches = origins.shape[0]
    zero = torch.zeros((), dtype=torch.int32, device=device)
    if cfg.prefilter_k > 0 or cfg.patch_k > 0:
        # Two-phase sparse TRD; patch_k > 0 with prefilter_k == 0 runs the
        # same machinery with the candidate budget at capacity.
        k_entries = (
            min(cfg.prefilter_k, buf.capacity)
            if cfg.prefilter_k > 0
            else buf.capacity
        )
        pre = sparse_mod.bbox_prefilter(
            *dcb.entry_bbox_inputs(buf),
            t_rel,
            buf.t,
            buf.valid,
            origins,
            saliency_mask,
            intr,
            patch,
            o_min=cfg.o_min,
            k=k_entries,
        )
        idx = pre.cand_idx
        cand_valid = buf.valid[idx] & pre.cand_real
        if fused_match is not None:
            # Fused ∘ sparse: the fused kernel runs on the (K, ...) slabs.
            _, _, _, c_pair, _ = fused_match(
                buf.rgb[idx],
                buf.depth[idx],
                buf.origin[idx],
                t_rel[idx],
                frame,
                intr,
                window=cfg.window,
                tau=cfg.tau,
                o_min=cfg.o_min,
                c_min=cfg.c_min,
            )
            pair_rows = c_pair & cand_valid[:, None]  # (K, M)
        else:
            c_diff, c_cov, _ = reproject_match(
                buf.rgb[idx],
                buf.depth[idx],
                buf.origin[idx],
                t_rel[idx],
                frame,
                intr,
                window=cfg.window,
                backend=cfg.backend,
            )
            entry_ok_c = (c_diff <= cfg.tau) & (c_cov >= cfg.c_min) & cand_valid
            pair_rows = entry_ok_c[:, None] & pre.overlap_ok[idx]  # (K, M)
        if 0 < cfg.patch_k < n_patches:
            # Association on (K, P_k) compacted slabs, scattered back
            # (patches that won no slot report unmatched -> re-inserted).
            pc = sparse_mod.compact_salient_patches(
                saliency_mask,
                pre.overlap_ok,
                pre.passes,
                k=min(cfg.patch_k, n_patches),
            )
            match_c = pair_rows[:, pc.idx] & pc.real[None, :]  # (K, P_k)
            idx_c, matched_c = dcb.newest_match(
                match_c, buf.t[idx], cand_valid
            )
            # Out-of-place scatters (the slots of pc.idx are distinct), so
            # the slot-batched step can vmap this body.
            matched = torch.zeros(
                n_patches, dtype=torch.bool, device=device
            ).scatter(0, pc.idx, matched_c & pc.real)
            chosen = torch.zeros(
                n_patches, dtype=torch.int64, device=device
            ).scatter(0, pc.idx, torch.where(
                pc.real, idx[idx_c], torch.zeros_like(idx_c)
            ))
            n_patch_overflow = pc.n_overflow
            n_patch_checked = pc.n_compacted
        else:
            match_ok_c = pair_rows & saliency_mask[None, :]  # (K, M)
            idx_c, matched = dcb.newest_match(
                match_ok_c, buf.t[idx], cand_valid
            )
            chosen = idx[idx_c]
            n_patch_overflow = zero
            n_patch_checked = zero
        n_full_checks = pre.n_full
        n_overflow = pre.n_overflow
    elif fused_match is not None:
        # One kernel: warp + match + thresholds + per-(entry, patch) mask.
        _, _, _, pair_ok, overlap_ok = fused_match(
            buf.rgb,
            buf.depth,
            buf.origin,
            t_rel,
            frame,
            intr,
            window=cfg.window,
            tau=cfg.tau,
            o_min=cfg.o_min,
            c_min=cfg.c_min,
        )
        match_ok = pair_ok & buf.valid[:, None] & saliency_mask[None, :]
        chosen, matched = dcb.newest_match(match_ok, buf.t, buf.valid)
        n_full_checks = None  # dense: derived from overlap_ok below
        n_overflow = n_patch_overflow = n_patch_checked = zero
    else:
        diff, coverage, bbox = reproject_match(
            buf.rgb,
            buf.depth,
            buf.origin,
            t_rel,
            frame,
            intr,
            window=cfg.window,
            backend=cfg.backend,
        )
        # --- Spatial association: warped-entry bbox vs patch grid. ---------
        overlap = geo.bbox_overlap_fraction(
            bbox[:, None, :], origins[None, :, :], patch
        )  # (N, M)
        overlap_ok = overlap >= cfg.o_min
        entry_ok = (diff <= cfg.tau) & (coverage >= cfg.c_min) & buf.valid
        match_ok = entry_ok[:, None] & overlap_ok & saliency_mask[None, :]
        chosen, matched = dcb.newest_match(match_ok, buf.t, buf.valid)
        n_full_checks = None
        n_overflow = n_patch_overflow = n_patch_checked = zero
    # The occupancy the TRD ran against: insertion below permutes slots.
    valid_pre = buf.valid

    # --- Popularity bump for matches (step 3). ------------------------------
    buf = dcb.bump_popularity(buf, chosen, matched, t_now=t_now)

    # --- Insert unmatched salient patches. ----------------------------------
    insert_mask = saliency_mask & ~matched
    new = dcb.NewEntries(
        rgb=patches,
        depth=extract_depth_patches(depth_map, patch),
        pose=pose.expand(patches.shape[0], 4, 4),
        origin=origins,
        saliency=saliency_score,
    )
    buf = dcb.insert(buf, buf_cfg, new, insert_mask, t_now)

    if n_full_checks is None:
        # Dense paths: entries whose bbox overlaps some salient patch (what
        # the ASIC would fully reproject).
        any_overlap = (overlap_ok & saliency_mask[None, :]).any(dim=1)
        n_full_checks = (any_overlap & valid_pre).sum(dtype=torch.int32)
    stats = TSRCStats(
        n_salient=saliency_mask.sum(dtype=torch.int32),
        n_matched=matched.sum(dtype=torch.int32),
        n_inserted=insert_mask.sum(dtype=torch.int32),
        n_bbox_checks=valid_pre.sum(dtype=torch.int32),
        n_full_checks=n_full_checks,
        buffer_valid=dcb.count_valid(buf),
        n_prefilter_overflow=n_overflow,
        n_patch_overflow=n_patch_overflow,
        n_patch_checked=n_patch_checked,
    )
    return buf, stats


def tsrc_step_sequential_oracle(
    buf: dcb.DCBuffer,
    buf_cfg: dcb.DCBufferConfig,
    cfg: TSRCConfig,
    frame: Tensor,
    depth_map: Tensor,
    saliency_mask: Tensor,
    saliency_score: Tensor,
    pose: Tensor,
    t_now: Tensor,
    intr: geo.Intrinsics,
):
    """Python-loop oracle of the ASIC's newest-first sequential scan.

    Used only in tests to show that the dense-parallel ``newest_match``
    equals the paper's early-exit buffer walk.  Returns numpy
    ``(chosen, matched)``.
    """
    patch = buf.patch_size
    patches, origins = extract_patches(frame, patch)
    t_rel = geo.invert_pose(pose) @ buf.pose
    diff, coverage, bbox = reproject_match(
        buf.rgb, buf.depth, buf.origin, t_rel, frame, intr,
        window=cfg.window, backend="ref",
    )
    overlap = geo.bbox_overlap_fraction(
        bbox[:, None, :], origins[None, :, :], patch
    ).cpu().numpy()
    diff = diff.cpu().numpy()
    coverage = coverage.cpu().numpy()
    valid = buf.valid.cpu().numpy()
    ts = buf.t.cpu().numpy()
    sal = saliency_mask.cpu().numpy()

    order = np.argsort(-ts, kind="stable")  # newest first, the ASIC walk
    m = patches.shape[0]
    matched = np.zeros(m, bool)
    chosen = np.zeros(m, np.int64)
    for p in range(m):
        if not sal[p]:
            continue
        for c in order:
            if not valid[c]:
                continue
            if (
                diff[c] <= cfg.tau
                and coverage[c] >= cfg.c_min
                and overlap[c, p] >= cfg.o_min
            ):
                matched[p] = True
                chosen[p] = c
                break  # early exit at the first (newest) hit
    return chosen, matched
