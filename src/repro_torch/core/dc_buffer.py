"""Duplication Check (DC) buffer (EPIC paper, Sections 3.4 and 4.1.2).

Port of ``repro.core.dc_buffer``.  Each entry holds the paper's six
components — RGB patch ``I_c``, timestamp ``t_c``, pose ``U_c``, depth
map ``d_c``, saliency ``S_c``, popularity ``P_c`` — plus the patch's
``origin`` (row, col) in its source frame, its last-use time and a
``valid`` occupancy mask.  The buffer is a fixed-capacity
structure-of-arrays of tensors; every operation returns a new buffer.

Ranking follows ``jax.lax.top_k``, which puts the lower index first on
ties: :func:`top_k_indices` is a stable descending sort, because ties are
routine here (the ``1e-7 * index`` penalty vanishes in float32 for large
scores) and ``torch.topk`` promises no order among them.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
from torch import Tensor

from repro_torch.core import retained as ret


def top_k_indices(key: Tensor, k: int) -> Tensor:
    """Indices of the ``k`` largest entries of 1-D ``key``, lower index
    first among equals (``jax.lax.top_k`` order)."""
    return torch.sort(key, descending=True, stable=True).indices[:k]


class DCBufferConfig(NamedTuple):
    capacity: int = 256  # max entries N
    patch: int = 32  # patch side P
    w_popularity: float = 1.0  # retention score weight for P_c
    w_recency: float = 0.1  # retention score weight for t_c (per frame)


class DCBuffer(NamedTuple):
    """Structure-of-arrays DC buffer state (float32 unless noted)."""

    rgb: Tensor  # (N, P, P, 3)
    depth: Tensor  # (N, P, P)
    pose: Tensor  # (N, 4, 4)
    origin: Tensor  # (N, 2) (row, col) in source frame
    t: Tensor  # (N,) capture timestamp
    t_last: Tensor  # (N,) last-use (match) timestamp — recency
    saliency: Tensor  # (N,)
    popularity: Tensor  # (N,)
    valid: Tensor  # (N,) bool

    @property
    def capacity(self) -> int:
        return self.rgb.shape[0]

    @property
    def patch_size(self) -> int:
        return self.rgb.shape[1]


def init(cfg: DCBufferConfig, device) -> DCBuffer:
    n, p = cfg.capacity, cfg.patch
    f32 = dict(dtype=torch.float32, device=device)
    return DCBuffer(
        rgb=torch.zeros((n, p, p, 3), **f32),
        depth=torch.ones((n, p, p), **f32),
        pose=torch.eye(4, **f32).expand(n, 4, 4).contiguous(),
        origin=torch.zeros((n, 2), **f32),
        t=torch.full((n,), -1.0, **f32),
        t_last=torch.full((n,), -1.0, **f32),
        saliency=torch.zeros((n,), **f32),
        popularity=torch.zeros((n,), **f32),
        valid=torch.zeros((n,), dtype=torch.bool, device=device),
    )


def retention_score(buf: DCBuffer, cfg: DCBufferConfig, t_now: Tensor) -> Tensor:
    """Buffer-controller retention score: higher = keep; invalid = -inf.

    ``pop - w_recency * age`` is rounded once, as the fused multiply-add
    that XLA makes of it in the JAX package: with integer popularities and
    ages, scores tie by construction, and the rounding decides which entry
    is evicted.  The product and difference are exact in float64.
    """
    age = t_now - buf.t_last  # recency of USE, not of capture
    pop = (cfg.w_popularity * buf.popularity).double()
    w_rec = float(np.float32(cfg.w_recency))
    score = (pop - w_rec * age.double()).float()
    return torch.where(buf.valid, score, torch.full_like(score, -torch.inf))


def bump_popularity(
    buf: DCBuffer, entry_idx: Tensor, mask: Tensor, t_now=None
) -> DCBuffer:
    """Increment ``P_c`` of matched entries and refresh their last use.

    Args:
      entry_idx: (M,) index of the matched buffer entry per patch.
      mask: (M,) bool — whether that patch actually matched.
      t_now: current frame time; None leaves recency unchanged.

    Several patches matching one entry accumulate (a segment sum).
    """
    # Out-of-place index_add: the slot-batched step vmaps this body.
    inc = torch.zeros_like(buf.popularity).index_add(
        0, entry_idx, mask.to(buf.popularity.dtype)
    )
    out = buf._replace(popularity=buf.popularity + inc)
    if t_now is not None:
        hits = torch.zeros(
            buf.valid.shape, dtype=torch.int32, device=buf.valid.device
        ).index_add(0, entry_idx, mask.to(torch.int32))
        t_now = torch.as_tensor(t_now, dtype=torch.float32,
                                device=buf.t_last.device)
        out = out._replace(
            t_last=torch.where(hits > 0, t_now, out.t_last)
        )
    return out


class NewEntries(NamedTuple):
    """Candidate entries for insertion (all leading dim M)."""

    rgb: Tensor  # (M, P, P, 3)
    depth: Tensor  # (M, P, P)
    pose: Tensor  # (M, 4, 4)
    origin: Tensor  # (M, 2)
    saliency: Tensor  # (M,)


def insert(
    buf: DCBuffer,
    cfg: DCBufferConfig,
    new: NewEntries,
    insert_mask: Tensor,
    t_now: Tensor,
) -> DCBuffer:
    """Insert masked new entries, evicting lowest-retention-score slots.

    Concatenate (existing, new) and keep the top-``capacity`` by retention
    score.  New entries start with ``P_t = 1``; masked-out candidates
    score -inf.  Ties favour existing entries (index penalty, then the
    stable sort).
    """
    n = buf.capacity
    m = new.rgb.shape[0]
    t_b = t_now.to(torch.float32).expand(m)
    cand = DCBuffer(
        rgb=torch.cat([buf.rgb, new.rgb], 0),
        depth=torch.cat([buf.depth, new.depth], 0),
        pose=torch.cat([buf.pose, new.pose], 0),
        origin=torch.cat([buf.origin, new.origin], 0),
        t=torch.cat([buf.t, t_b], 0),
        t_last=torch.cat([buf.t_last, t_b], 0),
        saliency=torch.cat([buf.saliency, new.saliency], 0),
        popularity=torch.cat([buf.popularity, torch.ones_like(t_b)], 0),
        valid=torch.cat([buf.valid, insert_mask], 0),
    )
    score = retention_score(cand, cfg, t_now)
    idx_penalty = torch.arange(
        n + m, dtype=torch.float32, device=score.device
    ) * 1e-7
    keyed = torch.where(torch.isneginf(score), score, score - idx_penalty)
    keep = top_k_indices(keyed, n)
    return DCBuffer(*(x[keep] for x in cand))


def count_valid(buf: DCBuffer) -> Tensor:
    return buf.valid.sum(dtype=torch.int32)


def memory_bytes(buf: DCBuffer) -> Tensor:
    """Storage footprint at ASIC precisions, valid entries only."""
    return count_valid(buf) * ret.dc_entry_bytes(buf.patch_size)


def to_retained(buf: DCBuffer) -> ret.RetainedPatches:
    """Adapt the DC buffer to the method-agnostic retained record."""
    return ret.RetainedPatches(
        rgb=buf.rgb,
        t=buf.t,
        origin=buf.origin,
        valid=buf.valid,
        saliency=buf.saliency,
        popularity=buf.popularity,
        t_last=buf.t_last,
    )


def entry_bbox_inputs(buf: DCBuffer) -> Tuple[Tensor, Tensor]:
    """``origin (N, 2)`` and ``corner_depths (N, 4)`` at [tl, tr, bl, br]."""
    p = buf.patch_size
    d = buf.depth
    corners = torch.stack(
        [d[:, 0, 0], d[:, 0, p - 1], d[:, p - 1, 0], d[:, p - 1, p - 1]],
        dim=-1,
    )
    return buf.origin, corners


def newest_match(
    match_ok: Tensor, entry_t: Tensor, entry_valid: Tensor
) -> Tuple[Tensor, Tensor]:
    """Per patch, the newest feasible entry (the ASIC's newest-first scan).

    ``argmax`` over ``(feasible * timestamp)`` returns the first maximum,
    so equal timestamps resolve to the lowest entry index, as in the JAX
    package.  Shape-polymorphic over both axes.

    Args:
      match_ok: (N, M) bool feasibility of (entry, patch) pairs.
      entry_t: (N,) entry timestamps.
      entry_valid: (N,) entry occupancy.

    Returns:
      idx (M,) int64 chosen entry per patch; matched (M,) bool.
    """
    feas = match_ok & entry_valid[:, None]
    key = torch.where(
        feas, entry_t[:, None], torch.full_like(entry_t, -torch.inf)[:, None]
    )
    return key.argmax(dim=0), feas.any(dim=0)
