"""Serving telemetry: per-stream counters without per-stream host syncs
(port of ``repro.serve.telemetry``).

A serving loop pays **one device-to-host copy per tick**:

* :func:`tick_readback` — the per-tick scalars the server needs (the
  adaptive-K controllers' inputs and the stream counters), reduced on the
  device to ``(capacity,)`` rows of one stacked tensor and copied to the
  host once.  Given a *sequence* of pooled stats (one per stepped tier of
  a :class:`~repro_torch.serve.tiers.TieredPool`), every tier's rows join
  the same tensor, in argument order: a tiered tick still syncs once.
* :func:`pool_stream_counters` — the energy-model bridge over a pooled
  stats tree, one transfer for the whole pool.

:class:`StreamTelemetry` is the host-side per-stream accumulator the
server keeps per live session (and hands back on eviction).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import torch
from torch import Tensor


@dataclass
class StreamTelemetry:
    """Host-side per-stream serving counters (one per live session)."""

    session_id: Any
    slot: int
    generation: int
    admitted_tick: int
    tier: int = 0
    arrival_ema: float = 0.0
    n_migrations: int = 0
    n_chunks: int = 0
    n_frames: int = 0
    n_processed: int = 0
    n_inserted: int = 0
    buffer_valid: int = 0
    n_queue_overflow: int = 0
    idle_frames: int = 0
    last_step_tick: int = -1
    k_trajectory: List[int] = field(default_factory=list)

    def as_dict(self) -> Dict[str, Any]:
        d = dict(self.__dict__)
        d["k_trajectory"] = list(self.k_trajectory)
        return d


class TickReadback:
    """The per-slot scalars of one serving tick, fetched in one sync."""

    __slots__ = (
        "overflow", "peak_full", "processed", "inserted", "buffer_valid"
    )

    def __init__(self, overflow, peak_full, processed, inserted,
                 buffer_valid):
        self.overflow = overflow
        self.peak_full = peak_full
        self.processed = processed
        self.inserted = inserted
        self.buffer_valid = buffer_valid


def _tick_reductions(stats: Any) -> Tensor:
    """Device-side per-slot reductions of one pooled stats tree, as one
    ``(5, capacity)`` int64 tensor."""
    i64 = torch.int64
    zeros = torch.zeros(stats.processed.shape[:1], dtype=i64,
                        device=stats.processed.device)
    overflow = getattr(stats, "n_prefilter_overflow", None)
    full = getattr(stats, "n_full_checks", None)
    return torch.stack([
        zeros if overflow is None else overflow.sum(dim=1, dtype=i64),
        zeros if full is None else full.amax(dim=1).to(i64),
        stats.processed.sum(dim=1, dtype=i64),
        stats.n_inserted.sum(dim=1, dtype=i64),
        stats.buffer_valid[:, -1].to(i64),
    ])


def tick_readback(stats: Any, gather=None) -> TickReadback:
    """Reduce pooled stats tree(s) to per-slot tick scalars.

    ``stats`` tensors are ``(capacity, T, ...)`` (masked slots zeroed — see
    ``SlottedPool.step``).  Works for EPIC ``FrameStats`` and the
    baselines' stats alike: the sparse-TRD counters are read when present,
    zero otherwise.

    ``stats`` may also be a ``list``/``tuple`` of such trees — one per
    stepped tier of a tiered pool.  Their rows are concatenated along the
    slot axis in argument order, so rows ``[0, cap_0)`` are the first
    tree's slots, ``[cap_0, cap_0 + cap_1)`` the second's, and so on.

    Either way, everything crosses to the host in **one** ``.cpu()``.
    ``gather`` (a stream-sharded pool's ``gather_slots``) joins every
    rank's slot rows first, so each rank reads the whole pool's.
    """
    # A stats tree is typically a NamedTuple — only a *plain* list/tuple
    # means "one tree per stepped tier".
    parts = stats if type(stats) in (list, tuple) else (stats,)
    if not parts:
        raise ValueError("tick_readback needs at least one stats tree")
    rows = torch.cat([_tick_reductions(s) for s in parts], dim=1)
    if gather is not None:
        rows = gather(rows, 1)
    return TickReadback(*rows.cpu().numpy())


def pool_stream_counters(
    cfg,
    stats: Any,
    *,
    streams: Optional[Sequence[int]] = None,
) -> List[Any]:
    """Per-stream ``energy.StreamCounters`` over a pooled stats tree, in one
    device-to-host transfer.  A serving-layer alias of
    :func:`repro_torch.core.pipeline.pool_stream_counters`, which holds
    the one copy of the byte accounting."""
    from repro_torch.core import pipeline as pipe

    return pipe.pool_stream_counters(cfg, stats, streams=streams)
