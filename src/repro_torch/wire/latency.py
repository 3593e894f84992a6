"""Latency telemetry: enqueue→readback histograms + percentiles (port of
``repro.wire.latency``; host-side Python).

The ingest chain stamps three points per chunk — **enqueue** (the wire
frame lands in the stream's :class:`~repro_torch.serve.ingest.ChunkQueue`),
**pop** (the serving tick claims it) and **readback** (the tick's
one batched device-to-host copy completes, i.e. results exist on host).  A
:class:`LatencyRecorder` attached to ``StreamServer.latency`` folds
every stepped chunk into three histograms:

  ``queue_wait``  enqueue→pop      (queueing delay: how far behind the
                                    server runs under load)
  ``service``     pop→readback     (compute + transfer delay of the
                                    tick that served the chunk)
  ``total``       enqueue→readback (what a producer experiences)

:class:`LatencyHistogram` is the observability registry's
:class:`~repro_torch.obs.metrics.Histogram` pinned to the latency bucket
layout (192 log-spaced buckets over 1 µs … 120 s): O(1) per-sample
recording with no sample list, percentiles interpolated within a
bucket (≤ ~9% relative bucket width), ``nan`` on an empty histogram,
and layout-validated :meth:`~repro_torch.obs.metrics.Histogram.merge` —
the cross-pool aggregation the bench uses.

A recorder can live *inside* a
:class:`~repro_torch.obs.metrics.MetricsRegistry` (pass ``metrics=``): its
three histograms become the registry's
``ingest_latency_seconds{phase=...}`` family, so ``summary()`` and the
registry snapshot/Prometheus export read the very same cells.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from repro_torch.obs.metrics import (
    DEFAULT_HI as _HI,
    DEFAULT_LO as _LO,
    DEFAULT_N_BUCKETS as _N_BUCKETS,
    Histogram,
)


class LatencyHistogram(Histogram):
    """Fixed log-spaced histogram of durations in seconds (the
    latency-telemetry layout of :class:`~repro_torch.obs.metrics.Histogram`;
    see that class for percentile/merge semantics)."""

    def __init__(self):
        super().__init__(lo=_LO, hi=_HI, n_buckets=_N_BUCKETS)


class LatencyRecorder:
    """Per-chunk ingest latency, split into queueing vs service delay.

    Attach to ``StreamServer.latency``; the server calls
    :meth:`observe` once per stepped chunk with the three monotonic
    timestamps.  NACK/drop events are counted by the wire server and
    queues themselves — :meth:`summary` is latency-only.

    With ``metrics=`` the three histograms are created in (or adopted
    from) that :class:`~repro_torch.obs.metrics.MetricsRegistry` as the
    ``ingest_latency_seconds{phase=queue_wait|service|total}`` family —
    one backing store, every view bit-identical.
    """

    METRIC = "ingest_latency_seconds"

    def __init__(self, *, metrics: Optional[Any] = None):
        if metrics is None:
            self.queue_wait = LatencyHistogram()
            self.service = LatencyHistogram()
            self.total = LatencyHistogram()
        else:
            self.queue_wait = metrics.histogram(
                self.METRIC, cls=_registry_hist, phase="queue_wait"
            )
            self.service = metrics.histogram(
                self.METRIC, cls=_registry_hist, phase="service"
            )
            self.total = metrics.histogram(
                self.METRIC, cls=_registry_hist, phase="total"
            )

    @property
    def n(self) -> int:
        return self.total.n

    def observe(
        self, enqueue_ts: float, pop_ts: float, readback_ts: float
    ) -> None:
        self.queue_wait.record(max(0.0, pop_ts - enqueue_ts))
        self.service.record(max(0.0, readback_ts - pop_ts))
        self.total.record(max(0.0, readback_ts - enqueue_ts))

    def merge(self, other: "LatencyRecorder") -> "LatencyRecorder":
        self.queue_wait.merge(other.queue_wait)
        self.service.merge(other.service)
        self.total.merge(other.total)
        return self

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            "queue_wait": self.queue_wait.summary(),
            "service": self.service.summary(),
            "total": self.total.summary(),
        }


def _registry_hist(**_layout) -> LatencyHistogram:
    """Registry factory: ignore the default layout kwargs and build the
    latency-pinned histogram (same layout, canonical class)."""
    return LatencyHistogram()


def merge_recorders(recorders: List[LatencyRecorder]) -> LatencyRecorder:
    out = LatencyRecorder()
    for r in recorders:
        out.merge(r)
    return out
