"""Typed metrics registry: one backing store for every counter view
(port of ``repro.obs.metrics``, a copy: the module is host-side Python
and the port imports nothing of the JAX package).

* :class:`Counter` — an integer adjusted in place (``inc``; a restore
  path may ``set`` it backwards, so it is not enforced monotone);
* :class:`Gauge` — last-write-wins value, or a **computed** gauge
  (``fn=``) that evaluates a callback at read time, so derived
  quantities stay equal to host-side truth;
* :class:`Histogram` — fixed log-spaced buckets, O(1) record,
  interpolated percentiles, mergeable; the percentile of an empty
  histogram is ``nan`` and :meth:`Histogram.merge` refuses a
  bucket-layout mismatch;
* :class:`MetricsRegistry` — get-or-create metric handles keyed on
  ``(name, labels)``, one kind per name, snapshot-able as JSON,
  mergeable, exportable in the Prometheus text exposition format.

Everything here is plain host-side Python: no tensors, no clocks, no
locks.  Naming: ``serve_*`` for the ``StreamServer`` tick loop,
``degrade_*`` for the degradation controller.
"""

from __future__ import annotations

import math
import re
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

# The latency-telemetry bucket layout (the reference's
# ``wire/latency.py`` ``LatencyHistogram`` subclasses Histogram with
# exactly these defaults).
DEFAULT_LO = 1e-6  # 1 µs
DEFAULT_HI = 120.0  # 2 min: anything slower clamps into the last bucket
DEFAULT_N_BUCKETS = 192  # ~9% relative width per bucket

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

LabelKey = Tuple[Tuple[str, Any], ...]


def _label_key(labels: Dict[str, Any]) -> LabelKey:
    for k in labels:
        if not _LABEL_RE.match(k):
            raise ValueError(f"invalid label name {k!r}")
    return tuple(sorted(labels.items()))


class Counter:
    """A single integer counter cell."""

    __slots__ = ("value",)
    kind = "counter"

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def set(self, value: int) -> None:
        """Overwrite (checkpoint restore / view setters only)."""
        self.value = int(value)


class Gauge:
    """Last-write-wins value, or a computed read-time callback."""

    __slots__ = ("_value", "fn")
    kind = "gauge"

    def __init__(self, fn: Optional[Callable[[], Any]] = None) -> None:
        self._value: Any = 0
        self.fn = fn

    @property
    def value(self) -> Any:
        return self._value if self.fn is None else self.fn()

    def set(self, value: Any) -> None:
        if self.fn is not None:
            raise TypeError("cannot set a computed gauge")
        self._value = value


class Histogram:
    """Fixed log-spaced histogram of durations in seconds.

    ``n_buckets`` log-spaced buckets over ``[lo, hi)`` plus an
    underflow and an overflow bucket.  Recording is O(1) with no sample
    list; :meth:`percentile` interpolates within a bucket (relative
    error bounded by the bucket width).  The percentile of an empty
    histogram is ``nan``; :meth:`summary` renders it as ``None`` so
    summaries stay JSON-safe.
    """

    kind = "histogram"

    def __init__(
        self,
        *,
        lo: float = DEFAULT_LO,
        hi: float = DEFAULT_HI,
        n_buckets: int = DEFAULT_N_BUCKETS,
    ):
        if not (0.0 < lo < hi):
            raise ValueError(f"need 0 < lo < hi, got lo={lo} hi={hi}")
        if n_buckets < 1:
            raise ValueError(f"n_buckets must be >= 1, got {n_buckets}")
        self.lo = float(lo)
        self.hi = float(hi)
        self.n_buckets = int(n_buckets)
        self.counts = [0] * (self.n_buckets + 2)  # + underflow + overflow
        self.n = 0
        self.sum_s = 0.0
        self.max_s = 0.0
        self._log_lo = math.log(self.lo)
        self._log_ratio = math.log(self.hi / self.lo)

    @property
    def layout(self) -> Tuple[float, float, int]:
        return (self.lo, self.hi, self.n_buckets)

    def _bucket(self, dt_s: float) -> int:
        if dt_s < self.lo:
            return 0
        if dt_s >= self.hi:
            return self.n_buckets + 1
        frac = (math.log(dt_s) - self._log_lo) / self._log_ratio
        return 1 + min(self.n_buckets - 1, int(frac * self.n_buckets))

    def _edge(self, i: int) -> float:
        """Upper edge of bucket ``i`` (seconds)."""
        if i <= 0:
            return self.lo
        if i >= self.n_buckets + 1:
            return self.hi
        return self.lo * math.exp(self._log_ratio * i / self.n_buckets)

    def record(self, dt_s: float) -> None:
        self.counts[self._bucket(dt_s)] += 1
        self.n += 1
        self.sum_s += dt_s
        if dt_s > self.max_s:
            self.max_s = dt_s

    def merge(self, other: "Histogram") -> "Histogram":
        if self.layout != other.layout:
            raise ValueError(
                f"cannot merge histograms with different bucket layouts: "
                f"{self.layout} vs {other.layout}"
            )
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.n += other.n
        self.sum_s += other.sum_s
        self.max_s = max(self.max_s, other.max_s)
        return self

    def percentile(self, q: float) -> float:
        """The ``q``-quantile (``0 < q <= 1``) in seconds, interpolated
        within its bucket; ``nan`` on an empty histogram."""
        if self.n == 0:
            return float("nan")
        target = q * self.n
        seen = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if seen + c >= target:
                lo = self._edge(i - 1)
                hi = min(self._edge(i), self.max_s)
                frac = (target - seen) / c
                return lo + (max(hi, lo) - lo) * frac
            seen += c
        return self.max_s  # pragma: no cover - rounding fallback

    def summary(self) -> Dict[str, Any]:
        """p50/p95/p99 + max in milliseconds, plus the sample count
        (empty percentiles render as ``None`` — JSON-safe)."""
        out: Dict[str, Any] = {"count": self.n}
        for name, q in (("p50_ms", 0.50), ("p95_ms", 0.95), ("p99_ms", 0.99)):
            p = self.percentile(q)
            out[name] = None if math.isnan(p) else round(p * 1e3, 4)
        out["max_ms"] = round(self.max_s * 1e3, 4)
        return out


Metric = Any  # Counter | Gauge | Histogram


class MetricsRegistry:
    """Get-or-create registry of labelled Counter/Gauge/Histogram cells.

    A metric is addressed by ``(name, labels)``; one *kind* per name
    (asking for ``counter("x")`` after ``gauge("x")`` is a programming
    error and fails fast).  Handles are stable objects — callers hold
    them and mutate in place, so the registry read path never sits on
    the hot path.
    """

    def __init__(self) -> None:
        self._metrics: Dict[Tuple[str, LabelKey], Metric] = {}
        self._kinds: Dict[str, str] = {}

    # -- get-or-create handles ----------------------------------------------

    def _get(
        self, kind: str, name: str, labels: Dict[str, Any],
        make: Callable[[], Metric],
    ) -> Metric:
        key = (name, _label_key(labels))
        m = self._metrics.get(key)
        if m is not None:
            if m.kind != kind:
                raise TypeError(
                    f"metric {name!r} is a {m.kind}, not a {kind}"
                )
            return m
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        have = self._kinds.setdefault(name, kind)
        if have != kind:
            raise TypeError(f"metric {name!r} is a {have}, not a {kind}")
        m = make()
        self._metrics[key] = m
        return m

    def counter(self, name: str, **labels: Any) -> Counter:
        return self._get("counter", name, labels, Counter)

    def gauge(
        self, name: str, *, fn: Optional[Callable[[], Any]] = None,
        **labels: Any,
    ) -> Gauge:
        g = self._get("gauge", name, labels, lambda: Gauge(fn))
        if fn is not None and g.fn is None:
            g.fn = fn  # upgrade a pre-created plain gauge in place
        return g

    def histogram(
        self,
        name: str,
        *,
        lo: float = DEFAULT_LO,
        hi: float = DEFAULT_HI,
        n_buckets: int = DEFAULT_N_BUCKETS,
        cls: type = Histogram,
        **labels: Any,
    ) -> Histogram:
        return self._get(
            "histogram", name, labels,
            lambda: cls(lo=lo, hi=hi, n_buckets=n_buckets),
        )

    # -- enumeration / families ---------------------------------------------

    def __contains__(self, name: str) -> bool:
        return name in self._kinds

    def names(self) -> List[str]:
        return sorted(self._kinds)

    def family(self, name: str) -> Dict[LabelKey, Metric]:
        """Every labelled cell of one metric name."""
        return {
            lk: m for (n, lk), m in self._metrics.items() if n == name
        }

    def clear_family(self, name: str) -> None:
        """Drop every cell of ``name`` (view setters on restore paths
        replace whole families; the name keeps its kind)."""
        for key in [k for k in self._metrics if k[0] == name]:
            del self._metrics[key]

    def value(self, name: str, **labels: Any) -> Any:
        m = self._metrics.get((name, _label_key(labels)))
        if m is None:
            raise KeyError(f"no metric {name!r} with labels {labels!r}")
        return m.value if m.kind != "histogram" else m.summary()

    # -- snapshot / merge / export ------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """JSON-safe dump: ``{name: {"kind": ..., "values": [...]}}``,
        each value entry carrying its labels.  Histograms render their
        summary (count/percentiles/max), not raw buckets."""
        out: Dict[str, Any] = {}
        for name in self.names():
            kind = self._kinds[name]
            values = []
            for lk in sorted(self.family(name), key=repr):
                m = self._metrics[(name, lk)]
                entry: Dict[str, Any] = {"labels": dict(lk)}
                if kind == "histogram":
                    entry.update(m.summary())
                else:
                    entry["value"] = m.value
                values.append(entry)
            out[name] = {"kind": kind, "values": values}
        return out

    def merge(self, other: "MetricsRegistry") -> "MetricsRegistry":
        """Fold another registry in: counters add, histograms merge
        (layouts must match), plain gauges take the other's value;
        computed gauges are identities of *this* registry's callbacks
        and are left alone."""
        for (name, lk), m in other._metrics.items():
            if m.kind == "counter":
                self.counter(name, **dict(lk)).inc(m.value)
            elif m.kind == "histogram":
                self.histogram(
                    name, lo=m.lo, hi=m.hi, n_buckets=m.n_buckets,
                    **dict(lk),
                ).merge(m)
            else:
                if m.fn is not None:
                    continue
                mine = self.gauge(name, **dict(lk))
                if mine.fn is None:
                    mine.set(m.value)
        return self

    def to_prometheus(self) -> str:
        """The Prometheus text exposition format (0.0.4): counters and
        gauges one sample per labelset; histograms as cumulative
        ``_bucket{le=...}`` series plus ``_sum``/``_count``."""
        lines: List[str] = []
        for name in self.names():
            kind = self._kinds[name]
            lines.append(f"# TYPE {name} {kind}")
            for lk in sorted(self.family(name), key=repr):
                m = self._metrics[(name, lk)]
                if kind == "histogram":
                    lines.extend(_prom_histogram(name, lk, m))
                else:
                    lines.append(
                        f"{name}{_prom_labels(lk)} {_prom_num(m.value)}"
                    )
        return "\n".join(lines) + "\n"


def _prom_escape(v: Any) -> str:
    return (
        str(v)
        .replace("\\", r"\\")
        .replace('"', r"\"")
        .replace("\n", r"\n")
    )


def _prom_labels(lk: LabelKey, extra: Iterable[Tuple[str, Any]] = ()) -> str:
    items = list(lk) + list(extra)
    if not items:
        return ""
    body = ",".join(f'{k}="{_prom_escape(v)}"' for k, v in items)
    return "{" + body + "}"


def _prom_num(v: Any) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, float):
        return repr(v)
    return str(v)


def _prom_histogram(name: str, lk: LabelKey, h: Histogram) -> List[str]:
    lines = []
    cum = 0
    for i, c in enumerate(h.counts[:-1]):  # the +Inf bucket is implicit
        cum += c
        le = h._edge(i) if i else h.lo
        lines.append(
            f"{name}_bucket{_prom_labels(lk, [('le', repr(le))])} {cum}"
        )
    lines.append(
        f"{name}_bucket{_prom_labels(lk, [('le', '+Inf')])} {h.n}"
    )
    lines.append(f"{name}_sum{_prom_labels(lk)} {_prom_num(h.sum_s)}")
    lines.append(f"{name}_count{_prom_labels(lk)} {h.n}")
    return lines


# -- attribute views ---------------------------------------------------------


def counter_property(name: str, registry_attr: str = "metrics"):
    """A class attribute that reads/writes a registry counter.

    Existing code (``self.n_ticks += 1``, checkpoint ``setattr``) keeps
    working unmodified: the property's getter/setter route through the
    registry cell, so every dict-shaped view over the registry reports
    the same integer — bit-identical, because it IS the same integer.
    """

    def _get(self):
        return getattr(self, registry_attr).counter(name).value

    def _set(self, value):
        getattr(self, registry_attr).counter(name).set(value)

    return property(_get, _set, doc=f"registry counter {name!r}")


def gauge_property(
    name: str,
    registry_attr: str = "metrics",
    cast: Optional[Callable[[Any], Any]] = None,
):
    """Like :func:`counter_property` but over a (plain) gauge cell —
    for host-state attributes that move both ways (a degrade level, a
    pressure reading)."""

    def _get(self):
        return getattr(self, registry_attr).gauge(name).value

    def _set(self, value):
        getattr(self, registry_attr).gauge(name).set(
            value if cast is None else cast(value)
        )

    return property(_get, _set, doc=f"registry gauge {name!r}")
