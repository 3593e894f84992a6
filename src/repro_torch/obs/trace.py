"""Per-tick span tracing into a bounded flight recorder (port of
``repro.obs.trace``, a copy: host-side Python).

The serving tick has four phases — **ingest** (degrade policy + queue
pops), **schedule** (the rung scheduler's plan), **dispatch** (the
masked pool steps) and **readback** (the tick's single batched
device-to-host copy) — plus discrete events: admit/evict,
promote/demote/swap migrations, rung changes, degrade level
transitions.

:class:`FlightRecorder` records all of it host-side into a bounded ring
buffer of ticks and dumps the retained window as Chrome ``trace_event``
JSON (``ui.perfetto.dev``).  Recording appends to lists under a lock: no
device syncs, so attaching a recorder keeps the one-sync-per-tick
contract.  A span's clock reads the host's time, so a phase span covers
the host's work; the device runs on asynchronously.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

#: Span names of the serving tick's phases, in order.
TICK_PHASES = ("ingest", "schedule", "dispatch", "readback")

#: Discrete event taxonomy (events outside this set are allowed — the
#: tuple documents the vocabulary the serving stack itself emits).
EVENT_NAMES = (
    "admit", "evict", "promote", "demote", "swap", "rung_change",
    "degrade_level", "checkpoint", "resume", "nack",
)


class _Span:
    """Context manager recording one closed interval into a tick."""

    __slots__ = ("_rec", "name", "t0")

    def __init__(self, rec: "FlightRecorder", name: str):
        self._rec = rec
        self.name = name
        self.t0 = 0.0

    def __enter__(self) -> "_Span":
        self.t0 = self._rec._clock()
        return self

    def __exit__(self, *exc) -> None:
        self._rec._add_span(self.name, self.t0, self._rec._clock())


class _NullSpan:
    """The recorder-detached no-op (shared instance, zero state)."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


NULL_SPAN = _NullSpan()


class FlightRecorder:
    """Bounded ring buffer of traced serving ticks.

    Args:
      capacity: ticks retained (older ticks fall off the ring).
      clock: monotonic seconds source (injectable for deterministic
        tests).
    """

    def __init__(
        self,
        capacity: int = 64,
        *,
        clock: Callable[[], float] = time.monotonic,
    ):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._clock = clock
        self._lock = threading.Lock()
        self._ticks: deque = deque(maxlen=capacity)
        self._cur: Optional[Dict[str, Any]] = None
        # Events emitted outside any open tick (checkpoint/restore on a
        # quiesced server, NACKs before the first tick): bounded too.
        self._orphans: deque = deque(maxlen=256)
        self.n_ticks_recorded = 0
        self.n_spans = 0
        self.n_events = 0

    # -- recording -----------------------------------------------------------

    def begin_tick(self, tick: int) -> None:
        """Open tick ``tick``; auto-closes a still-open predecessor."""
        with self._lock:
            self._close_cur_locked()
            self._cur = {
                "tick": int(tick),
                "t0": self._clock(),
                "spans": [],
                "events": [],
            }

    def end_tick(self) -> None:
        with self._lock:
            self._close_cur_locked()

    def _close_cur_locked(self) -> None:
        cur = self._cur
        if cur is None:
            return
        cur["t1"] = self._clock()
        self._ticks.append(cur)
        self.n_ticks_recorded += 1
        self._cur = None

    def span(self, name: str) -> _Span:
        """``with recorder.span("dispatch"): ...`` — one phase span."""
        return _Span(self, name)

    def _add_span(self, name: str, t0: float, t1: float) -> None:
        with self._lock:
            if self._cur is not None:
                self._cur["spans"].append((name, t0, t1))
                self.n_spans += 1

    def event(self, name: str, **args: Any) -> None:
        """Record one instant event (into the open tick, else the
        orphan buffer).  ``args`` values should be JSON-safe; session
        ids and labels are stringified on dump, not here."""
        t = self._clock()
        with self._lock:
            entry = (name, t, args)
            if self._cur is not None:
                self._cur["events"].append(entry)
            else:
                self._orphans.append(entry)
            self.n_events += 1

    # -- export --------------------------------------------------------------

    def ticks(self) -> List[Dict[str, Any]]:
        """The retained window, oldest first (closed ticks only)."""
        with self._lock:
            return list(self._ticks)

    def to_chrome_trace(self) -> Dict[str, Any]:
        """The retained window as Chrome ``trace_event`` JSON.

        Tick and phase spans become ``ph: "X"`` complete events
        (timestamps/durations in microseconds, as the format requires);
        discrete events become ``ph: "i"`` instants.  Open the dump at
        ``ui.perfetto.dev`` (``chrome://tracing``).
        """
        with self._lock:
            ticks = list(self._ticks)
            if self._cur is not None:
                cur = dict(self._cur)
                cur["t1"] = self._clock()
                ticks.append(cur)
            orphans = list(self._orphans)
        events: List[Dict[str, Any]] = [{
            "name": "process_name",
            "ph": "M",
            "pid": 0,
            "tid": 0,
            "args": {"name": "repro_torch.serve tick loop"},
        }]
        for t in ticks:
            events.append({
                "name": f"tick {t['tick']}",
                "cat": "tick",
                "ph": "X",
                "ts": t["t0"] * 1e6,
                "dur": max(0.0, (t["t1"] - t["t0"]) * 1e6),
                "pid": 0,
                "tid": 0,
                "args": {"tick": t["tick"]},
            })
            for name, s0, s1 in t["spans"]:
                events.append({
                    "name": name,
                    "cat": "phase",
                    "ph": "X",
                    "ts": s0 * 1e6,
                    "dur": max(0.0, (s1 - s0) * 1e6),
                    "pid": 0,
                    "tid": 1,
                    "args": {"tick": t["tick"]},
                })
            for name, ts, args in t["events"]:
                events.append(_instant(name, ts, args, tick=t["tick"]))
        for name, ts, args in orphans:
            events.append(_instant(name, ts, args))
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "source": "repro_torch.obs.trace.FlightRecorder",
                "ticks_retained": len(ticks),
                "ticks_recorded": self.n_ticks_recorded,
            },
        }

    def dump(self, path: str) -> str:
        """Write the Chrome-trace JSON to ``path``; returns the path."""
        doc = self.to_chrome_trace()
        with open(path, "w") as f:
            json.dump(doc, f)
        return path


def _jsonify(v: Any) -> Any:
    return v if isinstance(v, (int, float, bool, type(None))) else str(v)


def _instant(
    name: str, ts: float, args: Dict[str, Any], *, tick: Optional[int] = None
) -> Dict[str, Any]:
    a = {k: _jsonify(v) for k, v in args.items()}
    if tick is not None:
        a["tick"] = tick
    return {
        "name": name,
        "cat": "event",
        "ph": "i",
        "s": "t",
        "ts": ts * 1e6,
        "pid": 0,
        "tid": 2,
        "args": a,
    }
