"""StreamServer — the live multi-stream serving loop (port of
``repro.serve.server``).

One card ingests a churning population of glasses streams:

* a :class:`~repro_torch.serve.slots.SlottedPool` holds the device state
  — admission and eviction are in-place device copies that build nothing;
* each live stream gets a bounded :class:`~repro_torch.serve.ingest.
  ChunkQueue` (backpressure, counted) and, with a ``k_ladder`` configured,
  its own :class:`~repro_torch.serve.adaptive.KLadderController`;
* every :meth:`tick` pops at most one pending chunk per stream, buckets
  the ready slots **by rung**, and runs one cached full-capacity masked
  step per rung in use: the compressor's session body vmapped over the
  slots, each kernel on it one launch for all of them.  Each stream's
  state and ``k_trajectory`` equal a solo ``EPICCompressor`` fed the same
  chunks (``tests/test_torch_serve.py``);
* :meth:`_dispatch` makes no host sync (chunks are already on the device,
  masks go up ``non_blocking``); the tick's one sync is
  :func:`~repro_torch.serve.telemetry.tick_readback`, a single copy of
  every stepped tier's reductions feeding the controllers and the
  per-stream :class:`~repro_torch.serve.telemetry.StreamTelemetry`;
* :meth:`drain` is the double-buffered loop: the next tick's chunks are
  submitted *between* dispatching the current step and its readback;
* the server's device work runs on one CUDA stream, the caller's current
  stream at construction, whichever thread calls :meth:`submit` or
  :meth:`tick` (the wire frontier submits from its event-loop thread):
  a chunk's upload is ordered before the step that reads it.  A chunk
  that a full queue refuses is refused before it is copied anywhere.

**Tiered serving** (``ServerConfig.tiers``): the device state becomes a
:class:`~repro_torch.serve.tiers.TieredPool`; a tier is stepped only when
it has ready chunks, and the server rebalances every tick (idle streams
demote toward the cold tier, streams whose arrival EMA reaches
``promote_rate`` promote toward the hot tier, by device-side migration or
swap).  Per-stream outputs and ``k_trajectory`` equal the flat pool's
across churn and migration (``tests/test_torch_tiered_serve.py``).

Every tick's rung dispatches are ordered (and, with ``coalesce_rungs``,
pairwise merged when the backlog is low) by a measured-cost
:class:`~repro_torch.serve.adaptive.RungScheduler`.

Eviction policies: ``"explicit"`` (only :meth:`close`), ``"idle"``
(streams idle >= ``idle_frames`` frames are closed at tick end), and
``"lru"`` (a full pool evicts the least-recently-stepped stream to admit a
new one).

**Stream sharding** (``mesh=``, ``launch.mesh.make_stream_mesh``): one
process per device, every rank running the same server on the same
submits (the host state -- queues, slot table, controllers, telemetry --
is replicated), each stepping its own ``capacity / k`` slots with no
collective in the step.  A chunk is copied to the device only by the rank
holding its stream's slot; the tick's readback gathers every rank's slot
rows, so every rank feeds its controllers the same numbers.  ``state``,
``export`` and ``tokens`` broadcast from the owner: every rank calls them.
Tiers and a mesh are mutually exclusive, as in the reference.
"""

from __future__ import annotations

import time
from functools import reduce, wraps
from typing import (
    Any,
    Dict,
    Hashable,
    Iterable,
    List,
    NamedTuple,
    Optional,
    Tuple,
)

import numpy as np
import torch
from torch import Tensor

from repro_torch.api.pool import tree_map
from repro_torch.api.types import SensorChunk
from repro_torch.obs.metrics import MetricsRegistry, counter_property
from repro_torch.obs.trace import NULL_SPAN
from repro_torch.serve.adaptive import KLadderController, RungScheduler
from repro_torch.serve.ingest import (
    _QUEUE_POLICIES,
    ChunkQueue,
    chunk_to_device,
)
from repro_torch.serve.slots import SlottedPool, _combine
from repro_torch.serve.telemetry import StreamTelemetry, tick_readback
from repro_torch.serve.tiers import TieredPool, validate_tiers

_EVICTION_POLICIES = ("explicit", "idle", "lru")

# Promotion-by-swap hysteresis: when the hot tier is full, a warm riser
# only trades places with the coldest hot occupant if its arrival EMA
# leads by this much — keeps two streams flapping around the threshold
# from swapping every tick.
_SWAP_MARGIN = 0.25


class ServerConfig(NamedTuple):
    """Static configuration of a :class:`StreamServer`.

    ``chunk_frames`` is the serving quantum: every submitted chunk must
    carry exactly this many frames, so every pool program compiles for
    one chunk shape.  ``k_ladder=None`` serves fixed-K; a ladder turns
    on per-stream adaptive K with rung-bucketed dispatch.
    ``queue_depth`` bounds pending chunks per stream (backpressure
    beyond it); ``queue_policy`` picks what a full queue does —
    ``"refuse"`` the new chunk (default; producers see NACKs) or
    ``"drop_oldest"`` (freshest-data-wins).  ``idle_frames`` only
    applies to the ``"idle"`` eviction policy.

    Tiered serving: ``tiers`` splits ``capacity`` into size-classed
    sub-pools (hot first; must sum to ``capacity``).  Streams idle for
    ``demote_idle_frames`` frames demote toward the cold tier; streams
    whose per-tick arrival EMA (smoothing ``arrival_alpha``) reaches
    ``promote_rate`` promote toward the hot tier.  ``coalesce_rungs``
    lets the rung scheduler merge adjacent rung dispatches when at most
    ``coalesce_backlog`` chunks are queued.  ``prewarm`` pre-compiles
    the admission/eviction/migration programs at construction so the
    first churn event pays only a device copy.

    ``k_trajectory_limit`` bounds each stream's retained
    ``k_trajectory`` history to the most recent that many entries
    (``None``, the default, keeps the exact full history — what the
    bitwise-parity tests diff).  The adaptive decision rule never reads
    the history, so bounding it cannot change behaviour, only memory.
    """

    capacity: int = 8
    chunk_frames: int = 8
    k_ladder: Optional[Tuple[int, ...]] = None
    shrink_margin: int = 2
    eviction: str = "explicit"
    idle_frames: int = 64
    queue_depth: int = 2
    queue_policy: str = "refuse"
    tiers: Optional[Tuple[int, ...]] = None
    promote_rate: float = 0.5
    arrival_alpha: float = 0.5
    demote_idle_frames: int = 32
    coalesce_rungs: bool = False
    coalesce_backlog: int = 0
    prewarm: bool = False
    k_trajectory_limit: Optional[int] = None


def _on_stream(method):
    """Run a server method with the server's CUDA stream current."""

    @wraps(method)
    def run(self, *args, **kw):
        if self._stream is None:
            return method(self, *args, **kw)
        with torch.cuda.stream(self._stream):
            return method(self, *args, **kw)

    return run


class StreamServer:
    """A live serving runtime over a slotted compressor pool."""

    # Registry-backed counters: `self.n_ticks += 1` and a plain
    # `setattr` keep working, but the integer
    # lives in a `serve_*` MetricsRegistry cell — `server_counters()`,
    # snapshots and Prometheus export all read the same cell.
    n_ticks = counter_property("serve_ticks_total")
    n_admitted = counter_property("serve_admitted_total")
    n_evicted = counter_property("serve_evicted_total")
    n_admit_rejected = counter_property("serve_admit_rejected_total")
    n_backpressure = counter_property("serve_backpressure_total")
    n_dispatches = counter_property("serve_dispatches_total")
    frames_served = counter_property("serve_frames_served_total")
    _n_dropped_closed = counter_property("serve_dropped_closed_total")

    def __init__(
        self,
        compressor,
        config: ServerConfig = ServerConfig(),
        *,
        mesh=None,
        axis: Optional[str] = None,
    ):
        if config.eviction not in _EVICTION_POLICIES:
            raise ValueError(
                f"unknown eviction policy {config.eviction!r}; "
                f"available: {_EVICTION_POLICIES}"
            )
        if config.chunk_frames < 1:
            raise ValueError(
                f"chunk_frames must be >= 1, got {config.chunk_frames}"
            )
        if (
            config.k_trajectory_limit is not None
            and config.k_trajectory_limit < 1
        ):
            raise ValueError(
                f"k_trajectory_limit must be >= 1 or None, got "
                f"{config.k_trajectory_limit}"
            )
        if config.queue_policy not in _QUEUE_POLICIES:
            # Checked here, not at admit time: a per-admit failure
            # would leave a half-admitted slot behind.
            raise ValueError(
                f"unknown queue policy {config.queue_policy!r}; "
                f"available: {_QUEUE_POLICIES}"
            )
        if getattr(compressor, "k_ladder", None) is not None:
            raise ValueError(
                "pass the ladder as ServerConfig.k_ladder, not on the "
                "compressor: the server owns one rung controller per "
                "stream (a ladder-configured compressor carries a "
                "single per-instance rung)"
            )
        if not 0.0 < config.arrival_alpha <= 1.0:
            raise ValueError(
                f"arrival_alpha must be in (0, 1], got "
                f"{config.arrival_alpha}"
            )
        self.cfg = config
        self.compressor = compressor
        self.device = compressor.device
        # Every device operation of the server goes on this stream, from
        # any thread (CUDA's current stream is per thread).
        self._stream = (
            torch.cuda.current_stream(self.device)
            if self.device.type == "cuda" else None
        )
        # The metrics registry: every serve_* counter below is a
        # property over one of its cells.  Must exist before the first
        # counter attribute is touched.
        self.metrics = MetricsRegistry()
        # Optional flight recorder (repro_torch.obs.trace.FlightRecorder):
        # when attached, every tick records its four phase spans and
        # the stack's discrete events.  ``None`` keeps the hot path at
        # two attribute reads per would-be span.
        self.recorder: Optional[Any] = None
        if config.k_ladder is not None:
            if not hasattr(getattr(compressor, "cfg", None), "prefilter_k"):
                raise ValueError(
                    "k_ladder needs a compressor whose cfg carries "
                    "prefilter_k (the EPIC sparse-TRD knob); "
                    f"got {type(compressor).__name__}"
                )
            # Fail fast on ladder / margin / start-rung problems here:
            # every admit() builds a controller with exactly these
            # arguments, and a per-admit failure would leave a
            # half-admitted slot behind.
            self._make_controller(compressor, config)
        self._tiered = config.tiers is not None
        if self._tiered:
            if mesh is not None:
                raise ValueError(
                    "tiers and a stream mesh are mutually exclusive: "
                    "sharding differently-sized tiers over one stream "
                    "axis would need per-tier meshes (use the flat "
                    "pool on a mesh, or tiers on one host)"
                )
            tiers = validate_tiers(config.tiers, config.capacity)
            self.pool: Any = TieredPool(compressor, tiers)
        else:
            self.pool = SlottedPool(compressor, config.capacity, mesh=mesh,
                                    axis=axis)
        self.mesh = mesh
        if config.prewarm:
            self.pool.prewarm()
        self._sched = RungScheduler(
            coalesce=config.coalesce_rungs,
            coalesce_backlog=config.coalesce_backlog,
        )
        # Per-rung fixed-K compressors (adaptive mode), built lazily:
        # one per ladder rung, shared by every stream on that rung.
        self._rung_comps: Dict[int, Any] = {}
        self._queues: Dict[Hashable, ChunkQueue] = {}
        self._controllers: Dict[Hashable, KLadderController] = {}
        self._telemetry: Dict[Hashable, StreamTelemetry] = {}
        self.evicted: List[StreamTelemetry] = []
        self._zero_chunk: Optional[SensorChunk] = None
        # Optional wire-layer telemetry: when set (an object with the
        # reference's ``LatencyRecorder.observe``), every stepped chunk
        # reports (enqueue_ts, pop_ts, readback_ts) after the tick's
        # batched readback.  ``None`` keeps the hot path free of clock
        # reads beyond the queue's own enqueue stamp.
        self.latency: Optional[Any] = None
        # Optional graceful degradation: attach a
        # ``repro_torch.serve.degrade.DegradeController`` and every tick
        # feeds it the backlog/arrival/service pressure signals and
        # applies its level policy (rung caps, drop-oldest + staleness
        # shedding, cold-tier deferral) before popping work.  ``None``
        # serves exactly as before.
        self.degrade: Optional[Any] = None
        self._pop_ts: Dict[Hashable, Tuple[float, float]] = {}
        self._tick_t0 = 0.0
        self._last_tick_wall: Optional[float] = None
        self.max_queue_wait_ticks = 0
        self._n_dropped_closed = 0
        self.n_ticks = 0
        self.n_admitted = 0
        self.n_evicted = 0
        self.n_admit_rejected = 0
        self.n_backpressure = 0
        self.n_dispatches = 0
        self.frames_served = 0
        # Derived quantities export as *computed* gauges: reading one
        # evaluates the same expression `server_counters()` uses, so
        # the registry can never drift from host-side truth.
        m = self.metrics
        m.gauge("serve_live_streams", fn=lambda: len(self._queues))
        m.gauge(
            "serve_dropped_total",
            fn=lambda: self._n_dropped_closed
            + sum(q.n_dropped for q in self._queues.values()),
        )
        m.gauge("serve_coalesced_total", fn=lambda: self._sched.n_coalesced)
        m.gauge(
            "serve_shed_stale_total",
            fn=lambda: 0 if self.degrade is None else self.degrade.n_shed,
        )
        m.gauge(
            "serve_degrade_level",
            fn=lambda: 0 if self.degrade is None else self.degrade.level,
        )
        m.gauge(
            "serve_migrations_total",
            fn=lambda: (
                self.pool.n_migrations + self.pool.n_swaps
                if self._tiered else 0
            ),
        )

    # -- tier plumbing -------------------------------------------------------

    def _locate(self, session_id: Hashable) -> Tuple[int, int]:
        """``(tier, local_slot)``; a flat pool is tier 0."""
        if self._tiered:
            return self.pool.locate(session_id)
        return 0, self.pool.slot_of(session_id)

    def _tier_pool(self, tier: int) -> SlottedPool:
        return self.pool.tiers[tier] if self._tiered else self.pool

    def _tier_capacity(self, tier: int) -> int:
        if self._tiered:
            return self.pool.capacities[tier]
        return self.cfg.capacity

    # -- admission / eviction ------------------------------------------------

    @_on_stream
    def admit(self, session_id: Hashable) -> int:
        """Admit a stream into a free slot (fresh session state).

        Tiered pools admit into the *coldest* tier with room — new
        streams earn the hot tier through observed arrivals.  With the
        ``"lru"`` policy a full pool evicts its least-recently stepped
        stream to make room; other policies raise ``RuntimeError``
        when full.  Returns the (global) slot.
        """
        if session_id in self._queues:
            # Must precede the LRU branch: a duplicate admit on a full
            # pool must not evict an innocent stream (or silently reset
            # the duplicate itself).
            raise ValueError(f"session {session_id!r} already admitted")
        if not self.pool.free_slots():
            if self.cfg.eviction == "lru":
                self.close(self._lru_session())
            else:
                self.n_admit_rejected += 1
                raise RuntimeError(
                    f"pool full ({self.cfg.capacity} slots); close a "
                    f"stream or use the 'lru' eviction policy"
                )
        slot = self.pool.admit(session_id)
        self._queues[session_id] = ChunkQueue(
            self.cfg.queue_depth, policy=self.cfg.queue_policy
        )
        if self.cfg.k_ladder is not None:
            self._controllers[session_id] = self._make_controller(
                self.compressor, self.cfg
            )
        tier = self.pool.unpack_slot(slot)[0] if self._tiered else 0
        self._telemetry[session_id] = StreamTelemetry(
            session_id=session_id,
            slot=slot,
            generation=self.pool.generation_of(slot),
            admitted_tick=self.n_ticks,
            tier=tier,
        )
        self.n_admitted += 1
        self._event("admit", stream=session_id, slot=slot, tier=tier)
        return slot

    @staticmethod
    def _make_controller(compressor, config: ServerConfig):
        return KLadderController(
            config.k_ladder,
            start_k=compressor.cfg.prefilter_k,
            shrink_margin=config.shrink_margin,
            what="cfg.prefilter_k",
            history_limit=config.k_trajectory_limit,
        )

    def try_admit(self, session_id: Hashable) -> Optional[int]:
        """``admit`` that reports a full pool as ``None`` (counted)."""
        try:
            return self.admit(session_id)
        except RuntimeError:
            return None

    @_on_stream
    def close(self, session_id: Hashable) -> StreamTelemetry:
        """Explicitly evict a stream; returns its final telemetry."""
        self.pool.evict_session(session_id)
        self._n_dropped_closed += self._queues[session_id].n_dropped
        self._queues.pop(session_id)
        self._controllers.pop(session_id, None)
        tele = self._telemetry.pop(session_id)
        self.evicted.append(tele)
        self.n_evicted += 1
        self._event("evict", stream=session_id, tier=tele.tier)
        return tele

    def _lru_session(self) -> Hashable:
        return min(
            self._telemetry.values(),
            key=lambda t: (t.last_step_tick, t.slot),
        ).session_id

    # -- ingest --------------------------------------------------------------

    @_on_stream
    def submit(self, session_id: Hashable, chunk: SensorChunk) -> bool:
        """Queue one chunk for a live stream.

        The chunk is copied to the device now (``non_blocking`` from
        pinned memory, no host sync), so a tick's dispatch only stacks
        device tensors and the queue never holds a view of the caller's
        buffer.  Returns ``False`` (and counts backpressure) when the
        stream's bounded queue is full — the producer should retry after a
        tick; a refused chunk is not copied.
        """
        if chunk.n_frames != self.cfg.chunk_frames:
            raise ValueError(
                f"serving quantum is {self.cfg.chunk_frames} frames per "
                f"chunk, got {chunk.n_frames} (pad or re-chunk upstream)"
            )
        q = self._queues.get(session_id)
        if q is None:
            raise KeyError(f"session {session_id!r} is not admitted")
        if q.refuse_if_full():
            self._telemetry[session_id].n_queue_overflow += 1
            self.n_backpressure += 1
            return False
        if self._zero_chunk is None:
            self._zero_chunk = SensorChunk(*(
                None if x is None else torch.zeros(
                    tuple(np.shape(x)), dtype=torch.float32,
                    device=self.device) for x in chunk
            ))
        # On a mesh only the rank holding the stream's slot needs its
        # rows; the others queue a placeholder, keeping the same queue.
        if self._tiered or self.pool.owns(self.pool.slot_of(session_id)):
            chunk = chunk_to_device(chunk, self.device)
        else:
            chunk = None
        return q.push(chunk, tick=self.n_ticks)

    # -- tracing hooks -------------------------------------------------------

    def _span(self, name: str):
        """A phase span on the attached recorder, or the shared no-op
        (no allocation, no clock read) when tracing is off."""
        rec = self.recorder
        return NULL_SPAN if rec is None else rec.span(name)

    def _event(self, name: str, **args: Any) -> None:
        rec = self.recorder
        if rec is not None:
            rec.event(name, **args)

    def _tick_begin(self) -> None:
        rec = self.recorder
        if rec is not None:
            rec.begin_tick(self.n_ticks)

    # -- the serving tick ----------------------------------------------------

    def _rung_comp(self, k: int):
        comp = self._rung_comps.get(k)
        if comp is None:
            comp = type(self.compressor)(
                self.compressor.cfg._replace(prefilter_k=k),
                self.compressor.models,
                device=self.device,
            )
            self._rung_comps[k] = comp
        return comp

    def _rung_body(self, k: Optional[int]):
        """The session-body factory of rung ``k`` (called only when its
        step program is first built)."""
        comp = self.compressor if k is None else self._rung_comp(k)
        return comp.session_body

    def _pop_ready(
        self, deferred: Tuple[int, ...] = ()
    ) -> Dict[Hashable, SensorChunk]:
        ready = {}
        self._pop_ts = {}
        now = time.monotonic()
        for sid in list(self._queues):
            if deferred and self._locate(sid)[0] in deferred:
                continue
            entry = self._queues[sid].pop_full()
            if entry is not None:
                ready[sid] = entry[0]
                self._pop_ts[sid] = (entry[1], now)
                if entry[2] is not None:
                    self.max_queue_wait_ticks = max(
                        self.max_queue_wait_ticks, self.n_ticks - entry[2]
                    )
        return ready

    def _degrade_step(self) -> Tuple[int, ...]:
        """Feed the attached degradation controller one tick's pressure
        signals and apply its level policy; returns the tier indices
        whose dispatch the current level defers (empty when level 0 or
        no controller).  Every action only reduces or masks work —
        capped rungs are existing ladder rungs, shedding removes queued
        chunks, deferral skips pops — so no new program shapes appear
        across level transitions.
        """
        dg = self.degrade
        if dg is None:
            return ()
        backlog = sum(len(q) for q in self._queues.values())
        capacity = max(1, len(self._queues) * self.cfg.queue_depth)
        emas = [t.arrival_ema for t in self._telemetry.values()]
        level_before = dg.level
        dg.observe(
            backlog / capacity,
            arrival_ema=sum(emas) / len(emas) if emas else 0.0,
            service_s=self._last_tick_wall,
        )
        if dg.level != level_before:
            self._event(
                "degrade_level",
                level_from=level_before, level_to=dg.level,
                pressure=round(dg.pressure, 4),
            )
        pol = dg.policy
        qpol = pol.queue_policy or self.cfg.queue_policy
        for q in self._queues.values():
            q.policy = qpol
            if pol.stale_after_ticks is not None:
                dg.n_shed += q.shed_stale(
                    self.n_ticks - pol.stale_after_ticks
                )
        if self.cfg.k_ladder is not None and self._controllers:
            cap = max(0, len(self.cfg.k_ladder) - 1 - pol.rung_cap_down)
            for ctl in self._controllers.values():
                ctl.set_rung_cap(cap)
        if self._tiered and pol.defer_tiers > 0:
            ntiers = len(self.pool.tiers)
            # Never defer the hot tier: someone must keep serving.
            return tuple(range(max(1, ntiers - pol.defer_tiers), ntiers))
        return ()

    def _slot_masks(self, tier: int, groups) -> Tensor:
        """``(len(groups), capacity)`` bool rows, row i set at the slots of
        ``groups[i]``: made on the host and copied ``non_blocking`` from
        pinned memory, so the dispatch makes no host sync."""
        tp = self._tier_pool(tier)
        rows = torch.zeros((len(groups), tp.capacity), dtype=torch.bool)
        for i, sids in enumerate(groups):
            rows[i, [tp.slot_of(s) for s in sids]] = True
        if self.device.type == "cuda":
            rows = rows.pin_memory()
        return rows.to(self.device, non_blocking=True)

    def _dispatch(self, ready: Dict[Hashable, SensorChunk]):
        """Assemble per-tier tick batches and dispatch the scheduler's
        plans — only tiers with ready chunks are stepped.  Returns the
        (still in-flight) per-tier combined stats, the ``(tier, rung)``
        session groups, and the dispatched variant keys."""
        self._tick_t0 = time.monotonic()
        with self._span("schedule"):
            groups: Dict[Tuple[int, Optional[int]], List[Hashable]] = {}
            for sid in ready:
                tier = self._locate(sid)[0]
                k = (
                    None if self.cfg.k_ladder is None
                    else self._controllers[sid].begin_chunk()
                )
                groups.setdefault((tier, k), []).append(sid)
            plans = self._sched.plan(
                groups,
                backlog=sum(len(q) for q in self._queues.values()),
            )

        with self._span("dispatch"):
            batches: Dict[int, SensorChunk] = {}
            for tier in {t for t, _ in groups}:
                rows = [self._zero_chunk] * self._tier_capacity(tier)
                tp = self._tier_pool(tier)
                for sid, chunk in ready.items():
                    if self._locate(sid)[0] == tier and chunk is not None:
                        rows[tp.slot_of(sid)] = chunk
                batches[tier] = SensorChunk(*(
                    None if xs[0] is None else torch.stack(xs)
                    for xs in zip(*rows)
                ))

            stats_parts: Dict[int, List[Any]] = {}
            keys: List[Hashable] = []
            for plan in plans:
                tp = self._tier_pool(plan.tier)
                batch = batches[plan.tier]
                masks = self._slot_masks(plan.tier, plan.sids)
                if len(plan.rungs) == 1:
                    k = plan.rungs[0]
                    stats = tp.step(
                        batch,
                        mask=masks[0],
                        make_body=self._rung_body(k),
                        key=k,
                    )
                else:
                    stats = tp.step_multi(
                        batch,
                        masks,
                        [self._rung_body(k) for k in plan.rungs],
                        key=plan.key,
                    )
                keys.append(plan.key)
                self.n_dispatches += 1
                stats_parts.setdefault(plan.tier, []).append(stats)
        # Rung masks are disjoint and masked-out slots are zeroed, so
        # the union of a tier's per-rung stats is an elementwise
        # combine.
        stats_by_tier = {
            tier: reduce(
                lambda a, b: tree_map(_combine, a, b), parts
            )
            for tier, parts in stats_parts.items()
        }
        return stats_by_tier, groups, keys

    def _finish(self, stats_by_tier, groups, keys=()) -> None:
        """One batched readback across every stepped tier; feed
        controllers + telemetry + the scheduler's cost model; apply the
        idle eviction policy and (tiered) rebalance."""
        stepped = [sid for sids in groups.values() for sid in sids]
        if stepped:
            tiers_stepped = sorted(stats_by_tier)
            with self._span("readback"):
                rb = tick_readback(
                    [stats_by_tier[t] for t in tiers_stepped],
                    gather=None if self._tiered else self.pool.gather_slots,
                )
            self._last_tick_wall = time.monotonic() - self._tick_t0
            self._sched.observe_tick(keys, self._last_tick_wall)
            base, off = {}, 0
            for t in tiers_stepped:
                base[t] = off
                off += self._tier_capacity(t)
            if self.latency is not None:
                done = time.monotonic()
                for sid in stepped:
                    ts = self._pop_ts.get(sid)
                    if ts is not None:
                        self.latency.observe(ts[0], ts[1], done)
            for sid in stepped:
                tele = self._telemetry[sid]
                tier, local = self._locate(sid)
                row = base[tier] + local
                tele.n_chunks += 1
                tele.n_frames += self.cfg.chunk_frames
                tele.n_processed += int(rb.processed[row])
                tele.n_inserted += int(rb.inserted[row])
                tele.buffer_valid = int(rb.buffer_valid[row])
                tele.idle_frames = 0
                tele.last_step_tick = self.n_ticks
                ctl = self._controllers.get(sid)
                if ctl is not None:
                    k_before = ctl.k
                    ctl.update(
                        int(rb.overflow[row]), int(rb.peak_full[row])
                    )
                    if ctl.k != k_before:
                        self._event(
                            "rung_change",
                            stream=sid, k_from=k_before, k_to=ctl.k,
                        )
                    tele.k_trajectory = ctl.k_trajectory
            self.frames_served += len(stepped) * self.cfg.chunk_frames
        stepped_set = set(stepped)
        a = self.cfg.arrival_alpha
        for sid in list(self._telemetry):
            tele = self._telemetry[sid]
            if sid not in stepped_set:
                tele.idle_frames += self.cfg.chunk_frames
            tele.arrival_ema = (1.0 - a) * tele.arrival_ema + a * float(
                sid in stepped_set
            )
        self.n_ticks += 1
        if self.cfg.eviction == "idle":
            for sid in list(self._telemetry):
                if self._telemetry[sid].idle_frames >= self.cfg.idle_frames:
                    self.close(sid)
        if self._tiered:
            self._rebalance()
        if self.recorder is not None:
            self.recorder.end_tick()

    # -- tier rebalancing ----------------------------------------------------

    def _migrate(self, session_id: Hashable, to_tier: int) -> None:
        tele = self._telemetry[session_id]
        from_tier = tele.tier
        slot = self.pool.migrate(session_id, to_tier)
        tele.slot = slot
        tele.tier = to_tier
        tele.generation = self.pool.generation_of(slot)
        tele.n_migrations += 1
        self._event(
            "demote" if to_tier > from_tier else "promote",
            stream=session_id, from_tier=from_tier, to_tier=to_tier,
        )

    def _swap(self, session_a: Hashable, session_b: Hashable) -> None:
        self.pool.swap(session_a, session_b)
        self._event("swap", stream=session_a, with_stream=session_b)
        for sid in (session_a, session_b):
            slot = self.pool.slot_of(sid)
            tele = self._telemetry[sid]
            tele.slot = slot
            tele.tier = self.pool.unpack_slot(slot)[0]
            tele.generation = self.pool.generation_of(slot)
            tele.n_migrations += 1

    def _rebalance(self) -> None:
        """Concentrate active streams into the hot tier.

        Demote: a non-cold stream idle ≥ ``demote_idle_frames`` frames
        moves to the coldest tier with a free slot.  Promote: non-hot
        streams with arrival EMA ≥ ``promote_rate`` (hottest first,
        slot-order tie-break) move into the hottest tier with room, or
        swap with the coldest hot occupant when its EMA trails by
        ≥ ``_SWAP_MARGIN``.  All moves are device-side copies and build no
        step program.
        """
        pool = self.pool
        coldest = len(pool.tiers) - 1
        for tele in list(self._telemetry.values()):
            if (
                tele.tier < coldest
                and tele.idle_frames >= self.cfg.demote_idle_frames
            ):
                for tj in range(coldest, tele.tier, -1):
                    if pool.tiers[tj].free_slots():
                        self._migrate(tele.session_id, tj)
                        break
        risers = sorted(
            (
                t for t in self._telemetry.values()
                if t.tier > 0 and t.arrival_ema >= self.cfg.promote_rate
            ),
            key=lambda t: (-t.arrival_ema, t.slot),
        )
        for tele in risers:
            target = next(
                (
                    tj for tj in range(tele.tier)
                    if pool.tiers[tj].free_slots()
                ),
                None,
            )
            if target is not None:
                self._migrate(tele.session_id, target)
                continue
            victims = [
                self._telemetry[s] for s in pool.tiers[0]._slot_of
            ]
            victim = min(victims, key=lambda v: (v.arrival_ema, v.slot))
            if victim.arrival_ema + _SWAP_MARGIN <= tele.arrival_ema:
                self._swap(tele.session_id, victim.session_id)

    # -- tick / drain --------------------------------------------------------

    @_on_stream
    def tick(self) -> List[Hashable]:
        """Serve one tick: step every stream with a pending chunk.

        Returns the session ids stepped this tick.  A tick with no
        pending work still advances the clock and the idle accounting.
        """
        self._tick_begin()
        with self._span("ingest"):
            ready = self._pop_ready(self._degrade_step())
        if not ready:
            self._finish({}, {})
            return []
        stats, groups, keys = self._dispatch(ready)
        self._finish(stats, groups, keys)
        return [sid for sids in groups.values() for sid in sids]

    @_on_stream
    def drain(
        self,
        feeds: Dict[Hashable, Iterable[SensorChunk]],
        *,
        max_ticks: Optional[int] = None,
    ) -> int:
        """Double-buffered serving loop over per-stream chunk sources.

        Every iteration dispatches the current tick's pool steps, then
        — while that compute is in flight — pulls and submits the next
        chunk of every feed (the host→device transfer of tick ``i+1``
        overlaps the step of tick ``i``; CUDA launches are asynchronous),
        and
        only then performs the tick's single readback.  Bit-identical
        to submit-then-tick in a strict sequence.  Returns the number
        of ticks run.  The copies are those of :meth:`submit`; wrap a
        feed in :class:`~repro_torch.serve.ingest.Prefetch` to start them
        further ahead, on a side stream.
        """
        iters = {sid: iter(src) for sid, src in feeds.items()}
        for sid in iters:
            if sid not in self._queues:
                self.admit(sid)
        ticks = 0
        self._refill(iters)
        while iters or any(len(q) for q in self._queues.values()):
            self._tick_begin()
            with self._span("ingest"):
                ready = self._pop_ready(self._degrade_step())
            inflight = self._dispatch(ready) if ready else None
            self._refill(iters)  # overlaps the dispatched compute
            if inflight is not None:
                self._finish(*inflight)
            else:
                self._finish({}, {})
            ticks += 1
            if max_ticks is not None and ticks >= max_ticks:
                break
        return ticks

    def _refill(self, iters: Dict[Hashable, Any]) -> None:
        for sid in list(iters):
            if sid not in self._queues:  # evicted mid-run: drop its feed
                del iters[sid]
                continue
            if len(self._queues[sid]) >= self.cfg.queue_depth:
                continue
            try:
                chunk = next(iters[sid])
            except StopIteration:
                del iters[sid]
                continue
            self.submit(sid, chunk)

    # -- introspection -------------------------------------------------------

    @property
    def live_sessions(self) -> List[Hashable]:
        return list(self._queues)

    def telemetry(self, session_id: Hashable) -> StreamTelemetry:
        return self._telemetry[session_id]

    def server_counters(self) -> Dict[str, int]:
        return {
            "n_ticks": self.n_ticks,
            "n_live": len(self._queues),
            "n_admitted": self.n_admitted,
            "n_evicted": self.n_evicted,
            "n_admit_rejected": self.n_admit_rejected,
            "n_backpressure": self.n_backpressure,
            "n_dropped": self._n_dropped_closed
            + sum(q.n_dropped for q in self._queues.values()),
            "n_dispatches": self.n_dispatches,
            "n_coalesced": self._sched.n_coalesced,
            "n_shed_stale": (
                0 if self.degrade is None else self.degrade.n_shed
            ),
            "degrade_level": (
                0 if self.degrade is None else self.degrade.level
            ),
            "n_migrations": (
                self.pool.n_migrations + self.pool.n_swaps
                if self._tiered else 0
            ),
            "frames_served": self.frames_served,
        }

    def step_cache_sizes(self) -> Dict[Hashable, int]:
        """Built step programs across every pool step variant — the
        no-rebuild-after-warm-up telemetry (tiered pools key by ``(tier,
        variant)``)."""
        return self.pool.step_cache_sizes()

    def block_until_ready(self) -> None:
        self.pool.block_until_ready()

    @_on_stream
    def state(self, session_id: Hashable):
        return self.pool.session_state(session_id)

    @_on_stream
    def export(self, session_id: Hashable):
        return self.pool.export(session_id)

    @_on_stream
    def tokens(self, session_id: Hashable, seq_len: int):
        return self.pool.tokens(session_id, seq_len)
