"""Live-slot checkpoint/restore for a running :class:`StreamServer` (port of
``repro.serve.checkpoint``: the same manifest keys, shapes, dtype names
and ``"serve"`` metadata for the same config and sessions).

A serving process dies with queued chunks, mid-ladder rung state, and
hours of per-stream telemetry on board.  This module snapshots all of
it — device slot states, generation counters, per-stream controllers,
pending queue contents, scheduler cost model, wire cursors — through
the :mod:`repro_torch.checkpoint.store` atomic manifest format, and restores
into a *fresh* process such that serving resumes bit-identically:

* **what is saved**: one pytree ``{"tiers": [SlotStates, ...],
  "queues": {...}}`` (sharded npz, manifest written last) plus a JSON
  ``"serve"`` metadata block in the manifest — schema version, the full
  :class:`~repro_torch.serve.server.ServerConfig`, a compressor-config fence,
  and per-session host bookkeeping;
* **restore** builds a fresh server from the recorded config, loads the
  device tree with :func:`repro_torch.checkpoint.store.restore` (damaged
  newest steps fall back to the previous complete one), and re-binds
  every session **directly** — host tables, generation counters, and
  device state are written verbatim into the fresh pool's preallocated
  tensors by in-place copies, *never* routed through the admit path, so
  a restored slot is generation-fenced exactly as it was
  (`slot_state(expect_generation=...)` handles from before the crash
  stay valid) and restore builds no step program;
* **no step program built twice**: the restored server serves the same
  shape/rung variants the dead one did, so each pool step variant is
  built exactly once in the new process (``step_cache_sizes()`` all
  ``== 1`` after replay — pinned in ``tests/test_torch_checkpoint.py``);
* **determinism**: sessions are recorded and re-bound in the server's
  queue iteration order, so the restored tick visits streams in the
  same order and per-stream outputs + ``k_trajectory`` stay bitwise
  identical to an uninterrupted run (the crash-soak contract).

:class:`ServeCheckpointer` is the cadence wrapper: checkpoint every N
ticks through an :class:`~repro_torch.checkpoint.store.AsyncSaver` (the tick
path never blocks on disk), garbage-collect old steps, and refuse to
restore over an in-flight save.

The wire layer rides along: pass the :class:`~repro_torch.wire.server.
IngestServer` and its per-stream seq cursors + counters are saved under
``meta["wire"]``; ``restore_server(..., with_ingest=True)`` rebuilds
the ingest frontier so reconnecting clients RESUME against the restored
cursors (seqs the checkpoint already holds are duplicate-suppressed,
seqs after it are replayed from the client windows).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Dict, Hashable, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.api.pool import tree_map
from repro_torch.api.types import SensorChunk
from repro_torch.checkpoint import store
from repro_torch.serve.ingest import ChunkQueue
from repro_torch.serve.server import ServerConfig, StreamServer
from repro_torch.serve.telemetry import StreamTelemetry

# Bumped when the "serve" metadata block changes incompatibly; restore
# refuses a mismatched schema rather than mis-binding sessions.
SERVE_SCHEMA = 1

_COUNTER_ATTRS = (
    "n_ticks",
    "n_admitted",
    "n_evicted",
    "n_admit_rejected",
    "n_backpressure",
    "n_dispatches",
    "frames_served",
    "_n_dropped_closed",
)

_WIRE_COUNTER_ATTRS = (
    "n_messages",
    "n_frames_in",
    "n_opened",
    "n_closed",
    "n_resumed",
    "n_dup_suppressed",
)


class RestoredServer(NamedTuple):
    server: StreamServer
    ingest: Optional[Any]  # IngestServer when with_ingest=True
    step: int


# -- JSON-safe encodings -----------------------------------------------------
#
# Session ids are ints or strs on the wire and in the serving layer;
# tag them so a JSON round-trip cannot blur the distinction (or smuggle
# a bool through the int branch).  Scheduler cost keys are
# None/int/str/tuples thereof (DispatchPlan keys), encoded recursively.


def _encode_sid(sid: Hashable) -> List[Any]:
    if isinstance(sid, bool) or not isinstance(sid, (int, str)):
        raise TypeError(
            f"checkpointable session ids are int or str, got "
            f"{type(sid).__name__} ({sid!r})"
        )
    return ["i", sid] if isinstance(sid, int) else ["s", sid]


def _decode_sid(enc: List[Any]) -> Hashable:
    tag, v = enc
    return int(v) if tag == "i" else str(v)


def _encode_key(key: Hashable) -> Any:
    if key is None:
        return ["none"]
    if isinstance(key, bool):
        raise TypeError(f"unencodable scheduler key {key!r}")
    if isinstance(key, int):
        return ["i", key]
    if isinstance(key, str):
        return ["s", key]
    if isinstance(key, tuple):
        return ["t", [_encode_key(k) for k in key]]
    raise TypeError(f"unencodable scheduler key {key!r}")


def _decode_key(enc: Any) -> Hashable:
    tag = enc[0]
    if tag == "none":
        return None
    if tag == "i":
        return int(enc[1])
    if tag == "s":
        return str(enc[1])
    return tuple(_decode_key(k) for k in enc[1])


def _tier_pools(server: StreamServer) -> List[Any]:
    return list(server.pool.tiers) if server._tiered else [server.pool]


# -- a stream-sharded server -------------------------------------------------
#
# On a stream mesh every rank runs the same server on the same submits:
# the host tables are replicated, but each rank holds only its own block
# of slots, and only the rank holding a stream's slot holds its queued
# chunks (the others queue placeholders).  A save gathers both over the
# mesh's group in slot order, so every rank holds what the mesh=None
# server would, and the group's first rank writes it; a restore reads the
# whole directory on every rank, which keeps its own slots.


def _shard(server: StreamServer):
    """The pool's ``StreamShard`` on a stream mesh, else ``None`` (tiers
    and a mesh are mutually exclusive)."""
    return None if server._tiered else server.pool.shard


def _writes(server: StreamServer) -> bool:
    """Whether this rank writes the server's checkpoint files."""
    shard = _shard(server)
    return shard is None or shard.lo == 0


def _wait_for_writer(server: StreamServer) -> None:
    """On a mesh, hold every rank until the writing rank is done."""
    shard = _shard(server)
    if shard is not None:
        import torch.distributed as dist

        dist.barrier(group=shard.group)


def _gather_slots(shard, states):
    """The mesh's slot states joined in slot order (a collective call)."""
    def rows(x):
        if x.dtype == torch.bool:
            return shard.gather(x.view(torch.uint8)).view(torch.bool)
        return shard.gather(x)

    return tree_map(rows, states)


def _gather_queues(server: StreamServer, shard,
                   queues: Dict[str, List[Optional[SensorChunk]]]):
    """Every queued chunk as the rank holding its stream's slot has it, on
    every rank (collective calls: the chunks' specs in one object
    gather, then each chunk broadcast from its owner)."""
    import torch.distributed as dist

    slots = [server._locate(sid)[1] for sid in server._queues]
    mine = {name: [_chunk_spec(c) for c in chunks]
            for (name, chunks), slot in zip(queues.items(), slots)
            if shard.owns(slot)}
    specs: List[Dict[str, Any]] = [None] * dist.get_world_size(shard.group)
    dist.all_gather_object(specs, mine, group=shard.group)
    specs_of = {k: v for part in specs for k, v in part.items()}
    out = {}
    for (name, chunks), slot in zip(queues.items(), slots):
        if not shard.owns(slot):
            chunks = [
                SensorChunk(*(None if f is None else torch.empty(
                    f[0], dtype=getattr(torch, f[1]), device=server.device)
                    for f in spec))
                for spec in specs_of[name]
            ]
        out[name] = [shard.broadcast(c, slot) for c in chunks]
    return out


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _chunk_spec(chunk: SensorChunk) -> List[Optional[List[Any]]]:
    return [
        None if f is None else [list(f.shape), _dtype_name(f.dtype)]
        for f in chunk
    ]


def _chunk_struct(spec: List[Optional[List[Any]]]) -> SensorChunk:
    return SensorChunk(
        *[
            None
            if f is None
            else store.LeafSpec(tuple(f[0]), getattr(torch, f[1]))
            for f in spec
        ]
    )


# -- snapshot ----------------------------------------------------------------


def snapshot_server(
    server: StreamServer, *, ingest: Optional[Any] = None
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Capture ``(device_tree, json_meta)`` of a live server.

    The device tree holds the per-tier :class:`~repro_torch.serve.slots.
    SlotStates` and every queued chunk, as references to the live
    tensors: admission and eviction write them in place, so a caller
    that keeps the tree past the next server call takes a host copy
    under the same lock (:func:`save_server` does).  The meta block
    holds everything host-side needed to re-bind it.  With ``ingest``
    given, its lock is held while capturing so a socket thread cannot
    interleave a submit, OPEN or CLOSE mid-snapshot, and the wire seq
    cursors are included.
    """
    with _ingest_lock(server, ingest):
        return _snapshot_locked(server, ingest)


def _ingest_lock(server: StreamServer, ingest: Optional[Any]):
    if ingest is None:
        return contextlib.nullcontext()
    if ingest.srv is not server:
        raise ValueError(
            "ingest frontier is bound to a different StreamServer"
        )
    return ingest.lock


def _snapshot_locked(
    server: StreamServer, ingest: Optional[Any]
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    pools = _tier_pools(server)
    cfg = server.cfg

    sessions: List[Dict[str, Any]] = []
    queues: Dict[str, List[SensorChunk]] = {}
    # Iterate in _queues order: tick() visits streams in this order, so
    # preserving it across restore preserves dispatch determinism.
    for i, sid in enumerate(server._queues):
        q = server._queues[sid]
        chunks = [c for c, *_ in q._q]
        queues[f"q{i:04d}"] = chunks
        tier, local = server._locate(sid)
        ctl = server._controllers.get(sid)
        tele = server._telemetry[sid].as_dict()
        tele.pop("session_id")
        sessions.append(
            {
                "sid": _encode_sid(sid),
                "tier": tier,
                "slot": local,
                "queue_counters": {
                    "n_pushed": q.n_pushed,
                    "n_overflow": q.n_overflow,
                    "n_dropped": q.n_dropped,
                },
                "controller": None
                if ctl is None
                else {
                    "rung": ctl._rung,
                    "k_trajectory": list(ctl.k_trajectory),
                },
                "telemetry": tele,
            }
        )

    meta: Dict[str, Any] = {
        "schema": SERVE_SCHEMA,
        "config": {
            k: list(v) if isinstance(v, tuple) else v
            for k, v in cfg._asdict().items()
        },
        "compressor": {
            "type": type(server.compressor).__name__,
            "cfg": repr(server.compressor.cfg),
        },
        "sessions": sessions,
        "host_generation": [list(p._host_generation) for p in pools],
        "counters": {a: getattr(server, a) for a in _COUNTER_ATTRS},
        "scheduler_cost": [
            [_encode_key(k), float(v)]
            for k, v in server._sched.cost_estimates().items()
        ],
        "evicted": [
            {
                "sid": _encode_sid(t.session_id),
                **{
                    k: v
                    for k, v in t.as_dict().items()
                    if k != "session_id"
                },
            }
            for t in server.evicted
        ],
    }
    if server._tiered:
        meta["pool"] = {
            "n_migrations": server.pool.n_migrations,
            "n_swaps": server.pool.n_swaps,
        }
    if ingest is not None:
        meta["wire"] = {
            "verify_crc": ingest.verify_crc,
            "strict_seq": ingest.strict_seq,
            "seq_seen": [
                [int(k), int(v)] for k, v in ingest._seq_seen.items()
            ],
            "resume_cursor": [
                [int(k), int(v)] for k, v in ingest._resume_cursor.items()
            ],
            "seq_gaps": [
                [int(k), int(v)]
                for k, v in ingest.seq_gaps_by_stream.items()
            ],
            "counters": {a: getattr(ingest, a) for a in _WIRE_COUNTER_ATTRS},
            "nacks": dict(ingest.nacks),
        }

    tiers = [p.states for p in pools]
    shard = _shard(server)
    if shard is not None:
        with _server_stream(server):  # the gathers follow the server's work
            tiers = [_gather_slots(shard, p.states) for p in pools]
            queues = _gather_queues(server, shard, queues)
    for sess, chunks in zip(sessions, queues.values()):
        sess["queue_spec"] = [_chunk_spec(c) for c in chunks]
    tree = {"tiers": tiers, "queues": queues}
    return tree, meta


def save_server(
    directory: str,
    step: int,
    server: StreamServer,
    *,
    ingest: Optional[Any] = None,
    n_shards: int = 2,
    saver: Optional[store.AsyncSaver] = None,
) -> Optional[str]:
    """Snapshot + save.  Synchronous without ``saver`` (returns the
    final step directory); with an :class:`~repro_torch.checkpoint.store.
    AsyncSaver` the snapshot is taken now, the write happens off the
    tick path, and ``None`` is returned.

    On a stream mesh every rank calls it: the slots and queued chunks are
    gathered (collective calls) and the group's first rank writes the
    directory, which every rank's synchronous call waits for.

    The metadata and the host copy of the device tree are taken together
    under the ingest lock: admit and evict write the pool in place, so an
    OPEN or CLOSE between the two would save a slot's device state and
    its session table from different moments."""
    if saver is not None:
        saver.wait()  # the previous write lands before this capture
    with _ingest_lock(server, ingest):
        tree, meta = _snapshot_locked(server, ingest)
        with _server_stream(server):  # the copies follow the server's work
            host_tree = store.host_snapshot(tree)
    rec = getattr(server, "recorder", None)
    if rec is not None:
        rec.event(
            "checkpoint", step=step,
            n_sessions=len(meta["sessions"]),
            asynchronous=saver is not None,
        )
    writes = _writes(server)
    if saver is None:
        final = os.path.join(directory, f"step_{step:08d}")
        if writes:
            final = store.save(
                directory, step, host_tree, n_shards=n_shards,
                extra_meta={"serve": meta},
            )
        _wait_for_writer(server)
        return final
    if writes:
        saver.save_host(
            directory, step, host_tree, n_shards=n_shards,
            extra_meta={"serve": meta},
        )
    return None


def _server_stream(server: StreamServer):
    s = server._stream
    return torch.cuda.stream(s) if s is not None else contextlib.nullcontext()


# -- restore -----------------------------------------------------------------


def restore_server(
    directory: str,
    compressor,
    *,
    step: Optional[int] = None,
    server: Optional[StreamServer] = None,
    with_ingest: bool = False,
) -> RestoredServer:
    """Rebuild a serving runtime from the newest complete checkpoint.

    ``compressor`` must match the one the checkpoint was taken with
    (type + config ``repr`` fence — a silently different sparse-TRD
    config would un-pin the bitwise replay contract).  ``server=None``
    constructs a fresh :class:`StreamServer` from the recorded config;
    passing one (e.g. pre-built with ``prewarm=True``) requires an
    identical config and no live sessions.  A stream-sharded server is
    restored by passing a fresh one on the mesh, on every rank: each
    reads the whole directory and keeps its own slots.

    With ``step=None`` a damaged newest step (crashed save, concurrent
    gc) falls back to the previous complete one, exactly like
    :func:`repro_torch.checkpoint.store.restore`.
    """
    if step is not None:
        return _restore_one(directory, step, compressor, server, with_ingest)
    steps = store.complete_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no complete checkpoint in {directory}")
    last_err: Optional[BaseException] = None
    for s in reversed(steps):
        try:
            return _restore_one(directory, s, compressor, server, with_ingest)
        except store._DAMAGED_STEP_ERRORS as e:
            last_err = e
    raise last_err


def _restore_one(
    directory: str,
    step: int,
    compressor,
    server: Optional[StreamServer],
    with_ingest: bool,
) -> RestoredServer:
    meta = store.read_manifest(directory, step).get("serve")
    if meta is None:
        raise ValueError(
            f"step {step} in {directory} is not a serve checkpoint "
            f"(no 'serve' metadata block)"
        )
    if meta.get("schema") != SERVE_SCHEMA:
        raise ValueError(
            f"serve checkpoint schema {meta.get('schema')} != "
            f"{SERVE_SCHEMA} (this build)"
        )
    cfg_kw = dict(meta["config"])
    for k in ("k_ladder", "tiers"):
        if cfg_kw.get(k) is not None:
            cfg_kw[k] = tuple(cfg_kw[k])
    config = ServerConfig(**cfg_kw)
    fence = meta["compressor"]
    if fence["type"] != type(compressor).__name__ or fence["cfg"] != repr(
        compressor.cfg
    ):
        raise ValueError(
            f"compressor mismatch: checkpoint was taken with "
            f"{fence['type']}({fence['cfg']}), restoring with "
            f"{type(compressor).__name__}({compressor.cfg!r})"
        )

    if server is None:
        srv = StreamServer(compressor, config)
    else:
        if server.cfg != config:
            raise ValueError(
                f"provided server config {server.cfg} != checkpointed "
                f"{config}"
            )
        if server.live_sessions:
            raise ValueError(
                "restore target must have no live sessions; got "
                f"{server.live_sessions}"
            )
        srv = server
    pools = _tier_pools(srv)
    shard = _shard(srv)

    def whole(x):  # a leaf of the checkpoint's (mesh=None) slot tree
        if shard is None:
            return x
        return store.LeafSpec((srv.pool.capacity, *x.shape[1:]), x.dtype)

    like = {
        "tiers": [tree_map(whole, p.states) for p in pools],
        "queues": {
            f"q{i:04d}": [_chunk_struct(spec) for spec in sess["queue_spec"]]
            for i, sess in enumerate(meta["sessions"])
        },
    }
    tree, _ = store.restore(directory, like, step=step, device="cpu")

    # Device state + host mirrors are written directly — NOT through
    # the admit path (which would bump generations and reset sessions)
    # and NOT through _host_bind.  Restored generation counters
    # therefore equal the checkpointed ones on both sides.  The copies
    # go in place into the fresh pool's preallocated tensors.
    with _server_stream(srv):
        for p, st in zip(pools, tree["tiers"]):
            for buf, x in zip(store._flatten_with_paths(p.states),
                              store._flatten_with_paths(st)):
                buf[1].copy_(x[1] if shard is None else shard.rows(x[1]))
            p.session_at = [None] * p.capacity
            p._slot_of = {}
        queued = {
            name: [
                SensorChunk(*(None if f is None else f.to(srv.device)
                              for f in c))
                if shard is None or shard.owns(sess["slot"]) else None
                for c in chunks
            ]
            for (name, chunks), sess in zip(tree["queues"].items(),
                                            meta["sessions"])
        }
    for p, gens in zip(pools, meta["host_generation"]):
        p._host_generation = [int(g) for g in gens]

    now = time.monotonic()
    # The restored logical clock (applied to srv further down): queued
    # chunks are re-stamped with it so a staleness deadline never sheds
    # them on the first post-restore tick.
    tick_now = int(meta["counters"]["n_ticks"])
    zero_src: Optional[SensorChunk] = next(
        (c for chunks in tree["queues"].values() for c in chunks), None)
    for i, sess in enumerate(meta["sessions"]):
        sid = _decode_sid(sess["sid"])
        tier, local = sess["tier"], sess["slot"]
        p = pools[tier]
        p.session_at[local] = sid
        p._slot_of[sid] = local

        q = ChunkQueue(config.queue_depth, policy=config.queue_policy)
        for chunk in queued[f"q{i:04d}"]:
            q._q.append((chunk, now, tick_now))
        qc = sess["queue_counters"]
        q.n_pushed = qc["n_pushed"]
        q.n_overflow = qc["n_overflow"]
        q.n_dropped = qc["n_dropped"]
        srv._queues[sid] = q

        ctl = None
        if sess["controller"] is not None:
            ctl = StreamServer._make_controller(compressor, config)
            ctl._rung = int(sess["controller"]["rung"])
            # extend(), not assignment: under k_trajectory_limit the
            # fresh controller holds a bounded deque, and replacing it
            # with a plain list would silently unbound the history.
            ctl.k_trajectory.extend(
                int(k) for k in sess["controller"]["k_trajectory"]
            )
            srv._controllers[sid] = ctl

        tele = StreamTelemetry(session_id=sid, **sess["telemetry"])
        if ctl is not None:
            # Same aliasing the live server maintains: telemetry shows
            # the controller's trajectory list, not a copy.
            tele.k_trajectory = ctl.k_trajectory
        srv._telemetry[sid] = tele

    if zero_src is not None:
        srv._zero_chunk = SensorChunk(
            *(None if x is None else torch.zeros_like(x, device=srv.device)
              for x in zero_src)
        )
    # (else: the first post-restore submit sets it, as on a live server)

    for a in _COUNTER_ATTRS:
        setattr(srv, a, meta["counters"][a])
    srv._sched._cost = {
        _decode_key(k): float(v) for k, v in meta["scheduler_cost"]
    }
    srv.evicted = [
        StreamTelemetry(
            session_id=_decode_sid(e["sid"]),
            **{k: v for k, v in e.items() if k != "sid"},
        )
        for e in meta["evicted"]
    ]
    if srv._tiered and "pool" in meta:
        srv.pool.n_migrations = meta["pool"]["n_migrations"]
        srv.pool.n_swaps = meta["pool"]["n_swaps"]

    ingest = None
    if with_ingest:
        from repro_torch.wire.server import IngestServer  # wire optional

        w = meta.get("wire")
        ingest = IngestServer(
            srv,
            verify_crc=w["verify_crc"] if w else True,
            strict_seq=w["strict_seq"] if w else False,
        )
        if w is not None:
            ingest._seq_seen = {int(k): int(v) for k, v in w["seq_seen"]}
            ingest._resume_cursor = {
                int(k): int(v) for k, v in w["resume_cursor"]
            }
            ingest.seq_gaps_by_stream = {
                int(k): int(v) for k, v in w["seq_gaps"]
            }
            for a in _WIRE_COUNTER_ATTRS:
                setattr(ingest, a, w["counters"][a])
            ingest.nacks = dict(w["nacks"])
    rec = getattr(srv, "recorder", None)
    if rec is not None:
        rec.event(
            "resume", step=step,
            n_sessions=len(meta["sessions"]),
            with_ingest=with_ingest,
        )
    return RestoredServer(srv, ingest, step)


# -- cadence wrapper ---------------------------------------------------------


class ServeCheckpointer:
    """Checkpoint-every-N-ticks with async writes and gc.

    Call :meth:`maybe_save` once per serving tick; every
    ``every_ticks`` ticks it snapshots (one host copy of the device
    tree, one sync) and hands the write to an
    :class:`~repro_torch.checkpoint.store.AsyncSaver` so the tick path
    never blocks on disk.  A crash mid-save leaves the previous step intact
    (the store's tmp-dir + manifest-last protocol); :meth:`restore`
    waits out any in-flight save first — never restore over one.
    """

    def __init__(
        self,
        directory: str,
        server: StreamServer,
        *,
        every_ticks: int = 8,
        keep: int = 3,
        ingest: Optional[Any] = None,
        n_shards: int = 2,
    ):
        if every_ticks < 1:
            raise ValueError(
                f"every_ticks must be >= 1, got {every_ticks}"
            )
        self.directory = directory
        self.server = server
        self.every_ticks = every_ticks
        self.keep = keep
        self.ingest = ingest
        self.n_shards = n_shards
        self.saver = store.AsyncSaver()
        self.n_saves = 0
        self._last_saved_tick = -1

    def maybe_save(self) -> bool:
        """Save iff the tick counter crossed the cadence (idempotent
        within a tick).  Returns whether a save was started."""
        t = self.server.n_ticks
        if t > 0 and t % self.every_ticks == 0 and t != self._last_saved_tick:
            self.save_now()
            return True
        return False

    def save_now(self) -> None:
        step = self.server.n_ticks
        save_server(
            self.directory,
            step,
            self.server,
            ingest=self.ingest,
            n_shards=self.n_shards,
            saver=self.saver,
        )
        self._last_saved_tick = step
        self.n_saves += 1
        # Complete steps only — the in-flight one is invisible to gc.
        if _writes(self.server):
            store.gc_old(self.directory, self.keep)

    def wait(self) -> None:
        """Block until the in-flight save (if any) lands; re-raises a
        background write failure.  Runs a final gc pass — during
        operation the save-time gc cannot see the still-in-flight step,
        so up to ``keep + 1`` complete steps may briefly coexist.  On a
        stream mesh every rank calls it, and it returns once the writing
        rank's save has landed."""
        self.saver.wait()
        if self.n_saves and _writes(self.server):
            store.gc_old(self.directory, self.keep)
        _wait_for_writer(self.server)

    def restore(
        self,
        compressor,
        *,
        step: Optional[int] = None,
        server: Optional[StreamServer] = None,
        with_ingest: bool = False,
    ) -> RestoredServer:
        self.wait()  # never restore over an in-flight save
        return restore_server(
            self.directory,
            compressor,
            step=step,
            server=server,
            with_ingest=with_ingest,
        )
