"""Append-only ``.wtrace`` files: recorded wire traffic, replayable (port
of ``repro.wire.trace``; a trace is byte-compatible across both packages).

File layout (little-endian)::

    0   8    magic  b"EPWTRACE"
    8   2    version (u16, currently 1)
    10  2    reserved (0)
    12  ...  records, back to back, each:
             u64  record timestamp (ns, recorder's monotonic clock)
             u32  message nbytes
             ...  one codec message (data frame or control frame)

The record timestamp is the *transport* arrival time and drives paced
replay; a data frame additionally carries the producer's own
``timestamp_ns`` inside the codec header (end-to-end latency).  The
reader loads the file once and yields ``memoryview`` slices — replaying
never copies payload bytes.

Two replay modes:

* **as-fast-as-possible** (``realtime=False``): a bit-exact soak —
  pushing a recorded session through the loopback ingest server must
  produce bitwise-identical compressor state to the original
  in-process run (pinned in ``tests/test_torch_wire.py``);
* **original timestamps** (``realtime=True``): sleeps out the recorded
  inter-record gaps (optionally scaled by ``speed``) for latency
  measurement under the recorded traffic shape.
"""

from __future__ import annotations

import struct
import time
from typing import (
    Callable,
    Dict,
    Iterable,
    Iterator,
    List,
    NamedTuple,
    Optional,
)

from repro_torch.api.types import SensorChunk
from repro_torch.wire import codec

TRACE_MAGIC = b"EPWTRACE"
TRACE_VERSION = 1
TRACE_HEADER = struct.Struct("<8sHH")
RECORD_HEADER = struct.Struct("<QI")


class TraceRecord(NamedTuple):
    timestamp_ns: int
    message: memoryview  # zero-copy slice of the trace buffer


class TraceWriter:
    """Append wire messages (with record timestamps) to a trace file."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "wb")
        self._f.write(
            TRACE_HEADER.pack(TRACE_MAGIC, TRACE_VERSION, 0)
        )
        self.n_records = 0

    def append(
        self, message: bytes, *, timestamp_ns: Optional[int] = None
    ) -> None:
        ts = time.monotonic_ns() if timestamp_ns is None else timestamp_ns
        self._f.write(RECORD_HEADER.pack(ts, len(message)))
        self._f.write(message)
        self.n_records += 1

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "TraceWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class TraceReader:
    """Iterate a trace's records as zero-copy ``memoryview`` slices."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            self._buf = f.read()
        if len(self._buf) < TRACE_HEADER.size:
            raise codec.WireFormatError(
                f"truncated trace {path!r}: {len(self._buf)} bytes"
            )
        magic, version, _ = TRACE_HEADER.unpack_from(self._buf)
        if magic != TRACE_MAGIC:
            raise codec.WireFormatError(
                f"{path!r} is not a wire trace (magic {magic!r})"
            )
        if version != TRACE_VERSION:
            raise codec.WireFormatError(
                f"trace version {version} not supported (reader speaks "
                f"{TRACE_VERSION})"
            )

    def __iter__(self) -> Iterator[TraceRecord]:
        view = memoryview(self._buf)
        off = TRACE_HEADER.size
        while off < len(view):
            if off + RECORD_HEADER.size > len(view):
                raise codec.WireFormatError(
                    f"truncated record header at offset {off} in "
                    f"{self.path!r}"
                )
            ts, nbytes = RECORD_HEADER.unpack_from(self._buf, off)
            off += RECORD_HEADER.size
            if off + nbytes > len(view):
                raise codec.WireFormatError(
                    f"truncated record payload at offset {off} in "
                    f"{self.path!r} ({nbytes} bytes promised, "
                    f"{len(view) - off} left)"
                )
            yield TraceRecord(ts, view[off : off + nbytes])
            off += nbytes

    def records(self) -> List[TraceRecord]:
        return list(self)


def record_session(
    chunks: Iterable[SensorChunk],
    path: str,
    *,
    stream_id: int,
    chunk_period_ns: int = 0,
    open_close: bool = True,
    start_ns: int = 0,
) -> int:
    """Record one stream's chunks as a wire session trace.

    Encodes ``OPEN``, one data frame per chunk (``seq`` counting from
    0, timestamps spaced ``chunk_period_ns`` apart from ``start_ns``),
    and — with ``open_close`` — the final ``CLOSE``.  Synthetic
    timestamps keep the trace deterministic; pass ``chunk_period_ns``
    equal to the chunk duration (frames × frame period) for a
    wall-clock-faithful paced replay.  Returns the record count.
    """
    with TraceWriter(path) as w:
        ts = start_ns
        if open_close:
            w.append(
                codec.encode_control(codec.OP_OPEN, stream_id),
                timestamp_ns=ts,
            )
        for seq, chunk in enumerate(chunks):
            w.append(
                codec.encode_chunk(
                    chunk, stream_id=stream_id, seq=seq, timestamp_ns=ts
                ),
                timestamp_ns=ts,
            )
            ts += chunk_period_ns
        if open_close:
            w.append(
                codec.encode_control(codec.OP_CLOSE, stream_id),
                timestamp_ns=ts,
            )
        return w.n_records


def record_streams(
    feeds: Dict[int, Iterable[SensorChunk]],
    path: str,
    *,
    chunk_period_ns: int = 0,
    open_close: bool = True,
    start_ns: int = 0,
) -> int:
    """Record several interleaved streams into one session trace.

    ``feeds`` maps ``stream_id -> chunks``.  Streams are interleaved
    round-robin in the dict's iteration order: each "tick" takes the
    next chunk from every still-live stream, all stamped with the same
    record timestamp (``start_ns + tick * chunk_period_ns``), matching
    the one-chunk-per-stream-per-tick shape the load generator offers.
    An ``OPEN`` is recorded at a stream's first appearance and (with
    ``open_close``) a ``CLOSE`` when its feed is exhausted, at the
    exact positions a live multi-session client would have sent them —
    so a replay through a fresh ingest server reproduces the original
    interleaving (and therefore per-stream state) bit-exactly.
    Returns the record count.
    """
    with TraceWriter(path) as w:
        iters = {int(sid): iter(chunks) for sid, chunks in feeds.items()}
        seqs = {sid: 0 for sid in iters}
        ts = start_ns
        while iters:
            done: List[int] = []
            for sid, it in iters.items():
                chunk = next(it, None)
                if chunk is None:
                    done.append(sid)
                    continue
                if seqs[sid] == 0 and open_close:
                    w.append(
                        codec.encode_control(codec.OP_OPEN, sid),
                        timestamp_ns=ts,
                    )
                w.append(
                    codec.encode_chunk(
                        chunk,
                        stream_id=sid,
                        seq=seqs[sid],
                        timestamp_ns=ts,
                    ),
                    timestamp_ns=ts,
                )
                seqs[sid] += 1
            for sid in done:
                del iters[sid]
                if open_close:
                    w.append(
                        codec.encode_control(codec.OP_CLOSE, sid),
                        timestamp_ns=ts,
                    )
            ts += chunk_period_ns
        return w.n_records


def replay(
    source,
    send: Callable,
    *,
    realtime: bool = False,
    speed: float = 1.0,
    sleep: Callable[[float], None] = time.sleep,
    on_reply: Optional[Callable] = None,
    on_advance: Optional[Callable[[], None]] = None,
) -> int:
    """Push a trace's messages through a transport ``send``.

    ``source`` is a path, a :class:`TraceReader`, or any iterable of
    :class:`TraceRecord`.  ``send`` is e.g. ``Loopback.send`` or
    ``WireClient.send``; each reply is passed to ``on_reply`` (count
    NACKs there).  ``realtime=True`` paces records by their recorded
    timestamp deltas divided by ``speed``; the default replays
    as-fast-as-possible (the bit-exact soak mode).

    ``on_advance`` is called (with no arguments) *before* sending a
    record whose ``timestamp_ns`` strictly exceeds the previous
    record's.  Traces written by :func:`record_streams` or the load
    generator stamp every message of one logical tick with the same
    timestamp, so passing the ingest server's ``tick`` here re-runs
    the original tick boundaries at the original positions in the
    message stream — the replayed server drains between ticks exactly
    as the recorded one did.  Returns the number of messages sent.
    """
    if isinstance(source, str):
        source = TraceReader(source)
    if speed <= 0:
        raise ValueError(f"replay speed must be > 0, got {speed}")
    t0_ns: Optional[int] = None
    prev_ns: Optional[int] = None
    wall0 = time.monotonic()
    n = 0
    for rec in source:
        if realtime:
            if t0_ns is None:
                t0_ns = rec.timestamp_ns
            due = (rec.timestamp_ns - t0_ns) / 1e9 / speed
            lag = due - (time.monotonic() - wall0)
            if lag > 0:
                sleep(lag)
        if (
            on_advance is not None
            and prev_ns is not None
            and rec.timestamp_ns > prev_ns
        ):
            on_advance()
        prev_ns = rec.timestamp_ns
        reply = send(rec.message)
        if on_reply is not None:
            on_reply(reply)
        n += 1
    return n
