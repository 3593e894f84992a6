"""Host-side ingest server: framed wire messages → ``StreamServer`` (port
of ``repro.wire.server``; the replies are the reference's, byte for byte).

Transport layering (relay → queue → pipeline):

* every transport speaks the same **message framing** — a little-endian
  ``u32`` length prefix, then one codec message (data frame, control
  frame, or reply);
* :meth:`IngestServer.handle_message` is the transport-agnostic core:
  decode, demux on the stream id, map session ``OPEN``/``CLOSE`` onto
  slot admit/evict, push data frames into the stream's bounded
  :class:`~repro_torch.serve.ingest.ChunkQueue`, and answer **every** message
  with an ACK or a reasoned NACK — a full queue surfaces the queue's
  refuse-newest backpressure to the producer as ``NACK_BACKPRESSURE``
  instead of silently growing host memory, and a duplicate or
  regressed per-stream ``seq`` is refused as ``NACK_OUT_OF_ORDER``
  (seqs must advance monotonically; gaps are fine — a backpressure
  retry of the same seq still ACKs because ``_seq_seen`` only records
  successfully submitted frames);
* :class:`Loopback` is the in-process transport (the trace replayer and
  the load generator drive it; zero sockets, same code path);
* :meth:`IngestServer.serve_tcp` / :meth:`serve_unix` are thin asyncio
  receivers that run the same core on each framed message, one reply
  per message, in the event-loop thread.  ``handle_message`` holds the
  server's lock, so a bench thread may call :meth:`tick` concurrently.
  The chunk's upload to the card (``StreamServer.submit``) and the
  tick's step both run on the ``StreamServer``'s own CUDA stream,
  whichever thread calls them, so the upload is ordered before the
  step that reads it.

**Reconnect/resume**: a ``RESUME`` control frame re-binds a dropped
connection to its live (or just-restored, see
:mod:`repro_torch.serve.checkpoint`) stream.  The server answers with the
next seq it expects; seqs at or below that cursor replayed from the
client's window are **duplicate-suppressed** (ACKed without
re-serving).  :class:`ResumableSession` is the producer half: a bounded
unacked send window, automatic ``reconnect → RESUME → replay`` on
connection errors, with :class:`WireClient` supplying bounded
exponential-backoff redials.  Forward seq gaps are always *counted*
per stream (``n_seq_gaps``); under ``strict_seq=True`` they are also
refused with ``NACK_SEQ_GAP`` so a lossy uplink must retransmit.

**Selective retransmit**: a strict-mode ``NACK_SEQ_GAP`` reply carries
the *first missing* seq, so the missing range is exactly
``[reply.seq, attempted_seq)``.  :class:`ResumableSession` replays that
slice from its bounded window (no reconnect needed) and then retries
the refused frame — a lossy link converges to the bit-identical stream
as long as the loss does not outlive the window.  Damaged frames
(``NACK_BAD_FRAME``: corruption or truncation in flight) are resent
from the window's pristine copy, and a ``NACK_OUT_OF_ORDER`` on a seq
the session itself sent is absorbed as "already served" (the server's
duplicate signal for a late-arriving copy).

**Credit flow control**: a ``CREDIT`` control frame asks the server for
send credits; the grant (the ACK's ``seq``) is sized to the stream's
queue headroom minus credits already outstanding, and each accepted
data frame consumes one.  A :class:`ResumableSession` constructed with
``credit=N`` paces itself on the granted window — requesting more only
when exhausted, draining a tick on a zero grant — so a well-behaved
producer never trips ``NACK_BACKPRESSURE`` at all.  Credit-unaware
producers are unaffected (credits are cooperative pacing; the queue
bound still backstops them).  Outstanding grants are voided by RESUME:
a reconnecting client starts from zero credit.

**Introspection**: a ``STATUS`` control frame (op 5) is answered with
an ``EPWS`` status reply — the JSON snapshot built by
:func:`repro_torch.obs.status.collect_status` (occupancy, queues, credit,
degrade, seq cursors, counters, the ``STATUS_REASONS`` table).
``Loopback.status()`` / ``WireClient.status()`` wrap the round-trip.
All ingest counters live in a :class:`~repro_torch.obs.metrics.
MetricsRegistry` (shared with the ``StreamServer``'s when it has one);
the ``n_*`` attributes and the ``nacks`` / ``seq_gaps_by_stream`` dicts
are *views* over the same registry cells, so every surface —
``counters()``, STATUS payloads, Prometheus export — reports the same
integers.

The serving *clock* stays with the caller: the ingest server never
steps the pool on its own — call :meth:`tick` (or
``StreamServer.tick``) at the serving cadence.
"""

from __future__ import annotations

import asyncio
import socket
import struct
import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, Optional, Tuple

from repro_torch.obs.metrics import MetricsRegistry, counter_property
from repro_torch.wire import codec

LENGTH_PREFIX = struct.Struct("<I")
MAX_MESSAGE_NBYTES = 1 << 30  # fail fast on absurd/corrupt lengths


def frame_message(msg: bytes) -> bytes:
    """Prepend the u32 length prefix shared by all transports."""
    if len(msg) > MAX_MESSAGE_NBYTES:
        raise codec.WireFormatError(
            f"message of {len(msg)} bytes exceeds the "
            f"{MAX_MESSAGE_NBYTES}-byte frame limit"
        )
    return LENGTH_PREFIX.pack(len(msg)) + msg


class IngestServer:
    """Demux framed wire messages into a ``StreamServer``'s queues."""

    # Registry-backed counters: `self.n_messages += 1` and checkpoint
    # `setattr` round-trips keep working, but the integer lives in one
    # `wire_*` registry cell shared by every view (`counters()`, STATUS
    # payloads, Prometheus export).
    n_messages = counter_property("wire_messages_total")
    n_frames_in = counter_property("wire_frames_in_total")
    n_opened = counter_property("wire_opened_total")
    n_closed = counter_property("wire_closed_total")
    n_resumed = counter_property("wire_resumed_total")
    n_dup_suppressed = counter_property("wire_dup_suppressed_total")
    n_credit_requests = counter_property("wire_credit_requests_total")
    n_credit_granted = counter_property("wire_credit_granted_total")

    def __init__(
        self,
        stream_server,
        *,
        verify_crc: bool = True,
        strict_seq: bool = False,
    ):
        self.srv = stream_server
        self.verify_crc = verify_crc
        self.strict_seq = strict_seq
        self.lock = threading.Lock()
        # One registry per serving process: adopt the StreamServer's so
        # `wire_*` and `serve_*` families snapshot/export together; fall
        # back to a private one for bare frontiers.
        # Must be set before any counter attribute is touched.
        self.metrics = getattr(stream_server, "metrics", None)
        if self.metrics is None:
            self.metrics = MetricsRegistry()
        for _attr in (
            "n_messages", "n_frames_in", "n_opened", "n_closed",
            "n_resumed", "n_dup_suppressed", "n_credit_requests",
            "n_credit_granted",
        ):
            getattr(self, _attr)  # materialize zero-valued cells
        self._seq_seen: Dict[int, int] = {}
        # Credits granted but not yet consumed, per stream.  A grant is
        # bounded by queue headroom minus this balance, so the sum of
        # outstanding credits never exceeds the space that exists.
        self._credit: Dict[int, int] = {}
        self.metrics.gauge(
            "wire_credit_outstanding",
            fn=lambda: sum(self._credit.values()),
        )
        # Duplicate-suppression boundary set by RESUME: data seqs at or
        # below the cursor are ACKed without re-serving (the client's
        # window replay may overlap frames the server already has).
        self._resume_cursor: Dict[int, int] = {}
        self._servers: list = []
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None

    # -- registry-backed dict views -----------------------------------------

    @property
    def nacks(self) -> Dict[str, int]:
        """NACK counts by status name — a view over the registry's
        ``wire_nacks_total{status=...}`` family (a fresh real dict, so
        ``==`` comparisons against literals keep working)."""
        return {
            dict(lk)["status"]: c.value
            for lk, c in self.metrics.family("wire_nacks_total").items()
        }

    @nacks.setter
    def nacks(self, values: Dict[str, int]) -> None:
        # Checkpoint restore assigns the whole dict: replace the family.
        self.metrics.clear_family("wire_nacks_total")
        for status, n in values.items():
            self.metrics.counter(
                "wire_nacks_total", status=str(status)
            ).set(n)

    @property
    def seq_gaps_by_stream(self) -> Dict[int, int]:
        """Per-stream count of *missing* seqs skipped forward past
        (telemetry even in lax mode; retained after close so a bench
        can report end-of-run loss).  View over
        ``wire_seq_gaps_total{stream=...}``."""
        return {
            int(dict(lk)["stream"]): c.value
            for lk, c in self.metrics.family("wire_seq_gaps_total").items()
        }

    @seq_gaps_by_stream.setter
    def seq_gaps_by_stream(self, values: Dict[int, int]) -> None:
        self.metrics.clear_family("wire_seq_gaps_total")
        for sid, n in values.items():
            self.metrics.counter(
                "wire_seq_gaps_total", stream=int(sid)
            ).set(n)

    # -- transport-agnostic core --------------------------------------------

    def _nack(self, status: int, stream_id: int, seq: int = 0) -> bytes:
        name = codec.STATUS_NAMES[status]
        self.metrics.counter("wire_nacks_total", status=name).inc()
        rec = getattr(self.srv, "recorder", None)
        if rec is not None:
            rec.event("nack", status=name, stream=stream_id, seq=seq)
        return codec.encode_reply(status, stream_id, seq)

    def handle_message(self, msg) -> bytes:
        """Process one unframed message; returns the encoded reply."""
        with self.lock:
            return self._handle_locked(msg)

    def _handle_locked(self, msg) -> bytes:
        self.n_messages += 1
        try:
            kind, frame = codec.decode_message(
                msg, verify_crc=self.verify_crc
            )
        except codec.WireFormatError:
            return self._nack(codec.NACK_BAD_FRAME, 0)
        if kind == "control":
            return self._handle_control(frame)
        if kind != "data":
            return self._nack(codec.NACK_BAD_FRAME, 0)
        sid = frame.stream_id
        if sid not in self._seq_seen:
            return self._nack(codec.NACK_UNKNOWN_STREAM, sid, frame.seq)
        last = self._seq_seen[sid]
        if last >= 0 and frame.seq <= last:
            if frame.seq <= self._resume_cursor.get(sid, -1):
                # Post-RESUME window replay of a frame the server
                # already served (the client's ACK was lost in the
                # drop, or it restored an older cursor): suppress the
                # duplicate and ACK so the client's window drains.
                self.n_dup_suppressed += 1
                return codec.encode_reply(codec.ACK, sid, frame.seq)
            # A duplicate or regressed seq is a producer bug (or a
            # replayed packet): refuse it instead of double-serving the
            # frames.  `_seq_seen` only advances on successful submit,
            # so a backpressure retry of the *same* seq still ACKs.
            return self._nack(codec.NACK_OUT_OF_ORDER, sid, frame.seq)
        gap = frame.seq - last - 1 if last >= 0 else frame.seq
        if gap > 0 and self.strict_seq:
            # Strict mode refuses the jump without serving it — the
            # producer must retransmit the missing seqs (count before
            # refusing so the loss is visible either way).  The NACK's
            # seq is the FIRST missing seq, so the client knows the
            # missing range is exactly [reply.seq, attempted_seq) and
            # can replay that slice from its window.
            self._count_gap(sid, gap)
            return self._nack(codec.NACK_SEQ_GAP, sid, last + 1)
        try:
            # The decoded fields are views of the message buffer, which a
            # transport may reuse; submit queues a copy of its own.
            ok = self.srv.submit(sid, frame.chunk)
        except (ValueError, KeyError):
            # Wrong serving quantum / raced an eviction: the frame is
            # structurally valid wire but unserveable as submitted.
            return self._nack(codec.NACK_BAD_FRAME, sid, frame.seq)
        if not ok:
            return self._nack(codec.NACK_BACKPRESSURE, sid, frame.seq)
        if gap > 0:
            # Lax mode accepts the jump but never silently: counted
            # once, on the submit that actually advanced the cursor
            # (a backpressure retry of the same seq is not a new gap).
            self._count_gap(sid, gap)
        self._seq_seen[sid] = frame.seq
        self.n_frames_in += 1
        out = self._credit.get(sid)
        if out:  # each accepted frame consumes one outstanding credit
            self._credit[sid] = out - 1
        return codec.encode_reply(codec.ACK, sid, frame.seq)

    def _count_gap(self, sid: int, gap: int) -> None:
        self.metrics.counter("wire_seq_gaps_total", stream=int(sid)).inc(gap)

    def _handle_control(self, ctl: codec.ControlFrame) -> bytes:
        sid = ctl.stream_id
        if ctl.op == codec.OP_OPEN:
            if sid in self._seq_seen:
                return self._nack(codec.NACK_DUP_STREAM, sid)
            try:
                self.srv.admit(sid)
            except RuntimeError:
                return self._nack(codec.NACK_POOL_FULL, sid)
            except ValueError:
                return self._nack(codec.NACK_DUP_STREAM, sid)
            self._seq_seen[sid] = -1
            self.n_opened += 1
            return codec.encode_reply(codec.ACK, sid)
        if ctl.op == codec.OP_RESUME:
            if sid in self._seq_seen:
                cursor = self._seq_seen[sid]
            elif sid in set(self.srv.live_sessions):
                # The serving slot is live but this ingest frontier has
                # no wire cursor for it — a freshly restored process
                # whose checkpoint predates this frontier.  Adopt the
                # client's claimed last-acked seq (``ctl.seq`` carries
                # last_acked + 1) as the cursor.
                cursor = ctl.seq - 1
                self._seq_seen[sid] = cursor
            else:
                return self._nack(codec.NACK_UNKNOWN_STREAM, sid)
            self._resume_cursor[sid] = cursor
            # Grants die with the connection they were issued on: the
            # resumed client starts from zero and re-requests.
            self._credit.pop(sid, None)
            self.n_resumed += 1
            # The ACK's seq is the NEXT seq the server expects; the
            # client replays its unacked window from there.
            return codec.encode_reply(codec.ACK, sid, cursor + 1)
        if ctl.op == codec.OP_CREDIT:
            if sid not in self._seq_seen:
                return self._nack(codec.NACK_UNKNOWN_STREAM, sid)
            self.n_credit_requests += 1
            q = self.srv._queues.get(sid)
            headroom = 0 if q is None else max(0, q.maxlen - len(q))
            outstanding = self._credit.get(sid, 0)
            grant = max(0, min(ctl.seq, headroom - outstanding))
            if grant:
                self._credit[sid] = outstanding + grant
                self.n_credit_granted += grant
            # A zero grant is still an ACK — "no space yet, ask again
            # after a tick" — not an error.
            return codec.encode_reply(codec.ACK, sid, grant)
        if ctl.op == codec.OP_STATUS:
            # Introspection: answered with an EPWS status reply, not an
            # EPWR ack.  The caller holds the ingest lock, so the
            # snapshot is consistent w.r.t. concurrent submits/ticks.
            from repro_torch.obs.status import collect_status

            return codec.encode_status_reply(collect_status(self))
        # OP_CLOSE (decode_control rejects anything else)
        if sid not in self._seq_seen:
            return self._nack(codec.NACK_UNKNOWN_STREAM, sid)
        # Drain-then-evict: pending queued chunks are served before the
        # slot frees (matches a producer's "flush and hang up").
        while len(self.srv._queues[sid]):
            self.srv.tick()
        self.srv.close(sid)
        del self._seq_seen[sid]
        self._resume_cursor.pop(sid, None)
        self._credit.pop(sid, None)
        self.n_closed += 1
        return codec.encode_reply(codec.ACK, sid)

    def session_evicted(self, stream_id: int) -> None:
        """Forget a wire session the serving layer evicted on its own
        (idle/LRU policies); later frames NACK ``unknown_stream``."""
        self._seq_seen.pop(stream_id, None)
        self._resume_cursor.pop(stream_id, None)
        self._credit.pop(stream_id, None)

    def tick(self):
        """Run one serving tick under the ingest lock (safe alongside
        socket receivers); prunes wire sessions the tick evicted."""
        with self.lock:
            stepped = self.srv.tick()
            live = set(self.srv.live_sessions)
            for sid in [s for s in self._seq_seen if s not in live]:
                del self._seq_seen[sid]
                self._resume_cursor.pop(sid, None)
                self._credit.pop(sid, None)
            return stepped

    def counters(self) -> Dict[str, int]:
        return {
            "n_messages": self.n_messages,
            "n_frames_in": self.n_frames_in,
            "n_opened": self.n_opened,
            "n_closed": self.n_closed,
            "n_resumed": self.n_resumed,
            "n_dup_suppressed": self.n_dup_suppressed,
            "n_credit_requests": self.n_credit_requests,
            "n_credit_granted": self.n_credit_granted,
            "credit_outstanding": sum(self._credit.values()),
            "n_out_of_order": self.nacks.get("out_of_order", 0),
            "n_seq_gaps": sum(self.seq_gaps_by_stream.values()),
            "seq_gaps_by_stream": dict(self.seq_gaps_by_stream),
            "nacks": dict(self.nacks),
        }

    # -- asyncio socket receivers -------------------------------------------

    async def _handle_conn(self, reader, writer):
        try:
            while True:
                try:
                    head = await reader.readexactly(LENGTH_PREFIX.size)
                except asyncio.IncompleteReadError:
                    break
                (nbytes,) = LENGTH_PREFIX.unpack(head)
                if nbytes > MAX_MESSAGE_NBYTES:
                    writer.write(
                        frame_message(self._nack(codec.NACK_BAD_FRAME, 0))
                    )
                    break
                msg = await reader.readexactly(nbytes)
                writer.write(frame_message(self.handle_message(msg)))
                await writer.drain()
        finally:
            writer.close()

    async def serve_tcp(self, host: str = "127.0.0.1", port: int = 0):
        server = await asyncio.start_server(self._handle_conn, host, port)
        self._servers.append(server)
        return server

    async def serve_unix(self, path: str):
        server = await asyncio.start_unix_server(self._handle_conn, path)
        self._servers.append(server)
        return server

    def start_tcp_in_thread(
        self, host: str = "127.0.0.1", port: int = 0
    ) -> Tuple[str, int]:
        """Run the asyncio receiver on a daemon thread; returns the
        bound ``(host, port)``.  :meth:`stop` tears it down."""
        ready = threading.Event()
        addr: list = []

        def _run():
            loop = asyncio.new_event_loop()
            self._loop = loop
            asyncio.set_event_loop(loop)
            server = loop.run_until_complete(self.serve_tcp(host, port))
            addr.extend(server.sockets[0].getsockname()[:2])
            ready.set()
            loop.run_forever()
            server.close()
            loop.run_until_complete(server.wait_closed())
            loop.close()

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()
        if not ready.wait(timeout=10):
            raise RuntimeError("ingest server thread failed to start")
        return addr[0], addr[1]

    def stop(self) -> None:
        if self._loop is not None:
            self._loop.call_soon_threadsafe(self._loop.stop)
            if self._thread is not None:
                self._thread.join(timeout=10)
            self._loop = None
            self._thread = None
        self._servers.clear()


def _decode_status(buf: bytes) -> Dict[str, Any]:
    kind, payload = codec.decode_message(buf)
    if kind != "status":
        raise codec.WireFormatError(
            f"expected a status reply, got {kind!r}"
        )
    return payload


class Loopback:
    """In-process transport: the same framed messages, no sockets.

    ``send`` runs the full frame→reply path synchronously and returns
    the decoded :class:`~repro_torch.wire.codec.Reply` — what the trace
    replayer and the load generator drive.  ``roundtrip`` returns the
    raw encoded reply bytes (EPWR *or* EPWS), and ``status()`` performs
    the STATUS round-trip and decodes the JSON payload.
    """

    def __init__(self, ingest: IngestServer):
        self.ingest = ingest

    def roundtrip(self, msg) -> bytes:
        return self.ingest.handle_message(msg)

    def send(self, msg) -> codec.Reply:
        return codec.decode_reply(self.roundtrip(msg))

    def status(self) -> Dict[str, Any]:
        return _decode_status(
            self.roundtrip(codec.encode_control(codec.OP_STATUS, 0))
        )


class WireClient:
    """Minimal blocking socket client (producer side, tests/tools).

    :meth:`reconnect` redials the original address with bounded
    exponential backoff — the transport half of the resume story
    (:class:`ResumableSession` calls it before the RESUME handshake).
    ``sleep`` is injectable so tests can record the backoff schedule
    without waiting it out.

    ``timeout`` applies to every socket operation: a server that
    accepts the connection but stops reading or replying (wedged, not
    dead) surfaces after ``timeout`` seconds as a retriable
    ``ConnectionError`` — routing into the same reconnect/backoff path
    as a dropped connection — instead of blocking the producer forever.
    """

    def __init__(
        self,
        host: Optional[str] = None,
        port: Optional[int] = None,
        *,
        unix_path: Optional[str] = None,
        timeout: float = 10.0,
        reconnect_attempts: int = 5,
        backoff_base: float = 0.05,
        backoff_max: float = 2.0,
        sleep: Callable[[float], None] = time.sleep,
    ):
        self._host = host
        self._port = port
        self._unix_path = unix_path
        self._timeout = timeout
        self.reconnect_attempts = reconnect_attempts
        self.backoff_base = backoff_base
        self.backoff_max = backoff_max
        self._sleep = sleep
        self.n_reconnects = 0
        self.n_timeouts = 0
        self.sock = self._connect()

    def _connect(self) -> socket.socket:
        if self._unix_path is not None:
            sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            sock.settimeout(self._timeout)
            sock.connect(self._unix_path)
            return sock
        return socket.create_connection(
            (self._host, self._port), timeout=self._timeout
        )

    def reconnect(self) -> None:
        """Redial the original address; exponential backoff between
        attempts, capped at ``backoff_max``, bounded at
        ``reconnect_attempts`` tries before giving up."""
        try:
            self.sock.close()
        except OSError:
            pass
        last: Optional[BaseException] = None
        for attempt in range(max(1, self.reconnect_attempts)):
            try:
                self.sock = self._connect()
                self.n_reconnects += 1
                return
            except OSError as e:
                last = e
                self._sleep(
                    min(self.backoff_base * (2**attempt), self.backoff_max)
                )
        raise ConnectionError(
            f"reconnect failed after {self.reconnect_attempts} "
            f"attempts: {last}"
        )

    def send(self, msg: bytes) -> codec.Reply:
        return codec.decode_reply(self._roundtrip(msg))

    def status(self) -> Dict[str, Any]:
        """STATUS round-trip: the server's JSON introspection snapshot
        (see :func:`repro_torch.obs.status.collect_status`)."""
        return _decode_status(
            self._roundtrip(codec.encode_control(codec.OP_STATUS, 0))
        )

    def _roundtrip(self, msg: bytes) -> bytes:
        try:
            self.sock.sendall(frame_message(msg))
            head = self._recv_exact(LENGTH_PREFIX.size)
            (nbytes,) = LENGTH_PREFIX.unpack(head)
            return self._recv_exact(nbytes)
        except socket.timeout:
            # A wedged server (accepting but never replying) must look
            # like a dropped connection, not a hung producer.  The
            # socket may hold a half-sent or half-received message, so
            # it cannot be reused — close it; reconnect() redials.
            self.n_timeouts += 1
            try:
                self.sock.close()
            except OSError:
                pass
            raise ConnectionError(
                f"ingest server unresponsive for {self._timeout}s"
            ) from None

    def _recv_exact(self, n: int) -> bytes:
        out = b""
        while len(out) < n:
            part = self.sock.recv(n - len(out))
            if not part:
                raise ConnectionError("ingest server closed the connection")
            out += part
        return out

    def close(self) -> None:
        self.sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class ResumeError(ConnectionError):
    """A dropped wire session could not be resumed: the server refused
    the RESUME (stream unknown), or the unacked gap outgrew the
    client's bounded replay window."""


class ResumableSession:
    """Producer-side session: bounded replay window + RESUME recovery.

    Wraps any transport exposing ``send(msg) -> Reply`` (a
    :class:`WireClient`, a :class:`Loopback`, ...).  Every data frame
    is retained in a bounded deque until ACKed; when a send raises
    ``ConnectionError``/``OSError`` the session reconnects the
    transport (via ``transport.reconnect()`` when it has one — the
    :class:`WireClient` backs off exponentially), performs the RESUME
    handshake, replays the server-visible gap from the window in seq
    order, and carries on.  The server duplicate-suppresses any window
    entry it already served, so the replay is idempotent.

    ``drain`` (typically ``IngestServer.tick``) is invoked on
    backpressure NACKs to free queue space before retrying — without
    it, backpressure replies are returned to the caller as-is.

    Loss recovery beyond reconnects (all satisfied from the same
    bounded window):

    * ``NACK_SEQ_GAP`` (strict-seq server missing earlier frames): the
      reply's seq is the first missing one; the session replays exactly
      ``[reply.seq, refused_seq)`` in order, then retries the refused
      frame (``n_retransmits`` counts the replayed frames);
    * ``NACK_BAD_FRAME`` (damaged in flight): the window's pristine
      bytes are resent (``n_damage_retries``);
    * ``NACK_OUT_OF_ORDER`` on a seq this session sent: the server
      already served it (a duplicated or late-arriving copy of our own
      send) — absorbed as an ACK (``n_already_served``).  Producers
      that hand-roll seqs on a raw transport still see the NACK.

    With ``credit=N`` the session paces on credit-based flow control:
    before each fresh send it holds at least one granted credit,
    requesting ``N`` more when exhausted (a zero grant means the queue
    is full — ``drain`` is invoked and the request retried).  RESUME
    voids outstanding grants, so the balance resets on reconnect.
    """

    def __init__(
        self,
        transport,
        stream_id: int,
        *,
        window: int = 32,
        drain: Optional[Callable[[], Any]] = None,
        max_retries: int = 16,
        credit: Optional[int] = None,
    ):
        if credit is not None and credit < 1:
            raise ValueError(f"credit window must be >= 1, got {credit}")
        self.transport = transport
        self.stream_id = int(stream_id)
        self.drain = drain
        self.max_retries = max_retries
        self.credit_window = credit
        self._credits = 0
        self._window: Deque[Tuple[int, bytes]] = deque(maxlen=window)
        self.next_seq = 0
        self.last_acked = -1
        self.n_resumes = 0
        self.n_replayed = 0
        self.n_retransmits = 0
        self.n_damage_retries = 0
        self.n_already_served = 0
        self.n_credit_requests = 0
        self.n_credit_waits = 0

    @property
    def unacked(self) -> Tuple[int, ...]:
        """Seqs still in the window and not yet ACKed."""
        return tuple(s for s, _ in self._window if s > self.last_acked)

    def open(self) -> codec.Reply:
        return self.transport.send(
            codec.encode_control(codec.OP_OPEN, self.stream_id)
        )

    def close(self) -> codec.Reply:
        return self.transport.send(
            codec.encode_control(codec.OP_CLOSE, self.stream_id)
        )

    def send_chunk(self, chunk, *, timestamp_ns: int = 0) -> codec.Reply:
        if self.credit_window is not None:
            self._ensure_credit()
        seq = self.next_seq
        self.next_seq += 1
        msg = codec.encode_chunk(
            chunk,
            stream_id=self.stream_id,
            seq=seq,
            timestamp_ns=timestamp_ns,
        )
        self._window.append((seq, msg))
        reply = self._deliver(seq, msg)
        if self.credit_window is not None and reply.ok:
            self._credits = max(0, self._credits - 1)
        return reply

    def _ensure_credit(self) -> None:
        """Block (draining) until at least one granted credit is held."""
        for _ in range(self.max_retries):
            if self._credits > 0:
                return
            try:
                reply = self.transport.send(
                    codec.encode_credit(self.stream_id, self.credit_window)
                )
            except (ConnectionError, OSError):
                self.resume()  # zeroes the balance; re-request below
                continue
            self.n_credit_requests += 1
            if not reply.ok:
                raise ResumeError(
                    f"stream {self.stream_id}: CREDIT refused "
                    f"({reply.status_name})"
                )
            if reply.seq > 0:
                self._credits += reply.seq
                return
            # Zero grant: the stream's queue is full.  A serving tick
            # frees space; without a drain hook there is nothing to
            # wait on, so surface the starvation.
            self.n_credit_waits += 1
            if self.drain is None:
                raise ResumeError(
                    f"stream {self.stream_id}: zero credit granted and "
                    f"no drain hook to free queue space"
                )
            self.drain()
        raise ResumeError(
            f"stream {self.stream_id}: credit starved after "
            f"{self.max_retries} requests"
        )

    def _deliver(self, seq: int, msg: bytes) -> codec.Reply:
        for _ in range(self.max_retries):
            try:
                reply = self.transport.send(msg)
            except (ConnectionError, OSError):
                self.resume()
                if self.last_acked >= seq:
                    # The replay already covered this frame; synthesize
                    # the ACK the dropped connection swallowed.
                    return codec.Reply(codec.ACK, self.stream_id, seq)
                continue
            if reply.ok:
                self.last_acked = max(self.last_acked, seq)
                return reply
            if (
                reply.status == codec.NACK_BACKPRESSURE
                and self.drain is not None
            ):
                self.drain()
                continue
            if reply.status == codec.NACK_SEQ_GAP:
                # Selective retransmit: the server is missing exactly
                # [reply.seq, seq) — replay that slice, retry this one.
                self._retransmit(reply.seq, seq)
                continue
            if reply.status == codec.NACK_BAD_FRAME:
                # Damaged in flight; the window holds pristine bytes.
                self.n_damage_retries += 1
                continue
            if reply.status == codec.NACK_OUT_OF_ORDER:
                # A duplicated/late copy of our own send already served
                # this seq: the NACK is the server's duplicate signal.
                self.n_already_served += 1
                self.last_acked = max(self.last_acked, seq)
                return codec.Reply(codec.ACK, self.stream_id, seq)
            return reply
        raise ResumeError(
            f"stream {self.stream_id}: seq {seq} undeliverable after "
            f"{self.max_retries} attempts"
        )

    def _retransmit(self, first_missing: int, upto_seq: int) -> None:
        """Replay the ``[first_missing, upto_seq)`` slice the server
        reported missing, in seq order, from the bounded window."""
        gap = [
            (s, m) for s, m in self._window
            if first_missing <= s < upto_seq
        ]
        if not gap or gap[0][0] != first_missing:
            have = gap[0][0] if gap else upto_seq
            raise ResumeError(
                f"stream {self.stream_id}: server is missing seqs from "
                f"{first_missing} but the replay window starts at "
                f"{have} — the loss outlived the "
                f"{self._window.maxlen}-frame window"
            )
        for s, m in gap:
            self._replay_one(s, m)
        self.n_retransmits += len(gap)

    def resume(self) -> int:
        """Reconnect + RESUME handshake + replay the gap the server
        reports, in seq order.  Returns the number of frames replayed.

        Raises :class:`ResumeError` if the server refuses (the stream
        is unknown — evicted while disconnected) or if the server's
        next-expected seq has already rolled out of the bounded window.
        """
        if hasattr(self.transport, "reconnect"):
            self.transport.reconnect()
        # RESUME voids any credit granted on the dropped connection.
        self._credits = 0
        reply = self.transport.send(
            codec.encode_resume(self.stream_id, self.last_acked)
        )
        if not reply.ok:
            raise ResumeError(
                f"stream {self.stream_id}: RESUME refused "
                f"({reply.status_name})"
            )
        next_expected = reply.seq
        self.n_resumes += 1
        if next_expected >= self.next_seq:
            return 0  # server is fully caught up; nothing to replay
        gap = [(s, m) for s, m in self._window if s >= next_expected]
        if not gap or gap[0][0] != next_expected:
            have = gap[0][0] if gap else self.next_seq
            raise ResumeError(
                f"stream {self.stream_id}: server resumes at seq "
                f"{next_expected} but the replay window starts at "
                f"{have} — the gap outlived the "
                f"{self._window.maxlen}-frame window"
            )
        for s, m in gap:
            self._replay_one(s, m)
        self.n_replayed += len(gap)
        return len(gap)

    def _replay_one(self, seq: int, msg: bytes) -> codec.Reply:
        for _ in range(self.max_retries):
            reply = self.transport.send(msg)
            if reply.ok:
                self.last_acked = max(self.last_acked, seq)
                return reply
            if (
                reply.status == codec.NACK_BACKPRESSURE
                and self.drain is not None
            ):
                self.drain()
                continue
            if reply.status == codec.NACK_SEQ_GAP:
                # The replayed frame itself was lost in flight and a
                # later one arrived first: recover the nested gap.
                self._retransmit(reply.seq, seq)
                continue
            if reply.status == codec.NACK_BAD_FRAME:
                self.n_damage_retries += 1
                continue
            if reply.status == codec.NACK_OUT_OF_ORDER:
                # A late copy already served it; the replay is done.
                self.n_already_served += 1
                self.last_acked = max(self.last_acked, seq)
                return codec.Reply(codec.ACK, self.stream_id, seq)
            raise ResumeError(
                f"stream {self.stream_id}: replay of seq {seq} refused "
                f"({reply.status_name})"
            )
        raise ResumeError(
            f"stream {self.stream_id}: replay of seq {seq} still "
            f"backpressured after {self.max_retries} drains"
        )
