"""Seeded synthetic traffic: Poisson arrivals, heavy-tailed sessions (port
of ``repro.wire.loadgen``: the same draws from the same numpy generator,
so the same event log for the same config).

Models the traffic a perception server actually meets (the "full
system" argument: transport and traffic, not just the kernel):

* **session arrivals** per tick are Poisson with mean
  ``arrival_rate`` — glasses coming online independently;
* **session lengths** (in chunks) are log-normal
  (``exp(N(mu, sigma))``) — a heavy tail of long-lived wearers over a
  mass of short sessions;
* **bursts**: every ``burst_every``-th tick multiplies both the
  arrival rate and the per-session send count by ``burst_factor`` —
  the synchronized-activity spikes that exercise queue backpressure.

Everything is drawn from one seeded ``numpy`` generator, and the
server's tick loop consumes queues deterministically, so a fixed
``(seed, config, payload bank, server config)`` reproduces the exact
event sequence — admissions, NACKs, evictions, per-session chunk
counts — run after run (pinned in ``tests/test_torch_wire.py``).  Only the
latency *timings* vary; their sample counts do not.

The generator drives an :class:`~repro_torch.wire.server.IngestServer`
through its loopback transport with real encoded wire frames (payloads
drawn round-robin from a pre-rendered chunk bank), so the measured path
is codec → demux → queue → pool step, end to end.

Pass a ``trace_writer`` (a :class:`~repro_torch.wire.trace.TraceWriter`) to
record every message the generator sends — OPENs, data frames, CLOSEs,
in their exact interleaved order, each stamped with the logical-tick
timestamp ``tick * chunk_period_ns``.  Replaying that trace through a
fresh ingest server with ``on_advance=ingest.tick`` (see
:func:`repro_torch.wire.trace.replay`) reproduces the original multi-stream
run bit-exactly: same admissions, same NACKs, same per-stream state.
"""

from __future__ import annotations

import hashlib
import math
import time
from typing import Dict, List, NamedTuple, Sequence

import numpy as np

from repro_torch.api.types import SensorChunk
from repro_torch.wire import codec
from repro_torch.wire.latency import LatencyHistogram
from repro_torch.wire.server import IngestServer, Loopback


class LoadConfig(NamedTuple):
    """Shape of one synthetic load run (all knobs deterministic)."""

    seed: int = 0
    ticks: int = 32
    arrival_rate: float = 0.75  # mean new sessions per tick (Poisson)
    session_len_mu: float = 1.5  # log-normal of session length, chunks
    session_len_sigma: float = 0.6
    burst_factor: float = 1.0  # ≥ 1; multiplies arrivals + sends
    burst_every: int = 0  # 0 = no bursts
    submit_per_tick: int = 1  # data frames per live session per tick
    chunk_period_ns: int = 33_333_333  # producer timestamp spacing


class LoadGen:
    """Drive an ingest server with seeded synthetic wire traffic."""

    def __init__(
        self,
        cfg: LoadConfig,
        bank: Sequence[SensorChunk],
        ingest: IngestServer,
        *,
        trace_writer=None,
    ):
        if not bank:
            raise ValueError("payload bank is empty")
        if cfg.burst_factor < 1.0:
            raise ValueError(
                f"burst_factor must be >= 1, got {cfg.burst_factor}"
            )
        self.cfg = cfg
        self.ingest = ingest
        self.loop = Loopback(ingest)
        #: Optional TraceWriter: every sent message is appended with
        #: the logical-tick timestamp before it goes on the wire.
        self.trace_writer = trace_writer
        # Pre-encode the payload bank once: the generator measures the
        # server, so per-send work is one header re-pack + a join, not
        # a fresh host copy + CRC of megabytes of pixels per frame.
        self._bank = []
        for c in bank:
            enc = codec.encode_chunk(c, stream_id=0, seq=0, timestamp_ns=0)
            _, _, flags, _, _, _, crc, _ = codec.FRAME_HEADER.unpack(
                enc[: codec.FRAME_HEADER.size]
            )
            table = enc[codec.FRAME_HEADER.size : codec.DATA_HEADER_NBYTES]
            payload = enc[codec.DATA_HEADER_NBYTES :]
            self._bank.append((flags, crc, table, payload))
        self.rng = np.random.default_rng(cfg.seed)
        self.n_sessions = 0
        self.live: Dict[int, List[int]] = {}  # sid -> [length, sent, offset]
        self.event_log: List[tuple] = []
        self.counters: Dict[str, int] = {
            "n_arrivals": 0,
            "n_admitted": 0,
            "n_rejected": 0,
            "n_frames_sent": 0,
            "n_frames_acked": 0,
            "n_closed": 0,
        }
        self.nack_counts: Dict[str, int] = {}
        #: Client-side enqueue→ACK round-trip latency over every sent
        #: message (the producer's view; the server's recorder sees the
        #: queue_wait/service split).  Wall-clock — the sample *counts*
        #: are deterministic, the timings are not.
        self.rtt = LatencyHistogram()

    # -- wire encoding (header re-stamp over the cached payload) ------------

    def _frame(self, sid: int, seq: int, tick: int) -> bytes:
        flags, crc, table, payload = self._bank[
            (self.live[sid][2] + seq) % len(self._bank)
        ]
        header = codec.FRAME_HEADER.pack(
            codec.DATA_MAGIC,
            codec.WIRE_VERSION,
            flags,
            sid,
            seq,
            tick * self.cfg.chunk_period_ns,
            crc,
            len(payload),
        )
        return header + table + payload

    def _session_length(self) -> int:
        n = self.rng.lognormal(
            self.cfg.session_len_mu, self.cfg.session_len_sigma
        )
        return max(1, int(round(n)))

    def _send(self, msg: bytes, tick: int) -> codec.Reply:
        """Send one message, recording it first when tracing."""
        if self.trace_writer is not None:
            self.trace_writer.append(
                msg, timestamp_ns=tick * self.cfg.chunk_period_ns
            )
        t0 = time.perf_counter()
        reply = self.loop.send(msg)
        self.rtt.record(time.perf_counter() - t0)
        return reply

    def _count_nack(self, reply: codec.Reply) -> None:
        if not reply.ok:
            self.nack_counts[reply.status_name] = (
                self.nack_counts.get(reply.status_name, 0) + 1
            )

    # -- the drive loop ------------------------------------------------------

    def run(self) -> Dict:
        cfg = self.cfg
        for t in range(cfg.ticks):
            burst = bool(cfg.burst_every) and t % cfg.burst_every == 0
            boost = cfg.burst_factor if burst else 1.0

            n_new = int(self.rng.poisson(cfg.arrival_rate * boost))
            self.counters["n_arrivals"] += n_new
            for _ in range(n_new):
                sid = self.n_sessions
                self.n_sessions += 1
                reply = self._send(
                    codec.encode_control(codec.OP_OPEN, sid), t
                )
                if reply.ok:
                    self.live[sid] = [
                        self._session_length(),
                        0,
                        sid % len(self._bank),
                    ]
                    self.counters["n_admitted"] += 1
                else:
                    self._count_nack(reply)
                    self.counters["n_rejected"] += 1

            n_send = max(1, int(math.ceil(cfg.submit_per_tick * boost)))
            tick_sent = tick_acked = 0
            for sid in list(self.live):
                length, sent, _ = self.live[sid]
                for _ in range(min(n_send, length - sent)):
                    reply = self._send(
                        self._frame(sid, self.live[sid][1], t), t
                    )
                    tick_sent += 1
                    self.counters["n_frames_sent"] += 1
                    if reply.ok:
                        self.live[sid][1] += 1
                        tick_acked += 1
                        self.counters["n_frames_acked"] += 1
                    else:
                        self._count_nack(reply)
                        break  # backpressure: yield until the next tick

            closes = []
            for sid in list(self.live):
                length, sent, _ = self.live[sid]
                if sent >= length:
                    reply = self._send(
                        codec.encode_control(codec.OP_CLOSE, sid), t
                    )
                    self._count_nack(reply)
                    del self.live[sid]
                    closes.append(sid)
                    self.counters["n_closed"] += 1

            self.ingest.tick()
            # Server-side eviction (idle/LRU) can race our bookkeeping:
            # drop local sessions the serving layer let go.
            live_now = set(self.ingest.srv.live_sessions)
            for sid in [s for s in self.live if s not in live_now]:
                del self.live[sid]
            self.event_log.append((t, n_new, tick_sent, tick_acked,
                                   tuple(closes)))
        return self.summary()

    def summary(self) -> Dict:
        digest = hashlib.sha256(
            repr(self.event_log).encode()
        ).hexdigest()[:16]
        return {
            **self.counters,
            "nacks": dict(sorted(self.nack_counts.items())),
            "n_sessions": self.n_sessions,
            "n_live_at_end": len(self.live),
            "event_log_sha": digest,
            # Wall-clock percentiles live under their own key so the
            # deterministic remainder still compares `==` across runs
            # (tests pop "rtt" before comparing; its count is pinned).
            "rtt": self.rtt.summary(),
        }


def run_load(
    ingest: IngestServer,
    bank: Sequence[SensorChunk],
    cfg: LoadConfig,
) -> Dict:
    """One-call convenience: build a :class:`LoadGen`, run it, return
    the deterministic summary (latency lives on the server's attached
    recorder, if any)."""
    return LoadGen(cfg, bank, ingest).run()
