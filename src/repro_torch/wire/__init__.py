"""repro_torch.wire — the network ingest frontier (port of ``repro.wire``).

Everything between a glasses sensor stack and the serving runtime's
per-stream :class:`~repro_torch.serve.ingest.ChunkQueue`:

  encode_chunk, decode_frame, WireFrame,
  encode_control, encode_reply, decode_reply,
  WireFormatError, WireCRCError           (codec)    versioned zero-copy
                                                     binary SensorChunk
                                                     format + session
                                                     control / ACK-NACK
                                                     reply structs
  IngestServer, Loopback, WireClient,
  ResumableSession, ResumeError           (server)   framed-message demux
                                                     into StreamServer
                                                     queues (asyncio
                                                     TCP/Unix + loopback),
                                                     backpressure as NACKs,
                                                     RESUME reconnect with
                                                     windowed gap replay
  TraceWriter, TraceReader, TraceRecord,
  record_session, record_streams, replay  (trace)    append-only .wtrace
                                                     record / playback
                                                     (as-fast-as-possible,
                                                     original-timestamp, or
                                                     multi-stream with tick
                                                     boundaries preserved)
  FaultyTransport, FaultPlan              (fault)    seeded lossy-link
                                                     injector: drop / dup /
                                                     reorder / corrupt /
                                                     truncate on a
                                                     deterministic schedule
  LoadConfig, LoadGen, run_load           (loadgen)  seeded Poisson /
                                                     log-normal synthetic
                                                     traffic driver
  LatencyHistogram, LatencyRecorder       (latency)  enqueue→readback
                                                     latency percentiles +
                                                     backpressure counts

The codec and latency modules are host-side (torch CPU tensors, numpy,
stdlib); the server/loadgen layers import :mod:`repro_torch.serve`.
Lazy loading keeps ``import repro_torch.wire`` cheap for codec-only users
(trace tooling, off-box analysis).
"""

from __future__ import annotations

_LAZY = {
    "WIRE_VERSION": "repro_torch.wire.codec",
    "WireFormatError": "repro_torch.wire.codec",
    "WireCRCError": "repro_torch.wire.codec",
    "WireFrame": "repro_torch.wire.codec",
    "ControlFrame": "repro_torch.wire.codec",
    "Reply": "repro_torch.wire.codec",
    "encode_chunk": "repro_torch.wire.codec",
    "decode_frame": "repro_torch.wire.codec",
    "encode_control": "repro_torch.wire.codec",
    "decode_control": "repro_torch.wire.codec",
    "encode_resume": "repro_torch.wire.codec",
    "encode_credit": "repro_torch.wire.codec",
    "encode_reply": "repro_torch.wire.codec",
    "decode_reply": "repro_torch.wire.codec",
    "decode_message": "repro_torch.wire.codec",
    "STATUS_REASONS": "repro_torch.wire.codec",
    "IngestServer": "repro_torch.wire.server",
    "Loopback": "repro_torch.wire.server",
    "WireClient": "repro_torch.wire.server",
    "ResumableSession": "repro_torch.wire.server",
    "ResumeError": "repro_torch.wire.server",
    "TraceWriter": "repro_torch.wire.trace",
    "TraceReader": "repro_torch.wire.trace",
    "TraceRecord": "repro_torch.wire.trace",
    "record_session": "repro_torch.wire.trace",
    "record_streams": "repro_torch.wire.trace",
    "replay": "repro_torch.wire.trace",
    "FaultyTransport": "repro_torch.wire.fault",
    "FaultPlan": "repro_torch.wire.fault",
    "LoadConfig": "repro_torch.wire.loadgen",
    "LoadGen": "repro_torch.wire.loadgen",
    "run_load": "repro_torch.wire.loadgen",
    "LatencyHistogram": "repro_torch.wire.latency",
    "LatencyRecorder": "repro_torch.wire.latency",
}

__all__ = list(_LAZY)


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)
