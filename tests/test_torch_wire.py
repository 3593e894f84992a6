"""The wire ingest frontier of the PyTorch port (``repro_torch.wire``), held
to the JAX package's ``repro.wire`` on the CPU.

The same numpy chunks (rendered by the port from a seed, 64x64, chunks of
8) go through both packages.  Held:

* the codec: the bytes of every message kind and every dtype code
  (bfloat16 included) identical in both directions, and truncation, CRC,
  magic, version and table errors raised alike;
* the ingest protocol: one message sequence per scenario (OPEN/CLOSE as
  admit/evict, backpressure, pool full, out of order, strict-seq gaps,
  RESUME, credit, STATUS) through both ``IngestServer``s gives the same
  reply bytes, message by message, and the same counters;
* replay: a ``.wtrace`` recorded by the reference, replayed into the port
  with ``on_advance=tick``, gives the same reply bytes and STATUS JSON,
  and per-stream state with integers exact and floats within
  ``_torch_parity.FLOAT_ATOL``; the same for one trace's frames sent
  through ``FaultyTransport`` and ``ResumableSession``;
* schedules: the ``LoadGen`` event-log digest, ``FaultPlan`` actions and
  ``FaultyTransport`` deliveries equal the reference's for one seed;
* the port alone, as ``tests/test_wire.py``: loopback, TCP and Unix
  sockets (ticks on another thread) bitwise equal to solo sessions,
  reconnect backoff, a wedged server's timeout, and a backpressured
  submit that copies nothing.

Fixed seeds only; no ``@given``.
"""

import asyncio
import functools
import json
import socket
import threading
import zlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from _torch_parity import FLOAT_ATOL, assert_leaves_match
from repro import api as japi
from repro import serve as jserve
from repro.core import pipeline as jP
from repro.runtime import fault as jrfault
from repro.wire import codec as jcodec
from repro.wire import fault as jfault
from repro.wire import latency as jlatency
from repro.wire import loadgen as jloadgen
from repro.wire import server as jserver
from repro.wire import trace as jtrace
from repro_torch import api
from repro_torch import serve
from repro_torch.core import pipeline as P
from repro_torch.data import synthetic as SYN
from repro_torch.runtime import fault as rfault
from repro_torch.wire import codec, fault, latency, loadgen, server, trace

FRAME = 64
PATCH = 16
CHUNK = 8

REF = SimpleNamespace(
    name="ref", api=japi, P=jP, serve=jserve, codec=jcodec, server=jserver,
    trace=jtrace, fault=jfault, loadgen=jloadgen, rfault=jrfault,
    comp_kw={},
)
PORT = SimpleNamespace(
    name="port", api=api, P=P, serve=serve, codec=codec, server=server,
    trace=trace, fault=fault, loadgen=loadgen, rfault=rfault,
    comp_kw={"device": "cpu"},
)


def _comp(pkg, **kw):
    base = dict(frame_hw=(FRAME, FRAME), patch=PATCH, capacity=32,
                tau=0.10, gamma=0.015, theta=8, window=16)
    base.update(kw)
    return pkg.api.EPICCompressor(pkg.P.EPICConfig(**base), **pkg.comp_kw)


def _wire(pkg, *, capacity=2, queue_depth=2, k_ladder=None,
          strict_seq=False, **kw):
    srv = pkg.serve.StreamServer(
        _comp(pkg, prefilter_k=8 if k_ladder else 0),
        pkg.serve.ServerConfig(capacity=capacity, chunk_frames=CHUNK,
                               queue_depth=queue_depth, k_ladder=k_ladder,
                               **kw),
    )
    ingest = pkg.server.IngestServer(srv, strict_seq=strict_seq)
    return srv, ingest, pkg.server.Loopback(ingest)


@functools.lru_cache(maxsize=None)
def _stream_np(seed, n_frames=16, n_obj=4):
    s, _ = SYN.generate_stream(
        np.random.default_rng(seed),
        SYN.StreamConfig(n_frames=n_frames, hw=(FRAME, FRAME), n_obj=n_obj),
        device="cpu",
    )
    return tuple(x.numpy() for x in (s.frames, s.poses, s.gazes, s.depth))


def _chunks(pkg, seed, n_frames=16, n_obj=4):
    """numpy chunks of one port-rendered stream, as ``pkg``'s SensorChunk."""
    s = _stream_np(seed, n_frames, n_obj)
    return [pkg.api.SensorChunk(*(x[lo:lo + CHUNK] for x in s))
            for lo in range(0, n_frames - CHUNK + 1, CHUNK)]


def _solo(chunks):
    comp = _comp(PORT)
    state = comp.init()
    for c in chunks:
        state, _ = comp.step(state, api.SensorChunk(
            *(torch.from_numpy(np.array(x)) for x in c)))
    return state


def _assert_bitwise(a, b, msg=""):
    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    assert len(la) == len(lb), msg
    for i, (x, y) in enumerate(zip(la, lb)):
        assert torch.equal(x, y), f"{msg} leaf {i}"


def _assert_state_matches_ref(ref_state, port_state, what):
    assert_leaves_match(jax.tree.leaves(ref_state),
                        pytree.tree_leaves(port_state), atol=FLOAT_ATOL,
                        what=what)


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16))


def _arrays(dtype, t=2, h=5, w=3, with_depth=True, seed=0):
    """numpy field arrays of one dtype name (bfloat16 as ml_dtypes)."""
    rng = np.random.default_rng(seed)

    def arr(shape):
        a = rng.standard_normal(shape) * 100
        if dtype == "bfloat16":
            return _bf16(a.astype(np.float32))
        if dtype == "bool":
            return a > 0
        return a.astype(dtype)

    return [arr((t, h, w, 3)), arr((t, 4, 4)), arr((t, 2)),
            arr((t, h, w)) if with_depth else None]


def _as_tensor(a):
    if a is None:
        return None
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _field_bytes(x):
    if isinstance(x, torch.Tensor):
        return x.reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(x).tobytes()


# ---------------------------------------------------------------------------
# Codec


DTYPES = ["uint8", "int8", "uint16", "int16", "uint32", "int32", "uint64",
          "int64", "float16", "float32", "float64", "bool", "bfloat16"]


@pytest.mark.parametrize("with_depth", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
def test_data_frames_are_the_references_bytes(dtype, with_depth):
    fields = _arrays(dtype, with_depth=with_depth, seed=DTYPES.index(dtype))
    kw = dict(stream_id=2**63 + 5, seq=2**40 + 1, timestamp_ns=17)
    want = jcodec.encode_chunk(japi.SensorChunk(*fields), **kw)
    assert codec.encode_chunk(api.SensorChunk(*fields), **kw) == want
    tensors = api.SensorChunk(*(_as_tensor(a) for a in fields))
    assert codec.encode_chunk(tensors, **kw) == want
    # each package decodes the other's bytes to the same values
    back = codec.decode_frame(want)
    assert (back.stream_id, back.seq, back.timestamp_ns) == (
        kw["stream_id"], kw["seq"], 17)
    for a, b in zip(jcodec.decode_frame(want).chunk, back.chunk):
        assert (a is None) == (b is None)
        if a is not None:
            assert tuple(a.shape) == tuple(b.shape)
            assert _field_bytes(a) == _field_bytes(b)
    if dtype == "bfloat16":
        assert back.chunk.frames.dtype == torch.bfloat16


def test_decode_is_zero_copy():
    buf = codec.encode_chunk(api.SensorChunk(*_arrays("float32")),
                             stream_id=1, seq=0, timestamp_ns=0)
    frame = codec.decode_frame(buf)
    raw = torch.frombuffer(bytearray(buf), dtype=torch.uint8)
    lo = np.frombuffer(buf, np.uint8).ctypes.data
    for field in frame.chunk:
        start = field.data_ptr() - lo
        assert 0 <= start < len(buf), "field is not a view of the buffer"
    assert raw.numel() == len(buf)


def test_card_tensors_encode_with_their_bytes():
    """Encoding fetches tensors to the host; a non-contiguous CPU tensor
    encodes as its contiguous copy would."""
    fields = _arrays("float32", t=3)
    t = torch.from_numpy(fields[0].copy()).transpose(1, 2).contiguous() \
        .transpose(1, 2)  # same values, permuted strides
    assert not t.is_contiguous()
    a = codec.encode_chunk(api.SensorChunk(t, *map(_as_tensor, fields[1:])),
                           stream_id=1, seq=0, timestamp_ns=0)
    b = jcodec.encode_chunk(japi.SensorChunk(*fields), stream_id=1, seq=0,
                            timestamp_ns=0)
    assert a == b


def _good(seed=5, dtype="float32", with_depth=False):
    return jcodec.encode_chunk(
        japi.SensorChunk(*_arrays(dtype, with_depth=with_depth, seed=seed)),
        stream_id=1, seq=0, timestamp_ns=0,
    )


def _bad_frames():
    good = _good()
    cases = {f"truncated_{cut}": good[:cut] for cut in (
        0, 3, jcodec.FRAME_HEADER.size - 1, jcodec.DATA_HEADER_NBYTES - 1,
        len(good) - 1)}
    flip = bytearray(good)
    flip[-1] ^= 1
    cases["crc"] = bytes(flip)
    cases["magic"] = b"XXXX" + good[4:]
    cases["version"] = good[:4] + b"\x63\x00" + good[6:]
    code = bytearray(good)
    code[jcodec.FRAME_HEADER.size] = 250
    cases["dtype_code"] = bytes(code)
    dim = bytearray(good)
    off = jcodec.FRAME_HEADER.size + 2
    dim[off:off + 4] = (1 << 20).to_bytes(4, "little")
    cases["overrun"] = bytes(dim)
    ndim = bytearray(good)
    ndim[jcodec.FRAME_HEADER.size + 1] = 7
    cases["ndim"] = bytes(ndim)
    # trailing payload bytes beyond the field table (CRC kept valid)
    frames, poses, gazes = (np.zeros((2, 4, 4, 3), np.float32),
                            np.zeros((2, 4, 4), np.float32),
                            np.zeros((2, 2), np.float32))
    table = b"".join(
        jcodec.FIELD_SLOT.pack(9, a.ndim, *a.shape, *([0] * (6 - a.ndim)))
        for a in (frames, poses, gazes)
    ) + jcodec.FIELD_SLOT.pack(0, 0, 0, 0, 0, 0, 0, 0)
    for name, poses_rows, extra in (("trailing", 2, b"\0" * 4),
                                    ("leading_axis", 3, b"")):
        p = np.zeros((poses_rows, 4, 4), np.float32)
        payload = frames.tobytes() + p.tobytes() + gazes.tobytes() + extra
        t = table if poses_rows == 2 else b"".join(
            jcodec.FIELD_SLOT.pack(9, a.ndim, *a.shape,
                                   *([0] * (6 - a.ndim)))
            for a in (frames, p, gazes)
        ) + jcodec.FIELD_SLOT.pack(0, 0, 0, 0, 0, 0, 0, 0)
        header = jcodec.FRAME_HEADER.pack(
            jcodec.DATA_MAGIC, jcodec.WIRE_VERSION, 0, 1, 0, 0,
            zlib.crc32(payload), len(payload))
        cases[name] = header + t + payload
    return cases


BAD = _bad_frames()


def _raised(fn, *args, **kw):
    try:
        fn(*args, **kw)
    except Exception as e:  # the error is the result under comparison
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("case", sorted(BAD))
def test_decode_errors_are_the_references(case):
    want = _raised(jcodec.decode_frame, BAD[case])
    assert want is not None
    assert _raised(codec.decode_frame, BAD[case]) == want
    assert _raised(codec.decode_message, BAD[case]) == _raised(
        jcodec.decode_message, BAD[case])
    if case == "crc":
        frame = codec.decode_frame(BAD[case], verify_crc=False)
        assert tuple(frame.chunk.frames.shape) == (2, 5, 3, 3)


def _control_messages(c):
    out = [c.encode_control(op, 77) for op in (c.OP_OPEN, c.OP_CLOSE,
                                               c.OP_STATUS)]
    out += [c.encode_resume(9, -1), c.encode_resume(9, 41),
            c.encode_credit(3, 5)]
    out += [c.encode_reply(s, 2**64 - 1, 3) for s in c.STATUS_NAMES]
    out.append(c.encode_status_reply({"b": [1, 2.5, None], "a": "é"}))
    return out


def test_control_reply_and_status_bytes_are_the_references():
    want, got = _control_messages(jcodec), _control_messages(codec)
    assert got == want
    for msg in want:
        kind, a = jcodec.decode_message(msg)
        kind2, b = codec.decode_message(msg)
        assert kind2 == kind and tuple(b) == tuple(a) if kind != "status" \
            else b == a
    assert codec.STATUS_REASONS == jcodec.STATUS_REASONS
    assert codec.STATUS_NAMES == jcodec.STATUS_NAMES
    assert codec.frame_nbytes(_good()) == jcodec.frame_nbytes(_good())


@pytest.mark.parametrize("call", [
    ("encode_control", (3, 9)), ("encode_control", (4, 9)),
    ("encode_control", (99, 9)), ("encode_resume", (9, -2)),
    ("encode_credit", (9, 0)), ("decode_control", (b"EPWC\x01\x00",)),
    ("decode_control", (b"EPWC\x01\x00\x03\x00" + bytes(8),)),
    ("decode_reply", (b"EPWR",)), ("decode_status_reply", (b"EPWS" + bytes(
        12),)), ("frame_nbytes", (b"EPWF",)),
    ("decode_message", (b"JUNKJUNKJUNK",)),
    ("encode_chunk", (None,)),
], ids=lambda c: c if isinstance(c, str) else "")
def test_codec_call_errors_are_the_references(call):
    name, args = call
    if name == "encode_chunk":
        fields = _arrays("float32")
        fields[0] = fields[0].astype(np.complex64)
        want = _raised(jcodec.encode_chunk, japi.SensorChunk(*fields),
                       stream_id=0, seq=0, timestamp_ns=0)
        got = _raised(codec.encode_chunk, api.SensorChunk(*fields),
                      stream_id=0, seq=0, timestamp_ns=0)
        assert want[0] == got[0] == "WireFormatError"
        assert "complex64" in got[1]
        return
    want = _raised(getattr(jcodec, name), *args)
    assert want is not None
    assert _raised(getattr(codec, name), *args) == want


# ---------------------------------------------------------------------------
# Latency histograms


def test_latency_histograms_match_the_reference():
    rng = np.random.default_rng(0)
    samples = np.exp(rng.uniform(np.log(1e-6), np.log(200.0), 500))
    ref, port = jlatency.LatencyRecorder(), latency.LatencyRecorder()
    for i in range(0, 498, 3):
        ref.observe(*samples[i:i + 3])
        port.observe(*samples[i:i + 3])
    assert port.summary() == ref.summary()
    merged = latency.merge_recorders([port, port])
    assert merged.summary() == jlatency.merge_recorders([ref, ref]).summary()
    h, jh = latency.LatencyHistogram(), jlatency.LatencyHistogram()
    assert h.summary() == jh.summary() or (
        json.dumps(h.summary()) == json.dumps(jh.summary()))


# ---------------------------------------------------------------------------
# The ingest protocol: reply bytes message by message


def _scenario(pkg, name):
    """Run one scripted message sequence; returns ``(reply bytes,
    counters, server counters)``."""
    c = pkg.codec
    strict = name in ("strict_gap", "selective")
    cap = 1 if name in ("backpressure", "backpressure_retry") else 2
    srv, ingest, loop = _wire(pkg, capacity=cap, strict_seq=strict,
                              queue_depth=2)
    chunk = _chunks(pkg, 0)[0]
    out = []

    def send(msg):
        out.append(loop.roundtrip(msg))

    def data(sid, seq):
        send(c.encode_chunk(chunk, stream_id=sid, seq=seq, timestamp_ns=seq))

    send(c.encode_control(c.OP_OPEN, 1))
    if name == "open_submit_close":
        send(c.encode_control(c.OP_OPEN, 1))  # duplicate
        data(1, 0)
        data(9, 0)  # unknown stream
        send(b"garbage")
        send(c.encode_control(c.OP_CLOSE, 1))  # drains, then evicts
        send(c.encode_control(c.OP_CLOSE, 1))
    elif name == "backpressure":
        send(c.encode_control(c.OP_OPEN, 2))  # pool full
        for seq in range(3):
            data(1, seq)
    elif name == "backpressure_retry":
        for seq in range(3):
            data(1, seq)
        srv.tick()
        data(1, 2)
    elif name == "out_of_order":
        data(1, 0)
        data(1, 0)
        srv.tick()
        data(1, 5)
        srv.tick()
        data(1, 3)
        data(1, 9)
    elif name == "lax_gaps":
        data(1, 2)
        ingest.tick()
        data(1, 6)
    elif name == "strict_gap":
        data(1, 0)
        data(1, 2)
        for seq in (1, 2):
            ingest.tick()
            data(1, seq)
    elif name == "selective":
        data(1, 2)
        data(1, 0)
        data(1, 3)
    elif name == "resume":
        for seq in range(3):
            data(1, seq)
            ingest.tick()
        send(c.encode_resume(1, 0))
        data(1, 1)
        data(1, 2)
        data(1, 4)
        data(1, 3)
        send(c.encode_resume(404, 7))
    elif name == "resume_adopts":
        srv.admit(8)
        send(c.encode_resume(8, 4))
        data(8, 5)
    elif name == "credit":
        send(c.encode_credit(1, 5))  # headroom 2
        send(c.encode_credit(1, 5))  # all outstanding: zero grant
        data(1, 0)
        send(c.encode_credit(1, 1))
        send(c.encode_credit(404, 1))
        send(c.encode_resume(1, 0))  # voids the grants
        send(c.encode_credit(1, 9))
        send(c.encode_control(c.OP_CLOSE, 1))
        send(c.encode_control(c.OP_STATUS, 0))
    elif name == "idle_eviction":
        pass
    counters = ingest.counters()
    return out, counters, srv.server_counters()


SCENARIOS = ["open_submit_close", "backpressure", "backpressure_retry",
             "out_of_order", "lax_gaps", "strict_gap", "selective",
             "resume", "resume_adopts", "credit"]


@pytest.mark.parametrize("name", SCENARIOS)
def test_protocol_replies_are_the_references(name):
    want, want_c, want_s = _scenario(REF, name)
    got, got_c, got_s = _scenario(PORT, name)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(want, got)):
        assert b == a, (i, jcodec.decode_message(a), codec.decode_message(b))
    assert got_c == want_c
    assert got_s == want_s


@pytest.mark.parametrize("ladder", [None, (8, 16, 32)], ids=["fixed_k",
                                                            "k_ladder"])
def test_loopback_serving_equals_solo_sessions(ladder):
    chunks = {sid: _chunks(PORT, sid, n_frames=24, n_obj=5)
              for sid in (1, 2)}
    srv, ingest, loop = _wire(PORT, capacity=2, k_ladder=ladder)
    for sid in chunks:
        assert loop.send(codec.encode_control(codec.OP_OPEN, sid)).ok
    for seq in range(3):
        for sid in chunks:
            assert loop.send(codec.encode_chunk(
                chunks[sid][seq], stream_id=sid, seq=seq, timestamp_ns=seq,
            )).ok
        ingest.tick()
    for sid, cs in chunks.items():
        if ladder is None:
            _assert_bitwise(_solo(cs), srv.state(sid), f"stream {sid}")
        else:
            solo = api.EPICCompressor(_comp(PORT, prefilter_k=8).cfg,
                                      device="cpu", k_ladder=ladder)
            state = solo.init()
            for c in cs:
                state, _ = solo.step(state, api.SensorChunk(
                    *(torch.from_numpy(np.array(x)) for x in c)))
            _assert_bitwise(state, srv.state(sid), f"stream {sid}")
            assert solo.k_trajectory == srv.telemetry(sid).k_trajectory


def test_tick_prunes_server_side_evictions_and_latency_attaches():
    srv, ingest, loop = _wire(PORT, eviction="idle", idle_frames=CHUNK)
    srv.latency = latency.LatencyRecorder()
    chunk = _chunks(PORT, 0)[0]
    assert loop.send(codec.encode_control(codec.OP_OPEN, 1)).ok
    assert loop.send(codec.encode_chunk(chunk, stream_id=1, seq=0,
                                        timestamp_ns=0)).ok
    ingest.tick()
    assert srv.latency.summary()["total"]["count"] == 1
    ingest.tick()  # idle >= CHUNK frames -> evicted by policy
    assert srv.live_sessions == []
    r = loop.send(codec.encode_chunk(chunk, stream_id=1, seq=1,
                                     timestamp_ns=0))
    assert r.status_name == "unknown_stream"


def test_backpressured_submit_copies_nothing(monkeypatch):
    """A chunk that a full ``"refuse"`` queue refuses is refused before
    any copy; the backpressure counters are the reference's."""
    from repro_torch.serve import server as srv_mod

    copies = []
    real = srv_mod.chunk_to_device
    monkeypatch.setattr(srv_mod, "chunk_to_device",
                        lambda c, d: copies.append(1) or real(c, d))
    out = {}
    for pkg in (REF, PORT):
        srv, ingest, loop = _wire(pkg, capacity=1, queue_depth=2)
        chunk = _chunks(pkg, 0)[0]
        srv.admit(1)
        oks = [srv.submit(1, chunk) for _ in range(4)]
        q = srv._queues[1]
        out[pkg.name] = (oks, srv.n_backpressure,
                         srv.telemetry(1).n_queue_overflow, q.n_overflow,
                         q.n_pushed, srv.server_counters())
    assert out["port"] == out["ref"]
    assert out["port"][0] == [True, True, False, False]
    assert len(copies) == 2  # the two accepted chunks only


@pytest.mark.parametrize("route", ["direct", "wire"])
def test_submitted_chunk_is_the_servers_own_copy(route):
    """The queue holds memory of its own: a producer, or a transport that
    reuses its receive buffer, overwriting what it submitted changes
    nothing that a tick will serve."""
    srv, ingest, loop = _wire(PORT, capacity=1)
    chunk = api.SensorChunk(*(torch.from_numpy(np.array(x))
                              for x in _chunks(PORT, 0)[0]))
    want = api.SensorChunk(*(x.clone() for x in chunk))
    assert loop.send(codec.encode_control(codec.OP_OPEN, 1)).ok
    if route == "direct":
        assert srv.submit(1, chunk)
        for x in chunk:
            x.zero_()
    else:
        msg = bytearray(codec.encode_chunk(chunk, stream_id=1, seq=0,
                                           timestamp_ns=0))
        assert codec.decode_reply(ingest.handle_message(msg)).ok
        msg[:] = bytes(len(msg))
    _assert_bitwise(srv._queues[1].peek(), want)


# ---------------------------------------------------------------------------
# Traces


def _feeds(pkg, lengths):
    return {sid: _chunks(pkg, sid, n_frames=CHUNK * n)
            for sid, n in lengths.items()}


def test_recorded_traces_are_the_references_bytes(tmp_path):
    lengths = {3: 2, 5: 1, 7: 3}
    for fn, kw in ((lambda m, f, p: m.trace.record_streams(
            f, p, chunk_period_ns=1000), {}),
                   (lambda m, f, p: m.trace.record_session(
            f[3], p, stream_id=3, chunk_period_ns=7), {})):
        paths = []
        for pkg in (REF, PORT):
            path = str(tmp_path / f"{pkg.name}.wtrace")
            assert fn(pkg, _feeds(pkg, lengths), path) > 0
            paths.append(path)
        with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
            assert a.read() == b.read()
    recs = trace.TraceReader(paths[1]).records()
    assert [bytes(r.message) for r in recs] == [
        bytes(r.message) for r in jtrace.TraceReader(paths[1]).records()]
    frame = codec.decode_frame(recs[1].message)  # a view of the reader's
    assert frame.chunk.frames.numel() > 0        # buffer, no copy


def _replay_into(pkg, path, *, ladder=(8, 16, 32)):
    srv, ingest, loop = _wire(pkg, capacity=4, k_ladder=ladder,
                              queue_depth=2)
    replies = []
    pkg.trace.replay(path, loop.roundtrip, on_reply=replies.append,
                     on_advance=ingest.tick)
    ingest.tick()
    status = loop.status()
    return srv, replies, status


def test_reference_trace_replays_into_the_port(tmp_path):
    """Streams of 3, 1 and 2 chunks, recorded with OPENs and CLOSEs at a
    live client's positions, plus two streams left open; the reference
    records, both packages replay."""
    path = str(tmp_path / "ref.wtrace")
    feeds = _feeds(REF, {3: 3, 5: 1, 7: 2})
    with jtrace.TraceWriter(path) as w:
        for sid in (11, 12):
            w.append(jcodec.encode_control(jcodec.OP_OPEN, sid),
                     timestamp_ns=0)
        jtrace.replay(
            jtrace.TraceReader(_tmp_record(tmp_path, feeds)),
            lambda m: w.append(bytes(m), timestamp_ns=0),
        )
        for t, c in enumerate(_chunks(REF, 11, n_frames=24)):
            for sid in (11, 12):
                w.append(jcodec.encode_chunk(c, stream_id=sid, seq=t,
                                             timestamp_ns=t),
                         timestamp_ns=1000 * (t + 1))
    ref_srv, want, want_status = _replay_into(REF, path)
    port_srv, got, got_status = _replay_into(PORT, path)
    assert len(got) == len(want) > 10
    assert got == want
    assert got_status == want_status
    for sid in (11, 12):
        _assert_state_matches_ref(ref_srv.state(sid), port_srv.state(sid),
                                  f"stream {sid}")
        assert (port_srv.telemetry(sid).k_trajectory
                == ref_srv.telemetry(sid).k_trajectory)
    assert ([t.as_dict() for t in port_srv.evicted]
            == [t.as_dict() for t in ref_srv.evicted])


def _tmp_record(tmp_path, feeds):
    p = str(tmp_path / "streams.wtrace")
    jtrace.record_streams(feeds, p, chunk_period_ns=0)
    return p


def _faulty_run(pkg, path):
    srv, ingest, loop = _wire(pkg, capacity=2, strict_seq=True,
                              queue_depth=2)
    log = []

    class Logged:
        def send(self, msg):
            raw = loop.roundtrip(msg)
            log.append(raw)
            return pkg.codec.decode_reply(raw)

    plan = pkg.rfault.FaultPlan(
        seed=3, rates={"drop": 0.1, "dup": 0.1, "reorder": 0.1,
                       "corrupt": 0.1, "truncate": 0.05},
        at={2: "drop", 3: "reorder", 5: "corrupt"}, warmup=1,
    )
    link = pkg.fault.FaultyTransport(Logged(), plan)
    sessions = {}
    replies = []
    for rec in pkg.trace.TraceReader(path):
        kind, frame = pkg.codec.decode_message(rec.message)
        sid = frame.stream_id
        if sid not in sessions:
            sessions[sid] = pkg.server.ResumableSession(
                link, sid, window=16, drain=ingest.tick)
            assert sessions[sid].open().ok
        replies.append(tuple(sessions[sid].send_chunk(frame.chunk)))
        if sid == max(sessions):
            ingest.tick()
    # A frame lost at a stream's end has no later frame to reveal the
    # gap: the link turns clean and every session resumes, replaying what
    # the server lacks from its window.
    plan.rates = {}
    for s in sessions.values():
        s.resume()
    while any(len(q) for q in srv._queues.values()):
        ingest.tick()
    stats = {sid: (s.n_retransmits, s.n_damage_retries, s.n_already_served,
                   s.last_acked) for sid, s in sessions.items()}
    return srv, log, replies, stats, dict(plan.counts)


def test_trace_through_faulty_transport_and_resumable_session(tmp_path):
    feeds = {sid: _chunks(REF, sid, n_frames=40) for sid in (1, 2)}
    path = str(tmp_path / "lossy.wtrace")
    jtrace.record_streams(feeds, path, open_close=False)
    ref_srv, want_log, want, want_stats, want_counts = _faulty_run(REF, path)
    port_srv, got_log, got, got_stats, got_counts = _faulty_run(PORT, path)
    assert got_log == want_log
    assert got == want
    assert got_stats == want_stats and got_counts == want_counts
    assert sum(v for k, v in got_counts.items() if k != "deliver") >= 5
    for sid, cs in feeds.items():
        _assert_state_matches_ref(ref_srv.state(sid), port_srv.state(sid),
                                  f"stream {sid}")
        # strict-seq recovery converges to the lossless stream, bitwise
        _assert_bitwise(_solo(cs), port_srv.state(sid), f"stream {sid}")


def test_realtime_replay_paces_and_reader_rejects_garbage(tmp_path):
    path = str(tmp_path / "p.wtrace")
    with trace.TraceWriter(path) as w:
        for i in range(3):
            w.append(codec.encode_control(codec.OP_OPEN, i),
                     timestamp_ns=i * 1_000_000_000)
    sleeps, sent = [], []
    trace.replay(path, lambda m: sent.append(bytes(m)), realtime=True,
                 speed=10.0, sleep=sleeps.append)
    assert len(sent) == 3 and len(sleeps) == 2
    assert sleeps[0] == pytest.approx(0.1, abs=0.02)
    assert sleeps[1] == pytest.approx(0.2, abs=0.02)
    with pytest.raises(ValueError, match="speed"):
        trace.replay(path, sent.append, speed=0)
    bad = str(tmp_path / "bad.wtrace")
    with open(bad, "wb") as f:
        f.write(b"NOTATRACE123")
    with open(path, "rb") as f:
        data = f.read()
    trunc = str(tmp_path / "trunc.wtrace")
    with open(trunc, "wb") as f:
        f.write(data[:-3])
    for p in (bad, trunc):
        want = _raised(lambda: jtrace.TraceReader(p).records())
        assert want is not None
        assert _raised(lambda: trace.TraceReader(p).records()) == want


# ---------------------------------------------------------------------------
# Seeded schedules


LOAD_CFGS = {
    "steady": dict(seed=3, ticks=8, arrival_rate=1.0, session_len_mu=1.0,
                   session_len_sigma=0.5),
    "burst": dict(seed=4, ticks=10, arrival_rate=1.5, session_len_mu=1.2,
                  session_len_sigma=0.6, burst_factor=2.0, burst_every=4),
}


def _load(pkg, name, trace_path=None):
    srv, ingest, _ = _wire(pkg, capacity=2, queue_depth=1, eviction="lru")
    bank = _chunks(pkg, 0)
    writer = None if trace_path is None else pkg.trace.TraceWriter(
        trace_path)
    try:
        gen = pkg.loadgen.LoadGen(pkg.loadgen.LoadConfig(**LOAD_CFGS[name]),
                                  bank, ingest, trace_writer=writer)
        summary = gen.run()
    finally:
        if writer is not None:
            writer.close()
    rtt = summary.pop("rtt")
    assert rtt["count"] > 0
    return summary, gen.event_log, srv.server_counters()


@pytest.mark.parametrize("name", sorted(LOAD_CFGS))
def test_loadgen_digest_is_the_references(name, tmp_path):
    want = _load(REF, name, str(tmp_path / "ref.wtrace"))
    got = _load(PORT, name, str(tmp_path / "port.wtrace"))
    assert got == want
    if name == "burst":
        assert got[0]["nacks"].get("backpressure", 0) > 0
    with open(tmp_path / "ref.wtrace", "rb") as a, \
            open(tmp_path / "port.wtrace", "rb") as b:
        assert a.read() == b.read()


def test_loadgen_validation_is_the_references():
    for pkg_ in (REF, PORT):
        _, ingest, _ = _wire(pkg_)
        with pytest.raises(ValueError, match="bank"):
            pkg_.loadgen.LoadGen(pkg_.loadgen.LoadConfig(), [], ingest)
        with pytest.raises(ValueError, match="burst_factor"):
            pkg_.loadgen.LoadGen(pkg_.loadgen.LoadConfig(burst_factor=0.5),
                                 _chunks(pkg_, 0), ingest)


PLANS = [
    dict(seed=0, rates={"drop": 0.2, "dup": 0.1}),
    dict(seed=7, rates={"reorder": 0.3, "corrupt": 0.2, "truncate": 0.1},
         at={0: "dup", 4: "drop"}, warmup=2),
    dict(seed=11),
]


@pytest.mark.parametrize("kw", PLANS, ids=str)
def test_fault_plan_schedule_is_the_references(kw):
    a, b = jrfault.FaultPlan(**kw), rfault.FaultPlan(**kw)
    assert [b.next_action() for _ in range(200)] == [
        a.next_action() for _ in range(200)]
    assert b.counts == a.counts


@pytest.mark.parametrize("kw", [dict(rates={"explode": 0.1}),
                                dict(rates={"drop": 1.5}),
                                dict(rates={"drop": 0.7, "dup": 0.6}),
                                dict(at={1: "explode"})], ids=str)
def test_fault_plan_validation_is_the_references(kw):
    want = _raised(jrfault.FaultPlan, **kw)
    assert want is not None and _raised(rfault.FaultPlan, **kw) == want


def test_faulty_transport_deliveries_are_the_references():
    """Over a transport that logs what reaches it, one seeded plan damages
    the same frames the same way in both packages."""
    out = {}
    for pkg_ in (REF, PORT):
        delivered = []

        class Sink:
            def send(self, msg, _c=pkg_.codec):
                delivered.append(bytes(msg))
                return _c.Reply(_c.ACK, 0, 0)

        link = pkg_.fault.FaultyTransport(Sink(), pkg_.rfault.FaultPlan(
            seed=5, rates={"drop": 0.15, "dup": 0.15, "reorder": 0.15,
                           "corrupt": 0.15, "truncate": 0.15}))
        replies = []
        for seq, c in enumerate(_chunks(pkg_, 1, n_frames=16) * 10):
            replies.append(tuple(link.send(pkg_.codec.encode_chunk(
                c, stream_id=4, seq=seq, timestamp_ns=0))))
        link.send(pkg_.codec.encode_control(pkg_.codec.OP_CLOSE, 4))
        out[pkg_.name] = (delivered, replies, dict(link.plan.counts))
    assert out["port"] == out["ref"]


# ---------------------------------------------------------------------------
# Sockets (the port alone, as tests/test_wire.py)


def test_tcp_roundtrip_equals_solo_sessions():
    srv, ingest, _ = _wire(PORT)
    try:
        host, port = ingest.start_tcp_in_thread()
    except OSError as e:  # pragma: no cover
        pytest.skip(f"cannot bind local TCP socket: {e}")
    try:
        chunks = _chunks(PORT, 8)
        with server.WireClient(host, port) as client:
            assert client.send(codec.encode_control(codec.OP_OPEN, 21)).ok
            for seq, c in enumerate(chunks):
                r = client.send(codec.encode_chunk(c, stream_id=21, seq=seq,
                                                   timestamp_ns=seq))
                assert r.ok and r.seq == seq
                ingest.tick()
            st = client.status()
        _assert_bitwise(_solo(chunks), srv.state(21), "tcp ingest")
        assert st["wire_counters"]["n_frames_in"] == len(chunks)
    finally:
        ingest.stop()


def test_unix_socket_with_ticks_on_another_thread_equals_loopback(tmp_path):
    """The asyncio receiver submits on its event-loop thread while another
    thread ticks; both run the server's device work on its one stream.
    The result equals the in-process loopback run bitwise."""
    feeds = {sid: _chunks(PORT, sid, n_frames=24) for sid in (1, 2, 3, 4)}
    srv0, ingest0, loop0 = _wire(PORT, capacity=4)
    for sid in feeds:
        assert loop0.send(codec.encode_control(codec.OP_OPEN, sid)).ok
    for seq in range(3):
        for sid, cs in feeds.items():
            assert loop0.send(codec.encode_chunk(
                cs[seq], stream_id=sid, seq=seq, timestamp_ns=0)).ok
        ingest0.tick()

    srv, ingest, _ = _wire(PORT, capacity=4)
    path = str(tmp_path / "ingest.sock")
    loop = asyncio.new_event_loop()
    started = threading.Event()

    def serve_forever():
        asyncio.set_event_loop(loop)
        s = loop.run_until_complete(ingest.serve_unix(path))
        started.set()
        loop.run_forever()
        s.close()
        loop.run_until_complete(s.wait_closed())
        loop.close()

    t = threading.Thread(target=serve_forever, daemon=True)
    t.start()
    assert started.wait(10)
    try:
        with server.WireClient(unix_path=path) as client:
            for sid in feeds:
                assert client.send(codec.encode_control(codec.OP_OPEN,
                                                        sid)).ok
            for seq in range(3):
                for sid, cs in feeds.items():
                    assert client.send(codec.encode_chunk(
                        cs[seq], stream_id=sid, seq=seq, timestamp_ns=0)).ok
                ticker = threading.Thread(target=ingest.tick)
                ticker.start()
                ticker.join(30)
                assert not ticker.is_alive()
    finally:
        loop.call_soon_threadsafe(loop.stop)
        t.join(10)
    assert not t.is_alive()
    for sid in feeds:
        _assert_bitwise(srv0.state(sid), srv.state(sid), f"stream {sid}")


class _FakeSock:
    def close(self):
        pass


def _client(monkeypatch, fail_times, **kw):
    attempts, sleeps = [], []

    def create(addr, timeout=None):
        attempts.append(addr)
        if 1 < len(attempts) <= fail_times + 1:
            raise OSError("connection refused")
        return _FakeSock()

    monkeypatch.setattr(server.socket, "create_connection", create)
    return server.WireClient("127.0.0.1", 1, sleep=sleeps.append,
                             **kw), attempts, sleeps


def test_reconnect_backoff_is_bounded_and_exponential(monkeypatch):
    cli, attempts, sleeps = _client(monkeypatch, 3, reconnect_attempts=5,
                                    backoff_base=0.05, backoff_max=0.15)
    cli.reconnect()
    assert len(attempts) == 5 and cli.n_reconnects == 1
    assert sleeps == [0.05, 0.1, 0.15]
    cli, attempts, sleeps = _client(monkeypatch, 99, reconnect_attempts=3,
                                    backoff_base=0.01)
    with pytest.raises(ConnectionError, match="after 3 attempts"):
        cli.reconnect()
    assert len(attempts) == 4 and len(sleeps) == 3 and cli.n_reconnects == 0


def test_wedged_server_surfaces_as_a_retriable_connection_error():
    srv_sock = socket.socket()
    try:
        srv_sock.bind(("127.0.0.1", 0))
    except OSError as e:  # pragma: no cover
        pytest.skip(f"cannot bind local TCP socket: {e}")
    srv_sock.listen(1)
    host, port = srv_sock.getsockname()
    accepted = []
    t = threading.Thread(target=lambda: accepted.append(srv_sock.accept()),
                         daemon=True)
    t.start()
    try:
        client = server.WireClient(host, port, timeout=0.3)
        with pytest.raises(ConnectionError, match="unresponsive"):
            client.send(codec.encode_control(codec.OP_OPEN, 1))
        assert client.n_timeouts == 1
        with pytest.raises(OSError):
            client.send(codec.encode_control(codec.OP_OPEN, 1))
    finally:
        for conn, _ in accepted:
            conn.close()
        srv_sock.close()
        t.join(timeout=2)
    assert not t.is_alive()


class _Swallow:
    def __init__(self, loop, lose=()):
        self.loop, self.lose = loop, set(lose)

    def send(self, msg):
        if bytes(memoryview(msg)[:4]) == codec.DATA_MAGIC:
            _, _, _, sid, seq, *_ = codec.FRAME_HEADER.unpack_from(
                bytes(msg)[: codec.FRAME_HEADER.size])
            if seq in self.lose:
                self.lose.discard(seq)
                return codec.Reply(codec.ACK, sid, seq)
        return self.loop.send(msg)


def test_resumable_session_windows_and_credit():
    srv, ingest, loop = _wire(PORT, capacity=4, strict_seq=True,
                              queue_depth=4)
    chunks = _chunks(PORT, 9, n_frames=40)
    sess = server.ResumableSession(_Swallow(loop, {1, 2}), 5, window=32,
                                   drain=ingest.tick)
    assert sess.open().ok
    for c in chunks:
        assert sess.send_chunk(c).ok
        ingest.tick()
    while any(len(q) for q in srv._queues.values()):
        ingest.tick()
    assert sess.n_retransmits == 2
    _assert_bitwise(_solo(chunks), srv.state(5), "selective retransmit")
    # a loss that outlives the window is an error
    late = server.ResumableSession(_Swallow(loop, {0, 1}), 6, window=2,
                                   drain=ingest.tick)
    assert late.open().ok
    assert late.send_chunk(chunks[0]).ok and late.send_chunk(chunks[1]).ok
    with pytest.raises(server.ResumeError, match="outlived"):
        late.send_chunk(chunks[2])
    with pytest.raises(server.ResumeError, match="RESUME refused"):
        server.ResumableSession(loop, 404).resume()
    # credit pacing: a paced producer never trips backpressure
    paced = server.ResumableSession(loop, 7, credit=2, drain=ingest.tick)
    assert paced.open().ok
    for c in chunks:
        assert paced.send_chunk(c).ok
    assert ingest.nacks.get("backpressure", 0) == 0
    assert paced.n_credit_requests >= 1
    with pytest.raises(ValueError, match="credit"):
        server.ResumableSession(loop, 8, credit=0)
    starved = server.ResumableSession(loop, 7, credit=4)
    while len(srv._queues[7]) < 4:
        assert srv.submit(7, chunks[0])
    with pytest.raises(server.ResumeError, match="zero credit"):
        starved.send_chunk(chunks[0])
