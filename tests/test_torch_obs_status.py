"""STATUS introspection and flight-dump summaries in the PyTorch port
(``repro_torch.obs.status``, ``repro_torch.obs.dump``), held to the JAX
package on the CPU.

* One wire session (degrade controller attached, flat and tiered pools)
  through both packages: ``collect_status`` and the STATUS reply are the
  same JSON document, and the STATUS reply the same bytes;
* ``python -m repro_torch.obs.dump`` prints the reference's text (and its
  error, with its exit code) on the same Chrome-trace document;
* the reference's ``tests/test_obs.py::TestStatus`` and ``TestFaultDumps``
  cases on the port alone: loopback and TCP STATUS equal the host-side
  truth, kill points write a flight dump before raising.

Fixed seeds only; no ``@given``.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro import api as japi
from repro import serve as jserve
from repro.core import pipeline as jP
from repro.obs import dump as jdump
from repro.obs import status as jstatus
from repro.obs.trace import FlightRecorder as JFlightRecorder
from repro.serve.degrade import DegradeConfig as JDegradeConfig
from repro.serve.degrade import DegradeController as JDegradeController
from repro.wire import codec as jcodec
from repro.wire import server as jserver
from repro_torch import api
from repro_torch import serve
from repro_torch.core import pipeline as P
from repro_torch.data import synthetic as SYN
from repro_torch.obs import dump, status
from repro_torch.obs.trace import FlightRecorder
from repro_torch.runtime.fault import FailureInjector, WorkerFailure
from repro_torch.serve.degrade import DegradeConfig, DegradeController
from repro_torch.wire import codec, server

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAME, PATCH, CHUNK = 64, 16, 8


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


def _chunks(seed, n_frames=24):
    s, _ = SYN.generate_stream(
        np.random.default_rng(seed),
        SYN.StreamConfig(n_frames=n_frames, hw=(FRAME, FRAME), n_obj=4),
        device="cpu",
    )
    arrs = [x.numpy() for x in (s.frames, s.poses, s.gazes, s.depth)]
    return [tuple(a[lo:lo + CHUNK] for a in arrs)
            for lo in range(0, n_frames, CHUNK)]


def _loaded(is_ref, tiers=None, recorder=None):
    A, Pm, S, W, C = ((japi, jP, jserve, jserver, jcodec) if is_ref
                      else (api, P, serve, server, codec))
    cfg = Pm.EPICConfig(frame_hw=(FRAME, FRAME), patch=PATCH, capacity=32,
                        tau=0.10, gamma=0.015, theta=8, window=16,
                        prefilter_k=8)
    comp = A.EPICCompressor(cfg) if is_ref else A.EPICCompressor(
        cfg, device="cpu")
    srv = S.StreamServer(comp, S.ServerConfig(
        capacity=4, chunk_frames=CHUNK, queue_depth=1, k_ladder=(8, 16),
        tiers=tiers))
    dc = (JDegradeController(JDegradeConfig(), metrics=srv.metrics)
          if is_ref else DegradeController(DegradeConfig(),
                                            metrics=srv.metrics))
    srv.degrade = dc
    srv.recorder = recorder
    ingest = W.IngestServer(srv)
    loop = W.Loopback(ingest)
    replies = [loop.roundtrip(C.encode_control(C.OP_OPEN, sid))
               for sid in (5, 6)]
    feeds = {5: _chunks(2), 6: _chunks(3)}
    for seq in range(3):
        for sid, cs in feeds.items():
            msg = C.encode_chunk(A.SensorChunk(*cs[seq]), stream_id=sid,
                                 seq=seq, timestamp_ns=seq)
            replies.append(loop.roundtrip(msg))
            replies.append(loop.roundtrip(msg))  # out of order
        replies.append(loop.roundtrip(C.encode_credit(5, 3)))
        ingest.tick()
    return ingest, loop, replies


@pytest.mark.parametrize("tiers", [None, (2, 2)], ids=["flat", "tiered"])
def test_status_is_the_references_document(tiers):
    ref, ref_loop, ref_replies = _loaded(True, tiers)
    got, got_loop, got_replies = _loaded(False, tiers)
    assert got_replies == ref_replies
    with ref.lock, got.lock:
        want = json.loads(json.dumps(jstatus.collect_status(ref)))
        have = json.loads(json.dumps(status.collect_status(got)))
    assert have == want
    raw = ref_loop.roundtrip(jcodec.encode_control(jcodec.OP_STATUS, 0))
    assert got_loop.roundtrip(codec.encode_control(codec.OP_STATUS, 0)) \
        == raw
    assert have["degrade"]["attached"] is True
    assert have["seq_cursors"] == {"5": 2, "6": 2}
    assert set(have["status_reasons"]) == {str(c)
                                           for c in codec.STATUS_REASONS}


def test_loopback_and_tcp_status_equal_collect_status():
    ingest, loop, _ = _loaded(False)
    got = loop.status()
    with ingest.lock:
        want = json.loads(json.dumps(status.collect_status(ingest)))
    assert got == want
    assert got["schema"] == status.STATUS_SCHEMA == 1
    assert got["tick"] == ingest.srv.n_ticks > 0
    raw = loop.roundtrip(codec.encode_control(codec.OP_STATUS, 0))
    kind, payload = codec.decode_message(raw)
    again = loop.status()
    assert kind == "status"
    assert again["wire_counters"].pop("n_messages") == (
        payload["wire_counters"].pop("n_messages") + 1)
    assert payload == again
    try:
        host, port = ingest.start_tcp_in_thread()
    except OSError as e:  # pragma: no cover
        pytest.skip(f"cannot bind local TCP socket: {e}")
    try:
        with server.WireClient(host, port) as client:
            over_tcp = client.status()
        with ingest.lock:
            want = json.loads(json.dumps(status.collect_status(ingest)))
        assert over_tcp == want
    finally:
        ingest.stop()


def _flight_doc(tmp_path, is_ref):
    rec = (JFlightRecorder if is_ref else FlightRecorder)(
        capacity=8, clock=_FakeClock())
    _loaded(is_ref, recorder=rec)
    path = str(tmp_path / ("ref.json" if is_ref else "port.json"))
    rec.dump(path)
    return path


def _run_dump(module, path):
    env = {"PYTHONPATH": os.path.join(ROOT, "src"), "PATH": "/usr/bin:/bin"}
    for k in ("JAX_PLATFORMS", "HOME"):
        if k in os.environ:
            env[k] = os.environ[k]
    out = subprocess.run([sys.executable, "-m", module, path], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    return out.returncode, out.stdout, out.stderr


def test_dump_prints_the_references_text(tmp_path):
    ref_path = _flight_doc(tmp_path, True)
    port_path = _flight_doc(tmp_path, False)
    with open(ref_path) as f:
        ref_doc = json.load(f)
    with open(port_path) as f:
        port_doc = json.load(f)
    for doc in (ref_doc, port_doc):
        assert dump.summarize(doc) == jdump.summarize(doc)
    # the two recorders saw the same ticks, phases and events
    assert dump.summarize(port_doc) == jdump.summarize(ref_doc)
    assert "ticks retained: " in dump.summarize(port_doc)
    bad = str(tmp_path / "bad.json")
    with open(bad, "w") as f:
        json.dump({"no": "events"}, f)
    for path in (ref_path, bad, str(tmp_path / "missing.json")):
        want = _run_dump("repro.obs.dump", path)
        assert _run_dump("repro_torch.obs.dump", path) == want
    assert _run_dump("repro_torch.obs.dump", bad)[0] == 1


def test_kill_point_dumps_before_raising(tmp_path):
    rec = FlightRecorder(capacity=4, clock=_FakeClock())
    rec.begin_tick(0)
    rec.event("nack", status="backpressure")
    inj = FailureInjector([("mid_tick", 3)], recorder=rec,
                          dump_dir=str(tmp_path))
    inj.maybe_fail("benign")
    with pytest.raises(WorkerFailure):
        inj.maybe_fail(("mid_tick", 3))
    (path,) = inj.dump_paths
    assert os.path.basename(path) == "flight-mid_tick---3-0.json"
    with open(path) as f:
        assert any(e["name"] == "nack" for e in json.load(f)["traceEvents"])
    inj.maybe_fail(("mid_tick", 3))  # each point fires once
    quiet = FailureInjector(["x"], dump_dir=str(tmp_path / "q"))
    with pytest.raises(WorkerFailure):
        quiet.maybe_fail("x")
    assert quiet.dump_paths == []
    broken = FailureInjector(["x"], recorder=rec,
                             dump_dir=str(tmp_path / "missing" / "dir"))
    with pytest.raises(WorkerFailure):
        broken.maybe_fail("x")
    assert broken.dump_paths == []
