"""Checkpoints in the PyTorch port: the atomic store
(``repro_torch.checkpoint.store``), the fault-tolerant loop
(``repro_torch.runtime.fault``) and the live serving checkpoint
(``repro_torch.serve.checkpoint``), on the CPU.

Held against the JAX package:

* a directory written by either package's store is read by the other to
  the same arrays, bitwise — float32, bfloat16, integer, boolean and
  Python scalar leaves, dicts, lists and NamedTuples — under the same
  leaf keys and dtype names;
* a serve checkpoint of the same config and sessions has the same leaf
  keys, shapes and dtype names, and the same ``"serve"`` metadata keys
  with equal host values (cursors, counters, rungs, queue contents'
  specs), in both packages.

Held in the port alone, as ``tests/test_fault_serve.py`` and the store
cases of ``tests/test_substrates.py``: snapshot, restore and replay end
bitwise equal to an uninterrupted run, flat, adaptive and tiered, after
kills mid-tick, mid-save, mid-wire-frame and twice; restore builds no
step program (``step_cache_sizes()`` all 1 after replay); generation
handles stay valid; damaged newest steps fall back; ``gc_old``; the
``AsyncSaver`` re-raises a background failure; injected failures in the
``FaultTolerantLoop`` restore and replay bit-exactly.

Fixed seeds only; no ``@given``.
"""

import functools
import os
import shutil
import threading
import time
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro import api as japi
from repro import serve as jserve
from repro.checkpoint import store as jstore
from repro.core import pipeline as jP
from repro.serve import checkpoint as jckpt
from repro.wire import server as jserver
from repro_torch import api
from repro_torch.checkpoint import store
from repro_torch.core import pipeline as P
from repro_torch.data import synthetic as SYN
from repro_torch.runtime import fault
from repro_torch.serve import ServerConfig, StreamServer
from repro_torch.serve.checkpoint import (
    SERVE_SCHEMA,
    ServeCheckpointer,
    restore_server,
    save_server,
    snapshot_server,
)
from repro_torch.serve.slots import StaleSlotError
from repro_torch.wire import codec
from repro_torch.wire.server import IngestServer, Loopback, ResumableSession

FRAME = 64
PATCH = 16
CHUNK = 8
LADDER = (8, 16, 32)
N_STREAMS = 3
N_ROUNDS = 5


# ---------------------------------------------------------------------------
# The store, across packages


class Pair(NamedTuple):
    a: object
    b: object


def _host_tree(seed=0):
    """numpy leaves of every stored kind (bfloat16 as ml_dtypes)."""
    rng = np.random.default_rng(seed)
    return {
        "layers": {"w": rng.standard_normal((16, 8)).astype(np.float32),
                   "b": np.asarray(jnp.asarray(rng.standard_normal(8),
                                               jnp.bfloat16))},
        "ints": [rng.integers(-9, 9, (3, 2)).astype(np.int32),
                 rng.integers(0, 9, (4,)).astype(np.int64)],
        "pair": Pair(rng.random(5) < 0.5, np.float64(2.5)),
        "step": 7,
        "rate": 0.25,
        "skip": None,
    }


def _to_port(x):
    if isinstance(x, np.ndarray) and x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x.copy())
    if isinstance(x, np.floating):
        return torch.tensor(float(x), dtype=torch.float64)
    return x


def _port_tree(seed=0):
    return jax.tree.map(_to_port, _host_tree(seed),
                        is_leaf=lambda x: x is None)


def _bits(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy().tobytes(), tuple(x.shape)
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        a = a.view(np.int16)
    return a.tobytes(), a.shape


def _leaves(tree):
    return [leaf for _, leaf in store._flatten_with_paths(tree)]


def test_leaf_keys_are_the_references():
    want = [k for k, _ in jstore._flatten_with_paths(_host_tree())[0]]
    assert [k for k, _ in store._flatten_with_paths(_port_tree())] == want


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_either_package_reads_the_others_directory_bitwise(tmp_path, writer):
    src = _host_tree(1)
    if writer == "ref":
        jstore.save(str(tmp_path), 3, src, n_shards=3)
    else:
        store.save(str(tmp_path), 3, _port_tree(1), n_shards=3)
    manifest = jstore.read_manifest(str(tmp_path), 3)
    assert manifest["leaves"]["['layers']/['b']"]["dtype"] == "bfloat16"
    # the port reads into tensors, the reference into its arrays
    got, step = store.restore(str(tmp_path), _port_tree(0))
    ref, step2 = jstore.restore(str(tmp_path), _host_tree(0))
    assert step == step2 == 3
    want = _leaves(src)
    for a, b, c in zip(want, _leaves(got), jax.tree.leaves(ref)):
        assert _bits(b) == _bits(a) == _bits(c)
    assert got["step"] == 7 and isinstance(got["step"], int)
    assert got["rate"] == 0.25 and got["skip"] is None
    assert got["layers"]["b"].dtype == torch.bfloat16
    assert isinstance(got["pair"], Pair)


def test_both_packages_write_the_same_manifest(tmp_path):
    jstore.save(str(tmp_path / "ref"), 1, _host_tree(2), n_shards=2)
    store.save(str(tmp_path / "port"), 1, _port_tree(2), n_shards=2)
    a = jstore.read_manifest(str(tmp_path / "ref"), 1)
    b = store.read_manifest(str(tmp_path / "port"), 1)
    a.pop("time"), b.pop("time")
    assert a == b


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"layers": {"w": torch.randn((16, 8), generator=g),
                       "b": torch.zeros((8,), dtype=torch.bfloat16)},
            "step": torch.tensor(7, dtype=torch.int32)}


def test_roundtrip_atomicity_gc_and_async(tmp_path):
    t = _tree()
    store.save(str(tmp_path / "a"), 3, t)
    like = {"layers": {"w": store.LeafSpec((16, 8), torch.float32),
                       "b": store.LeafSpec((8,), torch.bfloat16)},
            "step": store.LeafSpec((), torch.int32)}
    out, step = store.restore(str(tmp_path / "a"), like)
    assert step == 3 and out["layers"]["b"].dtype == torch.bfloat16
    assert torch.equal(out["layers"]["w"], t["layers"]["w"])
    # a crashed save (step dir without manifest) is ignored
    bad = tmp_path / "a" / "step_00000009"
    bad.mkdir()
    (bad / "shard_0.npz").write_bytes(b"garbage")
    assert store.latest_step(str(tmp_path / "a")) == 3
    for s in (1, 2, 3, 4, 5):
        store.save(str(tmp_path / "g"), s, t)
    store.gc_old(str(tmp_path / "g"), keep=2)
    assert store.complete_steps(str(tmp_path / "g")) == [4, 5]
    saver = store.AsyncSaver()
    saver.save(str(tmp_path / "s"), 11, t)
    saver.wait()
    assert store.latest_step(str(tmp_path / "s")) == 11
    store.save(str(tmp_path / "m"), 1, {"w": torch.zeros(4)})
    with pytest.raises(ValueError, match="shape mismatch"):
        store.restore(str(tmp_path / "m"), {"w": torch.zeros(5)})


def test_async_snapshot_is_taken_at_the_call(tmp_path):
    """An in-place write to the live tree after ``save`` returns does not
    reach the checkpoint (the serving pool writes its slots in place)."""
    t = _tree()
    want = t["layers"]["w"].clone()
    saver = store.AsyncSaver()
    saver.save(str(tmp_path), 1, t)
    t["layers"]["w"].add_(1.0)
    saver.wait()
    out, _ = store.restore(str(tmp_path), _tree())
    assert torch.equal(out["layers"]["w"], want)


def _truncate_shard(d):
    p = d / "shard_0.npz"
    p.write_bytes(p.read_bytes()[: max(1, p.stat().st_size // 2)])


def _delete_shard(d):
    (d / "shard_0.npz").unlink()


def _delete_manifest(d):
    (d / "manifest.json").unlink()


def _corrupt_manifest(d):
    (d / "manifest.json").write_text("{not json")


@pytest.mark.parametrize("damage", [_truncate_shard, _delete_shard,
                                    _delete_manifest, _corrupt_manifest])
def test_restore_falls_back_past_damaged_newest(tmp_path, damage):
    store.save(str(tmp_path), 1, _tree(1))
    store.save(str(tmp_path), 2, _tree(2))
    damage(tmp_path / "step_00000002")
    out, step = store.restore(str(tmp_path), _tree(0))
    assert step == 1
    assert torch.equal(out["layers"]["w"], _tree(1)["layers"]["w"])


def test_explicit_step_gc_race_and_all_damaged(tmp_path, monkeypatch):
    store.save(str(tmp_path), 1, _tree(1))
    store.save(str(tmp_path), 2, _tree(2))
    _delete_shard(tmp_path / "step_00000002")
    with pytest.raises(FileNotFoundError):
        store.restore(str(tmp_path), _tree(0), step=2)
    store.save(str(tmp_path), 2, _tree(2))
    real, calls = store._load_step, []

    def racy(directory, step, like, device):
        if not calls:
            calls.append(step)
            shutil.rmtree(tmp_path / "step_00000002")
        return real(directory, step, like, device)

    monkeypatch.setattr(store, "_load_step", racy)
    _, step = store.restore(str(tmp_path), _tree(0))
    assert step == 1 and calls == [2]
    monkeypatch.undo()
    one = tmp_path / "one"
    store.save(str(one), 1, {"w": torch.zeros(4)})
    with pytest.raises(ValueError):
        store.restore(str(one), {"w": torch.zeros(5)})


def test_save_cleans_stale_tmp_and_saver_surfaces_errors(tmp_path):
    stale = tmp_path / "step_00000007.tmp"
    stale.mkdir()
    (stale / "shard_0.npz").write_bytes(b"partial")
    store.save(str(tmp_path), 9, _tree())
    assert not stale.exists() and store.latest_step(str(tmp_path)) == 9
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("file where the ckpt dir should go")
    saver = store.AsyncSaver()
    saver.save(str(blocker), 1, _tree())
    with pytest.raises(OSError):
        saver.wait()
    saver.save(str(tmp_path), 12, _tree())
    saver.wait()
    assert store.latest_step(str(tmp_path)) == 12


# ---------------------------------------------------------------------------
# The fault-tolerant loop


def _batch(step):
    return torch.from_numpy(
        np.random.default_rng(step).standard_normal(4).astype(np.float32))


def _step_fn(injector=None):
    def step_fn(state, batch):
        if injector is not None:
            injector.maybe_fail(int(state["i"]))
        return {"x": state["x"] + batch.sum(), "i": state["i"] + 1}, {}

    return step_fn


def test_fault_loop_bit_exact_recovery(tmp_path):
    init = {"x": torch.zeros(()), "i": torch.tensor(0, dtype=torch.int32)}
    clean = fault.FaultTolerantLoop(
        fault.LoopConfig(str(tmp_path / "clean"), ckpt_every=3),
        _step_fn(), _batch,
    ).run(init, 10)
    loop = fault.FaultTolerantLoop(
        fault.LoopConfig(str(tmp_path / "faulty"), ckpt_every=3),
        _step_fn(fault.FailureInjector([4, 8])), _batch,
    )
    faulty = loop.run(init, 10)
    assert loop.stats.restarts == 2
    assert torch.equal(clean["x"], faulty["x"]) and int(faulty["i"]) == 10


def test_fault_loop_limits_and_stragglers(tmp_path):
    def always(state, batch):
        raise fault.WorkerFailure("always")

    with pytest.raises(fault.WorkerFailure):
        fault.FaultTolerantLoop(
            fault.LoopConfig(str(tmp_path / "a"), max_restarts=2), always,
            lambda s: None,
        ).run({"x": torch.zeros(())}, 3)

    def slow(state, batch):
        time.sleep(0.2 if int(state["i"]) == 5 else 0.01)
        return {"i": state["i"] + 1}, {}

    seen = []
    loop = fault.FaultTolerantLoop(
        fault.LoopConfig(str(tmp_path / "b"), straggler_factor=4.0), slow,
        lambda s: None, on_straggler=lambda s, r: seen.append((s, r)),
    )
    loop.run({"i": torch.tensor(0, dtype=torch.int32)}, 8)
    assert loop.stats.stragglers >= 1 and seen[0][1] > 4.0


def test_failure_injector_labels_and_dumps(tmp_path):
    inj = fault.FailureInjector([("mid_tick", 3), "mid_save"])
    inj.maybe_fail(("mid_tick", 1))
    with pytest.raises(fault.WorkerFailure):
        inj.maybe_fail(("mid_tick", 3))
    inj.maybe_fail(("mid_tick", 3))  # fires once
    with pytest.raises(fault.WorkerFailure):
        inj.maybe_fail("mid_save")
    assert inj.calls == 4


# ---------------------------------------------------------------------------
# Serve checkpoints (port), as tests/test_fault_serve.py


def _ecfg(mod=P, **kw):
    base = dict(frame_hw=(FRAME, FRAME), patch=PATCH, capacity=32,
                tau=0.10, gamma=0.015, theta=8, window=16)
    base.update(kw)
    return mod.EPICConfig(**base)


def _comp(k=8):
    return api.EPICCompressor(_ecfg(prefilter_k=k), device="cpu")


@functools.lru_cache(maxsize=None)
def _stream_np(seed, n_frames):
    s, _ = SYN.generate_stream(
        np.random.default_rng(seed),
        SYN.StreamConfig(n_frames=n_frames, hw=(FRAME, FRAME), n_obj=4),
        device="cpu",
    )
    return tuple(x.numpy() for x in (s.frames, s.poses, s.gazes, s.depth))


def _chunks(seed, n_frames=48, mod=api, convert=torch.from_numpy):
    s = _stream_np(seed, n_frames)
    return [mod.SensorChunk(*(convert(x[lo:lo + CHUNK].copy()) for x in s))
            for lo in range(0, n_frames - CHUNK + 1, CHUNK)]


def _server_cfg(tiers=None, k_ladder=LADDER, mod=None, **kw):
    return (mod or ServerConfig)(capacity=4, chunk_frames=CHUNK,
                                 queue_depth=2, k_ladder=k_ladder,
                                 tiers=tiers, **kw)


def _assert_bitwise(a, b, msg=""):
    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    assert len(la) == len(lb), msg
    for i, (x, y) in enumerate(zip(la, lb)):
        assert torch.equal(x, y), f"{msg} leaf {i}"


@pytest.mark.parametrize("tiers,k_ladder", [(None, None), (None, LADDER),
                                            ((2, 2), LADDER)],
                         ids=["flat", "adaptive", "tiered"])
def test_snapshot_restore_roundtrip_bitwise(tmp_path, tiers, k_ladder):
    chunks = {sid: _chunks(sid) for sid in (1, 2, 3)}
    k = 8 if k_ladder else 0

    def build():
        srv = StreamServer(_comp(k), _server_cfg(tiers, k_ladder))
        for sid in chunks:
            srv.admit(sid)
        for i in range(2):
            for sid in chunks:
                assert srv.submit(sid, chunks[sid][i])
            srv.tick()
        for sid in chunks:  # one chunk pending at snapshot time
            assert srv.submit(sid, chunks[sid][2])
        return srv

    ref = build()
    ref.tick()
    for sid in chunks:
        assert ref.submit(sid, chunks[sid][3])
    ref.tick()

    srv = build()
    save_server(str(tmp_path), srv.n_ticks, srv)
    srv2, ingest, step = restore_server(str(tmp_path), _comp(k))
    assert step == 2 and ingest is None
    assert srv2.live_sessions == list(chunks)
    assert srv2.step_cache_sizes() == {}  # restore built nothing
    assert all(len(q) == 1 for q in srv2._queues.values())
    srv2.tick()
    for sid in chunks:
        assert srv2.submit(sid, chunks[sid][3])
    srv2.tick()
    for sid in chunks:
        _assert_bitwise(ref.state(sid), srv2.state(sid), f"stream {sid}")
        assert (ref.telemetry(sid).k_trajectory
                == srv2.telemetry(sid).k_trajectory)
    assert srv2.n_ticks == ref.n_ticks
    assert all(v == 1 for v in srv2.step_cache_sizes().values())


def test_counters_evicted_and_provided_servers(tmp_path):
    srv = StreamServer(_comp(0), _server_cfg(k_ladder=None))
    chunks = _chunks(5)
    srv.admit(1)
    srv.admit(2)
    for i in range(2):
        srv.submit(1, chunks[i])
        srv.tick()
    srv.close(2)
    save_server(str(tmp_path), srv.n_ticks, srv)
    srv2, _, _ = restore_server(str(tmp_path), _comp(0))
    assert srv2.server_counters() == srv.server_counters()
    assert [t.session_id for t in srv2.evicted] == [2]
    assert srv2._sched.cost_estimates() == srv._sched.cost_estimates()
    target = StreamServer(_comp(0), _server_cfg(k_ladder=None))
    srv3, _, _ = restore_server(str(tmp_path), _comp(0), server=target)
    assert srv3 is target
    _assert_bitwise(srv.state(1), srv3.state(1))
    other = StreamServer(
        _comp(0), _server_cfg(k_ladder=None)._replace(queue_depth=3))
    with pytest.raises(ValueError, match="config"):
        restore_server(str(tmp_path), _comp(0), server=other)
    busy = StreamServer(_comp(0), _server_cfg(k_ladder=None))
    busy.admit(9)
    with pytest.raises(ValueError, match="live sessions"):
        restore_server(str(tmp_path), _comp(0), server=busy)
    with pytest.raises(ValueError, match="compressor mismatch"):
        restore_server(str(tmp_path), _comp(16))


def test_generation_fenced_handles_survive_restore(tmp_path):
    srv = StreamServer(_comp(0), _server_cfg(k_ladder=None))
    srv.admit(1)
    srv.close(1)
    srv.admit(1)  # generation bumped twice on this slot
    srv.submit(1, _chunks(3)[0])
    srv.tick()
    tier, local = srv._locate(1)
    gen = srv._tier_pool(tier).generation_of(local)
    save_server(str(tmp_path), srv.n_ticks, srv)
    srv2, _, _ = restore_server(str(tmp_path), _comp(0))
    pool2 = srv2._tier_pool(tier)
    _assert_bitwise(srv.state(1),
                    pool2.slot_state(local, expect_generation=gen))
    with pytest.raises(StaleSlotError):
        pool2.slot_state(local, expect_generation=gen - 1)
    assert int(pool2.states.generation[local]) == gen


def test_refusals_fallback_and_wire_cursors(tmp_path):
    store.save(str(tmp_path / "plain"), 1, {"w": np.zeros((3,))})
    with pytest.raises(ValueError, match="serve"):
        restore_server(str(tmp_path / "plain"), _comp(0), step=1)
    srv = StreamServer(_comp(0), _server_cfg(k_ladder=None))
    other = StreamServer(_comp(0), _server_cfg(k_ladder=None))
    with pytest.raises(ValueError, match="different StreamServer"):
        snapshot_server(srv, ingest=IngestServer(other))
    ingest = IngestServer(srv, strict_seq=True)
    loop = Loopback(ingest)
    chunks = _chunks(11)
    assert loop.send(codec.encode_control(codec.OP_OPEN, 4)).ok
    d = str(tmp_path / "serve")
    for seq in range(2):
        assert loop.send(codec.encode_chunk(chunks[seq], stream_id=4,
                                            seq=seq, timestamp_ns=0)).ok
        ingest.tick()
        save_server(d, srv.n_ticks, srv, ingest=ingest)
    os.unlink(os.path.join(d, "step_00000002", "shard_0.npz"))
    srv2, ing2, step = restore_server(d, _comp(0), with_ingest=True)
    assert step == 1 and srv2.n_ticks == 1
    assert ing2.strict_seq and ing2._seq_seen == {4: 0}
    reply = codec.decode_reply(ing2.handle_message(codec.encode_chunk(
        chunks[0], stream_id=4, seq=0, timestamp_ns=0)))
    assert reply.status == codec.NACK_OUT_OF_ORDER


def test_checkpointer_cadence_gc_and_inflight_restore(tmp_path):
    srv = StreamServer(_comp(0), _server_cfg(k_ladder=None))
    chunks = _chunks(9, n_frames=56)
    srv.admit(1)
    with pytest.raises(ValueError, match="every_ticks"):
        ServeCheckpointer(str(tmp_path), srv, every_ticks=0)
    ckpt = ServeCheckpointer(str(tmp_path), srv, every_ticks=2, keep=2)
    saves = 0
    for i in range(7):
        srv.submit(1, chunks[i])
        srv.tick()
        saves += ckpt.maybe_save()
        assert not ckpt.maybe_save()  # idempotent within a tick
    ckpt.wait()
    assert saves == 3 and ckpt.n_saves == 3
    assert store.complete_steps(str(tmp_path)) == [4, 6]
    ckpt.save_now()  # possibly still in flight
    srv2, _, step = ckpt.restore(_comp(0))
    assert step == 7 and srv2.live_sessions == [1]
    _assert_bitwise(srv.state(1), srv2.state(1))


@pytest.mark.parametrize("asynchronous", [False, True],
                         ids=["sync", "async"])
def test_save_is_consistent_with_open_and_close_on_another_thread(
        tmp_path, monkeypatch, asynchronous):
    """An OPEN and a CLOSE sent from another thread while a save copies
    the pool land wholly after the save: every restored slot's active
    flag, generation and state agree with the saved session table."""
    srv = StreamServer(_comp(0), _server_cfg(k_ladder=None))
    ingest = IngestServer(srv)
    loop = Loopback(ingest)
    chunks = _chunks(13)
    for sid in (1, 2):
        assert loop.send(codec.encode_control(codec.OP_OPEN, sid)).ok
    for seq in range(2):
        for sid in (1, 2):
            assert loop.send(codec.encode_chunk(
                chunks[seq], stream_id=sid, seq=seq, timestamp_ns=0)).ok
        ingest.tick()
    before = {sid: pytree.tree_map(torch.clone, srv.state(sid))
              for sid in (1, 2)}
    real = store.host_snapshot
    racers = []

    def racing_snapshot(tree):
        # Close stream 1 and open stream 3 while the device tree is being
        # copied; unless a lock holds the thread off, both land now.
        t = threading.Thread(target=lambda: (
            loop.send(codec.encode_control(codec.OP_CLOSE, 1)),
            loop.send(codec.encode_control(codec.OP_OPEN, 3))))
        t.start()
        t.join(0.2)
        racers.append(t)
        return real(tree)

    monkeypatch.setattr(store, "host_snapshot", racing_snapshot)
    saver = store.AsyncSaver() if asynchronous else None
    save_server(str(tmp_path), srv.n_ticks, srv, ingest=ingest, saver=saver)
    if saver is not None:
        saver.wait()
    assert len(racers) == 1
    racers[0].join(10)
    assert not racers[0].is_alive()
    assert srv.live_sessions == [2, 3]  # the racing thread did run

    srv2, _, _ = restore_server(str(tmp_path), _comp(0))
    assert srv2.live_sessions == [1, 2]
    pool = srv2.pool
    assert pool.states.active.tolist() == [
        s is not None for s in pool.session_at]
    assert pool.states.generation.tolist() == pool._host_generation
    for sid in (1, 2):
        _assert_bitwise(before[sid], srv2.state(sid), f"stream {sid}")


def _manifest_of(mod, tmp_path):
    """One server run with churn, a ladder, queued chunks and a wire
    frontier, saved; returns ``(manifest, {key: (shape, dtype)})``."""
    is_ref = mod == "ref"
    A, S, W = (japi, jserve, jserver) if is_ref else (
        api, __import__("repro_torch.serve", fromlist=["x"]),
        __import__("repro_torch.wire.server", fromlist=["x"]))
    C = __import__("repro.wire.codec" if is_ref else "repro_torch.wire.codec",
                   fromlist=["x"])
    comp = (japi.EPICCompressor(_ecfg(jP, prefilter_k=8)) if is_ref
            else _comp(8))
    srv = S.StreamServer(comp, _server_cfg(mod=S.ServerConfig))
    ingest = W.IngestServer(srv, strict_seq=True)
    loop = W.Loopback(ingest)
    chunks = {sid: _chunks(sid, mod=A, convert=np.asarray)
              for sid in (1, 2, 3)}
    for sid in chunks:
        assert loop.send(C.encode_control(C.OP_OPEN, sid)).ok
    for i in range(3):
        for sid, cs in chunks.items():
            if sid in srv.live_sessions:
                assert loop.send(C.encode_chunk(cs[i], stream_id=sid, seq=i,
                                                timestamp_ns=0)).ok
        ingest.tick()
        if i == 1:
            assert loop.send(C.encode_control(C.OP_CLOSE, 2)).ok
    assert loop.send(C.encode_chunk(chunks[1][3], stream_id=1, seq=3,
                                    timestamp_ns=0)).ok  # stays queued
    d = str(tmp_path / mod)
    (jckpt if is_ref else __import__("repro_torch.serve.checkpoint",
                                      fromlist=["x"])).save_server(
        d, srv.n_ticks, srv, ingest=ingest)
    man = jstore.read_manifest(d, srv.n_ticks)
    step = os.path.join(d, f"step_{srv.n_ticks:08d}")
    arrays = {}
    for key, ent in man["leaves"].items():
        with np.load(os.path.join(step, f"shard_{ent['shard']}.npz")) as z:
            arrays[key] = (z[ent["name"]].shape, ent["dtype"])
    return man, arrays


def test_serve_manifest_is_the_references(tmp_path):
    ref, ref_arrays = _manifest_of("ref", tmp_path)
    got, got_arrays = _manifest_of("port", tmp_path)
    assert got_arrays == ref_arrays
    assert set(got) == set(ref)
    r, g = ref["serve"], got["serve"]
    assert set(g) == set(r) and g["schema"] == r["schema"] == SERVE_SCHEMA
    for key in ("config", "sessions", "host_generation", "counters",
                "evicted", "wire"):
        assert g[key] == r[key], key
    assert g["compressor"]["type"] == r["compressor"]["type"]
    assert ([k for k, _ in g["scheduler_cost"]]
            == [k for k, _ in r["scheduler_cost"]])


# -- the crash soak ----------------------------------------------------------


class _FlakyTransport:
    """Loopback that can die mid-wire-frame: before delivering a data
    frame it consults the injector with ``("wire", sid, seq)``."""

    def __init__(self, loop, injector):
        self.loop, self.inj = loop, injector

    def send(self, msg):
        if self.inj is not None:
            kind, frame = codec.decode_message(msg)
            if kind == "data":
                self.inj.maybe_fail(("wire", frame.stream_id, frame.seq))
        return self.loop.send(msg)


def _run_soak(tmp_path, fail_at, *, tiers=None, damage_newest=False):
    inj = fault.FailureInjector(fail_at)
    chunks = {sid: _chunks(sid) for sid in range(1, N_STREAMS + 1)}
    srv = StreamServer(_comp(8), _server_cfg(tiers=tiers))
    ingest = IngestServer(srv)
    ckpt = (ServeCheckpointer(str(tmp_path), srv, every_ticks=2,
                              ingest=ingest)
            if tmp_path is not None else None)
    loop = Loopback(ingest)
    sess = {sid: ResumableSession(_FlakyTransport(loop, inj), sid,
                                  drain=ingest.tick) for sid in chunks}
    for s in sess.values():
        assert s.open().ok
    pos = {sid: 0 for sid in chunks}
    i = n_crashes = 0
    while i < N_ROUNDS:
        try:
            for sid, s in sess.items():
                if pos[sid] == i:
                    pos[sid] = i + 1
                    s.send_chunk(chunks[sid][i])
            inj.maybe_fail(("mid_tick", i))
            ingest.tick()
            if ckpt is not None:
                ckpt.maybe_save()
            inj.maybe_fail(("post_tick", i))
            i += 1
        except fault.WorkerFailure:
            n_crashes += 1
            ckpt.wait()
            if damage_newest:  # dying mid-save: a partial newest step
                newest = store.latest_step(str(tmp_path))
                part = tmp_path / f"step_{newest + 1:08d}"
                part.mkdir()
                (part / "shard_0.npz").write_bytes(b"partial write")
                tmp = tmp_path / f"step_{newest + 2:08d}.tmp"
                tmp.mkdir()
                (tmp / "shard_0.npz").write_bytes(b"crashed")
            srv, ingest, _ = restore_server(str(tmp_path), _comp(8),
                                            with_ingest=True)
            assert srv.step_cache_sizes() == {}
            ckpt = ServeCheckpointer(str(tmp_path), srv, every_ticks=2,
                                     ingest=ingest)
            loop = Loopback(ingest)
            for s in sess.values():
                s.transport = _FlakyTransport(loop, inj)
                s.drain = ingest.tick
                s.resume()
    while any(len(q) for q in srv._queues.values()):
        ingest.tick()
    if ckpt is not None:
        ckpt.wait()
    states = {sid: srv.state(sid) for sid in chunks}
    trajs = {sid: list(srv.telemetry(sid).k_trajectory) for sid in chunks}
    return states, trajs, srv, n_crashes


@pytest.fixture(scope="module")
def uninterrupted():
    states, trajs, _, _ = _run_soak(None, [])
    return states, trajs


@pytest.mark.parametrize(
    "fail_at,damage_newest,tiers",
    [([("mid_tick", 2)], False, None),
     ([("post_tick", 2)], True, None),
     ([("wire", 2, 3)], False, None),
     ([("mid_tick", 2), ("wire", 3, 4)], False, None),
     ([("post_tick", 2)], False, (2, 2))],
    ids=["mid_tick", "mid_save", "mid_wire_frame", "double_crash",
         "tiered_mid_migration"],
)
def test_kill_restore_replay_is_bit_exact(tmp_path, uninterrupted, fail_at,
                                          damage_newest, tiers):
    ref_states, ref_trajs = uninterrupted
    states, trajs, srv, n_crashes = _run_soak(
        tmp_path, fail_at, tiers=tiers, damage_newest=damage_newest)
    assert n_crashes == len(fail_at)
    for sid in ref_states:
        _assert_bitwise(ref_states[sid], states[sid], f"stream {sid}")
        assert ref_trajs[sid] == trajs[sid], f"stream {sid}"
    assert all(v == 1 for v in srv.step_cache_sizes().values())
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]
    if tiers is not None:
        assert srv._tiered and srv.pool.n_migrations >= 1
