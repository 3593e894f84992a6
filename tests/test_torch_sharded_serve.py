"""The stream-sharded ``StreamServer`` (and ``StreamPool``) of the port on
two gloo ranks.

The schedule is the reference's ``tests/test_serve.py::TestShardedServe``:
three streams on four slots (two a rank) under the ladder (4, 8, 16), two
ticks, stream 1 closed and ``"fresh"`` admitted into its slot, one more
tick, on the oracle depth track.  One spawn of two ranks
(``tests/_torch_dist.py``) runs it sharded over ``make_stream_mesh()`` and
with ``mesh=None``; held:

* every stream's state bitwise equal to the ``mesh=None`` run, and its
  ``k_trajectory`` and the server counters equal;
* against the live JAX reference's ``mesh=None`` run of the same schedule
  on the same numpy streams: ``k_trajectory`` exactly, the exported
  ``RetainedPatches`` integers exactly and floats within
  ``_torch_parity.FLOAT_ATOL`` (as ``test_torch_serve.py`` holds the
  unsharded server);
* the divisibility ``ValueError`` and the one for tiers with a mesh;
* a sharded ``StreamPool`` step bitwise equal to the unsharded pool's.

Fixed seeds only.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest

from _torch_dist import spawn
from _torch_parity import FLOAT_ATOL, assert_leaves_match
from repro import api as japi
from repro.core import pipeline as jpipe
from repro.serve import ServerConfig as JServerConfig
from repro.serve import StreamServer as JStreamServer
from repro_torch.data import synthetic as SYN

WORLD = 2
CFG = dict(frame_hw=(64, 64), patch=16, capacity=12, tau=0.10, gamma=0.015,
           theta=8, window=16, prefilter_k=4)
SERVER = dict(capacity=4, chunk_frames=8, k_ladder=(4, 8, 16))


def _stream(seed):
    s, _ = SYN.generate_stream(
        np.random.default_rng(seed),
        SYN.StreamConfig(n_frames=16, hw=(64, 64), n_obj=3), device="cpu")
    return [x.numpy() for x in (s.frames, s.poses, s.gazes, s.depth)]


@pytest.fixture(scope="module")
def payload():
    chunks = {}
    for i in range(3):
        s = _stream(80 + i)
        chunks[i] = [[x[lo:lo + 8] for x in s] for lo in (0, 8)]
    pool = [_stream(90 + i) for i in range(4)]
    return {"cfg": CFG, "server": SERVER, "chunks": chunks,
            "pool_cfg": dict(CFG, capacity=16, prefilter_k=0),
            "pool_chunk": [np.stack([s[j][:8] for s in pool])
                           for j in range(4)]}


@pytest.fixture(scope="module")
def ranks(payload, tmp_path_factory):
    return spawn("sharded_serve_suite", WORLD,
                 tmp_path_factory.mktemp("sharded_serve"), payload)


@pytest.fixture(scope="module")
def jax_run(payload):
    srv = JStreamServer(japi.EPICCompressor(jpipe.EPICConfig(**CFG)),
                        JServerConfig(**SERVER))
    chunks = {sid: [japi.SensorChunk(*c) for c in cs]
              for sid, cs in payload["chunks"].items()}
    for sid in chunks:
        srv.admit(sid)
    for step_i in range(2):
        for sid in chunks:
            srv.submit(sid, chunks[sid][step_i])
        srv.tick()
    srv.close(1)
    srv.admit("fresh")
    srv.submit("fresh", chunks[1][0])
    srv.tick()
    return srv


def test_each_rank_steps_its_own_slots(ranks):
    assert [r["owned"] for r in ranks] == [[0, 1], [2, 3]]


@pytest.mark.parametrize("sid", [0, 2, "fresh"])
def test_sharded_server_equals_one_device_bitwise(ranks, sid):
    for r in ranks:
        assert r[f"bitwise/{sid}"], sid
        sharded, local = r[f"k/{sid}"]
        assert sharded == local
    assert ranks[0]["counters"][0] == ranks[0]["counters"][1]
    assert ranks[1]["counters"] == ranks[0]["counters"]


@pytest.mark.parametrize("sid", [0, 2, "fresh"])
def test_sharded_server_matches_the_jax_reference(ranks, jax_run, sid):
    for r in ranks:
        assert r[f"k/{sid}"][0] == list(jax_run.telemetry(sid).k_trajectory)
        jret = jax_run.export(sid)
        assert_leaves_match(jax.tree.leaves(jret),
                            [x for x in r[f"export/{sid}"] if x is not None],
                            atol=FLOAT_ATOL, what=f"export {sid}")
    # the schedule moved at least one stream off its starting rung
    assert len({k for sid_ in (0, 2, "fresh")
                for k in ranks[0][f"k/{sid_}"][0]}) >= 2


def test_a_mesh_that_does_not_divide_and_tiers_with_a_mesh_raise(ranks):
    for r in ranks:
        assert "divide evenly" in r["errors"]["divide"]
        assert "divide evenly" in r["errors"]["pool_divide"]
        assert "mutually exclusive" in r["errors"]["tiers"]


def test_sharded_stream_pool_equals_the_unsharded_pool(ranks):
    for r in ranks:
        assert r["pool_bitwise"]
        assert r["pool_local_rows"] == {(2,)}
