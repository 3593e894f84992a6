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
* a sharded ``StreamPool`` step bitwise equal to the unsharded pool's;
* the serve checkpoint of the sharded server (``serve/checkpoint.py``),
  with one chunk queued on every live stream: its step directory
  byte-equal to the ``mesh=None`` server's (the manifest without its
  ``time`` and the scheduler's measured costs, and every array member of
  every npz; a zip member's header holds its write time), its manifest and arrays the reference's
  ``save_server`` of its own stream-sharded server on 2 forced host
  devices (a subprocess, as ``tests/test_serve.py::TestShardedServe``
  builds it: leaves, shapes and dtypes and the ``"serve"`` block exactly,
  integer arrays exactly, float arrays within ``FLOAT_ATOL``), and a
  fresh sharded server restored from it and ticked bitwise the
  uninterrupted run (saved once by ``save_server`` and once through a
  ``ServeCheckpointer``, whose step is the one restored).

Fixed seeds only.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
import zipfile

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


_SUB_ENV = {"PYTHONPATH": "src", "PATH": "/usr/bin:/bin",
            "OMP_NUM_THREADS": "1"}
for _k in ("JAX_PLATFORMS", "HOME"):
    if _k in os.environ:
        _SUB_ENV[_k] = os.environ[_k]
_SUB_ENV["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                         " --xla_force_host_platform_device_count=2").strip()

# The reference's stream-sharded server on 2 forced host devices, through
# the schedule of ``jax_run`` below and one more chunk queued on each live
# stream, saved with ``repro.serve.checkpoint.save_server``.
_REF_SHARDED_SAVE = textwrap.dedent("""
    import json, sys, numpy as np, jax
    from repro import api
    from repro.core import pipeline as P
    from repro.launch.mesh import make_stream_mesh
    from repro.serve import ServerConfig, StreamServer
    from repro.serve.checkpoint import save_server
    assert len(jax.devices()) == 2, jax.devices()
    z = np.load(sys.argv[1])
    cfg, server = ({k: tuple(v) if isinstance(v, list) else v
                    for k, v in d.items()} for d in json.loads(sys.argv[3]))
    chunks = {i: [api.SensorChunk(*(z[f"c{i}_{j}_{k}"] for k in range(4)))
                  for j in range(2)] for i in range(3)}
    srv = StreamServer(api.EPICCompressor(P.EPICConfig(**cfg)),
                       ServerConfig(**server), mesh=make_stream_mesh())
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
    for sid, c in ((0, chunks[0][1]), (2, chunks[2][1]),
                   ("fresh", chunks[1][1])):
        srv.submit(sid, c)
    print(save_server(sys.argv[2], srv.n_ticks, srv))
""")


@pytest.fixture(scope="module")
def ckpt_root(tmp_path_factory):
    return tmp_path_factory.mktemp("sharded_ckpt")


@pytest.fixture(scope="module")
def ref_sharded_save(payload, ckpt_root):
    """Started before the ranks, read after them."""
    inputs = ckpt_root / "inputs.npz"
    np.savez(inputs, **{f"c{i}_{j}_{k}": x for i in range(3)
                        for j in range(2)
                        for k, x in enumerate(payload["chunks"][i][j])})
    proc = subprocess.Popen(
        [sys.executable, "-c", _REF_SHARDED_SAVE, str(inputs),
         str(ckpt_root / "ref"),
         json.dumps([payload["cfg"], payload["server"]])],
        env=_SUB_ENV, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def ranks(payload, tmp_path_factory, ckpt_root, ref_sharded_save):
    return spawn("sharded_serve_suite", WORLD,
                 tmp_path_factory.mktemp("sharded_serve"),
                 dict(payload, ckpt=str(ckpt_root)))


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


# -- the serve checkpoint of the sharded server ------------------------------


def _step_dir(root, name, ranks):
    step = os.path.basename(ranks[0]["ckpt_path"])
    return os.path.join(str(root), name, step)


def _dir_bytes(d):
    """A step directory's bytes, but for its clock readings: the manifest's
    text without ``time`` and with the scheduler's cost keys but not its
    measured costs (seconds on the host's clock), and each npz member's
    bytes."""
    with open(os.path.join(d, "manifest.json")) as f:
        man = json.load(f)
    man.pop("time")
    cost = man["serve"]["scheduler_cost"]
    man["serve"]["scheduler_cost"] = [k for k, _ in cost]
    out = {"manifest.json": json.dumps(man)}
    for name in sorted(os.listdir(d)):
        if name.endswith(".npz"):
            with zipfile.ZipFile(os.path.join(d, name)) as z:
                for member in z.namelist():
                    out[f"{name}/{member}"] = z.read(member)
    return out


def _arrays(d):
    with open(os.path.join(d, "manifest.json")) as f:
        man = json.load(f)
    out = {}
    for key, ent in man["leaves"].items():
        with np.load(os.path.join(d, f"shard_{ent['shard']}.npz")) as z:
            out[key] = (z[ent["name"]], ent["dtype"])
    return man, out


@pytest.mark.parametrize("saved_by", ["sharded", "async"])
def test_sharded_checkpoint_is_the_unsharded_servers_bytes(ranks, ckpt_root,
                                                           saved_by):
    assert ranks[0]["ckpt_path"] == ranks[1]["ckpt_path"]
    got = _dir_bytes(_step_dir(ckpt_root, saved_by, ranks))
    want = _dir_bytes(_step_dir(ckpt_root, "local", ranks))
    assert got.keys() == want.keys()
    for name in want:
        assert got[name] == want[name], name
    assert any(k.startswith("['queues']") for k in
               json.loads(got["manifest.json"])["leaves"])


def test_sharded_checkpoint_matches_the_references_sharded_save(
        ranks, ckpt_root, ref_sharded_save):
    out, err = ref_sharded_save.communicate(timeout=400)
    assert ref_sharded_save.returncode == 0, err[-3000:]
    ref_man, ref_arrays = _arrays(out.strip().splitlines()[-1])
    man, arrays = _arrays(_step_dir(ckpt_root, "sharded", ranks))
    assert set(man) == set(ref_man)
    assert man["step"] == ref_man["step"]
    assert man["n_shards"] == ref_man["n_shards"]
    assert man["leaves"] == ref_man["leaves"]
    r, g = ref_man["serve"], man["serve"]
    assert set(g) == set(r)
    for key in ("schema", "config", "sessions", "host_generation",
                "counters", "evicted"):
        assert g[key] == r[key], key
    assert g["compressor"]["type"] == r["compressor"]["type"]
    assert ([k for k, _ in g["scheduler_cost"]]
            == [k for k, _ in r["scheduler_cost"]])
    for key, (want, dtype) in ref_arrays.items():
        have, have_dtype = arrays[key]
        assert have_dtype == dtype and have.shape == want.shape, key
        if np.issubdtype(want.dtype, np.floating):
            np.testing.assert_allclose(have, want, rtol=0, atol=FLOAT_ATOL,
                                       err_msg=key)
        else:
            np.testing.assert_array_equal(have, want, err_msg=key)


@pytest.mark.parametrize("sid", [0, 2, "fresh"])
def test_restored_sharded_server_continues_bitwise(ranks, sid):
    for r in ranks:
        assert r[f"restored/{sid}"], sid
        restored, uninterrupted = r["restored_counters"]
        assert restored == uninterrupted
