"""The port's collective accounting (``repro_torch.launch.hloparse``)
against the reference's ``repro.launch.hloparse``.

* ``analyze_collectives``: the port's dict equals the reference's on the
  reference test's HLO sample and its upcast variant, on variants with
  async ``-start``/``-done`` pairs, list-form ``replica_groups``, a
  ``conditional`` and nested loops, and on a real post-SPMD HLO text that
  JAX compiles in a subprocess on 8 forced host devices (a ``shard_map``
  with a ``lax.scan`` over an all-gather, a reduce-scatter, an
  all-to-all, a ``ppermute`` and a ``psum``);
* ``analyze_records``: hand-reckoned totals, wire bytes, counts and
  detail rows, exactly;
* the ``Recorder`` on a fake process group of 4 ranks (a subprocess): the
  op, output bytes and group size of each ``torch.distributed`` call and
  of a DTensor redistribution, in issue order.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro.launch import hloparse as ref
from repro_torch.launch import hloparse as port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SUB_ENV = {"PYTHONPATH": os.path.join(ROOT, "src"), "PATH": "/usr/bin:/bin",
            "OMP_NUM_THREADS": "1"}
for _k in ("JAX_PLATFORMS", "HOME"):
    if _k in os.environ:
        _SUB_ENV[_k] = os.environ[_k]

# tests/test_distribution.py's sample
HLO_SAMPLE = """HloModule test, num_partitions=4

%body (p: (s32[], f32[8,8])) -> (s32[], f32[8,8]) {
  %ar = f32[8,8]{1,0} all-reduce(%x), replica_groups=[2,2]<=[4], to_apply=%add
}

ENTRY %main (a: f32[8,8]) -> f32[8,8] {
  %w = (s32[], f32[8,8]) while(%t), condition=%c, body=%body, backend_config={"known_trip_count":{"n":"10"}}
  %ag = f32[16,8]{1,0} all-gather(%y), replica_groups=[1,4]<=[4], dimensions={0}
}
"""

ASYNC_AND_LISTS = """HloModule test, num_partitions=8

%inner (p: (s32[], bf16[4,16])) -> (s32[], bf16[4,16]) {
  %rs = bf16[4,16]{1,0} reduce-scatter(%y), replica_groups={{0,1,2,3},{4,5,6,7}}, dimensions={0}, to_apply=%add
  %cp = bf16[4,16]{1,0} collective-permute(%rs), source_target_pairs={{0,1},{1,0}}
}

%outer (p: (s32[], f32[32])) -> (s32[], f32[32]) {
  %w2 = (s32[], bf16[4,16]) while(%t2), condition=%c2, body=%inner, backend_config={"known_trip_count":{"n":"3"}}
  %a2a = f32[32]{0} all-to-all(%convert_fusion.1), replica_groups=[4,2]<=[8], dimensions={0}
}

%on_true (p: f32[8]) -> f32[8] {
  %ar2 = f32[8]{0} all-reduce(%q), replica_groups={{0,1}}, to_apply=%add
}

%on_false (p: f32[8]) -> f32[8] {
  %ag2 = s32[2,8]{1,0} all-gather(%q), replica_groups=[4,2]<=[8], dimensions={0}
}

ENTRY %main (a: f32[32]) -> f32[32] {
  %w = (s32[], f32[32]) while(%t), condition=%c, body=%outer, backend_config={"known_trip_count":{"n":"4"}}
  %ags = (f32[8,8]{1,0}, f32[32,8]{1,0}) all-gather-start(%z), replica_groups=[2,4]<=[8], dimensions={0}
  %agd = f32[32,8]{1,0} all-gather-done(%ags)
  %ars = f32[64]{0} all-reduce-start(%convert.3), replica_groups={}, to_apply=%add
  %ard = f32[64]{0} all-reduce-done(%ars)
  %cond = f32[8]{0} conditional(%pred, %x, %x), true_computation=%on_true, false_computation=%on_false
}
"""

BRANCHES = """HloModule test, num_partitions=4

%b0 (p: f32[4]) -> f32[4] {
  %x0 = f32[4]{0} all-reduce(%p), replica_groups=[1,4]<=[4], to_apply=%add
}

%b1 (p: f32[4]) -> f32[4] {
  %x1 = pred[16]{0} all-to-all(%p), replica_groups=[2,2]<=[4], dimensions={0}
}

ENTRY %main (i: s32[], a: f32[4]) -> f32[4] {
  %c = f32[4]{0} conditional(%i, %a, %a), branch_computations={%b0, %b1}
}
"""

TEXTS = {
    "sample": HLO_SAMPLE,
    "upcast": HLO_SAMPLE.replace("all-reduce(%x)",
                                 "all-reduce(%convert_fusion)"),
    "async_lists_conditional": ASYNC_AND_LISTS,
    "branch_computations": BRANCHES,
}


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_analyze_collectives_is_the_references(name):
    want = ref.analyze_collectives(TEXTS[name])
    got = port.analyze_collectives(TEXTS[name])
    assert got == want
    assert port.split_computations(TEXTS[name]) == ref.split_computations(
        TEXTS[name])


def test_the_sample_is_counted_as_the_references_test_reckons():
    r = port.analyze_collectives(HLO_SAMPLE)
    assert r["by_op"]["all-reduce"] == 10 * 8 * 8 * 4
    assert r["counts"]["all-reduce"] == 10
    assert r["wire_bytes"] == pytest.approx(10 * 256 * 1.0 + 512 * 0.75)
    up = port.analyze_collectives(TEXTS["upcast"])
    assert up["tpu_wire_bytes"] < up["wire_bytes"]


_REAL_HLO = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import sys
    import jax, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    mesh = jax.make_mesh((2, 4), ("data", "model"))

    def body(c, x):
        g = jax.lax.all_gather(x, "model", tiled=True)
        r = jax.lax.psum_scatter(g * 2.0, "model", tiled=True)
        a = jax.lax.all_to_all(r, "model", 0, 0, tiled=True)
        p = jax.lax.ppermute(a, "model", [(i, (i + 1) % 4) for i in range(4)])
        s = jax.lax.psum(p, "data")
        return c + 1, s

    def f(x):
        return jax.lax.scan(body, 0, x)[1]

    try:
        smap = jax.shard_map
        kw = dict(check_vma=False)
    except AttributeError:
        from jax.experimental.shard_map import shard_map as smap
        kw = dict(check_rep=False)
    g = smap(f, mesh=mesh, in_specs=P(None, "data", "model"),
             out_specs=P(None, "data", "model"), **kw)
    text = jax.jit(g).lower(jnp.ones((5, 16, 32), jnp.float32)).compile(
    ).as_text()
    with open(sys.argv[1], "w") as fh:
        fh.write(text)
""")


def test_a_real_post_spmd_hlo_is_read_as_the_reference_reads_it(tmp_path):
    path = tmp_path / "module.hlo"
    out = subprocess.run([sys.executable, "-c", _REAL_HLO, str(path)],
                         env=_SUB_ENV, cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    text = path.read_text()
    want = ref.analyze_collectives(text)
    assert port.analyze_collectives(text) == want
    # every kind the function issues, each inside the 5-step scan
    for op in ("all-gather", "reduce-scatter", "all-to-all",
               "collective-permute", "all-reduce"):
        assert want["counts"].get(op, 0) >= 5, (op, want["counts"])


def test_analyze_records_gives_the_hand_reckoned_numbers():
    R = port.Record
    records = [R("all-reduce", 1024, 4), R("all-gather", 4096, 4),
               R("all-reduce", 1024, 4), R("reduce-scatter", 256, 2),
               R("all-to-all", 800, 8), R("collective-permute", 100, 4),
               R("all-reduce", 64, 1)]
    got = port.analyze_records(records)
    assert got["total_bytes"] == 1024 * 2 + 4096 + 256 + 800 + 100 + 64
    assert got["wire_bytes"] == (2 * 1024 * 2 * 3 / 4 + 4096 * 3 / 4
                                 + 256 * 1 / 2 + 800 * 7 / 8 + 100)
    assert got["by_op"] == {"all-reduce": 2112, "all-gather": 4096,
                            "reduce-scatter": 256, "all-to-all": 800,
                            "collective-permute": 100}
    assert got["counts"] == {"all-reduce": 3, "all-gather": 1,
                             "reduce-scatter": 1, "all-to-all": 1,
                             "collective-permute": 1}
    assert got["detail"] == [
        {"op": "all-gather", "group": 4, "bytes": 4096, "wire_bytes": 3072.0},
        {"op": "all-reduce", "group": 1, "bytes": 64, "wire_bytes": 0.0},
        {"op": "all-reduce", "group": 4, "bytes": 2048, "wire_bytes": 3072.0},
        {"op": "all-to-all", "group": 8, "bytes": 800, "wire_bytes": 700.0},
        {"op": "collective-permute", "group": 4, "bytes": 100,
         "wire_bytes": 100.0},
        {"op": "reduce-scatter", "group": 2, "bytes": 256,
         "wire_bytes": 128.0},
    ]
    assert "tpu_wire_bytes" not in got
    assert port.analyze_records([]) == {
        "total_bytes": 0.0, "wire_bytes": 0.0, "by_op": {}, "counts": {},
        "detail": []}
    with pytest.raises(ValueError, match="unknown collective"):
        port.analyze_records([R("all-gather-start", 8, 2)])


_RECORDER = textwrap.dedent("""
    import json, warnings
    import torch, torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.hloparse import Recorder
    warnings.simplefilter("ignore")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    pair = mesh.get_group("model")
    x = torch.empty(8, 16, device="meta")
    with Recorder() as rec:
        dist.all_reduce(x)
        dist.all_gather_into_tensor(torch.empty(16, 16, device="meta"), x,
                                    group=pair)
        dist.reduce_scatter_tensor(torch.empty(4, 16, device="meta"), x,
                                   group=pair)
        dist.all_to_all_single(torch.empty_like(x), x)
        dist.broadcast(x, src=0)
        d = DTensor.from_local(torch.empty(4, 16, device="meta"), mesh,
                               [Shard(0), Replicate()], run_check=False)
        d.full_tensor()
        p = DTensor.from_local(torch.empty(8, 16, dtype=torch.bfloat16,
                                           device="meta"), mesh,
                               [Replicate(), Partial()], run_check=False)
        p.redistribute(mesh, [Replicate(), Shard(0)])
        p.redistribute(mesh, [Replicate(), Replicate()])
    print(json.dumps([list(r) for r in rec.records]))
    dist.destroy_process_group()
""")


def test_the_recorder_catches_each_call_with_its_bytes_and_group():
    out = subprocess.run([sys.executable, "-c", _RECORDER], env=_SUB_ENV,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = [tuple(r) for r in json.loads(out.stdout.strip().splitlines()[-1])]
    assert got == [
        ("all-reduce", 512, 4),
        ("all-gather", 1024, 2),
        ("reduce-scatter", 256, 2),
        ("all-to-all", 512, 4),
        ("collective-permute", 512, 4),
        ("all-gather", 512, 2),  # full_tensor over "data"
        ("reduce-scatter", 128, 2),  # Partial -> Shard(0) over "model"
        ("all-reduce", 256, 2),  # Partial -> Replicate over "model"
    ]
