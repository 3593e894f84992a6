"""The port's sharding rules and shape specs against the JAX package, in
process (no ranks): exact equality throughout.

For each of the ten architectures at its full published configuration,
under each ``shard_strategy`` the reference's tests use (``"tp"``,
``"dp"``, ``"fsdp"``), on the production meshes (16, 16) and (2, 16, 16)
(``jax.sharding.AbstractMesh`` on the reference's side, as
``tests/test_distribution.py`` builds it, ``launch.mesh.AbstractMesh`` on
the port's):

* ``param_specs``, ``opt_specs``, ``batch_specs`` for every ``get_shapes``
  entry and ``serve_specs`` for the decode shapes, leaf by leaf by key
  path;
* the per-device bytes of the port's DTensor placements equal the
  reference's ``launch/dryrun.sharded_bytes`` reckoning of its specs
  (recomputed here from the specs: importing ``dryrun`` sets
  ``XLA_FLAGS`` for every later subprocess of the worker);
* ``Model.param_spec``, ``serve_spec``, ``token_spec`` and ``batch_spec``
  shapes and dtypes leaf for leaf;
* ``layers.decode_seq_shard`` under ambient meshes.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Shard
from torch.utils import _pytree as pytree

from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.configs import get_shapes as jax_get_shapes
from repro.launch import sharding as JS
from repro.models import build_model as jax_build_model
from repro.models import layers as JL
from repro_torch.configs import get_config, get_shapes
from repro_torch.launch import mesh as M
from repro_torch.launch import sharding as S
from repro_torch.models import build_model
from repro_torch.models import layers as TL

MESHES = {"pod": (16, 16), "multi_pod": (2, 16, 16)}
STRATEGIES = ("tp", "dp", "fsdp")


def _names(shape):
    return ("pod", "data", "model") if len(shape) == 3 else ("data", "model")


def _jax_mesh(shape):
    names = _names(shape)
    try:  # jax >= 0.5: AbstractMesh(axis_sizes, axis_names)
        return jax.sharding.AbstractMesh(shape, names)
    except TypeError:  # jax 0.4.x: AbstractMesh(((name, size), ...))
        return jax.sharding.AbstractMesh(tuple(zip(names, shape)))


@functools.lru_cache(maxsize=None)
def _jax_param_shapes(arch):
    return jax_build_model(jax_get_config(arch)).param_spec()


@functools.lru_cache(maxsize=None)
def _port_param_shapes(arch):
    return build_model(get_config(arch), device="meta").param_spec()


def _jax_specs(tree):
    """``{key path: entries}`` of a JAX PartitionSpec tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {jax.tree_util.keystr(p): tuple(s) for p, s in flat}


def _port_specs(tree):
    flat, _ = pytree.tree_flatten_with_path(tree)
    return {pytree.keystr(p): tuple(s) for p, s in flat}


def _jax_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): (tuple(x.shape), np.dtype(x.dtype).name)
            for p, x in flat}


def _port_leaves(tree):
    flat, _ = pytree.tree_flatten_with_path(tree)
    return {pytree.keystr(p): (tuple(x.shape), str(x.dtype).split(".")[-1])
            for p, x in flat}


def _reference_bytes(tree, specs, mesh_shape):
    """``repro.launch.dryrun.sharded_bytes``: each leaf's bytes over the
    product of the mesh axes its spec names."""
    sizes = dict(zip(_names(mesh_shape), mesh_shape))
    shapes = _jax_leaves(tree)
    total = 0
    for path, spec in _jax_specs(specs).items():
        denom = 1
        for entry in spec:
            if entry is None:
                continue
            for a in entry if isinstance(entry, tuple) else (entry,):
                denom *= sizes[a]
        shape, dtype = shapes[path]
        total += int(np.prod(shape)) * np.dtype(dtype).itemsize // denom
    return total


def _placement_bytes(tree, specs, mesh):
    """Per-device bytes of the port's DTensor placements of ``tree``."""
    sizes = [M.mesh_shape(mesh)[n] for n in M.mesh_axes(mesh)]
    total = 0
    for x, spec in zip(pytree.tree_leaves(tree), S.leaves_like(tree, specs)):
        shape = list(x.shape)
        for i, pl in enumerate(S.to_placements(spec, mesh)):
            if isinstance(pl, Shard):
                shape[pl.dim] //= sizes[i]
        total += int(np.prod(shape)) * x.element_size()
    return total


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_match_the_reference(arch, mesh, strategy):
    shape = MESHES[mesh]
    jmesh, tmesh = _jax_mesh(shape), M.AbstractMesh(shape, _names(shape))
    jcfg = jax_get_config(arch).replace(shard_strategy=strategy)
    tcfg = get_config(arch).replace(shard_strategy=strategy)
    jp, tp = _jax_param_shapes(arch), _port_param_shapes(arch)

    jspecs = JS.param_specs(jcfg, jp, jmesh)
    tspecs = S.param_specs(tcfg, tp, tmesh)
    assert _port_specs(tspecs) == _jax_specs(jspecs)
    assert _placement_bytes(tp, tspecs, tmesh) == _reference_bytes(
        jp, jspecs, shape)

    jo, to = JS.opt_specs(jcfg, jp, jmesh), S.opt_specs(tcfg, tp, tmesh)
    assert to.step == tuple(jo.step) == ()
    for name in ("mu", "nu"):
        assert _port_specs(getattr(to, name)) == _jax_specs(getattr(jo, name))
    assert _placement_bytes(tp, to.mu, tmesh) == _reference_bytes(
        jp, jo.mu, shape)

    jm, tm = jax_build_model(jcfg), build_model(tcfg, device="meta")
    for js, ts in zip(jax_get_shapes(arch), get_shapes(arch)):
        assert (js.name, js.seq_len, js.global_batch) == (
            ts.name, ts.seq_len, ts.global_batch)
        assert _port_specs(S.batch_specs(tcfg, ts, tmesh)) == _jax_specs(
            JS.batch_specs(jcfg, js, jmesh)), js.name
        if js.kind != "decode" or js.skip:
            continue
        b = js.global_batch
        jstate = jm.serve_spec(b, js.seq_len)
        tstate = tm.serve_spec(b, ts.seq_len)
        jss = JS.serve_specs(jcfg, jstate, jmesh, b)
        tss = S.serve_specs(tcfg, tstate, tmesh, b)
        assert _port_specs(tss) == _jax_specs(jss), js.name
        assert _placement_bytes(tstate, tss, tmesh) == _reference_bytes(
            jstate, jss, shape), js.name


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shape_specs_match_the_reference_leaf_for_leaf(arch):
    jm = jax_build_model(jax_get_config(arch))
    tm = build_model(get_config(arch), device="cpu")
    assert _port_leaves(tm.param_spec()) == _jax_leaves(
        _jax_param_shapes(arch))
    assert all(x.device.type == "meta"
               for x in pytree.tree_leaves(tm.param_spec()))
    for b, s in ((2, 64), (3, 17)):
        assert _port_leaves(tm.serve_spec(b, s)) == _jax_leaves(
            jm.serve_spec(b, s))
        tok, jtok = tm.token_spec(b), jm.token_spec(b)
        assert (tuple(tok.shape), tok.dtype) == (tuple(jtok.shape),
                                                 torch.int32)
        assert str(jtok.dtype) == "int32"
    for js, ts in zip(jax_get_shapes(arch), get_shapes(arch)):
        assert _port_leaves(tm.batch_spec(ts)) == _jax_leaves(
            jm.batch_spec(js)), js.name


@pytest.mark.parametrize("shape", [(2, 4), (4, 2), (2, 2, 4), (1, 8), (8, 1)])
def test_decode_seq_shard_matches_the_reference(shape, monkeypatch):
    """The flash-decoding decision over a grid of batch, kv-heads and cache
    lengths, under an ambient mesh of ``shape`` (the reference reads its
    ambient mesh's axis sizes, patched here to the same)."""
    names = _names(shape) if len(shape) != 2 else ("data", "model")
    sizes = dict(zip(names, shape))
    monkeypatch.setattr(JL, "ambient_mesh_axes", lambda: dict(sizes))
    seen = set()
    with M.use_mesh(M.AbstractMesh(shape, names)):
        assert TL.ambient_mesh_axes() == sizes
        for batch in (1, 2, 3, 4, 8):
            for kv in (1, 2, 3, 4, 8):
                for skv in (6, 8, 16, 30):
                    got = TL.decode_seq_shard(batch, kv, skv)
                    assert got == JL.decode_seq_shard(batch, kv, skv)
                    seen.add(got)
    assert None in seen and (len(seen) > 1) == (sizes["model"] > 1)
    assert TL.ambient_mesh_axes() == {}
    assert TL.decode_seq_shard(8, 1, 16) is None


def test_specs_normalise_as_partition_specs_do():
    P = jax.sharding.PartitionSpec
    for entries in ((), ("model", None), (("data",), None),
                    (None, ("data", "model")), ((), "model")):
        assert tuple(S.P(*entries)) == tuple(P(*entries))
