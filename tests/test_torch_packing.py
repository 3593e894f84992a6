"""Token packing, the energy-model counters and the energy model of the
PyTorch port against the JAX package.

Each port function gets the JAX run's own state or stats, as numpy, so
that it is tested alone: ``tokens()`` within 1e-6 of the reference's
(``packing.pack_dc_buffer`` / ``pack_retained``: thumbnail means and
normalisations sum and divide in float32), the subsample indices exactly;
``stream_counters`` / ``pool_stream_counters`` integers equal; the energy
model's joules and bytes equal (the same Python on equal integers).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import stream_64, to_torch
from repro import api as japi
from repro.core import energy as jenergy
from repro.core import hir as jhir
from repro.core import packing as jpacking
from repro.core import pipeline as jpipe
from repro_torch import api as tapi
from repro_torch.core import dc_buffer as tdcb
from repro_torch.core import energy as tenergy
from repro_torch.core import frame_bypass as tbypass
from repro_torch.core import packing as tpacking
from repro_torch.core import pipeline as tpipe
from repro_torch.core import retained as tret

TOKEN_ATOL = 1e-6
SYSTEMS = ("FVS", "SDS", "TDS", "GCS", "EPIC+GPU", "EPIC+Acc",
           "EPIC+Acc+InSensor")
CFG = dict(frame_hw=(64, 64), patch=16, capacity=32, tau=0.10, gamma=0.015,
           theta=8, window=16)


def _chunk():
    s = stream_64(40)
    return japi.SensorChunk(s["frames"], s["poses"], s["gazes"], s["depth"])


def _epic_run(**kw):
    """The JAX package's EPIC run on the ``test_stages`` stream with the
    HIR network (so saliency and popularity vary): ``(cfg kwargs, comp,
    state, stats)``."""
    cfg = {**CFG, **kw}
    comp = japi.EPICCompressor(
        jpipe.EPICConfig(**cfg),
        jpipe.EPICModels(hir_params=jhir.init_params(jax.random.PRNGKey(3))),
    )
    state, stats = jax.jit(comp.step)(comp.init(), _chunk())
    return cfg, comp, state, stats


@pytest.fixture(scope="module")
def dense():
    return _epic_run()


@pytest.fixture(scope="module")
def sparse():
    return _epic_run(prefilter_k=8, patch_k=8)


def _port_epic_state(jstate):
    t = [to_torch(np.asarray(x)) for x in jax.tree.leaves(jstate)]
    n_bypass = len(tbypass.BypassState._fields)
    return tpipe.EPICState(tbypass.BypassState(*t[:n_bypass]),
                           tdcb.DCBuffer(*t[n_bypass:-1]), t[-1])


def _port_stats(jstats):
    return tpipe.FrameStats(*(to_torch(np.asarray(x)) for x in jstats))


def _assert_tokens(want, got):
    assert got.tokens.dtype == torch.float32 and got.mask.dtype == torch.bool
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_allclose(got.tokens.numpy(), np.asarray(want.tokens),
                               atol=TOKEN_ATOL, rtol=0)


@pytest.mark.parametrize("seq_len", [8, 32, 48])
def test_epic_tokens_match_jax(dense, seq_len):
    cfg, jcomp, jstate, _ = dense
    tcomp = tapi.EPICCompressor(tpipe.EPICConfig(**cfg), device="cpu")
    tstate = _port_epic_state(jstate)
    assert int(tstate.buf.valid.sum()) > 8  # the subsample has work to do
    _assert_tokens(jcomp.tokens(jstate, seq_len),
                   tcomp.tokens(tstate, seq_len))


@pytest.mark.parametrize("name,budget", [("fv", -1), ("sd", 64), ("td", 64),
                                         ("gc", 64)])
@pytest.mark.parametrize("seq_len", [48, 200])
def test_baseline_tokens_match_jax(name, budget, seq_len):
    kw = dict(frame_hw=(64, 64), patch=16, budget_patches=budget, n_frames=40)
    jcomp = japi.get_compressor(name)(japi.BaselineConfig(**kw))
    jstate, _ = jax.jit(jcomp.step)(jcomp.init(), _chunk())
    tcomp = tapi.get_compressor(name)(tapi.BaselineConfig(**kw), device="cpu")
    leaves = [to_torch(np.asarray(x)) for x in jax.tree.leaves(jstate)]
    tstate = tapi.BaselineState(tret.RetainedPatches(*leaves[:4]),
                                *leaves[4:])
    _assert_tokens(jcomp.tokens(jstate, seq_len),
                   tcomp.tokens(tstate, seq_len))


@pytest.mark.parametrize("n,seq_len", [(640, 48), (192, 64), (32, 32),
                                       (1000, 7), (5, 1), (100, 99)])
def test_subsample_index_is_jax_linspace(n, seq_len):
    want = np.asarray(jnp.round(jnp.linspace(0, n - 1, seq_len)).astype(
        jnp.int32))
    np.testing.assert_array_equal(tpacking._subsample_index(n, seq_len), want)


def test_pack_orders_ties_stably_and_masks_invalid():
    rng = np.random.default_rng(0)
    n = 24
    rgb = rng.uniform(size=(n, 16, 16, 3)).astype(np.float32)
    t = rng.integers(0, 4, n).astype(np.float32)  # many ties
    origin = rng.integers(0, 48, (n, 2)).astype(np.float32)
    valid = rng.uniform(size=n) < 0.7
    sal = rng.uniform(size=n).astype(np.float32)
    for seq_len in (10, 24, 30):
        want = jpacking.pack(*map(jnp.asarray, (rgb, t, origin, valid)),
                             seq_len, saliency=jnp.asarray(sal), t_max=3.0,
                             frame_size=64.0)
        got = tpacking.pack(*map(to_torch, (rgb, t, origin, valid)),
                            seq_len, saliency=to_torch(sal), t_max=3.0,
                            frame_size=64.0)
        _assert_tokens(want, got)
        assert got.tokens.shape == (seq_len, tpacking.TOKEN_FEAT)


def _counter_dicts(counters):
    return [dataclasses.asdict(c) for c in counters]


@pytest.mark.parametrize("run", ["dense", "sparse"])
def test_stream_counters_match_jax(dense, sparse, run):
    cfg, _, _, jstats = dense if run == "dense" else sparse
    want = jpipe.stream_counters(jpipe.EPICConfig(**cfg), jstats)
    got = tpipe.stream_counters(tpipe.EPICConfig(**cfg), _port_stats(jstats))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert want.n_processed > 0 and want.dc_traffic_bytes > 0
    if run == "sparse":
        assert int(np.asarray(jstats.n_patch_checked).sum()) > 0
    # The int8_depth keyword is accepted and changes nothing, as in JAX.
    assert dataclasses.asdict(tpipe.stream_counters(
        tpipe.EPICConfig(**cfg), _port_stats(jstats), int8_depth=False)
    ) == dataclasses.asdict(want)


def test_pool_stream_counters_match_jax(dense, sparse):
    cfg = dense[0]
    jpool = jax.tree.map(lambda a, b: jnp.stack([a, b]), dense[3], sparse[3])
    tpool = _port_stats(jpool)
    for streams in (None, [1]):
        want = jpipe.pool_stream_counters(jpipe.EPICConfig(**cfg), jpool,
                                          streams=streams)
        got = tpipe.pool_stream_counters(tpipe.EPICConfig(**cfg), tpool,
                                         streams=streams)
        assert _counter_dicts(got) == _counter_dicts(want)
    assert tpipe.depth_mod_macs() == jpipe.depth_mod_macs()
    assert tpipe.hir_macs() == jpipe.hir_macs()


@pytest.mark.parametrize("system", SYSTEMS)
def test_energy_model_matches_jax(dense, system):
    cfg, _, _, jstats = dense
    want_c = jpipe.stream_counters(jpipe.EPICConfig(**cfg), jstats)
    got_c = tpipe.stream_counters(tpipe.EPICConfig(**cfg), _port_stats(jstats))
    if not system.startswith("EPIC"):  # a baseline's static schedule
        kw = dict(n_frames=40, frame_px=64 * 64, n_processed=40,
                  stored_bytes=40 * 64 * 64 * 3, h264=True, patch_px=256)
        want_c = jenergy.StreamCounters(**kw)
        got_c = tenergy.StreamCounters(**kw)
    assert tenergy.system_energy(system, got_c) == jenergy.system_energy(
        system, want_c)
    assert tenergy.total_energy(system, got_c) == jenergy.total_energy(
        system, want_c)
    assert tenergy.memory_footprint_bytes(got_c) == (
        jenergy.memory_footprint_bytes(want_c))
