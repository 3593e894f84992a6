"""The four streaming baselines (FV / SD / TD / GC) of the PyTorch port
against the JAX package, on the ``tests/test_stages.py`` setup (40 frames
of 64x64, patch 16; FV unbounded, the others at a budget of 64 patches),
rendered once by the JAX package and handed to both as numpy; and the
one-shot formulations of ``core/baselines.py``.

Retained patches, counters, cursors and clocks are exact, except SD's
resized pixels (and their origins' scale), within 1e-5: an antialiased
bilinear resize sums its taps in another order.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_parity import assert_leaves_match, stream_64, to_torch
from repro import api as japi
from repro.core import baselines as jbase
from repro_torch import api as tapi
from repro_torch.core import baselines as tbase
from repro_torch.core import pipeline as tpipe

N_FRAMES = 40
CASES = [("fv", -1), ("sd", 64), ("td", 64), ("gc", 64)]


def _cfg(mod, budget, **kw):
    return mod.BaselineConfig(frame_hw=(64, 64), patch=16,
                              budget_patches=budget, n_frames=N_FRAMES, **kw)


def _chunks():
    s = stream_64(N_FRAMES)
    jchunk = japi.SensorChunk(s["frames"], s["poses"], s["gazes"], s["depth"])
    return jchunk, tapi.SensorChunk(*(to_torch(x) for x in jchunk))


def _port_leaves(state):
    return [state.rp.rgb, state.rp.t, state.rp.origin, state.rp.valid,
            state.cursor, state.frame_idx]


@pytest.mark.parametrize("name,budget", CASES)
def test_baseline_matches_jax(name, budget):
    jchunk, tchunk = _chunks()
    jcomp = japi.get_compressor(name)(_cfg(japi, budget))
    jstate, jstats = jax.jit(jcomp.step)(jcomp.init(), jchunk)
    tcomp = tapi.get_compressor(name)(_cfg(tapi, budget), device="cpu")
    tstate, tstats = tcomp.step(tcomp.init(), tchunk)

    atol = 1e-5 if name == "sd" else 0.0
    assert_leaves_match(jstats, tstats, what="BaselineFrameStats")
    assert_leaves_match(jax.tree.leaves(jstate), _port_leaves(tstate),
                        atol=atol, what="BaselineState")
    assert [t.dtype for t in tstats] == [torch.bool, torch.int32, torch.int32]
    assert tstate.cursor.dtype == tstate.frame_idx.dtype == torch.int32
    assert int(tstate.frame_idx) == N_FRAMES
    assert int(tstats.buffer_valid[-1]) == min(tcomp.cfg.capacity,
                                               int(tstate.cursor)) > 0
    assert_leaves_match(jax.tree.leaves(jcomp.export(jstate)),
                        list(tcomp.export(tstate))[:4], atol=atol,
                        what="export")


@pytest.mark.parametrize("name,budget", CASES)
@pytest.mark.parametrize("chunk_size", [7, 16])
def test_chunked_ingest_equals_one_shot(name, budget, chunk_size):
    _, stream = _chunks()
    comp = tapi.get_compressor(name)(_cfg(tapi, budget), device="cpu")
    one_state, one_stats = comp.step(comp.init(), stream)
    state, stats = tapi.run_session(comp, stream, chunk_size)
    for a, b in zip(_port_leaves(one_state), _port_leaves(state)):
        assert torch.equal(a, b)
    for a, b in zip(one_stats, stats):
        assert torch.equal(a, b)


def test_retain_saturates_past_the_budget():
    """FV at a budget of 40 patches fills it in the third frame (16 + 16 +
    8 written); later frames write nothing and the cursor counts on."""
    _, stream = _chunks()
    comp = tapi.get_compressor("fv")(_cfg(tapi, 40), device="cpu")
    state, stats = comp.step(comp.init(), stream)
    assert int(state.cursor) == N_FRAMES * 16
    assert stats.n_inserted.tolist()[:4] == [16, 16, 8, 0]
    assert stats.buffer_valid.tolist()[-1] == 40
    jcomp = japi.get_compressor("fv")(_cfg(japi, 40))
    jchunk, _ = _chunks()
    jstate, jstats = jax.jit(jcomp.step)(jcomp.init(), jchunk)
    assert_leaves_match(jstats, stats, what="stats")
    assert_leaves_match(jax.tree.leaves(jstate), _port_leaves(state),
                        atol=0.0, what="state")


def test_baseline_config_checks_square_frames():
    with pytest.raises(ValueError, match="square"):
        tapi.BaselineConfig(frame_hw=(64, 32)).grid


@pytest.mark.parametrize("fn,budget", [
    ("full_video", None), ("temporal_downsample", 64),
    ("spatial_downsample", 64), ("spatial_downsample", 1000),
    ("gaze_crop", 64), ("gaze_crop", 200),
])
def test_one_shot_formulations_match_jax(fn, budget):
    s = stream_64(N_FRAMES)
    args = [s["frames"]] + ([s["gazes"]] if fn == "gaze_crop" else [])
    extra = [16] + ([] if budget is None else [budget])
    want = getattr(jbase, fn)(*map(jnp.asarray, args), *extra)
    got = getattr(tbase, fn)(*map(to_torch, args), *extra)
    atol = 1e-5 if fn == "spatial_downsample" else 0.0
    assert_leaves_match(jax.tree.leaves(want), list(got)[:4], atol=atol,
                        what=fn)


def test_from_dc_buffer_carries_the_metadata():
    comp = tapi.EPICCompressor(
        tpipe.EPICConfig(frame_hw=(64, 64), capacity=32), device="cpu")
    state = comp.init()
    rp = tbase.from_dc_buffer(state.buf)
    assert rp.saliency is state.buf.saliency and rp.t_last is state.buf.t_last
    assert torch.equal(rp.rgb, comp.export(state).rgb)
