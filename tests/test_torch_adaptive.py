"""Adaptive K in the PyTorch port: ``EPICCompressor(k_ladder=...)`` and
``serve/adaptive.py``'s controller against the JAX package, on the fixed
stream of ``tests/test_sparse_v2.py``'s ``TestAdaptiveK`` (32 frames of
64x64, key 5, oracle depth, capacity 48, chunks of 8, ladder
(4, 8, 16, 48)), rendered once by the JAX package and handed to both as
numpy.  The K trajectory, every counter and the integer/boolean state are
exact; float state within 1e-5.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from _torch_parity import assert_leaves_match, to_torch
from repro import api as japi
from repro.core import pipeline as jpipe
from repro.data import synthetic as jsyn
from repro.serve import adaptive as jadaptive
from repro_torch import api as tapi
from repro_torch.core import pipeline as tpipe
from repro_torch.serve import adaptive as tadaptive

LADDER = (4, 8, 16, 48)
CHUNK = 8


@functools.lru_cache(maxsize=None)
def _stream():
    scfg = jsyn.StreamConfig(n_frames=32, hw=(64, 64), n_obj=4)
    s, _ = jsyn.generate_stream(jax.random.PRNGKey(5), scfg)
    return tuple(np.asarray(x) for x in (s.frames, s.poses, s.gazes, s.depth))


def _cfg(mod, prefilter_k=4):
    return mod.EPICConfig(frame_hw=(64, 64), patch=16, capacity=48, tau=0.10,
                          gamma=0.015, theta=8, window=16,
                          prefilter_k=prefilter_k)


def _chunks(api, convert=lambda x: x):
    s = _stream()
    for lo in range(0, s[0].shape[0], CHUNK):
        yield api.SensorChunk(*(convert(x[lo:lo + CHUNK]) for x in s))


def _run_port(ladder=LADDER, prefilter_k=4, **kw):
    comp = tapi.EPICCompressor(_cfg(tpipe, prefilter_k), device="cpu",
                               k_ladder=ladder, **kw)
    state, stats = comp.init(), []
    for c in _chunks(tapi, to_torch):
        state, st = comp.step(state, c)
        stats.append(st)
    return comp, state, tapi.concat_stats(stats)


def _port_leaves(state):
    return [*state.bypass, *state.buf, state.t]


def test_trajectory_and_state_match_jax():
    jcomp = japi.EPICCompressor(_cfg(jpipe), k_ladder=LADDER)
    jstate, jstats = jcomp.init(), []
    for c in _chunks(japi):
        jstate, st = jcomp.step(jstate, c)
        jstats.append(st)
    jstats = jax.tree.map(lambda *xs: np.concatenate(xs), *jstats)

    comp, state, stats = _run_port()
    assert comp.k_trajectory == jcomp.k_trajectory
    # The controller climbs a rung after every chunk that overflowed.
    assert comp.k_trajectory == [4, 8, 16, 48]
    assert_leaves_match(jstats, stats, what="FrameStats")
    assert_leaves_match(jax.tree.leaves(jstate), _port_leaves(state),
                        what="EPICState")
    assert set(comp._rung_cfgs) == set(comp.k_trajectory)


def test_a_ladder_that_never_moves_is_the_fixed_k_run():
    fixed = tapi.EPICCompressor(_cfg(tpipe, 48), device="cpu")
    state = fixed.init()
    for c in _chunks(tapi, to_torch):
        state, _ = fixed.step(state, c)
    comp, adaptive_state, _ = _run_port(ladder=(48,), prefilter_k=48)
    assert comp.k_trajectory == [48] * 4
    for a, b in zip(_port_leaves(state), _port_leaves(adaptive_state)):
        assert torch.equal(a, b)


def test_run_session_drives_the_controller():
    comp = tapi.EPICCompressor(_cfg(tpipe), device="cpu", k_ladder=LADDER)
    stream = tapi.SensorChunk(*map(to_torch, _stream()))
    state, stats = tapi.run_session(comp, stream, CHUNK)
    assert comp.k_trajectory == _run_port()[0].k_trajectory
    assert int(stats.buffer_valid[-1]) > 0


def test_ladder_validation():
    for bad in ((), (0, 4), (8, 8), (16, 8), ("a",)):
        with pytest.raises((ValueError, TypeError)):
            tapi.EPICCompressor(_cfg(tpipe), device="cpu", k_ladder=bad)
    with pytest.raises(ValueError, match="not a rung"):
        tapi.EPICCompressor(_cfg(tpipe, 5), device="cpu", k_ladder=(4, 8))
    with pytest.raises(ValueError, match="shrink_margin"):
        tapi.EPICCompressor(_cfg(tpipe), device="cpu", k_ladder=(4, 8),
                            shrink_margin=0)
    comp = tapi.EPICCompressor(_cfg(tpipe, 0), device="cpu", k_ladder=(4, 8))
    assert comp.k_ladder == (4, 8)
    assert tapi.EPICCompressor(_cfg(tpipe), device="cpu").k_ladder is None


@pytest.mark.parametrize("history_limit", [None, 2])
def test_controller_matches_jax_on_a_counter_sequence(history_limit):
    """The decision rule alone, on a fixed (overflow, peak) sequence, with
    a rung cap set and lifted on the way."""
    seq = [(3, 9), (1, 20), (0, 30), (5, 40), (0, 3), (0, 1), (0, 0), (2, 9)]
    ctl = [m.KLadderController(LADDER, shrink_margin=2,
                               history_limit=history_limit)
           for m in (jadaptive, tadaptive)]
    for i, (overflow, peak) in enumerate(seq):
        if i == 3:
            for c in ctl:
                c.set_rung_cap(1)
        if i == 6:
            for c in ctl:
                c.set_rung_cap(None)
        ks = [(c.begin_chunk(), c.update(overflow, peak), c.rung_cap)
              for c in ctl]
        assert ks[0] == ks[1], i
    assert list(ctl[0].k_trajectory) == list(ctl[1].k_trajectory)
    with pytest.raises(ValueError, match="out of range"):
        ctl[1].set_rung_cap(len(LADDER))
    assert tadaptive.make_controller(None) is None
