"""The slice as a whole: ``EPICCompressor.step`` of the PyTorch port
against the JAX package's, on the ``tests/test_stages.py`` setup (40
frames, 64x64, patch 16, capacity 32), rendered once by the JAX package
and handed to both as numpy.

``FrameStats`` counters and the buffer's integer/boolean state are
exact; float state is within 1e-5 (relative as well where a depth model
fills the buffer's depth crops: see ``test_torch_models.py``).
"""

import jax
import numpy as np
import pytest
import torch

from _torch_parity import assert_leaves_match, stream_64, to_torch
from repro import api as japi
from repro.core import depth as jdepth
from repro.core import hir as jhir
from repro.core import pipeline as jpipe
from repro_torch import api as tapi
from repro_torch import convert
from repro_torch.core import pipeline as tpipe

N_FRAMES = 40


def _cfg(mod, **kw):
    base = dict(frame_hw=(64, 64), patch=16, capacity=32, tau=0.10,
                gamma=0.015, theta=8, window=16)
    base.update(kw)
    return mod.EPICConfig(**base)


def _models(kind):
    """``(jax models, port models)`` with the same weights."""
    if kind == "oracle":
        return jpipe.EPICModels(), tpipe.EPICModels()
    # HIR seed 3 marks about half of the patches salient on this stream.
    hir = jhir.init_params(jax.random.PRNGKey(3))
    thir = convert.hir_from_jax(jax.tree.map(np.asarray, hir), device="cpu")
    if kind == "hir":
        return (jpipe.EPICModels(hir_params=hir),
                tpipe.EPICModels(hir_model=thir))
    dep = jdepth.init_params(jax.random.PRNGKey(3))
    tdep = convert.depth_from_jax(jax.tree.map(np.asarray, dep), device="cpu")
    return (jpipe.EPICModels(depth_params=dep, hir_params=hir),
            tpipe.EPICModels(depth_model=tdep, hir_model=thir))


def _chunks(models_kind):
    s = stream_64(N_FRAMES)
    depth = None if models_kind == "depth+hir" else s["depth"]
    jchunk = japi.SensorChunk(s["frames"], s["poses"], s["gazes"], depth)
    tchunk = tapi.SensorChunk(*(to_torch(x) for x in jchunk))
    return jchunk, tchunk


def _port_leaves(state):
    return [*state.bypass, *state.buf, state.t]


# name -> (models, JAX backend, port backend, extra config)
CASES = {
    "oracle_ref": ("oracle", "ref", "ref", {}),
    "oracle_fused": ("oracle", "ref", "fused", {}),
    "hir_fused": ("hir", "ref", "fused", {}),
    "depth_hir_fused": ("depth+hir", "ref", "fused", {}),
    "sparse_tiled": ("hir", "ref", "pallas_tiled",
                     dict(prefilter_k=24, patch_k=16)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_compressor_matches_jax(case):
    kind, jb, tb, extra = CASES[case]
    jm, tm = _models(kind)
    jchunk, tchunk = _chunks(kind)
    jcomp = japi.get_compressor("epic")(_cfg(jpipe, backend=jb, **extra), jm)
    jstate, jstats = jax.jit(jcomp.step)(jcomp.init(), jchunk)
    tcomp = tapi.get_compressor("epic")(
        _cfg(tpipe, backend=tb, **extra), tm, device="cpu"
    )
    tstate, tstats = tcomp.step(tcomp.init(), tchunk)

    rtol = 1e-5 if kind == "depth+hir" else 0.0
    assert_leaves_match(jstats, tstats, rtol=rtol, what="FrameStats")
    assert_leaves_match(jax.tree.leaves(jstate), _port_leaves(tstate),
                        rtol=rtol, what="EPICState")
    assert_leaves_match(
        jax.tree.leaves(jcomp.export(jstate)),
        list(tcomp.export(tstate)), rtol=rtol, what="RetainedPatches",
    )
    # The run did real work: frames bypassed and processed, patches
    # matched and inserted.
    processed = tstats.processed.numpy()
    assert 0 < processed.sum() < N_FRAMES
    assert int(tstats.n_matched.sum()) > 0 and int(tstats.n_inserted.sum()) > 0
    assert all(t.device.type == "cpu" for t in _port_leaves(tstate))


@pytest.mark.parametrize("chunk_size", [8, 7])
def test_chunked_ingest_equals_one_shot(chunk_size):
    _, tm = _models("hir")
    _, stream = _chunks("hir")
    comp = tapi.EPICCompressor(_cfg(tpipe), tm, device="cpu")
    one_state, one_stats = comp.step(comp.init(), stream)
    state, stats = tapi.run_session(comp, stream, chunk_size)
    for a, b in zip(_port_leaves(one_state), _port_leaves(state)):
        assert torch.equal(a, b)
    for a, b in zip(one_stats, stats):
        assert torch.equal(a, b)


def test_pad_remainder_and_numpy_chunks():
    """``iter_chunks`` pads or drops the ragged tail, and float64 numpy
    input does not leak into the state."""
    s = stream_64(N_FRAMES)
    stream = tapi.SensorChunk(
        s["frames"].astype(np.float64), s["poses"], s["gazes"], s["depth"]
    )
    chunks = list(tapi.iter_chunks(stream.to("cpu"), 16, remainder="pad"))
    assert [c.n_frames for c in chunks] == [16, 16, 16]
    assert torch.equal(chunks[-1].frames[-1], chunks[-1].frames[7])
    assert [c.n_frames for c in tapi.iter_chunks(stream, 16, remainder="drop")
            ] == [16, 16]
    with pytest.raises(ValueError, match="remainder"):
        list(tapi.iter_chunks(stream, 16, remainder="bogus"))
    comp = tapi.EPICCompressor(_cfg(tpipe), device="cpu")
    state, _ = comp.step(comp.init(), stream)
    assert all(t.dtype in (torch.float32, torch.int32, torch.bool)
               for t in _port_leaves(state))
