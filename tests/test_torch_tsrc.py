"""DC buffer, sparse TRD and TSRC in the PyTorch port against the JAX
package.

Integer counters, ``matched``/``chosen``, the buffer's ``valid`` and ``t``
are held exactly; float state within 1e-5.  The JAX functions run under
``jax.jit``, as the reference pipeline runs them: XLA's fused
multiply-add in the eviction score decides ties (see
``repro_torch/core/dc_buffer.py``), and ties are made on purpose here.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    assert_leaves_match,
    assert_namedtuple_match,
    intrinsics_pair,
    stream_64,
    to_torch,
)
from repro.core import dc_buffer as jdcb
from repro.core import tsrc as jtsrc
from repro.kernels.reproject_match import sparse as jsparse
from repro_torch.core import dc_buffer as tdcb
from repro_torch.core import tsrc as ttsrc
from repro_torch.kernels.reproject_match import sparse as tsparse


def _buffer_arrays(rng, n, p):
    """A half-full buffer whose scores tie: integer popularities and ages,
    several entries sharing a timestamp."""
    valid = np.zeros(n, bool)
    valid[: n // 2 + 1] = True
    return dict(
        rgb=rng.uniform(size=(n, p, p, 3)).astype(np.float32),
        depth=rng.uniform(1, 4, size=(n, p, p)).astype(np.float32),
        pose=np.tile(np.eye(4, dtype=np.float32), (n, 1, 1)),
        origin=rng.integers(0, 4, size=(n, 2)).astype(np.float32) * p,
        t=rng.integers(0, 3, n).astype(np.float32),
        t_last=rng.integers(0, 4, n).astype(np.float32),
        saliency=rng.uniform(size=n).astype(np.float32),
        popularity=rng.integers(0, 3, n).astype(np.float32),
        valid=valid,
    )


def _bufs(arrays):
    names = jdcb.DCBuffer._fields
    return (
        jdcb.DCBuffer(*(jnp.asarray(arrays[k]) for k in names)),
        tdcb.DCBuffer(*(to_torch(arrays[k]) for k in names)),
    )


@pytest.mark.parametrize("seed", range(4))
def test_insert_with_ties(seed):
    rng = np.random.default_rng(seed)
    n, m, p = 12, 8, 4
    jbuf, tbuf = _bufs(_buffer_arrays(rng, n, p))
    new = dict(
        rgb=rng.uniform(size=(m, p, p, 3)).astype(np.float32),
        depth=rng.uniform(1, 4, size=(m, p, p)).astype(np.float32),
        pose=np.tile(np.eye(4, dtype=np.float32), (m, 1, 1)),
        origin=rng.integers(0, 4, size=(m, 2)).astype(np.float32),
        saliency=rng.uniform(size=m).astype(np.float32),
    )
    mask = rng.uniform(size=m) < 0.7
    t_now = np.float32(5.0)
    cfg = jdcb.DCBufferConfig(capacity=n, patch=p)
    jout = jax.jit(jdcb.insert, static_argnums=1)(
        jbuf, cfg,
        jdcb.NewEntries(*(jnp.asarray(new[k]) for k in jdcb.NewEntries._fields)),
        jnp.asarray(mask), jnp.asarray(t_now),
    )
    tout = tdcb.insert(
        tbuf, tdcb.DCBufferConfig(capacity=n, patch=p),
        tdcb.NewEntries(*(to_torch(new[k]) for k in tdcb.NewEntries._fields)),
        to_torch(mask), to_torch(t_now),
    )
    assert_namedtuple_match(jout, tout, atol=0.0)


@pytest.mark.parametrize("seed", range(3))
def test_newest_match_and_bump_with_ties_and_duplicates(seed):
    rng = np.random.default_rng(seed)
    n, m = 10, 16
    match_ok = rng.uniform(size=(n, m)) < 0.4
    entry_t = rng.integers(0, 3, n).astype(np.float32)  # many equal stamps
    valid = rng.uniform(size=n) < 0.8
    jidx, jm = jdcb.newest_match(*map(jnp.asarray, (match_ok, entry_t, valid)))
    tidx, tm = tdcb.newest_match(*map(to_torch, (match_ok, entry_t, valid)))
    assert_leaves_match([jidx, jm], [tidx, tm])

    jbuf, tbuf = _bufs(_buffer_arrays(rng, n, 4))
    idx = rng.integers(0, 3, m)  # duplicate indices accumulate
    mask = rng.uniform(size=m) < 0.6
    jb = jdcb.bump_popularity(jbuf, jnp.asarray(idx), jnp.asarray(mask),
                              t_now=jnp.float32(7.0))
    tb = tdcb.bump_popularity(tbuf, to_torch(idx), to_torch(mask),
                              t_now=torch.tensor(7.0))
    assert_namedtuple_match(jb, tb, atol=0.0)


@pytest.mark.parametrize("k", [2, 5, 40])
def test_bbox_prefilter_and_patch_compaction_with_ties(k):
    rng = np.random.default_rng(k)
    n, p, hw = 24, 16, 64
    arrays = _buffer_arrays(rng, n, p)
    arrays["valid"][:] = rng.uniform(size=n) < 0.9
    ang = rng.normal(scale=0.02, size=(n, 3)).astype(np.float32)
    tr = rng.normal(scale=0.05, size=(n, 3)).astype(np.float32)
    from repro.core import geometry as jgeo

    t_rel = np.asarray(jgeo.pose_from_rt(jgeo.rotation_xyz(jnp.asarray(ang)),
                                         jnp.asarray(tr)))
    salient = rng.uniform(size=16) < 0.6
    ji, ti = intrinsics_pair(hw)
    _, jorig = jtsrc.extract_patches(jnp.zeros((hw, hw, 3)), p)
    _, torig = ttsrc.extract_patches(torch.zeros(hw, hw, 3), p)
    jbuf, tbuf = _bufs(arrays)
    jpre = jax.jit(
        functools.partial(jsparse.bbox_prefilter, o_min=0.5, k=k),
        static_argnums=8,
    )(*jdcb.entry_bbox_inputs(jbuf), jnp.asarray(t_rel), jbuf.t, jbuf.valid,
      jorig, jnp.asarray(salient), ji, p)
    tpre = tsparse.bbox_prefilter(
        *tdcb.entry_bbox_inputs(tbuf), to_torch(t_rel), tbuf.t, tbuf.valid,
        torig, to_torch(salient), ti, p, o_min=0.5, k=k,
    )
    assert int(tpre.n_pass) > 5  # k = 2, 5 truncate passing entries
    assert_namedtuple_match(jpre, tpre, atol=1e-3)  # bbox: 1e-3, rest exact
    for pk in (3, 8):
        jpc = jsparse.compact_salient_patches(
            jnp.asarray(salient), jpre.overlap_ok, jpre.passes, k=pk
        )
        tpc = tsparse.compact_salient_patches(
            to_torch(salient), tpre.overlap_ok, tpre.passes, k=pk
        )
        assert_namedtuple_match(jpc, tpc)


# name -> (JAX backend, port backend, prefilter_k, patch_k)
BRANCHES = {
    "dense_ref": ("ref", "ref", 0, 0),
    "dense_fused": ("fused", "fused", 0, 0),
    "prefilter_overflow": ("ref", "ref", 4, 0),
    "patch_overflow": ("ref", "ref", 0, 4),
    "fused_sparse": ("fused", "fused", 4, 4),
}


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_tsrc_step_branches_match_jax(branch):
    _run_branch_against_jax(branch)


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_tsrc_step_branches_in_the_kernels_order_match_jax(branch,
                                                           monkeypatch):
    """The five branches with the scores summed in the CUDA kernel's order
    (``warp_order.py``) in place of the plain ones: the counters and the
    buffer still equal the JAX package's, so no threshold decided by the
    kernel's order flips on this stream."""
    from repro_torch.kernels.reproject_match import fused, ops, warp_order

    calls = []

    def counted(fn):
        def run(*args, **kwargs):
            calls.append(fn.__name__)
            return fn(*args, **kwargs)
        return run

    monkeypatch.setattr(ops, "reproject_match_ref",
                        counted(warp_order.reproject_match_warp_order))
    monkeypatch.setattr(fused, "reproject_match_fused_ref",
                        counted(warp_order.reproject_match_fused_warp_order))
    _run_branch_against_jax(branch)
    assert calls and all("warp_order" in c for c in calls)


def _run_branch_against_jax(branch):
    jb, tb, pk, ptk = BRANCHES[branch]
    s = stream_64()
    p, cap, n_frames = 16, 16, 6
    rng = np.random.default_rng(1)
    sal = rng.uniform(size=(n_frames, 16)) < 0.7
    score = rng.uniform(size=(n_frames, 16)).astype(np.float32)
    common = dict(tau=0.10, o_min=0.5, c_min=0.6, window=16,
                  prefilter_k=pk, patch_k=ptk)
    jcfg = jtsrc.TSRCConfig(backend=jb, **common)
    tcfg = ttsrc.TSRCConfig(backend=tb, **common)
    jbuf_cfg = jdcb.DCBufferConfig(capacity=cap, patch=p)
    tbuf_cfg = tdcb.DCBufferConfig(capacity=cap, patch=p)
    ji, ti = intrinsics_pair(64)
    jstep = jax.jit(jtsrc.tsrc_step, static_argnums=(1, 2))
    jbuf = jdcb.init(jbuf_cfg)
    tbuf = tdcb.init(tbuf_cfg, "cpu")
    overflow = 0
    for i in range(n_frames):
        args = [s["frames"][i], s["depth"][i], sal[i], score[i], s["poses"][i],
                np.float32(i)]
        jbuf, jst = jstep(jbuf, jbuf_cfg, jcfg, *map(jnp.asarray, args), ji)
        tbuf, tst = ttsrc.tsrc_step(tbuf, tbuf_cfg, tcfg, *map(to_torch, args), ti)
        assert_namedtuple_match(jst, tst)
        assert_namedtuple_match(jbuf, tbuf)
        overflow += int(tst.n_prefilter_overflow) + int(tst.n_patch_overflow)
        if i > 0:
            assert int(tst.n_matched) > 0  # the match algebra did run
    assert (overflow > 0) == (pk > 0 or ptk > 0)


def test_sequential_oracle_agrees_with_dense_step():
    """The port's newest-first early-exit walk and its dense step choose
    the same matches (the frame is half old content, half new)."""
    rng = np.random.default_rng(5)
    p, hw = 16, 64
    f1 = torch.from_numpy(rng.uniform(size=(hw, hw, 3)).astype(np.float32))
    f2 = f1.clone()
    f2[:, 32:] = torch.from_numpy(
        rng.uniform(size=(hw, 32, 3)).astype(np.float32)
    )
    cfg = ttsrc.TSRCConfig(tau=0.05, window=32, backend="ref")
    buf_cfg = tdcb.DCBufferConfig(capacity=32, patch=p)
    intr = intrinsics_pair(hw)[1]
    common = (torch.full((hw, hw), 3.0), torch.ones(16, dtype=torch.bool),
              torch.ones(16), torch.eye(4))
    buf, _ = ttsrc.tsrc_step(tdcb.init(buf_cfg, "cpu"), buf_cfg, cfg, f1,
                             *common, torch.tensor(0.0), intr)
    # A second copy of the first frame: equal timestamps among candidates.
    buf, _ = ttsrc.tsrc_step(buf, buf_cfg, cfg, f1 + 1.0, *common,
                             torch.tensor(0.0), intr)
    chosen, matched = ttsrc.tsrc_step_sequential_oracle(
        buf, buf_cfg, cfg, f2, *common, torch.tensor(1.0), intr
    )
    _, stats = ttsrc.tsrc_step(buf, buf_cfg, cfg, f2, *common,
                               torch.tensor(1.0), intr)
    assert int(stats.n_matched) == int(matched.sum()) == 8
    assert int(stats.n_inserted) == 16 - int(matched.sum())
    dense_chosen, dense_matched = _dense_choice(buf, cfg, f2, intr, p)
    np.testing.assert_array_equal(dense_matched.numpy(), matched)
    np.testing.assert_array_equal(dense_chosen.numpy()[matched], chosen[matched])


def _dense_choice(buf, cfg, frame, intr, p):
    from repro_torch.core import geometry as geo
    from repro_torch.kernels.reproject_match.ref import reproject_match_ref

    _, origins = ttsrc.extract_patches(frame, p)
    t_rel = geo.invert_pose(torch.eye(4)) @ buf.pose
    diff, cov, bbox = reproject_match_ref(
        buf.rgb, buf.depth, buf.origin, t_rel, frame, intr, cfg.window
    )
    ov = geo.bbox_overlap_fraction(bbox[:, None], origins[None], p) >= cfg.o_min
    ok = ((diff <= cfg.tau) & (cov >= cfg.c_min) & buf.valid)[:, None] & ov
    return tdcb.newest_match(ok, buf.t, buf.valid)


def test_sparse_reproject_match_scatters_like_jax():
    """Phase 2 on the candidate slabs, scattered back to dense shapes."""
    from _torch_parity import reproject_inputs

    n, p, hw = 12, 16, 64
    arrays = reproject_inputs(9, n, p, hw)
    rgb, depth, origin, t_rel, frame = arrays
    rng = np.random.default_rng(9)
    entry_t = rng.integers(0, 3, n).astype(np.float32)
    valid = rng.uniform(size=n) < 0.8
    salient = rng.uniform(size=16) < 0.7
    ji, ti = intrinsics_pair(hw)
    corners = np.stack([depth[:, 0, 0], depth[:, 0, -1], depth[:, -1, 0],
                        depth[:, -1, -1]], -1)
    _, jorig = jtsrc.extract_patches(jnp.zeros((hw, hw, 3)), p)
    _, torig = ttsrc.extract_patches(torch.zeros(hw, hw, 3), p)
    jpre = jsparse.bbox_prefilter(
        *map(jnp.asarray, (origin, corners, t_rel, entry_t, valid)), jorig,
        jnp.asarray(salient), ji, p, o_min=0.3, k=5,
    )
    tpre = tsparse.bbox_prefilter(
        *map(to_torch, (origin, corners, t_rel, entry_t, valid)), torig,
        to_torch(salient), ti, p, o_min=0.3, k=5,
    )
    assert int(tpre.n_full) > 0
    jout = jsparse.sparse_reproject_match(
        *map(jnp.asarray, arrays), ji, jpre, window=32, backend="ref"
    )
    tout = tsparse.sparse_reproject_match(
        *map(to_torch, arrays), ti, tpre, window=32, backend="ref"
    )
    np.testing.assert_allclose(np.asarray(jout[0]), tout[0].numpy(), atol=1e-5)
    np.testing.assert_allclose(np.asarray(jout[1]), tout[1].numpy(), atol=1e-5)
    np.testing.assert_allclose(np.asarray(jout[2]), tout[2].numpy(), atol=1e-3)


def test_byte_accounting_matches_jax():
    from repro.core import retained as jret
    from repro_torch.core import retained as tret

    for p in (8, 16, 32):
        assert tret.patch_rgb_bytes(p) == jret.patch_rgb_bytes(p)
        assert tret.retained_patch_bytes(p) == jret.retained_patch_bytes(p)
        assert tret.dc_entry_bytes(p) == jret.dc_entry_bytes(p)
    assert tret.bbox_row_bytes() == jret.bbox_row_bytes()
    jbuf, tbuf = _bufs(_buffer_arrays(np.random.default_rng(0), 10, 16))
    assert int(tdcb.memory_bytes(tbuf)) == int(jdcb.memory_bytes(jbuf))
    assert int(tdcb.to_retained(tbuf).memory_bytes()) == int(
        jdcb.to_retained(jbuf).memory_bytes()
    )
