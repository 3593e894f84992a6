"""Multi-stream serving in the PyTorch port (``repro_torch.serve``,
``repro_torch.api.StreamPool``) on the CPU.

Small size throughout, as ``tests/test_serve.py``: 64x64 frames, patch 16,
DC buffers of 32 (48 under a ladder), window 16, chunks of 8, pools of 2-8
slots, ``k_ladder=(4, 8, 16)``.  Held:

* against solo port sessions: every served stream's state, stats and
  ``k_trajectory``, bitwise on the oracle depth track (the slot-batched
  step is ``torch.func.vmap`` over the session body, with the bypass gate
  in its select form); on the predicted depth tracks, whose CPU
  convolutions and sigmoid round a frame's last bits differently with the
  batch, integers equal and floats within ``_torch_parity.FLOAT_ATOL``;
* against the live JAX reference: one ``StreamServer`` run with churn, a
  ladder and tiers through both packages on the same numpy streams —
  ``k_trajectory``, the per-stream telemetry and ``server_counters()``
  exactly, the exported ``RetainedPatches`` integers exactly and floats
  within ``_torch_parity.FLOAT_ATOL``;
* the reference's ``test_serve.py`` cases that need no mesh or wire;
* the batched bodies under ``warnings.simplefilter("error")``, so that a
  vmap fallback to a per-sample loop (which warns) fails; and each kernel
  custom op's vmap rule against per-slot calls.

Fixed seeds only; no ``@given``.
"""

import functools
import warnings

import jax
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from _torch_parity import FLOAT_ATOL, assert_leaves_match, to_torch
from repro import api as japi
from repro import serve as jserve
from repro.core import pipeline as jpipe
from repro_torch import api
from repro_torch import serve
from repro_torch.api.pool import tree_map
from repro_torch.core import pipeline as P
from repro_torch.data import synthetic as SYN
from repro_torch.serve import (
    ChunkQueue,
    Prefetch,
    ServerConfig,
    SlottedPool,
    StreamServer,
)

FRAME = 64
PATCH = 16
CHUNK = 8
LADDER = (4, 8, 16)


def _ecfg(mod=P, **kw):
    base = dict(
        frame_hw=(FRAME, FRAME), patch=PATCH, capacity=32,
        tau=0.10, gamma=0.015, theta=8, window=16,
    )
    base.update(kw)
    return mod.EPICConfig(**base)


@functools.lru_cache(maxsize=None)
def _stream_np(seed, n_frames=16, n_obj=4):
    """A stream rendered by the port from a numpy seed, as numpy arrays
    (frames, poses, gazes, depth)."""
    s, _ = SYN.generate_stream(
        np.random.default_rng(seed),
        SYN.StreamConfig(n_frames=n_frames, hw=(FRAME, FRAME), n_obj=n_obj),
        device="cpu",
    )
    return tuple(x.numpy() for x in (s.frames, s.poses, s.gazes, s.depth))


def _chunks(seed, n_frames=16, n_obj=4, mod=api, convert=to_torch,
            depth=True):
    s = _stream_np(seed, n_frames, n_obj)
    return [
        mod.SensorChunk(*(convert(x[lo:lo + CHUNK]) for x in s[:3]),
                        convert(s[3][lo:lo + CHUNK]) if depth else None)
        for lo in range(0, n_frames, CHUNK)
    ]


def _zero(chunk):
    return api.SensorChunk(*(None if x is None else torch.zeros_like(x)
                             for x in chunk))


def _batch(rows):
    return api.SensorChunk(*(None if xs[0] is None else torch.stack(xs)
                             for xs in zip(*rows)))


def _solo(cfg, chunks, k_ladder=None, models=None):
    comp = api.EPICCompressor(cfg, models, device="cpu", k_ladder=k_ladder)
    state, stats = comp.init(), []
    for c in chunks:
        state, st = comp.step(state, c)
        stats.append(st)
    return comp, state, api.concat_stats(stats)


def _assert_bitwise(a, b, msg=""):
    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    assert len(la) == len(lb), msg
    for i, (x, y) in enumerate(zip(la, lb)):
        assert (x is None and y is None) or torch.equal(x, y), \
            f"{msg} leaf {i}"


def _assert_ints_equal_floats_close(a, b, msg=""):
    """Integer and boolean leaves equal, float leaves within
    ``FLOAT_ATOL``: the rule for a track that runs the depth and HIR
    networks, whose CPU convolutions and sigmoid round a frame's last bits
    differently with the number of frames in the call."""
    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    assert len(la) == len(lb), msg
    for i, (x, y) in enumerate(zip(la, lb)):
        if x is None and y is None:
            continue
        if x.dtype.is_floating_point:
            torch.testing.assert_close(x, y, atol=FLOAT_ATOL, rtol=0.0,
                                       msg=f"{msg} leaf {i}")
        else:
            assert torch.equal(x, y), f"{msg} leaf {i}"


def _comp(cfg=None, **kw):
    return api.EPICCompressor(cfg or _ecfg(**kw), device="cpu")


# ---------------------------------------------------------------------------
# SlottedPool: admission/eviction semantics
# ---------------------------------------------------------------------------


class TestSlottedPool:
    def test_admit_evict_bookkeeping(self):
        pool = SlottedPool(_comp(capacity=8), 3)
        assert pool.free_slots() == [0, 1, 2]
        assert pool.admit("a") == 0
        assert pool.admit("b") == 1
        assert pool.n_active == 2
        assert bool(pool.states.active[0]) and bool(pool.states.active[1])
        assert pool.generation_of(0) == 1
        assert pool.states.generation.tolist() == [1, 1, 0]
        pool.evict_session("a")
        assert not bool(pool.states.active[0])
        assert pool.free_slots() == [0, 2]
        assert pool.admit("c", slot=0) == 0
        assert pool.generation_of(0) == 2
        with pytest.raises(ValueError, match="already admitted"):
            pool.admit("c")
        with pytest.raises(RuntimeError, match="pool full"):
            pool.admit("d"), pool.admit("e")
        with pytest.raises(KeyError, match="not admitted"):
            pool.slot_of("zz")

    def test_adaptive_compressor_and_mesh_rejected(self):
        comp = api.EPICCompressor(_ecfg(prefilter_k=4), device="cpu",
                                  k_ladder=(4, 8))
        with pytest.raises(ValueError, match="StreamServer"):
            SlottedPool(comp, 2)
        from repro_torch.launch.mesh import AbstractMesh

        with pytest.raises(ValueError, match="divide evenly"):
            SlottedPool(_comp(), 2, mesh=AbstractMesh((3,), ("streams",)))
        with pytest.raises(ValueError, match="not in mesh axes"):
            SlottedPool(_comp(), 2, mesh=AbstractMesh((1,), ("streams",)),
                        axis="data")

    def test_masked_step_equals_sessions_and_isolation(self):
        cfg = _ecfg(capacity=16)
        feeds = [_chunks(10 + i) for i in range(3)]
        pool = SlottedPool(_comp(cfg), 4)
        for i in range(3):
            pool.admit(i)
        frozen = pool.slot_state(3)
        for step_i in range(2):
            rows = [f[step_i] for f in feeds] + [_zero(feeds[0][0])]
            stats = pool.step(_batch(rows))
        _assert_bitwise(pool.slot_state(3), frozen, "idle slot")
        assert int(stats.processed[3].sum()) == 0
        for i, f in enumerate(feeds):
            _, ref, ref_stats = _solo(cfg, f)
            _assert_bitwise(pool.session_state(i), ref, f"stream {i}")
            _assert_bitwise([x[i] for x in stats],
                            [x[CHUNK:] for x in ref_stats], f"stats {i}")

    def test_evict_readmit_is_fresh_session_bitwise(self):
        cfg = _ecfg(capacity=16)
        pool = SlottedPool(_comp(cfg), 2)
        pool.admit("old", slot=0)
        pool.admit("other", slot=1)
        old, new = _chunks(1), _chunks(2)
        for c in old:
            pool.step(_batch([c, _zero(c)]))
        pool.evict(0)
        pool.admit("new", slot=0)
        for c in new:
            pool.step(_batch([c, _zero(c)]))
        _assert_bitwise(pool.session_state("new"), _solo(cfg, new)[1],
                        "readmitted slot")

    def test_mask_cannot_step_evicted_slot(self):
        pool = SlottedPool(_comp(capacity=16), 2)
        pool.admit("a", slot=0)
        chunk = _chunks(3)[0]
        before = pool.slot_state(1)
        pool.step(_batch([chunk, chunk]), mask=torch.ones(2, dtype=bool))
        _assert_bitwise(pool.slot_state(1), before, "never-admitted slot")

    def test_step_shape_validation(self):
        pool = SlottedPool(_comp(capacity=8), 2)
        with pytest.raises(ValueError, match="leading slot axis"):
            pool.step(_chunks(0)[0])

    def test_readmission_generation_fences_stale_handles(self):
        from repro_torch.serve import StaleSlotError

        pool = SlottedPool(_comp(capacity=8), 2)
        pool.admit("old", slot=0)
        handle = (0, pool.generation_of(0))
        pool.evict(0)
        pool.admit("new", slot=0)
        with pytest.raises(KeyError, match="not admitted"):
            pool.session_state("old")
        with pytest.raises(StaleSlotError, match="re-admitted"):
            pool.slot_state(handle[0], expect_generation=handle[1])
        assert issubclass(StaleSlotError, KeyError)
        pool.slot_state(0, expect_generation=pool.generation_of(0))

    def test_speculative_admission_inits_once(self):
        comp = _comp(capacity=8)
        calls = []
        real_init = comp.init

        class Counting:
            def __getattr__(self, name):
                return getattr(comp, name)

            def init(self):
                calls.append(1)
                return real_init()

        pool = SlottedPool(Counting(), 3)
        pool.prewarm()
        for churn in range(3):
            pool.admit(f"s{churn}")
            pool.evict_session(f"s{churn}")
        assert len(calls) == 1
        assert pool.free_slots() == [0, 1, 2]
        assert pool.states.generation.tolist() == [4, 0, 0]

    def test_no_rebuild_across_churn(self):
        """One step program for the default variant, whichever slots
        churn; a new chunk length builds one more."""
        pool = SlottedPool(_comp(capacity=16), 3)
        chunk = _chunks(4)[0]
        batch = _batch([chunk] * 3)
        pool.admit("a")
        pool.step(batch)
        pool.admit("b")
        pool.step(batch)
        pool.evict_session("a")
        pool.admit("c")
        pool.step(batch)
        assert pool.step_cache_sizes() == {None: 1}
        pool.step(api.SensorChunk(*(x[:, :4] for x in batch)))
        assert pool.step_cache_sizes() == {None: 2}


# ---------------------------------------------------------------------------
# The batched bodies: no per-sample loop, per-slot equality
# ---------------------------------------------------------------------------


def _models(kind):
    from repro_torch.core import depth as D
    from repro_torch.core import hir as H

    g = torch.Generator().manual_seed(0)
    net, hir = D.init_params(g), H.init_params(g)
    if kind == "fp32":
        return P.EPICModels(net, hir)
    rgb64 = D.resize_image(to_torch(_stream_np(7)[0][:4]), 64)
    return P.EPICModels(D.quantize_params(net, rgb64), hir)


@pytest.mark.parametrize("kind,kw", [
    ("oracle", dict(backend="fused")),
    ("oracle", dict(backend="pallas", prefilter_k=4, patch_k=8)),
    ("oracle", dict(backend="pallas_tiled", prefilter_k=8)),
    ("fp32", dict(backend="fused")),
    ("int8", dict(backend="fused")),
], ids=["oracle-fused", "oracle-pallas-sparse", "oracle-tiled",
        "fp32-depth", "int8-depth"])
def test_batched_body_runs_no_per_sample_loop_and_equals_solo(kind, kw):
    """The vmapped session body raises no warning (a vmap fallback to a
    per-sample loop warns), and each slot equals its solo session: bitwise
    on the oracle track, which runs no network; on the predicted depth
    tracks with integers equal and floats within ``FLOAT_ATOL`` (the
    networks' CPU kernels round a frame differently at batch 3 than at
    1)."""
    cfg = _ecfg(**kw)
    models = None if kind == "oracle" else _models(kind)
    oracle = kind == "oracle"
    feeds = [_chunks(20 + i, depth=oracle) for i in range(3)]
    pool = api.StreamPool(api.EPICCompressor(cfg, models, device="cpu"), 3)
    states = pool.init()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for c in range(2):
            states, stats = pool.step(states, _batch([f[c] for f in feeds]))
    same = _assert_bitwise if oracle else _assert_ints_equal_floats_close
    for i, f in enumerate(feeds):
        _, ref, ref_stats = _solo(cfg, f, models=models)
        same(tree_map(lambda x: x[i], states), ref, f"{kind} stream {i}")
        same([x[i] for x in stats], [x[CHUNK:] for x in ref_stats],
             f"{kind} stats {i}")


@pytest.mark.parametrize("name", ["fv", "gc", "sd", "td"])
def test_stream_pool_over_a_baseline_equals_sessions(name):
    bcfg = api.BaselineConfig(frame_hw=(FRAME, FRAME), patch=PATCH,
                              budget_patches=24, n_frames=16)
    comp = api.get_compressor(name)(bcfg, device="cpu")
    feeds = [_chunks(30 + i, depth=False) for i in range(3)]
    pool = api.StreamPool(comp, 3)
    states = pool.init()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for c in range(2):
            states, _ = pool.step(states, _batch([f[c] for f in feeds]))
    for i, f in enumerate(feeds):
        ref = comp.init()
        for c in f:
            ref, _ = comp.step(ref, c)
        _assert_bitwise(tree_map(lambda x: x[i], states), ref,
                        f"{name} stream {i}")
    exported = pool.export(states)
    assert exported.rgb.shape[0] == 3
    tokens = pool.tokens(states, 16)
    for i in range(3):
        one = comp.tokens(tree_map(lambda x: x[i], states), 16)
        assert all(torch.equal(a[i], b) for a, b in zip(tokens, one))


def test_stream_pool_validation():
    with pytest.raises(ValueError, match="lock-step"):
        api.StreamPool(api.EPICCompressor(_ecfg(prefilter_k=4),
                                          device="cpu", k_ladder=(4, 8)), 2)
    from repro_torch.launch.mesh import AbstractMesh

    with pytest.raises(ValueError, match="divide evenly"):
        api.StreamPool(_comp(), 2, mesh=AbstractMesh((3,), ("streams",)))
    with pytest.raises(ValueError, match="not in mesh axes"):
        api.StreamPool(_comp(), 2, mesh=AbstractMesh((1,), ("streams",)),
                       axis="data")
    pool = api.StreamPool(_comp(), 2)
    with pytest.raises(ValueError, match="leading stream axis"):
        pool.step(pool.init(), _chunks(0)[0])


def _rm_slot_inputs(slots, n, hw=64, p=16):
    from repro_torch.core import geometry as geo

    rng = np.random.default_rng(slots * 100 + n)
    t = torch.from_numpy
    t_rel = geo.pose_from_rt(
        geo.rotation_xyz(t(rng.normal(scale=0.05, size=(slots, n, 3))
                           .astype(np.float32))),
        t(rng.normal(scale=0.1, size=(slots, n, 3)).astype(np.float32)),
    ).contiguous()
    args = [
        t(rng.uniform(size=(slots, n, p, p, 3)).astype(np.float32)),
        t(rng.uniform(1.0, 4.0, size=(slots, n, p, p)).astype(np.float32)),
        t(rng.integers(0, hw - p, size=(slots, n, 2)).astype(np.float32)),
        t_rel,
        t(rng.uniform(size=(slots, hw, hw, 3)).astype(np.float32)),
    ]
    return args, geo.Intrinsics.create(0.8 * hw, hw / 2, hw / 2, "cpu")


@pytest.mark.parametrize("wrapper", ["fused", "pallas", "pallas_tiled"])
@pytest.mark.parametrize("slots,n", [(4, 12), (2, 1)])
def test_reproject_match_vmap_rule_equals_per_slot_calls(wrapper, slots, n):
    from repro_torch.kernels.reproject_match import fused, kernel

    fn = {"fused": fused.reproject_match_fused,
          "pallas": kernel.reproject_match_pallas,
          "pallas_tiled": kernel.reproject_match_pallas_tiled}[wrapper]
    args, intr = _rm_slot_inputs(slots, n)

    def call(*a):
        return fn(*a, intr, window=16)

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        batched = torch.func.vmap(call)(*args)
    for b in range(slots):
        for got, want in zip(batched, call(*(x[b] for x in args))):
            assert torch.equal(got[b], want), (wrapper, b)
    # A vmapped dimension that is not leading is moved to the front the
    # same way; two vmapped dimensions make two leading slot axes.
    moved = torch.func.vmap(call, in_dims=(1, 1, 1, 1, 3))(
        *(x.movedim(0, d) for x, d in zip(args, (1, 1, 1, 1, 3))))
    nested = torch.func.vmap(torch.func.vmap(call))(
        *(x.unflatten(0, (slots // 2, 2)) for x in args))
    for got, got2, want in zip(moved, nested, batched):
        assert torch.equal(got, want)
        assert torch.equal(got2.flatten(0, 1), want)


@pytest.mark.parametrize("wrapper", ["fused", "pallas", "pallas_tiled",
                                     "qconv"])
def test_wrappers_take_the_custom_op_only_under_vmap(wrapper, monkeypatch):
    """A solo call skips the custom op's dispatcher and computes what the op
    computes on a slot of one; under vmap the op (and its vmap rule) runs."""
    from repro_torch.kernels.int8_matmul import qconv
    from repro_torch.kernels.reproject_match import fused, kernel

    module, name, fn = {
        "fused": (fused, "rm_fused", fused.reproject_match_fused),
        "pallas": (kernel, "rm_scores", kernel.reproject_match_pallas),
        "pallas_tiled": (kernel, "rm_scores_tiled",
                         kernel.reproject_match_pallas_tiled),
        "qconv": (qconv, "qconv_int8_op", qconv.qconv_int8_pallas)}[wrapper]
    if wrapper == "qconv":
        g = torch.Generator().manual_seed(3)
        qw = torch.randint(-127, 128, (8, 6), generator=g, dtype=torch.int8)
        ws, b = 1e-2 * torch.rand(6, generator=g), torch.randn(6, generator=g)
        args = [torch.randn(2, 1, 5, 5, 8, generator=g)]

        def call(x):
            return fn(x, x.abs().amax(), qw, ws, b)
    else:
        args, intr = _rm_slot_inputs(2, 5)

        def call(*a):
            return fn(*a, intr, window=16)

    op, calls = getattr(module, name), []
    monkeypatch.setattr(module, name,
                        lambda *a: calls.append(1) or op(*a))
    solo = [call(*(x[s] for x in args)) for s in range(2)]
    assert calls == []
    batched = torch.func.vmap(call)(*args)
    assert calls  # the wrapper's call (and the rule's own, where it reads
    # the op from the module)
    for s in range(2):
        for got, want in zip(pytree.tree_leaves(batched),
                             pytree.tree_leaves(solo[s])):
            assert torch.equal(got[s], want), (wrapper, s)


def test_reproject_match_vmap_rule_refuses_batched_intrinsics():
    from repro_torch.core import geometry as geo
    from repro_torch.kernels.reproject_match.fused import (
        reproject_match_fused)

    args, intr = _rm_slot_inputs(2, 3)
    f = torch.stack([intr.f, intr.f])
    with pytest.raises(NotImplementedError, match="shared by every slot"):
        torch.func.vmap(lambda fb, *a: reproject_match_fused(
            *a, geo.Intrinsics(fb, intr.cx, intr.cy), window=16))(f, *args)


@pytest.mark.parametrize("stride,k", [(1, 1), (2, 3)])
def test_qconv_vmap_rule_keeps_each_slots_scale(stride, k):
    from repro_torch.kernels.int8_matmul.qconv import (qconv_int8_pallas,
                                                       qconv_int8_ref)

    g = torch.Generator().manual_seed(stride + k)
    x = torch.randn(5, 2, 9, 9, 8, generator=g)
    x = x * torch.linspace(0.2, 3.0, 5)[:, None, None, None, None]
    qw = torch.randint(-127, 128, (k * k * 8, 6), generator=g,
                       dtype=torch.int8)
    ws = 1e-3 + 2e-2 * torch.rand(6, generator=g)
    b = torch.randn(6, generator=g)

    def layer(xs):
        return qconv_int8_pallas(xs, xs.abs().amax(), qw, ws, b,
                                 stride=stride)

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        batched = torch.func.vmap(layer)(x)
    for s in range(5):
        assert torch.equal(batched[s], layer(x[s]))
    # The per-image form of the plain version, directly.
    scales = x.abs().amax(dim=(1, 2, 3, 4))
    flat = qconv_int8_ref(x.flatten(0, 1), scales.repeat_interleave(2), qw,
                          ws, b, stride=stride)
    assert torch.equal(flat.unflatten(0, (5, 2)), batched)


# ---------------------------------------------------------------------------
# Prefetch ingest + ChunkQueue
# ---------------------------------------------------------------------------


class TestIngest:
    def test_prefetch_bit_identical_to_sync(self):
        cfg = _ecfg(capacity=16)
        feed = _chunks(7, n_frames=32)
        _, ref, _ = _solo(cfg, feed)
        comp = _comp(cfg)
        state, n = comp.init(), 0
        for c in Prefetch(feed, depth=2, device="cpu"):
            state, _ = comp.step(state, c)
            n += 1
        assert n == 4
        _assert_bitwise(state, ref, "prefetched session")

    def test_prefetch_registered_combinator(self):
        assert set(api.available_combinators()) >= {"gated", "prefetch"}
        numpy_feed = _chunks(7, convert=np.asarray)
        pf = api.make_combinator("prefetch", numpy_feed, device="cpu")
        assert isinstance(pf, Prefetch)
        got = list(pf)
        assert [c.frames.dtype for c in got] == [torch.float32] * 2
        assert torch.equal(got[1].depth, to_torch(numpy_feed[1].depth))
        with pytest.raises(KeyError, match="unknown combinator"):
            api.get_combinator("zipline")

    def test_prefetch_depth_and_device_validation(self):
        with pytest.raises(ValueError, match="depth"):
            Prefetch([], depth=0, device="cpu")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                Prefetch([])

    def test_chunk_queue_backpressure(self):
        q = ChunkQueue(maxlen=2)
        assert q.push("c0") and q.push("c1")
        assert not q.push("c2")
        assert q.n_overflow == 1 and q.n_pushed == 2
        assert q.pop() == "c0"
        assert q.push("c2")
        assert [q.pop(), q.pop(), q.pop()] == ["c1", "c2", None]


# ---------------------------------------------------------------------------
# StreamServer: policies, backpressure, telemetry
# ---------------------------------------------------------------------------


def _server(capacity=2, cfg=None, **kw):
    cfgkw = dict(capacity=capacity, chunk_frames=CHUNK)
    cfgkw.update(kw)
    return StreamServer(_comp(cfg or _ecfg(capacity=16)),
                        ServerConfig(**cfgkw))


class TestStreamServer:
    def test_validation(self):
        comp = _comp(capacity=16)
        with pytest.raises(ValueError, match="eviction policy"):
            StreamServer(comp, ServerConfig(eviction="random"))
        with pytest.raises(ValueError, match="ServerConfig.k_ladder"):
            StreamServer(
                api.EPICCompressor(_ecfg(prefilter_k=4), device="cpu",
                                   k_ladder=(4, 8)),
                ServerConfig(),
            )
        with pytest.raises(ValueError, match="prefilter_k"):
            StreamServer(
                api.get_compressor("fv")(api.BaselineConfig(), device="cpu"),
                ServerConfig(k_ladder=(4, 8)),
            )
        with pytest.raises(ValueError, match="not a rung"):
            StreamServer(_comp(prefilter_k=24),
                         ServerConfig(k_ladder=(4, 8)))
        with pytest.raises(ValueError, match="shrink_margin"):
            StreamServer(_comp(prefilter_k=4),
                         ServerConfig(k_ladder=(4, 8), shrink_margin=0))
        from repro_torch.launch.mesh import AbstractMesh

        with pytest.raises(ValueError, match="divide evenly"):
            StreamServer(comp, ServerConfig(capacity=8),
                         mesh=AbstractMesh((3,), ("streams",)))
        with pytest.raises(ValueError, match="mutually exclusive"):
            StreamServer(comp, ServerConfig(capacity=8, tiers=(4, 4)),
                         mesh=AbstractMesh((1,), ("streams",)))

    def test_full_pool_rejects_then_lru_evicts(self):
        srv = _server(capacity=2)
        srv.admit("a"), srv.admit("b")
        with pytest.raises(RuntimeError, match="pool full"):
            srv.admit("c")
        assert srv.try_admit("c") is None
        assert srv.n_admit_rejected == 2

        lru = _server(capacity=2, eviction="lru")
        lru.admit("a"), lru.admit("b")
        with pytest.raises(ValueError, match="already admitted"):
            lru.admit("a")
        assert set(lru.live_sessions) == {"a", "b"}
        lru.submit("b", _chunks(0)[0])
        lru.tick()
        lru.admit("c")
        assert set(lru.live_sessions) == {"b", "c"}
        assert lru.n_evicted == 1
        assert lru.evicted[0].session_id == "a"

    def test_lru_eviction_tie_breaks_on_slot(self):
        lru = _server(capacity=3, eviction="lru")
        for sid in ("a", "b", "c"):
            lru.admit(sid)
        lru.admit("d")
        assert lru.evicted[0].session_id == "a"
        c0 = _chunks(0)[0]
        lru.submit("b", c0), lru.submit("c", c0)
        lru.tick()
        lru.admit("e")
        assert lru.evicted[1].session_id == "d"
        lru.submit("e", c0)
        lru.tick()
        lru.admit("f")
        assert lru.evicted[2].session_id == "b"

    def test_submit_validates_quantum_and_backpressure(self):
        srv = _server(capacity=1, queue_depth=1)
        srv.admit("a")
        c = _chunks(0)[0]
        with pytest.raises(ValueError, match="quantum"):
            srv.submit("a", api.SensorChunk(*(x[:4] for x in c)))
        with pytest.raises(KeyError, match="not admitted"):
            srv.submit("ghost", c)
        assert srv.submit("a", c)
        assert not srv.submit("a", c)
        assert srv.n_backpressure == 1
        assert srv.telemetry("a").n_queue_overflow == 1

    def test_idle_eviction(self):
        srv = _server(capacity=2, eviction="idle", idle_frames=2 * CHUNK)
        srv.admit("busy"), srv.admit("lazy")
        chunks = _chunks(0) * 2
        for c in chunks[:3]:
            srv.submit("busy", c)
            srv.tick()
        assert srv.live_sessions == ["busy"]
        assert srv.evicted and srv.evicted[0].session_id == "lazy"
        assert srv.evicted[0].idle_frames >= 2 * CHUNK

    def test_telemetry_counters(self):
        srv = _server(capacity=1)
        srv.admit("a")
        for c in _chunks(5):
            srv.submit("a", c)
            srv.tick()
        tele = srv.telemetry("a")
        assert tele.n_chunks == 2 and tele.n_frames == 16
        assert tele.n_processed >= 1
        assert tele.buffer_valid > 0
        c = srv.server_counters()
        assert c["frames_served"] == 16 and c["n_ticks"] == 2

    def test_drain_matches_submit_tick(self):
        cfg = _ecfg(capacity=16)
        feed = _chunks(9, n_frames=32)
        a = _server(cfg=cfg)
        a.admit("x")
        for c in feed:
            a.submit("x", c)
            a.tick()
        b = _server(cfg=cfg)
        numpy_feed = _chunks(9, n_frames=32, convert=np.asarray)
        b.drain({"x": Prefetch(numpy_feed, device="cpu")})
        _assert_bitwise(a.state("x"), b.state("x"), "drain vs ticks")
        assert b.server_counters() == a.server_counters()

    def test_export_and_tokens(self):
        from repro_torch.core import packing
        from repro_torch.core import retained as ret

        srv = _server(capacity=1)
        srv.admit("a")
        srv.submit("a", _chunks(5)[0])
        srv.tick()
        assert isinstance(srv.export("a"), ret.RetainedPatches)
        assert srv.tokens("a", 16).tokens.shape == (16, packing.TOKEN_FEAT)


# ---------------------------------------------------------------------------
# Per-stream adaptive K over the pool == solo adaptive sessions
# ---------------------------------------------------------------------------


class TestPerStreamAdaptiveK:
    def test_mixed_rungs_parity_and_one_program_per_rung(self):
        cfg = _ecfg(capacity=48, prefilter_k=4)
        feeds = {
            "calm": _chunks(20, n_frames=24, n_obj=1),
            "busy": _chunks(21, n_frames=24, n_obj=6),
            "mid": _chunks(22, n_frames=24, n_obj=3),
        }
        srv = StreamServer(_comp(cfg), ServerConfig(
            capacity=4, chunk_frames=CHUNK, k_ladder=LADDER))
        srv.drain(dict(feeds))
        rungs_seen = set()
        for sid, feed in feeds.items():
            solo, ref, _ = _solo(cfg, feed, k_ladder=LADDER)
            assert srv.telemetry(sid).k_trajectory == solo.k_trajectory, sid
            _assert_bitwise(srv.state(sid), ref, sid)
            rungs_seen.update(solo.k_trajectory)
        assert len(rungs_seen) >= 2
        sizes = srv.step_cache_sizes()
        assert set(sizes) == rungs_seen
        assert all(v == 1 for v in sizes.values()), sizes


# ---------------------------------------------------------------------------
# Soak: churn + mixed rungs, bitwise vs solo, no rebuild after warm-up
# ---------------------------------------------------------------------------


def test_soak_churn_parity_and_no_rebuild():
    cfg = _ecfg(capacity=48, prefilter_k=4)
    srv = StreamServer(_comp(cfg), ServerConfig(
        capacity=6, chunk_frames=CHUNK, k_ladder=LADDER))
    founders = {f"s{i}": _chunks(30 + i, n_frames=32, n_obj=1 + (i % 3) * 2)
                for i in range(5)}
    late = {f"l{i}": _chunks(40 + i, n_frames=24, n_obj=2 + i)
            for i in range(3)}
    served = {sid: [] for sid in list(founders) + list(late)}

    def serve_tick(submissions):
        for sid, chunk in submissions:
            srv.submit(sid, chunk)
            served[sid].append(chunk)
        srv.tick()

    for sid in founders:
        srv.admit(sid)
    for step_i in range(2):
        serve_tick((sid, ch[step_i]) for sid, ch in founders.items())
    warm = dict(srv.step_cache_sizes())
    for sid in ("s0", "s2", "s4"):
        srv.close(sid)
    for sid in late:
        srv.admit(sid)
    for step_i in range(2):
        serve_tick([(sid, founders[sid][2 + step_i]) for sid in ("s1", "s3")]
                   + [(sid, ch[step_i]) for sid, ch in late.items()])
    serve_tick((sid, ch[2]) for sid, ch in late.items())

    assert srv.n_evicted == 3 and srv.n_admitted == 8
    end = srv.step_cache_sizes()
    assert len(end) >= 2 and all(n == 1 for n in end.values()), end
    assert all(end[k] == n for k, n in warm.items())
    for sid in srv.live_sessions:
        solo, ref, _ = _solo(cfg, served[sid], k_ladder=LADDER)
        assert srv.telemetry(sid).k_trajectory == solo.k_trajectory
        _assert_bitwise(srv.state(sid), ref, sid)


# ---------------------------------------------------------------------------
# Telemetry: batched pool counters == per-stream, one transfer
# ---------------------------------------------------------------------------


def test_pool_stream_counters_matches_per_stream(monkeypatch):
    cfg = _ecfg(capacity=16)
    feeds = [_chunks(50 + i)[0] for i in range(3)]
    pool = api.StreamPool(_comp(cfg), 3)
    _, stats = pool.step(pool.init(), _batch(feeds))
    expect = [P.stream_counters(cfg, type(stats)(*(x[i] for x in stats)))
              for i in range(3)]
    calls = []
    real = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu",
                        lambda self, *a, **k: calls.append(1)
                        or real(self, *a, **k))
    got = serve.pool_stream_counters(cfg, stats)
    monkeypatch.undo()
    assert len(calls) == 1
    assert got == expect
    assert serve.pool_stream_counters(cfg, stats, streams=[2]) == [expect[2]]


# ---------------------------------------------------------------------------
# The live JAX reference: one server run through both packages
# ---------------------------------------------------------------------------


def _parity_run(mod_api, mod_serve, mod_pipe, convert, **extra):
    """Churn, a ladder, tiers and LRU eviction through ``mod_serve``'s
    StreamServer, on the same numpy streams: six founders, one closed and
    two admitted mid-run (one by LRU eviction).  Returns the server and
    the ids it served."""
    cfg = _ecfg(mod_pipe, capacity=48, prefilter_k=4)
    comp = mod_api.EPICCompressor(cfg, **extra)
    srv = mod_serve.StreamServer(comp, mod_serve.ServerConfig(
        capacity=6, chunk_frames=CHUNK, k_ladder=LADDER, tiers=(2, 4),
        eviction="lru", demote_idle_frames=2 * CHUNK, prewarm=True))
    feeds = {f"s{i}": _chunks(60 + i, n_frames=24, n_obj=1 + i % 3,
                              mod=mod_api, convert=convert)
             for i in range(6)}
    late = {f"l{i}": _chunks(70 + i, n_frames=16, n_obj=3, mod=mod_api,
                             convert=convert) for i in range(2)}
    for sid in feeds:
        srv.admit(sid)
    for t in range(2):
        for sid in ("s0", "s1", "s2", "s3"):
            srv.submit(sid, feeds[sid][t])
        srv.tick()
    srv.close("s4")
    srv.admit("l0")
    for sid in ("s0", "s1"):
        srv.submit(sid, feeds[sid][2])
    srv.submit("l0", late["l0"][0])
    srv.tick()
    srv.admit("l1")  # the pool is full: LRU evicts s5 (never stepped)
    for sid in ("s0", "s1"):
        srv.submit(sid, feeds[sid][0])
    srv.submit("l0", late["l0"][1])
    srv.submit("l1", late["l1"][0])
    srv.tick()
    srv.submit("l1", late["l1"][1])
    for _ in range(3):
        srv.tick()
    return srv


@functools.lru_cache(maxsize=None)
def _jax_run():
    return _parity_run(japi, jserve, jpipe, np.asarray)


def test_server_matches_the_jax_reference():
    jsrv = _jax_run()
    srv = _parity_run(api, serve, P, to_torch, device="cpu")
    assert srv.server_counters() == jsrv.server_counters()
    assert sorted(srv.live_sessions) == sorted(jsrv.live_sessions)
    assert [t.as_dict() for t in srv.evicted] == [
        t.as_dict() for t in jsrv.evicted]
    for sid in jsrv.live_sessions:
        assert srv.telemetry(sid).as_dict() == jsrv.telemetry(sid).as_dict()
        jret, ret = jsrv.export(sid), srv.export(sid)
        assert ret._fields == jret._fields
        assert_leaves_match(jax.tree.leaves(jret), list(ret),
                            atol=FLOAT_ATOL, what=f"export {sid}")
    # The run exercised what it claims to.
    c = srv.server_counters()
    assert c["n_migrations"] >= 1 and c["n_evicted"] == 2
    assert len({k for t in srv._telemetry.values()
                for k in t.k_trajectory}) >= 2


def test_server_matches_solo_port_sessions():
    """The same run against solo adaptive sessions fed what each stream
    was served (bitwise)."""
    srv = _parity_run(api, serve, P, to_torch, device="cpu")
    cfg = _ecfg(capacity=48, prefilter_k=4)
    served = {
        "s0": _chunks(60, n_frames=24, n_obj=1)[:3]
        + _chunks(60, n_frames=24, n_obj=1)[:1],
        "s1": _chunks(61, n_frames=24, n_obj=2)[:3]
        + _chunks(61, n_frames=24, n_obj=2)[:1],
        "s2": _chunks(62, n_frames=24, n_obj=3)[:2],
        "s3": _chunks(63, n_frames=24, n_obj=1)[:2],
        "l0": _chunks(70, n_frames=16, n_obj=3),
        "l1": _chunks(71, n_frames=16, n_obj=3),
    }
    assert sorted(srv.live_sessions) == sorted(served)
    for sid, feed in served.items():
        solo, ref, _ = _solo(cfg, feed, k_ladder=LADDER)
        assert srv.telemetry(sid).k_trajectory == solo.k_trajectory, sid
        _assert_bitwise(srv.state(sid), ref, sid)
