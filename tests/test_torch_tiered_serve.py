"""Tiered serving in the PyTorch port (``repro_torch.serve.tiers``, the rung
scheduler, coalesced steps, the one-sync tick readback) on the CPU, as the
reference's ``tests/test_tiered_serve.py``: a tiered pool under churn and
migration serves every stream bitwise as the flat pool does, and migration
and swaps are device copies that build no step program.  The rung
scheduler is host logic: its plans are held to the reference's on the same
groups.  Fixed seeds only.
"""

import numpy as np
import pytest
import torch

from repro.serve import adaptive as jadaptive
from repro_torch.serve import (
    DispatchPlan,
    RungScheduler,
    ServerConfig,
    SlottedPool,
    StreamServer,
    TieredPool,
    telemetry as TEL,
    validate_tiers,
)
from test_torch_serve import (
    CHUNK,
    _assert_bitwise,
    _batch,
    _chunks,
    _comp,
    _ecfg,
    _zero,
)


# ---------------------------------------------------------------------------
# TieredPool: bookkeeping, migration, swap, speculative admission
# ---------------------------------------------------------------------------


class TestTieredPool:
    def test_validation_and_addressing(self):
        with pytest.raises(ValueError, match="sum to"):
            validate_tiers((2, 4), 8)
        with pytest.raises(ValueError, match="positive"):
            validate_tiers((0, 8), 8)
        with pytest.raises(ValueError, match="positive"):
            validate_tiers((), 0)
        pool = TieredPool(_comp(capacity=8), (2, 4))
        assert pool.capacity == 6 and pool.offsets == (0, 2)
        assert pool.admit("a") == 2
        assert pool.admit("b", tier=0) == 0
        assert pool.locate("a") == (1, 0) and pool.locate("b") == (0, 0)
        assert pool.unpack_slot(5) == (1, 3)
        assert sorted(pool.live_sessions()) == ["a", "b"]
        assert pool.free_slots() == [1, 3, 4, 5]
        with pytest.raises(ValueError, match="already admitted"):
            pool.admit("a")
        for i in range(4):
            pool.admit(f"fill{i}")
        with pytest.raises(RuntimeError, match="pool full"):
            pool.admit("overflow")

    def test_migration_and_swap_preserve_state_bitwise(self):
        pool = TieredPool(_comp(capacity=16), (1, 2))
        pool.admit("x", tier=0)
        pool.admit("y", tier=1)
        for ti, sid, seed in ((0, "x", 1), (1, "y", 2)):
            chunk = _chunks(seed)[0]
            rows = [_zero(chunk)] * pool.capacities[ti]
            rows[pool.locate(sid)[1]] = chunk
            pool.tiers[ti].step(_batch(rows))
        x_ref, y_ref = pool.session_state("x"), pool.session_state("y")
        gen_before = pool.generation_of(2)
        assert pool.migrate("x", 1) == 2
        assert pool.locate("x") == (1, 1)
        assert pool.generation_of(2) == gen_before + 1
        assert pool.tiers[1].states.generation.tolist() == [1, 1]
        assert pool.tiers[0].free_slots() == [0]
        assert not bool(pool.tiers[0].states.active[0])
        _assert_bitwise(pool.session_state("x"), x_ref, "migrated x")
        with pytest.raises(ValueError, match="already in tier"):
            pool.migrate("x", 1)
        pool.admit("z", tier=0)
        z_ref = pool.session_state("z")
        pool.swap("z", "y")
        _assert_bitwise(pool.session_state("y"), y_ref, "swapped y")
        _assert_bitwise(pool.session_state("z"), z_ref, "swapped z")
        assert pool.locate("y") == (0, 0)
        with pytest.raises(ValueError, match="both in"):
            pool.swap("x", "z")
        assert pool.n_migrations == 1 and pool.n_swaps == 1

    def test_migrate_into_full_tier_refused(self):
        pool = TieredPool(_comp(capacity=8), (1, 1))
        pool.admit("a", tier=0)
        pool.admit("b", tier=1)
        with pytest.raises(RuntimeError, match="full"):
            pool.migrate("b", 0)

    def test_speculative_admission_shares_one_fresh_image(self):
        comp = _comp(capacity=8)
        calls = []
        real_init = comp.init

        class Counting:
            def __getattr__(self, name):
                return getattr(comp, name)

            def init(self):
                calls.append(1)
                return real_init()

        pool = TieredPool(Counting(), (2, 4))
        pool.prewarm()
        for i in range(6):
            pool.admit(f"s{i}")
        for i in range(6):
            pool.evict_session(f"s{i}")
        assert len(calls) == 1
        assert all(t._fresh is pool._fresh for t in pool.tiers)

    def test_prewarm_then_churn_builds_no_program(self):
        """The reference's warm-up leaves every slot free with counters at
        zero; churn and migration afterwards build nothing (step programs
        are the only programs the pool builds)."""
        pool = TieredPool(_comp(capacity=8), (1, 2))
        pool.prewarm()
        assert pool.n_migrations == 0 and pool.n_swaps == 0
        assert pool.free_slots() == [0, 1, 2]
        pool.admit("a", tier=0)
        pool.admit("b")
        pool.migrate("a", 1)
        pool.migrate("a", 0)
        pool.swap("a", "b")
        pool.evict_session("a"), pool.evict_session("b")
        assert pool.step_cache_sizes() == {}
        assert not bool(torch.cat([t.states.active for t in pool.tiers]).any())


# ---------------------------------------------------------------------------
# RungScheduler: the reference's plans on the same groups
# ---------------------------------------------------------------------------


def _plans(sched, groups, backlog=0):
    return [tuple(p) for p in sched.plan(dict(groups), backlog=backlog)]


class TestRungScheduler:
    GROUPS = {(0, 8): ["b"], (0, 4): ["a"], (0, 16): ["c"], (1, 8): ["d"],
              (1, None): ["e"]}

    @pytest.mark.parametrize("coalesce,backlog", [(False, 0), (True, 0),
                                                  (True, 3)])
    def test_plans_equal_the_reference(self, coalesce, backlog):
        ours = RungScheduler(coalesce=coalesce)
        ref = jadaptive.RungScheduler(coalesce=coalesce)
        for step in range(3):
            assert _plans(ours, self.GROUPS, backlog) == _plans(
                ref, self.GROUPS, backlog), step
            for s in (ours, ref):
                s.observe_tick([16], 0.5 * (step + 1))
                s.observe_tick([4, 8], 9.0)
        assert ours.cost_estimates() == ref.cost_estimates()
        assert ours.n_coalesced == ref.n_coalesced

    def test_plan_orders_most_expensive_first(self):
        sched = RungScheduler()
        plans = sched.plan({(0, 4): ["a"], (0, 16): ["b"], (1, 8): ["c"]})
        assert [p.key for p in plans] == [16, 8, 4]
        assert plans[0] == DispatchPlan(0, (16,), (("b",),))
        sched.observe_tick([4], 5.0)
        plans = sched.plan({(0, 4): ["a"], (0, 16): ["b"]})
        assert [p.key for p in plans] == [4, 16]

    def test_validation(self):
        with pytest.raises(ValueError, match="ema_alpha"):
            RungScheduler(ema_alpha=0.0)


# ---------------------------------------------------------------------------
# Coalesced step_multi: bitwise vs sequential per-rung steps
# ---------------------------------------------------------------------------


def test_step_multi_bitwise_equals_sequential_steps():
    cfg = _ecfg(capacity=16, prefilter_k=4)
    bodies = {k: _comp(cfg._replace(prefilter_k=k)).session_body
              for k in (4, 16)}
    feeds = [_chunks(20 + i) for i in range(4)]
    pools = [SlottedPool(_comp(cfg), 4) for _ in range(2)]
    for pool in pools:
        for i in range(4):
            pool.admit(i)
    masks = torch.tensor([[True, True, False, False],
                          [False, False, True, True]])
    for step_i in range(2):
        batch = _batch([f[step_i] for f in feeds])
        s_a = pools[0].step(batch, mask=masks[0], make_body=bodies[4], key=4)
        s_b = pools[0].step(batch, mask=masks[1], make_body=bodies[16],
                            key=16)
        seq = [a | b if a.dtype == torch.bool else a + b
               for a, b in zip(s_a, s_b)]
        multi = pools[1].step_multi(batch, masks, [bodies[4], bodies[16]],
                                    key=(4, 16))
        _assert_bitwise(list(multi), seq, "stats")
    _assert_bitwise(pools[1].states.sessions, pools[0].states.sessions,
                    "states")
    assert pools[1].step_cache_sizes() == {(4, 16): 1}


# ---------------------------------------------------------------------------
# Telemetry: multi-tier readback in one device-to-host copy
# ---------------------------------------------------------------------------


def test_multi_tier_tick_readback_single_copy(monkeypatch):
    comp = _comp(capacity=16)
    parts = []
    for cap, seeds in ((2, (30, 31)), (3, (32,))):
        pool = SlottedPool(comp, cap)
        rows = [_zero(_chunks(0)[0])] * cap
        for i, seed in enumerate(seeds):
            pool.admit(f"t{cap}s{i}")
            rows[i] = _chunks(seed)[0]
        parts.append(pool.step(_batch(rows)))
    calls = []
    real = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu",
                        lambda self, *a, **k: calls.append(1)
                        or real(self, *a, **k))
    rb = TEL.tick_readback(parts)
    monkeypatch.undo()
    assert len(calls) == 1
    assert rb.processed.shape == (5,)
    solo = [TEL.tick_readback(p) for p in parts]
    for field in ("overflow", "peak_full", "processed", "inserted",
                  "buffer_valid"):
        np.testing.assert_array_equal(
            getattr(rb, field),
            np.concatenate([getattr(s, field) for s in solo]))
    with pytest.raises(ValueError, match="at least one"):
        TEL.tick_readback([])


# ---------------------------------------------------------------------------
# Tiered StreamServer: facade behaviour + rebalancing
# ---------------------------------------------------------------------------


def _servers(ladder=(4, 8, 16), **tiered_kw):
    cfg = _ecfg(capacity=48, prefilter_k=4)
    base = dict(capacity=6, chunk_frames=CHUNK, k_ladder=ladder)
    flat = StreamServer(_comp(cfg), ServerConfig(**base))
    tiered_kw = dict(
        dict(tiers=(2, 4), demote_idle_frames=2 * CHUNK, prewarm=True),
        **tiered_kw,
    )
    tiered = StreamServer(_comp(cfg), ServerConfig(**base, **tiered_kw))
    return flat, tiered


class TestTieredServer:
    def test_validation(self):
        with pytest.raises(ValueError, match="sum to"):
            StreamServer(_comp(capacity=16),
                         ServerConfig(capacity=8, tiers=(2, 2)))
        with pytest.raises(ValueError, match="arrival_alpha"):
            StreamServer(_comp(capacity=16),
                         ServerConfig(capacity=8, tiers=(2, 6),
                                       arrival_alpha=0.0))

    def test_idle_demotes_active_promotes(self):
        _, srv = _servers(ladder=None)
        for i in range(4):
            srv.admit(f"s{i}")
        assert all(srv.telemetry(f"s{i}").tier == 1 for i in range(4))
        feeds = {f"s{i}": _chunks(40 + i, n_frames=40) for i in range(2)}
        for t in range(5):
            for sid, chunks in feeds.items():
                srv.submit(sid, chunks[t])
            srv.tick()
        assert {srv.telemetry(f"s{i}").tier for i in range(2)} == {0}
        assert {srv.telemetry(f"s{i}").tier for i in range(2, 4)} == {1}
        assert srv.telemetry("s0").n_migrations >= 1
        for _ in range(3):
            srv.tick()
        assert {srv.telemetry(f"s{i}").tier for i in range(2)} == {1}
        assert srv.server_counters()["n_migrations"] >= 4

    def test_tiered_counters_and_cache_keys(self):
        _, srv = _servers(ladder=None)
        srv.admit("a")
        for c in _chunks(5):
            srv.submit("a", c)
            srv.tick()
        c = srv.server_counters()
        assert c["frames_served"] == 16 and c["n_dispatches"] == 2
        assert srv.step_cache_sizes() == {(1, None): 1, (0, None): 1}
        assert srv.telemetry("a").tier == 0

    def test_soak_tiered_bitwise_flat_with_churn_and_migration(self):
        flat, tiered = _servers(coalesce_rungs=True)
        feeds = {f"s{i}": _chunks(60 + i, n_frames=40, n_obj=1 + (i % 3) * 2)
                 for i in range(4)}

        def run(srv):
            for sid in feeds:
                srv.admit(sid)
            for t in range(3):
                for i in (0, 1, 3):
                    srv.submit(f"s{i}", feeds[f"s{i}"][t])
                if t < 1:
                    srv.submit("s2", feeds["s2"][t])
                srv.tick()
            srv.close("s3")
            srv.admit("late")
            for t in range(3, 5):
                for i in (0, 1, 2):
                    srv.submit(f"s{i}", feeds[f"s{i}"][t - (2 if i == 2 else 0)])
                srv.submit("late", feeds["s0"][t])
                srv.tick()
            for _ in range(3):
                srv.tick()

        run(flat)
        run(tiered)
        warm = dict(tiered.step_cache_sizes())
        assert tiered.server_counters()["n_migrations"] >= 2
        for srv in (flat, tiered):
            srv.admit("tail")
            srv.submit("tail", feeds["s1"][0])
            srv.tick()
        for sid in tiered.live_sessions:
            _assert_bitwise(tiered.state(sid), flat.state(sid), sid)
            assert (tiered.telemetry(sid).k_trajectory
                    == flat.telemetry(sid).k_trajectory), sid
        end = tiered.step_cache_sizes()
        assert all(n == 1 for n in end.values()), end
        assert all(end[k] == n for k, n in warm.items())
