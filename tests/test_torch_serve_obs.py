"""The port's observability copies (``repro_torch.obs``) and the serving
loop's use of them, on the CPU: the same metric operations give the same
registry snapshot and Prometheus text as ``repro.obs``; the flight
recorder's Chrome trace equals the reference's on one fake clock (its two
names of the package aside); the degradation controller walks the same
levels as the reference's on one pressure sequence; and the server's tick
leaves its four phase spans, its events and registry-backed counters.
Fixed seeds only.
"""

import json
import math

import pytest

from repro.obs import metrics as jmetrics
from repro.obs import trace as jtrace
from repro.serve import degrade as jdegrade
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import trace as ttrace
from repro_torch.serve import degrade as tdegrade
from repro_torch.serve import DegradeConfig, DegradeController
from test_torch_serve import CHUNK, _chunks, _server


def _exercise(mod):
    """The same metric operations on a fresh registry of ``mod``."""
    reg = mod.MetricsRegistry()
    reg.counter("frames_total", tier=0).inc(5)
    reg.counter("frames_total", tier=1).inc(2)
    reg.counter("nacks_total", status="backpressure").inc(3)
    reg.gauge("level").set(2)
    reg.gauge("live", fn=lambda: 7)
    h = reg.histogram("lat", n_buckets=8)
    for v in (1e-5, 3e-4, 0.002, 0.02, 0.5, 200.0):
        h.record(v)
    other = mod.MetricsRegistry()
    other.counter("frames_total", tier=0).inc(1)
    other.histogram("lat", n_buckets=8).record(0.004)
    reg.merge(other)
    return reg


class TestMetricsParity:
    def test_snapshot_and_prometheus_equal_the_reference(self):
        ours, ref = _exercise(tmetrics), _exercise(jmetrics)
        assert ours.snapshot() == ref.snapshot()
        assert ours.to_prometheus() == ref.to_prometheus()
        assert json.loads(json.dumps(ours.snapshot())) == ours.snapshot()

    @pytest.mark.parametrize("q", [0.0, 0.5, 0.9, 0.99, 1.0])
    def test_histogram_percentiles_equal_the_reference(self, q):
        values = [10.0 ** (-6 + 0.37 * i) for i in range(20)]
        hs = []
        for mod in (tmetrics, jmetrics):
            h = mod.Histogram()
            for v in values:
                h.record(v)
            hs.append(h)
        assert hs[0].percentile(q) == hs[1].percentile(q)
        assert hs[0].summary() == hs[1].summary()

    def test_empty_histogram_and_layout_checks(self):
        h = tmetrics.Histogram()
        assert math.isnan(h.percentile(0.5))
        assert h.summary()["p50_ms"] is None
        with pytest.raises(ValueError):
            h.merge(tmetrics.Histogram(n_buckets=4))
        reg = tmetrics.MetricsRegistry()
        reg.counter("x")
        with pytest.raises(TypeError, match="is a counter"):
            reg.gauge("x")

    def test_attribute_views_hit_the_cells(self):
        class Instrumented:
            hits = tmetrics.counter_property("hits_total")
            level = tmetrics.gauge_property("level", cast=int)

            def __init__(self):
                self.metrics = tmetrics.MetricsRegistry()
                self.hits = 0
                self.level = 0

        obj = Instrumented()
        obj.hits += 3
        obj.level = 2.9
        assert obj.metrics.value("hits_total") == 3
        assert obj.level == 2 and obj.metrics.gauge("level").value == 2


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


def _record(mod):
    rec = mod.FlightRecorder(capacity=3, clock=_FakeClock())
    rec.event("checkpoint", step=3)  # an orphan, before any tick
    for i in range(4):
        rec.begin_tick(i)
        for phase in mod.TICK_PHASES:
            with rec.span(phase):
                pass
        rec.event("admit", stream=("sess", i), slot=i)
        rec.end_tick()
    rec.begin_tick(4)  # left open: dumped with the clock's reading
    return rec.to_chrome_trace()


def test_chrome_trace_equals_the_reference():
    ours, ref = _record(ttrace), _record(jtrace)
    names = {
        "repro_torch.serve tick loop": "repro.serve tick loop",
        "repro_torch.obs.trace.FlightRecorder":
            "repro.obs.trace.FlightRecorder",
    }
    renamed = json.loads(json.dumps(ours))
    renamed["traceEvents"][0]["args"]["name"] = names[
        renamed["traceEvents"][0]["args"]["name"]]
    renamed["otherData"]["source"] = names[renamed["otherData"]["source"]]
    assert renamed == json.loads(json.dumps(ref))
    assert ttrace.TICK_PHASES == jtrace.TICK_PHASES
    assert ttrace.EVENT_NAMES == jtrace.EVENT_NAMES


# A pressure sequence that climbs through both levels, dwells, sheds back
# down and flaps near a threshold.
PRESSURES = (0.1, 0.7, 0.7, 0.95, 0.95, 0.95, 0.5, 0.62, 0.3, 0.3, 0.66,
             0.39, 0.39, 0.2, 0.9, 0.9, 0.9, 0.1, 0.1, 0.1, 0.1)


@pytest.mark.parametrize("cfg_kw", [
    {},
    dict(dwell_ticks=1),
    dict(arrival_weight=2.0),
    dict(enter=(0.5,), exit=(0.2,),
         levels=(tdegrade.LevelPolicy(rung_cap_down=1),)),
], ids=["default", "dwell 1", "arrival weight", "one level"])
def test_degrade_level_walk_equals_the_reference(cfg_kw):
    jkw = dict(cfg_kw)
    if "levels" in jkw:
        jkw["levels"] = tuple(jdegrade.LevelPolicy(*p) for p in jkw["levels"])
    ours = DegradeController(DegradeConfig(**cfg_kw))
    ref = jdegrade.DegradeController(jdegrade.DegradeConfig(**jkw))
    walk, ref_walk = [], []
    for i, p in enumerate(PRESSURES):
        ema = (i % 5) / 10
        walk.append(ours.observe(p, arrival_ema=ema))
        ref_walk.append(ref.observe(p, arrival_ema=ema))
        assert tuple(ours.policy) == tuple(ref.policy)
    assert walk == ref_walk
    assert ours.counters() == ref.counters()
    assert ours.metrics.snapshot() == ref.metrics.snapshot()


def test_degrade_validation():
    with pytest.raises(ValueError, match="hysteresis"):
        tdegrade.validate_degrade(DegradeConfig(
            enter=(0.5,), exit=(0.6,), levels=(tdegrade.LevelPolicy(),)))
    with pytest.raises(ValueError, match="queue policy"):
        tdegrade.validate_degrade(DegradeConfig(
            enter=(0.5,), exit=(0.2,),
            levels=(tdegrade.LevelPolicy(queue_policy="bogus"),)))


class TestServerTracing:
    def test_tick_leaves_phase_spans_and_events(self):
        srv = _server(capacity=1)
        srv.recorder = ttrace.FlightRecorder(capacity=8)
        srv.admit("a")
        chunks = _chunks(0, n_frames=3 * CHUNK)
        for c in chunks:
            srv.submit("a", c)
            srv.tick()
        ticks = srv.recorder.ticks()
        assert len(ticks) == len(chunks)
        assert {s[0] for t in ticks for s in t["spans"]} == set(
            ttrace.TICK_PHASES)
        srv.close("a")
        srv.recorder.begin_tick(srv.n_ticks)
        srv.admit("b")
        srv.close("b")
        srv.recorder.end_tick()
        assert [e[0] for e in srv.recorder.ticks()[-1]["events"]] == [
            "admit", "evict"]

    def test_registry_backs_server_counters(self):
        srv = _server(capacity=1)
        srv.admit("a")
        for c in _chunks(0):
            srv.submit("a", c)
            srv.tick()
        sc, reg = srv.server_counters(), srv.metrics
        assert sc["n_ticks"] == reg.value("serve_ticks_total")
        assert sc["n_admitted"] == reg.value("serve_admitted_total")
        assert sc["n_dispatches"] == reg.value("serve_dispatches_total")
        assert sc["frames_served"] == reg.value("serve_frames_served_total")
        assert sc["n_live"] == reg.value("serve_live_streams")
        assert f"serve_ticks_total {sc['n_ticks']}" in reg.to_prometheus()

    def test_degrade_under_overload_sheds_and_builds_nothing_new(self):
        """Queues of one, two chunks a tick: the controller climbs, the
        queues drop their oldest chunk and shed stale ones, and the step
        programs stay one per variant."""
        srv = _server(capacity=2, queue_depth=1)
        srv.degrade = DegradeController(
            DegradeConfig(enter=(0.5, 0.9), exit=(0.2, 0.5), dwell_ticks=1),
            metrics=srv.metrics)
        srv.admit("a"), srv.admit("b")
        feed = _chunks(3, n_frames=4 * CHUNK)
        for t in range(4):
            for sid in ("a", "b"):
                srv.submit(sid, feed[t])
                srv.submit(sid, feed[t])  # backpressure or drop-oldest
            srv.tick()
        c = srv.server_counters()
        assert srv.degrade.n_transitions >= 1
        assert c["degrade_level"] == srv.degrade.level >= 1
        assert c["n_dropped"] + c["n_backpressure"] >= 4
        assert srv.step_cache_sizes() == {None: 1}
        assert srv.metrics.value("degrade_level") == srv.degrade.level
