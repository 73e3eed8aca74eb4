"""Port parity: the host side of the observability plane
(``sherman_tpu_torch/obs``) against the JAX package's ``sherman_tpu/obs``.

The cases of ``tests/test_obs.py``, ``tests/test_slo.py`` and
``tests/test_device_obs.py`` that need no engine run here once per
package (``P`` is either package's obs modules), so each keeps counting
for both.  Then the two packages meet directly: the same calls give equal
snapshots and Prometheus text, equal ``LatencyTracker`` percentiles and
buckets, equal Chrome traces except the timestamps, and equal recorder
bundles except the timestamps.  The reference's ``jax.monitoring`` and
``cost_analysis`` cases get the port's counterpart (the first call per
signature, the typed unavailable cost) instead of a copy.  No wall-time
A/B runs here: ``chip_smoke.py`` measures the plane's cost on the card.

Every environment variable a case sets goes through ``monkeypatch``, and
each case that touches a process-wide singleton resets both packages'.
"""

import json
import os
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import sherman_tpu.obs as JOBS
import sherman_tpu.utils.trace as JTRACE
import sherman_tpu_torch.obs as TOBS
import sherman_tpu_torch.utils.trace as TTRACE
from sherman_tpu.obs import device as JDEV
from sherman_tpu.obs import export as JEXP
from sherman_tpu.obs import recorder as JFR
from sherman_tpu.obs import registry as JREG
from sherman_tpu.obs import slo as JSLO
from sherman_tpu.obs import spans as JSPANS
from sherman_tpu_torch.obs import device as TDEV
from sherman_tpu_torch.obs import export as TEXP
from sherman_tpu_torch.obs import recorder as TFR
from sherman_tpu_torch.obs import registry as TREG
from sherman_tpu_torch.obs import slo as TSLO
from sherman_tpu_torch.obs import spans as TSPANS

PKGS = {
    "jax": types.SimpleNamespace(
        obs=JOBS, registry=JREG, spans=JSPANS, slo=JSLO, FR=JFR,
        export=JEXP, dev=JDEV, trace=JTRACE),
    "torch": types.SimpleNamespace(
        obs=TOBS, registry=TREG, spans=TSPANS, slo=TSLO, FR=TFR,
        export=TEXP, dev=TDEV, trace=TTRACE),
}


@pytest.fixture(params=["jax", "torch"])
def P(request):
    return PKGS[request.param]


@pytest.fixture(autouse=True)
def _reset_singletons():
    """Both packages' recorders and SLO trackers start empty."""
    for p in PKGS.values():
        p.FR.get_recorder().clear()
        p.slo.get_slo().reset()
    yield
    for p in PKGS.values():
        p.FR.get_recorder().clear()
        p.slo.get_slo().reset()


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def test_counter_gauge_histogram_snapshot(P):
    reg = P.registry.MetricsRegistry()
    c = reg.counter("c")
    c.inc()
    c.inc(4)
    reg.gauge("g").set(2.5)
    h = reg.histogram("h")
    for v in (1, 2, 3, 1000):
        h.record(v)
    snap = reg.snapshot()
    assert snap["c"] == 5
    assert snap["g"] == 2.5
    assert snap["h"]["count"] == 4
    assert snap["h"]["sum"] == 1006
    assert snap["h"]["min"] == 1 and snap["h"]["max"] == 1000
    assert 1 <= snap["h"]["p50"] <= 4
    assert snap["h"]["p99"] >= 511


def test_metric_get_or_create_idempotent_and_typed(P):
    reg = P.registry.MetricsRegistry()
    assert reg.counter("x") is reg.counter("x")
    with pytest.raises(TypeError):
        reg.gauge("x")


def test_snapshot_delta_semantics(P):
    reg = P.registry.MetricsRegistry()
    c = reg.counter("ops")
    c.inc(10)
    before = reg.snapshot()
    c.inc(7)
    reg.counter("born_inside").inc(3)
    after = reg.snapshot()
    d = P.registry.delta(before, after)
    assert d["ops"] == 7
    assert d["born_inside"] == 3


def test_reset_zeroes_in_place_keeping_bindings(P):
    reg = P.registry.MetricsRegistry()
    c = reg.counter("bound")
    g = reg.gauge("g")
    h = reg.histogram("h")
    c.inc(5)
    g.set(3.0)
    h.record(10)
    reg.register_collector("src", lambda: {"a": 1})
    reg.reset()
    assert reg.snapshot()["bound"] == 0
    assert reg.snapshot()["h"]["count"] == 0
    c.inc(2)
    assert reg.counter("bound") is c
    assert reg.snapshot()["bound"] == 2
    assert reg.snapshot()["src.a"] == 1


def test_collector_merge_and_error_isolation(P):
    reg = P.registry.MetricsRegistry()
    reg.register_collector("src", lambda: {"a": 1, "b": 2})
    reg.register_collector("bad", lambda: 1 / 0)
    snap = reg.snapshot()
    assert snap["src.a"] == 1 and snap["src.b"] == 2
    assert any("bad" in e for e in snap["_collector_errors"])
    reg.unregister_collector("src")
    assert "src.a" not in reg.snapshot()


def test_snapshot_vs_increment_fuzz_undercounts_never_crashes(P):
    """Concurrent inc/record during snapshot()/delta() may undercount
    but never raise, corrupt a histogram or over-count."""
    reg = P.registry.MetricsRegistry()
    c = reg.counter("storm.ops")
    h = reg.histogram("storm.lat")
    g = reg.gauge("storm.depth")
    n_threads, n_incs = 4, 5_000
    stop = threading.Event()
    errors: list = []

    def incer():
        try:
            for i in range(n_incs):
                c.inc()
                h.record(i % 1000)
                g.set(i)
        except Exception as e:  # pragma: no cover - the failure mode
            errors.append(e)

    def snapper():
        try:
            while not stop.is_set():
                snap = reg.snapshot()
                assert 0 <= snap["storm.ops"] <= n_threads * n_incs
                assert 0 <= snap["storm.lat"]["count"] <= n_threads * n_incs
                P.registry.delta(snap, reg.snapshot())
        except Exception as e:  # pragma: no cover
            errors.append(e)

    ts = [threading.Thread(target=incer) for _ in range(n_threads)]
    ss = [threading.Thread(target=snapper) for _ in range(2)]
    for t in ss + ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    stop.set()
    for t in ss:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts + ss)
    assert not errors, errors
    final = reg.snapshot()
    assert 0 < final["storm.ops"] <= n_threads * n_incs
    assert final["storm.lat"]["count"] == sum(h.buckets)


def test_collector_raises_mid_storm_isolated(P):
    reg = P.registry.MetricsRegistry()
    reg.counter("solid").inc(3)
    calls = [0]

    def flaky():
        calls[0] += 1
        if calls[0] % 2:
            raise RuntimeError("buffer mid-step")
        return {"ok": 1}

    reg.register_collector("flaky", flaky)
    bad = reg.snapshot()
    good = reg.snapshot()
    assert bad["solid"] == good["solid"] == 3
    assert any("flaky" in e for e in bad["_collector_errors"])
    assert good["flaky.ok"] == 1 and "_collector_errors" not in good
    assert "_collector_errors" not in P.registry.delta(bad, good)


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

def test_legacy_steptrace_api_still_works(P):
    assert P.trace.StepTrace is P.spans.StepTrace
    assert P.trace.device_trace is P.spans.device_trace
    tr = P.trace.StepTrace()
    with tr.span("descend"):
        pass
    tr.record("descend", 0.25)
    s = tr.summary()
    assert s["descend"]["n"] == 2
    assert s["descend"]["total_s"] >= 0.25
    assert "descend" in tr.report()


def test_nested_spans_and_summary(P):
    tr = P.spans.SpanTracer()
    with tr.span("outer"):
        with tr.span("inner"):
            pass
        with tr.span("inner"):
            pass
    s = tr.summary()
    assert s["outer"]["n"] == 1
    assert s["inner"]["n"] == 2
    depths = {e[0]: e[4] for e in tr._events}
    assert depths["outer"] == 0 and depths["inner"] == 1


def test_chrome_trace_roundtrips_through_json(P, tmp_path):
    tr = P.spans.SpanTracer()
    with tr.span("phase_a", step=3):
        with tr.span("phase_b"):
            pass
    path = tr.export_chrome(str(tmp_path / "trace.json"))
    with open(path) as f:
        doc = json.load(f)
    evs = doc["traceEvents"]
    assert isinstance(evs, list) and len(evs) == 2
    by_name = {e["name"]: e for e in evs}
    for e in evs:
        assert e["ph"] == "X"
        assert e["dur"] >= 0 and e["ts"] >= 0
    assert by_name["phase_a"]["args"] == {"step": 3}
    a, b = by_name["phase_a"], by_name["phase_b"]
    assert a["ts"] <= b["ts"]
    assert b["ts"] + b["dur"] <= a["ts"] + a["dur"] + 1e-3


def test_chrome_trace_event_schema_perfetto_loadable(P, tmp_path):
    tr = P.spans.SpanTracer()
    with tr.span("root", step=1):
        with tr.span("child_a"):
            with tr.span("grandchild"):
                pass
        with tr.span("child_b"):
            pass
    tr.record("after_the_fact", 0.001)
    path = tr.export_chrome(str(tmp_path / "trace.json"))
    with open(path) as f:
        doc = json.load(f)
    assert isinstance(doc["traceEvents"], list)
    assert doc["displayTimeUnit"] in ("ms", "ns")
    by_name = {}
    for e in doc["traceEvents"]:
        assert e["ph"] == "X", e
        assert isinstance(e["name"], str) and e["name"]
        assert isinstance(e["pid"], int)
        assert isinstance(e["tid"], int)
        assert isinstance(e["ts"], (int, float)) and e["ts"] >= 0
        assert isinstance(e["dur"], (int, float)) and e["dur"] >= 0
        if "args" in e:
            assert isinstance(e["args"], dict)
        by_name[e["name"]] = e

    def contains(outer, inner, tol_us=1e-3):
        return (outer["ts"] <= inner["ts"] + tol_us
                and inner["ts"] + inner["dur"]
                <= outer["ts"] + outer["dur"] + tol_us)

    root = by_name["root"]
    assert contains(root, by_name["child_a"])
    assert contains(root, by_name["child_b"])
    assert contains(by_name["child_a"], by_name["grandchild"])
    a, b = by_name["child_a"], by_name["child_b"]
    assert a["ts"] + a["dur"] <= b["ts"] + 1e-3
    assert root["args"] == {"step": 1}
    json.loads(json.dumps(doc, allow_nan=False))


def test_span_recording_thread_safe(P):
    tr = P.spans.SpanTracer()

    def worker():
        for _ in range(200):
            with tr.span("w"):
                pass

    ts = [threading.Thread(target=worker) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts)
    assert tr.summary()["w"]["n"] == 800
    assert len(tr.chrome_trace()["traceEvents"]) == 800


def test_event_cap_keeps_aggregates(P):
    tr = P.spans.SpanTracer(max_events=3)
    for _ in range(10):
        with tr.span("s"):
            pass
    assert tr.summary()["s"]["n"] == 10
    assert len(tr.chrome_trace()["traceEvents"]) == 3
    assert tr.dropped == 7


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------

def test_dump_and_jsonl(P, tmp_path):
    reg = P.registry.MetricsRegistry()
    reg.counter("n").inc(2)
    tr = P.spans.SpanTracer()
    with tr.span("p"):
        pass
    path = P.obs.dump(str(tmp_path / "obs.json"), reg, tr,
                      extra={"run": "test"})
    with open(path) as f:
        doc = json.load(f)
    assert doc["traceEvents"][0]["name"] == "p"
    assert doc["otherData"]["metrics"]["n"] == 2
    assert doc["otherData"]["run"] == "test"
    jl = str(tmp_path / "obs.jsonl")
    P.obs.write_snapshot_jsonl(jl, reg)
    P.obs.write_snapshot_jsonl(jl, reg)
    lines = [json.loads(ln) for ln in open(jl)]
    assert len(lines) == 2 and lines[0]["metrics"]["n"] == 2


def test_obs_section_shape(P):
    reg = P.registry.MetricsRegistry()
    reg.counter("k").inc()
    tr = P.spans.SpanTracer()
    with tr.span("s"):
        pass
    sec = P.obs.obs_section(reg, tr)
    assert sec["counters"]["k"] == 1 and sec["spans"]["s"]["n"] == 1


def test_prometheus_text_format(P):
    reg = P.obs.MetricsRegistry()
    reg.counter("a.ops").inc(3)
    reg.gauge("b.depth").set(1.5)
    h = reg.histogram("c.lat_ms")
    for v in (1, 2, 50):
        h.record(v)
    reg.register_collector("dsm", lambda: {"read_ops": 7})
    lines = P.export.prometheus_text(reg).strip().splitlines()
    assert "# TYPE sherman_a_ops_total counter" in lines
    assert "sherman_a_ops_total 3" in lines
    assert "sherman_b_depth 1.5" in lines
    assert "# TYPE sherman_c_lat_ms summary" in lines
    assert "sherman_c_lat_ms_count 3" in lines
    assert "sherman_dsm_read_ops 7" in lines
    for ln in lines:
        if ln.startswith("#"):
            continue
        name, val = ln.rsplit(" ", 1)
        float(val)
        assert " " not in name.split("{")[0]
        assert "." not in name.split("{")[0]


def test_write_prometheus_atomic(P, tmp_path):
    reg = P.obs.MetricsRegistry()
    reg.counter("x").inc()
    p = str(tmp_path / "metrics.prom")
    P.export.write_prometheus(p, reg)
    assert "sherman_x_total 1" in open(p).read()
    assert not [f for f in os.listdir(tmp_path) if ".tmp" in f]


def test_periodic_exporter_prom_mode(P, tmp_path):
    reg = P.obs.MetricsRegistry()
    reg.counter("ticks").inc(2)
    p = str(tmp_path / "m.prom")
    ex = P.export.PeriodicExporter(p, interval_s=30.0, reg=reg,
                                   fmt="prom").start()
    ex.stop()
    assert ex._thread is None
    assert "sherman_ticks_total 2" in open(p).read()


def test_periodic_exporter_jsonl_ticks(P, tmp_path):
    reg = P.obs.MetricsRegistry()
    reg.counter("ticks").inc(1)
    p = str(tmp_path / "m.jsonl")
    with P.export.PeriodicExporter(p, interval_s=0.02, reg=reg) as ex:
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and (
                not os.path.exists(p) or len(open(p).readlines()) < 2):
            time.sleep(0.01)
    assert ex._thread is None
    lines = [json.loads(ln) for ln in open(p)]
    assert len(lines) >= 3 and lines[-1].get("final") is True
    assert all(ln["metrics"]["ticks"] == 1 for ln in lines)


def test_metrics_http_endpoint(P):
    reg = P.obs.MetricsRegistry()
    reg.counter("served").inc(5)
    with P.export.MetricsServer(port=0, reg=reg) as srv:
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/metrics", timeout=10
        ).read().decode()
        assert "sherman_served_total 5" in body
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/nope", timeout=10)
    assert srv._httpd is None


def test_maybe_serve_http_env_gate(P, monkeypatch):
    monkeypatch.delenv(P.export.METRICS_PORT_ENV, raising=False)
    assert P.export.maybe_serve_http() is None
    monkeypatch.setenv(P.export.METRICS_PORT_ENV, "0")
    assert P.export.maybe_serve_http() is None
    monkeypatch.setenv(P.export.METRICS_PORT_ENV, "bogus")
    with pytest.raises(ValueError):
        P.export.maybe_serve_http()


# ---------------------------------------------------------------------------
# SLO: LatencyTracker, WindowedRate, SloTracker
# ---------------------------------------------------------------------------

def test_latency_tracker_percentiles_close_to_exact(P):
    t = P.slo.LatencyTracker()
    rng = np.random.default_rng(3)
    vals = rng.lognormal(mean=np.log(5e-3), sigma=0.7, size=20_000)
    for v in vals:
        t.record(float(v))
    for q in (50, 99, 99.9):
        est = t.percentile_ms(q)
        true = float(np.percentile(vals, q)) * 1e3
        assert abs(est / true - 1) < 0.125, (q, est, true)
    snap = t.snapshot()
    assert snap["count"] == 20_000
    assert snap["min_ms"] <= snap["p50_ms"] <= snap["p99_ms"] \
        <= snap["p999_ms"] <= snap["max_ms"]


def test_latency_tracker_weighted_and_merge(P):
    a, b = P.slo.LatencyTracker(), P.slo.LatencyTracker()
    a.record(0.010, n=90)
    b.record(0.100, n=10)
    a.merge(b)
    assert a.count == 100
    assert abs(a.percentile_ms(50) / 10 - 1) < 0.15
    assert a.percentile_ms(99) > 80
    assert a.percentile_ms(100) <= 100.0 + 1e-9
    assert a.percentile_ms(0.1) >= 10.0 - 1e-9


def test_latency_tracker_bucket_roundtrip(P):
    for v in (0, 1, 7, 8, 9, 255, 1 << 20, (1 << 40) + 12345):
        idx = P.slo.LatencyTracker._bucket(v)
        lo, hi = P.slo.LatencyTracker._bucket_bounds(idx)
        assert lo <= v < hi, (v, idx, lo, hi)


def test_windowed_rate_slides_and_expires(P):
    r = P.slo.WindowedRate(window_s=10.0, granules=10)
    for s in range(5):
        r.add(100, now=100.0 + s)
    assert abs(r.rate(now=105.0) - 100.0) < 25
    assert r.total(now=105.0) == 500
    assert r.total(now=120.0) == 0
    r.add(50, now=120.5)
    assert r.total(now=121.0) == 50


def test_windowed_rate_sub_granule_burst_not_diluted(P):
    r = P.slo.WindowedRate(window_s=3600.0, granules=20)
    for s in range(6):
        r.add(1_000_000, now=1000.0 + s)
    assert abs(r.rate(now=1005.0) / 1.2e6 - 1) < 0.05
    r2 = P.slo.WindowedRate(window_s=3600.0, granules=20)
    r2.add(100, now=50.0)
    assert 0 < r2.rate(now=50.0) < float("inf")


def test_slo_tracker_batch_attribution_and_window(P):
    st = P.slo.SloTracker(window_s=10.0, clock=lambda: 0.0)
    st.observe("read", 4000, 0.080, batches=4, now=1.0)
    st.observe("insert", 100, 0.050, batches=1, now=1.5)
    w = st.window(now=2.0)
    assert set(w) == {"read", "insert"}
    assert abs(w["read"]["p50_ms"] / 20 - 1) < 0.15
    assert abs(w["insert"]["p50_ms"] / 50 - 1) < 0.15
    assert w["read"]["window_ops"] == 4000
    assert w["read"]["ops_total"] == 4000
    assert w["read"]["batches_total"] == 4
    assert w["read"]["ops_s"] > 0
    for k in ("p50_ms", "p99_ms", "p999_ms"):
        assert k in w["read"]


def test_slo_tracker_two_generation_rotation(P):
    now = [0.0]
    st = P.slo.SloTracker(window_s=1.0, clock=lambda: now[0])
    st.observe("read", 100, 0.010, now=0.5)
    st.observe("read", 100, 0.010, now=1.6)
    assert st.window(now=1.7)["read"]["window_ops"] == 200
    assert st.window(now=2.8)["read"]["window_ops"] == 100
    assert st.window(now=4.5)["read"]["window_ops"] == 0


def test_slo_rotation_single_swap_under_race(P):
    st = P.slo.SloTracker(window_s=1.0, clock=lambda: 0.0)
    st.observe("read", 100, 0.010, now=0.5)
    cs = st._classes["read"]
    filled = cs.cur
    st._lock.acquire()
    ts = [threading.Thread(target=cs.rotate_if_due,
                           args=(1.0, 2.0, st._lock)) for _ in range(2)]
    for t in ts:
        t.start()
    time.sleep(0.05)
    st._lock.release()
    for t in ts:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in ts)
    assert cs.prev is filled, "second contender re-rotated the window"
    assert cs.cur.count == 0
    assert st.window(now=2.1)["read"]["window_ops"] == 100


def test_default_tracker_registers_slo_collector(P):
    P.obs.observe("read", 1000, 0.005)
    snap = P.obs.snapshot()
    assert snap["slo.read.ops_total"] >= 1000
    assert snap["slo.read.p50_ms"] > 0


def test_slo_env_kill_switch(P, monkeypatch):
    monkeypatch.setenv("SHERMAN_SLO", "0")
    P.obs.observe("read", 1000, 0.005)
    P.obs.observe_op("read", 0.005)
    assert "read" not in P.slo.slo_window()
    monkeypatch.setenv("SHERMAN_SLO", "1")
    P.obs.observe("read", 10, 0.005)
    assert P.slo.slo_window()["read"]["ops_total"] == 10


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------

def test_flight_recorder_ring_bounds_and_order(P):
    r = P.FR.FlightRecorder(capacity=4)
    for i in range(10):
        r.record("e", i=i)
    evs = r.events()
    assert len(evs) == 4
    assert [e["fields"]["i"] for e in evs] == [6, 7, 8, 9]
    assert evs[0]["seq"] < evs[-1]["seq"]
    assert r.dropped == 6


def test_flight_recorder_dump_bundle(P, tmp_path):
    r = P.FR.FlightRecorder()
    r.record("chaos.inject", fault="torn_page")
    r.record("engine.degraded_enter", reason="test")
    path = r.dump("unit", str(tmp_path))
    with open(path) as f:
        doc = json.load(f)
    od = doc["otherData"]
    assert od["reason"] == "unit"
    kinds = [e["kind"] for e in od["flight_events"]]
    assert kinds == ["chaos.inject", "engine.degraded_enter"]
    assert "metrics" in od and "traceEvents" in doc
    jl = path.replace(".json", ".events.jsonl")
    lines = [json.loads(ln) for ln in open(jl)]
    assert [ln["kind"] for ln in lines] == kinds


def test_flight_recorder_dump_needs_a_directory(P, monkeypatch):
    monkeypatch.delenv(P.FR.BLACKBOX_ENV, raising=False)
    with pytest.raises(ValueError, match=P.FR.BLACKBOX_ENV):
        P.FR.FlightRecorder().dump("nowhere")


def test_flight_recorder_auto_dump_env_gated_and_debounced(
        P, tmp_path, monkeypatch):
    r = P.FR.FlightRecorder(min_dump_interval_s=60.0)
    r.record("x")
    monkeypatch.delenv(P.FR.BLACKBOX_ENV, raising=False)
    assert r.auto_dump("nope") is None
    monkeypatch.setenv(P.FR.BLACKBOX_ENV, str(tmp_path))
    p1 = r.auto_dump("first")
    assert p1 and os.path.exists(p1)
    assert r.auto_dump("debounced") is None
    p3 = r.auto_dump("forced", force=True)
    assert p3 and p3 != p1


def test_span_closes_feed_the_recorder(P):
    rec = P.FR.get_recorder()
    with P.obs.span("slo_test_phase"):
        pass
    evs = [e for e in rec.events() if e["kind"] == "span"
           and e["fields"]["name"] == "slo_test_phase"]
    assert len(evs) == 1
    assert evs[0]["fields"]["dur_ms"] >= 0


# ---------------------------------------------------------------------------
# device plane: the cases that need no jit
# ---------------------------------------------------------------------------

def test_wrap_idempotent_and_transparent(P):
    led = P.dev.CompileLedger()
    base = (lambda x: x + 1)
    w = led.wrap("t.inc", base)
    assert led.wrap("relabel", w) is w
    assert w.unwrapped is base
    assert w.label == "t.inc"


def test_seal_nests_and_summary_shape(P):
    led = P.dev.CompileLedger()
    with led.sealed_scope():
        with led.sealed_scope():
            assert led.sealed
        assert led.sealed
    assert not led.sealed
    s = led.summary()
    assert {"programs", "compiles", "compile_ms_total", "retraces",
            "sealed_windows", "entries"} <= set(s)
    assert s["sealed_windows"] == 2


def test_default_ledger_registers_device_collector(P):
    P.dev.get_ledger()
    snap = P.obs.snapshot()
    assert "device.programs" in snap and "device.retraces" in snap
    assert "device.hbm_total_bytes" in snap


def test_roofline_fractions_with_env_peaks(P, monkeypatch):
    monkeypatch.setenv("SHERMAN_PEAK_GBPS", "100")
    monkeypatch.setenv("SHERMAN_PEAK_TFLOPS", "0.001")
    peaks = P.dev.device_peaks()
    assert peaks["source"] == "env"
    cost = {"available": True, "flops": 1e6, "bytes": 1e9}
    r = P.dev.roofline(cost, 100.0, peaks)
    assert r["available"]
    assert r["achieved_gbytes_s"] == pytest.approx(10.0)
    assert r["achieved_bytes_frac"] == pytest.approx(0.1)
    assert r["achieved_flops_frac"] == pytest.approx(0.01)
    assert r["bound"] == "bytes"


def test_device_peaks_malformed_env_falls_back(P, monkeypatch):
    monkeypatch.setenv("SHERMAN_PEAK_GBPS", "819GB")
    monkeypatch.delenv("SHERMAN_PEAK_TFLOPS", raising=False)
    peaks = P.dev.device_peaks()
    assert "bad-env:SHERMAN_PEAK_GBPS" in peaks["source"]
    assert peaks["bytes_per_s"] is None or peaks["bytes_per_s"] > 0


def test_device_peaks_env_fields_resolve_independently(P, monkeypatch):
    monkeypatch.setenv("SHERMAN_PEAK_GBPS", "819GB")
    monkeypatch.setenv("SHERMAN_PEAK_TFLOPS", "197")
    peaks = P.dev.device_peaks()
    assert peaks["flops_per_s"] == pytest.approx(197e12)
    assert "bad-env:SHERMAN_PEAK_GBPS" in peaks["source"]
    assert "env" in peaks["source"].split(";")


def test_roofline_unknown_backend_omits_fractions(P):
    cost = {"available": True, "flops": 1e6, "bytes": 1e9}
    r = P.dev.roofline(cost, 10.0,
                       {"bytes_per_s": None, "flops_per_s": None})
    assert r["available"] and "achieved_gbytes_s" in r
    assert "achieved_bytes_frac" not in r and "bound" not in r


def test_roofline_below_resolution_flags_and_omits_fracs(P):
    cost = {"available": True, "flops": 1e3, "bytes": 1e3}
    r = P.dev.roofline(cost, 0.0001,
                       {"bytes_per_s": 1e9, "flops_per_s": 1e9})
    assert r["wall_below_resolution"]
    assert "achieved_bytes_frac" not in r


def test_roofline_unavailable_cost_passthrough(P):
    r = P.dev.roofline({"available": False, "reason": "nope"}, 5.0)
    assert not r["available"] and r["reason"] == "nope"
    assert r["wall_ms"] == 5.0


def test_accountant_gauges_watermark_and_dead_source(P):
    acct = P.dev.MemoryAccountant()
    live = {"n": 1000}
    acct.register("pool", lambda: live["n"])
    acct.register("journal", lambda: 77, kind="host")
    g = acct.gauges()
    assert g["hbm_pool_bytes"] == 1000 and g["host_journal_bytes"] == 77
    assert g["hbm_total_bytes"] == 1000
    assert g["hbm_peak_bytes"] == 1000
    live["n"] = 5000
    assert acct.gauges()["hbm_peak_bytes"] == 5000
    live["n"] = 10
    g = acct.gauges()
    assert g["hbm_total_bytes"] == 10 and g["hbm_peak_bytes"] == 5000

    def boom():
        raise RuntimeError("buffer mid-step")

    acct.register("pool", boom)
    assert acct.gauges()["hbm_pool_bytes"] == 0


# ---------------------------------------------------------------------------
# the port's counterparts of the reference's jit-bound cases
# ---------------------------------------------------------------------------

def _double(x):
    return x * 2


def test_port_ledger_records_first_call_per_signature():
    """The reference records each jit compile with its signature; the
    port records each wrapped program's first call per signature."""
    led = TDEV.CompileLedger()
    f = led.wrap("t.double", _double)
    out = f(torch.arange(8, dtype=torch.int32))
    assert torch.equal(out, torch.arange(8, dtype=torch.int32) * 2)
    (e,) = (x for x in led.entries() if x["label"] == "t.double")
    assert e["compiles"] == 1
    assert list(e["signatures"]) == ["int32[8]@cpu"]
    f(torch.arange(8, dtype=torch.int32))          # seen: no new entry
    (e,) = (x for x in led.entries() if x["label"] == "t.double")
    assert e["compiles"] == 1
    f(torch.arange(16, dtype=torch.int32))         # a new shape
    f(torch.arange(8, dtype=torch.int64))          # a new dtype
    (e,) = (x for x in led.entries() if x["label"] == "t.double")
    assert e["compiles"] == 3
    assert {"int32[16]@cpu", "int64[8]@cpu"} <= set(e["signatures"])
    # a Python scalar's value makes no new signature, its type does
    g = led.wrap("t.add", lambda x, k: x if k is None else x + k)
    g(torch.zeros(4), 1)
    g(torch.zeros(4), 7)
    g(torch.zeros(4), None)
    (e,) = (x for x in led.entries() if x["label"] == "t.add")
    assert sorted(e["signatures"]) == ["float32[4]@cpu,None",
                                       "float32[4]@cpu,int"]


def test_port_seal_retrace_semantics_and_recorder_event():
    led = TDEV.CompileLedger()
    f = led.wrap("t.sealed", _double)
    f(torch.arange(8, dtype=torch.int32))
    assert led.retraces == 0
    with led.sealed_scope():
        f(torch.arange(8, dtype=torch.int32))
        assert led.retraces == 0
        f(torch.arange(32, dtype=torch.int32))
    assert led.retraces == 1
    (e,) = (x for x in led.entries() if x["label"] == "t.sealed")
    assert e["retraces"] == 1 and e["compiles"] == 2
    evs = [e for e in TFR.get_recorder().events()
           if e["kind"] == "compile.retrace"
           and e["fields"]["program"] == "t.sealed"]
    assert evs and evs[-1]["fields"]["signature"] == "int32[32]@cpu"
    f(torch.arange(64, dtype=torch.int32))        # unsealed: ordinary
    assert led.retraces == 1


def test_port_first_call_recorded_when_call_raises():
    def boom(x):
        raise RuntimeError("boom")

    led = TDEV.CompileLedger()
    f = led.wrap("t.raise", boom)
    with pytest.raises(RuntimeError):
        f(torch.zeros(4))
    (e,) = (x for x in led.entries() if x["label"] == "t.raise")
    assert e["compiles"] == 1
    with led.sealed_scope():
        with pytest.raises(RuntimeError):
            f(torch.zeros(5))
    assert led.retraces == 1


def test_port_suppress_scope_hides_probe_calls():
    led = TDEV.CompileLedger()
    f = led.wrap("t.quiet", _double)
    with led.sealed_scope():
        with led.suppress():
            f(torch.zeros(8))
    assert led.retraces == 0
    assert all(e["label"] != "t.quiet" for e in led.entries())


def test_port_kill_switch_forwards_untracked(monkeypatch):
    monkeypatch.setenv(TDEV.DEVICE_OBS_ENV, "0")
    assert not TDEV.enabled()
    led = TDEV.CompileLedger()
    f = led.wrap("t.dark", _double)
    with led.sealed_scope():
        out = f(torch.arange(8))
    assert torch.equal(out, torch.arange(8) * 2)
    led.record_build("build.dark", 1.0, ["a.cu"])
    assert led.retraces == 0 and led.entries() == []
    assert TDEV._collect() == {"enabled": 0}


def test_port_kernel_build_entry_and_retrace_after_seal():
    led = TDEV.CompileLedger()
    led.record_build("build.page_kernels", 5000.0,
                     ["sherman_tpu_torch/ops/csrc/page_kernels.cu"])
    (e,) = led.entries()
    assert e["label"] == "build.page_kernels" and e["compiles"] == 1
    assert list(e["signatures"]) == [
        "sherman_tpu_torch/ops/csrc/page_kernels.cu"]
    with led.sealed_scope():
        led.record_build("build.page_kernels", 1.0, ["x.cu"])
    assert led.retraces == 1


def test_port_cost_memory_typed_unavailable():
    """PyTorch has no cost_analysis: the reference's typed unavailable
    form, passed through by roofline and rooflines."""
    c = TDEV.program_cost(_double, torch.zeros(4))
    assert c["available"] is False and "cost_analysis" in c["reason"]
    m = TDEV.program_memory(_double, torch.zeros(4))
    assert m["available"] is False and m["reason"]
    led = TDEV.CompileLedger()
    f = led.wrap("t.phase", _double)
    f(torch.zeros(64))
    assert not led.analyze("t.never")["available"]
    ana = led.analyze("t.phase", memory=True)
    assert not ana["available"] and not ana["memory"]["available"]
    out = TDEV.rooflines({"serve": 3.0, "wall_ms": 9.9},
                         {"serve": "t.phase"}, ledger=led,
                         peaks={"bytes_per_s": 1e9, "flops_per_s": 1e9})
    assert set(out) == {"serve"}
    assert out["serve"]["program"] == "t.phase"
    assert not out["serve"]["available"] and out["serve"]["wall_ms"] == 3.0


def test_port_device_peaks_without_a_card(monkeypatch):
    """No CUDA device here: no peak is invented (the H100 table applies
    only to that card's name)."""
    monkeypatch.delenv("SHERMAN_PEAK_GBPS", raising=False)
    monkeypatch.delenv("SHERMAN_PEAK_TFLOPS", raising=False)
    peaks = TDEV.device_peaks()
    assert peaks["bytes_per_s"] is None and peaks["flops_per_s"] is None
    assert peaks["source"].startswith("unknown:")
    assert any(tok == "h100 80gb hbm3" and bw == 3.35e12
               for tok, bw, _ in TDEV._KNOWN_PEAKS)


def test_port_accountant_has_no_cuda_gauges_without_cuda():
    acct = TDEV.MemoryAccountant()
    acct.register("pool", lambda: 4096)
    g = acct.gauges()
    assert g["hbm_pool_bytes"] == 4096
    assert not any(k.startswith("cuda_") for k in g)


def test_port_device_trace_writes_a_chrome_trace(tmp_path):
    d = str(tmp_path / "prof")
    with TSPANS.device_trace(d) as prof:
        torch.arange(1000).sum()
    (name,) = os.listdir(d)
    with open(os.path.join(d, name)) as f:
        doc = json.load(f)
    assert doc["traceEvents"]
    assert prof.key_averages() is not None


# ---------------------------------------------------------------------------
# the two packages side by side
# ---------------------------------------------------------------------------

def _drive_registry(p):
    reg = p.registry.MetricsRegistry()
    reg.counter("dsm.host_steps").inc(7)
    reg.counter("journal.appends").inc(2)
    reg.gauge("engine.degraded").set(1)
    h = reg.histogram("staged.prep_ms")
    for v in (0.5, 3.0, 17.0, 1e4):
        h.record(v)
    reg.register_collector("dsm", lambda: {"read_ops": 11, "cas_ops": 3})
    return reg


def test_same_calls_give_equal_snapshots_and_prometheus_text():
    rj, rt = _drive_registry(PKGS["jax"]), _drive_registry(PKGS["torch"])
    assert rt.snapshot() == rj.snapshot()
    assert TEXP.prometheus_text(rt) == JEXP.prometheus_text(rj)
    assert TREG.delta({}, rt.snapshot()) == JREG.delta({}, rj.snapshot())


def test_latency_trackers_give_equal_percentiles_and_buckets():
    rng = np.random.default_rng(11)
    vals = rng.lognormal(mean=np.log(2e-3), sigma=1.1, size=5_000)
    weights = rng.integers(1, 50, vals.size)
    tj, tt = JSLO.LatencyTracker(), TSLO.LatencyTracker()
    for v, n in zip(vals, weights):
        tj.record(float(v), int(n))
        tt.record(float(v), int(n))
    assert tt.buckets == tj.buckets
    assert tt.snapshot() == tj.snapshot()
    for q in (0.1, 50, 90, 99, 99.9, 100):
        assert tt.percentile_ns(q) == tj.percentile_ns(q)
    sj = JSLO.SloTracker(window_s=5.0, clock=lambda: 0.0)
    st = TSLO.SloTracker(window_s=5.0, clock=lambda: 0.0)
    for i, (v, n) in enumerate(zip(vals[:500], weights[:500])):
        for s in (sj, st):
            s.observe(("read", "mixed")[i % 2], int(n), float(v),
                      batches=1 + i % 3, now=i * 0.03)
    assert st.window(now=16.0) == sj.window(now=16.0)
    assert st.collect() == sj.collect()


def _norm_trace(doc):
    evs = [{k: v for k, v in e.items() if k not in ("ts", "dur")}
           for e in doc["traceEvents"]]
    other = {k: v for k, v in doc["otherData"].items() if k != "tracer"}
    return evs, doc["displayTimeUnit"], other


def test_same_spans_give_equal_chrome_traces():
    docs = []
    for p in (PKGS["jax"], PKGS["torch"]):
        tr = p.spans.SpanTracer(max_events=4)
        with tr.span("engine.search.descend", n=512):
            with tr.span("engine.insert.split_drain"):
                pass
        for i in range(4):
            with tr.span("engine.delete.descend_lock_apply", n=i):
                pass
        tr.record("after", 0.5)
        docs.append(tr.chrome_trace())
    assert _norm_trace(docs[1]) == _norm_trace(docs[0])
    assert docs[1]["otherData"]["dropped_events"] == 3
    assert docs[0]["otherData"]["tracer"] == "sherman_tpu.obs"
    assert docs[1]["otherData"]["tracer"] == "sherman_tpu_torch.obs"


def test_same_events_give_equal_recorder_bundles(tmp_path):
    bundles = []
    for name, p in PKGS.items():
        r = p.FR.FlightRecorder(capacity=3)
        r.record("chaos.inject", fault="torn_page", step=0, addr=5, slot=0)
        r.record("scrub.violation", addr="0x5", mask="torn_page",
                 structural=True)
        r.record("engine.degraded_enter", reason="scrub")
        r.record("engine.degraded_exit")
        path = r.dump("drill", str(tmp_path / name))
        with open(path) as f:
            doc = json.load(f)
        with open(path.replace(".json", ".events.jsonl")) as f:
            lines = [json.loads(ln) for ln in f]
        strip = lambda evs: [{k: v for k, v in e.items() if k != "t"}
                             for e in evs]
        od = doc["otherData"]
        bundles.append((strip(od["flight_events"]), od["flight_dropped"],
                        od["reason"], strip(lines),
                        os.path.basename(path).split("-", 3)[3]))
    assert bundles[1] == bundles[0]
    assert [e["kind"] for e in bundles[0][0]] == [
        "scrub.violation", "engine.degraded_enter", "engine.degraded_exit"]
