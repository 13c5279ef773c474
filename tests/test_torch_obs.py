"""The port's ``repro_torch.obs`` and ``repro_torch.utils.atomicio``: the
reference's tracer, metrics, statistics, Chrome-export and CLI cases on the
port's copy, then the two packages against each other — a trace and a
metrics snapshot written by either validate and load in the other, and
``atomic_write_json`` writes the same bytes in both.  The reference's three
serve-engine cases wait for the port's serve runtime (ROADMAP C4)."""

import json
import threading

import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

import repro.obs as ref_obs
import repro.obs.cli as ref_obs_cli
from repro.utils.atomicio import atomic_write_json as ref_atomic_write_json
from repro_torch.obs import (NOOP_OBS, Histogram, MetricsRegistry,
                             NullTracer, Obs, Tracer, latency_summary,
                             load_chrome_trace, mean_tail, percentile,
                             to_chrome_trace, validate_chrome_trace,
                             write_chrome_trace)
from repro_torch.obs.cli import main as obs_cli, request_rows, slowest_spans
from repro_torch.utils import atomic_write_json, atomic_write_text


# -- stats --------------------------------------------------------------------

def test_percentile_nearest_rank_basics():
    vals = [10.0, 20.0, 30.0, 40.0]
    assert percentile(vals, 0) == 10.0
    assert percentile(vals, 50) == 20.0          # rank ceil(0.5*4)=2
    assert percentile(vals, 75) == 30.0
    assert percentile(vals, 100) == 40.0
    assert percentile([7.0], 95) == 7.0
    with pytest.raises(ValueError, match="empty"):
        percentile([], 50)
    with pytest.raises(ValueError, match="in \\[0, 100\\]"):
        percentile([1.0], 101)


@settings(max_examples=100, deadline=None)
@given(st.lists(st.floats(min_value=-1e6, max_value=1e6,
                          allow_nan=False), min_size=1, max_size=64),
       st.integers(min_value=0, max_value=100))
def test_percentile_matches_numpy_inverted_cdf(vals, q):
    """The single nearest-rank definition is exactly NumPy's
    method='inverted_cdf' for every sample set and integer q, and the
    reference's value."""
    expect = float(np.percentile(np.asarray(vals, np.float64), q,
                                 method="inverted_cdf"))
    assert percentile(vals, q) == pytest.approx(expect)
    assert percentile(vals, q) == ref_obs.percentile(vals, q)


def test_latency_summary_and_mean_tail():
    s = latency_summary([0.010, 0.020, 0.030], unit=1e3)
    assert s["p50"] == pytest.approx(20.0)
    assert s["max"] == pytest.approx(30.0)
    assert s["mean"] == pytest.approx(20.0)
    assert latency_summary([]) == {}
    assert mean_tail([10.0, 1.0, 1.0], skip=1) == pytest.approx(1.0)
    assert mean_tail([10.0], skip=5) == pytest.approx(10.0)  # short: use all
    assert mean_tail([], skip=2) == 0.0


# -- tracer -------------------------------------------------------------------

def test_tracer_span_kinds_and_order():
    tr = Tracer()
    with tr.span("outer", cat="test", track="p/t"):
        tr.instant("mark", cat="test", track="p/t")
    t0 = tr.epoch + 0.5
    tr.complete("pre", cat="test", track="p/t", start=t0, dur=0.25)
    spans = tr.spans()
    assert [s.name for s in spans] == ["outer", "mark", "pre"]
    outer, mark, pre = spans
    assert outer.ph == "X" and mark.ph == "i"
    assert outer.ts <= mark.ts <= outer.end      # the instant nests inside
    assert pre.ts == pytest.approx(0.5)
    assert pre.dur == pytest.approx(0.25)
    assert pre.end == pytest.approx(0.75)
    assert tr.dropped == 0


def test_tracer_thread_safety_and_ring_bound():
    """Concurrent writers never lose each other's spans below capacity,
    and a full per-thread ring drops oldest while counting the drops."""
    tr = Tracer(capacity_per_thread=100)
    n_threads, n_spans = 4, 150                  # 50 drops per thread

    def work(tid):
        for i in range(n_spans):
            tr.instant(f"t{tid}.{i}", track=f"p/{tid}")

    threads = [threading.Thread(target=work, args=(t,))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30.0)
        assert not t.is_alive()
    spans = tr.spans()
    assert len(spans) == n_threads * 100         # capacity kept per thread
    assert tr.dropped == n_threads * 50
    # the *newest* spans survive drop-oldest
    names = {s.name for s in spans}
    for t in range(n_threads):
        assert f"t{t}.{n_spans - 1}" in names
        assert f"t{t}.0" not in names


def test_null_tracer_and_noop_obs():
    nt = NullTracer()
    with nt.span("x"):
        nt.instant("y")
    nt.complete("z", start=0.0, dur=1.0)
    assert nt.spans() == [] and nt.dropped == 0 and not nt.enabled
    assert not NOOP_OBS.enabled
    NOOP_OBS.metrics.counter("anything").inc()
    NOOP_OBS.metrics.histogram("h").observe(1.0)
    assert NOOP_OBS.metrics.snapshot() == {}
    on = Obs.on()
    assert on.enabled and on.tracer.enabled


# -- metrics ------------------------------------------------------------------

def test_metrics_registry_instruments():
    reg = MetricsRegistry()
    reg.counter("req").inc()
    reg.counter("req").inc(4)
    reg.gauge("depth").set(3.5)
    h = reg.histogram("lat_ms")
    for v in (1.0, 2.0, 3.0, 4.0):
        h.observe(v)
    snap = reg.snapshot()
    assert snap["req"] == 5
    assert snap["depth"] == 3.5
    assert snap["lat_ms.count"] == 4
    assert snap["lat_ms.mean"] == pytest.approx(2.5)
    assert snap["lat_ms.p50"] == pytest.approx(2.0)   # nearest rank
    assert snap["lat_ms.min"] == 1.0 and snap["lat_ms.max"] == 4.0
    assert h.quantile(100) == 4.0
    reg.reset()
    assert reg.snapshot() == {}


def test_metrics_registry_kind_mismatch_raises():
    reg = MetricsRegistry()
    reg.counter("x")
    with pytest.raises(TypeError, match="already registered as Counter"):
        reg.gauge("x")
    with pytest.raises(TypeError, match="not Histogram"):
        reg.histogram("x")


def test_histogram_reservoir_bounds_memory():
    h = Histogram("h", keep=8)
    for v in range(100):
        h.observe(float(v))
    s = h.summary()
    assert s["count"] == 100                     # exact over the stream
    assert s["min"] == 0.0 and s["max"] == 99.0  # exact extremes
    assert s["p50"] >= 92.0                      # quantiles: recent window


def test_metrics_snapshot_atomic_write(tmp_path):
    reg = MetricsRegistry()
    reg.counter("c").inc(2)
    path = str(tmp_path / "metrics.json")
    reg.write_snapshot(path)
    with open(path) as f:
        assert json.load(f) == {"c": 2}


# -- chrome export ------------------------------------------------------------

def _sample_tracer(tracer_cls=Tracer):
    tr = tracer_cls()
    e = tr.epoch
    tr.complete("serve", cat="driver", track="replica0/driver",
                start=e, dur=1.0)
    tr.complete("decode", cat="stage", track="replica0/stage0",
                start=e + 0.1, dur=0.2, args={"group": 0})
    tr.complete("req0", cat="request", track="replica0/requests",
                start=e + 0.05, dur=0.5,
                args={"rid": 0, "ttft_ms": 100.0, "tokens": 4,
                      "finish": "length"})
    tr.instant("admit", cat="sched", track="replica0/sched",
               ts=e + 0.04, args={"rid": 0, "slot": 1})
    return tr


def test_chrome_trace_round_trip(tmp_path):
    tr = _sample_tracer()
    trace = to_chrome_trace(tr.spans(), dropped=tr.dropped)
    assert validate_chrome_trace(trace) == []
    path = str(tmp_path / "trace.json")
    write_chrome_trace(path, tr)
    loaded = load_chrome_trace(path)
    assert validate_chrome_trace(loaded) == []
    evs = loaded["traceEvents"]
    # one process metadata entry per "process", one thread per track
    procs = {e["args"]["name"] for e in evs
             if e.get("ph") == "M" and e["name"] == "process_name"}
    assert procs == {"replica0"}
    threads = {e["args"]["name"] for e in evs
               if e.get("ph") == "M" and e["name"] == "thread_name"}
    assert threads == {"driver", "stage0", "requests", "sched"}
    xs = [e for e in evs if e.get("ph") == "X"]
    assert {e["name"] for e in xs} == {"serve", "decode", "req0"}
    drv = next(e for e in xs if e["name"] == "serve")
    assert drv["dur"] == pytest.approx(1e6)      # seconds -> microseconds
    assert loaded["otherData"]["dropped_spans"] == 0


def test_validate_chrome_trace_catches_malformed():
    assert validate_chrome_trace({"nope": 1})
    bad = {"traceEvents": [{"ph": "X", "name": "a", "ts": 0.0,
                            "pid": 1, "tid": 1, "dur": -5.0}]}
    errs = validate_chrome_trace(bad)
    assert any("dur" in e for e in errs)
    # pid/tid without naming metadata is flagged (Perfetto shows bare ints)
    anon = {"traceEvents": [{"ph": "X", "name": "a", "ts": 0.0,
                             "pid": 7, "tid": 7, "dur": 1.0}]}
    assert any("metadata" in e for e in validate_chrome_trace(anon))


def test_cli_renders_tables(tmp_path, capsys):
    tr = _sample_tracer()
    path = str(tmp_path / "trace.json")
    write_chrome_trace(path, tr)
    assert obs_cli([path, "--top", "5"]) == 0
    out = capsys.readouterr().out
    assert "per-request breakdown" in out
    assert "slowest spans" in out
    assert "latency_ms p50=" in out
    trace = load_chrome_trace(path)
    rows = request_rows(trace)
    assert [r["rid"] for r in rows] == [0]
    assert rows[0]["replica"] == "replica0"
    assert rows[0]["latency_ms"] == pytest.approx(500.0)
    slow = slowest_spans(trace, top=2)
    assert slow[0]["name"] == "serve"            # longest non-request span


def test_cli_rejects_invalid_trace(tmp_path, capsys):
    path = str(tmp_path / "bad.json")
    with open(path, "w") as f:
        json.dump({"traceEvents": [{"ph": "X"}]}, f)
    assert obs_cli([path]) == 2
    assert "INVALID" in capsys.readouterr().err


# -- the two packages against each other --------------------------------------

_SIDES = {"port": (Tracer, MetricsRegistry, write_chrome_trace,
                   validate_chrome_trace, load_chrome_trace),
          "reference": (ref_obs.Tracer, ref_obs.MetricsRegistry,
                        ref_obs.write_chrome_trace,
                        ref_obs.validate_chrome_trace,
                        ref_obs.load_chrome_trace)}


@pytest.mark.parametrize("writer,reader", [("port", "reference"),
                                           ("reference", "port")])
def test_trace_and_snapshot_load_in_the_other_package(tmp_path, writer,
                                                      reader):
    """A Chrome trace and a metrics snapshot written by one package
    validate, load and render in the other, event for event."""
    tracer_cls, reg_cls, write, _, _ = _SIDES[writer]
    _, _, _, validate, load = _SIDES[reader]
    tr = _sample_tracer(tracer_cls)
    path = str(tmp_path / "trace.json")
    write(path, tr)
    loaded = load(path)
    assert validate(loaded) == []
    assert loaded == load_chrome_trace(path)
    rows = (request_rows if reader == "port"
            else ref_obs_cli.request_rows)(loaded)
    assert [r["latency_ms"] for r in rows] == [pytest.approx(500.0)]

    reg = reg_cls()
    reg.counter("search_warm_starts").inc(3)
    reg.gauge("depth").set(0.125)
    for v in (0.5, 1.5, 2.5):
        reg.histogram("search_wall_s").observe(v)
    snap_path = str(tmp_path / "metrics.json")
    reg.write_snapshot(snap_path)
    with open(snap_path) as f:
        snap = json.load(f)
    assert snap["search_warm_starts"] == 3
    assert snap["search_wall_s.p50"] == 1.5
    assert ref_obs_cli.main([path, "--metrics", snap_path]) == 0
    assert obs_cli([path, "--metrics", snap_path]) == 0


def test_same_spans_give_the_same_trace_and_snapshot_bytes(tmp_path):
    """The two exporters turn the same spans, and the two registries the
    same observations, into byte-identical files."""
    tr = _sample_tracer()
    write_chrome_trace(str(tmp_path / "a.json"), tr.spans())
    ref_obs.write_chrome_trace(str(tmp_path / "b.json"), tr.spans())
    regs = [MetricsRegistry(), ref_obs.MetricsRegistry()]
    for reg, name in zip(regs, ("c.json", "d.json")):
        reg.counter("n").inc(2)
        for v in (0.1, 0.7, 0.3):
            reg.histogram("h").observe(v)
        reg.write_snapshot(str(tmp_path / name))
    read = {n: (tmp_path / n).read_bytes()
            for n in ("a.json", "b.json", "c.json", "d.json")}
    assert read["a.json"] == read["b.json"]
    assert read["c.json"] == read["d.json"]


@pytest.mark.parametrize("payload", [{"a": [1, 2.5, None], "b": "x"},
                                     [], {"nested": {"k": (1, 2)}}])
def test_atomic_write_json_is_byte_identical(tmp_path, payload):
    atomic_write_json(str(tmp_path / "port.json"), payload)
    ref_atomic_write_json(str(tmp_path / "ref.json"), payload)
    assert ((tmp_path / "port.json").read_bytes()
            == (tmp_path / "ref.json").read_bytes())
    atomic_write_text(str(tmp_path / "t.txt"), "done\n")
    assert (tmp_path / "t.txt").read_text() == "done\n"
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "port.json", "ref.json", "t.txt"]           # no temp file left
