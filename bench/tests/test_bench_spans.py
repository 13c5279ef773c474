"""The program's spans on the profiler's clock (``bench/lib/spans.py``): the
clock anchor maps a span within 100 us of a profiler block opened with
it, the attribution of self time, device time and idle gaps is exact on
a hand-built trace, and the K1 work counted from the search's own
``search.rank`` spans equals the count from the wrapped launches."""

from __future__ import annotations

import json

import pytest
import torch

from bench.lib import spans
from repro_torch.obs import Obs


def _export(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())["traceEvents"]


def test_anchor_maps_a_span_onto_the_trace_clock(tmp_path):
    from torch.profiler import ProfilerActivity, profile, record_function
    obs = Obs.on()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        reads = spans.anchor()
        torch.ones(64).sum()
        with record_function("probe"):
            with obs.tracer.span("probe", track="t"):
                torch.ones(64).sum()
    events = _export(prof, tmp_path)
    offset, error = spans.Events(events).offset_us(reads)
    assert error < 100.0
    probe = [e for e in events
             if e.get("name") == "probe" and e.get("ph") == "X"]
    s, = obs.tracer.spans()
    mapped = (obs.tracer.epoch + s.ts) * 1e6 + offset
    assert abs(mapped - float(probe[0]["ts"])) < 100.0
    ends = abs(mapped + s.dur * 1e6
               - float(probe[0]["ts"]) - float(probe[0]["dur"]))
    assert ends < 100.0


def test_anchor_count_must_match_the_reads():
    ev = spans.Events([{"ph": "X", "cat": "user_annotation",
                        "name": spans.ANCHOR, "ts": 10.0, "dur": 2.0}])
    assert ev.offset_us([1e-6]) == (10.0, 2.0)
    with pytest.raises(ValueError):
        ev.offset_us([1.0, 2.0])


class _Span:
    """A recorded span as ``repro_torch.obs.Span`` has it (seconds from the
    tracer's epoch)."""

    def __init__(self, name, ts_us, dur_us, args=None):
        self.name, self.ts, self.dur = name, ts_us / 1e6, dur_us / 1e6
        self.ph, self.args = "X", args


def _hand_trace():
    """Trace clock = perf_counter us + 1000 (anchor at 1000..1002, read at
    1 us).  Window 1000-1200 us.  Spans (trace us): outer 1010-1150 holding
    inner 1040-1100.  Kernels: k1 1020-1030 launched 1015 (outer), k2
    1060-1070 launched 1045 (inner), k3 1110-1180 launched 1105 (outer),
    c1 1071-1073 (a copy, launched 1050, inner).  Idle: 1000-1020 (10 us
    under no span, 10 outer), 1030-1060 (10 outer, 20 inner), 1070-1071 (1
    us: short), 1073-1110 (27 inner, 10 outer), 1180-1200 (20, no span)."""
    def x(cat, name, ts, dur, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "args": args}
    events = [
        x("user_annotation", spans.ANCHOR, 1000.0, 2.0),
        x("cuda_runtime", "cudaLaunchKernel", 1015.0, 3.0, correlation=1),
        x("kernel", "k1", 1020.0, 10.0, correlation=1),
        x("cuda_runtime", "cudaLaunchKernel", 1045.0, 3.0, correlation=2),
        x("kernel", "k2", 1060.0, 10.0, correlation=2),
        x("cuda_runtime", "cudaMemcpyAsync", 1050.0, 3.0, correlation=4),
        x("gpu_memcpy", "Memcpy DtoH", 1071.0, 2.0, correlation=4),
        x("cuda_runtime", "cudaLaunchKernel", 1105.0, 3.0, correlation=3),
        x("kernel", "k3", 1110.0, 70.0, correlation=3),
        {"ph": "X", "cat": "kernel", "name": "before", "ts": 900.0,
         "dur": 10.0, "args": {"correlation": 9}},
    ]
    recorded = [_Span("outer", 10.0, 140.0, {"k": 1}),
                _Span("inner", 40.0, 60.0)]
    # epoch 0; the anchor's read at 1 us puts its midpoint 1000 us later
    return spans.SpanView(spans.Events(events), recorded, epoch=0.0,
                          reads=[1e-6], t0=0.0, window_s=200e-6)


def test_span_view_on_a_hand_built_trace():
    view = _hand_trace()
    assert view.offset_us == pytest.approx(1000.0)
    assert view.error_us == 2.0
    rows = view.summary()
    assert rows["outer"]["count"] == rows["inner"]["count"] == 1
    assert rows["outer"]["self_ms"] == pytest.approx(0.080)
    assert rows["inner"]["self_ms"] == pytest.approx(0.060)
    assert rows["outer"]["device_busy_ms"] == pytest.approx(0.080)
    assert rows["inner"]["device_busy_ms"] == pytest.approx(0.012)
    assert rows["outer"]["device_idle_ms"] == pytest.approx(0.030)
    assert rows["inner"]["device_idle_ms"] == pytest.approx(0.047)
    idle = view.idle_by_span()
    assert idle[spans.NO_SPAN] == pytest.approx(30e-6)
    assert idle[spans.SHORT_GAPS] == pytest.approx(1e-6)
    busy = sum(b - a for a, b in view.events.busy_intervals(view.lo, view.hi))
    assert sum(idle.values()) == pytest.approx(200e-6 - busy / 1e6)
    assert view.args("outer") == [{"k": 1}]
    assert view.at(1045.0) == "inner" and view.at(1120.0) == "outer"
    assert view.at(1160.0) == spans.NO_SPAN
    assert dict(view.split(1030.0, 1060.0)) == {"outer": 10.0, "inner": 20.0}
    m = view.metric(["outer", "inner"], per=2)
    assert m["value"] == pytest.approx(0.070) and m["count"] == 2
    assert view.metric(["absent"], per=1) is None


def test_innermost_segments_of_nested_and_sibling_spans():
    segs = spans.innermost([("a", 0, 10), ("b", 2, 4), ("c", 4, 6),
                            ("d", 12, 13)])
    assert segs == [(0, 2, "a"), (2, 4, "b"), (4, 6, "c"), (6, 10, "a"),
                    (12, 13, "d")]
    assert spans.self_times([("a", 0, 10), ("b", 2, 4), ("a", 20, 21)]) == \
        {"a": 9, "b": 2}


def test_k1_work_from_rank_spans_equals_the_launch_log():
    """``search.rank``'s ``n``, ``m`` and ``feasible`` count the same K1
    work as the harness's wrapper counts from each launch's inputs."""
    from bench.drivers import search
    from bench.lib import harness, work
    from repro_torch.explore import run_spec
    _, _, config = harness.cell_files("search.effnetb0-4plat.pop16k")
    traffic = {"pop_size": 128, "n_gen": 2, "rank_block": 64}
    spec = search._spec(config, traffic, 20261018)
    keeper = search.Keeper(torch.device("cpu"))
    try:
        keeper.log = []
        obs = Obs.on()
        run_spec(spec, device="cpu", obs=obs)
        launches, keeper.log = keeper.log, None
    finally:
        keeper.restore()
    want = [search._work(*launch)[1] for launch in launches
            if launch[0] == "K1"]
    got = [work.domination_ops(a["m"], a["feasible"], a["n"], a["feasible"],
                               a["n"])
           for a in (s.args for s in obs.tracer.spans()
                     if s.name == "search.rank")]
    assert len(want) == traffic["n_gen"] + 1 and got == want

