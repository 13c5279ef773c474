"""The port's fault tolerance (``repro_torch.serve.faults`` / ``.health``
+ router failover) and its traced serve engine, on the CPU: the JAX
package's ``tests/test_faults.py`` and the serve-engine cases of
``tests/test_obs.py`` run on the port.  Fault-plan determinism,
missed-heartbeat failure detection without false positives, hysteresis
that refuses to thrash on transient spikes, the headline invariant — a
replica crash mid-stream loses zero requests and the recovered requests'
greedy tokens are byte-identical to a no-fault run — and request spans
that reconcile with the engine's own records.  Imports no JAX."""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.link import LinkModel  # noqa: E402
from repro_torch.explore import (PlatformSpec, SystemSpec,  # noqa: E402
                                 degrade_link)
from repro_torch.models.registry import build_model, get_config  # noqa: E402
from repro_torch.obs import (NOOP_OBS, Obs, to_chrome_trace,  # noqa: E402
                             validate_chrome_trace)
from repro_torch.obs.cli import request_rows  # noqa: E402
from repro_torch.serve import (DivergenceMonitor, FailureDetector,  # noqa: E402
                               FaultPlan, FaultTrace, HealthMonitor,
                               LinkDegrade, PipelineServeEngine,
                               ReplicaCrash, ReplicaCrashError,
                               ReplicaRouter, Request, ServeLink,
                               StageStall, poisson_traffic, stream_of)
from repro_torch.serving.pipeline import PartitionedLMRunner  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def lm():
    cfg = get_config("smollm-360m").reduced()
    model = build_model(cfg, device="cpu")
    return cfg, model


@pytest.fixture(scope="module")
def runner(lm):
    cfg, model = lm
    return PartitionedLMRunner(model, cuts=[0])


def _burst(reqs, deadline_s=None):
    return [Request(r.rid, r.prompt, r.max_new, 0.0, deadline_s=deadline_s)
            for r in reqs]


def _traffic(cfg, n=8, max_new=5, seed=2):
    return poisson_traffic(n, rate_rps=1000.0, vocab=cfg.vocab,
                           prompt_len=6, max_new=max_new, seed=seed)


@pytest.fixture(scope="module")
def ref_tokens(runner, lm):
    """Greedy tokens of the shared traffic on a clean single replica —
    the byte-identity reference for every failover test."""
    cfg, *_ = lm
    eng = PipelineServeEngine(runner, n_slots=4, eos=None, mode="async",
                              capacity=32, name="ref")
    eng.warmup(prompt_len=6)
    rep = eng.run(stream_of(_burst(_traffic(cfg))))
    assert rep.n_done == 8 and rep.n_failed == 0
    return {r.rid: list(r.tokens) for r in rep.records}


# -- FaultPlan: pure, validated, deterministic --------------------------------

def test_fault_plan_lookups_and_validation():
    plan = FaultPlan(events=(LinkDegrade(0, 4.0, at_transfer=2,
                                         until_transfer=6),
                             LinkDegrade(0, 2.0, at_transfer=5),
                             StageStall(1, 0.25, at_item=3),
                             StageStall(1, 0.5, at_item=3),
                             ReplicaCrash(at_step=7)))
    assert [plan.link_factor(0, k) for k in range(8)] == \
           [1.0, 1.0, 4.0, 4.0, 4.0, 8.0, 2.0, 2.0]   # windows compound
    assert plan.link_factor(1, 3) == 1.0              # other links healthy
    assert plan.stage_stall_s(1, 3) == 0.75           # stalls sum
    assert plan.stage_stall_s(1, 2) == 0.0
    assert plan.crash_step == 7
    assert FaultPlan().crash_step is None

    with pytest.raises(ValueError, match="factor"):
        LinkDegrade(0, 0.0)
    with pytest.raises(ValueError, match="stall_s"):
        StageStall(0, -1.0)
    with pytest.raises(ValueError, match="at_step"):
        ReplicaCrash(-1)
    with pytest.raises(ValueError, match="at most one"):
        FaultPlan(events=(ReplicaCrash(1), ReplicaCrash(2)))
    with pytest.raises(TypeError, match="unknown fault event"):
        FaultPlan(events=("not-an-event",))


def test_fault_plan_jitter_deterministic_per_seed():
    a = FaultPlan(link_jitter_s=0.01, seed=9)
    b = FaultPlan(link_jitter_s=0.01, seed=9)
    other = FaultPlan(link_jitter_s=0.01, seed=10)
    draws = [a.link_jitter(0, k) for k in range(32)]
    assert draws == [b.link_jitter(0, k) for k in range(32)]
    assert all(0.0 <= j < 0.01 for j in draws)
    assert draws != [other.link_jitter(0, k) for k in range(32)]
    assert a.link_jitter(0, 3) != a.link_jitter(1, 3)  # per-link streams
    assert FaultPlan().link_jitter(0, 3) == 0.0


def test_injected_trace_and_tokens_reproducible(runner, lm):
    """Two runs of the same plan over the same traffic apply the identical
    fault sequence (canonical trace) and decode identical tokens."""
    cfg, *_ = lm

    def one():
        plan = FaultPlan(events=(LinkDegrade(0, 3.0, at_transfer=2,
                                             until_transfer=9),
                                 StageStall(1, 0.01, at_item=4)),
                         link_jitter_s=0.001, seed=11)
        eng = PipelineServeEngine(runner, n_slots=4, eos=None, mode="async",
                                  capacity=32, faults=plan)
        eng.warmup(prompt_len=6)
        rep = eng.run(stream_of(_burst(_traffic(cfg, n=4, max_new=4))))
        assert rep.n_done == 4
        return (eng.fault_trace.canonical(),
                {r.rid: list(r.tokens) for r in rep.records})
    trace1, toks1 = one()
    trace2, toks2 = one()
    assert len(trace1) > 0
    assert trace1 == trace2
    assert toks1 == toks2
    kinds = {e[0] for e in trace1}
    assert {"link_degrade", "link_jitter", "stage_stall"} <= kinds


def test_fault_trace_canonical_sorts_interleavings():
    t1, t2 = FaultTrace(), FaultTrace()
    t1.record("link_degrade", 0, 0, 2.0)
    t1.record("link_degrade", 0, 1, 2.0)
    t2.record("link_degrade", 0, 1, 2.0)   # reversed arrival order
    t2.record("link_degrade", 0, 0, 2.0)
    assert t1.entries != t2.entries
    assert t1.canonical() == t2.canonical()
    assert len(t1) == 2


# -- failure detector ---------------------------------------------------------

def _serve_probing_detector(runner, cfg, plan, timeout_s):
    """Serve a small burst while a probe thread samples the failure
    detector; returns the set of stages ever reported stalled."""
    health = HealthMonitor(runner.n_stages, runner.n_stages - 1)
    eng = PipelineServeEngine(runner, n_slots=4, eos=None, mode="async",
                              capacity=32, faults=plan, health=health)
    eng.warmup(prompt_len=6)
    fd = FailureDetector(health, timeout_s=timeout_s)
    seen, stop = set(), threading.Event()

    def probe():
        while not stop.is_set():
            seen.update(fd.stalled())
            time.sleep(0.01)

    th = threading.Thread(target=probe, daemon=True)
    th.start()
    rep = eng.run(stream_of(_burst(_traffic(cfg, n=4, max_new=4))))
    stop.set()
    th.join(timeout=2.0)
    assert rep.n_done == 4
    return seen


def test_failure_detector_no_false_positive_on_clean_run(runner, lm):
    """Idle workers heartbeat on every queue poll, so a healthy run never
    trips the detector — even while workers sit idle between waves."""
    cfg, *_ = lm
    seen = _serve_probing_detector(runner, cfg, FaultPlan(), timeout_s=0.75)
    assert seen == set()


def test_failure_detector_catches_stalled_stage(runner, lm):
    """A worker stuck inside a stalled stage call stops heartbeating and
    is reported; the run still completes once the stall clears."""
    cfg, *_ = lm
    plan = FaultPlan(events=(StageStall(1, 2.0, at_item=2),))
    seen = _serve_probing_detector(runner, cfg, plan, timeout_s=0.6)
    assert 1 in seen


def test_failure_detector_validation():
    hm = HealthMonitor(2, 1)
    with pytest.raises(ValueError, match="timeout_s"):
        FailureDetector(hm, timeout_s=0.0)
    fd = FailureDetector(hm, timeout_s=1.0)
    assert fd.stalled(now=100.0) == []        # never-heartbeat = not stalled
    hm.heartbeat(0, 10.0)
    assert fd.stalled(now=10.5) == []
    assert fd.stalled(now=12.0) == [0]
    assert not fd.healthy(now=12.0)


# -- health estimators --------------------------------------------------------

def test_health_monitor_divergence_and_rate():
    hm = HealthMonitor(2, 1, alpha=1.0)       # alpha=1: value = last sample
    assert hm.link_divergence(0) == 1.0       # no samples -> "as deployed"
    assert hm.link_rate_bps(0) == 0.0
    hm.record_link(0, nbytes=1000, measured_s=4e-3, model_s=1e-3)
    assert hm.link_divergence(0) == pytest.approx(4.0)
    assert hm.link_rate_bps(0) == pytest.approx(1000 * 8 / 4e-3)
    assert hm.link_samples(0) == 1
    hm.record_stage(1, 0.25, now=5.0)
    assert hm.stage_occupancy_s(1) == pytest.approx(0.25)
    assert hm.last_heartbeat(1) == 5.0
    snap = hm.snapshot()
    assert snap["link_divergence"] == [4.0]
    with pytest.raises(ValueError):
        HealthMonitor(0, 1)


# -- hysteresis ---------------------------------------------------------------

TWO_NODE = SystemSpec(platforms=(PlatformSpec("A", "eyr", bits=16),
                                 PlatformSpec("B", "smb", bits=8)),
                      links=("gige",), name="AB")


def _feed(hm, ratio):
    hm.record_link(0, nbytes=1000, measured_s=ratio * 1e-3, model_s=1e-3)


def test_hysteresis_transient_spike_never_fires():
    """min_breach consecutive observations are required: a 2-observation
    spike at 5x divergence does not trigger a re-partition."""
    hm = HealthMonitor(1, 1, alpha=1.0)
    dm = DivergenceMonitor(TWO_NODE, enter=2.0, exit=1.2, min_breach=3,
                           cooldown_s=10.0, min_samples=1)
    for t, ratio in enumerate([5.0, 5.0, 1.0, 5.0, 5.0, 1.0]):
        _feed(hm, ratio)
        assert dm.observe(hm, now=float(t)) is None
    assert dm.signals == [] and dm.alarmed_links == []
    assert dm.drifted_system() == TWO_NODE


def test_hysteresis_sustained_breach_fires_once_then_latches():
    hm = HealthMonitor(1, 1, alpha=1.0)
    dm = DivergenceMonitor(TWO_NODE, enter=2.0, exit=1.2, min_breach=3,
                           cooldown_s=10.0, min_samples=1)
    fired = []
    for t in range(3):
        _feed(hm, 5.0)
        fired.append(dm.observe(hm, now=float(t)))
    assert fired[:2] == [None, None]
    sig = fired[2]
    assert sig is not None and sig.link == 0
    assert sig.divergence == pytest.approx(5.0)
    assert dm.alarmed_links == [0]
    # latched: hovering above `enter` does not re-fire
    _feed(hm, 5.0)
    assert dm.observe(hm, now=3.0) is None
    assert len(dm.signals) == 1
    # the drifted snapshot degrades the alarmed link by measured divergence
    assert dm.drifted_system() == degrade_link(TWO_NODE, 0, 5.0)
    # recovery below `exit` re-arms and clears the drifted snapshot
    _feed(hm, 1.0)
    assert dm.observe(hm, now=4.0) is None
    assert dm.alarmed_links == []
    assert dm.drifted_system() == TWO_NODE


def test_hysteresis_cooldown_rate_limits_refires():
    hm = HealthMonitor(1, 1, alpha=1.0)
    dm = DivergenceMonitor(TWO_NODE, enter=2.0, exit=1.2, min_breach=3,
                           cooldown_s=10.0, min_samples=1)
    for t in range(3):
        _feed(hm, 5.0)
        dm.observe(hm, now=float(t))
    assert len(dm.signals) == 1               # fired at t=2
    _feed(hm, 1.0)
    dm.observe(hm, now=3.0)                   # recovered: re-armed
    for t in (4.0, 5.0, 6.0, 7.0):            # breaches inside the cooldown
        _feed(hm, 5.0)
        assert dm.observe(hm, now=t) is None
    _feed(hm, 5.0)
    sig = dm.observe(hm, now=13.0)            # cooldown (2 + 10s) elapsed
    assert sig is not None
    assert len(dm.signals) == 2


def test_divergence_monitor_warmup_and_validation():
    hm = HealthMonitor(1, 1, alpha=1.0)
    dm = DivergenceMonitor(TWO_NODE, enter=2.0, exit=1.2, min_breach=1,
                           cooldown_s=0.0, min_samples=4)
    for t in range(3):                        # estimator still warming up
        _feed(hm, 50.0)
        assert dm.observe(hm, now=float(t)) is None
    _feed(hm, 50.0)                           # 4th sample: gate opens
    assert dm.observe(hm, now=3.0) is not None
    with pytest.raises(ValueError, match="enter > exit"):
        DivergenceMonitor(TWO_NODE, enter=1.2, exit=1.2)
    with pytest.raises(ValueError, match="min_breach"):
        DivergenceMonitor(TWO_NODE, min_breach=0)
    # rebase resets alarms against the re-deployed spec
    dm.rebase(degrade_link(TWO_NODE, 0, 50.0))
    assert dm.alarmed_links == [] and len(dm.signals) == 1


def test_cooldown_expiry_still_requires_fresh_breaches():
    """The cooldown gates *when* a fire may happen, never substitutes for
    the breach count: after the cooldown expires, a dip below `enter`
    resets the counter and min_breach fresh consecutive breaches are
    needed before the re-fire."""
    hm = HealthMonitor(1, 1, alpha=1.0)
    dm = DivergenceMonitor(TWO_NODE, enter=2.0, exit=1.2, min_breach=3,
                           cooldown_s=5.0, min_samples=1)
    for t in range(3):
        _feed(hm, 5.0)
        dm.observe(hm, now=float(t))
    assert len(dm.signals) == 1                   # fired at t=2
    _feed(hm, 1.0)
    dm.observe(hm, now=3.0)                       # recovered: re-armed
    _feed(hm, 1.0)
    dm.observe(hm, now=20.0)                      # cooldown long expired...
    _feed(hm, 5.0)
    assert dm.observe(hm, now=21.0) is None       # ...but breaches 1/3
    _feed(hm, 5.0)
    assert dm.observe(hm, now=22.0) is None       # 2/3
    _feed(hm, 5.0)
    sig = dm.observe(hm, now=23.0)                # 3/3: fresh fire
    assert sig is not None and len(dm.signals) == 2


def test_rebase_clears_cooldown_and_breach_state():
    """After acting on a signal the monitor is rebased onto the new
    deployment: the cooldown clock and any half-accumulated breach count
    must not leak into the new spec's epoch."""
    hm = HealthMonitor(1, 1, alpha=1.0)
    dm = DivergenceMonitor(TWO_NODE, enter=2.0, exit=1.2, min_breach=2,
                           cooldown_s=1000.0, min_samples=1)
    for t in range(2):
        _feed(hm, 6.0)
        dm.observe(hm, now=float(t))
    assert len(dm.signals) == 1
    dm.rebase(TWO_NODE)
    assert dm.alarmed_links == []
    # a fire right after rebase: the old cooldown would block until
    # t=1001, the old alarm latch would swallow it entirely
    for t in (2.0, 3.0):
        _feed(hm, 6.0)
        sig = dm.observe(hm, now=t)
    assert sig is not None and len(dm.signals) == 2


def test_observe_records_divergence_history():
    """Every observation lands in `history` as (t, per-link divergence) —
    the measured-vs-modeled series the drift timeline artifact persists —
    whether or not anything fired."""
    hm = HealthMonitor(1, 1, alpha=1.0)
    dm = DivergenceMonitor(TWO_NODE, enter=2.0, exit=1.2, min_breach=3,
                           cooldown_s=10.0, min_samples=1)
    assert list(dm.history) == []
    for t, ratio in enumerate([1.0, 5.0, 1.0]):
        _feed(hm, ratio)
        dm.observe(hm, now=float(t))
    assert [t for t, _ in dm.history] == [0.0, 1.0, 2.0]
    assert dm.history[1][1][0] == pytest.approx(5.0)
    assert all(len(divs) == 1 for _, divs in dm.history)


def test_ewma_first_sample_is_raw():
    """The first sample becomes the value verbatim — no (1-alpha) pull
    toward a phantom zero start — so a single link transfer already
    yields its exact measured/model divergence."""
    from repro_torch.serve.health import Ewma
    e = Ewma(alpha=0.25)
    assert e.value == 0.0 and e.n == 0            # empty: explicit zero
    assert e.update(4.0) == pytest.approx(4.0)    # raw, not 0.75*0+0.25*4
    assert e.n == 1
    assert e.update(8.0) == pytest.approx(0.75 * 4.0 + 0.25 * 8.0)
    # HealthMonitor inherits it: one transfer -> exact divergence even
    # with smoothing enabled
    hm = HealthMonitor(1, 1, alpha=0.25)
    hm.record_link(0, nbytes=100, measured_s=4e-3, model_s=1e-3)
    assert hm.link_divergence(0) == pytest.approx(4.0)


# -- replica crash + router failover ------------------------------------------

def test_engine_crash_stashes_done_records(runner, lm):
    """The engine's failure path leaves completed records in
    ``crash_records`` so the router can salvage them and re-admit only
    the unfinished requests."""
    cfg, *_ = lm
    reqs = _traffic(cfg, n=3, max_new=2)
    eng = PipelineServeEngine(runner, n_slots=2, n_groups=1, eos=None,
                              mode="serial", capacity=32,
                              faults=FaultPlan(events=(ReplicaCrash(1),)),
                              name="crashy")
    eng.warmup(prompt_len=6)
    with pytest.raises(ReplicaCrashError) as ei:
        eng.run(stream_of(_burst(reqs)))
    assert ei.value.replica == "crashy" and ei.value.step >= 1
    assert "injected crash" in str(ei.value)
    # the first decode wave finished requests 0 and 1 (max_new=2); both
    # must be salvageable, request 2 stays stranded for the router
    assert set(eng.crash_records) == {0, 1}
    assert all(rec.done for rec in eng.crash_records.values())
    trace = eng.fault_trace.canonical()
    assert ("replica_crash", 0, ei.value.step) in trace


def test_router_failover_zero_loss_token_identity(runner, lm, ref_tokens):
    """The headline invariant: a replica crash mid-stream loses zero
    requests, and every recovered request's greedy tokens are
    byte-identical to the no-fault run."""
    cfg, *_ = lm
    slow = LinkModel(name="slow", rate_bps=1e9, t_setup_s=0.02)
    crashy = PipelineServeEngine(
        runner, n_slots=2, n_groups=1, eos=None, mode="async", capacity=32,
        links=[ServeLink(model=slow) for _ in range(runner.n_stages - 1)],
        faults=FaultPlan(events=(ReplicaCrash(at_step=2),)), name="crashy")
    survivor = PipelineServeEngine(runner, n_slots=4, eos=None, mode="async",
                                   capacity=32, name="survivor")
    for e in (crashy, survivor):
        e.warmup(prompt_len=6)
    router = ReplicaRouter([crashy, survivor])
    rep = router.serve(_burst(_traffic(cfg)), realtime=False)

    assert rep.extra["n_replica_failures"] == 1
    assert rep.extra["requests_recovered"] >= 1
    assert "recovery_ms" in rep.extra and rep.extra["recovery_ms"] >= 0.0
    assert rep.n_done == 8 and rep.n_failed == 0       # zero lost
    got = {r.rid: list(r.tokens) for r in rep.records}
    assert got == ref_tokens                           # byte-identical
    assert len(crashy.fault_trace) >= 1                # crash was recorded


def test_router_sheds_recovered_requests_past_deadline(runner, lm,
                                                       ref_tokens):
    """Failover honors deadlines: a recovered request whose deadline has
    already passed is recorded ``finish='shed'`` instead of wasting
    survivor capacity — and never silently dropped."""
    cfg, *_ = lm
    slow = LinkModel(name="slow", rate_bps=1e9, t_setup_s=0.02)
    crashy = PipelineServeEngine(
        runner, n_slots=2, n_groups=1, eos=None, mode="async", capacity=32,
        links=[ServeLink(model=slow) for _ in range(runner.n_stages - 1)],
        faults=FaultPlan(events=(ReplicaCrash(at_step=2),)), name="crashy")
    survivor = PipelineServeEngine(runner, n_slots=4, eos=None, mode="async",
                                   capacity=32, name="survivor")
    for e in (crashy, survivor):
        e.warmup(prompt_len=6)
    burst = _burst(_traffic(cfg), deadline_s=1e-4)     # already expired
    rep = ReplicaRouter([crashy, survivor]).serve(burst, realtime=False)

    assert rep.extra["n_replica_failures"] == 1
    assert rep.n_done + rep.n_failed == 8              # all accounted for
    assert rep.n_failed >= 1                           # crashy had >= 1
    shed = [r for r in rep.records if r.failed]
    assert all(r.finish == "shed" for r in shed)
    assert all(r.failed for r in shed) and shed[0].latency_s is None
    # requests that never touched the dead replica still match reference
    got = {r.rid: list(r.tokens) for r in rep.records if r.done}
    assert all(got[rid] == ref_tokens[rid] for rid in got)
    assert rep.summary()["n_failed"] == rep.n_failed


def test_router_retry_budget_marks_lost(runner, lm):
    """With ``max_retries=0`` a recovered request is recorded lost (never
    silently dropped) while untouched requests still complete."""
    cfg, *_ = lm
    slow = LinkModel(name="slow", rate_bps=1e9, t_setup_s=0.02)
    crashy = PipelineServeEngine(
        runner, n_slots=2, n_groups=1, eos=None, mode="async", capacity=32,
        links=[ServeLink(model=slow) for _ in range(runner.n_stages - 1)],
        faults=FaultPlan(events=(ReplicaCrash(at_step=2),)), name="crashy")
    survivor = PipelineServeEngine(runner, n_slots=4, eos=None, mode="async",
                                   capacity=32, name="survivor")
    for e in (crashy, survivor):
        e.warmup(prompt_len=6)
    router = ReplicaRouter([crashy, survivor], max_retries=0)
    rep = router.serve(_burst(_traffic(cfg)), realtime=False)
    assert rep.n_done + rep.n_failed == 8
    assert rep.n_failed >= 1
    assert all(r.finish == "lost" for r in rep.records if r.failed)
    with pytest.raises(ValueError, match="max_retries"):
        ReplicaRouter([survivor], max_retries=-1)


# -- serve-engine integration -------------------------------------------------

def test_traced_engine_run_reconciles_with_report(runner):
    """A traced async run produces stage/link/driver/request spans whose
    request rows match the engine's own RequestRecords exactly, and the
    scheduler's lifecycle instants land on the sched track."""
    obs = Obs.on()
    eng = PipelineServeEngine(runner, n_slots=2, n_groups=1, eos=None,
                              mode="async", capacity=32, obs=obs)
    eng.warmup(prompt_len=6)
    prompts = np.random.default_rng(1).integers(
        0, 100, size=(3, 6)).astype(np.int32)
    reqs = [Request(i, prompts[i], max_new=3, arrival_s=0.0)
            for i in range(3)]
    rep = eng.run(stream_of(reqs), max_wall_s=120.0)
    assert rep.n_done == 3

    spans = obs.tracer.spans()
    cats = {s.cat for s in spans}
    assert {"driver", "stage", "request", "sched"} <= cats
    driver = [s for s in spans if s.cat == "driver"]
    assert len(driver) == 1
    # every stage span nests inside the driver span's interval
    for s in spans:
        if s.cat == "stage":
            assert s.ts >= driver[0].ts - 1e-6
            assert s.end <= driver[0].end + 1e-6
    # request spans mirror the records byte-for-byte
    req_spans = {s.args["rid"]: s for s in spans if s.cat == "request"}
    assert set(req_spans) == {0, 1, 2}
    for rid, rec in rep_records(rep).items():
        s = req_spans[rid]
        assert s.dur == pytest.approx(rec.latency_s)
        assert s.args["tokens"] == len(rec.tokens)
        assert s.args["ttft_ms"] == pytest.approx(rec.ttft_s * 1e3,
                                                  abs=1e-3)
    # the scheduler's lifecycle instants
    sched = [s.name for s in spans if s.cat == "sched"]
    assert sched.count("submit") == 3
    assert sched.count("admit") == 3
    assert sched.count("evict") == 3
    # counters followed along
    snap = obs.metrics.snapshot()
    assert snap["serve_requests_submitted"] == 3
    assert snap["serve_requests_finished"] == 3
    assert snap["serve_ttft_ms.count"] == 3

    # the exported trace validates and the CLI sees the same rows
    trace = to_chrome_trace(spans, dropped=obs.tracer.dropped)
    assert validate_chrome_trace(trace) == []
    rows = request_rows(trace)
    assert [r["rid"] for r in rows] == [0, 1, 2]


def rep_records(rep):
    return {rec.rid: rec for rec in rep.records}


def test_untraced_engine_records_nothing(runner):
    eng = PipelineServeEngine(runner, n_slots=2, n_groups=1, eos=None,
                              mode="serial", capacity=32)
    eng.warmup(prompt_len=6)
    reqs = [Request(0, np.zeros(6, np.int32), max_new=2, arrival_s=0.0)]
    rep = eng.run(stream_of(reqs), max_wall_s=120.0)
    assert rep.n_done == 1
    assert eng.obs is NOOP_OBS
    assert eng.obs.tracer.spans() == []


def test_router_route_and_serve_spans(runner):
    obs = Obs.on()
    replicas = [PipelineServeEngine(runner, n_slots=2, n_groups=1, eos=None,
                                    mode="serial", capacity=32,
                                    name=f"replica{i}", obs=obs)
                for i in range(2)]
    for r in replicas:
        r.warmup(prompt_len=6)
    prompts = np.random.default_rng(2).integers(
        0, 100, size=(4, 6)).astype(np.int32)
    reqs = [Request(i, prompts[i], max_new=2, arrival_s=0.0)
            for i in range(4)]
    rep = ReplicaRouter(replicas, obs=obs).serve(reqs, realtime=False,
                                                 max_wall_s=120.0)
    assert rep.n_done == 4
    spans = obs.tracer.spans()
    routes = [s for s in spans if s.track == "router/route" and s.ph == "i"]
    assert len(routes) == 4
    assert {s.args["replica"] for s in routes} <= {"replica0", "replica1"}
    serve_span = [s for s in spans
                  if s.track == "router/route" and s.ph == "X"]
    assert len(serve_span) == 1
    assert obs.metrics.counter("router_requests_routed").value == 4


def test_async_tokens_hold_under_thread_switch_stress(runner, lm):
    """Two async replicas (two stage, one link and one driver thread
    each, beside the router's), with the interpreter switching threads
    every microsecond: every request finishes with the serial handoff's
    tokens (a lost or crossed update of a lane, a queue or a record would
    change or drop some)."""
    import sys

    cfg, _ = lm
    reqs = _burst(_traffic(cfg, n=8, max_new=4, seed=5))

    def serve(mode):
        replicas = [PipelineServeEngine(runner, n_slots=4, n_groups=2,
                                        eos=None, mode=mode, capacity=32,
                                        name=f"replica{i}")
                    for i in range(2)]
        for r in replicas:
            r.warmup(prompt_len=6)
        rep = ReplicaRouter(replicas).serve(reqs, realtime=False,
                                            max_wall_s=60.0)
        assert rep.n_done == len(reqs) and rep.n_failed == 0
        return {r.rid: r.tokens for r in rep.records}

    want = serve("serial")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = serve("async")
    finally:
        sys.setswitchinterval(old)
    assert got == want
