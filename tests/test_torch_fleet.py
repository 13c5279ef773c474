"""The port's campaign and fleet (``repro_torch.explore.campaign``,
``repro_torch.fleet``) on the CPU: the reference's fleet cases of
``tests/test_fleet.py`` (manifest state machine and atomic claims, leases,
worker loop and retries, shard merge, resume without recompute, merged ≡
serial, the declarative accuracy spec) and its campaign cases of
``tests/test_explore_api.py``, all at ``device="cpu"``; then the port
against the reference — the same NumPy sweep gives the reference's report
fingerprint — a two-worker ``run_fleet`` through real worker processes
with ``torch_nsga2``, the worker command's ``--device``, and the default
device refusing to run without a card."""

import dataclasses
import json
import os
import socket

import pytest

torch = pytest.importorskip("torch")

import repro.explore as jexplore  # noqa: E402
import repro_torch.explore as texplore  # noqa: E402
from repro.fleet import report_fingerprint as jreport_fingerprint  # noqa: E402
from repro_torch.core.accuracy import (MeasuredAccuracy,  # noqa: E402
                                       ProxyAccuracy,
                                       register_accuracy_measure)
from repro_torch.explore import (AccuracySpec, Campaign,  # noqa: E402
                                 CampaignReport, ExplorationSpec, LinkSpec,
                                 ModelRef, PlatformSpec, SearchSettings,
                                 SweepSpec, SystemSpec, eval_from_dict,
                                 run_spec)
from repro_torch.fleet import (Manifest, ManifestError,  # noqa: E402
                               ReportMergeError, merge_manifest, merge_shards,
                               report_fingerprint, run_fleet)
from repro_torch.fleet.launch import worker_command  # noqa: E402
from repro_torch.fleet.worker import run_cell, run_worker  # noqa: E402

torch.set_num_threads(2)


def _systems(m):
    two = m.SystemSpec(
        platforms=(m.PlatformSpec("A", "eyr", bits=16),
                   m.PlatformSpec("B", "smb", bits=8)),
        links=("gige",), name="AB")
    slow = m.SystemSpec(
        platforms=(m.PlatformSpec("A", "eyr", bits=16),
                   m.PlatformSpec("B", "smb", bits=8)),
        links=(m.LinkSpec(base="gige", rate_bps=1e8),), name="AB-slow")
    return two, slow


def _spec(m, two):
    return m.ExplorationSpec(
        model=m.ModelRef("cnn", "squeezenet11", {"in_hw": 64}),
        system=two,
        objectives=("latency", "energy"),
        search=m.SearchSettings(strategy="nsga2", seed=0, pop_size=32,
                                n_gen=6))


TWO_PLATFORM, SLOW_LINK = _systems(texplore)
SPEC = _spec(texplore, TWO_PLATFORM)
NAMES = ("squeezenet11", "vgg16", "regnetx_400mf")


def make_campaign(n_models=2, systems=(TWO_PLATFORM,), spec=SPEC,
                  m=texplore):
    return m.Campaign(spec,
                      models=[m.ModelRef("cnn", n, {"in_hw": 64})
                              for n in NAMES[:n_models]],
                      systems=list(systems))


# -- SweepSpec ----------------------------------------------------------------

def test_sweep_spec_roundtrip_and_hash():
    sweep = make_campaign(2).to_sweep()
    s2 = SweepSpec.from_json(sweep.to_json())
    assert s2 == sweep
    assert s2.spec_hash() == sweep.spec_hash()
    assert sweep.cells() == (("squeezenet11", "AB"), ("vgg16", "AB"))
    # a different seed is a different sweep
    other = SweepSpec(template=dataclasses.replace(
        SPEC, search=dataclasses.replace(SPEC.search, seed=7)),
        models=sweep.models, systems=sweep.systems)
    assert other.spec_hash() != sweep.spec_hash()


def test_sweep_defaults_to_template_model_system():
    sweep = SweepSpec(template=SPEC)
    assert sweep.models == (SPEC.model,)
    assert sweep.systems == (SPEC.system,)
    assert sweep.cells() == (("squeezenet11", "AB"),)


# -- manifest state machine ---------------------------------------------------

def test_manifest_create_load_and_claims(tmp_path):
    d = str(tmp_path / "m")
    m = make_campaign(2).to_manifest(d)
    assert len(m.cells) == 2
    assert all(m.cell_state(c.id) == "pending" for c in m.cells)

    cid = m.cells[0].id
    assert m.claim(cid, "w1")
    assert not m.claim(cid, "w2")          # exclusive
    assert m.cell_state(cid) == "running"
    m.release(cid)
    assert m.cell_state(cid) == "pending"

    # idempotent reopen; different sweep refuses
    m2 = make_campaign(2).to_manifest(d)
    assert m2.spec_hash == m.spec_hash
    with pytest.raises(ManifestError, match="different sweep"):
        make_campaign(1).to_manifest(d)
    assert Manifest.load(d).status()["cells"] == 2


def test_manifest_retry_budget_and_terminal_failure(tmp_path):
    m = make_campaign(1).to_manifest(str(tmp_path / "m"), max_retries=1)
    cid = m.cells[0].id
    assert m.record_failure(cid, "w", "boom 1") == 1
    assert m.cell_state(cid) == "pending"      # one retry left
    assert m.record_failure(cid, "w", "boom 2") == 2
    assert m.cell_state(cid) == "failed"       # budget spent
    assert m.pending_cells() == []
    assert m.complete()
    errs = m.failure_records(cid)
    assert len(errs) == 2 and "boom 2" in errs[-1]["error"]


def _backdate(path, by_s=60.0):
    """Age a claim file past the reclaim grace period."""
    t = os.stat(path).st_mtime - by_s
    os.utime(path, (t, t))


def _dead_claim(m, cid, pid):
    with open(m._claim_path(cid), "w") as f:
        json.dump({"worker": "dead", "pid": pid,
                   "host": socket.gethostname(), "time": 0}, f)


def test_reclaim_stale_only_dead_pids(tmp_path):
    m = make_campaign(2).to_manifest(str(tmp_path / "m"))
    a, b = m.cells[0].id, m.cells[1].id
    m.claim(a, "live")                          # our own (live) pid
    m.claim(b, "dead")
    _dead_claim(m, b, 2 ** 22 + 12345)          # rewrite b with a dead pid
    # claims inside the grace window are never touched, even with force
    assert m.reclaim_stale() == []
    assert m.reclaim_stale(force=True) == []
    _backdate(m._claim_path(a))
    _backdate(m._claim_path(b))
    assert m.reclaim_stale() == [b]
    assert m.cell_state(a) == "running"
    assert m.cell_state(b) == "pending"
    assert m.reclaim_stale(force=True) == [a]


def test_lease_ttl_reclaims_hung_worker(tmp_path):
    """A claim held by a *live* pid whose lease expired (hung worker) is
    reclaimed with ``lease_ttl_s``; a refreshed lease survives."""
    m = make_campaign(2).to_manifest(str(tmp_path / "m"))
    a, b = m.cells[0].id, m.cells[1].id
    m.claim(a, "hung")                 # our own pid: provably alive
    m.claim(b, "slow-but-live")
    _backdate(m._claim_path(a), by_s=60.0)
    _backdate(m._claim_path(b), by_s=60.0)
    # pid probing alone never touches live-pid claims, however old
    assert m.reclaim_stale() == []
    # b's worker heartbeats; a's lease stays expired
    assert m.refresh_claim(b)
    assert m.reclaim_stale(lease_ttl_s=30.0) == [a]
    assert m.cell_state(a) == "pending"
    assert m.cell_state(b) == "running"
    # the reclaimed claim is gone, so a further refresh reports it
    assert not m.refresh_claim(a)
    with pytest.raises(ValueError, match="lease_ttl_s"):
        m.reclaim_stale(lease_ttl_s=0.0)


def test_lease_heartbeat_refreshes_until_claim_released(tmp_path):
    """The worker's heartbeat thread keeps bumping the claim's mtime and
    exits on its own once the claim disappears."""
    import threading
    import time as _time

    import repro_torch.fleet.worker as W
    m = make_campaign(1).to_manifest(str(tmp_path / "m"))
    cid = m.cells[0].id
    m.claim(cid, "w")
    _backdate(m._claim_path(cid), by_s=60.0)
    before = os.stat(m._claim_path(cid)).st_mtime
    stop = threading.Event()
    th = threading.Thread(target=W._lease_heartbeat,
                          args=(m, cid, 0.3, stop), daemon=True)
    th.start()
    _time.sleep(0.4)                   # >= one heartbeat period (lease/3)
    assert os.stat(m._claim_path(cid)).st_mtime > before
    m.release(cid)                     # claim vanishes mid-heartbeat
    th.join(timeout=3.0)
    assert not th.is_alive()
    stop.set()


def test_run_worker_validates_lease(tmp_path):
    d = str(tmp_path / "m")
    make_campaign(1).to_manifest(d)
    with pytest.raises(ValueError, match="lease_s"):
        run_worker(d, lease_s=0.0, device="cpu")


# -- merge edge cases ---------------------------------------------------------

def test_merge_empty_shard_set_raises(tmp_path):
    m = make_campaign(2).to_manifest(str(tmp_path / "m"))
    with pytest.raises(ReportMergeError, match="without a shard"):
        merge_manifest(m)


def test_merge_empty_sweep_yields_empty_report():
    rep = merge_shards({"t": 1}, [], [])
    assert rep.entries == [] and rep.wall_s == 0.0


def test_merge_duplicate_cell_conflict():
    cells = [("c0", "m", "s")]
    e1 = {"model": "m", "system": "s", "wall_s": 1.0, "pareto": [1]}
    e2 = {"model": "m", "system": "s", "wall_s": 2.0, "pareto": [1]}
    e3 = {"model": "m", "system": "s", "wall_s": 1.0, "pareto": [2]}
    # identical payloads (timing-stripped) dedupe silently
    rep = merge_shards({}, cells, [("c0", e1), ("c0", e2)])
    assert len(rep.entries) == 1
    # diverging payloads are a hard conflict
    with pytest.raises(ReportMergeError, match="conflicting shards"):
        merge_shards({}, cells, [("c0", e1), ("c0", e3)])
    # shard for a cell outside the sweep is rejected
    with pytest.raises(ReportMergeError, match="unknown cell"):
        merge_shards({}, cells, [("cX", e1)])


def test_merge_failed_cell_placeholder(tmp_path):
    m = make_campaign(2).to_manifest(str(tmp_path / "m"), max_retries=0)
    good, bad = m.cells
    m.write_shard(good.id, run_cell(m, good, device="cpu"), "w")
    m.record_failure(bad.id, "w", "ValueError: kaput")
    # without allow_failed the merge refuses to pose as complete
    with pytest.raises(ReportMergeError, match="without a shard"):
        merge_manifest(m)
    rep = merge_manifest(m, allow_failed=True)
    assert len(rep.entries) == 2
    ph = rep.entries[1]
    assert ph["failed"] and "kaput" in ph["error"]
    assert ph["model"] == bad.model and ph["system"] == bad.system
    assert ph["pareto"] == [] and ph["selected"] is None
    # placeholder still JSON-serializable through CampaignReport
    assert json.loads(rep.to_json())["entries"][1]["failed"]


# -- merged == serial ---------------------------------------------------------

@pytest.fixture(scope="module")
def serial_3x2():
    """The reference's 3 models × 2 systems NumPy sweep, run serially."""
    camp = make_campaign(3, systems=(TWO_PLATFORM, SLOW_LINK))
    return camp, camp.run(device="cpu").report


def test_fleet_merge_equals_serial_3x2(serial_3x2, tmp_path):
    """3 models × 2 systems: in-process worker sweep merges to a report
    fingerprint-identical to the serial Campaign.run (same seeds)."""
    camp, serial = serial_3x2
    d = str(tmp_path / "m")
    m = camp.to_manifest(d)
    assert len(m.cells) == 6
    stats = run_worker(d, device="cpu")
    assert stats == {"done": 6, "failed": 0}
    merged = merge_manifest(d)
    assert report_fingerprint(merged) == report_fingerprint(serial)
    # order is serial (model-major), not shard-arrival
    assert [(e["model"], e["system"]) for e in merged.entries] == \
           [(e["model"], e["system"]) for e in serial.entries]


def test_resume_does_not_recompute_done_cells(tmp_path):
    """Kill-and-resume semantics: cells finished before a crash keep their
    shards byte-identical; only pending work runs again."""
    d = str(tmp_path / "m")
    camp = make_campaign(2)
    m = camp.to_manifest(d)
    first, second = m.cells
    m.write_shard(first.id, run_cell(m, first, device="cpu"), "w0")
    before = open(m._shard_path(first.id)).read()
    mtime = os.stat(m._shard_path(first.id)).st_mtime_ns
    # crashed worker left a claim on the second cell with a dead pid
    m.claim(second.id, "dead")
    _dead_claim(m, second.id, 2 ** 22 + 999)
    _backdate(m._claim_path(second.id))
    # resume: reclaim + one worker finishes only the pending cell
    assert m.reclaim_stale() == [second.id]
    stats = run_worker(d, device="cpu")
    assert stats == {"done": 1, "failed": 0}
    assert open(m._shard_path(first.id)).read() == before
    assert os.stat(m._shard_path(first.id)).st_mtime_ns == mtime
    merged = merge_manifest(d)
    assert report_fingerprint(merged) == \
           report_fingerprint(camp.run(device="cpu").report)


def test_worker_retries_transient_failure(tmp_path, monkeypatch):
    """A cell that fails once and then succeeds ends done, within budget."""
    d = str(tmp_path / "m")
    make_campaign(1).to_manifest(d, max_retries=2)
    import repro_torch.fleet.worker as W
    real = W.run_cell
    calls = {"n": 0}

    def flaky(manifest, cell, caches=None, device="cuda"):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("transient")
        return real(manifest, cell, caches, device=device)

    monkeypatch.setattr(W, "run_cell", flaky)
    stats = W.run_worker(d, device="cpu")
    assert stats == {"done": 1, "failed": 1}
    m = Manifest.load(d)
    assert m.cell_state(m.cells[0].id) == "done"
    assert m.attempts(m.cells[0].id) == 1


# -- declarative accuracy -----------------------------------------------------

def test_accuracy_spec_proxy_knobs_roundtrip():
    spec = dataclasses.replace(
        SPEC, objectives=("latency", "accuracy"),
        accuracy=AccuracySpec(kind="proxy", base_accuracy=0.9,
                              noise_scale=2.0))
    s2 = ExplorationSpec.from_json(spec.to_json())
    assert s2 == spec
    res = run_spec(spec, device="cpu")
    assert res.selected is not None
    # knobs actually reach the oracle: accuracy capped by base_accuracy
    assert all(e.accuracy <= 0.9 + 1e-9 for e in res.pareto)


def test_accuracy_spec_validation():
    with pytest.raises(ValueError, match="kind"):
        AccuracySpec(kind="magic")
    with pytest.raises(ValueError, match="measure"):
        AccuracySpec(kind="measured")
    # a measure name with the default/typo'd proxy kind would silently run
    # the wrong oracle — rejected instead
    with pytest.raises(ValueError, match="mean kind='measured'"):
        AccuracySpec(kind="proxy", measure="cnn_fakequant")
    with pytest.raises(ValueError, match="unknown accuracy measure"):
        AccuracySpec(kind="measured", measure="no-such").build(
            None, [], None)


def test_measured_accuracy_declarative_path():
    """A registered measured oracle drives the NumPy strategies through the
    spec; per-cut caching comes from MeasuredAccuracy."""
    calls, devices = [], []

    def factory(graph=None, schedule=None, system=None, device=None, *,
                bonus=0.0):
        assert schedule is not None and system is not None
        devices.append(device)

        def measure(cuts):
            calls.append(tuple(cuts))
            return 0.5 + bonus

        return measure

    register_accuracy_measure("test_const", factory, override=True)
    spec = dataclasses.replace(
        SPEC, objectives=("latency", "accuracy"),
        search=SearchSettings(strategy="exhaustive"),
        accuracy=AccuracySpec(kind="measured", measure="test_const",
                              options={"bonus": 0.25}))
    res = run_spec(spec, device="cpu")
    assert calls, "measured oracle was never invoked"
    assert devices == ["cpu"], "the oracle works on the search's device"
    assert all(abs(e.accuracy - 0.75) < 1e-9 for e in res.pareto)
    # built oracle is the caching wrapper
    built = spec.accuracy.build(None, [], TWO_PLATFORM.build())
    assert isinstance(built, MeasuredAccuracy)


def test_measured_table_oracle_builtin():
    acc = AccuracySpec(kind="measured", measure="table",
                       options={"table": {"3": 0.91, "-1": 0.4},
                                "default": 0.1})
    fn = acc.build(None, [], TWO_PLATFORM.build())
    assert fn((3,)) == 0.91 and fn((-1,)) == 0.4 and fn((7,)) == 0.1


def test_torch_path_falls_back_on_measured_accuracy():
    """torch_nsga2 + measured oracle + accuracy objective: documented
    fallback to the NumPy strategy, not a crash or silent drop."""
    register_accuracy_measure(
        "test_half", lambda graph=None, schedule=None, system=None,
        device=None: (lambda cuts: 0.5), override=True)
    spec = dataclasses.replace(
        SPEC, objectives=("latency", "accuracy"),
        search=SearchSettings(strategy="torch_nsga2", seed=0, pop_size=16,
                              n_gen=2),
        accuracy=AccuracySpec(kind="measured", measure="test_half"))
    with pytest.warns(UserWarning, match="falling back"):
        res = run_spec(spec, device="cpu")
    assert res.selected is not None
    assert res.strategy_used == "nsga2"
    assert all(abs(e.accuracy - 0.5) < 1e-9 for e in res.pareto)


def test_default_accuracy_unchanged():
    """No accuracy field -> the default ProxyAccuracy oracle (seed parity
    with pre-AccuracySpec reports)."""
    res_default = run_spec(SPEC, device="cpu")
    res_explicit = run_spec(dataclasses.replace(
        SPEC, accuracy=AccuracySpec(kind="proxy")), device="cpu")
    assert [e.cuts for e in res_default.pareto] == \
           [e.cuts for e in res_explicit.pareto]
    assert isinstance(ProxyAccuracy([], TWO_PLATFORM.build()), ProxyAccuracy)


# -- campaign (the reference's explore-API cases) -----------------------------

SQUEEZE = ModelRef("cnn", "squeezenet11", {"in_hw": 64})


@pytest.fixture(scope="module")
def campaign_result():
    spec = ExplorationSpec(
        model=SQUEEZE, system=TWO_PLATFORM,
        objectives=("latency", "energy", "throughput"))
    models = [ModelRef("cnn", n, {"in_hw": 64})
              for n in ("squeezenet11", "vgg16", "resnet50")]
    return Campaign(spec, models=models).run(device="cpu")


def test_campaign_scores_three_models(campaign_result):
    cr = campaign_result
    assert len(cr.entries) == 3
    for e in cr.entries:
        assert len(e.result.pareto) >= 1
        assert e.result.selected is not None
        assert e.result.selected.violation <= 0
    assert {e.model for e in cr.entries} == \
           {"squeezenet11", "vgg16", "resnet50"}
    # entries retrievable by model label
    assert cr.get("vgg16").selected is not None


def test_campaign_report_json_roundtrip(campaign_result):
    rep = campaign_result.report
    rep2 = CampaignReport.from_json(rep.to_json())
    assert rep2.to_dict() == rep.to_dict()
    assert len(rep2.entries) == 3
    for e in rep2.entries:
        assert e["selected"] is not None
        assert eval_from_dict(e["selected"]).cuts == \
               tuple(e["selected"]["cuts"])
    # the template itself round-trips back into a runnable spec
    assert ExplorationSpec.from_dict(rep2.template) is not None
    assert rep.summary()


def test_campaign_shares_cost_tables(monkeypatch):
    """Two systems over the same archs must profile each arch once per
    model, not once per (model, system)."""
    import repro_torch.core.partition as P
    calls = []
    real = P.layer_cost_table

    def counting(schedule, arch, batch):
        calls.append(arch.name)
        return real(schedule, arch, batch)

    monkeypatch.setattr(P, "layer_cost_table", counting)
    spec = ExplorationSpec(model=SQUEEZE, system=TWO_PLATFORM,
                           objectives=("latency", "energy"))
    sys_b = SystemSpec(
        platforms=(PlatformSpec("A2", "eyr", bits=16),
                   PlatformSpec("B2", "smb", bits=8)),
        links=(LinkSpec(base="gige", rate_bps=1e8),), name="slow")
    Campaign(spec, systems=[TWO_PLATFORM, sys_b]).run(device="cpu")
    # one EYR + one SMB profile total, despite two systems
    assert sorted(calls) == ["EYR", "SMB"]


# -- the port against the reference -------------------------------------------

def test_campaign_report_equals_the_references(serial_3x2):
    """The NumPy strategy draws the same random numbers in both packages,
    so the port's report of the reference's 3 × 2 sweep has exactly the
    reference's fingerprint, and its JSON the reference's keys."""
    _, port = serial_3x2
    jtwo, jslow = _systems(jexplore)
    ref = make_campaign(3, systems=(jtwo, jslow), spec=_spec(jexplore, jtwo),
                        m=jexplore).run().report
    assert report_fingerprint(port) == jreport_fingerprint(ref)
    assert jreport_fingerprint(json.loads(port.to_json())) == \
        report_fingerprint(json.loads(ref.to_json()))
    assert list(json.loads(port.to_json())) == list(json.loads(ref.to_json()))


def test_run_fleet_with_two_worker_processes(tmp_path, monkeypatch):
    """Two workers, each its own process running ``python -m
    repro_torch.fleet worker --device cpu``, search two reduced cells with
    ``torch_nsga2``; the merge equals the serial run; a second
    ``run_fleet`` on the complete manifest starts no worker and rewrites
    no shard."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    spec = dataclasses.replace(
        SPEC, objectives=("latency", "energy", "throughput"),
        search=SearchSettings(strategy="torch_nsga2", seed=0, pop_size=32,
                              n_gen=3))
    camp = make_campaign(2, spec=spec)
    serial = camp.run(device="cpu").report
    assert {e["strategy_used"] for e in serial.entries} == {"torch_nsga2"}
    d = str(tmp_path / "m")
    m = camp.to_manifest(d)
    merged = run_fleet(d, workers=2, device="cpu")
    assert report_fingerprint(merged) == report_fingerprint(serial)
    shards = {c.id: os.stat(m._shard_path(c.id)).st_mtime_ns
              for c in m.cells}
    import repro_torch.fleet.launch as launch
    monkeypatch.setattr(launch, "start_workers", None)   # must not be called
    again = run_fleet(d, workers=2, device="cpu")
    assert report_fingerprint(again) == report_fingerprint(serial)
    assert {c.id: os.stat(m._shard_path(c.id)).st_mtime_ns
            for c in m.cells} == shards


def test_worker_command_carries_the_device(tmp_path):
    cmd = worker_command(str(tmp_path), worker_id="w0", device="cpu")
    assert cmd[1:4] == ["-m", "repro_torch.fleet", "worker"]
    assert cmd[cmd.index("--device") + 1] == "cpu"
    assert cmd[cmd.index("--worker-id") + 1] == "w0"
    default = worker_command(str(tmp_path))
    assert default[default.index("--device") + 1] == "cuda"
    from repro_torch.fleet.launch import host_commands
    assert "python -m repro_torch.fleet" in host_commands(str(tmp_path),
                                                         ["h1"])


def test_default_device_raises_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = str(tmp_path / "m")
    camp = make_campaign(1)
    camp.to_manifest(d)
    for run in (camp.run, lambda: run_worker(d), lambda: run_fleet(d)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run()
    from repro_torch.fleet.__main__ import main as fleet_cli
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fleet_cli(["worker", "--manifest", d])
    from repro_torch.launch.drift import main as drift_main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        drift_main(["--pop", "16", "--gens", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        drift_main(["--serve", "--pop", "16", "--gens", "1"])
    assert not os.listdir(os.path.join(d, "shards"))


def test_drift_driver_serves_and_fires_the_measured_trigger(tmp_path,
                                                            capsys):
    """``--serve`` serves every request of the baseline burst on the CPU;
    ``--measured`` fires the warm re-partition from the measured link
    divergence and writes a timeline whose decision says so."""
    import json

    from repro_torch.launch.drift import main as drift_main
    common = ["--device", "cpu", "--pop", "16", "--gens", "1"]
    assert drift_main(common + ["--serve", "--requests", "4"]) == 0
    out = capsys.readouterr().out
    assert "serve[baseline]: 2 stages, 4/4 done" in out
    path = tmp_path / "timeline.json"
    assert drift_main(common + ["--measured", "--timeline", str(path)]) == 0
    timeline = json.loads(path.read_text())
    assert timeline["decision"]["trigger"] == "measured"
    assert timeline["signals"] and timeline["divergence_series"]
    assert timeline["served"] == {"n_done": 8, "n_requests": 8}
