"""The port's serve runtime (``repro_torch.serve``) and what only it
consumes — lane caches, ``SlotDecoder``, ``PartitionedLMRunner.
stage_step_fn`` — on the CPU, against the JAX package on the same weights
(the reference's pytree carried over by ``repro_torch.models.convert``)
and the same numpy inputs.

The model is smollm-360m reduced (2 blocks, d 256, 4 heads over 2 KV
heads, window 64), partitioned ``cuts=[0]``.  The reference's serve tests
(``tests/test_serve_pipeline.py``, ``tests/test_serve_scheduler.py``) run
here on the port; then lane cache updates are held against ``jax.vmap`` of
the reference's (exact), ``SlotDecoder`` and ``stage_step_fn`` against the
reference's within ``ATOL`` (float32 logits of magnitude ~1.5, summed in
other orders by XLA and by torch: ``tests/test_torch_lm.py``'s 2e-5), and
the served greedy tokens against the reference's engine and both
packages' ``GenerationEngine`` (exact), also with quantized stages and a
quantizing link."""

import dataclasses
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import registry as jreg  # noqa: E402
from repro.nn import attention as ja  # noqa: E402
from repro.serve import PipelineServeEngine as JPipelineServeEngine  # noqa: E402
from repro.serve import stream_of as jstream_of  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro.serving import pipeline as jpipeline  # noqa: E402
from repro_torch.core.link import LinkModel  # noqa: E402
from repro_torch.explore import lm_block_cuts  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.convert import load_reference_params  # noqa: E402
from repro_torch.models.decoder import DecoderLM  # noqa: E402
from repro_torch.nn import attention as ta  # noqa: E402
from repro_torch.serve import (PipelineServeEngine, ReplicaRouter,  # noqa: E402
                               Request, RequestStream, ServeLink,
                               poisson_traffic, stream_of)
from repro_torch.serve.request import Request as SRequest  # noqa: E402
from repro_torch.serve.scheduler import SlotScheduler  # noqa: E402
from repro_torch.serving import GenerationEngine  # noqa: E402
from repro_torch.serving.engine import SlotDecoder, _bump_pos, write_lane  # noqa: E402
from repro_torch.serving.pipeline import (PartitionedLMRunner,  # noqa: E402
                                          def4_throughput)

torch.set_num_threads(2)

ATOL = 2e-5


def flat_params(tree):
    """The reference's parameter pytree as numpy arrays, ``/``-joined keys."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in leaves}


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=atol,
                               atol=atol)


def build_pair(window="reduced"):
    """(reference model, its params, port model on the same weights)."""
    jcfg = jreg.get_config("smollm-360m").reduced()
    cfg = registry.get_config("smollm-360m").reduced()
    if window != "reduced":
        jcfg = dataclasses.replace(jcfg, window=window)
        cfg = dataclasses.replace(cfg, window=window)
    jm = jreg.build_model(jcfg)
    params, _ = jm.init(jax.random.PRNGKey(0))
    tm = DecoderLM(cfg, device="cpu")
    load_reference_params(tm, flat_params(params))
    return jm, params, tm


@pytest.fixture(scope="module")
def pair():
    return build_pair()


@pytest.fixture(scope="module")
def lm(pair):
    _, _, tm = pair
    return tm.cfg, tm


@pytest.fixture(scope="module")
def runner(lm):
    _, model = lm
    return PartitionedLMRunner(model, cuts=[0])


def _burst(reqs):
    return [Request(r.rid, r.prompt, r.max_new, 0.0) for r in reqs]


# -- the reference's serve-pipeline cases, on the port --------------------------

def test_def4_throughput_helper():
    assert def4_throughput([2.0]) == pytest.approx(0.5)
    assert def4_throughput([0.5, 0.2], [0.1]) == pytest.approx(2.0)
    assert def4_throughput([]) == 0.0
    assert def4_throughput([0.0, 0.0]) == 0.0      # zeros are "not measured"


def test_lm_block_cuts_mapping():
    # schedule: Embed(0), Attn_0(1), FFN_0(2), Attn_1(3), FFN_1(4), ...
    assert lm_block_cuts([2], n_layers=4) == [0]   # cut after FFN_0
    assert lm_block_cuts([3], n_layers=4) == [1]   # mid-block snaps down
    assert lm_block_cuts([-1], n_layers=4) == [1]  # no cut -> middle
    assert lm_block_cuts([99], n_layers=4) == [2]  # clamped: last stage
    assert lm_block_cuts([2, 4], n_layers=4) == [0, 1]


@pytest.mark.parametrize("lanes", [False, True])
def test_stage_stepwise_matches_decode_step(runner, lm, lanes):
    """Driving the stages one step at a time reproduces the monolithic
    decode_step bit-for-bit (prefill + decode), with one write position
    for the batch and with one per lane."""
    cfg, model = lm
    b, tp = 2, 6
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, size=(b, tp))
    caches = model.init_caches(b, 32, torch.float32, lanes=lanes)
    ref, caches = model.decode_step(caches,
                                    {"tokens": torch.from_numpy(prompts)})
    nxt = ref[:, -1].argmax(-1)
    ref2, caches = model.decode_step(caches, {"tokens": nxt[:, None]})

    sc = [runner.init_stage_caches(si, b, 32, lanes=lanes)
          for si in range(runner.n_stages)]
    fns = [runner.stage_step_fn(si) for si in range(runner.n_stages)]
    ws = [runner.stage_weights(si) for si in range(runner.n_stages)]
    x = torch.from_numpy(prompts)
    for si in range(runner.n_stages):
        x, sc[si] = fns[si](ws[si], sc[si], x)
    assert torch.equal(x, ref)
    x = nxt[:, None]
    for si in range(runner.n_stages):
        x, sc[si] = fns[si](ws[si], sc[si], x)
    assert torch.equal(x, ref2)
    assert sc[0]["pos"].shape == ((1, b) if lanes else (1,))


def test_stage_step_fn_rejects_empty_stage(lm):
    cfg, model = lm
    r = PartitionedLMRunner(model, cuts=[cfg.n_layers - 1])
    with pytest.raises(ValueError, match="owns no blocks"):
        r.stage_step_fn(r.n_stages - 1)


def test_slot_decoder_no_cross_request_bleed(lm):
    """Admitting a request into slot 1 mid-flight must not change what
    slot 0 decodes — per-slot cache lanes are fully independent."""
    cfg, model = lm
    rng = np.random.default_rng(1)
    pa = rng.integers(0, cfg.vocab, size=6).astype(np.int32)
    pb = rng.integers(0, cfg.vocab, size=6).astype(np.int32)

    def roll(interleave):
        sd = SlotDecoder(model, n_slots=2, max_seq=32)
        tok = int(np.argmax(sd.prefill(0, pa)))
        seq = [tok]
        for step in range(5):
            if interleave and step == 2:
                sd.prefill(1, pb)          # admission into the other slot
            logits = sd.decode(np.array([seq[-1], 0], np.int32))
            seq.append(int(np.argmax(logits[0])))
        return seq

    assert roll(interleave=False) == roll(interleave=True)


def test_async_serial_and_engine_tokens_identical(runner, lm):
    """The tentpole invariant: continuous-batching async pipeline, the
    lockstep serial baseline, and the monolithic GenerationEngine all
    produce byte-identical greedy tokens."""
    cfg, model = lm
    reqs = poisson_traffic(6, rate_rps=1000.0, vocab=cfg.vocab,
                           prompt_len=6, max_new=6, seed=2)
    # EOS chosen from a real greedy continuation so eviction paths run
    eng = GenerationEngine(model, max_seq=32, cache_dtype=torch.float32)
    prompts = np.stack([r.prompt for r in reqs])
    probe = eng.generate(prompts, max_new=6)
    eos = int(probe.tokens[0, 2])

    outs = {}
    for mode in ("serial", "async"):
        e = PipelineServeEngine(runner, n_slots=4, eos=eos, mode=mode,
                                capacity=32)
        e.warmup(prompt_len=6)
        rep = e.run(stream_of(_burst(reqs)), max_wall_s=120.0)
        assert rep.n_done == len(reqs)                   # nothing dropped
        assert rep.extra["decode_steps"] > 0
        outs[mode] = {r.rid: r.tokens for r in rep.records}
    assert outs["serial"] == outs["async"]

    ref = eng.generate(prompts, max_new=6, eos=eos)
    for i, r in enumerate(reqs):
        row = list(ref.tokens[i])
        if eos in row:
            row = row[:row.index(eos) + 1]
        assert outs["async"][r.rid] == row, f"rid {r.rid} diverged"


def test_streaming_arrival_tokens_identical(runner, lm):
    """Requests arriving while a decode wave is already in flight
    (router-style streaming pushes, not a pre-closed burst) must not pick
    up a spurious first token from the stale wave's logits: every
    request's token stream still equals the monolithic greedy reference."""
    cfg, model = lm
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, cfg.vocab, size=(4, 6)).astype(np.int32)
    eng = GenerationEngine(model, max_seq=32, cache_dtype=torch.float32)
    ref = eng.generate(prompts, max_new=6)

    # the slow link keeps each decode wave "on the wire" ~50 ms, so the
    # pushes below almost surely land while a wave is in flight
    slow = LinkModel(name="slow", rate_bps=1e9, t_setup_s=0.05)
    for mode in ("serial", "async"):
        # 2 lanes, 1 wave: request 0 decodes with a free lane in its wave,
        # so later arrivals land mid-flight in that wave's free lane
        e = PipelineServeEngine(runner, n_slots=2, n_groups=1, eos=None,
                                mode=mode, capacity=32,
                                links=[ServeLink(model=slow)])
        e.warmup(prompt_len=6)
        stream = RequestStream()
        stream.push(Request(0, prompts[0], 6, 0.0))
        out = {}
        t = threading.Thread(
            target=lambda: out.update(rep=e.run(stream, max_wall_s=120.0)))
        t.start()
        for rid in range(1, 4):
            time.sleep(0.06)               # land mid-wave, unaligned
            stream.push(Request(rid, prompts[rid], 6, 0.0))
        stream.close()
        t.join(timeout=120.0)
        assert not t.is_alive()
        rep = out["rep"]
        assert rep.n_done == 4
        toks = {r.rid: r.tokens for r in rep.records}
        for rid in range(4):
            assert toks[rid] == list(ref.tokens[rid]), (mode, rid)


def test_n_slots_must_divide_into_groups(runner):
    with pytest.raises(ValueError, match="multiple of"):
        PipelineServeEngine(runner, n_slots=8, n_groups=3)
    with pytest.raises(ValueError, match="multiple of"):
        PipelineServeEngine(runner, n_slots=2, n_groups=4)


def test_router_surfaces_replica_failure(runner):
    """A dying replica's root-cause error must come back from serve() —
    not a masking ValueError from pushing to its closed stream."""
    class Boom(PipelineServeEngine):
        def run(self, stream, max_wall_s=120.0):
            raise RuntimeError("replica exploded")

    reqs = [Request(i, np.zeros(4, np.int32), 2, float(i) * 0.01)
            for i in range(6)]
    bad = Boom(runner, n_slots=2, n_groups=1, mode="serial", capacity=32)
    with pytest.raises(RuntimeError, match="replica failed") as ei:
        ReplicaRouter([bad]).serve(reqs, realtime=True, max_wall_s=5.0)
    assert "replica exploded" in str(ei.value.__cause__)


def test_router_least_outstanding(runner, lm):
    cfg, _ = lm
    reqs = poisson_traffic(6, rate_rps=1000.0, vocab=cfg.vocab,
                           prompt_len=6, max_new=4, seed=4)
    replicas = [PipelineServeEngine(runner, n_slots=2, n_groups=1, eos=None,
                                    mode="serial", capacity=32,
                                    name=f"replica{i}") for i in range(2)]
    for r in replicas:
        r.warmup(prompt_len=6)
    rep = ReplicaRouter(replicas).serve(_burst(reqs), realtime=False,
                                        max_wall_s=120.0)
    assert rep.n_done == len(reqs)
    assert sorted(r.rid for r in rep.records) == [r.rid for r in reqs]
    routed = rep.extra["routed_per_replica"]
    assert sum(routed) == len(reqs)
    assert max(routed) - min(routed) <= 2      # least-outstanding balances
    for r in rep.records:
        assert r.replica in ("replica0", "replica1")
        assert len(r.tokens) == 4


# -- the reference's scheduler cases, on the port --------------------------------

def _req(rid, max_new=4, plen=3):
    return SRequest(rid=rid, prompt=np.arange(1, plen + 1), max_new=max_new)


def test_admit_fifo_and_backfill():
    s = SlotScheduler(2)
    for rid in range(4):
        s.submit(_req(rid))
    placed = s.admit()
    assert [(i, r.rid) for i, r in placed] == [(0, 0), (1, 1)]
    assert s.n_waiting == 2 and not s.free_slots()
    # evict slot 0 via length (max_new=1 path: record up to the budget)
    for _ in range(4):
        rec = s.record_token(0, 9)
    assert rec is not None and rec.finish == "length"
    # freed slot backfills with the *oldest* waiting request
    placed = s.admit()
    assert [(i, r.rid) for i, r in placed] == [(0, 2)]
    assert s.n_waiting == 1


def test_eos_evicts_and_finish_reason():
    s = SlotScheduler(1, eos=7)
    s.submit(_req(0, max_new=10))
    s.admit()
    assert s.record_token(0, 3) is None
    rec = s.record_token(0, 7)
    assert rec is not None and rec.finish == "eos"
    assert rec.tokens == [3, 7]
    assert s.free_slots() == [0]


def test_duplicate_rid_and_free_slot_errors():
    s = SlotScheduler(1)
    s.submit(_req(0))
    with pytest.raises(ValueError):
        s.submit(_req(0))
    with pytest.raises(ValueError):
        s.record_token(0, 1)          # nothing admitted yet


def test_ttft_and_latency_accounting():
    s = SlotScheduler(1, eos=5)
    s.submit(_req(0, max_new=3), now=1.0)
    s.admit()
    s.record_token(0, 2, now=1.5)
    rec = s.record_token(0, 5, now=2.0)
    assert rec.ttft_s == pytest.approx(0.5)
    assert rec.latency_s == pytest.approx(1.0)


def test_randomized_invariants_no_leak_no_bleed():
    """Randomized arrival/EOS patterns: invariants hold after every
    operation, every token lands in its own request's record, and the
    run drains completely (no slot leak)."""
    rng = np.random.default_rng(0)
    for trial in range(20):
        n_slots = int(rng.integers(1, 5))
        eos = 0
        s = SlotScheduler(n_slots, eos=eos)
        reqs = [_req(rid, max_new=int(rng.integers(1, 6)))
                for rid in range(int(rng.integers(1, 12)))]
        pending = list(reqs)
        expected = {}                   # rid -> tokens we fed that request
        t = 0.0
        while True:
            # random arrivals
            while pending and rng.random() < 0.5:
                s.submit(pending.pop(0), now=t)
                s.check_invariants()
            s.admit()
            s.check_invariants()
            if s.idle and not pending:
                break
            # one decode step over the active slots: random tokens with a
            # random chance of EOS; tokens are tagged per-rid so any
            # cross-request bleed shows up as a wrong record
            for slot in s.active_slots():
                rid = s.slot_request(slot).rid
                tok = eos if rng.random() < 0.2 else 100 + rid
                expected.setdefault(rid, []).append(tok)
                s.record_token(slot, tok, now=t)
                s.check_invariants()
            t += 1.0
        assert not s.active_slots() and s.n_waiting == 0     # no slot leak
        assert set(s.records) == {r.rid for r in reqs}
        for r in reqs:
            rec = s.records[r.rid]
            assert rec.done and rec.finish in ("eos", "length")
            assert rec.tokens == expected[r.rid]             # no bleed
            assert len(rec.tokens) <= r.max_new
            if rec.finish == "eos":
                assert rec.tokens[-1] == eos
                assert eos not in rec.tokens[:-1]


def test_poisson_traffic_shape():
    reqs = poisson_traffic(10, rate_rps=100.0, vocab=64, prompt_len=8,
                           max_new=4, seed=1)
    assert len(reqs) == 10
    assert reqs[0].arrival_s == 0.0
    arr = [r.arrival_s for r in reqs]
    assert arr == sorted(arr)
    for r in reqs:
        assert r.prompt.shape == (8,) and r.prompt.dtype == np.int32
        assert (r.prompt >= 0).all() and (r.prompt < 64).all()
    # same seed reproduces, different seed differs
    again = poisson_traffic(10, rate_rps=100.0, vocab=64, prompt_len=8,
                            max_new=4, seed=1)
    assert all((a.prompt == b.prompt).all() and a.arrival_s == b.arrival_s
               for a, b in zip(reqs, again))
    other = poisson_traffic(10, rate_rps=100.0, vocab=64, prompt_len=8,
                            max_new=4, seed=2)
    assert any(a.arrival_s != b.arrival_s for a, b in zip(reqs, other))


def test_poisson_traffic_equals_reference():
    from repro.serve import poisson_traffic as jpoisson
    for seed in (0, 123):
        got = poisson_traffic(9, rate_rps=200.0, vocab=49152, prompt_len=12,
                              max_new=5, seed=seed)
        want = jpoisson(9, rate_rps=200.0, vocab=49152, prompt_len=12,
                        max_new=5, seed=seed)
        assert [(r.rid, r.arrival_s, r.max_new) for r in got] == [
            (r.rid, r.arrival_s, r.max_new) for r in want]
        assert all((a.prompt == b.prompt).all() for a, b in zip(got, want))


# -- lane caches against jax.vmap of the reference's -----------------------------

@pytest.mark.parametrize("ring", [True, False])
def test_lane_cache_update_matches_vmapped_reference(ring):
    """Lanes at different positions (one past ``cap - T``, where the
    non-ring write clamps): exact against the reference's update and
    positions ``vmap``ped over batch-1 lanes."""
    rng = np.random.default_rng(4)
    cap, n_kv, hd = 16, 2, 8
    start = np.array([0, 5, 13, 19], np.int32)        # lane 3: past cap - T
    lanes = start.size
    tc = ta.init_cache(lanes, n_kv, cap, hd, dtype=torch.float32, lanes=True)
    tc["pos"] = torch.from_numpy(start.copy())
    one = ja.init_cache(1, n_kv, cap, hd, dtype=jnp.float32)
    jc = jax.tree_util.tree_map(lambda x: jnp.stack([x] * lanes), one)
    jc["pos"] = jnp.asarray(start)
    update = jax.jit(jax.vmap(
        lambda c, k, v: ja.cache_update(c, k, v, ring=ring)))
    positions = jax.jit(jax.vmap(lambda c: ja.cache_positions(c, ring)))
    for t_new in (3, 1, 7, 1, 16, 2):
        k, v = (rng.standard_normal((lanes, t_new, n_kv, hd)).astype(
            np.float32) for _ in range(2))
        tc = ta.cache_update(tc, torch.from_numpy(k), torch.from_numpy(v),
                             ring=ring)
        jc = update(jc, jnp.asarray(k)[:, None], jnp.asarray(v)[:, None])
        for name in ("k", "v"):
            assert (tc[name].numpy() == np.asarray(jc[name])[:, 0]).all()
        assert (tc["pos"].numpy() == np.asarray(jc["pos"])).all()
        assert (ta.cache_positions(tc, ring).numpy()
                == np.asarray(positions(jc))).all()
    if not ring:
        with pytest.raises(ValueError, match="capacity"):
            ta.cache_update(tc, torch.zeros(lanes, cap + 1, n_kv, hd),
                            torch.zeros(lanes, cap + 1, n_kv, hd), ring=False)


def test_bump_pos_moves_every_lane():
    c = ta.init_cache(3, 2, 8, 4, dtype=torch.float32, lanes=True)
    assert _bump_pos(c)["pos"].tolist() == [1, 1, 1]
    stack = {"k": torch.zeros(2, 3, 8, 2, 4), "v": torch.zeros(2, 3, 8, 2, 4),
             "pos": torch.zeros(2, 3, dtype=torch.int32)}
    one = {"k": torch.ones(2, 1, 8, 2, 4), "v": torch.full((2, 1, 8, 2, 4),
                                                           2.0),
           "pos": torch.tensor([5, 5], dtype=torch.int32)}
    write_lane(stack, 1, one)
    assert stack["pos"].tolist() == [[0, 5, 0], [0, 5, 0]]
    assert stack["k"][:, 1].eq(1).all() and stack["k"][:, [0, 2]].eq(0).all()
    assert stack["v"][:, 1].eq(2).all()


# -- SlotDecoder and stage_step_fn against the reference's -------------------------

@pytest.mark.parametrize("window", ["reduced", None])
def test_slot_decoder_matches_reference(window):
    """Prefill and decode logits against the reference's vmapped
    ``SlotDecoder``, lanes admitted at different times with prompts of
    different lengths; ring cache (window 64) and clamped (no window,
    positions past the capacity)."""
    jm, params, tm = build_pair(window)
    rng = np.random.default_rng(11)
    n_slots, cap = 3, 16
    jsd = jengine.SlotDecoder(jm, params, n_slots=n_slots, max_seq=cap,
                              cache_dtype=jnp.float32)
    tsd = SlotDecoder(tm, n_slots=n_slots, max_seq=cap)
    toks = np.zeros(n_slots, np.int32)
    for step, (slot, plen) in enumerate([(0, 6), (2, 3), (1, 9), (0, 4)]):
        prompt = rng.integers(0, 512, plen).astype(np.int32)
        want, got = jsd.prefill(slot, prompt), tsd.prefill(slot, prompt)
        close(got, want)
        toks[slot] = int(np.argmax(got))
        for _ in range(4 + step):       # lane 0 reaches 13 + ... > cap
            want, got = jsd.decode(toks), tsd.decode(toks)
            assert got.shape == (n_slots, 512)
            close(got, want)
            toks = got.argmax(-1).astype(np.int32)
    pos = np.asarray(jsd.caches["dense"]["pos"])       # (slots, layers)
    assert (tsd.caches["dense"]["pos"].numpy() == pos.T).all()
    tsd.free(1)
    jsd.free(1)
    assert (tsd.caches["dense"]["pos"].numpy()
            == np.asarray(jsd.caches["dense"]["pos"]).T).all()


def test_stage_step_fn_matches_reference(pair):
    """Each stage's step against the reference's: a prefill per lane on a
    fresh batch-1 cache spliced into the wave, then wave decode steps,
    the reference ``vmap``ped over the lanes."""
    jm, params, tm = pair
    cuts, lanes, cap = [0], 3, 32
    jr = jpipeline.PartitionedLMRunner(jm, params, cuts=cuts)
    tr = PartitionedLMRunner(tm, cuts=cuts)
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in (5, 8, 2)]
    for si in range(tr.n_stages):
        assert jr.ranges[si] == tr.ranges[si]
    jfn = [jax.jit(jr.stage_step_fn(si)) for si in range(jr.n_stages)]
    jw = [jr.stage_weights(si) for si in range(jr.n_stages)]
    jvm = [jax.jit(jax.vmap(jr.stage_step_fn(si), in_axes=(None, 0, 0)))
           for si in range(jr.n_stages)]
    tfn = [tr.stage_step_fn(si) for si in range(tr.n_stages)]
    tw = [tr.stage_weights(si) for si in range(tr.n_stages)]
    jlanes = [jax.tree_util.tree_map(
        lambda x: jnp.stack([x] * lanes),
        jengine._bump_pos(jr.init_stage_caches(si, 1, cap)))
        for si in range(jr.n_stages)]
    tlanes = [_bump_pos(tr.init_stage_caches(si, lanes, cap, lanes=True))
              for si in range(tr.n_stages)]
    nxt = np.zeros(lanes, np.int32)
    for lane, p in enumerate(prompts):
        jx, tx = jnp.asarray(p)[None], torch.from_numpy(p.astype(np.int64))[None]
        for si in range(tr.n_stages):
            jx, jnew = jfn[si](jw[si], jr.init_stage_caches(si, 1, cap), jx)
            jlanes[si] = jax.tree_util.tree_map(
                lambda f, o: f.at[lane].set(o), jlanes[si], jnew)
            tx, tnew = tfn[si](tw[si], tr.init_stage_caches(si, 1, cap), tx)
            write_lane(tlanes[si], lane, tnew)
            close(tx, jx)
        nxt[lane] = int(np.asarray(tx[0, -1]).argmax())
    for _ in range(3):
        jx = jnp.asarray(nxt)[:, None, None]
        tx = torch.from_numpy(nxt.astype(np.int64))[:, None]
        for si in range(tr.n_stages):
            jx, jlanes[si] = jvm[si](jw[si], jlanes[si], jx)
            tx, tlanes[si] = tfn[si](tw[si], tlanes[si], tx)
            close(tx, np.asarray(jx)[:, 0])
            assert (tlanes[si]["pos"].numpy()
                    == np.asarray(jlanes[si]["pos"]).T).all()
            close(tlanes[si]["k"], np.asarray(jlanes[si]["k"])[:, :, 0]
                  .transpose(1, 0, 2, 3, 4))
        nxt = tx[:, -1].argmax(-1).numpy().astype(np.int32)


# -- the served tokens against the reference's ------------------------------------

def test_served_tokens_equal_reference_and_both_engines(pair, runner):
    """Greedy tokens of the port's engine (serial and async) equal the
    reference engine's on the same Poisson burst, and both packages'
    ``GenerationEngine``'s."""
    jm, params, tm = pair
    reqs = poisson_traffic(6, rate_rps=1000.0, vocab=512, prompt_len=6,
                           max_new=6, seed=3)
    prompts = np.stack([r.prompt for r in reqs])
    jr = jpipeline.PartitionedLMRunner(jm, params, cuts=[0])
    jeng = JPipelineServeEngine(jr, n_slots=4, eos=None, mode="serial",
                                capacity=32)
    jeng.warmup(prompt_len=6)
    want = {r.rid: r.tokens for r in jeng.run(jstream_of(_burst(reqs)))
            .records}
    jgen = jengine.GenerationEngine(jm, params, max_seq=32,
                                    cache_dtype=jnp.float32).generate(
        prompts, max_new=6)
    tgen = GenerationEngine(tm, max_seq=32).generate(prompts, max_new=6)
    assert (tgen.tokens == jgen.tokens).all()
    assert want == {r.rid: list(jgen.tokens[i]) for i, r in enumerate(reqs)}
    for mode in ("serial", "async"):
        e = PipelineServeEngine(runner, n_slots=4, eos=None, mode=mode,
                                capacity=32)
        e.warmup(prompt_len=6)
        rep = e.run(stream_of(_burst(reqs)))
        assert {r.rid: r.tokens for r in rep.records} == want, mode


def test_quantized_stages_served_equal_reference(pair):
    """Stages on their fake-quantized weights (``stage_weights`` of a
    quantized runner: 8 and 4 bits, calibrated over each stage's stacked
    layers) and a link that quantizes to the producer's 8 bits, served
    serially and async: the reference engine's greedy tokens on the same
    burst."""
    from repro.core.quant import QuantSpec as JQuantSpec
    from repro.serve import ServeLink as JServeLink
    from repro_torch.core.quant import QuantSpec
    jm, params, tm = pair
    reqs = poisson_traffic(4, rate_rps=1000.0, vocab=512, prompt_len=6,
                           max_new=5, seed=4)
    jr = jpipeline.PartitionedLMRunner(jm, params, cuts=[0], quant_specs=[
        JQuantSpec(8), JQuantSpec(4)])
    jeng = JPipelineServeEngine(jr, n_slots=4, eos=None, mode="serial",
                                capacity=32,
                                links=[JServeLink(quant=JQuantSpec(8))])
    jeng.warmup(prompt_len=6)
    want = {r.rid: r.tokens for r in jeng.run(jstream_of(_burst(reqs)))
            .records}
    tr = PartitionedLMRunner(tm, cuts=[0], quant_specs=[QuantSpec(8),
                                                        QuantSpec(4)])
    float_tokens = {r.rid: r.tokens for r in PipelineServeEngine(
        PartitionedLMRunner(tm, cuts=[0]), n_slots=4, eos=None,
        mode="serial", capacity=32).run(stream_of(_burst(reqs))).records}
    for mode in ("serial", "async"):
        e = PipelineServeEngine(tr, n_slots=4, eos=None, mode=mode,
                                capacity=32,
                                links=[ServeLink(quant=QuantSpec(8))])
        e.warmup(prompt_len=6)
        rep = e.run(stream_of(_burst(reqs)))
        assert {r.rid: r.tokens for r in rep.records} == want, mode
    assert want != float_tokens            # the quantization did something


def test_temperature_sampling_matches_reference(pair, runner):
    """The host-side Gumbel sampler is the reference's: the same tokens on
    the same logits, and a served burst at temperature 0.8 gives the
    reference engine's tokens."""
    jm, params, _ = pair
    jr = jpipeline.PartitionedLMRunner(jm, params, cuts=[0])
    kw = dict(n_slots=2, n_groups=1, eos=None, mode="serial", capacity=32,
              temperature=0.8, seed=5)
    jeng, teng = JPipelineServeEngine(jr, **kw), PipelineServeEngine(
        runner, **kw)
    logits = np.random.default_rng(6).standard_normal((20, 512)).astype(
        np.float32) * 3
    for rid in range(4):
        for step in range(5):
            assert teng._sample(logits[rid * 5 + step], rid, step) == \
                jeng._sample(logits[rid * 5 + step], rid, step)
    reqs = _burst(poisson_traffic(3, rate_rps=1000.0, vocab=512,
                                  prompt_len=6, max_new=5, seed=8))
    for e in (jeng, teng):
        e.warmup(prompt_len=6)
    want = {r.rid: r.tokens for r in jeng.run(jstream_of(reqs)).records}
    got = {r.rid: r.tokens for r in teng.run(stream_of(reqs)).records}
    assert got == want
    greedy = {r.rid: r.tokens for r in PipelineServeEngine(
        runner, **dict(kw, temperature=0.0)).run(stream_of(reqs)).records}
    assert greedy != got                   # the temperature did something
