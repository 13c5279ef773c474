"""Each cell's run, at a small size on the CPU (the look for a card
skipped), comes out correct as it stands and not correct with the timed
path broken underneath: for each fault the cell can have."""

from __future__ import annotations

import pytest

from bench.tests.small import run_small

SEARCH = "search.effnetb0-4plat.pop16k"
ORACLE = "oracle.effnetb0-4plat.distinct"


@pytest.mark.parametrize("name", [SEARCH, ORACLE])
def test_sound_run_is_correct(name):
    r = run_small(name)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) >= {"setup_s"}
    assert list(r)[-1] == "checks"


def _bad(r, *names):
    assert not r["correct"], r["checks"]
    bad = {k for k, c in r["checks"].items() if not c["value"] <= c["limit"]}
    assert bad & set(names), r["checks"]


# -- the search: an answer altered, half of the population left out -------------

def test_search_answer_altered(monkeypatch):
    from repro_torch.core import partition
    orig = partition.PartitionEvaluator.evaluate_batch

    def altered(self, cuts, constraints=None):
        be = orig(self, cuts, constraints)
        be.latency_s = be.latency_s * (1 + 1e-6)
        return be
    monkeypatch.setattr(partition.PartitionEvaluator, "evaluate_batch",
                        altered)
    _bad(run_small(SEARCH), "front_rel_gap")


def test_search_half_population_ranked(monkeypatch):
    from repro_torch.explore import strategies
    orig = strategies.pareto_indices

    def half(X, F, CV):
        n = len(X) // 2                 # the survivors' first half left out
        return n + orig(X[n:], F[n:], CV[n:])
    monkeypatch.setattr(strategies, "pareto_indices", half)
    _bad(run_small(SEARCH), "final_front_diff")


def test_search_domination_bit_altered(monkeypatch):
    from repro_torch.kernels import ref
    orig = ref.packed_domination

    def flipped(*a, **k):
        out = orig(*a, **k).clone()
        out[0, 1] ^= 1
        return out
    monkeypatch.setattr(ref, "packed_domination", flipped)
    _bad(run_small(SEARCH), "k1_bits_diff")


def test_search_ranking_unseen(monkeypatch):
    """K1 reached by a name the harness does not wrap: the check that it
    lost reads as failed, not as passed."""
    import types

    from repro_torch.kernels import ops, ref
    monkeypatch.setattr(ops, "_ref", types.SimpleNamespace(
        packed_domination=ref.packed_domination,
        domination_counts=ref.domination_counts))
    _bad(run_small(SEARCH), "k1_bits_diff")


def test_search_population_scored_wrong(monkeypatch):
    """Wrong values inside the search (the returned front's values are
    scored again, correctly, by the evaluator) push good cut vectors out
    of the front: scoring the whole population again catches it."""
    from repro_torch.core import partition_torch
    orig = partition_torch.make_runtime_eval_fn

    def wrong(*a, **k):
        fn = orig(*a, **k)

        def scored(C, t):
            F, CV = fn(C, t)
            odd = (C[:, 0] % 2 == 1).to(F.dtype)
            return F * (1 + 0.5 * odd)[:, None], CV
        return scored
    monkeypatch.setattr(partition_torch, "make_runtime_eval_fn", wrong)
    _bad(run_small(SEARCH), "final_front_diff")


# -- the oracle: an answer altered, half of the images left out ------------------

def test_oracle_answer_altered(monkeypatch):
    from repro_torch.quantize import evaluate
    orig = evaluate._top1

    def altered(logits, y):
        return orig(logits, y) + 1.0 / len(y)
    monkeypatch.setattr(evaluate, "_top1", altered)
    _bad(run_small(ORACLE), "acc_gap_images")


def test_oracle_half_images_left_out(monkeypatch):
    from repro_torch.quantize import evaluate

    def half(logits, y):
        n = len(y) // 2
        return float((logits[:n].argmax(-1) == y[:n]).float().mean() * 0.5)
    monkeypatch.setattr(evaluate, "_top1", half)
    _bad(run_small(ORACLE), "acc_gap_images")


