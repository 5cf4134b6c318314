"""The port's fail-slow scorer and hedge budget (dynamo_tpu_torch/runtime/
health.py) against the JAX package's (dynamo_tpu/runtime/health.py).

Each of tests/test_health.py's 13 cases runs on both packages: the case's
own assertions hold on each, and what each run observed (scores, z-scores,
SLOW decisions, the decision timeline, the budget's grants) is equal. Then
one seeded evidence sequence (numpy, seed 13) goes through both scorers
and both hedge budgets, and their decisions are equal step for step.
"""
import numpy as np
import pytest

from dynamo_tpu.runtime import health as jhealth
from dynamo_tpu_torch.runtime import health as thealth


def mk(H, **kw):
    kw.setdefault("clock", lambda: 0.0)
    kw.setdefault("min_evidence", 3)
    kw.setdefault("enter_evals", 2)
    kw.setdefault("exit_evals", 2)
    return H.HealthScorer(**kw)


def feed(sc, latencies, n=4):
    """n samples per worker at the given per-worker latency."""
    for _ in range(n):
        for w, v in latencies.items():
            sc.observe(w, v)


def both(case):
    """Run `case(module)` on the JAX and the port module; the observations
    must be equal. Returns the port's."""
    want, got = case(jhealth), case(thealth)
    assert got == want
    return got


def view(sc):
    return {"snapshot": sc.snapshot(), "timeline": list(sc.timeline)}


# -- robust scoring ------------------------------------------------------------

def test_outlier_worker_scores_low_fleet_scores_high():
    def case(H):
        sc = mk(H)
        feed(sc, {"a": 0.05, "b": 0.05, "c": 0.05, "sick": 0.50})
        sc.evaluate(0.0)
        assert sc.score("sick") < 0.5 < sc.score("a")
        assert sc.zscore("sick") > sc.z_enter
        assert sc.score("a") == sc.score("b") == sc.score("c") == 1.0
        return view(sc)
    both(case)


def test_median_baseline_resists_a_slow_clique():
    def case(H):
        sc = mk(H)
        feed(sc, {"a": 0.05, "b": 0.05, "c": 0.05, "s1": 0.4, "s2": 0.5})
        sc.evaluate(0.0)
        assert sc.zscore("s1") > sc.z_enter
        assert sc.zscore("s2") > sc.z_enter
        assert sc.score("a") == 1.0
        return view(sc)
    both(case)


def test_no_quorum_no_condemnation():
    def case(H):
        sc = mk(H)
        feed(sc, {"a": 0.05, "sick": 5.0})
        for t in range(5):
            assert sc.evaluate(float(t)) == []
        assert sc.score("sick") == 1.0
        assert not sc.is_slow("sick")
        return view(sc)
    both(case)


def test_min_evidence_floor_never_condemns_cold():
    def case(H):
        sc = mk(H, min_evidence=8)
        feed(sc, {"a": 0.05, "b": 0.05, "c": 0.05}, n=10)
        sc.observe("cold", 9.0)
        for t in range(5):
            sc.evaluate(float(t))
        assert sc.score("cold") == 1.0
        assert not sc.is_slow("cold")
        feed(sc, {"cold": 9.0}, n=8)
        sc.evaluate(10.0)
        sc.evaluate(11.0)
        assert sc.is_slow("cold")
        return view(sc)
    both(case)


def test_link_err_evidence_inflates_z():
    def case(H):
        sc = mk(H, z_enter=1.0, z_exit=0.5)
        feed(sc, {"a": 0.05, "b": 0.05, "c": 0.05})
        sc.observe_link_err("c", 1.0)
        sc.evaluate(0.0)
        assert sc.zscore("c") == pytest.approx(sc.err_weight)
        assert sc.zscore("a") == 0.0
        return view(sc)
    both(case)


# -- hysteresis ----------------------------------------------------------------

def test_enter_needs_consecutive_evals():
    def case(H):
        sc = mk(H, enter_evals=3)
        feed(sc, {"a": 0.05, "b": 0.05, "c": 0.05, "sick": 0.5})
        assert sc.evaluate(0.0) == []
        assert sc.evaluate(1.0) == []
        events = sc.evaluate(2.0)
        assert [e["event"] for e in events] == ["slow_enter"]
        assert events[0]["worker"] == "sick"
        assert sc.is_slow("sick")
        return view(sc)
    both(case)


def test_one_spike_flips_nothing():
    def case(H):
        sc = mk(H, enter_evals=2)
        feed(sc, {"a": 0.05, "b": 0.05, "c": 0.05, "w": 0.5})
        assert sc.evaluate(0.0) == []
        feed(sc, {"w": 0.05}, n=12)
        assert sc.evaluate(1.0) == []
        feed(sc, {"w": 0.5}, n=4)
        assert sc.evaluate(2.0) == []
        assert not sc.is_slow("w")
        return view(sc)
    both(case)


def test_exit_hysteresis_and_recovery():
    def case(H):
        sc = mk(H)
        feed(sc, {"a": 0.05, "b": 0.05, "c": 0.05, "sick": 0.5})
        sc.evaluate(0.0)
        sc.evaluate(1.0)
        assert sc.is_slow("sick")
        feed(sc, {"sick": 0.05}, n=20)
        assert sc.evaluate(2.0) == []
        events = sc.evaluate(3.0)
        assert [e["event"] for e in events] == ["slow_exit"]
        assert not sc.is_slow("sick")
        assert sc.slow_workers() == []
        return view(sc)
    both(case)


def test_hysteresis_requires_exit_below_enter():
    def case(H):
        with pytest.raises(ValueError) as exc:
            H.HealthScorer(z_enter=2.0, z_exit=2.0)
        return str(exc.value)
    both(case)


# -- eviction + determinism ----------------------------------------------------

def test_forget_evicts_all_state():
    def case(H):
        sc = mk(H)
        feed(sc, {"a": 0.05, "b": 0.05, "c": 0.05, "sick": 0.5})
        sc.evaluate(0.0)
        sc.evaluate(1.0)
        assert sc.is_slow("sick")
        sc.forget("sick")
        assert not sc.is_slow("sick")
        assert sc.score("sick") == 1.0
        assert sc.evidence("sick") == 0
        assert "sick" not in sc.snapshot()["workers"]
        return view(sc)
    both(case)


def test_same_stream_same_timeline():
    def case(H):
        def run():
            sc = mk(H)
            for t in range(6):
                feed(sc, {"a": 0.05, "b": 0.05, "c": 0.05,
                          "sick": 0.5 if t < 4 else 0.05}, n=2)
                sc.evaluate(float(t))
            return sc.timeline
        first = run()
        assert first == run()
        return first
    assert both(case)


# -- hedge budget --------------------------------------------------------------

def test_hedge_budget_burst_then_denial():
    def case(H):
        b = H.HedgeBudget(budget_frac=0.5, burst=2)
        grants = [b.try_fire("std") for _ in range(3)]
        assert grants == [True, True, False]
        for _ in range(4):
            b.on_request("std")
        more = [b.try_fire("std") for _ in range(3)]
        assert more == [True, True, False]
        return grants + more, b.snapshot()
    both(case)


def test_hedge_budget_is_per_class():
    def case(H):
        b = H.HedgeBudget(budget_frac=0.0, burst=1)
        assert b.try_fire("interactive")
        assert not b.try_fire("interactive")
        assert b.try_fire("batch")
        snap = b.snapshot()
        assert snap["fired"] == {"interactive": 1, "batch": 1}
        return snap
    both(case)


# -- one seeded evidence sequence through both ---------------------------------

def _seeded_run(H, seed: int = 13, steps: int = 40):
    """A fleet of six workers over `steps` evaluation rounds: each round
    every worker reports a few latencies (one worker turns slow for a
    stretch, one is flaky), a worker dies and comes back under its name,
    link-error evidence arrives, and hedges are asked for per class. The
    decisions of every round: SLOW events, scores, budget grants."""
    rng = np.random.default_rng(seed)
    sc = mk(H, min_evidence=6, enter_evals=2, exit_evals=3)
    budget = H.HedgeBudget(budget_frac=0.2, burst=1)
    workers = [f"w{i}" for i in range(6)]
    rounds = []
    for t in range(steps):
        for w in workers:
            base = 0.05 + 0.01 * rng.random()
            if w == "w2" and 8 <= t < 22:
                base *= 8.0
            if w == "w4" and rng.random() < 0.2:
                base *= 5.0
            for _ in range(int(rng.integers(1, 4))):
                sc.observe(w, float(base * (1 + 0.1 * rng.standard_normal())))
        if t % 7 == 3:
            sc.observe_link_err("w5", float(rng.random() - 0.3))
        if t == 25:
            sc.forget("w3")
        events = sc.evaluate(float(t))
        grants = []
        for cls in ("interactive", "standard", "batch"):
            for _ in range(int(rng.integers(0, 3))):
                budget.on_request(cls)
            grants.append(budget.try_fire(cls))
        rounds.append({"events": events,
                       "scores": {w: sc.score(w) for w in workers},
                       "z": {w: sc.zscore(w) for w in workers},
                       "slow": sc.slow_workers(), "grants": grants})
    return rounds, sc.snapshot(), budget.snapshot()


def test_seeded_evidence_sequence_decisions_equal():
    want, got = _seeded_run(jhealth), _seeded_run(thealth)
    for t, (a, b) in enumerate(zip(want[0], got[0])):
        assert b == a, t
    assert got[1:] == want[1:]
    # the sequence exercised both transitions
    kinds = {e["event"] for r in got[0] for e in r["events"]}
    assert kinds == {"slow_enter", "slow_exit"}, kinds
