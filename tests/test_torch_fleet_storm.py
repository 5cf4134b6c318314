"""tools/torch_fleet_storm.py's slo and autoscale modes against
tools/fleet_storm.py's, --quick, with the live engines on the CPU.

- autoscale: the static / controller / replay storms over the same seeded
  traffic, the budget tuner's walk of `mixed_token_budget` and every
  contract equal JAX's report field for field (the port's engine is tiny
  with weights of its own; the tuner reads only the ledger's padding,
  which the weights do not move).
- slo: the live engine's ledger summary equals JAX's (apart from its
  wall-clock rate), and the storm's contracts, victim link, kill count and
  alert sequence equal JAX's; the rollups and alert timestamps are wall
  clock and are not compared.
- the exit codes: 0 with the contracts met, 1 when a storm is cut so short
  that one cannot be.
"""
import argparse
import asyncio
import importlib
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tools():
    tools = os.path.join(REPO, "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    return (importlib.import_module("fleet_storm"),
            importlib.import_module("torch_fleet_storm"))


def _quick_args(**kw):
    """The namespace both tools build from `--quick`."""
    a = dict(workers=16, seed=10, phase_ticks=8, ticks=240,
             autoscale_workers=16, degraded_start=210, degraded_len=30)
    a.update(kw)
    return argparse.Namespace(**a)


def test_autoscale_report_equals_jax():
    jstorm, tstorm = _tools()
    args = _quick_args()
    want = asyncio.run(jstorm.run_autoscale_storm(args))
    want["budget_tuning"] = jstorm.run_budget_tuner(quick=True)
    got = asyncio.run(tstorm.run_autoscale_storm(args))
    got["budget_tuning"] = tstorm.run_budget_tuner(True, "cpu")
    assert got == want
    assert all(got["contracts"].values()), got["contracts"]
    assert got["budget_tuning"]["n_adjustments"] >= 1


def test_slo_report_equals_jax(tmp_path):
    jstorm, tstorm = _tools()
    jled = jstorm.run_engine_ledger(str(tmp_path / "j.jsonl"), quick=True)
    tled = tstorm.run_engine_ledger(str(tmp_path / "t.jsonl"), True, "cpu")
    for led in (jled, tled):
        led.pop("tok_s_last")
        led.pop("jsonl")
    assert tled == jled
    assert tled["requests"] == 3 and tled["written"] == tled["samples"]
    assert set(tled["steps_by_kind"]) == {"prefill", "mixed", "decode"}
    args = _quick_args()
    want = asyncio.run(jstorm.run_fleet_storm(args))
    got = asyncio.run(tstorm.run_fleet_storm(args))
    assert got["contracts"] == want["contracts"]
    assert all(got["contracts"].values()), got["contracts"]
    assert got["storm"] == want["storm"]

    def seq(report):
        return [(ev["event"], ev["slo"]) for ev in report["alerts"]]
    assert seq(got) == seq(want)
    assert [(ev["event"], ev["slo"]) for ev in got["alerts_delivered"]] \
        == seq(got)


@pytest.mark.parametrize("mode,extra,rc", [
    ("autoscale", [], 0),
    ("autoscale", ["--ticks", "20"], 1),     # too short to burn the SLO
    ("slo", [], 0),
    ("slo", ["--phase-ticks", "1"], 1),      # too short to fire an alert
])
def test_exit_codes(mode, extra, rc, capsys):
    _, tstorm = _tools()
    assert tstorm.main(["--mode", mode, "--quick", "--device", "cpu",
                        "--no-artifact", *extra]) == rc
    capsys.readouterr()
