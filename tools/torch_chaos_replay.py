#!/usr/bin/env python
"""torch_chaos_replay: re-run one of the port's chaos scenarios from a plan.

The counterpart of tools/chaos_replay.py for dynamo_tpu_torch. Every
scenario (tools/torch_chaos.py) takes its faults from a plan dict,
`{site: {"seed": int, "specs": [{kind, p, n, ...}]}}`, armed on the port's
failpoint registry (dynamo_tpu_torch/runtime/faults.py); the same plan
replays the same faults in the same order. The engines run the `tiny`
model in float32 on the CPU with the port's seed-0 weights, and every
stream is held to the port's single engine on the same weights. Nothing
of JAX is imported, so the tool runs where the card is.

Usage:
    python tools/torch_chaos_replay.py --list
        name the scenarios
    python tools/torch_chaos_replay.py <scenario> --dump-plan
        print the committed default plan JSON (edit it, feed it back)
    python tools/torch_chaos_replay.py <scenario> [--plan plan.json]
        run the scenario under the given (or default) plan; its own
        assertions are the pass / fail contract
    python tools/torch_chaos_replay.py <scenario> --record [PATH]
        also append {scenario, plan, summary} to PATH (default
        build/torch_chaos_replay.jsonl)
    python tools/torch_chaos_replay.py <scenario> --trace [PATH]
        record spans during the run (sample 1.0) into the JSONL PATH
        (default build/torch_chaos_trace.jsonl) plus a chrome://tracing
        twin at PATH.chrome.json; read them with
        tools/torch_trace_explain.py

Exit code 0 on a clean run, 1 on a contract violation (AssertionError),
2 on usage errors.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BUILD = os.path.join(REPO_ROOT, "build")
DEFAULT_RECORD = os.path.join(BUILD, "torch_chaos_replay.jsonl")
DEFAULT_TRACE = os.path.join(BUILD, "torch_chaos_trace.jsonl")


def _append_jsonl(path: str, record) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")


def main(argv=None) -> int:
    sys.path.insert(0, REPO_ROOT)
    from tools import torch_chaos as chaos
    ap = argparse.ArgumentParser(
        prog="torch_chaos_replay", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("scenario", nargs="?", choices=list(chaos.SCENARIOS),
                    help="scenario to run (see --list)")
    ap.add_argument("--list", action="store_true",
                    help="list scenario names and exit")
    ap.add_argument("--plan", metavar="PLAN_JSON",
                    help="fault plan JSON file ({site: {seed, specs}}); "
                         "default: the scenario's committed plan")
    ap.add_argument("--dump-plan", action="store_true",
                    help="print the scenario's committed plan and exit")
    ap.add_argument("--record", metavar="JSONL", nargs="?",
                    const=DEFAULT_RECORD,
                    help="append the run record to this JSONL (default: "
                         "build/torch_chaos_replay.jsonl)")
    ap.add_argument("--trace", metavar="TRACE_JSONL", nargs="?",
                    const=DEFAULT_TRACE,
                    help="record spans during the run (sample 1.0) into "
                         "this JSONL (default: build/torch_chaos_trace."
                         "jsonl), plus a chrome://tracing twin at "
                         "<path>.chrome.json")
    args = ap.parse_args(argv)

    if args.list:
        for name in chaos.SCENARIOS:
            print(name)
        return 0
    if not args.scenario:
        ap.error("a scenario name (or --list) is required")

    _, default_plan = chaos.SCENARIOS[args.scenario]
    if args.dump_plan:
        print(json.dumps(default_plan, indent=1))
        return 0
    plan = default_plan
    if args.plan:
        with open(args.plan) as f:
            plan = json.load(f)

    from dynamo_tpu_torch.runtime.tracing import TRACER, chrome_trace
    if args.trace:
        TRACER.configure(enabled=True, sample_rate=1.0)
        TRACER.reset()        # start the capture clean

    started = time.time()
    try:
        summary = chaos.run_scenario(args.scenario, plan)
        ok, error = True, None
    except AssertionError as e:
        summary, ok, error = None, False, f"{e}"
    elapsed = time.time() - started

    record = {"scenario": args.scenario, "plan": plan, "ok": ok,
              "error": error, "summary": summary,
              "started_unix": round(started, 3),
              "elapsed_s": round(elapsed, 3)}
    if args.trace:
        spans = TRACER.drain()
        for span in spans:
            _append_jsonl(args.trace, span)
        with open(args.trace + ".chrome.json", "w") as f:
            json.dump(chrome_trace(spans), f)
        record["trace_spans"] = len(spans)
        record["trace_file"] = args.trace
        print(f"captured {len(spans)} span(s) -> {args.trace} "
              f"(+ .chrome.json)", file=sys.stderr)
    print(json.dumps(record, indent=1, default=str))
    if args.record:
        _append_jsonl(args.record, json.loads(json.dumps(record,
                                                         default=str)))
        print(f"recorded to {args.record}", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
