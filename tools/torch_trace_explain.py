#!/usr/bin/env python
"""torch_trace_explain: one request's timeline from a port trace file.

The counterpart of tools/trace_explain.py for dynamo_tpu_torch: it reads
the same span JSONL (written by `TRACER.drain()`, one span a line, the
schema in dynamo_tpu_torch/runtime/tracing.py) and renders the same
views, with the port's `Histogram` (observability/metrics.py) and
`chrome_trace` (runtime/tracing.py). It imports nothing of JAX.

- the span TREE (parent links), offset and duration a span, attrs inline:
  frontend root, schedule, attempts, worker stream, remote prefill, queue
  wait, KV transfer chunks, inject, decode emits;
- a summary: queue wait, prefill legs, transfer bytes and per-fetch cost,
  decode ITL (gaps between decode.emit instants), resumes and salvages,
  and the retry / migration story (attempt outcomes).

Usage:
    python tools/torch_trace_explain.py TRACE.jsonl [--trace-id ID]
    python tools/torch_trace_explain.py TRACE.jsonl --list
    python tools/torch_trace_explain.py TRACE.jsonl --summary
    python tools/torch_trace_explain.py TRACE.jsonl --chrome OUT.json

--summary aggregates the whole file by span name: count, total time and
p50 / p95 / p99 through the bucketed Histogram quantile estimator, then
the link estimator table (the transfer cost model's pre-send estimate
beside each transfer's actual time) and the stream-frontier table.

With no --trace-id the busiest non-scope trace is explained (scope:*
pseudo-traces, the engine's phases and the pool and router spans, are
context, not a request). --chrome writes the whole file as a
chrome://tracing JSON.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO_ROOT)


def load_spans(path: str) -> List[dict]:
    spans = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict) and "trace_id" in rec and "ts" in rec:
                spans.append(rec)
    return spans


def pick_trace(spans: List[dict]) -> Optional[str]:
    counts: Dict[str, int] = {}
    for s in spans:
        tid = s["trace_id"]
        if not tid.startswith("scope:"):
            counts[tid] = counts.get(tid, 0) + 1
    if not counts:
        return None
    return max(counts, key=lambda t: counts[t])


def _fmt_attrs(attrs: Optional[dict]) -> str:
    if not attrs:
        return ""
    return " " + " ".join(f"{k}={v}" for k, v in sorted(attrs.items()))


def _percentile(vals: List[float], p: float) -> float:
    if not vals:
        return 0.0
    vals = sorted(vals)
    i = min(len(vals) - 1, int(round(p * (len(vals) - 1))))
    return vals[i]


def explain(spans: List[dict], trace_id: str) -> str:
    """Render one trace's timeline + summary as text (pure function —
    the tier-1 golden test drives it on the committed artifact)."""
    mine = [s for s in spans if s["trace_id"] == trace_id]
    if not mine:
        return f"trace {trace_id}: no spans"
    mine.sort(key=lambda s: (s["ts"], s["span_id"]))
    t_base = min(s["ts"] for s in mine)
    by_id = {s["span_id"]: s for s in mine}
    children: Dict[str, List[dict]] = {}
    roots: List[dict] = []
    for s in mine:
        parent = s.get("parent_id") or ""
        if parent and parent in by_id:
            children.setdefault(parent, []).append(s)
        else:
            roots.append(s)

    out: List[str] = [f"trace {trace_id}: {len(mine)} span(s), "
                      f"{(max(x['ts'] + x['dur'] for x in mine) - t_base) * 1e3:.1f} ms end to end"]

    # defensive: a malformed file (e.g. span-id collisions from a
    # pre-fix process mix) could make the parent graph cyclic — render
    # each span at most once rather than recursing forever
    seen_ids: set = set()

    def render(s: dict, depth: int) -> None:
        if id(s) in seen_ids:
            return
        seen_ids.add(id(s))
        off = (s["ts"] - t_base) * 1e3
        dur = s["dur"] * 1e3
        mark = "!" if s.get("error") else ("·" if s["dur"] <= 0 else "—")
        out.append(f"  {off:9.2f}ms {'  ' * depth}{mark} {s['name']}"
                   + (f" [{dur:.2f}ms]" if s["dur"] > 0 else "")
                   + _fmt_attrs(s.get("attrs")))
        if depth < 64:
            for c in children.get(s["span_id"], ()):
                render(c, depth + 1)

    for r in roots:
        render(r, 0)
    for s in mine:              # orphans of a cyclic/malformed graph
        render(s, 0)

    # -- summary --------------------------------------------------------------
    def named(*names):
        return [s for s in mine if s["name"] in names]

    out.append("")
    out.append("summary:")
    waits = named("admission.wait", "queue.wait")
    if waits:
        total = sum(s["dur"] for s in waits) * 1e3
        out.append(f"  queue wait: {total:.2f} ms across {len(waits)} "
                   f"leg(s) ({', '.join(s['name'] for s in waits)})")
    sched = named("schedule", "router.schedule")
    if sched:
        out.append(f"  schedule: {sum(s['dur'] for s in sched) * 1e3:.2f} ms "
                   f"over {len(sched)} decision(s)")
    prefills = named("prefill.remote", "prefill.run")
    for s in prefills:
        out.append(f"  {s['name']}: {s['dur'] * 1e3:.2f} ms"
                   + _fmt_attrs(s.get("attrs")))
    xfers = named("kv.transfer", "kv.inject")
    if xfers:
        total_bytes = sum((s.get("attrs") or {}).get("bytes", 0)
                          for s in xfers)
        total_pages = sum((s.get("attrs") or {}).get("pages", 0)
                          for s in xfers)
        out.append(f"  kv transfer: {total_bytes} bytes / {total_pages} "
                   f"page(s) in {len(xfers)} leg(s), "
                   f"{sum(s['dur'] for s in xfers) * 1e3:.2f} ms")
    resumes = named("kv.transfer.resume")
    if resumes:
        pages = sum((s.get("attrs") or {}).get("committed_pages", 0)
                    for s in resumes)
        out.append(f"  kv transfer resumes: {len(resumes)} (continued "
                   f"past {pages} already-committed page(s))")
    salvages = named("kv.salvage")
    for s in salvages:
        a = s.get("attrs") or {}
        out.append(f"  kv salvage: kept {a.get('pages', '?')} committed "
                   f"page(s) ({a.get('tokens', '?')} tokens charged as "
                   "cached); only the tail re-prefilled locally")
    emits = sorted(named("decode.emit"), key=lambda s: s["ts"])
    if len(emits) >= 2:
        gaps = [(b["ts"] - a["ts"]) * 1e3
                for a, b in zip(emits, emits[1:])]
        out.append(f"  decode: {len(emits)} emit(s); itl p50 "
                   f"{_percentile(gaps, 0.5):.2f} ms, p95 "
                   f"{_percentile(gaps, 0.95):.2f} ms, max "
                   f"{max(gaps):.2f} ms")
    elif emits:
        out.append(f"  decode: {len(emits)} emit(s)")
    attempts = named("attempt")
    if attempts:
        outcomes: Dict[str, int] = {}
        for s in attempts:
            o = (s.get("attrs") or {}).get("outcome", "?")
            outcomes[o] = outcomes.get(o, 0) + 1
        story = ", ".join(f"{k}×{v}" for k, v in sorted(outcomes.items()))
        out.append(f"  attempts: {len(attempts)} ({story})")
    errs = [s for s in mine if s.get("error")]
    if errs:
        out.append(f"  errors: {len(errs)} span(s): "
                   + ", ".join(sorted({s['name'] for s in errs})))
    return "\n".join(out)


def summarize(spans: List[dict]) -> str:
    """Whole-file per-span-name latency table: count, total ms, and
    p50/p95/p99 from bucket counts (Histogram.quantile — the estimator
    is exact at bucket boundaries; +Inf-bucket ranks report the largest
    finite bound). Instants (dur <= 0) are counted but not timed."""
    from dynamo_tpu_torch.observability.metrics import Histogram

    # span durations range from µs schedule decisions to multi-second
    # storms: a wide log-ish ladder keeps the estimator honest
    buckets = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
               0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
               float("inf"))
    hist = Histogram("trace_span_seconds", "span durations", ("name",),
                     buckets=buckets)
    totals: Dict[str, float] = {}
    instants: Dict[str, int] = {}
    for s in spans:
        name = s["name"]
        if s.get("dur", 0.0) > 0.0:
            hist.observe(name, value=s["dur"])
            totals[name] = totals.get(name, 0.0) + s["dur"]
        else:
            instants[name] = instants.get(name, 0) + 1
    out = [f"{len(spans)} span(s), "
           f"{len(set(s['trace_id'] for s in spans))} trace(s)"]
    out.append(f"  {'span':<28}{'count':>7}{'total ms':>11}"
               f"{'p50 ms':>9}{'p95 ms':>9}{'p99 ms':>9}")
    for name in sorted(totals, key=lambda n: -totals[n]):
        n = hist.count(name)
        p50, p95, p99 = (hist.quantile(q, name) * 1e3
                         for q in (0.50, 0.95, 0.99))
        out.append(f"  {name:<28}{n:>7}{totals[name] * 1e3:>11.2f}"
                   f"{p50:>9.3f}{p95:>9.3f}{p99:>9.3f}")
    for name in sorted(instants):
        if name not in totals:
            out.append(f"  {name:<28}{instants[name]:>7}"
                       f"{'instant':>11}")
    table = link_estimator_table(spans)
    if table:
        out.append("")
        out.extend(table)
    stream_table = stream_frontier_table(spans)
    if stream_table:
        out.append("")
        out.extend(stream_table)
    return "\n".join(out)


def stream_frontier_table(spans: List[dict]) -> List[str]:
    """Per-(shard, host) stream table from kv.transfer.stream spans
    (sharded parallel transfer, disagg/remote_transfer.py): wall time,
    bytes, and resumes per stream, plus the MIN-FRONTIER STALL — how
    long the slowest stream of each transfer outlived the fastest
    (the time the request-wide min frontier, which gates early decode
    and bounds salvage, sat waiting on the straggler). The straggler
    column names the stream that pinned the min. Empty when no span
    carries a stream id (artifacts from before the sharded streams render
    unchanged)."""
    # (trace_id, request_id) -> stream spans of that transfer
    by_xfer: Dict[tuple, List[dict]] = {}
    for s in spans:
        attrs = s.get("attrs") or {}
        if s["name"] == "kv.transfer.stream" and s.get("dur", 0.0) > 0.0:
            key = (s["trace_id"], attrs.get("request_id", "?"))
            by_xfer.setdefault(key, []).append(s)
    if not by_xfer:
        return []
    per_stream: Dict[str, dict] = {}
    stalls: List[float] = []
    stragglers: Dict[str, int] = {}
    for rows in by_xfer.values():
        ends = [(r["ts"] + r["dur"], r) for r in rows]
        if len(ends) >= 2:
            last_end, last = max(ends, key=lambda x: x[0])
            first_end = min(e for e, _ in ends)
            stalls.append(last_end - first_end)
            a = last.get("attrs") or {}
            skey = f"{a.get('engine_id', '?')}/{a.get('host', '?')}" \
                   f"#{a.get('stream', '?')}"
            stragglers[skey] = stragglers.get(skey, 0) + 1
        for r in rows:
            a = r.get("attrs") or {}
            skey = f"{a.get('engine_id', '?')}/{a.get('host', '?')}" \
                   f"#{a.get('stream', '?')}"
            row = per_stream.setdefault(
                skey, {"n": 0, "bytes": 0, "dur": 0.0, "resumes": 0})
            row["n"] += 1
            row["bytes"] += a.get("bytes") or 0
            row["dur"] += r["dur"]
            row["resumes"] += a.get("resumes") or 0
    out = ["kv transfer streams (per shard, host):",
           f"  {'stream':<24}{'sends':>6}{'bytes':>12}{'total ms':>10}"
           f"{'resumes':>8}{'straggler':>10}"]
    for skey in sorted(per_stream):
        row = per_stream[skey]
        out.append(f"  {skey:<24}{row['n']:>6}{row['bytes']:>12}"
                   f"{row['dur'] * 1e3:>10.2f}{row['resumes']:>8}"
                   f"{stragglers.get(skey, 0):>10}")
    if stalls:
        stalls.sort()
        out.append(
            f"  min-frontier stall (slowest-fastest stream end): "
            f"p50 {stalls[len(stalls) // 2] * 1e3:.2f} ms, "
            f"max {stalls[-1] * 1e3:.2f} ms over {len(stalls)} "
            "parallel transfer(s)")
    return out


def link_estimator_table(spans: List[dict]) -> List[str]:
    """Per-link estimated-vs-actual transfer-time table from kv.transfer
    spans carrying the sender's pre-send `est_s` attr (the
    TransferCostModel's answer at dispatch time). The diagnosis surface
    for routing regressions caused by a stale bandwidth EWMA: a link
    whose err% goes strongly negative is being under-estimated (the
    EWMA believes it faster than it is) and the transfer-aware router
    is over-routing onto it. Empty when no span carries an estimate
    (artifacts from before the transfer-aware router render unchanged)."""
    links: Dict[str, List[dict]] = {}
    for s in spans:
        attrs = s.get("attrs") or {}
        if s["name"] == "kv.transfer" and "est_s" in attrs \
                and s.get("dur", 0.0) > 0.0:
            links.setdefault(attrs.get("engine_id", "?"), []).append(s)
    if not links:
        return []
    out = ["kv transfer estimator (per link, est vs actual):",
           f"  {'link':<24}{'sends':>6}{'bytes':>12}{'est ms':>9}"
           f"{'act ms':>9}{'err %':>8}{'cold':>6}"]
    for link in sorted(links):
        rows = links[link]
        est = sum((r["attrs"].get("est_s") or 0.0) for r in rows)
        act = sum(r["dur"] for r in rows)
        nbytes = sum((r["attrs"].get("bytes") or 0) for r in rows)
        cold = sum(1 for r in rows if r["attrs"].get("est_cold"))
        err = (est - act) / act * 100 if act else 0.0
        out.append(f"  {link:<24}{len(rows):>6}{nbytes:>12}"
                   f"{est * 1e3:>9.2f}{act * 1e3:>9.2f}{err:>8.1f}"
                   f"{cold:>6}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="torch_trace_explain", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("trace_file", help="span JSONL (TRACER.drain records)")
    ap.add_argument("--trace-id", help="trace to explain "
                                       "(default: busiest request trace)")
    ap.add_argument("--list", action="store_true",
                    help="list trace ids with span counts and exit")
    ap.add_argument("--summary", action="store_true",
                    help="whole-file per-span-name latency table "
                         "(p50/p95/p99 via Histogram.quantile) and exit")
    ap.add_argument("--chrome", metavar="OUT_JSON",
                    help="also write the whole file as a chrome://tracing "
                         "JSON (tools/artifacts.py policy)")
    args = ap.parse_args(argv)

    spans = load_spans(args.trace_file)
    if not spans:
        print(f"no spans in {args.trace_file}", file=sys.stderr)
        return 1
    if args.list:
        counts: Dict[str, int] = {}
        for s in spans:
            counts[s["trace_id"]] = counts.get(s["trace_id"], 0) + 1
        for tid, n in sorted(counts.items(), key=lambda kv: -kv[1]):
            print(f"{n:6d}  {tid}")
        return 0
    if args.summary:
        print(summarize(spans))
        return 0
    if args.chrome:
        from dynamo_tpu_torch.runtime.tracing import chrome_trace

        from tools.artifacts import write_json
        write_json(args.chrome, chrome_trace(spans), overwrite=True)
        print(f"chrome trace -> {args.chrome}", file=sys.stderr)
    tid = args.trace_id or pick_trace(spans)
    if tid is None:
        print("no request traces in file (only scope:* spans); pass "
              "--trace-id to explain one of those", file=sys.stderr)
        return 1
    print(explain(spans, tid))
    return 0


if __name__ == "__main__":
    sys.exit(main())
