"""Per-step engine resource ledger: what is the engine doing, over time.

Copied from dynamo_tpu/observability/ledger.py. A bounded ring of
per-step samples recorded at the engine's commit sites
(engine/engine.py `_ledger_record`), drainable as JSONL and folded into
the `llm_engine_*` gauges on every /metrics surface (frontend/service.py,
observability/exporter.py) and into `EngineMetrics.engine_*`, which the
worker's `$STATS` carries.

Recording discipline:

- **no device syncs, ever**: every sample field comes from host-side
  scheduler / allocator state the commit path already holds (allocator
  free counts, plan array shapes, deque lengths): no `.item()`, no
  `.cpu()`, no event wait on a CUDA tensor, which would stall the
  two-deep decode pipeline;
- **disabled path is branch-only**: `record_step()` is one `if` when
  off (`DYN_LEDGER=0`), and the engine's streams are token-identical
  either way (the ledger only reads);
- **bounded**: the ring overwrites oldest samples (`samples_dropped`
  counted).

The ledger is on by default: one tuple append plus ~20 plain attribute
bumps per device step. `DYN_LEDGER_CAP` sizes the ring (default 4096);
`DYN_PEAK_TFLOPS` (the card's dense peak, in TFLOP/s) turns the EWMA
token rate into an MFU estimate.

Per-step sample schema (one JSONL record per step after `drain()`):
    {"ts", "dt", "kind", "rows", "rows_live", "tokens_useful",
     "tokens_padded", "kv_used", "kv_total", "host_used", "host_total",
     "disk_used", "disk_total", "waiting", "recompiles", "stream_hit",
     "stream_late", "stream_spilled", "stream_stalls", "tok_s", "mfu"}
`kind` is the step kind ("prefill" | "decode" | "mixed" | "spec" |
"stream" — the last is a streamed step past the page budget, whose
stream_* columns carry that step's window-pool prefetch deltas);
`tokens_padded` is the full bucket charge of the step ([Bb, Tb] or
window steps x slots) so padded - useful is the bucket-ladder waste.
`recompiles` counts new (program, bucket) keys first seen at this step's
dispatch, on the JAX engine's keys: there a first-seen key is an XLA
compile. On the card a first-seen decode-window or verify key is, as a
rule, a CUDA-graph capture (engine/window_graph.py; the graph's own key
is finer, with the penalty history's width, or coarser, without the
gather base on the ragged path); a first-seen prefill or mixed key is an
eager step at new shapes, which compiles nothing.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional


class LedgerStats:
    """Process-local fold target for the `llm_engine_*` gauges.

    Same pattern as runtime/cpstats.py CP_STATS: plain numeric fields
    bumped at record time, folded into Prometheus gauges at /metrics
    render by frontend/service.py. Values are process-local and
    last-writer-wins across engines in one process (cumulative fields
    add across engines) — the per-instance question /metrics answers.
    """

    FIELDS = (
        "steps_total",            # device steps committed (all kinds)
        "steps_prefill",          # pure prefill steps
        "steps_decode",           # decode windows (one per window)
        "steps_mixed",            # fused prefill+decode steps
        "steps_spec",             # speculative verify steps
        "steps_stream",           # tiered-KV streamed long-context steps
        "recompiles",             # new (program, bucket) keys dispatched
        "tokens_useful",          # committed/consumed tokens, all kinds
        "tokens_padded",          # full bucket charge, all kinds
        "useful_tokens_prefill",  # per-kind padding-waste split:
        "padded_tokens_prefill",  # prefill chunk rows
        "useful_tokens_decode",   # decode window (steps x slots)
        "padded_tokens_decode",
        "useful_tokens_mixed",    # fused steps ([Bb, Tb] charge)
        "padded_tokens_mixed",
        "kv_pages_used",          # HBM KV tier occupancy (pages)
        "kv_pages_total",
        "host_pages_used",        # host-DRAM offload tier occupancy
        "host_pages_total",
        "disk_pages_used",        # disk offload tier occupancy
        "disk_pages_total",
        "batch_rows_live",        # last step: live rows in the bucket
        "batch_rows_total",       # last step: bucket row capacity
        # tiered-KV streaming decode (engine/streaming.py), cumulative
        # across streamed steps: window-pool segments consumed from a
        # prior prefetch vs staged synchronously (the double-buffer's
        # hide-the-tier-latency verdict), pages spilled by the EWMA
        # policy, and steps that stalled on >= 1 late segment
        "stream_prefetch_hit",
        "stream_prefetch_late",
        "stream_pages_spilled",
        "stream_stall_steps",
        "queue_depth",            # last step: requests waiting
        "tok_s",                  # EWMA instantaneous useful tok/s
        "mfu",                    # tok_s * flops/token / peak (0 = no peak)
        "samples_dropped",        # ring overwrites (oldest lost)
    )

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        for name in self.FIELDS:
            setattr(self, name, 0)

    def snapshot(self) -> Dict[str, float]:
        return {name: getattr(self, name) for name in self.FIELDS}


LEDGER_STATS = LedgerStats()


def model_flops_per_token(cfg) -> float:
    """Matmul FLOPs one decoded token costs (2 x active matmul params):
    attention projections + MLP (active experts only on MoE) + lm head.
    Attention score/value FLOPs are context-dependent and excluded, so
    this is a floor — the resulting MFU is conservative. `cfg` is a
    ModelConfig (engine/config.py)."""
    d = cfg.hidden_size
    q = cfg.num_heads * cfg.head_dim
    kv = cfg.num_kv_heads * cfg.head_dim
    attn = d * q + 2 * d * kv + q * d
    mlp = 3 * d * cfg.intermediate_size
    if cfg.num_experts:
        mlp *= cfg.num_experts_per_tok
    head = d * cfg.vocab_size
    return 2.0 * (cfg.num_layers * (attn + mlp) + head)


def sampler_flops_per_token(cfg) -> float:
    """FLOPs the sampling tail spends per decoded token: with the tail
    inside the decode window program, its vocab-sized
    work (temperature scale, rank mask, gumbel draw — ~5 elementwise
    passes over [V], sort excluded as comparison-not-FLOP) executes on
    the device inside the step the ledger meters, so the MFU denominator
    counts it. Kept separate from `model_flops_per_token` (whose formula
    is load-bearing for existing consumers); the engine passes the sum."""
    return 5.0 * cfg.vocab_size


_KINDS = ("prefill", "decode", "mixed", "spec", "stream")


class StepLedger:
    """The bounded per-step sample ring + gauge fold for one engine.

    `stats` defaults to the process-global LEDGER_STATS (what /metrics
    renders); pass a private LedgerStats for isolation in tests. The
    EWMA smoothing (`tok_s`) uses alpha=0.2 over per-step instantaneous
    rates; `peak_flops` (DYN_PEAK_TFLOPS e12, or `configure()`) turns
    the rate into an MFU estimate — 0.0 when no peak is known (CPU)."""

    EWMA_ALPHA = 0.2

    def __init__(self, capacity: Optional[int] = None,
                 enabled: Optional[bool] = None,
                 stats: Optional[LedgerStats] = None,
                 flops_per_token: float = 0.0):
        if enabled is None:
            enabled = os.environ.get("DYN_LEDGER", "1") not in ("", "0")
        if capacity is None:
            capacity = int(os.environ.get("DYN_LEDGER_CAP", "4096"))
        self.enabled = bool(enabled)
        self.capacity = max(1, int(capacity))
        self.stats = stats if stats is not None else LEDGER_STATS
        self.flops_per_token = float(flops_per_token)
        self.peak_flops = float(
            os.environ.get("DYN_PEAK_TFLOPS", "0")) * 1e12
        self._recs: List[tuple] = []
        self._pos = 0
        self.dropped = 0
        self._last_ts = 0.0
        self._tok_s = 0.0
        # per-INSTANCE cumulative counters (metrics() reads these; the
        # shared `stats` fold is process-cumulative across engines)
        self.steps = 0
        self.recompiles_total = 0
        self.useful_total = 0
        self.padded_total = 0

    def configure(self, enabled: Optional[bool] = None,
                  capacity: Optional[int] = None,
                  peak_tflops: Optional[float] = None) -> "StepLedger":
        if enabled is not None:
            self.enabled = enabled
        if capacity is not None:
            self.capacity = max(1, int(capacity))
            self._recs, self._pos = [], 0
        if peak_tflops is not None:
            self.peak_flops = peak_tflops * 1e12
        return self

    # -- recording (deferred-recorder discipline: host ints only) -------------

    def record_step(self, kind: str, rows: int, rows_live: int,
                    useful: int, padded: int,
                    kv_used: int, kv_total: int,
                    host_used: int, host_total: int,
                    disk_used: int, disk_total: int,
                    waiting: int, recompiles: int,
                    stream_hit: int = 0, stream_late: int = 0,
                    stream_spilled: int = 0, stream_stalls: int = 0) -> None:
        """Record one committed device step. Every argument is an
        already-known host int — the disabled path is this one branch.
        The stream_* kwargs are this step's window-pool deltas (0 on
        non-streamed kinds); they attribute the prefetch leg per step
        in the drained JSONL."""
        if not self.enabled:
            return
        now = time.monotonic()
        dt = now - self._last_ts if self._last_ts else 0.0
        self._last_ts = now
        if 0.0 < dt < 60.0:
            inst = useful / dt
            self._tok_s += self.EWMA_ALPHA * (inst - self._tok_s)
        mfu = 0.0
        if self.peak_flops > 0.0 and self.flops_per_token > 0.0:
            mfu = self._tok_s * self.flops_per_token / self.peak_flops
        rec = (now, dt, kind, rows, rows_live, useful, padded,
               kv_used, kv_total, host_used, host_total,
               disk_used, disk_total, waiting, recompiles,
               stream_hit, stream_late, stream_spilled, stream_stalls,
               self._tok_s, mfu)
        if len(self._recs) < self.capacity:
            self._recs.append(rec)
        else:
            self._recs[self._pos] = rec
            self._pos = (self._pos + 1) % self.capacity
            self.dropped += 1
        self.steps += 1
        self.recompiles_total += recompiles
        self.useful_total += useful
        self.padded_total += padded
        s = self.stats
        s.steps_total += 1
        setattr(s, "steps_" + kind, getattr(s, "steps_" + kind) + 1)
        s.recompiles += recompiles
        s.tokens_useful += useful
        s.tokens_padded += padded
        k = kind if kind in ("prefill", "decode", "mixed") else "decode"
        setattr(s, "useful_tokens_" + k,
                getattr(s, "useful_tokens_" + k) + useful)
        setattr(s, "padded_tokens_" + k,
                getattr(s, "padded_tokens_" + k) + padded)
        s.kv_pages_used = kv_used
        s.kv_pages_total = kv_total
        s.host_pages_used = host_used
        s.host_pages_total = host_total
        s.disk_pages_used = disk_used
        s.disk_pages_total = disk_total
        s.batch_rows_live = rows_live
        s.batch_rows_total = rows
        s.queue_depth = waiting
        s.stream_prefetch_hit += stream_hit
        s.stream_prefetch_late += stream_late
        s.stream_pages_spilled += stream_spilled
        s.stream_stall_steps += stream_stalls
        s.tok_s = self._tok_s
        s.mfu = mfu
        s.samples_dropped = self.dropped

    # -- derived figures (engine metrics()) -----------------------------------

    @property
    def tok_s(self) -> float:
        return self._tok_s

    @property
    def mfu(self) -> float:
        if self.peak_flops > 0.0 and self.flops_per_token > 0.0:
            return self._tok_s * self.flops_per_token / self.peak_flops
        return 0.0

    def pad_fraction(self) -> float:
        """Cumulative padded-but-useless fraction of device step tokens
        for THIS engine (bucket-ladder waste across every step kind)."""
        if self.padded_total <= 0:
            return 0.0
        return 1.0 - self.useful_total / self.padded_total

    # -- export (off the serving path) ----------------------------------------

    def __len__(self) -> int:
        return len(self._recs)

    def drain(self, clear: bool = True) -> List[Dict[str, Any]]:
        """Collect the ring, oldest first, as JSONL-ready dicts."""
        recs = self._recs[self._pos:] + self._recs[:self._pos]
        if clear:
            self._recs, self._pos = [], 0
        keys = ("ts", "dt", "kind", "rows", "rows_live", "tokens_useful",
                "tokens_padded", "kv_used", "kv_total", "host_used",
                "host_total", "disk_used", "disk_total", "waiting",
                "recompiles", "stream_hit", "stream_late",
                "stream_spilled", "stream_stalls", "tok_s", "mfu")
        out = []
        for rec in recs:
            d = dict(zip(keys, rec))
            d["ts"] = round(d["ts"], 6)
            d["dt"] = round(d["dt"], 6)
            d["tok_s"] = round(d["tok_s"], 3)
            d["mfu"] = round(d["mfu"], 6)
            out.append(d)
        return out

    def write_jsonl(self, path: str, clear: bool = True) -> int:
        """Append the drained samples to a JSONL file, one record a line;
        returns the record count."""
        recs = self.drain(clear=clear)
        with open(path, "a") as f:
            for rec in recs:
                f.write(json.dumps(rec) + "\n")
        return len(recs)

    def summary(self) -> Dict[str, Any]:
        """Aggregate view over the resident ring."""
        recs = self.drain(clear=False)
        by_kind: Dict[str, int] = {}
        for r in recs:
            by_kind[r["kind"]] = by_kind.get(r["kind"], 0) + 1
        useful = sum(r["tokens_useful"] for r in recs)
        padded = sum(r["tokens_padded"] for r in recs)
        return {
            "samples": len(recs),
            "dropped": self.dropped,
            "steps_by_kind": by_kind,
            "tokens_useful": useful,
            "tokens_padded": padded,
            "pad_waste_frac": round(1.0 - useful / padded, 4)
            if padded else 0.0,
            "recompiles": sum(r["recompiles"] for r in recs),
            "kv_used_last": recs[-1]["kv_used"] if recs else 0,
            "tok_s_last": recs[-1]["tok_s"] if recs else 0.0,
        }
