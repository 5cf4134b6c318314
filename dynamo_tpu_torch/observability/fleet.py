"""Fleet time-series rollup + per-link KV-transfer cost model.

Copied from dynamo_tpu/observability/fleet.py. Where the per-step ledger
(observability/ledger.py) answers "what is THIS engine doing", the rollup
answers "what is the FLEET doing, over time": a scrape loop over the
`$STATS` plane (the same WorkerMetrics every router aggregator reads)
feeding fixed-interval ring series (observability/timeseries.py) per
worker and per fleet aggregate. `TransferCostModel` keeps per-link
KV-transfer bandwidth EWMAs, fed from the transfer backends' bytes /
duration samples (disagg/transfer.py, disagg/remote_transfer.py) and from
the pool service's page fetches (engine/pool_service.py, link
`pool:{host}`); the router's transfer-aware selector
(kv_router/scheduler.py) prices candidates with it. The SLO watchdog
(observability/slo.py) evaluates over the same store.

The cost model is process-global (`TRANSFER_MODEL`): any process that
ships KV pages grows a measured bandwidth table keyed by destination
engine id. The per-host link groups (`set_group`) are kept whole; no
caller of the port sets a group yet (the sharded multi-host sender is not
ported).
"""
from __future__ import annotations

import asyncio
import dataclasses
import logging
import time
from typing import Callable, Dict, List, Optional

from dynamo_tpu_torch.observability.timeseries import Ewma, SeriesStore

log = logging.getLogger("dynamo_tpu_torch.fleet")

# WorkerMetrics fields the rollup keeps per-worker history for (a
# deliberate subset: per-worker series cost capacity x fields buckets)
WORKER_FIELDS = (
    "kv_active_blocks", "kv_total_blocks", "request_active_slots",
    "num_requests_waiting", "gpu_cache_usage_perc", "engine_tok_s",
    "engine_mfu", "engine_pad_frac", "engine_recompiles",
    "kv_host_pages_used", "kv_transfer_bytes",
)


@dataclasses.dataclass
class TransferEstimate:
    """One router-facing cost answer. `cold` marks the no-data branch:
    the link has no measured EWMA yet and `bytes_per_s` fell back to the
    fleet median (or the configured default when NOTHING is measured) —
    never free, never infinite. Consumers must branch on it (dynalint
    R16): a cold estimate is a prior, not a measurement."""

    link: str
    seconds: float
    bytes_per_s: float
    cold: bool


class TransferCostModel:
    """Per-link KV-transfer bandwidth EWMAs, queryable by the router.

    A "link" is the destination engine/worker id of a KV page transfer
    (what `send_pages(engine_id, ...)` targets); the sample is the
    UNIQUE payload bytes of one completed send over its total wall
    seconds, so the EWMA tracks delivered goodput — integrity
    re-fetches and resume re-sends inflate the denominator without
    inflating the numerator, and a lossy link correctly estimates
    slower than its raw wire speed. `estimate(link, bytes)` is the
    router-facing query: what would shipping N bytes to this worker
    cost right now? Cold links (no EWMA yet) answer with the fleet
    median bandwidth and `cold=True` — a principled prior, neither a
    free pass nor an infinite penalty.

    The model also tracks per-destination transfer BACKLOG (bytes
    staged/in flight on sends not yet completed — `note_inflight` /
    `note_done` from the send path) and a per-link ESTIMATOR-ERROR
    EWMA (signed relative error of the pre-send estimate vs the
    actual transfer time), the diagnosis signal for routing
    regressions caused by a stale EWMA."""

    def __init__(self, alpha: float = 0.3,
                 default_bytes_per_s: float = 1e9,
                 min_sample_s: float = 1e-6):
        self.alpha = alpha
        self.default_bytes_per_s = default_bytes_per_s
        self.min_sample_s = min_sample_s
        self._links: Dict[str, Ewma] = {}
        self._err: Dict[str, Ewma] = {}
        self._inflight: Dict[str, int] = {}
        # sharded parallel transfer (disagg/remote_transfer.py): a
        # destination engine whose decode mesh spans multiple hosts is
        # a GROUP of per-host links ("{engine}/{host}"); estimate()
        # prices the parallel streams (bytes split per member, wall =
        # the slowest member) so the router sees multi-host decode
        # workers as genuinely faster targets
        self._groups: Dict[str, List[str]] = {}

    def observe(self, link: str, nbytes: int, seconds: float) -> None:
        if nbytes <= 0 or seconds < self.min_sample_s:
            return
        ew = self._links.get(link)
        if ew is None:
            ew = self._links[link] = Ewma(self.alpha)
        else:
            # estimator error BEFORE folding the sample in: how wrong
            # would the router's estimate have been for this transfer?
            # Signed relative error: >0 = over-estimated (link faster
            # than believed), <0 = under-estimated (stale-fast EWMA —
            # the dangerous direction for routing).
            est = nbytes / max(1.0, ew.value)
            err = self._err.get(link)
            if err is None:
                err = self._err[link] = Ewma(self.alpha)
            err.update((est - seconds) / max(seconds, self.min_sample_s))
        ew.update(nbytes / seconds)

    # -- in-flight backlog (per-destination queue depth in bytes) -------------

    def note_inflight(self, link: str, nbytes: int) -> None:
        """A send of `nbytes` toward `link` started; pair with
        note_done — the delta is the router's transfer-backlog term."""
        self._inflight[link] = self._inflight.get(link, 0) + max(0, nbytes)

    def note_done(self, link: str, nbytes: int) -> None:
        left = self._inflight.get(link, 0) - max(0, nbytes)
        if left > 0:
            self._inflight[link] = left
        else:
            self._inflight.pop(link, None)

    def backlog_bytes(self, link: str) -> int:
        return self._inflight.get(link, 0)

    # -- queries --------------------------------------------------------------

    def bandwidth_bytes_per_s(self, link: str) -> float:
        ew = self._links.get(link)
        if ew is None or ew.value is None:
            # no-data branch: fleet-median prior (default when nothing
            # anywhere is measured)
            return self.fleet_median_bytes_per_s()
        return ew.value

    def fleet_median_bytes_per_s(self) -> float:
        """Median measured bandwidth across links; the cold-link prior.
        Falls back to default_bytes_per_s when no link is measured."""
        vals = sorted(ew.value for ew in self._links.values()
                      if ew.value is not None)
        if not vals:
            return self.default_bytes_per_s
        return vals[len(vals) // 2]

    def measured(self, link: str) -> bool:
        ew = self._links.get(link)
        return ew is not None and ew.samples > 0

    # -- sharded parallel streams (per-host link groups) ----------------------

    def set_group(self, link: str, members: List[str]) -> None:
        """Register `link` (a destination engine id) as a group of
        per-host member links: transfers to it ride N parallel streams,
        one per (shard, host), so its cost is the parallel composition
        of the members' — registered by the sender when discovery shows
        per-host `kv_transfer/{engine}/{host}` endpoints."""
        if len(members) >= 2:
            self._groups[link] = list(members)
        else:
            self._groups.pop(link, None)

    def group_members(self, link: str) -> Optional[List[str]]:
        return self._groups.get(link)

    def estimate(self, link: str, nbytes: int) -> TransferEstimate:
        """Cost of shipping `nbytes` to `link` now, cold-aware: a
        never-measured link answers at the fleet-median bandwidth with
        cold=True — it can never score as free (bytes always cost
        time) nor as infinitely penalized (the prior is finite).

        A GROUP link (multi-host sharded target, set_group) prices the
        parallel streams: bytes split evenly per member, wall-clock =
        the SLOWEST member's share time (the min-frontier straggler
        bound), aggregate bandwidth reported as the sum of member
        EWMAs; cold only when every member is cold (the measured/
        cold/median vocabulary of dynalint R16 applies member-wise)."""
        members = self._groups.get(link)
        if members:
            share = max(0, nbytes) / len(members)
            worst = 0.0
            agg_bw = 0.0
            cold = True
            for m in members:
                e = self.estimate(m, int(share))
                worst = max(worst, e.seconds)
                agg_bw += e.bytes_per_s
                cold = cold and e.cold
            return TransferEstimate(link=link, seconds=worst,
                                    bytes_per_s=agg_bw, cold=cold)
        cold = not self.measured(link)
        bw = max(1.0, self.bandwidth_bytes_per_s(link))
        return TransferEstimate(link=link, seconds=max(0, nbytes) / bw,
                                bytes_per_s=bw, cold=cold)

    def estimate_s(self, link: str, nbytes: int) -> float:
        # cold fallback handled inside estimate() (fleet-median prior)
        return self.estimate(link, nbytes).seconds

    def queue_s(self, link: str) -> float:
        """Drain time of the bytes already in flight toward `link` —
        the per-destination transfer-backlog term of the router score.
        Cold-safe: rides the same fleet-median prior as estimate().
        Group links (sharded multi-host targets) answer with the WORST
        member host's drain time: backlog is tracked per destination
        host, and the slowest host's queue is what gates a parallel
        transfer's min frontier."""
        members = self._groups.get(link)
        if members:
            return max((self.queue_s(m) for m in members), default=0.0)
        backlog = self.backlog_bytes(link)
        if backlog <= 0:
            return 0.0
        return self.estimate(link, backlog).seconds

    def est_err_frac(self, link: str) -> Optional[float]:
        """Signed relative estimator error EWMA for one link (None
        until a second sample exists)."""
        err = self._err.get(link)
        return err.value if err is not None else None

    def mean_abs_est_err(self) -> float:
        vals = [abs(e.value) for e in self._err.values()
                if e.value is not None]
        return sum(vals) / len(vals) if vals else 0.0

    def links(self) -> List[str]:
        return sorted(self._links)

    def snapshot(self) -> Dict[str, dict]:
        out = {}
        for link, ew in sorted(self._links.items()):
            if ew.value is None:
                continue
            row = {"bytes_per_s": round(ew.value, 1),
                   "samples": ew.samples}
            err = self._err.get(link)
            if err is not None and err.value is not None:
                row["est_err_frac"] = round(err.value, 4)
            if self._inflight.get(link):
                row["backlog_bytes"] = self._inflight[link]
            out[link] = row
        return out

    def reset(self) -> None:
        self._links.clear()
        self._err.clear()
        self._inflight.clear()
        self._groups.clear()


TRANSFER_MODEL = TransferCostModel()


def _health_snapshot() -> dict:
    """Fail-slow table for the rollup summary: the HealthScorer's
    per-worker score/z/evidence/SLOW rows plus the process hedge
    counters (runtime/health.py)."""
    from dynamo_tpu_torch.runtime.health import HEALTH, HEDGE_STATS
    snap = HEALTH.snapshot()
    snap["hedges"] = HEDGE_STATS.snapshot()
    return snap


def parse_prometheus_text(text: str) -> Dict[str, Dict[str, float]]:
    """Minimal Prometheus text-exposition parser: family name ->
    {label-string -> value}. HELP/TYPE lines are recorded as presence
    (empty dict) so a family with no series still shows up — what the
    docs-catalog completeness test keys on. Histogram _bucket/_sum/
    _count sample names roll up under their family name."""
    out: Dict[str, Dict[str, float]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 3 and parts[1] in ("HELP", "TYPE"):
                out.setdefault(parts[2], {})
            continue
        name_labels, _, value = line.rpartition(" ")
        name, labels = name_labels, ""
        if "{" in name_labels:
            name, _, rest = name_labels.partition("{")
            labels = "{" + rest
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[:-len(suffix)] in out:
                name = name[:-len(suffix)]
                break
        try:
            out.setdefault(name, {})[labels] = float(value)
        except ValueError:
            continue
    return out


async def scrape_http_metrics(host: str, port: int,
                              timeout_s: float = 5.0
                              ) -> Dict[str, Dict[str, float]]:
    """One GET /metrics against a frontend or exporter, parsed."""
    reader, writer = await asyncio.wait_for(
        asyncio.open_connection(host, port), timeout_s)
    try:
        writer.write(b"GET /metrics HTTP/1.1\r\nhost: fleet\r\n"
                     b"connection: close\r\n\r\n")
        await asyncio.wait_for(writer.drain(), timeout_s)
        raw = await asyncio.wait_for(reader.read(), timeout_s)
    finally:
        writer.close()
    body = raw.split(b"\r\n\r\n", 1)[-1].decode(errors="replace")
    return parse_prometheus_text(body)


class FleetRollup:
    """The scrape loop: `$STATS` plane -> SeriesStore history.

    One `scrape_once(ts)` polls every live worker's WorkerMetrics
    through the runtime Client (the same fan-out KvMetricsAggregator
    does), records per-worker series for WORKER_FIELDS, fleet
    aggregates, the serving-path histogram quantiles (TTFT/ITL p95/p99
    via Histogram.quantile — the series the SLO specs evaluate), the
    control-plane health fields, and the TransferCostModel's per-link
    bandwidth EWMAs. Explicit `ts` keeps it virtual-clock testable."""

    def __init__(self, client, store: Optional[SeriesStore] = None,
                 interval_s: float = 1.0,
                 model: Optional[TransferCostModel] = None,
                 expected_workers: Optional[int] = None,
                 clock: Callable[[], float] = time.time):
        self.client = client
        self.store = store if store is not None else SeriesStore(
            interval_s=interval_s)
        self.interval_s = interval_s
        self.model = model if model is not None else TRANSFER_MODEL
        self.expected_workers = expected_workers
        self.clock = clock
        self.scrapes = 0
        self._task: Optional[asyncio.Task] = None

    async def scrape_once(self, ts: Optional[float] = None) -> dict:
        from dynamo_tpu_torch.kv_router.scoring import WorkerMetrics
        from dynamo_tpu_torch.runtime.cpstats import CP_STATS
        if ts is None:
            ts = self.clock()
        stats = await self.client.scrape_stats()
        rec = self.store.record
        workers: Dict[str, WorkerMetrics] = {}
        for worker_id, payload in stats.items():
            try:
                m = WorkerMetrics.from_dict(payload)
            except (TypeError, KeyError):
                continue
            workers[worker_id] = m
            for field in WORKER_FIELDS:
                rec(f"worker/{worker_id}/{field}",
                    float(getattr(m, field)), ts)
        live = len(workers)
        rec("fleet/workers_live", live, ts)
        if self.expected_workers:
            rec("fleet/availability", live / self.expected_workers, ts)
        if workers:
            rec("fleet/kv_usage_avg",
                sum(m.gpu_cache_usage_perc for m in workers.values())
                / live, ts)
            rec("fleet/waiting_total",
                sum(m.num_requests_waiting for m in workers.values()), ts)
            rec("fleet/tok_s_total",
                sum(m.engine_tok_s for m in workers.values()), ts)
            rec("fleet/recompiles_total",
                sum(m.engine_recompiles for m in workers.values()), ts)
        # per-role aggregates: the prefill/decode split read once here,
        # from the instance-key role field, so every consumer reads one
        # schema instead of re-deriving it. Draining counts come from the
        # watch-maintained instance info (a draining worker still
        # answers $STATS, so it appears in `workers` too).
        from dynamo_tpu_torch.runtime.component import (
            STATUS_DRAINING, instance_role, instance_status,
        )
        instances = getattr(self.client, "instances", None) or {}
        role_members: Dict[str, list] = {}
        role_draining: Dict[str, int] = {}
        for worker_id, info in instances.items():
            role = instance_role(info)
            if role is None:
                continue
            if instance_status(info) == STATUS_DRAINING:
                role_draining[role] = role_draining.get(role, 0) + 1
                role_members.setdefault(role, [])
            elif worker_id in workers:
                role_members.setdefault(role, []).append(workers[worker_id])
            else:
                role_members.setdefault(role, [])
        for role, members in role_members.items():
            ready = len(members)
            drn = role_draining.get(role, 0)
            rec(f"role/{role}/workers", float(ready), ts)
            rec(f"role/{role}/draining", float(drn), ts)
            rec(f"role/{role}/availability",
                ready / max(1, ready + drn), ts)
            if members:
                rec(f"role/{role}/queue_depth",
                    float(sum(m.num_requests_waiting for m in members)), ts)
                total_slots = sum(m.request_total_slots for m in members)
                rec(f"role/{role}/occupancy",
                    sum(m.request_active_slots for m in members)
                    / max(1, total_slots), ts)
        # serving-path latency quantiles (the SLO evaluator's TTFT/ITL
        # sources; Histogram.quantile — observability/metrics.py)
        from dynamo_tpu_torch.observability.serving import SERVING
        for name, hist, q in (("serving/ttft_p95", SERVING.ttft, 0.95),
                              ("serving/itl_p99", SERVING.itl, 0.99)):
            qv = hist.quantile_all(q)
            if qv == qv:  # not NaN: at least one observation exists
                rec(name, qv, ts)
        # per-QoS-class serving series: the same quantiles partitioned
        # by the histograms' qos label — the series the per-class
        # SloSpecs (observability/slo.qos_slo_specs) evaluate, so the
        # watchdog pages per tenant class
        for name, hist, q in (("ttft_p95", SERVING.ttft, 0.95),
                              ("itl_p99", SERVING.itl, 0.99)):
            for cls in hist.label_values("qos"):
                qv = hist.quantile_label(q, "qos", cls)
                if qv == qv:
                    rec(f"qos/{cls}/{name}", qv, ts)
        for cls in SERVING.queue_wait.label_values("qos"):
            qv = SERVING.queue_wait.quantile_label(0.95, "qos", cls)
            if qv == qv:
                rec(f"qos/{cls}/queue_wait_p95", qv, ts)
        # control-plane health + event-plane lag (degraded-mode context
        # the SLO watchdog reads)
        rec("cp/event_lag_seconds", float(CP_STATS.event_lag_seconds), ts)
        rec("cp/router_degraded", float(CP_STATS.router_degraded), ts)
        # per-link measured transfer bandwidth (the router-scoring feed)
        for link, snap in self.model.snapshot().items():
            rec(f"link/{link}/bytes_per_s", snap["bytes_per_s"], ts)
        # fail-slow health plane (runtime/health.py): per-worker score
        # series + the fleet SLOW count, so a gray failure shows up as
        # history (when did this worker start sinking?) and not just as
        # the breaker's current flag
        from dynamo_tpu_torch.runtime.health import HEALTH
        hsnap = HEALTH.snapshot()
        for wid, row in hsnap["workers"].items():
            rec(f"health/{wid}/score", row["score"], ts)
        rec("fleet/workers_slow", float(len(hsnap["slow"])), ts)
        self.scrapes += 1
        return {"ts": ts, "workers": live,
                "links": len(self.model.links())}

    async def start(self) -> "FleetRollup":
        async def loop():
            # dynalint: backoff-ok=fixed-cadence rollup scrape; a failed
            # cycle logs and the next tick retries at the same cadence
            while True:
                try:
                    await self.scrape_once()
                except asyncio.CancelledError:
                    raise
                except Exception:
                    log.exception("fleet rollup scrape failed")
                await asyncio.sleep(self.interval_s)
        self._task = asyncio.create_task(loop())
        return self

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    # -- rendering / evidence -------------------------------------------------

    def summary(self, window_s: float = 60.0,
                ts: Optional[float] = None) -> dict:
        """One rollup snapshot: fleet aggregates over the window plus
        the link table."""
        if ts is None:
            ts = self.clock()
        st = self.store

        def agg(name):
            s = st.get(name)
            if s is None:
                return None
            return {"last": s.latest(),
                    "avg": round(a, 4) if (a := s.avg(window_s, ts))
                    is not None else None,
                    "max": s.max(window_s, ts)}

        workers = sorted({n.split("/")[1]
                          for n in st.names("worker/")})
        roles: Dict[str, dict] = {}
        for name in st.names("role/"):
            _, role, field = name.split("/", 2)
            roles.setdefault(role, {})[field] = agg(name)
        qos: Dict[str, dict] = {}
        for name in st.names("qos/"):
            _, cls, field = name.split("/", 2)
            qos.setdefault(cls, {})[field] = agg(name)
        return {
            "ts": round(ts, 3),
            "scrapes": self.scrapes,
            "workers_seen": len(workers),
            "fleet": {name.split("/", 1)[1]: agg(name)
                      for name in st.names("fleet/")},
            "serving": {name.split("/", 1)[1]: agg(name)
                        for name in st.names("serving/")},
            "cp": {name.split("/", 1)[1]: agg(name)
                   for name in st.names("cp/")},
            "roles": roles,
            "qos": qos,
            "links": self.model.snapshot(),
            # fail-slow health table (runtime/health.py HEALTH): score/
            # z/evidence/SLOW per worker plus hedge counters
            "health": _health_snapshot(),
            # per-(shard, host) transfer-stream rows: the sharded
            # multi-host sender that records them is not ported, so the
            # table is empty (the JAX summary's shape is kept)
            "xfer_streams": {},
        }

    def per_role(self) -> Dict[str, dict]:
        """Latest per-role aggregates (the controller's sensor view)."""
        out: Dict[str, dict] = {}
        for name in self.store.names("role/"):
            _, role, field = name.split("/", 2)
            series = self.store.get(name)
            latest = series.latest() if series is not None else None
            if latest is not None:
                out.setdefault(role, {})[field] = latest
        return out
