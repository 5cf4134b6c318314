"""The port's telemetry plane (dynamo_tpu_torch/observability: timeseries,
fleet.TransferCostModel, ledger, slo, metrics.Histogram quantiles) against
the JAX package's, on the CPU, and the engine's step ledger against the JAX
engine's.

Each unit case runs the same inputs (seeded or literal, as in
tests/test_telemetry.py) through the JAX object and its port counterpart
and holds the outputs equal, then keeps the JAX test's own assertions on
the port's. Tolerance: exact equality everywhere (the modules are the same
pure-Python arithmetic), except where the JAX test itself states an
approx.

The engine cases run the tiny f32 engine through JAX (its gather decode)
and the port with the same requests (greedy, seeded-sampled, chunked,
mixed, speculative n-gram, one streamed request) and hold the drained
ledger samples equal field for field except the timing fields (ts, dt,
tok_s, mfu), the first-seen program keys equal key for key, and
engine_steps / engine_recompiles / engine_pad_frac equal. With
DYN_LEDGER=0 the port's streams are unchanged and it records nothing.
"""
import math

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.observability import fleet as jfleet
from dynamo_tpu.observability import ledger as jledger
from dynamo_tpu.observability import metrics as jmetrics
from dynamo_tpu.observability import slo as jslo
from dynamo_tpu.observability import timeseries as jts
from dynamo_tpu_torch.observability import fleet as tfleet
from dynamo_tpu_torch.observability import ledger as tledger
from dynamo_tpu_torch.observability import metrics as tmetrics
from dynamo_tpu_torch.observability import slo as tslo
from dynamo_tpu_torch.observability import timeseries as tts

torch.set_num_threads(1)

JAX = {"ts": jts, "fleet": jfleet, "ledger": jledger, "metrics": jmetrics,
       "slo": jslo}
PORT = {"ts": tts, "fleet": tfleet, "ledger": tledger, "metrics": tmetrics,
        "slo": tslo}


def both(fn):
    """fn(modules) on the JAX modules and the port's; the two results must
    be equal. Returns the port's."""
    want, got = fn(JAX), fn(PORT)
    assert got == want
    return got


@pytest.fixture(autouse=True)
def _reset_transfer_models():
    jfleet.TRANSFER_MODEL.reset()
    tfleet.TRANSFER_MODEL.reset()
    yield
    jfleet.TRANSFER_MODEL.reset()
    tfleet.TRANSFER_MODEL.reset()


# -- TimeSeries ----------------------------------------------------------------

def test_timeseries_bucketing_and_window():
    def run(m):
        s = m["ts"].TimeSeries(interval_s=1.0, capacity=8)
        s.record(1.0, ts=10.2)
        s.record(2.0, ts=10.9)       # same bucket, reduce=last wins
        s.record(5.0, ts=12.5)       # gap at bucket 11
        return (s.latest(), s.window(3.0, ts=12.9), s.avg(3.0, ts=12.9),
                s.max(3.0, ts=12.9))
    latest, win, avg, mx = both(run)
    assert latest == 5.0
    assert win == [2.0, 5.0]
    assert avg == pytest.approx(3.5)
    assert mx == 5.0


def test_timeseries_wraparound_hides_stale_buckets():
    def run(m):
        s = m["ts"].TimeSeries(interval_s=1.0, capacity=4)
        for t in range(8):
            s.record(float(t), ts=float(t))
        return s.window(10.0, ts=7.5)
    assert both(run) == [4.0, 5.0, 6.0, 7.0]


def test_timeseries_reduce_modes_and_frac():
    def run(m):
        TS = m["ts"].TimeSeries
        mx = TS(interval_s=1.0, capacity=8, reduce="max")
        sm = TS(interval_s=1.0, capacity=8, reduce="sum")
        for v in (1.0, 3.0, 2.0):
            mx.record(v, ts=0.5)
            sm.record(v, ts=0.5)
        s = TS(interval_s=1.0, capacity=8)
        for t, v in ((0, 1.0), (1, 9.0), (2, 9.0), (3, 1.0)):
            s.record(v, ts=float(t))
        return (mx.latest(), sm.latest(),
                s.frac_where(lambda v: v > 5.0, 4.0, ts=3.5),
                s.frac_where(lambda v: v > 5.0, 4.0, ts=3.5, min_samples=5))
    assert both(run) == (3.0, 6.0, 0.5, None)


def test_series_store_get_or_make_and_names():
    def run(m):
        st = m["ts"].SeriesStore(interval_s=1.0, capacity=16)
        st.record("worker/w0/kv", 3.0, ts=1.0)
        st.record("fleet/live", 8.0, ts=1.0)
        return (st.names("worker/"), st.get("fleet/live").latest(),
                st.get("absent"), len(st))
    assert both(run) == (["worker/w0/kv"], 8.0, None, 2)


def test_ewma_none_until_first_sample():
    def run(m):
        e = m["ts"].Ewma(alpha=0.5)
        first = e.value
        e.update(10.0)
        e.update(20.0)
        return first, e.value, e.samples
    first, value, samples = both(run)
    assert first is None
    assert value == pytest.approx(15.0)
    assert samples == 2


# -- TransferCostModel ---------------------------------------------------------

def test_transfer_cost_model_ewma_and_estimate():
    def run(m):
        cm = m["fleet"].TransferCostModel(alpha=0.5, default_bytes_per_s=1e9)
        out = [cm.bandwidth_bytes_per_s("w9"), cm.measured("w9")]
        cm.observe("w0", nbytes=10_000_000, seconds=0.01)   # 1 GB/s
        cm.observe("w0", nbytes=5_000_000, seconds=0.01)    # 0.5 GB/s
        out += [cm.measured("w0"), cm.bandwidth_bytes_per_s("w0"),
                cm.estimate_s("w0", 75_000_000)]
        # degenerate samples are dropped, not divided by
        cm.observe("w0", nbytes=0, seconds=1.0)
        cm.observe("w0", nbytes=100, seconds=0.0)
        return out + [cm.snapshot(), cm.links()]
    bw9, m9, m0, bw0, est, snap, links = both(run)
    assert bw9 == 1e9 and not m9 and m0
    assert bw0 == pytest.approx(7.5e8)
    assert est == pytest.approx(0.1)
    assert snap["w0"]["samples"] == 2
    assert links == ["w0"]


def test_transfer_cost_model_cold_start_fleet_median():
    """A never-measured link estimates at the fleet-median bandwidth with
    cold=True: neither free nor infinitely penalized."""
    def run(m):
        cm = m["fleet"].TransferCostModel(default_bytes_per_s=1e9)
        est0 = cm.estimate("ghost", 1_000_000)
        cm.observe("slow", 1_000_000, 1.0)     # 1 MB/s
        cm.observe("mid", 10_000_000, 1.0)     # 10 MB/s
        cm.observe("fast", 100_000_000, 1.0)   # 100 MB/s
        est = cm.estimate("ghost", 10_000_000)
        return ((est0.cold, est0.seconds), cm.fleet_median_bytes_per_s(),
                (est.cold, est.seconds, est.bytes_per_s, est.link),
                cm.estimate("fast", 1).cold,
                cm.estimate_s("ghost", 10_000_000))
    (c0, s0), med, est, fast_cold, est_s = both(run)
    assert c0 and s0 == pytest.approx(1e-3)
    assert med == pytest.approx(1e7)
    assert est[0] and est[1] == pytest.approx(1.0) and est[1] > 0.0
    assert not fast_cold
    assert est_s == pytest.approx(1.0)


def test_transfer_cost_model_backlog_and_estimator_error():
    def run(m):
        cm = m["fleet"].TransferCostModel(alpha=0.5)
        cm.observe("w0", 10_000_000, 1.0)      # believes 10 MB/s
        cm.observe("w0", 10_000_000, 1.0)
        e0 = cm.est_err_frac("w0")
        cm.observe("w0", 10_000_000, 2.0)
        out = [e0, cm.est_err_frac("w0"), cm.mean_abs_est_err(),
               cm.snapshot()]
        cm.note_inflight("w0", 5_000_000)
        out += [cm.backlog_bytes("w0"), cm.queue_s("w0"), cm.snapshot()]
        cm.note_done("w0", 5_000_000)
        return out + [cm.backlog_bytes("w0"), cm.queue_s("w0")]
    e0, e1, mae, snap, backlog, q, snap2, backlog2, q2 = both(run)
    assert e0 == pytest.approx(0.0, abs=1e-6)
    assert e1 < 0.0 and mae > 0.0
    assert "est_err_frac" in snap["w0"]
    assert backlog == 5_000_000 and q > 0.0
    assert snap2["w0"]["backlog_bytes"] == 5_000_000
    assert backlog2 == 0 and q2 == 0.0


def test_transfer_cost_model_group_links():
    """The per-host link groups, kept whole: a group prices its members'
    parallel streams (bytes split, the slowest member's time)."""
    def run(m):
        cm = m["fleet"].TransferCostModel()
        cm.observe("e/h0", 10_000_000, 1.0)
        cm.observe("e/h1", 40_000_000, 1.0)
        cm.set_group("e", ["e/h0", "e/h1"])
        est = cm.estimate("e", 20_000_000)
        cm.note_inflight("e/h0", 5_000_000)
        out = (est.seconds, est.bytes_per_s, est.cold, cm.queue_s("e"),
               cm.group_members("e"))
        cm.set_group("e", ["e/h0"])
        return out + (cm.group_members("e"),)
    secs, bw, cold, q, members, after = both(run)
    assert secs == pytest.approx(1.0) and bw == pytest.approx(5e7)
    assert not cold and q == pytest.approx(0.5)
    assert members == ["e/h0", "e/h1"] and after is None


# -- Histogram.quantile --------------------------------------------------------

def test_quantile_boundary_exactness_and_interpolation():
    def run(m):
        h = m["metrics"].Histogram("q", "h",
                                   buckets=(1.0, 2.0, 4.0, float("inf")))
        for v in (0.5, 1.5, 1.5, 3.0):
            h.observe(value=v)
        return [h.quantile(q) for q in (0.25, 0.75, 0.5, 1.0)]
    q25, q75, q50, q100 = both(run)
    assert q25 == 1.0 and q75 == 2.0
    assert q50 == pytest.approx(1.5)
    assert q100 == 4.0


def test_quantile_inf_bucket_reports_largest_finite_bound():
    def run(m):
        h = m["metrics"].Histogram("q2", "h", buckets=(1.0, float("inf")))
        h.observe(value=50.0)
        return h.quantile(0.5), h.quantile(0.99)
    assert both(run) == (1.0, 1.0)


def test_quantile_empty_and_labels_and_all():
    def run(m):
        h = m["metrics"].Histogram("q3", "h", ("model",),
                                   buckets=(1.0, 2.0, float("inf")))
        empty = h.quantile(0.5, "m")
        h.observe("a", value=0.5)
        h.observe("b", value=1.5)
        with pytest.raises(ValueError):
            h.quantile(0.0, "a")
        return (math.isnan(empty), h.quantile(0.5, "a"),
                h.quantile(0.5, "b"), h.quantile_all(1.0))
    nan, qa, qb, qall = both(run)
    assert nan
    assert qa == pytest.approx(0.5) and qb == pytest.approx(1.5)
    assert qall == 2.0


# -- StepLedger ----------------------------------------------------------------

TIMING = ("ts", "dt", "tok_s", "mfu")


def _sample(ledger, kind="decode", useful=4, padded=16, recomp=0):
    ledger.record_step(kind, rows=4, rows_live=2, useful=useful,
                       padded=padded, kv_used=3, kv_total=32,
                       host_used=0, host_total=0, disk_used=0,
                       disk_total=0, waiting=1, recompiles=recomp)


def _untimed(recs):
    return [{k: v for k, v in r.items() if k not in TIMING} for r in recs]


def test_ledger_ring_bounds_and_drain_order():
    def run(m):
        st = m["ledger"].LedgerStats()
        led = m["ledger"].StepLedger(capacity=4, enabled=True, stats=st)
        for i in range(6):
            _sample(led, useful=i)
        n, dropped = len(led), led.dropped
        recs = _untimed(led.drain())
        return (n, dropped, recs, len(led), st.steps_total,
                st.samples_dropped)
    n, dropped, recs, after, steps, sdropped = both(run)
    assert n == 4 and dropped == 2
    assert [r["tokens_useful"] for r in recs] == [2, 3, 4, 5]
    assert after == 0 and steps == 6 and sdropped == 2


def test_ledger_disabled_is_branch_only():
    def run(m):
        st = m["ledger"].LedgerStats()
        led = m["ledger"].StepLedger(capacity=8, enabled=False, stats=st)
        _sample(led)
        return len(led), led.steps, st.steps_total
    assert both(run) == (0, 0, 0)


def test_ledger_per_kind_padding_attribution_and_pad_fraction():
    def run(m):
        st = m["ledger"].LedgerStats()
        led = m["ledger"].StepLedger(capacity=32, enabled=True, stats=st)
        _sample(led, kind="prefill", useful=10, padded=16)
        _sample(led, kind="mixed", useful=6, padded=32)
        _sample(led, kind="decode", useful=4, padded=16, recomp=2)
        _sample(led, kind="spec", useful=5, padded=10)
        _sample(led, kind="stream", useful=1, padded=1)
        s = led.summary()
        s.pop("tok_s_last")
        snap = st.snapshot()
        snap.pop("tok_s")
        return snap, led.pad_fraction(), s
    snap, pad, s = both(run)
    assert snap["useful_tokens_prefill"] == 10
    assert snap["padded_tokens_mixed"] == 32
    assert snap["recompiles"] == 2
    # spec and stream steps charge the decode split
    assert snap["useful_tokens_decode"] == 10
    assert snap["steps_spec"] == 1 and snap["steps_stream"] == 1
    assert pad == pytest.approx(1.0 - 26 / 75)
    assert s["steps_by_kind"] == {"prefill": 1, "mixed": 1, "decode": 1,
                                  "spec": 1, "stream": 1}
    assert s["recompiles"] == 2


def test_ledger_mfu_needs_peak_and_flops():
    from dynamo_tpu.engine.config import get_model_config as jget
    from dynamo_tpu_torch.engine.config import get_model_config as tget
    for name in ("tiny", "llama3-8b", "tiny-moe"):
        j, t = jget(name), tget(name)
        assert tledger.model_flops_per_token(t) \
            == jledger.model_flops_per_token(j)
        assert tledger.sampler_flops_per_token(t) \
            == jledger.sampler_flops_per_token(j)

    def run(m):
        fpt = m["ledger"].model_flops_per_token(
            (jget if m is JAX else tget)("tiny"))
        led = m["ledger"].StepLedger(capacity=8, enabled=True,
                                     stats=m["ledger"].LedgerStats(),
                                     flops_per_token=fpt)
        mfu0 = led.mfu
        led.configure(peak_tflops=1.0)
        led._tok_s = 1000.0
        return fpt, mfu0, led.mfu
    fpt, mfu0, mfu = both(run)
    assert fpt > 0 and mfu0 == 0.0
    assert mfu == pytest.approx(1000.0 * fpt / 1e12)


def test_ledger_jsonl_write(tmp_path):
    import json

    def run(m):
        led = m["ledger"].StepLedger(capacity=8, enabled=True,
                                     stats=m["ledger"].LedgerStats())
        _sample(led)
        _sample(led)
        path = tmp_path / f"LEDGER_{id(m)}.jsonl"
        n = led.write_jsonl(str(path))
        return n, _untimed(json.loads(line) for line in open(path))
    n, rows = both(run)
    assert n == 2
    assert rows[0]["kind"] == "decode"
    assert set(rows[0]) >= {"kind", "tokens_useful", "tokens_padded",
                            "kv_used", "recompiles"}


# -- SLO watchdog --------------------------------------------------------------

def _run_plan(m, seed, spec_kw=None, degraded_fn=None):
    slo, ts = m["slo"], m["ts"]
    store = ts.SeriesStore(interval_s=1.0, capacity=600)
    for t, v in slo.seeded_storm_plan(seed, n_intervals=120, storm_start=40,
                                      storm_len=40, good_value=0.05,
                                      bad_value=2.0):
        store.record("serving/ttft_p95", v, t)
    kw = dict(name="ttft_p95", series="serving/ttft_p95", objective=0.5,
              target=0.9, short_window_s=10, long_window_s=30,
              burn_threshold=2.0)
    kw.update(spec_kw or {})
    wd = slo.SloWatchdog(store, [slo.SloSpec(**kw)],
                         degraded_fn=degraded_fn or (lambda: False))
    events = []
    for t in range(120):
        events.extend(wd.evaluate(float(t)))
    return wd, events


def test_slo_fire_clear_transition_is_deterministic_from_seeded_plan():
    def run(m):
        runs = [_run_plan(m, 7) for _ in range(2)]
        assert runs[0][1] == runs[1][1]           # bit-identical timelines
        wd, events = runs[0]
        return events, wd.firing(), wd.states["ttft_p95"].transitions
    events, firing, transitions = both(run)
    assert [e["event"] for e in events] == ["fire", "clear"]
    fire, clear = events
    assert 40 <= fire["ts"] < 80 and clear["ts"] > 80
    assert not firing and transitions == 2


def test_slo_short_spike_alone_does_not_fire():
    def run(m):
        store = m["ts"].SeriesStore(interval_s=1.0, capacity=600)
        for t in range(120):
            store.record("s", 2.0 if 50 <= t < 54 else 0.05, float(t))
        wd = m["slo"].SloWatchdog(store, [m["slo"].SloSpec(
            name="x", series="s", objective=0.5, target=0.9,
            short_window_s=4, long_window_s=60, burn_threshold=2.0)],
            degraded_fn=lambda: False)
        events = []
        for t in range(120):
            events.extend(wd.evaluate(float(t)))
        return events, wd.states["x"].transitions
    assert both(run) == ([], 0)


def test_slo_missing_data_yields_no_verdict():
    def run(m):
        store = m["ts"].SeriesStore(interval_s=1.0, capacity=600)
        wd = m["slo"].SloWatchdog(store, [m["slo"].SloSpec(
            name="x", series="s", objective=0.5, target=0.9,
            short_window_s=5, long_window_s=10, min_samples=3)],
            degraded_fn=lambda: False)
        st = wd.states["x"]
        return wd.evaluate(10.0), st.burn_short, st.burn_long, st.firing
    assert both(run) == ([], None, None, False)


def test_slo_degraded_exempt_freezes_state():
    def run(m):
        degraded = {"on": False}
        store = m["ts"].SeriesStore(interval_s=1.0, capacity=600)
        for t, v in m["slo"].seeded_storm_plan(3, storm_start=40,
                                               storm_len=40, good_value=0.05,
                                               bad_value=2.0):
            store.record("s", v, t)
        wd = m["slo"].SloWatchdog(store, [m["slo"].SloSpec(
            name="lag", series="s", objective=0.5, target=0.9,
            short_window_s=10, long_window_s=30, burn_threshold=2.0,
            degraded_exempt=True)], degraded_fn=lambda: degraded["on"])
        events = []
        for t in range(120):
            degraded["on"] = 35 <= t < 95
            events.extend(wd.evaluate(float(t)))
        return events, wd.states["lag"].suppressed
    events, suppressed = both(run)
    assert events == [] and suppressed > 0


def test_slo_below_mode_and_gauges_render():
    def run(m):
        store = m["ts"].SeriesStore(interval_s=1.0, capacity=600)
        for t in range(40):
            store.record("bw", 2e7 if t >= 20 else 1e9, float(t))
        wd = m["slo"].SloWatchdog(store, [m["slo"].SloSpec(
            name="bw_floor", series="bw", objective=1e8, mode="below",
            target=0.9, short_window_s=5, long_window_s=15,
            burn_threshold=2.0)], degraded_fn=lambda: False)
        for t in range(40):
            wd.evaluate(float(t))
        return wd.firing(), wd.render(), wd.summary()
    firing, body, _ = both(run)
    assert firing == ["bw_floor"]
    assert 'llm_slo_firing{slo="bw_floor"} 1' in body
    assert "# HELP llm_slo_burn_rate_short" in body


def test_slo_alert_event_shape_and_on_alert():
    def run(m):
        _, events = _run_plan(m, 11)
        seen = []
        store = m["ts"].SeriesStore(interval_s=1.0, capacity=600)
        for t, v in m["slo"].seeded_storm_plan(11):
            store.record("serving/ttft_p95", v, t)
        wd3 = m["slo"].SloWatchdog(store, [m["slo"].SloSpec(
            name="ttft_p95", series="serving/ttft_p95", objective=0.5,
            target=0.9, short_window_s=10, long_window_s=30)],
            on_alert=seen.append, degraded_fn=lambda: False)
        for t in range(120):
            wd3.evaluate(float(t))
        return events[0], seen
    ev, seen = both(run)
    assert set(ev) >= {"event", "slo", "ts", "series", "objective",
                       "burn_short", "burn_long", "threshold"}
    assert [e["event"] for e in seen] == ["fire", "clear"]


def test_slo_duplicate_names_rejected():
    for m in (JAX, PORT):
        store = m["ts"].SeriesStore()
        spec = m["slo"].SloSpec(name="a", series="s", objective=1.0)
        with pytest.raises(ValueError):
            m["slo"].SloWatchdog(store, [spec, m["slo"].SloSpec(
                name="a", series="t", objective=2.0)])


def test_slo_event_plane_wiring_packs_like_msgpack():
    """wire_event_plane publishes each alert on the subject; the port's
    codec bytes equal msgpack's, so a JAX subscriber decodes them."""
    import asyncio

    import msgpack
    published = {}

    class Messaging:
        def __init__(self, key):
            self.key = key

        async def publish(self, subject, payload):
            published.setdefault(self.key, []).append((subject, payload))

    async def go(m, key):
        wd, _ = _run_plan(m, 7)
        store = wd.store
        wd2 = m["slo"].SloWatchdog(store, list(wd.specs),
                                   degraded_fn=lambda: False)
        m["slo"].wire_event_plane(wd2, Messaging(key), "ns.slo.alerts")
        for t in range(120):
            wd2.evaluate(float(t))
        await asyncio.sleep(0)
    asyncio.run(go(JAX, "jax"))
    asyncio.run(go(PORT, "port"))
    assert published["port"] == published["jax"]
    assert [msgpack.unpackb(p, raw=False)["event"]
            for _, p in published["port"]] == ["fire", "clear"]


def test_qos_slo_specs_per_class():
    from dynamo_tpu.runtime.qos import DEFAULT_POLICY as JPOL
    from dynamo_tpu_torch.runtime.qos import DEFAULT_POLICY as TPOL
    want = jslo.qos_slo_specs(JPOL, short_window_s=5.0)
    got = tslo.qos_slo_specs(TPOL, short_window_s=5.0)
    assert [vars(s) for s in got] == [vars(s) for s in want]
    assert len(got) == 6


# -- prometheus text parsing ---------------------------------------------------

def test_parse_prometheus_text_families_and_histograms():
    text = "\n".join([
        "# HELP llm_workers Live worker instances",
        "# TYPE llm_workers gauge",
        "llm_workers 3",
        "# HELP llm_ttft_seconds ttft",
        "# TYPE llm_ttft_seconds histogram",
        'llm_ttft_seconds_bucket{model="m",le="+Inf"} 2',
        'llm_ttft_seconds_sum{model="m"} 0.5',
        'llm_ttft_seconds_count{model="m"} 2',
        "# HELP llm_empty_family no series yet",
        "# TYPE llm_empty_family gauge",
        "llm_bad_value abc",
    ])
    fams = both(lambda m: m["fleet"].parse_prometheus_text(text))
    assert fams["llm_workers"][""] == 3.0
    assert "llm_empty_family" in fams
    assert "llm_ttft_seconds" in fams
    assert all(not k.endswith(("_bucket", "_sum", "_count")) for k in fams)


# -- the engine's step ledger against the JAX engine's -------------------------

from dynamo_tpu.engine.config import (  # noqa: E402
    EngineConfig as JEngineConfig, ModelConfig as JModelConfig,
)
from dynamo_tpu.engine.engine import NativeEngine as JNativeEngine  # noqa
from dynamo_tpu.engine.scheduler import (  # noqa: E402
    EngineRequest as JRequest, SamplingParams as JSamplingParams,
)
from dynamo_tpu_torch.engine.config import (  # noqa: E402
    EngineConfig as TEngineConfig, ModelConfig as TModelConfig,
)
from dynamo_tpu_torch.engine.engine import NativeEngine as TNativeEngine  # noqa
from dynamo_tpu_torch.engine.scheduler import (  # noqa: E402
    EngineRequest as TRequest, SamplingParams as TSamplingParams,
)
from dynamo_tpu_torch.models.llama import params_from_jax  # noqa: E402

# tests/test_torch_engine.py's model and geometry (shared JAX programs).
# Both engines decode through the gather window (decode_kernel="off"): the
# window's base bucket and the follow-up rule that depends on it are then
# the same on both, so the two pipelines stage (and key) the same windows
JCFG = JModelConfig(dtype="float32", max_model_len=512, decode_kernel="off")
TCFG = TModelConfig(dtype="float32", max_model_len=512, decode_kernel="off")
ENGINE_KW = dict(page_size=8, num_pages=64, max_slots=4,
                 max_prefill_chunk=32, prefill_buckets=(8, 16, 32),
                 max_model_len=512)
# tests/test_torch_streaming.py's: 80 prompt + 16 output tokens on a
# 6-page HBM budget with a host tier
STREAM_J = JModelConfig(dtype="float32", max_model_len=256,
                        decode_kernel="off")
STREAM_T = TModelConfig(dtype="float32", max_model_len=256,
                        decode_kernel="off")
STREAM_KW = dict(page_size=4, num_pages=6, max_slots=2,
                 max_prefill_chunk=32, prefill_buckets=(8, 16, 32),
                 max_model_len=256, host_pages=64, stream_pages=4,
                 stream_resident_pages=4, stream_hot_pages=2)


def _scenario(name):
    """(jax model cfg, port model cfg, engine kwargs, requests)."""
    rng = np.random.default_rng(2)
    if name == "greedy":
        return JCFG, TCFG, ENGINE_KW, [("g", list(range(10, 30)),
                                        dict(max_tokens=12))]
    if name == "sampled":
        return JCFG, TCFG, ENGINE_KW, [
            ("s1", list(range(40, 61)), dict(max_tokens=10, temperature=0.8,
                                             top_k=20, seed=7)),
            ("s2", list(range(90, 110)), dict(
                max_tokens=7, temperature=0.7, seed=11,
                repetition_penalty=1.3))]
    if name == "chunked":
        return JCFG, TCFG, ENGINE_KW, [("long", list(range(5, 80)),
                                        dict(max_tokens=8))]
    if name == "mixed":
        return JCFG, TCFG, ENGINE_KW, [
            (f"m{i}", rng.integers(3, 250, n).tolist(),
             dict(max_tokens=10, temperature=0.9 if i % 2 else 0.0,
                  seed=100 + i))
            for i, n in enumerate((9, 40, 17, 70))]
    if name == "spec":
        jcfg = JModelConfig(dtype="float32", max_model_len=512)
        return jcfg, TCFG, dict(ENGINE_KW, spec_decode="ngram", spec_k=4), [
            ("p", list(range(10, 26)) * 3, dict(max_tokens=20)),
            ("q", [5, 6, 7, 8] * 6, dict(max_tokens=12))]
    assert name == "stream"
    prompt = [(7 * i + 3) % 250 + 1 for i in range(80)]
    return STREAM_J, STREAM_T, STREAM_KW, [
        ("a", prompt, dict(max_tokens=16, temperature=0.0,
                           ignore_eos=True))]


def _sync_copies(eng):
    """Make the engine's offload copies land before submit returns, so the
    tier counts at each sample are deterministic."""
    cs = eng._copy_stream
    if cs is None:
        return eng
    submit = cs.submit

    def sync_submit(*args):
        submit(*args)
        cs.drain()
    cs.submit = sync_submit
    return eng


def _drive(eng, request_cls, params_cls, reqs):
    for rid, prompt, kw in reqs:
        eng.add_request(request_cls(rid, list(prompt), params_cls(**kw)))
    out = {rid: [] for rid, _, _ in reqs}
    while eng.has_work():
        for ev in eng.step():
            if ev.token is not None:
                out[ev.request_id].append(ev.token)
    return out


def _engines(name):
    jcfg, tcfg, kw, reqs = _scenario(name)
    jeng = _sync_copies(JNativeEngine(jcfg, JEngineConfig(**kw),
                                      eos_token_ids={2}, seed=0))
    teng = _sync_copies(TNativeEngine(
        tcfg, TEngineConfig(**kw), eos_token_ids={2}, device="cpu",
        params=params_from_jax(jax.device_get(jeng.params), tcfg, "cpu")))
    return jeng, teng, reqs


LEDGER_METRICS = ("engine_steps", "engine_recompiles", "engine_pad_frac")


@pytest.mark.parametrize("name", ["greedy", "sampled", "chunked", "mixed",
                                  "spec", "stream"])
def test_engine_ledger_samples_equal_jax(name):
    jeng, teng, reqs = _engines(name)
    want = _drive(jeng, JRequest, JSamplingParams, reqs)
    got = _drive(teng, TRequest, TSamplingParams, reqs)
    assert got == want
    jm, tm = jeng.metrics(), teng.metrics()
    for f in LEDGER_METRICS:
        assert getattr(tm, f) == getattr(jm, f), f
    jrecs, trecs = jeng.ledger.drain(), teng.ledger.drain()
    assert _untimed(trecs) == _untimed(jrecs)
    assert teng._seen_programs == jeng._seen_programs
    kinds = {r["kind"] for r in trecs}
    expect = {"greedy": {"prefill", "decode"}, "sampled": {"decode"},
              "chunked": {"prefill", "decode"}, "mixed": {"mixed"},
              "spec": {"spec"}, "stream": {"stream"}}[name]
    assert expect <= kinds, kinds
    assert tm.engine_steps == len(trecs) > 0
    assert tm.engine_recompiles == sum(r["recompiles"] for r in trecs)
    # a streamed request dispatches no keyed program (neither engine
    # notes the streamer's steps); every other run compiles something
    assert (tm.engine_recompiles > 0) == (name != "stream")
    if name == "stream":
        from dynamo_tpu_torch.engine.streaming import STREAM_STATS
        st = [r for r in trecs if r["kind"] == "stream"]
        assert sum(r["stream_hit"] + r["stream_late"] for r in st) > 0
        assert len(st) <= STREAM_STATS.stream_steps


def test_engine_ledger_off_changes_no_token(monkeypatch):
    """DYN_LEDGER=0: the same streams, no sample, no engine_* figure."""
    jeng, teng, reqs = _engines("mixed")
    want = _drive(teng, TRequest, TSamplingParams, reqs)
    monkeypatch.setenv("DYN_LEDGER", "0")
    _, off, _ = _engines("mixed")
    assert not off.ledger.enabled
    got = _drive(off, TRequest, TSamplingParams, reqs)
    assert got == want
    assert len(off.ledger) == 0
    m = off.metrics()
    assert (m.engine_steps, m.engine_recompiles) == (0, 0)
    # configure(enabled=...) flips it on one engine, as chip_smoke does
    teng.ledger.configure(enabled=False)
    teng.ledger.drain()
    again = _drive(teng, TRequest, TSamplingParams,
                   [(r + "2", p, kw) for r, p, kw in reqs])
    assert len(teng.ledger) == 0 and again
