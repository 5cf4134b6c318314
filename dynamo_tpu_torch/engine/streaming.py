"""Decode-time KV streaming past the HBM page budget: the window-pool loop.

Port of dynamo_tpu/engine/streaming.py. A context larger than the HBM page
budget keeps only a small working set resident (`stream_resident_pages`,
the first `stream_hot_pages` logical pages protected as the hot prefix) and
attends over every other page by staging it from the host tier
(HostKvPool DRAM, DiskKvPool below it) through a double-buffered window
pool: two staging halves of `stream_pages` page slots, the fill of segment
j + 1 issued before segment j's partial is consumed (a prefetch hit); a
segment no half holds is staged when it is needed (a prefetch late). Hits,
lates and every other `STREAM_STATS` counter are counted exactly as in JAX.

Exactness, as in JAX: attention over the whole context factors into
partial-softmax flash states (acc unnormalised, m row max, l row sum), one
per KV source (the resident pages, each staged segment, the chunk's causal
self-attention), merged by the flash rule. K is stored after RoPE, so a
page attends the same wherever it is staged.

The per-layer host loop is JAX's: layer l + 1's queries need layer l's
attention over every segment, so segments iterate innermost and the staged
unit is one layer's slice of a page. JAX's per-unit jitted programs are
plain functions on tensors here; the JAX path is a host loop of dispatches
too, so nothing is captured into a graph.

What differs from the JAX module:
- The window pool's halves live on the device. The host tier's slabs are
  pinned on the card, so a fill copies each page's layer slice (one
  contiguous block of its slot) with `non_blocking` straight out of the
  slot on a side stream into a page-major half, and one device copy lays
  the half out as [Hkv, W, ps, hd]: JAX's np.stack into host staging
  would read every byte with the host CPU first (7.9 GB/s against 19.8
  GB/s for the slots' DMAs on one H100 machine's host,
  tools/torch_stream_probe.py; PERF.md). The consuming
  step's stream waits on the fill's event; a half is refilled only after
  the event recorded where its last partial was enqueued; the cold pages
  stay pinned until every fill of the step has completed. On the CPU the
  fill is a plain copy.
- `_pin_cold` hashes the step's cold pages in threads ahead of the pins
  (`HostKvPool.preverify`, as the prefix walk does): every pin still
  verifies, with the same outcome and counters. `resume_hot_prefix` waits
  for the in-flight spills of the pages it pins (`CopyStream.settle`), as
  `_pin_cold` does in both packages.
- A decode step (one query token) on the ragged decode path takes its
  resident-pages partial and every staged segment's partial from the
  ragged kernel (ops/paged_attention.ragged_decode_attention: the
  unnormalised (acc, m, l) of one query over `lens` tokens of its pages) in
  every layer but layer 0. Layer 0 needs the per-page stats (pm, pl) that
  feed the spill policy, and a prefill chunk has T = page size rows; both
  keep `_pages_partial`, the form the JAX package uses. The resident pages
  are sorted by logical index with the tail last, so their rows are
  contiguous as the kernel's `lens` expects; a staged half is a one-layer
  cache [1, Hkv, W, ps, hd] with the page table arange(W). The same
  function in another summation order (ROADMAP.md §C).
- `_fold_stats` reads the step's layer-0 stats in one host copy of their
  concatenation.
- The pool counts the bytes and device time of its fills (`h2d_bytes`,
  `h2d_s`, `fills`; the JAX module has no counterpart).

Left out, with A14 (observability/ledger.py): the streamed step's
StepLedger sample.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from dynamo_tpu_torch.engine.config import ModelConfig
from dynamo_tpu_torch.engine.kv_cache import SequenceState, page_hash
from dynamo_tpu_torch.engine.sampler import sample_logits
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.ops.attention import NEG_INF, _scale, scatter_new_kv
from dynamo_tpu_torch.ops.kv_quant import dequantize_rows, quantize_rows
from dynamo_tpu_torch.ops.paged_attention import ragged_decode_attention


# -- stats --------------------------------------------------------------------

class StreamStats:
    """Process-global streamed-decode counters -> llm_kv_stream_* gauges."""

    FIELDS = (
        "window_pool_pages",     # staging slots per half (config)
        "window_pool_used",      # slots filled by the last staged segment
        "prefetch_issued",       # segment stagings issued ahead
        "prefetch_hit",          # segments consumed from a prior prefetch
        "prefetch_late",         # segments staged at consume
        "pages_spilled",         # resident pages spilled to the host tier
        "pages_promoted",        # cold pages onboarded back into HBM
        "pages_quarantined",     # cold pages failing the pin verify gate
        "pages_recomputed",      # quarantined pages rebuilt from tokens
        "stall_steps",           # steps with >= 1 late segment
        "stream_steps",          # streamed prefill-chunk + decode steps
        "stream_seqs",           # sequences admitted to the streamed path
    )

    def __init__(self):
        self._mu = threading.Lock()
        for f in self.FIELDS:
            setattr(self, f, 0)

    def snapshot(self) -> Dict[str, float]:
        with self._mu:
            return {f: float(getattr(self, f)) for f in self.FIELDS}


STREAM_STATS = StreamStats()


# -- flash-partial math -------------------------------------------------------

def _merge_partial(acc1, m1, l1, acc2, m2, l2):
    """Merge two partial-softmax states; acc [T, Hkv, G, hd] f32, m / l
    [T, Hkv, G]. The all-masked state (m = NEG_INF, l = 0) merges as a
    no-op: its factor underflows to 0 against any finite m."""
    m = torch.maximum(m1, m2)
    e1 = torch.exp(m1 - m)
    e2 = torch.exp(m2 - m)
    return acc1 * e1[..., None] + acc2 * e2[..., None], m, l1 * e1 + l2 * e2


def _pages_partial(q, kp, vp, lens, scale: float, with_stats: bool):
    """Partial attention of q [T, H, hd] against pages kp / vp [Hkv, N, ps,
    hd] whose every valid row precedes every query row (only the per-page
    length mask). Returns (acc, m, l) plus, with_stats, the per-page flash
    stats (pm [N], pl [N]) that feed the attention-mass EWMA."""
    t, h, hd = q.shape
    hkv, n, ps, _ = kp.shape
    g = h // hkv
    qg = q.reshape(t, hkv, g, hd).float()
    kf = kp.float()
    vf = vp.float()
    scores = torch.einsum("tkgd,knsd->tkgns", qg, kf) * scale
    valid = (torch.arange(ps, device=q.device)[None, :]
             < lens[:, None])                                   # [N, ps]
    neg = torch.full((), NEG_INF, device=q.device)
    zero = torch.zeros((), device=q.device)
    scores = torch.where(valid[None, None, None], scores, neg)
    m = scores.amax(dim=(3, 4))                                 # [T, Hkv, G]
    # the where (not a bare exp) keeps an all-masked set at 0, not 1
    p = torch.where(valid[None, None, None],
                    torch.exp(scores - m[..., None, None]), zero)
    l = p.sum(dim=(3, 4))
    # rows past lens may hold stale bytes; 0 * NaN is NaN, so zero V there
    vz = torch.where(valid[None, :, :, None], vf, zero)
    acc = torch.einsum("tkgns,knsd->tkgd", p, vz)
    if not with_stats:
        return acc, m, l
    pm = scores.amax(dim=(0, 1, 2, 4))                          # [N]
    pp = torch.where(valid[None, None, None],
                     torch.exp(scores - pm[None, None, None, :, None]), zero)
    pl = pp.sum(dim=(0, 1, 2, 4))                               # [N]
    return acc, m, l, pm, pl


def _kernel_partial(q, kc, vc, layer: int, table, nlen, ksc, vsc):
    """The same partial at T = 1 from the ragged kernel: q [1, H, hd] over
    the first nlen[0] tokens of the pages `table` [1, Pb] lists in layer
    `layer` of kc / vc [L, Hkv, P, ps, hd] (int8 with their scales).
    Returns (acc [1, Hkv, G, hd], m, l [1, Hkv, G])."""
    _, h, hd = q.shape
    hkv = kc.shape[1]
    acc, m, l = ragged_decode_attention(q.contiguous(), kc, vc, layer, table,
                                        nlen, ksc, vsc)
    g = h // hkv
    return (acc.reshape(1, hkv, g, hd), m.reshape(1, hkv, g),
            l.reshape(1, hkv, g))


def _causal_partial(q, k, v, scale: float):
    """The chunk's own causal self-attention state; q [T, H, hd], k / v
    [T, Hkv, hd]. Padding rows sit at the chunk's tail, so the j <= i mask
    alone keeps them out of every real row."""
    t, h, hd = q.shape
    hkv = k.shape[1]
    g = h // hkv
    qg = q.reshape(t, hkv, g, hd).float()
    scores = torch.einsum("tkgd,skd->tkgs", qg, k.float()) * scale
    idx = torch.arange(t, device=q.device)
    mask = idx[None, :] <= idx[:, None]                          # [Tq, Tk]
    scores = torch.where(mask[:, None, None, :], scores,
                         torch.full((), NEG_INF, device=q.device))
    m = scores.amax(-1)
    p = torch.where(mask[:, None, None, :], torch.exp(scores - m[..., None]),
                    torch.zeros((), device=q.device))
    l = p.sum(-1)
    acc = torch.einsum("tkgs,skd->tkgd", p, v.float())
    return acc, m, l


def _stream_layer_start(cfg: ModelConfig, with_stats: bool, params, lid: int,
                        x, positions, cache, table, lens, kernel=None):
    """Per-layer front half: norm + QKV + RoPE, then the resident-pages
    partial merged with the causal self-chunk partial. x [T, D]; returns
    (q, k_new, v_new, acc, m, l[, pm, pl]). `kernel` = (table [1, Pb],
    nlen [1]): the resident partial from the ragged kernel instead."""
    q, k, v = llama._qkv(x[None], params["layers"], lid, cfg,
                         positions[None])
    q, k, v = q[0], k[0], v[0]
    sc = _scale(cfg.head_dim, cfg.query_scale)
    # an int8 cache: the kernel folds the scales, the gather dequantizes
    # # dynalint: kv-codec
    ksc, vsc = cache.get("k_scale"), cache.get("v_scale")
    if kernel is not None:
        res = _kernel_partial(q, cache["k"], cache["v"], lid, kernel[0],
                              kernel[1], ksc, vsc)
    else:
        # dynalint: kv-codec (scale rows gathered next to the values)
        kp = cache["k"][lid].index_select(1, table)       # [Hkv, R, ps, hd]
        vp = cache["v"][lid].index_select(1, table)
        if ksc is not None:
            kp = dequantize_rows(kp, ksc[lid].index_select(1, table),
                                 q.dtype)
            vp = dequantize_rows(vp, vsc[lid].index_select(1, table),
                                 q.dtype)
        res = _pages_partial(q, kp, vp, lens, sc, with_stats)
    acc_s, m_s, l_s = _causal_partial(q, k, v, sc)
    acc, m, l = _merge_partial(res[0], res[1], res[2], acc_s, m_s, l_s)
    out = (q, k, v, acc, m, l)
    if with_stats:
        out = out + (res[3], res[4])
    return out


def _stream_seg_merge(cfg: ModelConfig, with_stats: bool, q, staged, acc, m,
                      l, kernel: bool = False):
    """Merge one staged window-pool segment into the running flash state.
    staged = (k, v, k_scale, v_scale [Hkv, W, ps(, hd)], lens [W], nlen [1],
    table [1, W]); an int8 segment is staged verbatim with its scales."""
    kp, vp, ksc, vsc, lens, nlen, table = staged
    if kernel:
        seg = _kernel_partial(q, kp[None], vp[None], 0, table, nlen,
                              None if ksc is None else ksc[None],
                              None if vsc is None else vsc[None])
    else:
        if ksc is not None:
            # dynalint: kv-codec (staged int8 pages dequantize at consume)
            kp = dequantize_rows(kp, ksc, q.dtype)
            vp = dequantize_rows(vp, vsc, q.dtype)
        seg = _pages_partial(q, kp, vp, lens,
                             _scale(cfg.head_dim, cfg.query_scale),
                             with_stats)
    acc, m, l = _merge_partial(acc, m, l, seg[0], seg[1], seg[2])
    if with_stats:
        return acc, m, l, seg[3], seg[4]
    return acc, m, l


def _stream_layer_finish(cfg: ModelConfig, params, lid: int, x, acc, l):
    """Per-layer back half: normalise the merged state, output projection,
    residual, MLP. Returns the next layer's x [T, D]."""
    t = x.shape[0]
    attn = (acc / l[..., None]).reshape(t, cfg.num_heads, cfg.head_dim)
    out, _ = llama._block_tail(x[None], attn[None].to(x.dtype),
                               params["layers"], lid, cfg)
    return out[0]


def _stream_embed(cfg: ModelConfig, params, tokens):
    # ids validated at admission; streamed decode feeds committed sampler
    # outputs only  # dynalint: disable-next-line=R1
    return llama.scale_embeds(params["embed"][tokens], cfg)


def _stream_final(cfg: ModelConfig, params, x_last):
    """Final norm + LM head on the last real chunk row: [D] -> [1, V] f32."""
    return llama._lm_head(params, cfg, x_last[None])


def _quant_page_rows(k_rows, v_rows):
    """Quantize one recomputed page's rows with the capture path's per-row
    codec (ops/attention.scatter_new_kv), so a recomputed page re-puts the
    payload the capture path would have written for the same rows."""
    # dynalint: kv-codec (the recompute twin of the capture-time quantize)
    kq, ks = quantize_rows(k_rows)
    vq, vs = quantize_rows(v_rows)
    return kq, ks, vq, vs


# -- window pool --------------------------------------------------------------

@dataclasses.dataclass
class _Half:
    arrays: tuple                  # (k, v, ks, vs, lens, nlen, table)
    raw: tuple = ()                # the fill's page-major target (the card)
    filled: Optional[object] = None     # event after the fill
    consumed: Optional[object] = None   # event after the last partial


class WindowPool:
    """Two device staging halves for streamed cold-KV segments.

    `prefetch(key, ...)` fills the idle half with the segment's per-layer
    page slices and returns at once (on the card the copies run on the
    side stream). `take(key, ...)` returns the staged arrays from a half
    whose key matches (a prefetch HIT) or, when no half holds the key,
    stages the segment then (a prefetch LATE). Keys carry the segment's
    page hashes, so a stale prefetch against a changed cold set is never
    consumed."""

    def __init__(self, slots: int, hkv: int, ps: int, hd: int,
                 dtype: torch.dtype, quant: bool, device, main=None):
        self.slots = slots
        self.device = torch.device(device)
        self._quant = quant
        self._ps = ps
        self._cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._main = main          # the consuming stream (the engine's)
        # (per-slot lens [W], their sum [1]) of a segment of n pages, for
        # every n: a fill copies no lengths
        self._meta = []
        for n in range(slots + 1):
            meta = torch.zeros((slots + 1,), dtype=torch.int32)
            meta[:n] = ps
            meta[slots] = n * ps
            meta = meta.to(self.device)
            self._meta.append((meta[:slots], meta[slots:]))
        self._halves = [self._make(hkv, ps, hd, dtype) for _ in range(2)]
        self._half: List[Optional[tuple]] = [None, None]   # (key, half)
        self._next = 0
        self._timings: list = []
        self.h2d_bytes = 0         # bytes copied into the halves
        self.h2d_s = 0.0           # device time of those copies (the card)
        self.fills = 0
        STREAM_STATS.window_pool_pages = slots

    def _make(self, hkv, ps, hd, dtype) -> _Half:
        w, dev = self.slots, self.device

        def z(shape, dt):
            return torch.zeros(shape, dtype=dt, device=dev)
        arrays = (z((hkv, w, ps, hd), dtype), z((hkv, w, ps, hd), dtype),
                  z((hkv, w, ps), torch.float32) if self._quant else None,
                  z((hkv, w, ps), torch.float32) if self._quant else None,
                  *self._meta[0],
                  torch.arange(w, dtype=torch.int32, device=dev)[None])
        raw = ()
        if self._cuda:
            raw = (z((w, hkv, ps, hd), dtype), z((w, hkv, ps, hd), dtype))
            if self._quant:
                raw += (z((w, hkv, ps), torch.float32),
                        z((w, hkv, ps), torch.float32))
        return _Half(arrays=arrays, raw=raw)

    def _assemble(self, half: int, views: List[tuple], lid: int) -> None:
        """Stage layer `lid`'s slice of each cold page view into `half`. On
        the card each slice (one contiguous block of its pinned slot) is
        copied with `non_blocking` on the side stream, after the half's
        last partial, into a page-major buffer, and one device copy lays it
        out as [Hkv, W, ps, hd]; the slots are read after this returns, so
        they stay pinned until `account`. On the CPU, a copy."""
        hb = self._halves[half]
        n = len(views)
        leaves = 4 if self._quant else 2
        hb.arrays = hb.arrays[:4] + self._meta[n] + hb.arrays[6:]
        self.fills += 1
        STREAM_STATS.window_pool_used = n
        if not self._cuda:
            for i, pv in enumerate(views):
                for dst, src in zip(hb.arrays[:leaves], pv):
                    dst[:, i].copy_(src[lid])
            return
        st = self._stream
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(st):
            if hb.consumed is not None:
                st.wait_event(hb.consumed)   # its last partial is done
            start.record(st)
            for i, pv in enumerate(views):
                for dst, src in zip(hb.raw, pv):
                    # dynalint: kv-codec (int8 pages + scales verbatim)
                    dst[i].copy_(src[lid], non_blocking=True)
                    self.h2d_bytes += src[lid].numel() * src.element_size()
            for dst, raw in zip(hb.arrays[:leaves], hb.raw):
                dst[:, :n].copy_(raw[:n].transpose(0, 1))
            end.record(st)
        hb.filled = end
        self._timings.append((start, end))

    def prefetch(self, key, views: List[tuple], lid: int) -> None:
        """Fill the idle half ahead of consume; re-prefetching a key already
        staged is a no-op."""
        if any(h is not None and h[0] == key for h in self._half):
            return
        half = self._next
        self._next ^= 1
        self._half[half] = (key, half)
        self._assemble(half, views, lid)
        STREAM_STATS.prefetch_issued += 1

    def take(self, key, views: List[tuple], lid: int):
        """Claim the staged segment: (arrays, hit, half). A half whose key
        matches is a prefetch hit; otherwise the segment is staged now (a
        prefetch late, never a stale consume). The caller's stream waits
        for the fill; call `consumed(half)` once the partial is enqueued."""
        for h in self._half:
            if h is not None and h[0] == key:
                STREAM_STATS.prefetch_hit += 1
                return self._ready(h[1]), True, h[1]
        half = self._next
        self._next ^= 1
        self._half[half] = (key, half)
        self._assemble(half, views, lid)
        STREAM_STATS.prefetch_late += 1
        return self._ready(half), False, half

    def _ready(self, half: int) -> tuple:
        hb = self._halves[half]
        if self._cuda:
            self._main.wait_event(hb.filled)
        return hb.arrays

    def consumed(self, half: int) -> None:
        """The partial reading `half` is enqueued: a refill waits for it."""
        if self._cuda:
            ev = torch.cuda.Event()
            ev.record(self._main)
            self._halves[half].consumed = ev

    def staged(self) -> List[tuple]:
        """The arrays of each half that holds a segment."""
        return [self._halves[h[1]].arrays for h in self._half
                if h is not None]

    def account(self) -> None:
        """Wait for the fills issued so far (they read pinned slab slots)
        and add their device time."""
        for start, end in self._timings:
            end.synchronize()
            self.h2d_s += start.elapsed_time(end) / 1e3
        self._timings = []

    def invalidate(self) -> None:
        self._half = [None, None]



# -- spill policy -------------------------------------------------------------

class StreamPolicy:
    """Per-logical-page attention-mass EWMA victim selection (JAX's).

    Masses are normalised flash denominators, page p's share of the merged
    softmax mass l_p * exp(m_p - M) / sum, observed once a streamed step
    from the layer-0 statistics. New pages start at 1.0; the victim is the
    lowest-EWMA sealed resident page outside the hot prefix, ties broken
    toward the OLDEST logical page."""

    def __init__(self, hot_pages: int, beta: float = 0.8):
        self.hot_pages = hot_pages
        self.beta = beta

    def observe(self, ewma: List[float], logicals: List[int],
                pm: np.ndarray, pl: np.ndarray) -> None:
        if not logicals:
            return
        pm = np.asarray(pm, np.float64)
        pl = np.asarray(pl, np.float64)
        big = float(np.max(pm))
        mass = pl * np.exp(np.clip(pm - big, -60.0, 0.0))
        total = float(np.sum(mass))
        if total <= 0.0:
            return
        mass = mass / total
        for i, lg in enumerate(logicals):
            if lg < len(ewma):
                ewma[lg] = self.beta * ewma[lg] + (1 - self.beta) * mass[i]

    def victim(self, ewma: List[float],
               candidates: List[int]) -> Optional[int]:
        eligible = [lg for lg in candidates if lg >= self.hot_pages]
        if not eligible:
            eligible = list(candidates)   # a full hot prefix must still spill
        if not eligible:
            return None
        return min(eligible, key=lambda lg: (ewma[lg], lg))


# -- per-sequence record ------------------------------------------------------

@dataclasses.dataclass
class StreamSeq:
    seq: SequenceState
    hashes: List[int] = dataclasses.field(default_factory=list)
    resident: Dict[int, int] = dataclasses.field(default_factory=dict)
    ewma: List[float] = dataclasses.field(default_factory=list)
    n_kv: int = 0                 # tokens with committed KV
    tail_logical: int = -1        # the unsealed page's logical index, or -1

    @property
    def sealed_pages(self) -> int:
        return len(self.hashes)

    def cold_logicals(self) -> List[int]:
        return [i for i in range(self.sealed_pages) if i not in self.resident]


class StreamQuarantineError(RuntimeError):
    """A cold page failed the pin verify gate and recompute could not
    restore it."""


# -- the decoder --------------------------------------------------------------

class StreamingDecoder:
    """Owns streamed sequences end to end: chunked streamed prefill,
    one-token streamed decode steps, residency and spills, and the rot ->
    quarantine -> recompute-the-victim-page repair. Everything it touches
    on the device is the engine's own paged cache, on the engine's stream."""

    def __init__(self, engine):
        self.engine = engine
        cfg = engine.model_cfg
        ecfg = engine.cfg
        self.cfg = cfg
        self.ecfg = ecfg
        self.quant = bool(engine.kv_quant)
        self.ps = ecfg.page_size
        self.window = ecfg.stream_pages
        self.resident_budget = max(2, ecfg.stream_resident_pages)
        self.policy = StreamPolicy(ecfg.stream_hot_pages)
        dtype = torch.int8 if self.quant else llama.torch_dtype(cfg)
        self.device = engine.device
        self.pool = WindowPool(self.window, cfg.num_kv_heads, self.ps,
                               cfg.head_dim, dtype, self.quant, self.device,
                               main=engine._stream)
        # decode steps of layers >= 1 take their partials from the ragged
        # kernel wherever the engine's decode path is the kernel
        self.kernel = engine.decode_path == "ragged"
        self._seqs: Dict[str, StreamSeq] = {}
        # resident page-table width: budget + 1 (the unsealed tail)
        self._rb = self.resident_budget + 1

    # -- lifecycle -----------------------------------------------------------

    def admit(self, seq: SequenceState) -> StreamSeq:
        ss = StreamSeq(seq=seq)
        self._seqs[seq.request_id] = ss
        STREAM_STATS.stream_seqs += 1
        return ss

    def release(self, seq: SequenceState) -> None:
        ss = self._seqs.pop(seq.request_id, None)
        if ss is None:
            return
        alloc = self.engine.scheduler.allocator
        for pid in ss.resident.values():
            alloc.free(pid)
        ss.resident.clear()

    def record(self, seq: SequenceState) -> Optional[StreamSeq]:
        return self._seqs.get(seq.request_id)

    # -- residency helpers ---------------------------------------------------

    def _alloc_page(self) -> int:
        """Allocate one device page, enqueueing the extraction of any page
        the allocation evicted before anything can overwrite it."""
        pid = self.engine.scheduler.allocator.allocate()
        self.engine._process_offloads()
        return pid

    def _spill_victims(self, ss: StreamSeq) -> None:
        """Spill the lowest-mass sealed resident pages until the sequence
        fits its resident budget: each rides the checksummed offload leg
        and its page returns to the allocator."""
        sealed = [lg for lg in ss.resident if lg != ss.tail_logical]
        while len(ss.resident) > self.resident_budget and sealed:
            victim = self.policy.victim(ss.ewma, sealed)
            if victim is None:
                return
            sealed.remove(victim)
            pid = ss.resident.pop(victim)
            h = ss.hashes[victim]
            eng = self.engine
            if eng.host_pool is not None and h not in eng.host_pool:
                eng._pending_offloads.append((pid, h))
                eng._process_offloads()
            eng.scheduler.allocator.free(pid)
            STREAM_STATS.pages_spilled += 1

    def _pin_cold(self, ss: StreamSeq, logicals: List[int]) -> dict:
        """Pin + fetch every cold page of this step (the verify-on-fetch
        gate). A rotten page is quarantined, recomputed from its token span
        (only it) and re-put under its unchanged hash, then pinned again.
        Returns {logical: slab views}, valid until `_unpin_cold`."""
        hp = self.engine.host_pool
        cs = self.engine._copy_stream
        hashes = [ss.hashes[lg] for lg in logicals]
        if cs is not None:
            cs.settle(hashes)   # in-flight spills land before the reads
        # the pins below verify one page at a time; hash them ahead, in
        # threads (the outcome and the counters are the pins')
        hp.preverify(hashes)
        views: dict = {}
        for lg, h in zip(logicals, hashes):
            if not hp.pin(h):
                STREAM_STATS.pages_quarantined += 1
                self._recompute_page(ss, lg)
                if not hp.pin(h):
                    raise StreamQuarantineError(
                        f"page {lg} (hash {h:#x}) unrecoverable after "
                        "recompute")
            views[lg] = hp.get(h)
        hp.forget_verified()
        return views

    def _unpin_cold(self, ss: StreamSeq, logicals: List[int]) -> None:
        hp = self.engine.host_pool
        for lg in logicals:
            hp.unpin(ss.hashes[lg])

    def _recompute_page(self, ss: StreamSeq, logical: int) -> None:
        """Rebuild ONE quarantined page from its tokens against the history
        [0, logical * ps) and re-put it under its unchanged chained hash."""
        ps = self.ps
        toks = ss.seq.all_tokens[logical * ps:(logical + 1) * ps]
        k_rows, v_rows = self._forward_chunk(
            ss, toks, logical * ps, history_pages=logical, append=False,
            collect_kv=True)
        # [L, T, Hkv, hd] -> the tier's [L, Hkv, ps, hd] page layout
        if self.quant:
            kq, ksc, vq, vsc = _quant_page_rows(k_rows, v_rows)
            leaves = (kq.permute(0, 2, 1, 3), vq.permute(0, 2, 1, 3),
                      ksc.permute(0, 2, 1), vsc.permute(0, 2, 1))
        else:
            leaves = (k_rows.permute(0, 2, 1, 3), v_rows.permute(0, 2, 1, 3))
        self.engine.host_pool.put(
            ss.hashes[logical], *(x.contiguous().cpu() for x in leaves))
        STREAM_STATS.pages_recomputed += 1

    # -- the streamed forward pass -------------------------------------------

    def _resident_tables(self, ss: StreamSeq, history_pages: int,
                         hist_len: int):
        """Static-width resident page table + per-page valid lengths for
        attention over history [0, hist_len), sorted by logical page with
        the tail last (every page full but the last); with the kernel's
        row: the same pages as one [1, Rb] row and its valid tokens."""
        table = np.zeros((self._rb,), np.int32)
        lens = np.zeros((self._rb,), np.int32)
        i = 0
        for lg in sorted(ss.resident):
            if lg >= history_pages and lg != ss.tail_logical:
                continue
            pid = ss.resident[lg]
            if lg == ss.tail_logical:
                valid = hist_len - lg * self.ps
                if valid <= 0:
                    continue
                table[i], lens[i] = pid, valid
            else:
                if lg * self.ps >= hist_len:
                    continue
                table[i], lens[i] = pid, min(self.ps,
                                             hist_len - lg * self.ps)
            i += 1
        dev = self.engine._dev
        return (dev(table).long(), dev(lens), dev(table[None]),
                dev(np.array([lens.sum()], np.int32)))

    def _segments(self, ss: StreamSeq, history_pages: int) -> List[list]:
        cold = [lg for lg in ss.cold_logicals() if lg < history_pages]
        return [cold[i:i + self.window]
                for i in range(0, len(cold), self.window)]

    def _forward_chunk(self, ss: StreamSeq, tokens: List[int], start: int,
                       history_pages: int, append: bool,
                       collect_kv: bool = False):
        """One streamed forward pass over `tokens` (positions start..)
        attending history [0, history_pages * ps) + the history's tail +
        itself: per layer the resident + self partial, then each cold
        segment through the window pool with segment (l, j + 1) staged
        while (l, j) computes, then the layer's back half. Returns logits
        [1, V] (append) or the chunk's new KV rows [L, T, Hkv, hd] pairs
        (collect_kv, for recompute)."""
        eng = self.engine
        cfg = self.cfg
        ps = self.ps
        t_real = len(tokens)
        t_pad = 1 if t_real == 1 else ps
        toks = np.zeros((t_pad,), np.int64)
        toks[:t_real] = tokens
        # the attended history is exactly [0, start): a recompute passes
        # the victim page's base, so later pages never leak into its KV
        hist_len = start
        positions = eng._dev(np.arange(start, start + t_pad, dtype=np.int32))
        segs = self._segments(ss, history_pages)
        pin_logicals = sorted({lg for seg in segs for lg in seg})
        views = self._pin_cold(ss, pin_logicals)
        stats: list = []
        late = 0
        try:
            x = _stream_embed(cfg, eng.params, eng._dev(toks))
            table, lens, ktable, klen = self._resident_tables(
                ss, history_pages, hist_len)
            cache = eng.cache
            k_news: list = []
            v_news: list = []
            nl = cfg.num_layers
            # segment (0, 0) of this step was prefetched at the end of the
            # previous one; re-issued here only if the cold set moved
            if segs:
                with eng.phases.phase("prefetch"):
                    self.pool.prefetch(self._seg_key(ss, 0, segs[0]),
                                       [views[lg] for lg in segs[0]], 0)
            for lid in range(nl):
                want_stats = lid == 0
                kernel = self.kernel and t_pad == 1 and not want_stats
                out = _stream_layer_start(
                    cfg, want_stats, eng.params, lid, x, positions, cache,
                    table, lens, (ktable, klen) if kernel else None)
                q, k_new, v_new, acc, m, l = out[:6]
                if want_stats:
                    stats.append(("resident", None, out[6], out[7]))
                for j, seg in enumerate(segs):
                    key = self._seg_key(ss, lid, seg)
                    staged, hit, half = self.pool.take(
                        key, [views[lg] for lg in seg], lid)
                    late += 0 if hit else 1
                    sout = _stream_seg_merge(cfg, want_stats, q, staged, acc,
                                             m, l, kernel=kernel)
                    self.pool.consumed(half)
                    acc, m, l = sout[:3]
                    if want_stats:
                        stats.append(("seg", seg, sout[3], sout[4]))
                    # double buffer: issue the NEXT segment's fill while
                    # this segment's partial runs
                    with eng.phases.phase("prefetch"):
                        if j + 1 < len(segs):
                            nseg = segs[j + 1]
                            self.pool.prefetch(
                                self._seg_key(ss, lid, nseg),
                                [views[lg] for lg in nseg], lid)
                        elif lid + 1 < nl:
                            self.pool.prefetch(
                                self._seg_key(ss, lid + 1, segs[0]),
                                [views[lg] for lg in segs[0]], lid + 1)
                x = _stream_layer_finish(cfg, eng.params, lid, x, acc, l)
                k_news.append(k_new)
                v_news.append(v_new)
            k_stack = torch.stack(k_news)
            v_stack = torch.stack(v_news)
            if collect_kv:
                return k_stack[:, :t_real], v_stack[:, :t_real]
            if append:
                write_idx = self._write_indices(ss, start, t_real, t_pad)
                # an int8 cache quantizes the rows here, with the codec of
                # every other cache write  # dynalint: kv-codec
                scatter_new_kv(cache, k_stack, v_stack, eng._dev(write_idx))
            logits = _stream_final(cfg, eng.params, x[t_real - 1])
            eng._nonfinite += (~torch.isfinite(logits)).any()
            return logits
        finally:
            self._fold_stats(ss, segs, stats, late)
            self.pool.account()   # the fills have read the pinned slots
            self._unpin_cold(ss, pin_logicals)

    def _seg_key(self, ss: StreamSeq, lid: int, seg: List[int]) -> tuple:
        return (lid, tuple(ss.hashes[lg] for lg in seg))

    def _write_indices(self, ss: StreamSeq, start: int, t_real: int,
                       t_pad: int) -> np.ndarray:
        """Flat cache slot per chunk token (<0 = padding), allocating and
        registering tail pages as the chunk crosses page boundaries."""
        ps = self.ps
        idx = np.full((t_pad,), -1, np.int32)
        for i in range(t_real):
            pos = start + i
            lg = pos // ps
            if lg not in ss.resident:
                ss.resident[lg] = self._alloc_page()
                ss.tail_logical = lg
                if lg >= len(ss.ewma):
                    ss.ewma.append(1.0)
            idx[i] = ss.resident[lg] * ps + pos % ps
        return idx

    def _fold_stats(self, ss: StreamSeq, segs: List[list], stats: list,
                    late: int) -> None:
        """End-of-step host fold of the layer-0 flash stats into the EWMA:
        one host copy of their concatenation."""
        if late:
            STREAM_STATS.stall_steps += 1
        if not stats:
            return
        sizes = [s[2].shape[0] for s in stats]
        flat = torch.cat([torch.cat([s[2] for s in stats]),
                          torch.cat([s[3] for s in stats])]).cpu().numpy()
        n = sum(sizes)
        fetched, off = [], 0
        for size in sizes:
            fetched.append((flat[off:off + size], flat[n + off:n + off + size]))
            off += size
        logicals: List[int] = []
        pm_all: List[float] = []
        pl_all: List[float] = []
        res_logicals = sorted(
            lg for lg in ss.resident
            if lg != ss.tail_logical and lg < len(ss.ewma))
        for (kind, seg, _, _), (pm, pl) in zip(stats, fetched):
            lgs = res_logicals if kind == "resident" else seg
            for i, lg in enumerate(lgs):
                if i < len(pm):
                    logicals.append(lg)
                    pm_all.append(float(pm[i]))
                    pl_all.append(float(pl[i]))
        self.policy.observe(ss.ewma, logicals, np.asarray(pm_all),
                            np.asarray(pl_all))

    # -- step entry points ---------------------------------------------------

    def _seal_chunk(self, ss: StreamSeq, upto: int) -> None:
        """Seal every full page below `upto`, chaining hashes, then spill
        down to the resident budget."""
        ps = self.ps
        alloc = self.engine.scheduler.allocator
        toks = ss.seq.all_tokens
        while (ss.sealed_pages + 1) * ps <= upto:
            lg = ss.sealed_pages
            parent = ss.hashes[-1] if ss.hashes else 0
            page_toks = toks[lg * ps:(lg + 1) * ps]
            pid = ss.resident[lg]
            alloc.seal(pid, parent, page_toks)
            ss.hashes.append(page_hash(parent, page_toks))
            if ss.tail_logical == lg:
                ss.tail_logical = -1
        self._spill_victims(ss)

    def step(self, seq: SequenceState):
        """One streamed step: a prefill chunk (no event) or one decoded
        token. Returns (token or None, finished_prefill)."""
        ss = self._seqs.get(seq.request_id)
        if ss is None:
            ss = self.admit(seq)
        STREAM_STATS.stream_steps += 1
        n_prompt = len(seq.prompt)
        if ss.n_kv < n_prompt:
            start = ss.n_kv
            chunk = min(self.ps - start % self.ps, n_prompt - start)
            toks = seq.all_tokens[start:start + chunk]
            logits = self._forward_chunk(ss, toks, start,
                                         history_pages=start // self.ps,
                                         append=True)
            ss.n_kv += chunk
            seq.num_cached = seq.num_computed = ss.n_kv
            self._seal_chunk(ss, ss.n_kv)
            if ss.n_kv < n_prompt:
                return None, False
            if seq.output:
                # a resume or migration replay crossed the prompt boundary:
                # the first token was emitted before the preempt
                return None, True
            return self._sample(ss, logits), True
        start = ss.n_kv
        total = len(seq.all_tokens)
        if start < total - 1:
            # replay after preempt / migration: KV coverage is behind the
            # committed tokens; rebuild a chunk at a time WITHOUT sampling
            chunk = min(self.ps - start % self.ps, total - 1 - start)
            self._forward_chunk(ss, seq.all_tokens[start:start + chunk],
                                start, history_pages=start // self.ps,
                                append=True)
            ss.n_kv += chunk
            seq.num_cached = seq.num_computed = ss.n_kv
            self._seal_chunk(ss, ss.n_kv)
            return None, False
        # decode: feed the last committed token, append its KV, sample
        logits = self._forward_chunk(ss, [seq.all_tokens[start]], start,
                                     history_pages=start // self.ps,
                                     append=True)
        ss.n_kv += 1
        seq.num_cached = seq.num_computed = ss.n_kv
        self._seal_chunk(ss, ss.n_kv)
        return self._sample(ss, logits), False

    def _sample(self, ss: StreamSeq, logits) -> int:
        """The decode window's sampler tail with the same (seed, counter)
        keys, so greedy and seeded-sampled streams are the window's."""
        seq = ss.seq
        p = self.engine.scheduler.params[seq.request_id]
        dev = self.engine._dev
        tok = sample_logits(
            logits, self.engine._eos_vec,
            dev(np.array([p.temperature], np.float32)),
            dev(np.array([p.top_k], np.int32)),
            dev(np.array([p.top_p], np.float32)),
            dev(np.array([p.seed & 0x7FFFFFFF], np.int32)),
            dev(np.array([len(seq.output)], np.int32)),
            dev(np.array([p.min_tokens], np.int32)),
            greedy=p.temperature <= 0.0)[0]
        return int(tok[0])

    # -- preempt / resume / migration ----------------------------------------

    def preempt(self, seq: SequenceState) -> None:
        """Spill every sealed resident page to the host tier and drop the
        unsealed tail (its tokens recompute on resume)."""
        ss = self._seqs.get(seq.request_id)
        if ss is None:
            return
        eng = self.engine
        alloc = eng.scheduler.allocator
        for lg in sorted(ss.resident):
            pid = ss.resident.pop(lg)
            if lg < ss.sealed_pages:
                h = ss.hashes[lg]
                if eng.host_pool is not None and h not in eng.host_pool:
                    eng._pending_offloads.append((pid, h))
                    eng._process_offloads()
                STREAM_STATS.pages_spilled += 1
            alloc.free(pid)
        ss.tail_logical = -1
        ss.n_kv = ss.sealed_pages * self.ps
        seq.num_cached = seq.num_computed = ss.n_kv
        self.pool.invalidate()

    def resume_hot_prefix(self, ss: StreamSeq) -> None:
        """Onboard the hot-prefix pages back into HBM (the spill leg's
        promotion counterpart); cold middle pages stay streamed."""
        hp = self.engine.host_pool
        cs = self.engine._copy_stream
        n = min(self.policy.hot_pages, ss.sealed_pages)
        if cs is not None:
            cs.settle([ss.hashes[lg] for lg in range(n)])
        for lg in range(n):
            if lg in ss.resident:
                continue
            h = ss.hashes[lg]
            if not hp.pin(h):
                STREAM_STATS.pages_quarantined += 1
                self._recompute_page(ss, lg)
                if not hp.pin(h):
                    raise StreamQuarantineError(
                        f"hot page {lg} unrecoverable")
            try:
                pv = hp.get(h)
                pid = self._alloc_page()
                self.engine._onboard([pid], [pv])
                ss.resident[lg] = pid
                STREAM_STATS.pages_promoted += 1
            finally:
                hp.unpin(h)
        self._spill_victims(ss)

    def export_seq(self, seq: SequenceState) -> dict:
        """A serializable record for migration: pages stay content-addressed
        in the tiers, so it is tokens + hashes + policy state. Call
        preempt() first so every sealed page is tier-resident."""
        ss = self._seqs[seq.request_id]
        return {
            "request_id": seq.request_id,
            "prompt": list(seq.prompt),
            "output": list(seq.output),
            "hashes": list(ss.hashes),
            "ewma": list(ss.ewma),
            "n_kv": ss.n_kv,
        }

    def import_seq(self, seq: SequenceState, record: dict) -> StreamSeq:
        """Register a migrated streamed sequence; its pages must already be
        in this engine's tiers."""
        ss = self.admit(seq)
        ss.hashes = list(record["hashes"])
        ss.ewma = list(record["ewma"])
        ss.n_kv = int(record["n_kv"])
        seq.num_cached = seq.num_computed = ss.n_kv
        return ss
