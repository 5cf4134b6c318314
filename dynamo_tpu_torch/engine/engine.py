"""NativeEngine: the PyTorch serving engine for one model on one device.

Port of dynamo_tpu/engine/engine.py for the slice's main path. The
scheduler (engine/scheduler.py) plans prefill, mixed and decode steps;
prefill and mixed steps run `models/llama.forward` and sample one token per
row (`_engine_step`); decode runs a window of `decode_steps` iterations of
`models/llama.decode_forward` (`_engine_decode_window`), the sampled token
feeding the next iteration on the device, with ONE device-to-host copy of
the window's tokens at its end.

The decode window is the JAX package's kernel-mode body
(dynamo_tpu/engine/engine.py:2278-2358). It carries (token, position,
counter, seen, alive) on the device and derives each step's attended
prefix and write slot there; the cache is read-only inside each step (the
ragged kernel in prefix mode plus combine_self_attention) and each step's
new kv rows are scattered into the cache in place (`_scatter_new_kv`; on
an int8 cache the rows quantize there). A slot that samples eos (unless
ignore_eos) or a hidden stop id dies on the device and writes no more KV.
The window returns its final (token, position, counter), so an unchanged
slot set re-dispatches with zero uploads (`_stage_window`).

On the card each window variant is ONE captured CUDA graph
(engine/window_graph.py), the counterpart of the JAX engine's jitted
window programs: `decode_dispatches` counts one replay per window.

With ModelConfig.quant == "int8" the weights are int8 with per-output-
channel scales (ops/quant.py): an unquantized `params` tree is quantized
on its device, as the JAX engine quantizes on the host
(dynamo_tpu/engine/engine.py:289-297). A decode window's projections then
run the W8A16 kernel inside the window's graph.

With pipeline_depth >= 2 (the default) the decode loop is two-deep, as in
the JAX package: a step that finds a window in flight dispatches its
follow-up from the device carry first, then fetches and commits the
in-flight window while the device runs the follow-up; a commit that
changes slot membership discards the follow-up and re-plans. Streams are
token-identical to the synchronous loop (docs/PERF.md §3 has the
argument). Prefill and mixed steps stay eager.

Disaggregation (dynamo_tpu/engine/engine.py:1700-1811, :2087-2104): a
prefill-only request parks after its prefill with its pages held
(`extract_pages` reads them); the decode side allocates a remote request's
pages up front (`allocate_remote`), takes its KV (`inject_pages`) and
enters it into the normal flow (`activate_remote`, or the early-decode
gate `preactivate_remote`, polled by `has_work`). Inject writes every
cache leaf in place with `index_copy_` on the engine's stream, so the
captured window graphs and the device carry stay valid; an activated
sequence enters `waiting`, on which `_pipeline_ok` and `_pipeline_step`
already gate, so no window in flight reads or is re-dispatched over it.
Padded page ids point at the scratch page (`num_pages`): extract reads
the last real page there, as the JAX engine clamps, and inject writes the
padding into the scratch page where the JAX engine drops it.

The KV tiers (dynamo_tpu/engine/engine.py:136-166, :1635-1698,
:1942-2080): with `host_pages > 0` a page the allocator recycles is queued
(`_offload_page`) and its extraction enqueued on the engine's stream at the
next cache write (`_process_offloads`, right after `schedule()`, at the top
of a pipeline step and before an inject), the copy to its host slot running
on engine/offload.py's CopyStream thread. A prefix hit in the host tier
(or, below it, the disk tier or an attached shared pool, engine/kv_pool.py)
gets a fresh HBM page that `_process_onboards` / `_process_pool_injects`
fill with `inject_pages` before the step that reads it; on the card each
page leaves its pinned slot in one DMA on the onboard stream, and its slot
stays pinned until that copy is done. The pipeline does not start or
continue a window while offloads, onboards or pool injects are pending.

Left out of this slice: speculative decoding, pipeline/tensor parallelism,
streaming, vision, the tp shard inject (`inject_pages_shard`) and the gather
decode window.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Set

import numpy as np
import torch

from dynamo_tpu_torch.engine.config import (
    EngineConfig, ModelConfig, check_supported,
)
from dynamo_tpu_torch.engine.kv_cache import SequenceState
from dynamo_tpu_torch.engine.offload import CopyStream, HostKvPool
from dynamo_tpu_torch.engine.sampler import (
    RepPenaltyCache, SamplingArrayCache, eos_mask, sample_logits,
    seen_token_mask,
)
from dynamo_tpu_torch.engine.scheduler import (
    DecodePlan, EngineRequest, MixedPlan, PrefillPlan, SamplingParams,
    Scheduler, next_bucket, pow2_buckets, window_ladder,
)
from dynamo_tpu_torch.engine.window_graph import HostCopies, WindowGraphs
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models.llama import AttnMetadata
from dynamo_tpu_torch.ops.attention import write_slots
from dynamo_tpu_torch.observability.metrics import PhaseTimer
from dynamo_tpu_torch.ops.kv_quant import (
    is_quantized_cache, page_bytes, quantize_rows, validate_mode,
)
from dynamo_tpu_torch.ops.quant import (
    is_quantized, quantize_params, validate_mode as validate_quant,
)


@dataclasses.dataclass
class StepOutput:
    """One emitted event for one request after an engine step."""

    request_id: str
    token: Optional[int]           # None when finished without a new token
    finished: bool = False
    finish_reason: Optional[str] = None   # "stop" | "length" | "cancelled"
    # populated when the request asked for logprobs: logprob of `token`,
    # and the top-K alternatives
    logprob: Optional[float] = None
    top_logprobs: Optional[List[tuple]] = None  # [(token_id, logprob), ...]


def resolve_device(device) -> torch.device:
    """The engine's device. CUDA is the default everywhere; asking for it
    without a card raises instead of quietly running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return dev


class NativeEngine:
    """Continuous-batching PyTorch engine for one model on one device."""

    def __init__(
        self,
        model_cfg: ModelConfig,
        engine_cfg: EngineConfig,
        params=None,
        eos_token_ids: Optional[Set[int]] = None,
        seed: int = 0,
        device="cuda",
    ):
        self.device = resolve_device(device)
        check_supported(model_cfg)
        # KV-cache quantization is a deployment knob: a non-empty
        # EngineConfig.kv_quant overrides the model config's
        if engine_cfg.kv_quant:
            model_cfg = dataclasses.replace(
                model_cfg, kv_quant=validate_mode(engine_cfg.kv_quant))
        self.kv_quant = validate_mode(model_cfg.kv_quant)
        self.quant = validate_quant(model_cfg.quant)
        self.model_cfg = model_cfg
        self.cfg = engine_cfg
        self.eos_token_ids = set(eos_token_ids or ())
        # the eos ban's [V] mask, built once (no host copy inside a window)
        self._eos_vec = eos_mask(self.eos_token_ids, model_cfg.vocab_size,
                                 self.device)
        # host KV tier: evicted HBM pages spill to a host slab (and below it
        # to disk) and come back on prefix hits instead of being recomputed
        if engine_cfg.disk_pages > 0 and engine_cfg.host_pages <= 0:
            raise ValueError("disk_pages > 0 requires host_pages > 0: the "
                             "disk tier sits below the host tier")
        self.host_pool = None
        if engine_cfg.host_pages > 0:
            page_shape = (model_cfg.num_layers, model_cfg.num_kv_heads,
                          engine_cfg.page_size, model_cfg.head_dim)
            # the slabs store the device representation verbatim: int8
            # pages + f32 scale rows on an int8 cache
            self.host_pool = HostKvPool(
                engine_cfg.host_pages, page_shape,
                torch.int8 if self.kv_quant else llama.torch_dtype(model_cfg),
                disk_pages=engine_cfg.disk_pages,
                disk_dir=engine_cfg.disk_dir,
                scale_shape=page_shape[:-1] if self.kv_quant else None,
                pin=self.device.type == "cuda")
        self.scheduler = Scheduler(engine_cfg, host_pool=self.host_pool)
        if params is None:
            params = llama.init_params(model_cfg, self.device, seed)
        elif self.quant and not is_quantized(params["layers"]["wq"]):
            # a loader may hand an already-quantized tree; otherwise
            # quantize where the weights live, one layer slice at a time
            params = quantize_params(params)
        self.params = params
        # every device op of the engine runs on its own stream, whichever
        # thread calls step(): window graphs are captured and replayed there
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self.graphs = WindowGraphs(self.device, self._stream)
        self._host_copies = HostCopies()
        # the KV tiers: offloads wait here until the next cache write
        # extracts them; onboard copies run on a stream of their own
        # (_onboards_in_flight: their events, for the copy and inject times)
        self._pending_offloads: list = []
        self._onboards_in_flight: list = []
        self._copy_stream = None
        self._h2d_stream = None
        if self.host_pool is not None:
            self.scheduler.allocator.on_evict = self._offload_page
            self._copy_stream = CopyStream(self.host_pool, self.device,
                                           self.graphs.capture_lock)
            self.scheduler.settle_hashes = self._copy_stream.settle
        if self._stream is not None:
            self._h2d_stream = torch.cuda.Stream(self.device)
        # the shared KV pool (engine/kv_pool.py): attach_kv_pool wires it
        self.kv_pool = None
        self.kv_pool_source = ""
        self._pool_stream = None
        self._dec_state = None   # the last window's sig: its carry is live
        self._pipeline = None    # the in-flight window (pipeline_depth >= 2)
        # one page past the allocator's range: the scratch page that
        # absorbs dropped writes (ops/attention.write_kv_pages)
        self.cache = llama.init_cache(model_cfg, engine_cfg.num_pages + 1,
                                      engine_cfg.page_size, self.device)
        self._window_sizes = window_ladder(engine_cfg.decode_steps)
        # host staging caches; mixed steps get their own pair so the mixed
        # row set and the decode slot set don't evict each other
        self._samp_cache = SamplingArrayCache()
        self._rp_cache = RepPenaltyCache()
        self._mixed_samp_cache = SamplingArrayCache()
        self._mixed_rp_cache = RepPenaltyCache()
        self._last_logprobs = None
        # steps whose sampled logits held a non-finite value, counted on the
        # device (read by logits_nonfinite_steps(), which syncs)
        self._nonfinite = torch.zeros((), dtype=torch.int64,
                                      device=self.device)
        self.window_slot_steps = 0    # device (step, live-slot) pairs run
        self.window_wasted_steps = 0  # of those, after the slot finished
        self.decode_windows = 0
        self.decode_window_steps = 0  # decode_forward calls across windows
        self.decode_host_syncs = 0    # blocking output fetches in decode
        self.decode_dispatches = 0    # device programs launched for windows
        self.decode_plan_uploads = 0  # windows that staged fresh arrays
        self.pipeline_windows = 0     # windows committed through the pipeline
        self.pipeline_overlapped = 0  # ... with a follow-up running meanwhile
        self.pipeline_fallbacks = 0   # follow-ups discarded at reconcile
        self.mixed_steps = 0
        self.decode_stall_steps = 0
        # host wall time per decode-loop phase (tools/torch_decode_profile);
        # profile_sync isolates device time from fetch (attribution runs
        # only: it defeats the overlap it measures)
        self.phases = PhaseTimer()
        self.profile_sync = False
        if self._stream is not None:
            # the weights, cache and counter were made on the caller's stream
            self._stream.wait_stream(torch.cuda.current_stream(self.device))

    @property
    def cache(self):
        return self._cache

    @cache.setter
    def cache(self, value):
        """Rebinding (or freeing) the cache drops the window graphs captured
        over the old one, and with them the device carry."""
        self._sync_stream()
        self._cache = value
        if self._stream is not None and value is not None:
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
        self.graphs.reset()
        self._dec_state = None
        self._pipeline = None

    def _sync_stream(self) -> None:
        if self._stream is not None:
            self._stream.synchronize()

    def _on_stream(self):
        """The engine's stream as the current one (a no-op on the CPU)."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    # -- public API ----------------------------------------------------------

    def _validate_prompt(self, req: EngineRequest) -> EngineRequest:
        """Reject out-of-vocab token ids at admission: an OOV id would
        index past the embedding table."""
        vocab = self.model_cfg.vocab_size
        ids = np.asarray(req.prompt, dtype=np.int64)
        bad = (ids < 0) | (ids >= vocab)
        if bad.any():
            i = int(np.argmax(bad))
            raise ValueError(
                f"request {req.request_id}: token id {req.prompt[i]} at "
                f"position {i} is outside the model vocab [0, {vocab})")
        return req

    def add_request(self, req: EngineRequest) -> None:
        self.scheduler.add_request(self._validate_prompt(req))

    def abort(self, request_id: str) -> bool:
        return self.scheduler.abort(request_id)

    def close(self) -> None:
        """Wait for the device work the engine enqueued (a discarded
        follow-up window may still run) and stop the tier threads (the
        offload copies and the pool publisher drain first)."""
        self._sync_stream()
        self._retire_onboards(wait=True)
        if self._copy_stream is not None:
            self._copy_stream.close()
            self._copy_stream = None
            self.host_pool.close()
        if self._pool_stream is not None:
            self._pool_stream.close()
            self._pool_stream = None

    def drain_kv_events(self):
        """The allocator's stored / removed page events since the last
        drain (host bookkeeping only: no device sync). With a shared pool
        attached, the newly sealed pages are published into it too."""
        events = self.scheduler.allocator.drain_events()
        if self._pool_stream is not None and events:
            self._publish_pool_pages(events)
        return events

    def has_work(self) -> bool:
        s = self.scheduler
        if s.overlap_gates:
            # early decode: activate every gated remote sequence whose
            # committed frontier covers its transfer list, on the thread
            # that applies the injects, before planning
            s.poll_overlap_gates()
        return (self._pipeline is not None or bool(s.waiting)
                or any(x is not None for x in s.running))

    def step(self) -> List[StepOutput]:
        """Run one scheduler step on the device; returns per-request events.

        With pipeline_depth >= 2 the decode loop is two-deep: a step that
        finds an in-flight window dispatches its follow-up FIRST (no host
        arrays: the device carry feeds it), then fetches and commits the
        in-flight window's outputs while the follow-up executes. Events for
        a pipelined window arrive one step() call after its dispatch."""
        with self._on_stream():
            self._retire_onboards()
            if self._pipeline is not None:
                return self._pipeline_step()
            with self.phases.phase("plan"):
                plan = self.scheduler.schedule()
            self._process_offloads()  # save evicted pages before overwrite
            self._process_onboards()  # host-tier pages the plan may read
            self._process_pool_injects()  # shared-pool pages it may read
            if plan is None:
                return []
            if isinstance(plan, MixedPlan):
                return self._run_mixed(plan)
            if isinstance(plan, PrefillPlan):
                # a pure prefill step while decode slots are live starves
                # every running stream for this step
                if any(s is not None for s in self.scheduler.running):
                    self.decode_stall_steps += 1
                return self._run_prefill(plan)
            if self._pipeline_ok(plan):
                return self._prime_pipeline(plan)
            return self._run_decode(plan)

    def generate(self, prompt: List[int], params: SamplingParams,
                 request_id: str = "req") -> List[int]:
        """Synchronous convenience: run one request to completion."""
        self.add_request(EngineRequest(request_id, prompt, params))
        out: List[int] = []
        while True:
            events = self.step()
            done = False
            for ev in events:
                if ev.request_id != request_id:
                    continue
                if ev.token is not None:
                    out.append(ev.token)
                done |= ev.finished
            if done:
                return out
            if not events and not self.has_work():
                return out

    def metrics(self):
        m = self.scheduler.metrics()
        m.window_slot_steps = self.window_slot_steps
        m.window_wasted_steps = self.window_wasted_steps
        m.decode_windows = self.decode_windows
        m.decode_host_syncs = self.decode_host_syncs
        m.decode_dispatches = self.decode_dispatches
        m.decode_plan_uploads = self.decode_plan_uploads
        m.pipeline_windows = self.pipeline_windows
        m.pipeline_overlapped = self.pipeline_overlapped
        m.pipeline_fallbacks = self.pipeline_fallbacks
        m.mixed_steps = self.mixed_steps
        m.decode_stall_steps = self.decode_stall_steps
        # KV representation: bytes one page occupies on the device (k + v,
        # plus scales when quantized) and the quantized bit width (0 = none)
        mc = self.model_cfg
        m.kv_page_bytes = page_bytes(
            mc.num_layers, mc.num_kv_heads, self.cfg.page_size, mc.head_dim,
            llama.torch_dtype(mc).itemsize, bool(self.kv_quant))
        m.kv_quant_bits = 8 if self.kv_quant == "int8" else 0
        # weight representation: device bytes of the whole parameter tree
        # (int8 values + f32 scales where quantized) and the bit width
        m.weight_bytes = _tree_bytes(self.params)
        m.weight_quant_bits = 8 if self.quant == "int8" else 0
        if self.host_pool is not None:
            m.kv_host_pages_used = self.host_pool.used
            m.kv_host_pages_total = self.host_pool.capacity
            if self.host_pool.disk is not None:
                m.kv_disk_pages_used = self.host_pool.disk.used
                m.kv_disk_pages_total = self.host_pool.disk.capacity
        return m

    def logits_nonfinite_steps(self) -> int:
        """Steps whose sampled logits held NaN or inf (waits for the
        device)."""
        with self._on_stream():
            return int(self._nonfinite.item())

    # -- disaggregation ------------------------------------------------------

    def allocate_remote(self, req: EngineRequest):
        """Decode side: allocate a remote prefill's pages up front."""
        return self.scheduler.add_remote(self._validate_prompt(req))

    def activate_remote(self, request_id: str, first_token: int) -> None:
        self.scheduler.activate_remote(request_id, first_token)

    def preactivate_remote(self, request_id: str, first_token: int,
                           needed_pages: int, frontier_fn) -> None:
        """Decode side, early decode: activate the sequence once
        `frontier_fn()` reports every transferred page committed."""
        self.scheduler.preactivate_remote(request_id, first_token,
                                          needed_pages, frontier_fn)

    def cancel_overlap(self, request_id: str) -> bool:
        return self.scheduler.cancel_overlap(request_id)

    def release_remote(self, request_id: str) -> None:
        self.scheduler.release_remote(request_id)

    def salvage_remote(self, request_id: str, valid_pages: int,
                       first_token=None) -> int:
        """Decode side: keep the committed prefix of a failed transfer and
        prefill the rest locally; returns the salvaged token count."""
        return self.scheduler.salvage_remote(request_id, valid_pages,
                                             first_token=first_token)

    def release_parked(self, request_id: str) -> None:
        self.scheduler.release_parked(request_id)

    def _bucket_ids(self, page_ids) -> np.ndarray:
        """A page-id list padded to its page-ladder bucket with
        `num_pages` (the scratch page's index)."""
        n = max(len(page_ids), 1)
        nb = next_bucket(n, self.scheduler.page_buckets)
        out = np.full((nb,), self.cfg.num_pages, np.int64)
        out[:len(page_ids)] = page_ids
        return out

    def extract_pages(self, page_ids) -> dict:
        """Gather whole KV pages of every cache leaf on the engine's stream:
        values [L, Hkv, Nb, ps, hd] and, on an int8 cache, the scales [L,
        Hkv, Nb, ps], in the stored representation. Nb is the ids' page
        bucket; padding rows repeat the last real page (the JAX clamp), so
        the scratch page is never read as data. "ready" is an event on the
        engine's stream after the gather (None on the CPU): a reader on
        another stream waits on it."""
        ids = np.minimum(self._bucket_ids(page_ids), self.cfg.num_pages - 1)
        with self._on_stream():
            idx = self._dev(ids)
            # dynalint: kv-codec (whole pages keep the stored representation)
            out = {key: arr.index_select(2, idx)
                   for key, arr in self.cache.items()}
            out["ready"] = self._record_event()
        return out

    def inject_pages(self, page_ids, k_pages, v_pages, k_scale=None,
                     v_scale=None, ready=None) -> None:
        """Write whole KV pages into this engine's cache at `page_ids`, in
        place (`index_copy_` on every leaf, on the engine's stream, after
        `ready` when given), so the window graphs captured over the cache
        and the device carry stay valid. The pages' bucket may be larger
        than the id list (the sender's ladder): the padding rows go to the
        scratch page. An int8 cache needs the scale stacks and an
        unquantized one refuses them: both sides of a transfer run the same
        kv_quant mode."""
        if self.kv_quant and k_scale is None:
            raise ValueError(
                "this engine stores int8 KV pages (kv_quant="
                f"{self.kv_quant!r}) but the sender shipped no scales; "
                "both sides of a transfer must run the same kv_quant mode")
        if not self.kv_quant and k_scale is not None:
            raise ValueError(
                "sender shipped quantized KV pages but this engine's "
                "cache is unquantized; both sides of a transfer must run "
                "the same kv_quant mode")
        # evicted-but-unsaved pages reach the host tier before this write
        # can overwrite them (an inject may land on an evicted page)
        if self._pending_offloads:
            self._process_offloads()
        nb = k_pages.shape[2]
        if len(page_ids) > nb:
            raise ValueError(
                f"{len(page_ids)} dst pages but only {nb} pages sent")
        ids = np.full((nb,), self.cfg.num_pages, np.int64)
        ids[:len(page_ids)] = page_ids
        pages = {"k": k_pages, "v": v_pages}
        if k_scale is not None:
            pages.update(k_scale=k_scale, v_scale=v_scale)
        with self._on_stream():
            if ready is not None:
                self._stream.wait_event(ready)
            idx = self._dev(ids)
            # dynalint: kv-codec (whole pages keep the stored representation)
            for key, arr in self.cache.items():
                src = pages[key]
                if src.dtype != arr.dtype or src.shape[3:] != arr.shape[3:]:
                    raise ValueError(
                        f"{key} pages of {src.dtype} {tuple(src.shape)} do "
                        f"not fit a {arr.dtype} cache {tuple(arr.shape)}")
                src = src.to(self.device, non_blocking=True)
                arr.index_copy_(2, idx, src)
                if self._stream is not None:
                    # the source may come from another stream's allocation
                    src.record_stream(self._stream)

    def _record_event(self):
        """An event recorded on the engine's stream (None on the CPU)."""
        if self._stream is None:
            return None
        ev = torch.cuda.Event()
        ev.record(self._stream)
        return ev

    # -- KV tiers (engine/offload.py) ----------------------------------------

    def _offload_page(self, pid: int, seq_hash: int) -> None:
        """Allocator eviction hook: queue the page for the host tier. Its
        extraction is enqueued at the next cache write (_process_offloads),
        before anything can overwrite it."""
        self._pending_offloads.append((pid, seq_hash))

    def _process_offloads(self) -> None:
        """Enqueue the extraction of every page evicted since the last cache
        write, in device order; the copies to host slots and the checksums
        run on the CopyStream thread, so the step loop never waits on an
        offload."""
        pending, self._pending_offloads = self._pending_offloads, []
        if self._copy_stream is None or not pending:
            return
        max_b = self.scheduler.page_buckets[-1]
        for start in range(0, len(pending), max_b):
            chunk = pending[start:start + max_b]
            self._copy_stream.submit(
                self._extract_page_major([pid for pid, _ in chunk]),
                [h for _, h in chunk])

    def _extract_page_major(self, page_ids) -> dict:
        """Gather whole pages of every cache leaf into page-major blocks
        ([N, L, Hkv, ps, hd] values, [N, L, Hkv, ps] scales: one contiguous
        run per page) on the engine's stream, with a "ready" event after
        the gather (None on the CPU, where the gather is done on return)."""
        with self._on_stream():
            idx = self._dev(np.asarray(page_ids, np.int64))
            # dynalint: kv-codec (whole pages keep the stored representation)
            out = {key: arr.movedim(2, 0).index_select(0, idx)
                   for key, arr in self.cache.items()}
            out["ready"] = self._record_event()
        return out

    def _process_onboards(self) -> None:
        """Write the host-tier pages _match_prefix claimed into their HBM
        pages before the device step that reads them."""
        pending = self.scheduler.drain_onboards()
        max_b = self.scheduler.page_buckets[-1]
        for start in range(0, len(pending), max_b):
            chunk = pending[start:start + max_b]
            hashes = [h for _, h in chunk]
            got = [self.host_pool.get(h) for h in hashes]
            self._onboard([pid for pid, _ in chunk], got, hashes)
            self.host_pool.stats.onboarded += len(chunk)

    def _onboard(self, page_ids, pages, unpin=()) -> None:
        """Write host pages ((k, v[, k_scale, v_scale]) per page) into the
        cache at `page_ids` with `inject_pages`, then unpin `unpin`. On the
        CPU the pages are stacked (copied) first. On the card each page's
        leaves are copied out of its slab slot, one DMA each, on the onboard
        stream (which waits for no window in flight); the inject waits for
        that copy's event on the engine's stream, and the slots are unpinned
        only once the copy has completed, so no put can overwrite a slot
        the copy still reads."""
        n_leaves = len(pages[0])
        if self._h2d_stream is None:
            stacks = [torch.stack([p[leaf] for p in pages], dim=2)
                      for leaf in range(n_leaves)]
            for h in unpin:
                self.host_pool.unpin(h)
            self.inject_pages(page_ids, *stacks)
            return
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        with torch.cuda.stream(self._h2d_stream):
            ev[0].record(self._h2d_stream)
            blocks = [torch.empty((len(pages),) + tuple(pages[0][leaf].shape),
                                  dtype=pages[0][leaf].dtype,
                                  device=self.device)
                      for leaf in range(n_leaves)]
            for i, p in enumerate(pages):
                for leaf in range(n_leaves):
                    blocks[leaf][i].copy_(p[leaf], non_blocking=True)
            ev[1].record(self._h2d_stream)
        # [N, L, Hkv, ...] -> the [L, Hkv, N, ...] layout inject_pages takes
        self.inject_pages(page_ids, *(b.movedim(0, 2) for b in blocks),
                          ready=ev[1])
        ev[2].record(self._stream)
        ev[1].synchronize()
        for h in unpin:
            self.host_pool.unpin(h)
        nbytes = sum(b.numel() * b.element_size() for b in blocks)
        self._onboards_in_flight.append((ev, nbytes))

    def _retire_onboards(self, wait: bool = False) -> None:
        """Account the copy and inject times of onboards whose injects have
        completed (all of them with wait=True)."""
        keep = []
        t = self.host_pool.times if self.host_pool is not None else None
        for ev, nbytes in self._onboards_in_flight:
            if wait:
                ev[2].synchronize()
            elif not ev[2].query():
                keep.append((ev, nbytes))
                continue
            if t is not None:
                t.h2d_s += ev[0].elapsed_time(ev[1]) / 1e3
                t.h2d_bytes += nbytes
                t.inject_s += ev[1].elapsed_time(ev[2]) / 1e3
                t.onboard_batches += 1
        self._onboards_in_flight = keep

    # -- the shared KV pool (engine/kv_pool.py) ------------------------------

    def attach_kv_pool(self, pool, source_id: str,
                       publish: bool = True) -> None:
        """Join a shared KV pool: the prefix walk gains the pool below the
        host and disk tiers, and (publish=True) every full page this engine
        seals is published into it off the step loop."""
        from dynamo_tpu_torch.engine.kv_pool import PoolPublishStream
        self.kv_pool = pool
        self.kv_pool_source = source_id
        self.scheduler.kv_pool = pool
        self.scheduler.kv_pool_mode = self.kv_quant
        if publish:
            self._pool_stream = PoolPublishStream(
                pool, source_id, mode=self.kv_quant, device=self.device,
                lock=self.graphs.capture_lock)

    def _publish_pool_pages(self, events) -> None:
        """Tee newly sealed full pages into the shared pool, at event-drain
        time: the extraction is enqueued after the steps that sealed them
        and before any later write. A page whose seal is gone (recycled
        since) is skipped: its contents are no longer the hash's. Hashes
        already in the pool only record this source (no copy)."""
        alloc = self.scheduler.allocator
        ship_ids, ship_metas = [], []
        for kind, pid, sh, parent, th in events:
            if kind != "stored" or alloc.pages[pid].seq_hash != sh:
                continue
            if sh in self.kv_pool:
                self.kv_pool.note_source(self.kv_pool_source, sh, parent, th)
            else:
                ship_ids.append(pid)
                ship_metas.append((sh, parent, th))
        max_b = self.scheduler.page_buckets[-1]
        for start in range(0, len(ship_ids), max_b):
            self._pool_stream.submit(
                self._extract_page_major(ship_ids[start:start + max_b]),
                ship_metas[start:start + max_b])

    def _process_pool_injects(self) -> None:
        """Write the shared-pool pages _match_prefix claimed into HBM before
        the device step that reads them. Their bytes were verified at the
        claim (SharedKvPool.fetch), so this is transport only. A claim whose
        page no longer carries the claimed seal (the sequence was released
        and the page recycled) is skipped."""
        pending = self.scheduler.drain_pool_injects()
        alloc = self.scheduler.allocator
        pending = [(pid, arrays) for pid, h, arrays in pending
                   if alloc.pages[pid].seq_hash == h]
        max_b = self.scheduler.page_buckets[-1]
        for start in range(0, len(pending), max_b):
            chunk = pending[start:start + max_b]
            self._onboard([pid for pid, _ in chunk],
                          [arrays for _, arrays in chunk])

    def prefetch_pool_pages(self, tokens) -> int:
        """Warm this prompt's leading pool-resident pages into HBM now,
        sealed into the allocator's reusable pool (ref_count 0, keyed by
        hash), so a later admission's prefix walk hits HBM. Every fetch is
        verified at the claim; a failure keeps the pages warmed before it.
        Warmed pages belong to no request, so a prefetch that races a
        cancel leaks nothing. Runs between device steps; returns the pages
        warmed."""
        from dynamo_tpu_torch.engine.kv_cache import page_hash
        from dynamo_tpu_torch.engine.kv_pool import POOL_STATS
        sch = self.scheduler
        if sch.kv_pool is None:
            return 0
        ps = self.cfg.page_size
        parent, warmed, pids = 0, 0, []
        for i in range(len(tokens) // ps):
            toks = list(tokens[i * ps:(i + 1) * ps])
            h = page_hash(parent, toks)
            if sch.allocator.lookup(h) is not None \
                    or (sch.host_pool is not None and h in sch.host_pool):
                parent = h
                continue   # already warm in a local tier
            if h not in sch.kv_pool or not sch.allocator.can_allocate(1):
                break
            got = sch._pool_claim(h)
            if got is None:
                break
            pid = sch.allocator.allocate()
            sch.allocator.seal(pid, parent, toks)
            sch.pending_pool_injects.append((pid, h, got))
            pids.append(pid)
            warmed += 1
            parent = h
        if warmed:
            self._process_pool_injects()
            for pid in pids:
                # into the reuse pool: content and hash stay until evicted
                sch.allocator.free(pid)
            POOL_STATS.prefetch_pages += warmed
        return warmed

    # -- internals -----------------------------------------------------------

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

    def _sampling_arrays(self, reqs, mixed: bool = False):
        cache = self._mixed_samp_cache if mixed else self._samp_cache
        return cache.arrays(reqs, lambda rid: self.scheduler.params[rid])

    def _rep_penalty_arrays(self, reqs, mixed: bool = False):
        cache = self._mixed_rp_cache if mixed else self._rp_cache
        return cache.arrays(
            reqs, lambda rid: self.scheduler.params[rid],
            self.model_cfg.vocab_size,
            lambda n: next_bucket(n, pow2_buckets(self.cfg.max_model_len)))

    def _wants_logprobs(self, reqs) -> bool:
        return any(seq is not None and
                   self.scheduler.params[seq.request_id].logprobs is not None
                   for seq in reqs)

    def _run_device_step(self, plan, reqs, mixed: bool = False):
        """forward + last-position logits + sample for a prefill or mixed
        plan; returns the sampled tokens as a numpy array."""
        temp, top_k, top_p, seeds, counters, min_toks = \
            self._sampling_arrays(reqs, mixed=mixed)
        rp = self._rep_penalty_arrays(reqs, mixed=mixed)
        with_lp = self._wants_logprobs(reqs)
        toks, lp, top_ids, top_lps = _engine_step(
            self.model_cfg, self._eos_vec, self.params, self.cache,
            self._dev(plan.tokens), self._dev(plan.positions),
            self._dev(plan.page_table), self._dev(plan.kv_lens),
            self._dev(plan.write_idx), self._dev(plan.last_idx),
            self._dev(temp), self._dev(top_k), self._dev(top_p),
            self._dev(seeds), self._dev(counters), self._dev(min_toks),
            hist=None if rp is None else self._dev(rp[0]),
            rep_penalty=None if rp is None else self._dev(rp[1]),
            with_lp=with_lp, greedy=bool(np.all(temp <= 0.0)),
            nonfinite=self._nonfinite)
        out = toks.cpu().numpy()
        self._last_logprobs = ((lp.cpu().numpy(), top_ids.cpu().numpy(),
                                top_lps.cpu().numpy()) if with_lp else None)
        return out

    def _run_prefill(self, plan: PrefillPlan) -> List[StepOutput]:
        sampled = self._run_device_step(plan, plan.seqs)
        lps = self._last_logprobs
        events: List[StepOutput] = []
        # rows commit in REVERSE order: each continuing multi-chunk row is
        # re-queued with appendleft, so reverse iteration leaves the
        # earliest-arrived row back at the head (FIFO preserved)
        for i in reversed(range(len(plan.seqs))):
            seq = plan.seqs[i]
            if seq is None:
                continue
            tok = self.scheduler.commit_prefill_row(
                plan, i, int(sampled[i]) if plan.is_last_chunk[i] else None)
            if tok is None:
                continue
            events.append(self._postprocess_row(seq, tok, lps, i))
        return events

    def _postprocess_row(self, seq, tok, lps, i) -> StepOutput:
        if seq.prefill_only:
            # disaggregated prefill: the first token goes to the transfer
            # layer; stop conditions run on the decode side
            return StepOutput(seq.request_id, tok, True, "prefill_done")
        if lps is None:
            return self._postprocess(seq, tok)
        return self._postprocess(seq, tok, float(lps[0][i]), lps[1][i],
                                 lps[2][i])

    def _run_mixed(self, plan: MixedPlan) -> List[StepOutput]:
        """One fused prefill+decode step: decode rows and prefill chunk
        rows share one [Bb, Tb] forward + sample. Decode rows sample with
        the same (seed, counter) the decode window would use, so streams
        are token-identical to the alternating schedule."""
        sampled = self._run_device_step(plan, plan.seqs, mixed=True)
        lps = self._last_logprobs
        events: List[StepOutput] = []
        # decode rows first (slot order, the decode path's commit order)
        for i, seq in enumerate(plan.seqs):
            if seq is None or not plan.is_decode[i]:
                continue
            self.scheduler.commit_decode_token(seq, int(sampled[i]))
            events.append(self._postprocess_row(seq, seq.output[-1], lps, i))
        # prefill rows commit in REVERSE order (FIFO, as _run_prefill)
        for i in reversed(range(len(plan.seqs))):
            seq = plan.seqs[i]
            if seq is None or plan.is_decode[i]:
                continue
            tok = self.scheduler.commit_prefill_row(
                plan, i, int(sampled[i]) if plan.is_last_chunk[i] else None)
            if tok is None:
                continue
            events.append(self._postprocess_row(seq, tok, lps, i))
        # the decode rows advanced outside the window program: the device
        # carry of the last window is stale
        self._dec_state = None
        self.mixed_steps += 1
        return events

    def _run_decode(self, plan: DecodePlan) -> List[StepOutput]:
        """The synchronous decode window: stage, dispatch, fetch, commit."""
        samp = self._sampling_arrays(plan.seqs)
        rp = self._rep_penalty_arrays(plan.seqs)
        with_lp = self._wants_logprobs(plan.seqs)
        greedy = self._samp_cache.all_greedy
        # the top_p-free sampling tail when every row has top_p disabled;
        # logprob plans keep the full tail
        fused = (not greedy and not with_lp
                 and self._samp_cache.fused_eligible)
        staged = self._stage_window(plan, samp, rp, with_lp, greedy, fused)
        outs = self._dispatch_staged(staged)
        self._dec_state = staged["sig"]
        return self._fetch_and_commit(plan, self._copy_outs_async(outs))

    # -- decode window staging / dispatch ------------------------------------

    def _window_rung(self, plan: DecodePlan) -> int:
        """Smallest ladder rung covering the plan's window."""
        return next((w for w in reversed(self._window_sizes)
                     if w >= max(1, plan.n_window)), self._window_sizes[0])

    def _stage_window(self, plan: DecodePlan, samp, rp, with_lp: bool,
                      greedy: bool, fused: bool = False) -> dict:
        """Stage a decode window's inputs in the static buffers of its
        shapes (window_graph.WindowGraphs.inputs).

        Device-resident decode state: if the slot set and page allocation
        are unchanged since the last window (and no penalty history needs
        refreshing), the buffers still hold this plan's arrays and the last
        window's final (token, position, counter) carry, so steady-state
        windows upload NOTHING."""
        temp, top_k, top_p, seeds, counters, min_toks = samp
        s, pb = plan.page_table.shape
        k_stops = plan.stop_ids.shape[1]
        hb = 0 if rp is None else rp[0].shape[1]
        sig = (tuple((q.request_id, q.epoch) if q else None
                     for q in plan.seqs),
               tuple(len(q.pages) if q else 0 for q in plan.seqs),
               pb, k_stops, rp is None, with_lp, greedy, fused)
        shapes = (s, pb, k_stops, hb)
        i32, f32 = torch.int32, torch.float32
        spec = {"tokens": ((s,), i32), "positions": ((s,), i32),
                "counters": ((s,), i32), "page_table": ((s, pb), i32),
                "max_pos": ((s,), i32), "temperature": ((s,), f32),
                "top_k": ((s,), i32), "top_p": ((s,), f32),
                "seeds": ((s,), i32), "min_tokens": ((s,), i32),
                "ignore_eos": ((s,), torch.bool),
                "stop_ids": ((s, k_stops), i32)}
        if rp is not None:
            spec.update(hist=((s, hb), i32), rep_penalty=((s,), f32))
        bufs = self.graphs.inputs(shapes, spec)
        bufs["nonfinite"] = self._nonfinite
        if self._dec_state != sig or rp is not None:
            with self.phases.phase("upload"):
                ign = np.array([
                    bool(self.scheduler.params[q.request_id].ignore_eos)
                    if q is not None else True for q in plan.seqs])
                host = {"tokens": plan.tokens[:, 0],
                        "positions": plan.positions[:, 0],
                        "counters": counters, "page_table": plan.page_table,
                        "max_pos": plan.max_pos, "temperature": temp,
                        "top_k": top_k, "top_p": top_p, "seeds": seeds,
                        "min_tokens": min_toks, "ignore_eos": ign,
                        "stop_ids": plan.stop_ids}
                if rp is not None:
                    host.update(hist=rp[0], rep_penalty=rp[1])
                for name, arr in host.items():
                    bufs[name].copy_(torch.from_numpy(
                        np.ascontiguousarray(arr)))
            self.decode_plan_uploads += 1
        nw = self._window_rung(plan)
        return {"sig": sig, "bufs": bufs, "nw": nw,
                "key": (rp is not None, with_lp, greedy, fused, nw) + shapes}

    def _window_program(self, staged: dict):
        """The window as a function of its input buffers, for
        WindowGraphs.run: writes the final carry back into them."""
        rp, with_lp, greedy, fused, nw = staged["key"][:5]

        def program(b):
            *outs, carry = _engine_decode_window(
                self.model_cfg, self._eos_vec, self.params, self.cache,
                b["tokens"], b["positions"], b["counters"], b["page_table"],
                b["max_pos"], b["temperature"], b["top_k"], b["top_p"],
                b["seeds"], b["min_tokens"], b["ignore_eos"], b["stop_ids"],
                n_steps=nw, page_size=self.cfg.page_size,
                hist=b.get("hist"), rep_penalty=b.get("rep_penalty"),
                with_lp=with_lp, greedy=greedy, fused=fused,
                nonfinite=b["nonfinite"])
            for name, t in zip(("tokens", "positions", "counters"), carry):
                b[name].copy_(t)
            return tuple(outs)
        return program

    def _dispatch_staged(self, staged: dict):
        """Dispatch one decode window from its staged buffers (the carry
        included): one graph replay on the card. Returns its outputs, still
        on the device."""
        with self.phases.phase("dispatch"):
            outs = self.graphs.run(staged["key"], self._window_program(staged),
                                   staged["bufs"])
        self.decode_windows += 1
        self.decode_window_steps += staged["nw"]
        # one window == one device program (a graph replay on the card)
        self.decode_dispatches += 1
        if self.profile_sync:
            # attribution mode (tools/torch_decode_profile.py): isolate
            # device execution from the fetch phase; serving never sets it
            with self.phases.phase("device"):
                self._sync_stream()
        return outs

    def _copy_outs_async(self, outs):
        """Start the device->host copy of a window's outputs right after its
        dispatch, into pinned buffers of its own (the next replay reuses the
        graph's output buffers)."""
        return self._host_copies.copy_async(outs, self._stream)

    def _fetch_and_commit(self, plan: DecodePlan,
                          handle) -> List[StepOutput]:
        """Blocking output fetch + host commit for one window."""
        with self.phases.phase("fetch"):
            # the one intended host sync per decode window
            toks, lps, top_ids, top_lps = HostCopies.wait(handle)
        self.decode_host_syncs += 1
        with self.phases.phase("commit"):
            return self._commit_window(plan, toks, lps, top_ids, top_lps)

    # -- overlapped decode pipeline ------------------------------------------

    def _pipeline_ok(self, plan: DecodePlan) -> bool:
        """May `plan` enter the overlapped pipeline? Only hot-path windows
        (no logprobs, no penalties), nothing waiting for admission, and only
        when a follow-up window could run off this plan's page tables."""
        sch = self.scheduler
        if self.cfg.pipeline_depth < 2 or sch.waiting or sch.pending_onboards \
                or sch.pending_pool_injects or self._pending_offloads:
            return False
        if self._wants_logprobs(plan.seqs) \
                or self._rep_penalty_arrays(plan.seqs) is not None:
            return False
        return self._followup_fits(plan, next_index=1)

    def _followup_fits(self, plan: DecodePlan, next_index: int) -> bool:
        """Can window `next_index` (0 = the plan's own window) run entirely
        against the plan's staged page tables: its writes land in pages
        listed at staging time, and some slot is still within budget?"""
        nw = self._window_rung(plan)
        live = np.array([q is not None for q in plan.seqs])
        if not live.any():
            return False
        start = plan.positions[:, 0] + next_index * nw
        if np.all(start[live] > plan.max_pos[live]):
            return False   # every slot is out of budget: pure garbage
        covered = np.array([len(q.pages) if q is not None else 0
                            for q in plan.seqs]) * self.cfg.page_size
        # exclusive end of this window's writes, clamped by each request's
        # admission budget (writes beyond max_pos are dropped on device)
        need = np.minimum(start + nw, plan.max_pos + 1)
        return not np.any(need[live] > covered[live])

    def _prime_pipeline(self, plan: DecodePlan) -> List[StepOutput]:
        """Dispatch `plan`'s window and DEFER its commit: its outputs start
        their copy to the host and its events surface on the next step(),
        which dispatches the follow-up window before fetching them."""
        samp = self._sampling_arrays(plan.seqs)
        greedy = self._samp_cache.all_greedy
        fused = not greedy and self._samp_cache.fused_eligible
        staged = self._stage_window(plan, samp, None, False, greedy, fused)
        outs = self._dispatch_staged(staged)
        self._dec_state = staged["sig"]
        # index of the in-flight window relative to the staged plan: 0 =
        # the plan's own window, each follow-up increments it
        self._pipeline = {"plan": plan, "staged": staged, "j": 0,
                          "outs": self._copy_outs_async(outs)}
        return []

    def _membership_intact(self, plan: DecodePlan) -> bool:
        """True while every row of `plan` still maps to the same live
        sequence (no finish, abort or preemption since staging). An
        admission into a slot the plan held as padding does not invalidate
        the in-flight window (the padding row computed nothing and wrote no
        KV): see _slots_grown."""
        running = self.scheduler.running
        return all(q is None or running[i] is q
                   for i, q in enumerate(plan.seqs))

    def _slots_grown(self, plan: DecodePlan) -> bool:
        """A slot the staged plan held as padding is now occupied: results
        in flight stay valid, but further windows off this plan would
        starve the newcomer."""
        running = self.scheduler.running
        return any(q is None and running[i] is not None
                   for i, q in enumerate(plan.seqs))

    def _pipeline_step(self) -> List[StepOutput]:
        """Advance the two-deep decode pipeline by one step():

        1. dispatch the follow-up window (device carry only, no uploads)
           while the in-flight window's outputs are still copying;
        2. fetch the in-flight window's outputs (the one host sync);
        3. commit them on the host while the follow-up runs on the device;
        4. reconcile: if the commit changed slot membership (stop / eos /
           length / abort), the follow-up ran off a stale plan: discard it
           and re-plan synchronously. Its KV writes land past every
           committed position inside pages the staged table owned, and the
           re-run overwrites them."""
        pend, self._pipeline = self._pipeline, None
        self._process_offloads()
        self._process_onboards()
        self._process_pool_injects()
        plan, staged = pend["plan"], pend["staged"]
        follow = None
        sch = self.scheduler
        if pend.get("drain") or sch.waiting or sch.pending_onboards \
                or sch.pending_pool_injects:
            pass    # flagged reconcile or an admission pending: commit the
            #         in-flight window, then re-plan
        elif not self._membership_intact(plan) or self._slots_grown(plan):
            pass    # abort mid-window / a newcomer: commit what's valid
        elif self._followup_fits(plan, pend["j"] + 1):
            outs = self._dispatch_staged(staged)
            follow = {"plan": plan, "staged": staged, "j": pend["j"] + 1,
                      "outs": self._copy_outs_async(outs)}
        events = self._fetch_and_commit(plan, pend["outs"])
        self.pipeline_windows += 1
        intact = self._membership_intact(plan)
        if follow is not None:
            if intact:
                # true overlap: the commit above ran while the follow-up
                # executed on the device
                self.pipeline_overlapped += 1
                if self._slots_grown(plan):
                    # the follow-up is exact for every staged row: commit
                    # it next step, then re-plan so the arrival joins
                    follow["drain"] = True
                self._pipeline = follow
            else:
                # reconciliation fallback: the follow-up assumed occupants
                # the commit just changed; its carry in the buffers is stale
                self.pipeline_fallbacks += 1
                self._dec_state = None
        elif not intact:
            self._dec_state = None
        return events

    def _commit_window(self, plan: DecodePlan, toks: np.ndarray, lps=None,
                       top_ids=None, top_lps=None) -> List[StepOutput]:
        """Unpack a [N, S] window of sampled tokens step-major so each
        request's tokens stream in generation order; stop accounting a
        sequence at its first finished token (later window tokens for it
        are garbage by construction)."""
        n_steps = toks.shape[0]
        events: List[StepOutput] = []
        done: Set[str] = set()
        finish_step: Dict[str, int] = {}
        running = self.scheduler.running
        live = [seq is not None and running[i] is seq
                for i, seq in enumerate(plan.seqs)]
        n_live = sum(live)
        for step in range(n_steps):
            for i, seq in enumerate(plan.seqs):
                if not live[i] or seq.request_id in done:
                    continue
                self.scheduler.commit_decode_token(seq, int(toks[step, i]))
                if lps is not None:
                    ev = self._postprocess(seq, seq.output[-1],
                                           float(lps[step, i]),
                                           top_ids[step, i],
                                           top_lps[step, i])
                else:
                    ev = self._postprocess(seq, seq.output[-1])
                events.append(ev)
                if ev.finished:
                    done.add(seq.request_id)
                    finish_step[seq.request_id] = step
        # wasted-step accounting: device steps a slot ran after its request
        # finished inside this window
        self.window_slot_steps += n_steps * n_live
        self.window_wasted_steps += sum(n_steps - 1 - s
                                        for s in finish_step.values())
        return events

    def _postprocess(self, seq: SequenceState, tok: int,
                     lp: Optional[float] = None, top_ids=None,
                     top_lps=None) -> StepOutput:
        p = self.scheduler.params[seq.request_id]
        n_out = len(seq.output)
        finish = None
        emit: Optional[int] = tok
        # hidden stop ids always stop and are never emitted; eos before
        # min_tokens cannot occur (the sampler bans it)
        if tok in p.stop_token_ids:
            finish, emit = "stop", None
        elif not p.ignore_eos and tok in self.eos_token_ids:
            finish, emit = "stop", None
        elif n_out >= p.max_tokens:
            finish = "length"
        if finish is not None:
            self.scheduler.finish(seq)
        ev = StepOutput(seq.request_id, emit, finish is not None, finish)
        if p.logprobs is not None and emit is not None and lp is not None:
            ev.logprob = lp
            k = max(0, min(int(p.logprobs), len(top_ids)))
            ev.top_logprobs = [(int(t), float(v))
                               for t, v in zip(top_ids[:k], top_lps[:k])]
        return ev


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def _scatter_new_kv(cache, k_news, v_news, write_idx):
    """One in-place scatter of all layers' new kv rows (deferred write).

    cache {k, v[, k_scale, v_scale]}: [L, Hkv, P, ps, hd] (+ [L, Hkv, P,
    ps] scales); k_news/v_news [L, S, Hkv, hd] full-precision rows;
    write_idx [S] flat token slots (<0 = dropped: those rows land in the
    cache's last page, the scratch page no page table references). On an
    int8 cache the rows quantize here and the int8 values and f32 scales
    scatter together."""
    l, hkv, p, ps, hd = cache["k"].shape  # dynalint: kv-codec (shape only)
    idx = write_slots(write_idx, p, ps)
    for key, new in (("k", k_news), ("v", v_news)):
        flat = cache[key].view(l, hkv, p * ps, hd)
        if is_quantized_cache(cache):
            new, scale = quantize_rows(new)   # [L,S,Hkv,hd] / [L,S,Hkv]
            cache[f"{key}_scale"].view(l, hkv, p * ps).index_copy_(
                2, idx, scale.permute(0, 2, 1))
        flat.index_copy_(2, idx, new.permute(0, 2, 1, 3).to(flat.dtype))
    return cache


def _engine_step(cfg: ModelConfig, eos, params, cache, tokens,
                 positions, page_table, kv_lens, write_idx, last_idx,
                 temperature, top_k, top_p, seeds, counters, min_tokens,
                 hist=None, rep_penalty=None, with_lp=False, greedy=False,
                 nonfinite=None):
    """forward + last-position logits + sample for one prefill or mixed
    step (eos: the engine's [V] eos mask or None). Returns (tokens [B]
    int32, sampled_lp, top_ids, top_lps), the lp outputs None unless
    with_lp. The cache is updated in place."""
    meta = AttnMetadata(positions=positions, page_table=page_table,
                        kv_lens=kv_lens, write_idx=write_idx)
    last, _ = llama.forward(params, cfg, tokens, cache, meta,
                            last_idx=last_idx)          # [B, V] f32
    if nonfinite is not None:
        nonfinite += (~torch.isfinite(last)).any()
    seen = (seen_token_mask(hist, cfg.vocab_size)
            if rep_penalty is not None else None)
    return sample_logits(last, eos, temperature, top_k, top_p, seeds,
                         counters, min_tokens, seen=seen,
                         rep_penalty=rep_penalty, with_lp=with_lp,
                         greedy=greedy)


def _engine_decode_window(cfg: ModelConfig, eos, params, cache, tokens,
                          positions, counters, page_table, max_pos,
                          temperature, top_k, top_p, seeds, min_tokens,
                          ignore_eos, stop_ids, *, n_steps: int,
                          page_size: int, hist=None, rep_penalty=None,
                          with_lp=False, greedy=False, fused=False,
                          nonfinite=None):
    """N decode iterations, the sampled token feeding the next on the
    device: the JAX package's kernel-mode window body
    (dynamo_tpu/engine/engine.py:2278-2358).

    tokens / positions / counters [S] are the fed token, its position and
    the sampling counter of step 0; max_pos [S] is the highest position a
    slot may write (-1 for padding); eos is the engine's [V] eos mask or
    None; ignore_eos [S] bool; stop_ids [S, K] hidden stop ids (-1
    padded). The carry (token, position, counter, seen, alive) stays on the
    device: each step attends the prefix clip(pos, 0, max_pos + 1), runs
    decode_forward with the cache read-only, then scatters the step's kv
    rows into the cache in place at its write slot, dropped (into the
    scratch page) once the slot is past max_pos or dead. A slot dies when
    it samples an eos id (unless ignore_eos) or a stop id.

    Returns (tokens [N, S] int32, lps, top_ids, top_lps, (tok_f, pos_f,
    ctr_f)), still on the device; the lp outputs are None unless with_lp.
    Nothing here copies between host and device or waits on the device, so
    the window can be captured in a CUDA graph."""
    s = tokens.shape[0]
    rows = torch.arange(s, device=tokens.device)
    seen = (seen_token_mask(hist, cfg.vocab_size)
            if rep_penalty is not None else None)
    tok, pos, ctr = tokens, positions, counters
    alive = max_pos >= 0
    outs = []
    for _ in range(n_steps):
        writable = (pos <= max_pos) & alive
        prefix = torch.minimum(torch.clamp(pos, min=0), max_pos + 1)
        # flat global-cache slot of this step's row (-1 = dropped)
        page = page_table[rows, torch.clamp(torch.minimum(pos, max_pos),
                                            min=0).long() // page_size]
        write_idx = torch.where(writable,
                                page * page_size + pos % page_size, -1)
        logits, k_news, v_news = llama.decode_forward(
            params, cfg, tok, cache, page_table, prefix, pos)
        _scatter_new_kv(cache, k_news, v_news, write_idx)
        if nonfinite is not None:
            nonfinite += (~torch.isfinite(logits)).any()
        nxt, lp, top_ids, top_lps = sample_logits(
            logits, eos, temperature, top_k, top_p, seeds, ctr, min_tokens,
            seen=seen, rep_penalty=rep_penalty, with_lp=with_lp,
            greedy=greedy, fused=fused)
        if seen is not None:
            seen.scatter_(1, nxt[:, None].long(), True)
        if eos is not None:
            alive = alive & (ignore_eos | ~eos[nxt.long()])
        if stop_ids.shape[1]:
            # hidden stop ids kill the slot whatever ignore_eos says
            alive = alive & ~(nxt[:, None] == stop_ids).any(dim=1)
        outs.append((nxt, lp, top_ids, top_lps))
        tok, pos, ctr = nxt, pos + 1, ctr + 1
    toks = torch.stack([o[0] for o in outs])
    if not with_lp:
        return toks, None, None, None, (tok, pos, ctr)
    return (toks, torch.stack([o[1] for o in outs]),
            torch.stack([o[2] for o in outs]),
            torch.stack([o[3] for o in outs]), (tok, pos, ctr))
