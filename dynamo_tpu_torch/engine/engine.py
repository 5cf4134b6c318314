"""NativeEngine: the PyTorch serving engine for one model on one device.

Port of dynamo_tpu/engine/engine.py for the slice's main path. The
scheduler (engine/scheduler.py) plans prefill, mixed and decode steps;
prefill and mixed steps run `models/llama.forward` and sample one token per
row (`_engine_step`); decode runs a window of `decode_steps` iterations of
`models/llama.decode_forward` (`_engine_decode_window`), the sampled token
feeding the next iteration on the device, with ONE device-to-host copy of
the window's tokens at its end.

The decode window is one of the JAX package's two window bodies
(dynamo_tpu/engine/engine.py:2236-2371), after the decode path the engine
resolves once, at build (models/llama.decode_path; `decode_path`,
`decode_path_reason`, named in `metrics()`). It carries (token, position,
counter, seen, alive) on the device and derives each step's attended
prefix and write slot there; the cache is read-only inside each step. The
ragged path's body (the kernel-mode body) runs the ragged kernel in prefix
mode plus combine_self_attention and scatters each step's new kv rows into
the cache in place (`scatter_new_kv`; on an int8 cache the rows quantize
there). The gather path's body (the pregather body) gathers each slot's
valid pages into a base once a window (`_gather_base`; int8 pages
dequantized there), keeps the window's rows in full precision in a small
buffer, attends base + buffer + the current token in one softmax
(ops/attention.decode_attention_split: Gemma-2's soft-cap, sliding
windows and query scale live there) and scatters the window's rows into
the cache once, at its end; its base width, the page bucket of the
longest valid prefix, is part of the window's key. A slot that samples
eos (unless ignore_eos) or a hidden stop id dies on the device and writes
no more KV. The window returns its final (token, position, counter), so
an unchanged slot set re-dispatches with zero uploads (`_stage_window`).

On the card each window variant is ONE captured CUDA graph
(engine/window_graph.py), the counterpart of the JAX engine's jitted
window programs: `decode_dispatches` counts one replay per window.

With ModelConfig.quant == "int8" the weights are int8 with per-output-
channel scales (ops/quant.py): an unquantized `params` tree is quantized
on its device, as the JAX engine quantizes on the host
(dynamo_tpu/engine/engine.py:289-297). A decode window's projections then
run the W8A16 kernel inside the window's graph.

Mixture-of-experts models (dynamo_tpu/engine/engine.py:245-247, :711-725,
:1935-1940): with moe_impl="dispatch" every program returns the summed
(dropped, routed) pair counts of its expert dispatch as outputs, a window
the sum over its steps, and the host adds them to `moe_dropped_tokens` /
`moe_routed_tokens` when it reads that program's tokens; a program whose
outputs are never read (a graph's warm-up, a discarded follow-up window)
counts nothing, as in the JAX engine. The window routes only its writable
rows (`valid`), prefill and mixed steps only their real positions.

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

Speculative decoding (dynamo_tpu/engine/engine.py:379-433, :917-945,
:1335-1490, :2379-2420; engine/spec.py): with `spec_decode` set, a greedy
decode plan without logprobs or penalties may verify drafts instead of
running its window, when the cost gate (`_spec_worthwhile`, an acceptance
EMA with a probe cadence) says the drafts beat the window. The drafts come
from prompt lookup ("ngram") or a draft model ("draft", spec.DraftModel,
over the target's page table). The verify is one forward over each slot's
[last token, drafts] block with a greedy argmax at every position under
the min-tokens eos ban (`_engine_verify_step`; on the ragged path the
block attends its prefix through the ragged kernel), on the card one
graph replay a block shape (engine/window_graph.py); the longest matching
prefix plus the model's own token commit through `commit_decode_token` /
`_postprocess`. A spec engine never pipelines.

Vision (dynamo_tpu/engine/engine.py:461-468, :503-564, :582, :793-807,
:1702-1713): a multimodal model's tower (models/vision.py) runs at
admission, the "vision prefill": `_resolve_mm` encodes a request's raw
pixels (`encode_image`, one eager call on the engine's stream; f32 embeds
on the host, where JAX hands back the model dtype as an ml_dtypes array
and the scheduler widens it to f32) and salts each span from the pixels'
bytes (kv_cache.content_salt). The scheduler rewrites the span's
placeholder ids to the salts and slices each prefill chunk's rows of the
span into the plan (`mm_embeds` / `mm_mask`), which the prefill and mixed
steps hand to `llama.forward`. `_validate_prompt` exempts span positions
from the vocabulary check.

Streaming past the page budget (dynamo_tpu/engine/engine.py:469-501,
:648-649, :764-787, :1152, :1924-1932; engine/streaming.py): with
`stream_pages > 0` a request whose pages exceed `stream_resident_pages`
runs through the StreamingDecoder, one prefill chunk or one token a
`StreamPlan` step (`_run_stream`), and no pipeline starts while one is
active. The JAX refusals stand where the port has the knob: no host tier,
spec_decode, an MoE dispatch, attention soft-caps or sliding windows.

The per-step ledger (dynamo_tpu/engine/engine.py:202-220, :732-785;
observability/ledger.py): every committed device step records one host-
int sample at its commit site (prefill, mixed, each committed decode
window, a spec verify, a streamed step), and the dispatch sites note each
(program, bucket) key on the JAX engine's keys (`_note_program`: "step",
"window", "verify"); a first-seen key counts as a recompile on the next
sample. On the card a first-seen window or verify key is, as a rule, a
graph capture. A window discarded at a pipeline reconcile is never
committed and records nothing, as in JAX. `metrics()` carries the
ledger's figures as `engine_*` (the worker's $STATS). `DYN_LEDGER=0`
turns the ledger off; the streams are the same either way.

Left out of this slice: pipeline/tensor/expert parallelism and the tp shard
inject (`inject_pages_shard`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import math
import os
from typing import Dict, List, Optional, Set

import numpy as np
import torch

from dynamo_tpu_torch.engine import spec
from dynamo_tpu_torch.engine.config import (
    EngineConfig, ModelConfig, check_supported, get_model_config,
)
from dynamo_tpu_torch.engine.kv_cache import SequenceState, content_salt
from dynamo_tpu_torch.engine.offload import CopyStream, HostKvPool
from dynamo_tpu_torch.engine.sampler import (
    RepPenaltyCache, SamplingArrayCache, eos_mask, sample_logits,
    seen_token_mask,
)
from dynamo_tpu_torch.engine.scheduler import (
    DecodePlan, EngineRequest, MixedPlan, PrefillPlan, SamplingParams,
    Scheduler, StreamPlan, next_bucket, pow2_buckets, window_ladder,
)
from dynamo_tpu_torch.engine.window_graph import HostCopies, WindowGraphs
from dynamo_tpu_torch.models import llama, vision
from dynamo_tpu_torch.models.llama import AttnMetadata
from dynamo_tpu_torch.ops.attention import scatter_new_kv, write_slots
from dynamo_tpu_torch.observability.ledger import (
    StepLedger, model_flops_per_token, sampler_flops_per_token,
)
from dynamo_tpu_torch.observability.metrics import PhaseTimer
from dynamo_tpu_torch.ops.kv_quant import (
    dequantize_rows, is_quantized_cache, page_bytes, validate_mode,
)
from dynamo_tpu_torch.ops.quant import (
    is_quantized, quantize_params, validate_mode as validate_quant,
)
from dynamo_tpu_torch.runtime.integrity import XFER_STATS


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
        draft_params=None,
    ):
        self.device = resolve_device(device)
        check_supported(model_cfg, self.device)
        # KV-cache quantization is a deployment knob: a non-empty
        # EngineConfig.kv_quant overrides the model config's
        if engine_cfg.kv_quant:
            model_cfg = dataclasses.replace(
                model_cfg, kv_quant=validate_mode(engine_cfg.kv_quant))
        self.kv_quant = validate_mode(model_cfg.kv_quant)
        self.quant = validate_quant(model_cfg.quant)
        self.model_cfg = model_cfg
        # the decode attention path, resolved once here and never switched
        # after (models/llama.decode_path): "ragged" (the kernel) or
        # "gather" (the attention knobs, a geometry the kernel cannot
        # take, or decode_kernel="off"), with the reason
        self.decode_path, self.decode_path_reason = llama.decode_path(
            model_cfg)
        if self.decode_path == "gather" and model_cfg.decode_kernel != "off":
            logging.getLogger(__name__).warning(
                "model %r, decode_kernel=%r: %s; decoding through the gather "
                "window", model_cfg.name, model_cfg.decode_kernel,
                self.decode_path_reason)
        # the gather path's window form: True = the pregather window (the
        # base gathered once a window, an in-window buffer, one writeback
        # scatter: serving); False = the per-token deferred gather with a
        # scatter every step (a reference the chip smoke run and the tests
        # hold the window to)
        self.pregather = self.decode_path == "gather"
        self.decode_kernel_tag = ""   # the last window's path + tail
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
        # speculative decoding: verify forwards run, drafts proposed and
        # accepted; the acceptance EMA starts optimistic, and the gate's
        # rejections since its last probe
        self.spec_steps = 0
        self.spec_proposed_tokens = 0
        self.spec_accepted_tokens = 0
        self._spec_acc_ema = 1.0
        self._spec_gate_skips = 0
        self._draft = None
        self._spec = self._build_spec(draft_params, seed)
        # MoE capacity accounting: (token, expert) pairs the dispatch routed
        # and dropped over capacity, summed from committed programs
        self.moe_dropped_tokens = 0.0
        self.moe_routed_tokens = 0.0
        self._moe_drop_warned = False
        # host wall time per decode-loop phase (tools/torch_decode_profile);
        # profile_sync isolates device time from fetch (attribution runs
        # only: it defeats the overlap it measures)
        self.phases = PhaseTimer()
        # the legs double as spans of the "engine" scope (tracing's
        # deferred recorder; one branch while tracing is off)
        self.phases.trace_scope = "engine"
        self.profile_sync = False
        # the per-step ledger: a bounded ring of host-int samples recorded
        # at the commit sites; the MFU numerator counts the model's matmuls
        # and the sampling tail's vocab-sized work
        self.ledger = StepLedger(
            flops_per_token=model_flops_per_token(model_cfg)
            + sampler_flops_per_token(model_cfg))
        # (program, bucket) keys already dispatched: a key's first
        # dispatch counts as a recompile on the next ledger sample
        self._seen_programs: set = set()
        self._pending_recompiles = 0
        self._streamer = self._build_streamer()
        if self._stream is not None:
            # the weights, cache and counter were made on the caller's stream
            self._stream.wait_stream(torch.cuda.current_stream(self.device))

    def _build_spec(self, draft_params, seed: int) -> bool:
        """Check the spec_* knobs (the JAX engine's refusals,
        dynamo_tpu/engine/engine.py:387-433) and build the draft model for
        "draft" mode; True when speculative decoding is on. The JAX refusal
        of sequence parallelism has nothing to refuse here: the port runs
        no sp mesh."""
        ecfg = self.cfg
        if not ecfg.spec_decode:
            return False
        if ecfg.spec_decode not in ("ngram", "draft"):
            raise ValueError(
                f"unknown spec_decode mode {ecfg.spec_decode!r} "
                "(supported: 'ngram', 'draft')")
        if ecfg.spec_k < 1:
            raise ValueError("spec_decode requires spec_k >= 1")
        if ecfg.spec_decode != "draft":
            return True
        name = ecfg.spec_draft_model
        if not name:
            raise ValueError(
                "spec_decode='draft' requires spec_draft_model "
                "(a registry name or an HF checkpoint dir)")
        if os.path.isdir(name):
            from dynamo_tpu_torch.models.loader import load_model_dir
            dcfg, loaded = load_model_dir(name, device=self.device)
            if draft_params is None:
                draft_params = loaded
        else:
            dcfg = get_model_config(name)
        if dcfg.vocab_size != self.model_cfg.vocab_size:
            raise ValueError(
                f"draft vocab {dcfg.vocab_size} != target vocab "
                f"{self.model_cfg.vocab_size}: the draft's token ids feed "
                "the target's verify block verbatim")
        check_supported(dcfg, self.device)
        self._draft = spec.DraftModel(dcfg, ecfg, self.device,
                                      params=draft_params, seed=seed,
                                      stream=self._stream)
        # the draft's captures exclude the threads the engine's exclude
        self._draft.graphs.capture_lock = self.graphs.capture_lock
        return True

    def _build_streamer(self):
        """The StreamingDecoder when stream_pages > 0, after the JAX
        engine's refusals (dynamo_tpu/engine/engine.py:469-501; the port runs
        no pp / sp mesh, so that one has nothing to refuse)."""
        ecfg, mcfg = self.cfg, self.model_cfg
        if ecfg.stream_pages <= 0:
            return None
        if ecfg.host_pages <= 0:
            raise ValueError(
                "stream_pages > 0 requires host_pages > 0: cold "
                "pages live in the host/disk offload tiers")
        if ecfg.spec_decode:
            raise ValueError(
                "tiered-KV streaming does not compose with "
                "spec_decode (the streamed step has no verify "
                "block); disable one of them")
        if mcfg.is_moe and mcfg.moe_impl == "dispatch":
            raise ValueError(
                "tiered-KV streaming requires moe_impl='dense' on "
                "MoE models (the streamed per-layer loop uses the "
                "dense-compute MLP path)")
        if mcfg.attn_softcap or mcfg.sliding_window:
            raise ValueError(
                "tiered-KV streaming supports full attention only "
                "(no attn_softcap / sliding_window): a sliding "
                "window never exceeds the resident budget anyway")
        from dynamo_tpu_torch.engine.streaming import StreamingDecoder
        streamer = StreamingDecoder(self)
        self.scheduler.stream_enabled = True
        self.scheduler.on_stream_finish = streamer.release
        return streamer

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

    def encode_image(self, pixels: np.ndarray) -> np.ndarray:
        """pixels [H, W, 3] or [B, H, W, 3] float in [0, 1] ->
        [n_patches, D_text] (or [B, n_patches, D_text]) f32 embeds on the
        host: the tower's output in the model dtype, widened."""
        if self.model_cfg.vision is None:
            raise ValueError(f"model {self.model_cfg.name!r} has no vision "
                             "encoder configured")
        px = np.asarray(pixels, np.float32)
        single = px.ndim == 3
        if single:
            px = px[None]
        with self._on_stream():
            emb = vision.encode(self.params["vision"], self.model_cfg,
                                self._dev(px))
            out = emb.float().cpu().numpy()
        return out[0] if single else out

    def _resolve_mm(self, req: EngineRequest) -> EngineRequest:
        """Encode a request's raw pixels into text-space embeds (the
        "vision prefill"). The salts derive from the PIXEL bytes, not the
        embeds, so both sides of a disaggregated pair compute the same page
        hashes whatever their towers' numerics."""
        if not req.mm_pixels:
            return req
        spans = list(req.mm_spans or [])
        for off, px in req.mm_pixels:
            px = np.asarray(px, np.float32)
            spans.append((int(off), self.encode_image(px),
                          content_salt(px.tobytes())))
        return dataclasses.replace(req, mm_spans=spans, mm_pixels=None)

    def _validate_prompt(self, req: EngineRequest) -> EngineRequest:
        """Reject out-of-vocab token ids at admission: an OOV id would
        index past the embedding table. Multimodal span positions are
        exempt: their placeholder ids become content salts that never
        feed the embedding table (scheduler._admit)."""
        vocab = self.model_cfg.vocab_size
        ids = np.asarray(req.prompt, dtype=np.int64)
        bad = (ids < 0) | (ids >= vocab)
        for item in req.mm_spans or ():
            off, n = int(item[0]), np.asarray(item[1]).shape[0]
            bad[off:off + n] = False
        if bad.any():
            i = int(np.argmax(bad))
            raise ValueError(
                f"request {req.request_id}: token id {req.prompt[i]} at "
                f"position {i} is outside the model vocab [0, {vocab})")
        return req

    def add_request(self, req: EngineRequest) -> None:
        self.scheduler.add_request(
            self._validate_prompt(self._resolve_mm(req)))

    def abort(self, request_id: str) -> bool:
        if self._draft is not None:
            self._draft.forget(request_id)
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
                or bool(s.stream_active)
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
            if isinstance(plan, StreamPlan):
                return self._run_stream(plan)
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
        m.spec_steps = self.spec_steps
        m.spec_proposed_tokens = self.spec_proposed_tokens
        m.spec_accepted_tokens = self.spec_accepted_tokens
        m.decode_path = self.decode_path
        m.decode_path_reason = self.decode_path_reason
        m.decode_kernel_tag = self.decode_kernel_tag
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
        m.kv_transfer_bytes = XFER_STATS.bytes_sent
        m.kv_transfer_fetches = XFER_STATS.fetches
        m.kv_transfer_resumes = XFER_STATS.resumes
        m.kv_transfer_salvaged_pages = XFER_STATS.salvaged_pages
        m.kv_transfer_stale_chunks = XFER_STATS.stale_chunks
        m.kv_transfer_link_timeouts = XFER_STATS.link_timeouts
        # the ledger's figures, per engine (the shared LEDGER_STATS fold is
        # process-cumulative)
        m.engine_steps = self.ledger.steps
        m.engine_recompiles = self.ledger.recompiles_total
        m.engine_tok_s = round(self.ledger.tok_s, 3)
        m.engine_mfu = round(self.ledger.mfu, 6)
        m.engine_pad_frac = round(self.ledger.pad_fraction(), 4)
        if self.host_pool is not None:
            m.kv_host_pages_used = self.host_pool.used
            m.kv_host_pages_total = self.host_pool.capacity
            if self.host_pool.disk is not None:
                m.kv_disk_pages_used = self.host_pool.disk.used
                m.kv_disk_pages_total = self.host_pool.disk.capacity
        if self._streamer is not None:
            from dynamo_tpu_torch.engine.streaming import STREAM_STATS
            m.kv_stream_steps = int(STREAM_STATS.stream_steps)
            m.kv_stream_prefetch_hit = int(STREAM_STATS.prefetch_hit)
            m.kv_stream_prefetch_late = int(STREAM_STATS.prefetch_late)
            m.kv_stream_pages_spilled = int(STREAM_STATS.pages_spilled)
            m.kv_stream_pages_quarantined = int(
                STREAM_STATS.pages_quarantined)
            m.kv_stream_stall_steps = int(STREAM_STATS.stall_steps)
        return m

    def moe_drop_rate(self) -> float:
        """Fraction of routed (token, expert) assignments dropped over
        expert capacity since engine start (0.0 for non-MoE models)."""
        if self.moe_routed_tokens <= 0:
            return 0.0
        return self.moe_dropped_tokens / self.moe_routed_tokens

    def _account_moe(self, counts) -> None:
        """Add one committed program's (dropped, routed) pair counts; warn
        once when more than 1% of the pairs were dropped (capacity drops
        are invisible in the output otherwise)."""
        self.moe_dropped_tokens += float(counts[0])
        self.moe_routed_tokens += float(counts[1])
        rate = self.moe_drop_rate()
        if rate > 0.01 and not self._moe_drop_warned \
                and self.moe_routed_tokens > 1000:
            self._moe_drop_warned = True
            logging.getLogger(__name__).warning(
                "MoE dispatch dropping %.2f%% of (token, expert) "
                "assignments over capacity (capacity_factor=%s); "
                "outputs are degraded — raise moe_capacity_factor or "
                "use moe_impl='dense'", rate * 100,
                self.model_cfg.moe_capacity_factor)

    def logits_nonfinite_steps(self) -> int:
        """Steps whose sampled logits held NaN or inf (waits for the
        device)."""
        with self._on_stream():
            return int(self._nonfinite.item())

    # -- disaggregation ------------------------------------------------------

    def allocate_remote(self, req: EngineRequest):
        """Decode side: allocate a remote prefill's pages up front."""
        return self.scheduler.add_remote(
            self._validate_prompt(self._resolve_mm(req)))

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

    def _note_program(self, key: tuple) -> None:
        """The first dispatch of a (program, bucket-shape) key counts as a
        recompile; pending counts attach to the next ledger sample."""
        if key not in self._seen_programs:
            self._seen_programs.add(key)
            self._pending_recompiles += 1

    def _ledger_record(self, kind: str, rows: int, rows_live: int,
                       useful: int, padded: int, **stream_kw) -> None:
        """One ledger sample at a commit site, from host state only
        (allocator counters, the host tier's counts, the waiting queue):
        nothing here reads a device tensor. `stream_kw` carries a streamed
        step's window-pool deltas."""
        if not self.ledger.enabled:
            return
        alloc = self.scheduler.allocator
        hp = self.host_pool
        host_used = hp.used if hp is not None else 0
        host_total = hp.capacity if hp is not None else 0
        disk = hp.disk if hp is not None else None
        disk_used = disk.used if disk is not None else 0
        disk_total = disk.capacity if disk is not None else 0
        rc, self._pending_recompiles = self._pending_recompiles, 0
        self.ledger.record_step(
            kind, rows, rows_live, useful, padded,
            alloc.num_pages - alloc.num_free, alloc.num_pages,
            host_used, host_total, disk_used, disk_total,
            len(self.scheduler.waiting), rc, **stream_kw)

    def _run_device_step(self, plan, reqs, mixed: bool = False):
        """forward + last-position logits + sample for a prefill or mixed
        plan; returns the sampled tokens as a numpy array."""
        temp, top_k, top_p, seeds, counters, min_toks = \
            self._sampling_arrays(reqs, mixed=mixed)
        rp = self._rep_penalty_arrays(reqs, mixed=mixed)
        with_lp = self._wants_logprobs(reqs)
        mm = plan.mm_embeds is not None
        self._note_program(("step", rp is not None, with_lp, mm,
                            plan.tokens.shape, plan.page_table.shape[1],
                            None if rp is None else rp[0].shape[1]))
        toks, lp, top_ids, top_lps, moe = _engine_step(
            self.model_cfg, self._eos_vec, self.params, self.cache,
            self._dev(plan.tokens), self._dev(plan.positions),
            self._dev(plan.page_table), self._dev(plan.kv_lens),
            self._dev(plan.write_idx), self._dev(plan.last_idx),
            self._dev(temp), self._dev(top_k), self._dev(top_p),
            self._dev(seeds), self._dev(counters), self._dev(min_toks),
            hist=None if rp is None else self._dev(rp[0]),
            rep_penalty=None if rp is None else self._dev(rp[1]),
            with_lp=with_lp, greedy=bool(np.all(temp <= 0.0)),
            nonfinite=self._nonfinite, path=self.decode_path,
            mm_embeds=self._dev(plan.mm_embeds) if mm else None,
            mm_mask=self._dev(plan.mm_mask) if mm else None)
        out = toks.cpu().numpy()
        if moe is not None:
            # read after the tokens' copy, which waited for the step
            self._account_moe(moe.cpu().numpy())
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
        self._ledger_record(
            "prefill", len(plan.seqs),
            sum(1 for q in plan.seqs if q is not None),
            sum(plan.n_valid), int(plan.tokens.size))
        return events

    def _run_stream(self, plan: StreamPlan) -> List[StepOutput]:
        """One streamed step (engine/streaming.py): a prefill chunk or one
        decoded token of a sequence whose context exceeds the resident page
        budget; this wrapper owns the event and the ledger sample
        (kind "stream", with the step's prefetch hit / late / spill / stall
        deltas)."""
        from dynamo_tpu_torch.engine.streaming import STREAM_STATS
        seq = plan.seq
        st0 = (STREAM_STATS.prefetch_hit, STREAM_STATS.prefetch_late,
               STREAM_STATS.pages_spilled, STREAM_STATS.stall_steps)
        tok, _ = self._streamer.step(seq)
        events: List[StepOutput] = []
        if tok is not None:
            seq.output.append(tok)
            events.append(self._postprocess(seq, tok))
        st1 = (STREAM_STATS.prefetch_hit, STREAM_STATS.prefetch_late,
               STREAM_STATS.pages_spilled, STREAM_STATS.stall_steps)
        self._ledger_record(
            "stream", 1, 1, 1 if tok is not None else 0, 1,
            stream_hit=st1[0] - st0[0], stream_late=st1[1] - st0[1],
            stream_spilled=st1[2] - st0[2], stream_stalls=st1[3] - st0[3])
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
        self._ledger_record(
            "mixed", len(plan.seqs),
            sum(1 for q in plan.seqs if q is not None),
            sum(plan.n_valid), int(plan.tokens.size))
        return events

    def _run_decode(self, plan: DecodePlan) -> List[StepOutput]:
        """The synchronous decode window: stage, dispatch, fetch, commit;
        or, with speculative decoding, a verify of drafts when the cost
        gate passes them."""
        samp = self._sampling_arrays(plan.seqs)
        rp = self._rep_penalty_arrays(plan.seqs)
        with_lp = self._wants_logprobs(plan.seqs)
        greedy = self._samp_cache.all_greedy
        if self._spec and greedy and not with_lp and rp is None:
            events = self._try_spec(plan, samp[4], samp[5])
            if events is not None:
                return events
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

    def _base_pb(self, plan: DecodePlan) -> int:
        """The gather window's base width in pages: the bucket of the
        valid kv at the window's start (the true length, not the
        allocation), at most the plan's table width."""
        base_lens = np.clip(plan.positions[:, 0], 0, plan.max_pos + 1)
        pages = max(1, -(-int(base_lens.max()) // self.cfg.page_size))
        return min(next_bucket(pages, self.scheduler.page_buckets),
                   plan.page_table.shape[1])

    def _stage_window(self, plan: DecodePlan, samp, rp, with_lp: bool,
                      greedy: bool, fused: bool = False) -> dict:
        """Stage a decode window's inputs in the static buffers of its
        shapes (window_graph.WindowGraphs.inputs).

        Device-resident decode state: if the slot set and page allocation
        are unchanged since the last window (and no penalty history needs
        refreshing), the buffers still hold this plan's arrays and the last
        window's final (token, position, counter) carry, so steady-state
        windows upload NOTHING.

        The gather window's base width (`_base_pb`) is part of its key, as
        in the JAX engine: a follow-up window off this staging gathers the
        same pages, and `_followup_fits` refuses one whose valid kv would
        outgrow them. Its base and window buffers are views of two static
        buffers every window graph shares (`_window_bufs`)."""
        temp, top_k, top_p, seeds, counters, min_toks = samp
        s, pb = plan.page_table.shape
        k_stops = plan.stop_ids.shape[1]
        hb = 0 if rp is None else rp[0].shape[1]
        base_pb = self._base_pb(plan) if self.pregather else 0
        sig = (tuple((q.request_id, q.epoch) if q else None
                     for q in plan.seqs),
               tuple(len(q.pages) if q else 0 for q in plan.seqs),
               pb, base_pb, k_stops, rp is None, with_lp, greedy, fused)
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
        # the JAX engine's window key: its variant, every bucketed dim and
        # the base bucket, which JAX computes on every path
        self._note_program(("window", rp is not None, with_lp, greedy,
                            fused, nw, s, pb,
                            base_pb if self.pregather else self._base_pb(plan),
                            k_stops))
        staged = {"sig": sig, "bufs": bufs, "nw": nw,
                  "key": (rp is not None, with_lp, greedy, fused, nw)
                  + shapes + (base_pb,),
                  # which attention path + sampling tail the window runs
                  "tag": self.decode_path + ("+fused" if fused else "")}
        if self.pregather:
            staged["window_bufs"] = self._window_bufs(s, base_pb, nw)
        return staged

    def _window_bufs(self, s: int, base_pb: int, nw: int) -> tuple:
        """The gather window's (k_base, v_base, k_win, v_win): contiguous
        views of static buffers sized once for the largest base the engine
        can gather (max_slots rows of its largest page bucket) and its
        longest window, shared by every window graph (they replay one
        after another on one stream, and each gathers its base anew)."""
        mc, ps = self.model_cfg, self.cfg.page_size
        dt = llama.torch_dtype(mc)
        lead = (mc.num_layers, mc.num_kv_heads, self.cfg.max_slots)
        most = (self.scheduler.page_buckets[-1] * ps, max(self._window_sizes))
        views = []
        for name, width, n in (("base", base_pb * ps, most[0]),
                               ("window", nw, most[1])):
            shape = lead[:2] + (s, width, mc.head_dim)
            size = math.prod(lead + (n, mc.head_dim))
            for half in ("k", "v"):
                flat = self.graphs.static(f"{half}_{name}", size, dt)
                views.append(flat[:math.prod(shape)].view(shape))
        return views[0], views[1], views[2], views[3]

    def _window_program(self, staged: dict):
        """The window as a function of its input buffers, for
        WindowGraphs.run: writes the final carry back into them."""
        rp, with_lp, greedy, fused, nw = staged["key"][:5]
        window_bufs = staged.get("window_bufs")

        def program(b):
            *outs, carry = _engine_decode_window(
                self.model_cfg, self._eos_vec, self.params, self.cache,
                b["tokens"], b["positions"], b["counters"], b["page_table"],
                b["max_pos"], b["temperature"], b["top_k"], b["top_p"],
                b["seeds"], b["min_tokens"], b["ignore_eos"], b["stop_ids"],
                n_steps=nw, page_size=self.cfg.page_size,
                hist=b.get("hist"), rep_penalty=b.get("rep_penalty"),
                with_lp=with_lp, greedy=greedy, fused=fused,
                nonfinite=b["nonfinite"], path=self.decode_path,
                window_bufs=window_bufs)
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
                                   staged["bufs"], self.decode_path)
        self.decode_windows += 1
        self.decode_window_steps += staged["nw"]
        self.decode_kernel_tag = staged["tag"]
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
            toks, lps, top_ids, top_lps, moe = HostCopies.wait(handle)
        self.decode_host_syncs += 1
        if moe is not None:
            self._account_moe(moe)
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
        if self._spec:
            return False   # the verify handoff stays synchronous
        if sch.stream_active:
            return False   # streamed steps interleave; don't lock them out
        if self._wants_logprobs(plan.seqs) \
                or self._rep_penalty_arrays(plan.seqs) is not None:
            return False
        return self._followup_fits(plan, next_index=1)

    def _followup_fits(self, plan: DecodePlan, next_index: int) -> bool:
        """Can window `next_index` (0 = the plan's own window) run entirely
        against the plan's staged page tables: its writes land in pages
        listed at staging time, some slot is still within budget, and (the
        gather window) the staged base width covers its valid kv?"""
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
        if np.any(need[live] > covered[live]):
            return False
        if self.pregather:
            # the gather window's base: the staged base width must hold
            # every slot's valid kv at the window's start
            base_need = np.clip(start, 0, plan.max_pos + 1)
            if int(base_need[live].max()) > \
                    self._base_pb(plan) * self.cfg.page_size:
                return False
        return True

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

    # -- speculative decoding (engine/spec.py) -------------------------------

    def _try_spec(self, plan: DecodePlan, counters, min_toks):
        """The JAX dispatch ahead of the window (dynamo_tpu/engine/
        engine.py:923-945): verify drafts when the cost gate passes them;
        None sends the plan to the window."""
        if self._draft is not None:
            # the draft model's budget is known up front: the gate runs
            # before any draft compute
            caps = self._draft.caps(plan)
            if sum(caps) and self._spec_worthwhile(plan, sum(caps)):
                with self.phases.phase("propose"):
                    drafts = self._draft.propose(plan, caps)
                return self._run_spec_decode(plan, drafts, counters,
                                             min_toks)
        elif self._spec_bound_ok(plan):
            drafts = self._gather_drafts(plan)
            if any(drafts):
                if self._spec_worthwhile(plan, sum(len(d) for d in drafts)):
                    return self._run_spec_decode(plan, drafts, counters,
                                                 min_toks)
            elif self._spec_gate_skips >= self.cfg.spec_probe_every:
                # a probe-granted scan that found no drafts spends the
                # probe, or the precheck would admit the scan every step
                self._spec_gate_skips = 0
        return None

    def _gather_drafts(self, plan: DecodePlan) -> list:
        """Per-slot prompt-lookup proposals, clamped to the shared
        draft_cap budget (page allocation and max_tokens) and truncated to
        in-vocab ids."""
        ps = self.cfg.page_size
        drafts: list = []
        for i, seq in enumerate(plan.seqs):
            d_max = (spec.draft_cap(seq, plan.max_pos[i], ps,
                                    self.cfg.spec_k)
                     if seq is not None else 0)
            if d_max <= 0:
                drafts.append([])
                continue
            drafts.append(spec.ngram_propose(
                seq.all_tokens, d_max,
                vocab_size=self.model_cfg.vocab_size))
        return drafts

    def _spec_gate_terms(self, plan: DecodePlan):
        """(n_live, nw, window, verify) for the speculation cost gate: the
        window's rung and the two programs' prices (spec.gate_costs)."""
        n_live = sum(1 for s in plan.seqs if s is not None)
        nw = self._window_rung(plan)
        return (n_live, nw) + spec.gate_costs(nw, self.device.type)

    def _spec_bound_ok(self, plan: DecodePlan) -> bool:
        """Cheap precheck before the per-slot n-gram scans: with spec_k
        drafts a live slot the gate reads (1 + ema * spec_k) * window >
        nw * verify; when even that fails no draft set can pass
        `_spec_worthwhile`, so the scan is skipped, unless a probe is due
        (the skip counts toward the probe cadence)."""
        n_live, nw, window, verify = self._spec_gate_terms(plan)
        if n_live == 0:
            return False
        if (1 + self._spec_acc_ema * self.cfg.spec_k) * window \
                > nw * verify:
            return True
        self._spec_gate_skips += 1
        # left at the threshold: _spec_worthwhile's probe branch resets it
        # when the probe dispatches
        return self._spec_gate_skips >= self.cfg.spec_probe_every

    def _spec_worthwhile(self, plan: DecodePlan, d_total: int) -> bool:
        """The cost gate: with `window` and `verify` the two programs'
        times (spec.gate_costs: JAX's dispatch-based prices off the card,
        the measured verify / window-step ratio on it) and ema the recent
        acceptance rate, speculation wins iff

            (n_live + ema * d_total) * window > n_live * nw * verify

        (at nw == 1 it always does off the card). The ema moves only when a
        verify runs, so every spec_probe_every-th rejection forces a
        probe."""
        n_live, nw, window, verify = self._spec_gate_terms(plan)
        if ((n_live + self._spec_acc_ema * d_total) * window
                > n_live * nw * verify):
            self._spec_gate_skips = 0
            return True
        self._spec_gate_skips += 1
        if self._spec_gate_skips >= self.cfg.spec_probe_every:
            self._spec_gate_skips = 0
            return True
        return False

    def _verify_program(self):
        """The verify as a function of its input buffers, for
        WindowGraphs.run."""
        def program(b):
            return _engine_verify_step(
                self.model_cfg, self._eos_vec, self.params, self.cache,
                b["tokens"], b["positions"], b["page_table"], b["kv_lens"],
                b["write_idx"], b["counters"], b["min_tokens"],
                nonfinite=b["nonfinite"], path=self.decode_path)
        return program

    def _run_spec_decode(self, plan: DecodePlan, drafts: list, counters,
                         min_toks) -> List[StepOutput]:
        """Verify the drafts in one target forward (JAX `_run_spec_decode`,
        dynamo_tpu/engine/engine.py:1405-1490).

        Each slot's block row is [last token, drafts...] laid out like a
        prefill chunk; the verify's per-position argmax replays the greedy
        choice at every draft position. The longest matching prefix plus
        the model's own token at the first mismatch commit through
        commit_decode_token + _postprocess (stop, eos and max_tokens there),
        a slot stopping at its first finished event. On the card the verify
        is one replay of the graph of its block shape, from static input
        buffers, its predictions copied out after it."""
        ps = self.cfg.page_size
        s_count, pb = plan.page_table.shape
        kp1 = self.cfg.spec_k + 1
        tokens = np.zeros((s_count, kp1), np.int32)
        positions = np.zeros((s_count, kp1), np.int32)
        write_idx = np.full((s_count, kp1), -1, np.int32)
        kv_lens = np.zeros((s_count,), np.int32)
        for i, seq in enumerate(plan.seqs):
            if seq is None:
                continue
            d = drafts[i]
            n = 1 + len(d)
            pos0 = seq.total_len - 1
            tokens[i, 0] = plan.tokens[i, 0]
            if d:
                tokens[i, 1:n] = d
            positions[i, :] = pos0 + n - 1
            positions[i, :n] = np.arange(pos0, pos0 + n)
            for j in range(n):
                write_idx[i, j] = seq.flat_index(pos0 + j, ps)
            kv_lens[i] = pos0 + n
        i32 = torch.int32
        self._note_program(("verify", tokens.shape, pb))
        key = ("verify", s_count, kp1, pb)
        bufs = self.graphs.inputs(key, {
            "tokens": ((s_count, kp1), i32),
            "positions": ((s_count, kp1), i32),
            "page_table": ((s_count, pb), i32), "kv_lens": ((s_count,), i32),
            "write_idx": ((s_count, kp1), i32),
            "counters": ((s_count,), i32), "min_tokens": ((s_count,), i32)})
        bufs["nonfinite"] = self._nonfinite
        for name, arr in (("tokens", tokens), ("positions", positions),
                          ("page_table", plan.page_table),
                          ("kv_lens", kv_lens), ("write_idx", write_idx),
                          ("counters", counters), ("min_tokens", min_toks)):
            bufs[name].copy_(torch.from_numpy(np.ascontiguousarray(arr)))
        with self.phases.phase("verify"):
            outs = self.graphs.run(key, self._verify_program(), bufs,
                                   "verify", dead="write_idx")
            pred, moe = HostCopies.wait(
                self._host_copies.copy_async(outs, self._stream))
        if moe is not None:
            self._account_moe(moe)
        # the verify advanced positions and KV outside the window: the
        # window's staged buffers and carry are stale
        self._dec_state = None
        events: List[StepOutput] = []
        for i, seq in enumerate(plan.seqs):
            if seq is None:
                continue
            d = drafts[i]
            m = 0
            while m < len(d) and int(pred[i, m]) == d[m]:
                m += 1
            self.spec_proposed_tokens += len(d)
            self.spec_accepted_tokens += m
            if d:
                self._spec_acc_ema = (0.8 * self._spec_acc_ema
                                      + 0.2 * (m / len(d)))
            emitted, finished = 0, False
            for tok in list(d[:m]) + [int(pred[i, m])]:
                self.scheduler.commit_decode_token(seq, tok)
                emitted += 1
                ev = self._postprocess(seq, seq.output[-1])
                events.append(ev)
                if ev.finished:
                    finished = True
                    break
            if self._draft is not None and not finished:
                # a FINISHED request was forgotten by _postprocess:
                # recording it again would leak its entry
                self._draft.committed(seq, m, emitted)
        self.spec_steps += 1
        # the verify block charges [S, k + 1] bucket tokens; the accepted
        # drafts and the model's own tokens are the useful part
        self._ledger_record(
            "spec", s_count, sum(1 for q in plan.seqs if q is not None),
            len(events), s_count * kp1)
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
        # the bucket charge is every (step, slot) pair of the window; the
        # useful part is the tokens that committed
        self._ledger_record("decode", len(plan.seqs), n_live,
                            len(events), n_steps * len(plan.seqs))
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
            if self._draft is not None:
                self._draft.forget(seq.request_id)
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


def _engine_step(cfg: ModelConfig, eos, params, cache, tokens,
                 positions, page_table, kv_lens, write_idx, last_idx,
                 temperature, top_k, top_p, seeds, counters, min_tokens,
                 hist=None, rep_penalty=None, with_lp=False, greedy=False,
                 nonfinite=None, path=None, mm_embeds=None, mm_mask=None):
    """forward + last-position logits + sample for one prefill or mixed
    step (eos: the engine's [V] eos mask or None). Returns (tokens [B]
    int32, sampled_lp, top_ids, top_lps, moe), the lp outputs None unless
    with_lp, moe the MoE dispatch's [dropped, routed] f32 counts or None.
    A multimodal plan's mm_embeds [B, Tq, D] / mm_mask [B, Tq] mix into
    the token embeds. The cache is updated in place."""
    meta = AttnMetadata(positions=positions, page_table=page_table,
                        kv_lens=kv_lens, write_idx=write_idx)
    last, _, aux = llama.forward(params, cfg, tokens, cache, meta,
                                 last_idx=last_idx, with_aux=True, path=path,
                                 input_embeds=mm_embeds,
                                 embeds_mask=mm_mask)
    if nonfinite is not None:
        nonfinite += (~torch.isfinite(last)).any()
    seen = (seen_token_mask(hist, cfg.vocab_size)
            if rep_penalty is not None else None)
    return sample_logits(last, eos, temperature, top_k, top_p, seeds,
                         counters, min_tokens, seen=seen,
                         rep_penalty=rep_penalty, with_lp=with_lp,
                         greedy=greedy) + (_moe_counts(aux),)


def _engine_verify_step(cfg: ModelConfig, eos, params, cache, tokens,
                        positions, page_table, kv_lens, write_idx, counters,
                        min_tokens, nonfinite=None, path=None):
    """Speculative-decoding verify (JAX `_engine_verify_step`,
    dynamo_tpu/engine/engine.py:2379-2420): one forward over each slot's
    [last token, drafts...] block, returning the greedy token at EVERY
    position ([S, K+1] int32) and the MoE counts (or None). Position j's
    argmax is what sample_logits(greedy) gives for generated token
    counters + j, the min-tokens eos ban included, so the host's
    acceptance is exact. The block's KV rows are written during the
    forward; rejected rows lie past the committed length, where nothing
    reads them and the next write overwrites them. Block token j sits at
    position positions[:, 0] + j: on the ragged path the block attends that
    prefix through the ragged kernel, one kernel row a block token
    (ops/paged_attention.block_attention), where the JAX verify gathers
    the pages into a prefill-shaped attention (the same function in
    another summation order). No host copy and no data-dependent shape:
    the verify is captured whole in one graph."""
    meta = AttnMetadata(positions=positions, page_table=page_table,
                        kv_lens=kv_lens, write_idx=write_idx,
                        prefix_lens=positions[:, 0])
    logits, _, aux = llama.forward(params, cfg, tokens, cache, meta,
                                   with_aux=True, path=path)
    if nonfinite is not None:
        nonfinite += (~torch.isfinite(logits)).any()
    if eos is not None:
        # position j emits generated token counters + j
        j = torch.arange(tokens.shape[1], dtype=counters.dtype,
                         device=counters.device)[None, :]
        ban = (counters[:, None] + j) < min_tokens[:, None]   # [S, K+1]
        logits = logits.masked_fill(ban[:, :, None] & eos[None, None, :],
                                    -1e30)
    pred = logits.argmax(dim=-1).to(torch.int32)
    return pred, _moe_counts(aux)


def _moe_counts(aux: dict):
    """A program's MoE aux as one [dropped, routed] f32 tensor (None
    without an MoE dispatch), so it crosses to the host in one copy."""
    if not aux:
        return None
    return torch.stack([aux["moe_dropped"], aux["moe_routed"]])


def _gather_base(cache, base_table, k_base, v_base, base_len) -> None:
    """The gather window's base: each slot's first Pb_base pages, layer by
    layer, into the static buffers k_base / v_base [L, Hkv, S, Pb_base *
    ps, hd] in the model dtype, V's rows at or past base_len [S] zeroed (a
    recycled page's stale tail may hold NaN, which 0 * NaN would carry
    through the masked probabilities; K's are masked by the scores). An
    int8 cache is dequantized here, once a window, one layer's pages at a
    time (an f32 copy of the whole base would be tens of GB at Gemma-2-9B's
    widths)."""
    l, hkv, s, lb, hd = k_base.shape
    ids = base_table.reshape(-1).long()
    stale = (torch.arange(lb, device=ids.device)[None, :]
             >= base_len.long()[:, None])[None, :, :, None]
    for key, out in (("k", k_base), ("v", v_base)):
        for layer in range(l):
            # dynalint: kv-codec — the base gather reads one layer's pages
            # and, for an int8 cache, dequantizes them with their scales
            pages = cache[key][layer]
            p, ps = pages.shape[1], pages.shape[2]
            if is_quantized_cache(cache):
                out[layer].view(hkv, -1, ps, hd).copy_(dequantize_rows(
                    pages.index_select(1, ids),
                    cache[f"{key}_scale"][layer].index_select(1, ids),
                    out.dtype))
            else:
                # one row of ps * hd values a page
                torch.index_select(pages.view(hkv, p, ps * hd), 1, ids,
                                   out=out[layer].view(hkv, -1, ps * hd))
            if key == "v":
                out[layer].masked_fill_(stale, 0)


def _engine_decode_window(cfg: ModelConfig, eos, params, cache, tokens,
                          positions, counters, page_table, max_pos,
                          temperature, top_k, top_p, seeds, min_tokens,
                          ignore_eos, stop_ids, *, n_steps: int,
                          page_size: int, hist=None, rep_penalty=None,
                          with_lp=False, greedy=False, fused=False,
                          nonfinite=None, path: str = "ragged",
                          window_bufs: Optional[tuple] = None):
    """N decode iterations, the sampled token feeding the next on the
    device: the JAX package's window bodies
    (dynamo_tpu/engine/engine.py:2236-2371).

    tokens / positions / counters [S] are the fed token, its position and
    the sampling counter of step 0; max_pos [S] is the highest position a
    slot may write (-1 for padding); eos is the engine's [V] eos mask or
    None; ignore_eos [S] bool; stop_ids [S, K] hidden stop ids (-1
    padded). The carry (token, position, counter, seen, alive) stays on the
    device: each step attends the prefix clip(pos, 0, max_pos + 1) and runs
    decode_forward with the cache read-only. A slot dies when it samples an
    eos id (unless ignore_eos) or a stop id; a dead slot, or one past
    max_pos, writes its rows into the scratch page.

    The decode path (`path`, models/llama.decode_path) picks the body:

    - "ragged", or "gather" without `window_bufs` (the per-token deferred
      gather): the JAX kernel-mode body. Each step's kv rows are scattered
      into the cache in place at its write slot (`scatter_new_kv`; an int8
      cache quantizes them there).
    - "gather" with `window_bufs` = (k_base, v_base [L, Hkv, S, Pb_base *
      ps, hd], k_win, v_win [L, Hkv, S, n_steps, hd]), static buffers of
      the model dtype: the JAX pregather body. The window gathers each
      slot's first Pb_base pages once into the base (`_gather_base`; an
      int8 cache dequantized there), valid up to base_len, the position at
      the window's start (V's rows past it zeroed there, so the steps read
      the base as it is); step t writes its full-precision rows at index t
      of the window buffer; attention merges base, window and the current
      token (decode_attention_split); the window's rows reach the cache in
      one scatter at its end (int8 caches quantize them there). The caller
      sizes Pb_base to cover every position the window attends.

    Returns (tokens [N, S] int32, lps, top_ids, top_lps, moe, (tok_f,
    pos_f, ctr_f)), still on the device; the lp outputs are None unless
    with_lp; moe is the MoE dispatch's [dropped, routed] f32 counts summed
    over the window's steps (each step routes its writable rows), or None.
    Nothing here copies between host and device or waits on the device, so
    the window can be captured in a CUDA graph."""
    s = tokens.shape[0]
    rows = torch.arange(s, device=tokens.device)
    seen = (seen_token_mask(hist, cfg.vocab_size)
            if rep_penalty is not None else None)
    tok, pos, ctr = tokens, positions, counters
    alive = max_pos >= 0
    pregather = path == "gather" and window_bufs is not None
    if pregather:
        k_base, v_base, k_win, v_win = window_bufs
        base_pb = k_base.shape[3] // page_size
        # valid kv at the window's start, fixed across it: the window
        # buffer holds everything generated after it
        base_len = torch.minimum(torch.clamp(pos, min=0), max_pos + 1)
        _gather_base(cache, page_table[:, :base_pb], k_base, v_base,
                     base_len)
        write_idxs = []
    outs = []
    moe = None
    for t in range(n_steps):
        writable = (pos <= max_pos) & alive
        prefix = torch.minimum(torch.clamp(pos, min=0), max_pos + 1)
        # flat global-cache slot of this step's row (-1 = dropped)
        page = page_table[rows, torch.clamp(torch.minimum(pos, max_pos),
                                            min=0).long() // page_size]
        write_idx = torch.where(writable,
                                page * page_size + pos % page_size, -1)
        if pregather:
            # in-window tokens so far: window index j is step j for every
            # slot; entries j < win_len are valid
            window = (k_base, v_base, k_win, v_win, base_len,
                      prefix - base_len)
            logits, k_news, v_news, aux = llama.decode_forward(
                params, cfg, tok, cache, page_table, prefix, pos,
                valid=writable, with_aux=True, window=window, path=path)
            # this step's rows land at index t for every slot; a slot that
            # may not write stores garbage there, but its win_len stops
            # growing (or it is dead) and its writeback is dropped
            k_win[:, :, :, t].copy_(k_news.transpose(1, 2))
            v_win[:, :, :, t].copy_(v_news.transpose(1, 2))
            write_idxs.append(write_idx)
        else:
            logits, k_news, v_news, aux = llama.decode_forward(
                params, cfg, tok, cache, page_table, prefix, pos,
                valid=writable, with_aux=True, path=path)
            scatter_new_kv(cache, k_news, v_news, write_idx)
        if aux:
            counts = _moe_counts(aux)
            moe = counts if moe is None else moe + counts
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
    if pregather:
        # end-of-window writeback: every step's rows into the paged cache
        # in one scatter, slot-major ([L, Hkv, S, N, hd] -> [L, S * N, Hkv,
        # hd] beside the write slots [S, N])
        l, hkv, _, nw, hd = k_win.shape
        def rows_of(w):
            return w.permute(0, 2, 3, 1, 4).reshape(l, s * nw, hkv, hd)
        scatter_new_kv(cache, rows_of(k_win), rows_of(v_win),
                       torch.stack(write_idxs, 1).reshape(-1))
    toks = torch.stack([o[0] for o in outs])
    if not with_lp:
        return toks, None, None, None, moe, (tok, pos, ctr)
    return (toks, torch.stack([o[1] for o in outs]),
            torch.stack([o[2] for o in outs]),
            torch.stack([o[3] for o in outs]), moe, (tok, pos, ctr))
