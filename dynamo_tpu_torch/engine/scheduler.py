"""Continuous-batching scheduler for the port's engine.

Copied from dynamo_tpu/engine/scheduler.py, trimmed to the slice: one
engine on one device, aggregated or one side of a disaggregated pair. The
disaggregation hooks are the JAX package's (:72 `prefill_only`, :94
`RemoteAllocation`, :373-376 `remote` / `parked`, :534-683 the decode and
prefill sides, :844-845 abort, :987 the slot a prefill-only row does not
take, :1065-1069 the memory dead end, :1220-1222 parking), and so are the KV
tier hooks (:335-350 `host_pool` / `settle_hashes`, :690-805 the tiered
prefix walk, `_pool_claim`, the host and pool branches of `_match_prefix`,
the onboard and pool-inject queues), and so are the multimodal spans (:74-85
`mm_spans` / `mm_pixels`, :131-132 the plan's `mm_embeds` / `mm_mask`,
:438-463 the content salts at admission, :1190-1198 each chunk's slice of
a span), and so are the tiered-KV streaming hooks (:187-193 `StreamPlan`,
:365-370 `stream_active`, :467-502 `_stream_admissible`, :808-812 and
:837 finish and abort, :915 and :954-970 `_maybe_stream_plan`). Sequence
parallelism is left out. Planning is otherwise the JAX package's, decision
for decision, so both engines plan the same steps for the same requests:

- every device step has a bucketed shape: prefill chunk lengths from
  `prefill_buckets`, page-table widths from `page_bucket_ladder`, decode
  padded to `max_slots` rows;
- mixed steps (mixed_token_budget > 0): whenever requests wait while
  decodes run, one [Bb, Tb] MixedPlan carries every running slot as a
  single-token decode row plus a token-budgeted prefill chunk; pure prefill
  runs only with no active decode, pure decode whenever nothing waits;
- alternating policy (mixed_token_budget = 0): prefill-priority with a
  bounded streak;
- pipelined decode (pipeline_depth > 1): a decode plan pre-allocates, best
  effort and never preempting, the pages of the windows the engine may run
  off it before the first commits.
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np

from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.kv_cache import (
    PageAllocator, SequenceState, content_salt, page_hash,
)
from dynamo_tpu_torch.runtime.qos import (
    DEFAULT_POLICY, QOS_STATS, QosPolicy, select_victim,
)


@dataclasses.dataclass
class SamplingParams:
    """Engine-level sampling options (the JAX package's SamplingParams)."""

    max_tokens: int = 16
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    ignore_eos: bool = False
    stop_token_ids: tuple = ()   # hidden stop ids (not emitted)
    min_tokens: int = 0
    # HF-semantics repetition penalty over prompt+generated (1.0 = off)
    repetition_penalty: float = 1.0
    # logprobs request: None = off; 0 = sampled-token logprob only;
    # k>0 = also the top-k alternatives (capped at sampler.TOP_LOGPROBS)
    logprobs: Optional[int] = None


@dataclasses.dataclass
class EngineRequest:
    request_id: str
    prompt: List[int]
    params: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    # prefill-only: run chunked prefill, sample the first token, then park
    # the sequence (pages held) instead of taking a decode slot: the
    # prefill half of disaggregated serving
    prefill_only: bool = False
    # multimodal: [(prompt_offset, embeds [n, D_text])] spans whose
    # positions take vision-tower output instead of token embeds; the
    # prompt carries placeholder ids there, rewritten to content salts at
    # admission so the prefix cache tells images apart. An item may be
    # (offset, embeds, salt_base): a salt hashed from the pixels, the same
    # on both sides of a disaggregated pair
    mm_spans: Optional[list] = None
    # raw pixels [(prompt_offset, [H, W, 3] float array)], encoded into
    # mm_spans by the engine's vision tower at admission
    # (NativeEngine._resolve_mm)
    mm_pixels: Optional[list] = None
    # multi-tenant QoS class name (runtime/qos.py); "" = the policy default
    qos: str = ""


@dataclasses.dataclass
class RemoteAllocation:
    """Decode-side up-front allocation for a remotely prefilled request."""

    request_id: str
    page_ids: List[int]
    num_cached_tokens: int   # prefix-hit tokens already valid decode-side
    # admission epoch of the allocated sequence: every transfer chunk
    # carries it, and the decode side fences out a stale sender whose
    # chunks would land in pages released and reallocated since
    alloc_epoch: int = 0


@dataclasses.dataclass
class PrefillPlan:
    """One batched prefill step: up to Bb sequences' chunks side by side.
    Padding rows carry kv_lens 0 / write_idx -1 and are ignored on commit."""

    seqs: List[Optional[SequenceState]]  # per row; None = padding
    tokens: np.ndarray      # [Bb, Tb] int32
    positions: np.ndarray   # [Bb, Tb]
    page_table: np.ndarray  # [Bb, Pb]
    kv_lens: np.ndarray     # [Bb]
    write_idx: np.ndarray   # [Bb, Tb]
    last_idx: np.ndarray    # [Bb] index of last valid token in the chunk
    n_valid: List[int] = dataclasses.field(default_factory=list)   # per row
    is_last_chunk: List[bool] = dataclasses.field(default_factory=list)
    # multimodal rows: embeds to mix in at masked positions (None = all
    # text)
    mm_embeds: Optional[np.ndarray] = None  # [Bb, Tb, D] f32
    mm_mask: Optional[np.ndarray] = None    # [Bb, Tb] bool


@dataclasses.dataclass
class MixedPlan(PrefillPlan):
    """One fused prefill+decode step: a PrefillPlan [Bb, Tb] whose leading
    rows are the running decode slots, each a single-token causal row
    (token at column 0, kv_lens = position + 1), followed by the prefill
    chunk rows. One paged forward runs both row kinds."""

    is_decode: List[bool] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class DecodePlan:
    seqs: List[Optional[SequenceState]]  # per slot
    tokens: np.ndarray      # [S, 1]
    positions: np.ndarray   # [S, 1]
    page_table: np.ndarray  # [S, Pb]
    kv_lens: np.ndarray     # [S]
    write_idx: np.ndarray   # [S, 1]
    last_idx: np.ndarray    # [S]
    # highest position whose KV may be written during the decode window
    # (= prompt_len + max_tokens - 1, within this plan's page allocation);
    # -1 for padding slots. Writes past it are dropped and attention is
    # clamped to it, so a sequence that exhausts max_tokens mid-window
    # neither clobbers other pages nor reads past its page table.
    max_pos: np.ndarray = None  # [S]
    # window length chosen by the scheduler (a window_ladder rung)
    n_window: int = 1
    # hidden stop ids per slot, -1 padded; K is a pow2 bucket of the longest
    # list (>= 8 once any slot has one), 0 when no slot has any
    stop_ids: np.ndarray = None  # [S, K]


@dataclasses.dataclass
class StreamPlan:
    """One streamed step (engine/streaming.py) of a single sequence whose
    context exceeds the resident page budget. Streamed sequences hold no
    decode slot and ride no AttnMetadata (the StreamingDecoder owns their
    residency), so the plan is the dispatch token the engine routes to
    `_run_stream`."""

    seq: SequenceState


@dataclasses.dataclass
class EngineMetrics:
    """Snapshot published to the router (the reference's
    ForwardPassMetrics fields) plus the engine's window and mixed-step
    counters."""

    request_active_slots: int = 0
    request_total_slots: int = 0
    kv_active_blocks: int = 0
    kv_total_blocks: int = 0
    num_requests_waiting: int = 0
    gpu_cache_usage_perc: float = 0.0
    gpu_prefix_cache_hit_rate: float = 0.0
    # the counts behind the hit rate (full pages matched / looked up at
    # admission) and the requests admitted, so that per-worker figures add
    # up across workers
    gpu_prefix_cache_hits: int = 0
    gpu_prefix_cache_lookups: int = 0
    requests_admitted: int = 0
    window_slot_steps: int = 0
    window_wasted_steps: int = 0
    decode_windows: int = 0
    decode_host_syncs: int = 0
    # device programs launched for decode windows (one CUDA-graph replay
    # each on the card; must equal decode_windows), and windows that staged
    # fresh plan arrays (flat while windows climb = zero steady-state uploads)
    decode_dispatches: int = 0
    decode_plan_uploads: int = 0
    # the two-deep pipeline: windows committed through it, of those the
    # commits that ran while a follow-up executed, and follow-ups discarded
    # because a commit changed slot membership
    pipeline_windows: int = 0
    pipeline_overlapped: int = 0
    pipeline_fallbacks: int = 0
    mixed_steps: int = 0
    decode_stall_steps: int = 0
    # speculative decoding (engine/spec.py): verify forwards run, and the
    # drafts proposed and accepted (accepted / proposed is the acceptance
    # rate; all 0 when spec_decode is off)
    spec_steps: int = 0
    spec_proposed_tokens: int = 0
    spec_accepted_tokens: int = 0
    # the decode attention path resolved at engine build ("ragged" |
    # "gather") and why, and the last window's path + sampling tail
    decode_path: str = ""
    decode_path_reason: str = ""
    decode_kernel_tag: str = ""
    # how decode windows run ("on": one CUDA-graph replay a window; "off
    # (gloo)", "off (cpu)", "off (eager)": the program run directly) and
    # the windows so run
    window_graphs: str = ""
    eager_windows: int = 0
    # tensor parallelism (parallel/): tp, this rank, the group's backend
    # ("" without a group) and every rank's figures (engine.tp_stats:
    # launches by kernel, collectives, windows, weight bytes)
    tp: int = 1
    tp_rank: int = 0
    tp_backend: str = ""
    tp_ranks: list = dataclasses.field(default_factory=list)
    # KV representation (ops/kv_quant.py): bytes one page occupies on the
    # device (k + v + scales) and the quantized bit width (0 = unquantized)
    kv_page_bytes: int = 0
    kv_quant_bits: int = 0
    # weight representation (ops/quant.py): device bytes of the parameter
    # tree (int8 values + f32 scales where quantized) and the bit width
    weight_bytes: int = 0
    weight_quant_bits: int = 0
    # KV transfer volume and the chunk-committed stream's counters of the
    # engine's process (runtime/integrity.XFER_STATS)
    kv_transfer_bytes: int = 0
    kv_transfer_fetches: int = 0
    kv_transfer_resumes: int = 0
    kv_transfer_salvaged_pages: int = 0
    kv_transfer_stale_chunks: int = 0
    kv_transfer_link_timeouts: int = 0
    # the per-step ledger (observability/ledger.py): committed device
    # steps, recompile events (first dispatch of a new (program, bucket)
    # key), EWMA useful tok/s, MFU estimate (0 without a configured peak)
    # and the cumulative padding-waste fraction
    engine_steps: int = 0
    engine_recompiles: int = 0
    engine_tok_s: float = 0.0
    engine_mfu: float = 0.0
    engine_pad_frac: float = 0.0
    # KV tier occupancy (engine/offload.py): host-DRAM and disk pages held
    # and their capacities (0 with the tier off)
    kv_host_pages_used: int = 0
    kv_host_pages_total: int = 0
    kv_disk_pages_used: int = 0
    kv_disk_pages_total: int = 0
    # streaming past the page budget (engine/streaming.py): streamed steps,
    # prefetch outcomes, spilled / quarantined pages and stalled steps (0
    # with stream_pages 0)
    kv_stream_steps: int = 0
    kv_stream_prefetch_hit: int = 0
    kv_stream_prefetch_late: int = 0
    kv_stream_pages_spilled: int = 0
    kv_stream_pages_quarantined: int = 0
    kv_stream_stall_steps: int = 0


def window_ladder(decode_steps: int) -> List[int]:
    """Decode-window sizes, descending: full window, a quarter window for
    request tails, and 1. The scheduler rounds UP into the ladder; writes
    past a request's admission limit are dropped, so an oversized rung only
    wastes bounded tail compute."""
    n = max(1, decode_steps)
    return sorted({n, max(1, n // 4), 1}, reverse=True)


def pow2_buckets(max_value: int, start: int = 1) -> List[int]:
    out, b = [], start
    while b < max_value:
        out.append(b)
        b *= 2
    out.append(max_value)
    return out


def page_bucket_ladder(max_value: int) -> List[int]:
    """Page-table width buckets with 1.5x intermediate rungs
    (1,2,3,4,6,8,12,16,24,32,...)."""
    out, b = [], 1
    while b < max_value:
        out.append(b)
        mid = b + b // 2
        if b >= 2 and mid < max_value:
            out.append(mid)
        b *= 2
    out.append(max_value)
    return sorted(set(out))


def next_bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if b >= n:
            return b
    raise ValueError(f"{n} exceeds largest bucket {buckets[-1]}")


class Scheduler:
    def __init__(self, cfg: EngineConfig, host_pool=None):
        self.cfg = cfg
        self.allocator = PageAllocator(cfg.num_pages, cfg.page_size)
        # host KV tier (engine/offload.py HostKvPool); None = tier off
        self.host_pool = host_pool
        # set by the engine to CopyStream.settle: a prefix walk waits only
        # for the in-flight offload copies of the hashes it looks up
        self.settle_hashes = None
        # (pid, seq_hash) pairs whose HBM page the engine fills from the
        # host tier before the next device step
        self.pending_onboards: list = []
        # the shared KV pool (engine/kv_pool.py SharedKvPool; wired by
        # engine.attach_kv_pool): the tier below host and disk in the walk
        self.kv_pool = None
        self.kv_pool_mode = ""   # this engine's kv_quant mode for fetches
        # (pid, seq_hash, verified host arrays) claimed from the shared pool
        # by _match_prefix; the engine injects them before the next step
        # and skips a page that no longer carries the claimed seal (its
        # sequence was released and the page recycled in between)
        self.pending_pool_injects: list = []
        self.pool_fetched_pages = 0
        self._pool_quant_logged = False
        self.waiting: deque[SequenceState] = deque()
        self.running: List[Optional[SequenceState]] = [None] * cfg.max_slots
        # streaming past the page budget: sequences too long for the
        # resident budget run one step at a time through the window pool
        # instead of decode slots; the engine turns it on and wires
        # on_stream_finish to StreamingDecoder.release
        self.stream_enabled = False
        self.stream_active: List[SequenceState] = []
        self.on_stream_finish = None
        self._stream_turn = 0
        self.params: Dict[str, SamplingParams] = {}
        # disaggregation state: decode-side sequences awaiting a remote
        # prefill, and prefill-side sequences parked (prefill done, pages
        # held) until the transfer reads their KV
        self.remote: Dict[str, SequenceState] = {}
        self.parked: Dict[str, SequenceState] = {}
        # early-decode gates: rid -> (first_token, needed_pages,
        # frontier_fn). The sequence stays in self.remote (chunk injects
        # and the epoch fence still see it) until poll_overlap_gates
        # finds every transferred page committed.
        self.overlap_gates: Dict[str, tuple] = {}
        self.overlap_activations = 0
        ps = cfg.page_size
        self.prefill_buckets = list(cfg.prefill_buckets)
        max_pages_per_seq = -(-cfg.max_model_len // ps)
        self.page_buckets = page_bucket_ladder(max_pages_per_seq)
        self._prefix_hits = 0
        self._prefix_lookups = 0
        self._admitted = 0
        self._prefill_streak = 0
        self.mixed_token_budget = cfg.mixed_token_budget
        # floor for runtime budget actuation (set_mixed_token_budget, JAX
        # :397): the smallest prefill bucket must still fit one chunk row
        # next to a decode row, or the budget silently starves prefill
        self._mixed_budget_floor = 2 * min(cfg.prefill_buckets)
        # QoS class table + per-class outstanding cross-class-preemption
        # debt (charged in _preempt_for, repaid when the victim decodes)
        self.qos_policy: QosPolicy = DEFAULT_POLICY
        self._qos_preempt_debt: Dict[str, int] = {}
        # monotonic epoch source for admissions AND preemptions: the
        # sampler's host caches key slots by (request_id, epoch)
        self._epoch_seq = itertools.count(1)

    # -- request lifecycle ---------------------------------------------------

    def _admit(self, req: EngineRequest) -> SequenceState:
        """Validate + create + register a sequence."""
        if req.request_id in self.params:
            raise ValueError(
                f"request {req.request_id}: id already active on this "
                "engine (duplicate dispatch?)")
        if len(req.prompt) + req.params.max_tokens > self.cfg.max_model_len:
            raise ValueError(
                f"request {req.request_id}: len {len(req.prompt)} + "
                f"max_tokens {req.params.max_tokens} exceeds max_model_len "
                f"{self.cfg.max_model_len}")
        prompt = list(req.prompt)
        spans = []
        for item in req.mm_spans or ():
            # placeholder ids become content salts: page hashes (the prefix
            # cache, the router's events) run over token ids, and one
            # placeholder id for different images would alias their pages.
            # The salts never reach the embedding table (llama.forward's
            # embeds_mask)
            off, emb = int(item[0]), np.asarray(item[1])
            if off < 0 or off + emb.shape[0] > len(prompt):
                # a ValueError: the worker's add path turns it into this
                # request's error frame
                raise ValueError(
                    f"request {req.request_id}: image span "
                    f"[{off}, {off + emb.shape[0]}) outside prompt of "
                    f"{len(prompt)} tokens")
            spans.append((off, emb))
            base = item[2] if len(item) > 2 else content_salt(emb.tobytes())
            for j in range(emb.shape[0]):
                prompt[off + j] = int((base + j) % 0x7FFFFFF0) + 1
        qos_cls = self.qos_policy.resolve(req.qos or None)
        seq = SequenceState(request_id=req.request_id,
                            prompt=prompt,
                            epoch=next(self._epoch_seq),
                            prefill_only=req.prefill_only, mm_spans=spans,
                            qos=req.qos or "", qos_prio=qos_cls.priority)
        self.params[req.request_id] = req.params
        self._admitted += 1
        if self._stream_admissible(seq, req):
            # streamed sequences never touch the prefix cache: their pages
            # live under the StreamingDecoder's residency plan, not
            # seq.pages, so a prefix share would dangle
            seq.streamed = True
            return seq
        self._match_prefix(seq)
        return seq

    def _stream_admissible(self, seq: SequenceState,
                           req: EngineRequest) -> bool:
        """Route to the streamed path when the request's whole page
        footprint exceeds the resident budget. Multimodal and prefill-only
        requests stay on the slot path; logprobs and repetition penalties
        are refused (the streamed sampler tail does not thread them)."""
        if not self.stream_enabled or seq.mm_spans or seq.prefill_only:
            return False
        pages = -(-(len(seq.prompt) + req.params.max_tokens)
                  // self.cfg.page_size)
        if pages <= self.cfg.stream_resident_pages:
            return False
        if req.params.logprobs is not None \
                or req.params.repetition_penalty != 1.0:
            raise ValueError(
                f"request {req.request_id}: logprobs/repetition_penalty "
                "are not supported on the streamed long-context path "
                f"({pages} pages > stream_resident_pages="
                f"{self.cfg.stream_resident_pages})")
        return True

    def add_request(self, req: EngineRequest) -> SequenceState:
        seq = self._admit(req)
        if seq.streamed:
            self.stream_active.append(seq)
        else:
            self._queue_insert(seq)
        return seq

    def _queue_insert(self, seq: SequenceState) -> None:
        """Class-aware waiting-queue insertion with bounded aging: a
        higher-priority arrival bypasses lower-priority waiting sequences
        (FIFO within a class), but never one already bypassed
        `aging_limit` times. With a single class this is append()."""
        limit = self.qos_policy.aging_limit
        idx = len(self.waiting)
        while idx > 0:
            prev = self.waiting[idx - 1]
            if prev.qos_prio >= seq.qos_prio \
                    or prev.qos_bypassed >= limit:
                if prev.qos_bypassed >= limit \
                        and prev.qos_prio < seq.qos_prio:
                    QOS_STATS.sched_aging_pins += 1
                break
            idx -= 1
        for j in range(idx, len(self.waiting)):
            self.waiting[j].qos_bypassed += 1
        if idx < len(self.waiting):
            QOS_STATS.sched_bypasses += 1
        self.waiting.insert(idx, seq)

    # -- disaggregation: decode side -----------------------------------------

    def peek_prefix(self, tokens: List[int]) -> int:
        """Longest locally cached prefix (tokens), without allocating: the
        prefix hit of the local-vs-remote prefill decision."""
        matches, _ = self._prefix_walk(tokens)
        return len(matches) * self.cfg.page_size

    def add_remote(self, req: EngineRequest) -> Optional[RemoteAllocation]:
        """Allocate decode-side pages for the whole prompt up front and hold
        the sequence until the remote prefill lands. None when the pages
        are not free right now (the caller prefills locally)."""
        seq = self._admit(req)
        if not self._ensure_pages(seq, len(seq.prompt)):
            self.finish(seq)   # return the shared prefix pages
            return None
        self.remote[req.request_id] = seq
        return RemoteAllocation(
            request_id=req.request_id, page_ids=list(seq.pages),
            num_cached_tokens=seq.num_cached, alloc_epoch=seq.epoch)

    def activate_remote(self, request_id: str, first_token: int
                        ) -> SequenceState:
        """The remote prefill's KV is injected: seed the first generated
        token and enter the normal flow (a one-token prefill chunk writes
        that token's KV, then the sequence takes a decode slot)."""
        self.overlap_gates.pop(request_id, None)
        seq = self.remote.pop(request_id)
        n = len(seq.prompt)
        seq.num_cached = n
        seq.num_computed = n
        seq.output.append(int(first_token))
        self._seal_full_pages(seq)  # stored events for the injected pages
        self.waiting.appendleft(seq)
        return seq

    def release_remote(self, request_id: str) -> None:
        """Drop a pending remote allocation (prefill failed, client gone)."""
        self.overlap_gates.pop(request_id, None)
        seq = self.remote.pop(request_id, None)
        if seq is not None:
            self.finish(seq)

    # -- early decode over the committed frontier ----------------------------

    def preactivate_remote(self, request_id: str, first_token: int,
                           needed_pages: int, frontier_fn) -> None:
        """Arm an early-decode gate: the sequence activates as soon as
        `frontier_fn()` (the transfer's committed pages for this
        allocation's epoch) reaches `needed_pages`, the length of the
        transfer list, instead of waiting for the completion notify."""
        if request_id not in self.remote:
            raise KeyError(f"request {request_id!r} not pending remote")
        self.overlap_gates[request_id] = (int(first_token),
                                          max(0, needed_pages), frontier_fn)

    def cancel_overlap(self, request_id: str) -> bool:
        """Disarm a gate: True when it was still pending (the caller owns
        salvage or fallback), False when it had opened already."""
        return self.overlap_gates.pop(request_id, None) is not None

    def poll_overlap_gates(self) -> int:
        """Activate every gated sequence whose committed frontier covers
        its transfer list; returns how many activated."""
        activated = 0
        for rid in list(self.overlap_gates):
            first_token, needed, frontier_fn = self.overlap_gates[rid]
            if rid not in self.remote:
                del self.overlap_gates[rid]
                continue
            if frontier_fn() >= needed:
                del self.overlap_gates[rid]
                self.activate_remote(rid, first_token)
                self.overlap_activations += 1
                activated += 1
        return activated

    def salvage_remote(self, request_id: str, valid_pages: int,
                       first_token: Optional[int] = None) -> int:
        """An unrecoverable remote prefill after a partial transfer: keep
        the first `valid_pages` pages (verified and injected before their
        chunks were acked) and re-enter the prefill flow for the rest, with
        at least one token left to prefill. `first_token` (the early-decode
        path, where the first token was already emitted) is seeded as
        output[0]. Returns the prompt tokens salvaged."""
        self.overlap_gates.pop(request_id, None)
        seq = self.remote.pop(request_id)
        ps = self.cfg.page_size
        n = len(seq.prompt)
        valid = max(0, min(valid_pages * ps, n - 1))
        valid = max(valid, seq.num_cached)   # never below the prefix hit
        seq.num_cached = valid
        seq.num_computed = valid
        if first_token is not None:
            seq.output.append(int(first_token))
        self._seal_full_pages(seq)
        self.waiting.appendleft(seq)
        return valid

    # -- disaggregation: prefill side ----------------------------------------

    def release_parked(self, request_id: str) -> None:
        """Free a parked prefill-only sequence's pages once its KV is
        read; its full pages stay in the reuse pool by content hash."""
        seq = self.parked.pop(request_id, None)
        if seq is not None:
            self.finish(seq)

    def _prefix_walk(self, tokens: List[int]):
        """Cached full-page prefix matches, stopping at the first miss in
        every tier; always leaves >= 1 token to recompute. Returns
        ([(kind, page_id or None, chained_hash, page_tokens)], n_full), kind
        "hbm", "host" (host or disk tier) or "pool" (the shared pool)."""
        ps = self.cfg.page_size
        n_full = (len(tokens) - 1) // ps
        parent, hashes = 0, []
        for i in range(n_full):
            parent = page_hash(parent, tokens[i * ps:(i + 1) * ps])
            hashes.append(parent)
        # settle ONLY the copies this walk could hit: in-flight copies of
        # our hashes land before the tier lookups, unrelated ones are not
        # waited for
        if self.settle_hashes is not None and hashes:
            self.settle_hashes(hashes)
        out = []
        for i, h in enumerate(hashes):
            toks = tokens[i * ps:(i + 1) * ps]
            pid = self.allocator.lookup(h)
            if pid is not None:
                out.append(("hbm", pid, h, toks))
            elif self.host_pool is not None and h in self.host_pool:
                out.append(("host", None, h, toks))
            elif self.kv_pool is not None and h in self.kv_pool:
                out.append(("pool", None, h, toks))
            else:
                break
        return out, n_full

    def _pool_claim(self, seq_hash: int):
        """Verified host copies of one shared-pool page, or None: a checksum
        mismatch quarantines the entry pool-side, and an entry of another
        kv_quant mode is rejected by name; both walk as a miss."""
        from dynamo_tpu_torch.engine.kv_pool import PoolQuantMismatch
        try:
            return self.kv_pool.fetch(seq_hash, self.kv_pool_mode)
        except PoolQuantMismatch as e:
            if not self._pool_quant_logged:
                self._pool_quant_logged = True
                import logging
                logging.getLogger("dynamo_tpu_torch.kv_pool").warning(
                    "shared-pool fetch rejected: %s (further mismatches "
                    "on this engine logged at debug)", e)
            return None

    def _match_prefix(self, seq: SequenceState) -> None:
        """Share resident full pages; claim host-tier and shared-pool pages
        into fresh HBM pages that the engine fills before the next step.

        Each hash is re-resolved when it is applied: an allocation below can
        evict a reusable page the walk saw in HBM. The eviction only queues
        the page for offload, so at re-resolution the hash is in no tier and
        the match ends there (the rest is recomputed); trusting the walk's
        page id would alias one physical page under two prefix positions."""
        ps = self.cfg.page_size
        matches, n_full = self._prefix_walk(seq.all_tokens)
        self._prefix_lookups += min(len(matches) + 1, n_full)
        if self.host_pool is not None:
            # the pins below verify one page at a time; hash them ahead, in
            # threads (the port's addition: same outcome, same counters)
            self.host_pool.preverify([h for kind, _, h, _ in matches
                                      if kind == "host"])
        parent = 0
        for _kind, _pid, h, toks in matches:
            pid = self.allocator.lookup(h)
            if pid is not None:
                self.allocator.share(pid)
            elif self.host_pool is not None:
                # pin() checks residency, verifies the bytes and pins in one
                # step, so a racing CopyStream eviction cannot take the slot
                if not self.allocator.can_allocate(1):
                    break
                if not self.host_pool.pin(h):
                    break
                pid = self.allocator.allocate()
                self.allocator.seal(pid, parent, toks)
                self.pending_onboards.append((pid, h))
                self.host_pool.stats.host_hits += 1
            elif self.kv_pool is not None and self.allocator.can_allocate(1):
                # each page is one committed unit: a claim that fails keeps
                # the pages claimed before it and recomputes the rest
                got = self._pool_claim(h)
                if got is None:
                    break
                pid = self.allocator.allocate()
                self.allocator.seal(pid, parent, toks)
                self.pending_pool_injects.append((pid, h, got))
                self.pool_fetched_pages += 1
            else:
                break
            seq.pages.append(pid)
            seq.page_hashes.append(h)
            seq.num_cached += ps
            self._prefix_hits += 1
            parent = h
        if self.host_pool is not None:
            self.host_pool.forget_verified()

    def drain_onboards(self) -> list:
        out, self.pending_onboards = self.pending_onboards, []
        return out

    def drain_pool_injects(self) -> list:
        out, self.pending_pool_injects = self.pending_pool_injects, []
        return out

    def finish(self, seq: SequenceState) -> None:
        if seq.streamed:
            if seq in self.stream_active:
                self.stream_active.remove(seq)
            if self.on_stream_finish is not None:
                self.on_stream_finish(seq)   # frees the streamed residency
            self.params.pop(seq.request_id, None)
            return
        if seq.preempted_by:
            # a victim that terminates without resuming still settles the
            # preemptor class's qos debt
            self._repay_preempt_debt(seq)
        if seq.slot >= 0:
            self.running[seq.slot] = None
            seq.slot = -1
        for pid in seq.pages:
            self.allocator.free(pid)
        seq.pages = []
        self.params.pop(seq.request_id, None)

    def abort(self, request_id: str) -> bool:
        for seq in list(self.waiting):
            if seq.request_id == request_id:
                self.waiting.remove(seq)
                self.finish(seq)
                return True
        for seq in self.running:
            if seq is not None and seq.request_id == request_id:
                self.finish(seq)
                return True
        for seq in list(self.stream_active):
            if seq.request_id == request_id:
                self.finish(seq)
                return True
        if request_id in self.remote:
            self.release_remote(request_id)
            return True
        if request_id in self.parked:
            self.release_parked(request_id)
            return True
        return False

    # -- planning ------------------------------------------------------------

    def _free_slot(self) -> int:
        for i, s in enumerate(self.running):
            if s is None:
                return i
        return -1

    def _ensure_pages(self, seq: SequenceState, upto_len: int) -> bool:
        """Allocate pages so positions [0, upto_len) have slots."""
        ps = self.cfg.page_size
        need = -(-upto_len // ps) - len(seq.pages)
        if need <= 0:
            return True
        if not self.allocator.can_allocate(need):
            return False
        for _ in range(need):
            seq.pages.append(self.allocator.allocate())
        return True

    def _seal_full_pages(self, seq: SequenceState) -> None:
        """Hash pages that just became full of computed tokens."""
        ps = self.cfg.page_size
        all_tokens = seq.prompt + seq.output
        n_full = seq.num_cached // ps
        while len(seq.page_hashes) < n_full:
            i = len(seq.page_hashes)
            parent = seq.page_hashes[-1] if seq.page_hashes else 0
            h = self.allocator.seal(seq.pages[i], parent,
                                    all_tokens[i * ps:(i + 1) * ps])
            seq.page_hashes.append(h)

    def set_mixed_token_budget(self, budget: int) -> int:
        """Runtime actuation point of the mixed-step token budget (JAX
        :881), what the autoscaler's MixedBudgetTuner adjusts as padding
        waste shifts with the traffic shape. Clamped: a positive request
        never lands below the floor where the smallest prefill chunk row
        no longer fits next to a decode row; 0 (or less) is the explicit
        switch to alternating steps. Returns the applied value."""
        budget = int(budget)
        applied = max(self._mixed_budget_floor, budget) if budget > 0 else 0
        self.mixed_token_budget = applied
        return applied

    def schedule(self):
        """Return a StreamPlan, MixedPlan, PrefillPlan, DecodePlan, or None
        (idle)."""
        plan = self._maybe_stream_plan()
        if plan is not None:
            return plan
        if self.mixed_token_budget > 0:
            decode_active = any(s is not None for s in self.running)
            if self.waiting and decode_active:
                plan = self._schedule_mixed()
                if plan is not None:
                    return plan
                # no admissible prefill row right now: a high-priority
                # head may preempt the lowest-class decode and re-plan
                if self._preempt_for(self.waiting[0]):
                    plan = (self._schedule_mixed()
                            or self._schedule_prefill())
                    if plan is not None:
                        return plan
                return self._schedule_decode()
            if self.waiting:
                plan = self._schedule_prefill()
                if plan is not None:
                    return plan
            return self._schedule_decode()
        limit = self.cfg.max_prefill_streak
        if limit and self._prefill_streak >= limit \
                and any(s is not None for s in self.running):
            plan = self._schedule_decode()
            if plan is not None:
                self._prefill_streak = 0
                return plan
        plan = self._schedule_prefill()
        if plan is not None:
            self._prefill_streak += 1
            return plan
        self._prefill_streak = 0
        return self._schedule_decode()

    def _maybe_stream_plan(self) -> Optional[StreamPlan]:
        """Interleave streamed steps with the slot path: when both kinds
        of work exist, streamed sequences take every other schedule() call;
        round-robin across streamed sequences."""
        if not self.stream_active:
            return None
        slot_work = bool(self.waiting) \
            or any(s is not None for s in self.running)
        self._stream_turn ^= 1
        if slot_work and not self._stream_turn:
            return None
        seq = self.stream_active[0]
        if len(self.stream_active) > 1:
            self.stream_active.append(self.stream_active.pop(0))
        return StreamPlan(seq=seq)

    def _prefill_admissible(self, seq: SequenceState, slots_left: int,
                            chunk_cap: Optional[int] = None):
        """Can this waiting seq's next chunk run now? Returns (n, is_last,
        takes_slot) or a string reason ("slot" | "memory")."""
        n_toks = len(seq.all_tokens)
        if seq.num_cached >= n_toks:
            raise AssertionError("prefix match must leave >=1 token")
        cap = self.cfg.max_prefill_chunk
        if chunk_cap is not None:
            cap = min(cap, chunk_cap)
        n = min(n_toks - seq.num_cached, cap)
        is_last = seq.num_cached + n == n_toks
        takes_slot = is_last and not seq.prefill_only
        if takes_slot and slots_left <= 0:
            # the final chunk needs a decode slot (a prefill-only sequence
            # parks instead)
            return "slot"
        if not self._ensure_pages(seq, seq.num_cached + n):
            return "memory"
        return n, is_last, takes_slot

    def _collect_prefill_batch(self, slots_left: int,
                               chunk_cap: Optional[int] = None,
                               max_rows: Optional[int] = None):
        """Pop admissible waiting seqs whose next chunk shares one token
        bucket; returns (batch [(seq, n, is_last)], tb, head_block).
        Up to prefill_skip_ahead blocked/mismatched entries are scanned
        past; the queue is never reordered."""
        bound = max(0, self.cfg.prefill_skip_ahead)
        max_b = max(1, self.cfg.max_prefill_batch)
        if max_rows is not None:
            max_b = min(max_b, max(1, max_rows))
        batch, tb, head_block = [], None, None
        i = skipped = 0
        while len(batch) < max_b and i < len(self.waiting):
            cand = self.waiting[i]
            res = None
            if tb is not None:
                cap = self.cfg.max_prefill_chunk
                if chunk_cap is not None:
                    cap = min(cap, chunk_cap)
                nc = min(len(cand.all_tokens) - cand.num_cached, cap)
                if next_bucket(nc, self.prefill_buckets) != tb:
                    res = "bucket"  # only same-bucket chunks share a step
            if res is None:
                res = self._prefill_admissible(cand, slots_left, chunk_cap)
            if isinstance(res, str):
                if i == 0 and not batch and res != "bucket":
                    head_block = res
                skipped += 1
                if skipped > bound:
                    break
                i += 1
                continue
            n, is_last, takes_slot = res
            if tb is None:
                tb = next_bucket(n, self.prefill_buckets)
            slots_left -= takes_slot
            batch.append((cand, n, is_last))
            del self.waiting[i]  # later entries shift left; i stays put
        return batch, tb, head_block

    def _schedule_prefill(self) -> Optional[PrefillPlan]:
        if not self.waiting:
            return None
        slots_left = sum(1 for s in self.running if s is None)
        batch, tb, head_block = self._collect_prefill_batch(slots_left)
        if not batch and head_block in ("slot", "memory"):
            # cross-class preemption for a blocked high-priority head
            if self._preempt_for(self.waiting[0]):
                slots_left = sum(1 for s in self.running if s is None)
                batch, tb, head_block = \
                    self._collect_prefill_batch(slots_left)
        if not batch:
            if head_block == "memory":
                # only a true dead end raises: no running decode, no
                # parked or remote sequence whose pages will be released
                head = self.waiting[0]
                if not any(s is not None for s in self.running) \
                        and not self.parked and not self.remote:
                    raise MemoryError(
                        f"prompt of {len(head.all_tokens)} tokens cannot "
                        f"fit in {self.cfg.num_pages} pages of "
                        f"{self.cfg.page_size}")
            return None  # blocked (slots, or memory pressure draining)
        return self._build_prefill(batch, tb)

    def _schedule_mixed(self) -> Optional[MixedPlan]:
        """One fused prefill+decode step, or None when no prefill row is
        admissible. Decode rows are charged the full Tb-wide row each
        occupies; the prefill chunk bucket is the largest rung with
        Tb * (n_decode + 1) <= mixed_token_budget (the smallest rung when
        nothing fits, so prefill always progresses)."""
        active = [s for s in self.running if s is not None]
        for seq in active:
            while seq.slot >= 0 \
                    and not self._ensure_pages(seq, seq.total_len + 1):
                self._preempt_one()
        active = [s for s in self.running if s is not None]
        if not active:
            return None  # everything preempted; caller re-plans
        n_decode = len(active)
        budget = self.mixed_token_budget
        cap = self.prefill_buckets[0]  # progress guarantee
        for rung in reversed(self.prefill_buckets):
            if rung * (n_decode + 1) <= budget:
                cap = rung
                break
        slots_left = sum(1 for s in self.running if s is None)
        max_rows = max(1, budget // cap - n_decode)
        batch, tb, _ = self._collect_prefill_batch(slots_left, cap,
                                                   max_rows)
        if not batch:
            return None
        return self._build_prefill(batch, tb, decode_rows=active)

    def _build_prefill(self, batch, tb: int,
                       decode_rows: Sequence[SequenceState] = ()
                       ) -> PrefillPlan:
        """Build a [Bb, Tb] prefill plan; with decode_rows, a MixedPlan
        whose leading rows are those running slots as single-token decode
        rows. Bb rides a fixed pow2 ladder, Tb the prefill buckets and Pb
        the page ladder."""
        ps = self.cfg.page_size
        nd = len(decode_rows)
        n_rows = nd + len(batch)
        row_cap = self.cfg.max_prefill_batch
        if nd:
            row_cap = self.cfg.max_slots + max(1, self.cfg.max_prefill_batch)
        bb = next_bucket(n_rows, pow2_buckets(max(n_rows, row_cap)))
        tokens = np.zeros((bb, tb), np.int32)
        positions = np.zeros((bb, tb), np.int32)
        write_idx = np.full((bb, tb), -1, np.int32)
        kv_lens = np.zeros((bb,), np.int32)
        last = np.zeros((bb,), np.int32)
        max_pages = max(max(len(s.pages) for s, _, _ in batch), 1)
        for seq in decode_rows:
            # admission-time width (prompt + max_tokens), as the decode
            # planner buckets it
            max_pages = max(
                max_pages, len(seq.pages),
                -(-(len(seq.prompt) + self.params[seq.request_id].max_tokens)
                  // ps))
        pb = next_bucket(max_pages, self.page_buckets)
        page_table = np.zeros((bb, pb), np.int32)
        seqs: List[Optional[SequenceState]] = [None] * bb
        n_valid, is_last = [0] * bb, [False] * bb
        is_decode = [False] * bb
        mm_embeds = mm_mask = None
        for i, seq in enumerate(decode_rows):
            # one-token causal decode row: feed the last sampled token at
            # its position; padding columns carry the same position and
            # write nothing
            seqs[i] = seq
            is_decode[i] = True
            n_valid[i] = 1
            pos = seq.total_len - 1
            tokens[i, 0] = seq.output[-1] if seq.output else seq.prompt[-1]
            positions[i, :] = pos
            write_idx[i, 0] = seq.flat_index(pos, ps)
            page_table[i, :len(seq.pages)] = seq.pages
            kv_lens[i] = pos + 1
            last[i] = 0
        for j, (seq, n, last_chunk) in enumerate(batch):
            i = nd + j
            start = seq.num_cached
            seqs[i] = seq
            n_valid[i] = n
            is_last[i] = last_chunk
            tokens[i, :n] = seq.all_tokens[start:start + n]
            positions[i, :] = max(start + n - 1, 0)
            positions[i, :n] = np.arange(start, start + n)
            for t in range(n):
                write_idx[i, t] = seq.flat_index(start + t, ps)
            page_table[i, :len(seq.pages)] = seq.pages
            kv_lens[i] = start + n
            last[i] = n - 1
            # multimodal rows: each image span's overlap with this chunk's
            # [start, start + n) goes into the plan's embed rows
            for off, emb in seq.mm_spans:
                lo, hi = max(off, start), min(off + emb.shape[0], start + n)
                if lo >= hi:
                    continue
                if mm_embeds is None:
                    mm_embeds = np.zeros((bb, tb, emb.shape[1]), np.float32)
                    mm_mask = np.zeros((bb, tb), bool)
                mm_embeds[i, lo - start:hi - start] = emb[lo - off:hi - off]
                mm_mask[i, lo - start:hi - start] = True
        kw = dict(
            seqs=seqs, tokens=tokens, positions=positions,
            page_table=page_table, kv_lens=kv_lens, write_idx=write_idx,
            last_idx=last, n_valid=n_valid, is_last_chunk=is_last,
            mm_embeds=mm_embeds, mm_mask=mm_mask)
        if nd:
            return MixedPlan(is_decode=is_decode, **kw)
        return PrefillPlan(**kw)

    def commit_prefill_row(self, plan: PrefillPlan, i: int,
                           sampled_token: Optional[int]):
        """Account row i of a finished prefill step; returns the emitted
        token or None (chunking continues / padding row)."""
        seq = plan.seqs[i]
        if seq is None:
            return None
        seq.num_cached += plan.n_valid[i]
        seq.num_computed += plan.n_valid[i]
        self._seal_full_pages(seq)
        if plan.is_last_chunk[i]:
            if sampled_token is None:
                raise ValueError("final prefill chunk committed without a "
                                 "sampled token")
            if seq.prefill_only:
                # park with pages held until the transfer reads the KV
                self.parked[seq.request_id] = seq
                return int(sampled_token)
            slot = self._free_slot()
            if slot < 0:
                raise RuntimeError("final prefill chunk scheduled without a "
                                   "free slot")
            seq.slot = slot
            self.running[slot] = seq
            if seq.preempted_by:
                self._repay_preempt_debt(seq)
            seq.output.append(int(sampled_token))
            return int(sampled_token)
        self.waiting.appendleft(seq)  # continue chunking next step
        return None

    def _schedule_decode(self) -> Optional[DecodePlan]:
        active = [s for s in self.running if s is not None]
        if not active:
            return None
        ps = self.cfg.page_size
        # adaptive window: the smallest ladder rung covering the smallest
        # remaining token budget across active slots; pages are reserved
        # for the rung actually executed
        ladder = window_ladder(self.cfg.decode_steps)
        min_remaining = max(1, min(
            len(s.prompt) + self.params[s.request_id].max_tokens
            - s.total_len for s in active))
        n_window = next((w for w in reversed(ladder) if w >= min_remaining),
                        ladder[0])
        for seq in active:
            limit = len(seq.prompt) + self.params[seq.request_id].max_tokens
            upto = max(seq.total_len + 1, min(seq.total_len + n_window,
                                              limit))
            while seq.slot >= 0 and not self._ensure_pages(seq, upto):
                self._preempt_one()
        active = [s for s in self.running if s is not None]
        if not active:
            return None
        # pipeline lookahead: the engine dispatches up to pipeline_depth
        # windows against THIS plan's page table before the first commits,
        # so their pages are allocated (and listed in the table) now. Best
        # effort: speculation never preempts; a failed allocation only means
        # no follow-up window chains off this plan
        if self.cfg.pipeline_depth > 1:
            for seq in active:
                limit = (len(seq.prompt)
                         + self.params[seq.request_id].max_tokens)
                self._ensure_pages(seq, min(
                    seq.total_len + n_window * self.cfg.pipeline_depth,
                    limit))
        s_count = self.cfg.max_slots
        # table width bucketed by each request's ADMISSION-TIME page limit,
        # so it never changes mid-request
        max_pages = max(
            max(len(s.pages),
                -(-(len(s.prompt) + self.params[s.request_id].max_tokens)
                  // ps))
            for s in active)
        pb = next_bucket(max_pages, self.page_buckets)
        tokens = np.zeros((s_count, 1), np.int32)
        positions = np.zeros((s_count, 1), np.int32)
        page_table = np.zeros((s_count, pb), np.int32)
        kv_lens = np.zeros((s_count,), np.int32)
        write_idx = np.full((s_count, 1), -1, np.int32)
        max_pos = np.full((s_count,), -1, np.int32)
        seqs: List[Optional[SequenceState]] = [None] * s_count
        longest_stops = max((len(self.params[s.request_id].stop_token_ids)
                             for s in active), default=0)
        k_stops = 0
        if longest_stops:
            k_stops = next_bucket(longest_stops,
                                  pow2_buckets(max(longest_stops, 8)))
        stop_ids = np.full((s_count, k_stops), -1, np.int32)
        for seq in active:
            i = seq.slot
            seqs[i] = seq
            last_tok = seq.output[-1] if seq.output else seq.prompt[-1]
            pos = seq.total_len - 1  # position of the token being fed
            tokens[i, 0] = last_tok
            positions[i, 0] = pos
            page_table[i, :len(seq.pages)] = seq.pages
            kv_lens[i] = pos + 1
            write_idx[i, 0] = seq.flat_index(pos, ps)
            max_pos[i] = (len(seq.prompt)
                          + self.params[seq.request_id].max_tokens - 1)
            stops = self.params[seq.request_id].stop_token_ids
            if stops:
                stop_ids[i, :len(stops)] = list(stops)
        return DecodePlan(
            seqs=seqs, tokens=tokens, positions=positions,
            page_table=page_table, kv_lens=kv_lens, write_idx=write_idx,
            last_idx=np.zeros((s_count,), np.int32), max_pos=max_pos,
            n_window=n_window, stop_ids=stop_ids)

    def _preempt_one(self) -> None:
        """Evict one running seq back to waiting under MEMORY pressure:
        lowest QoS class first, youngest within a class."""
        victim = select_victim(self.running, self.qos_policy)
        if victim is None:
            raise MemoryError("KV cache exhausted with nothing to preempt")
        self._evict_to_waiting(victim)

    def _preempt_for(self, seq: SequenceState) -> bool:
        """Cross-class preemption: a blocked high-priority arrival evicts
        the lowest-priority running decode strictly below its class,
        charged against the preemptor class's budget. Returns True when a
        victim was evicted."""
        cls = self.qos_policy.resolve(seq.qos or None)
        if cls.preempt_budget <= 0 or \
                self._qos_preempt_debt.get(cls.name, 0) \
                >= cls.preempt_budget:
            if cls.preempt_budget > 0:
                QOS_STATS.preempt_denied_budget += 1
            return False
        victim = select_victim(self.running, self.qos_policy,
                               below_prio=seq.qos_prio)
        if victim is None:
            return False
        victim.preempted_by = cls.name
        self._qos_preempt_debt[cls.name] = \
            self._qos_preempt_debt.get(cls.name, 0) + 1
        QOS_STATS.note_preempt(
            cls.name, self.qos_policy.resolve(victim.qos or None).name)
        self._evict_to_waiting(victim)
        return True

    def _repay_preempt_debt(self, seq: SequenceState) -> None:
        """A preemption victim resumed decoding (or finished): repay the
        preemptor class's outstanding debt."""
        cls = seq.preempted_by
        seq.preempted_by = None
        if not cls:
            return
        n = self._qos_preempt_debt.get(cls, 0)
        if n > 1:
            self._qos_preempt_debt[cls] = n - 1
        else:
            self._qos_preempt_debt.pop(cls, None)

    def _evict_to_waiting(self, victim: SequenceState) -> None:
        """Shared eviction mechanics for both preemption paths: free the
        pages (sealed ones stay claimable by hash), restart from the
        committed prefix, requeue at the head of the victim's class band."""
        self.running[victim.slot] = None
        victim.slot = -1
        victim.epoch = next(self._epoch_seq)
        for pid in victim.pages:
            self.allocator.free(pid)
        victim.pages = []
        victim.page_hashes = []
        victim.num_cached = 0
        victim.num_computed = 0
        self._match_prefix(victim)
        idx = 0
        while idx < len(self.waiting) \
                and self.waiting[idx].qos_prio > victim.qos_prio:
            idx += 1
        self.waiting.insert(idx, victim)

    def commit_decode_token(self, seq: SequenceState, tok: int) -> None:
        """Account one decoded token for one sequence (fed-token KV
        resident, page seals, output append)."""
        seq.num_cached += 1
        seq.num_computed += 1
        self._seal_full_pages(seq)
        seq.output.append(int(tok))

    # -- metrics -------------------------------------------------------------

    def metrics(self) -> EngineMetrics:
        alloc = self.allocator
        active = sum(1 for s in self.running if s is not None)
        return EngineMetrics(
            request_active_slots=active,
            request_total_slots=self.cfg.max_slots,
            kv_active_blocks=alloc.num_pages - alloc.num_free,
            kv_total_blocks=alloc.num_pages,
            num_requests_waiting=len(self.waiting),
            gpu_cache_usage_perc=alloc.usage,
            gpu_prefix_cache_hit_rate=(
                self._prefix_hits / self._prefix_lookups
                if self._prefix_lookups else 0.0),
            gpu_prefix_cache_hits=self._prefix_hits,
            gpu_prefix_cache_lookups=self._prefix_lookups,
            requests_admitted=self._admitted,
        )
