"""Continuous-batching scheduler for the port's engine.

Copied from dynamo_tpu/engine/scheduler.py, trimmed to the slice: one
aggregated engine on one device. The disaggregation hooks (remote
allocations, parked prefill-only sequences, early-decode gates), the KV
tiers (host/disk offload, the shared pool), tiered-KV streaming, sequence
parallelism and multimodal spans are left out. Planning is otherwise the
JAX package's, decision for decision, so both engines plan the same steps
for the same requests:

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
    PageAllocator, SequenceState, page_hash,
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
    # multi-tenant QoS class name (runtime/qos.py); "" = the policy default
    qos: str = ""


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
    # KV representation (ops/kv_quant.py): bytes one page occupies on the
    # device (k + v + scales) and the quantized bit width (0 = unquantized)
    kv_page_bytes: int = 0
    kv_quant_bits: int = 0
    # weight representation (ops/quant.py): device bytes of the parameter
    # tree (int8 values + f32 scales where quantized) and the bit width
    weight_bytes: int = 0
    weight_quant_bits: int = 0


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
    def __init__(self, cfg: EngineConfig):
        self.cfg = cfg
        self.allocator = PageAllocator(cfg.num_pages, cfg.page_size)
        self.waiting: deque[SequenceState] = deque()
        self.running: List[Optional[SequenceState]] = [None] * cfg.max_slots
        self.params: Dict[str, SamplingParams] = {}
        ps = cfg.page_size
        self.prefill_buckets = list(cfg.prefill_buckets)
        max_pages_per_seq = -(-cfg.max_model_len // ps)
        self.page_buckets = page_bucket_ladder(max_pages_per_seq)
        self._prefix_hits = 0
        self._prefix_lookups = 0
        self._prefill_streak = 0
        self.mixed_token_budget = cfg.mixed_token_budget
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
        qos_cls = self.qos_policy.resolve(req.qos or None)
        seq = SequenceState(request_id=req.request_id,
                            prompt=list(req.prompt),
                            epoch=next(self._epoch_seq),
                            qos=req.qos or "", qos_prio=qos_cls.priority)
        self.params[req.request_id] = req.params
        self._match_prefix(seq)
        return seq

    def add_request(self, req: EngineRequest) -> SequenceState:
        seq = self._admit(req)
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

    def _prefix_walk(self, tokens: List[int]):
        """Cached full-page prefix matches, stopping at the first miss;
        always leaves >= 1 token to recompute. Returns
        ([(page_id, chained_hash)], n_full)."""
        ps = self.cfg.page_size
        n_full = (len(tokens) - 1) // ps
        parent, out = 0, []
        for i in range(n_full):
            parent = page_hash(parent, tokens[i * ps:(i + 1) * ps])
            pid = self.allocator.lookup(parent)
            if pid is None:
                break
            out.append((pid, parent))
        return out, n_full

    def _match_prefix(self, seq: SequenceState) -> None:
        """Share resident full pages (prefix hit)."""
        ps = self.cfg.page_size
        matches, n_full = self._prefix_walk(seq.all_tokens)
        self._prefix_lookups += min(len(matches) + 1, n_full)
        for pid, h in matches:
            self.allocator.share(pid)
            seq.pages.append(pid)
            seq.page_hashes.append(h)
            seq.num_cached += ps
            self._prefix_hits += 1

    def finish(self, seq: SequenceState) -> None:
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

    def schedule(self):
        """Return a MixedPlan, PrefillPlan, DecodePlan, or None (idle)."""
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
        if is_last and slots_left <= 0:
            return "slot"   # the final chunk needs a decode slot
        if not self._ensure_pages(seq, seq.num_cached + n):
            return "memory"
        return n, is_last, is_last

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
                head = self.waiting[0]
                if not any(s is not None for s in self.running):
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
        kw = dict(
            seqs=seqs, tokens=tokens, positions=positions,
            page_table=page_table, kv_lens=kv_lens, write_idx=write_idx,
            last_idx=last, n_valid=n_valid, is_last_chunk=is_last)
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
        )
