"""Speculative decoding: draft proposal sources (n-gram and draft-model).

Copied from dynamo_tpu/engine/spec.py. Decode is weight-read-bound: a
forward over K + 1 tokens reads the same weights as a forward over one, so
verifying K cheap draft tokens in ONE target forward multiplies decode
throughput by the mean accepted length. The engine's verify step
(engine._run_spec_decode) recomputes the greedy token at every block
position (with the min-tokens eos ban), accepts the longest matching prefix
and emits the model's own token at the first mismatch, so speculative
greedy output is token for token the plain greedy output whenever both
paths compute the same arithmetic (f32 on the CPU). In bf16 on the card the
verify (the ragged kernel over the prefix, the block folded in f32:
ops/paged_attention.block_attention) and the decode window (the kernel and
one self-term a step) sum in other orders, so an argmax whose top-2 gap is
below their rounding can flip. Draft quality changes speed, never content.

Two draft sources share the verify:

- **ngram** (`ngram_propose`): prompt lookup, no second model. Wins on
  summarization, RAG and code-edit traffic whose output restates its
  context.
- **draft** (`DraftModel`): a small model of the same vocabulary proposes
  K greedy tokens per spec step. Its paged KV cache is shaped by its own
  dims but indexed by the TARGET's page table and page ids, so the
  scheduler's allocation, prefix sharing and preemption need no draft-side
  twin. A catch-up forward replays the committed tokens the draft has not
  seen before each proposal (prompt prefill, window interludes,
  re-admissions, disaggregated activation).

The port's departures: the draft decodes through
`models/llama.decode_path(dcfg)` (the ragged kernel wherever it serves the
draft's geometry; JAX forces its gather path, dynamo_tpu/engine/spec.py:
214-216, because its Pallas kernel needs the target's shard_map plumbing,
which one device does not have), and its K proposal steps run as one
captured CUDA graph on the card (the counterpart of the JAX `_propose_fn`
jit), replayed from static input buffers. The catch-up replay stays eager,
like the engine's prefill.
"""
from __future__ import annotations

import logging
from typing import List, Optional, Sequence

import numpy as np
import torch

from dynamo_tpu_torch.engine.scheduler import next_bucket, pow2_buckets
from dynamo_tpu_torch.engine.window_graph import WindowGraphs
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.ops.attention import scatter_new_kv

# the suffix n-gram lengths prompt lookup matches, longest first: the JAX
# EngineConfig.spec_min_ngram / spec_max_ngram defaults (dynamo_tpu/engine/
# config.py:196-197), which no JAX caller changes
NGRAM_MIN = 2
NGRAM_MAX = 4

# The cost gate's prices (`gate_costs`). JAX prices a verify at one forward
# and one host dispatch, and a window of nw steps at nw forwards and one
# dispatch, a dispatch costing DISPATCH_RATIO forwards (its
# EngineConfig.spec_dispatch_ratio default, dynamo_tpu/engine/config.py:
# 206). On the card a window and a verify are each one graph replay, so no
# dispatch is amortized, and a verify costs VERIFY_STEPS window steps: the
# llama3-8b verify of an [8, 5] block at its widest page table (16.13 ms)
# over a window step at 8 slots (12.09 ms), NVIDIA H100 80GB HBM3 at
# 700 W (chip_smoke.py phase 17a; PERF.md section 6).
DISPATCH_RATIO = 2.0
VERIFY_STEPS = 1.33


def gate_costs(nw: int, device_type: str) -> tuple:
    """(window, verify): the times of an nw-step window and of a verify in
    one unit, for the cost gate, which passes drafts iff

        (n_live + ema * drafts) * window > n_live * nw * verify

    (tokens a unit of time: a verify emits every live slot's token and
    its accepted drafts, the window nw tokens a live slot). Off the card
    the JAX prices, so the CPU engine decides as the JAX engine does, step
    for step (tests/test_torch_spec.py); on the card the measured ones."""
    if device_type == "cuda":
        return float(nw), VERIFY_STEPS
    return nw + DISPATCH_RATIO, 1 + DISPATCH_RATIO


def truncate_to_vocab(cont: List[int],
                      vocab_size: Optional[int]) -> List[int]:
    """Cut a proposal at the first id outside [0, vocab_size): a history
    may hold ids the embedding must never see (the JAX scheduler salts
    multimodal spans with content hashes far outside the vocab)."""
    if vocab_size is None:
        return cont
    for i, x in enumerate(cont):
        if not 0 <= x < vocab_size:
            return cont[:i]
    return cont


def ngram_propose(tokens: Sequence[int], k: int,
                  min_ngram: int = NGRAM_MIN, max_ngram: int = NGRAM_MAX,
                  max_scan: int = 4096,
                  vocab_size: Optional[int] = None) -> List[int]:
    """Propose up to ``k`` draft tokens by prompt lookup.

    Finds the MOST RECENT earlier occurrence of the longest suffix n-gram
    (lengths ``max_ngram`` down to ``min_ngram``) of ``tokens`` within the
    last ``max_scan`` tokens, and returns the tokens that followed it.
    Overlapping self-matches are allowed (a trailing run "a a a" proposes
    more "a"s). Returns [] when the sequence is too short or nothing
    matches. A continuation is truncated at its first out-of-vocab id
    (``vocab_size``); matching runs over the raw history."""
    t = len(tokens)
    if k <= 0 or t < min_ngram + 1:
        return []
    lo = max(0, t - max_scan)
    arr = np.asarray(tokens[lo:], dtype=np.int64)
    n_arr = len(arr)
    best: List[int] = []
    for n in range(min(max_ngram, n_arr - 1), min_ngram - 1, -1):
        sfx = arr[n_arr - n:]
        # candidate windows start at 0..n_arr-n-1: every occurrence except
        # the terminal suffix itself
        win = np.lib.stride_tricks.sliding_window_view(arr[:n_arr - 1], n)
        hits = np.nonzero((win == sfx).all(axis=1))[0]
        if not len(hits):
            continue
        # the most recent occurrence whose continuation has all k tokens; a
        # longer match beats a shorter one, but an end-truncated draft
        # yields to a shorter-n full draft
        full = hits[hits + n + k <= n_arr]
        j = int(full[-1]) if len(full) else int(hits[-1])
        cont = truncate_to_vocab(
            [int(x) for x in arr[j + n:j + n + k]], vocab_size)
        if len(cont) == k:
            return cont
        if len(cont) > len(best):
            best = cont
    return best


def draft_cap(seq, max_pos_i: int, page_size: int, k: int) -> int:
    """Per-slot draft budget: every draft token's KV write (positions
    pos0+1 .. pos0+d) stays inside the slot's page allocation AND its
    max_tokens budget; the bonus token needs no write. One definition for
    both draft sources, so the gate, the propose's write clamp and the
    proposal lengths agree."""
    pos0 = seq.total_len - 1
    cap = min(len(seq.pages) * page_size - 1, int(max_pos_i))
    return max(0, min(k, cap - pos0))


# -- draft-model proposals -----------------------------------------------------

# its proposals are argmaxes over the draft's vocabulary, never history ids
# dynalint: disable-next-line=R1
def _draft_propose_step(dcfg, k_steps: int, page_size: int, params, cache,
                        tokens, positions, page_table, max_write,
                        path: str = "ragged"):
    """K greedy draft steps (JAX `_draft_propose_step`, its lax.scan as a
    loop): feed the slot's last committed token, take the argmax, feed it,
    writing each fed token's KV row into the draft cache through the
    TARGET's page table. Returns the proposals [S, K] int32; the cache is
    updated in place. Rows past max_write (page allocation and max_tokens,
    from the host) drop their writes into the scratch page and clamp their
    reads. No host copy and no data-dependent shape: the loop is captured
    whole in one CUDA graph."""
    rows = torch.arange(tokens.shape[0], device=tokens.device)
    tok, pos = tokens, positions
    props = []
    for _ in range(k_steps):
        writable = pos <= max_write
        prefix = torch.minimum(torch.clamp(pos, min=0), max_write + 1)
        logits, k_news, v_news = llama.decode_forward(
            params, dcfg, tok, cache, page_table, prefix, pos,
            valid=writable, path=path)
        page = page_table[rows, torch.clamp(torch.minimum(pos, max_write),
                                            min=0).long() // page_size]
        widx = torch.where(writable, page * page_size + pos % page_size, -1)
        scatter_new_kv(cache, k_news, v_news, widx)
        tok = logits.argmax(dim=-1).to(torch.int32)
        props.append(tok)
        pos = pos + 1
    return torch.stack(props, dim=1)


def _draft_catchup_step(dcfg, params, cache, tokens, positions, page_table,
                        kv_lens, write_idx, path: str = "ragged") -> None:
    """Prefill-shaped draft forward that exists for its KV writes: replays
    committed tokens the draft has not seen. Only one column's logits are
    computed (nothing reads them)."""
    meta = llama.AttnMetadata(positions=positions, page_table=page_table,
                              kv_lens=kv_lens, write_idx=write_idx)
    last = torch.zeros((tokens.shape[0],), dtype=torch.int32,
                       device=tokens.device)
    llama.forward(params, dcfg, tokens, cache, meta, last_idx=last,
                  path=path)


class DraftModel:
    """Draft-model proposal source riding the target's page geometry
    (JAX `DraftModel`, dynamo_tpu/engine/spec.py:192-358).

    The cache has the target's num_pages (plus the scratch page) and page
    size, indexed by the target's page ids. Shared prefix pages are benign:
    a catch-up replay writes the same tokens' KV, and a freed-then-reused
    page is rewritten by its new request's catch-up before any read. `pos`
    tracks, per (request, admission epoch), the first position whose
    committed token the draft has NOT folded into its cache; an epoch
    mismatch (preempt and readmit) resets coverage to zero.

    On the card the K proposal steps are one graph replay (`graphs`, keyed
    by ("propose", S, Pb)); `graphs.replay_launches` counts the kernel
    launches of the replays alone. The engine hands its stream and its
    capture lock over, so the draft's captures exclude the same threads the
    engine's do."""

    def __init__(self, dcfg, engine_cfg, device, params=None, seed: int = 0,
                 stream=None):
        self.cfg = dcfg
        self.device = torch.device(device)
        self.path, self.path_reason = llama.decode_path(dcfg)
        if self.path == "gather" and dcfg.decode_kernel != "off":
            logging.getLogger(__name__).warning(
                "draft model %r: %s; its proposals decode through the "
                "gather path", dcfg.name, self.path_reason)
        self.vocab = dcfg.vocab_size
        self.k = engine_cfg.spec_k
        self.page_size = engine_cfg.page_size
        self.max_chunk = engine_cfg.max_prefill_chunk
        self._chunk_buckets = pow2_buckets(self.max_chunk)
        if params is None:
            params = llama.init_params(dcfg, self.device, seed)
        self.params = params
        # one page past the allocator's range, as the target's: the scratch
        # page at the same index absorbs dropped writes
        self.cache = llama.init_cache(dcfg, engine_cfg.num_pages + 1,
                                      engine_cfg.page_size, self.device)
        self.pos = {}   # request_id -> (epoch, first position not in cache)
        self.graphs = WindowGraphs(self.device, stream)
        # catch-up forwards run (eager), by their chunk bucket
        self.catchup_buckets = {}

    def forget(self, request_id: str) -> None:
        self.pos.pop(request_id, None)

    def _coverage(self, seq) -> int:
        epoch, p = self.pos.get(seq.request_id, (seq.epoch, 0))
        return p if epoch == seq.epoch else 0

    def caps(self, plan) -> List[int]:
        """Per-slot proposal budget (draft_cap), known before the draft
        runs, so the cost gate can refuse before any draft compute."""
        return [draft_cap(seq, plan.max_pos[i], self.page_size, self.k)
                if seq is not None else 0
                for i, seq in enumerate(plan.seqs)]

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

    def sync(self, plan) -> None:
        """Catch the draft cache up to every live slot's committed tokens
        (a bucketed batched replay; loops for lags beyond max_chunk)."""
        ps = self.page_size
        s = len(plan.seqs)
        while True:
            lags = [0] * s
            for i, seq in enumerate(plan.seqs):
                if seq is None:
                    continue
                lags[i] = max(0, (seq.total_len - 1) - self._coverage(seq))
            m = max(lags)
            if m == 0:
                return
            bucket = next_bucket(min(m, self.max_chunk),
                                 self._chunk_buckets)
            tokens = np.zeros((s, bucket), np.int32)
            positions = np.zeros((s, bucket), np.int32)
            write_idx = np.full((s, bucket), -1, np.int32)
            kv_lens = np.zeros((s,), np.int32)
            for i, seq in enumerate(plan.seqs):
                if seq is None or lags[i] == 0:
                    continue
                start = self._coverage(seq)
                n = min(lags[i], bucket)
                tokens[i, :n] = seq.all_tokens[start:start + n]
                # an id outside the draft's vocabulary (a salted history)
                # replays as 0: only draft quality is at stake, the target
                # verify rejects what follows from it
                row = tokens[i, :n]
                row[(row < 0) | (row >= self.vocab)] = 0
                positions[i, :] = start + n - 1
                positions[i, :n] = np.arange(start, start + n)
                for j in range(n):
                    write_idx[i, j] = seq.flat_index(start + j, ps)
                kv_lens[i] = start + n
                self.pos[seq.request_id] = (seq.epoch, start + n)
            _draft_catchup_step(self.cfg, self.params, self.cache,
                                self._dev(tokens), self._dev(positions),
                                self._dev(plan.page_table),
                                self._dev(kv_lens), self._dev(write_idx),
                                path=self.path)
            self.catchup_buckets[bucket] = \
                self.catchup_buckets.get(bucket, 0) + 1

    def _propose_program(self):
        def program(b):
            return (_draft_propose_step(
                self.cfg, self.k, self.page_size, self.params, self.cache,
                b["tokens"], b["positions"], b["page_table"],
                b["max_write"], path=self.path),)
        return program

    def propose(self, plan, caps: List[int]) -> List[List[int]]:
        """Sync, then run the K proposal steps (one graph replay on the
        card); returns per-slot proposal lists clamped to ``caps``
        (max_write = pos0 + cap is the same bound)."""
        self.sync(plan)
        s, pb = plan.page_table.shape
        toks0 = np.zeros((s,), np.int32)
        pos0s = np.zeros((s,), np.int32)
        max_write = np.full((s,), -1, np.int32)
        for i, seq in enumerate(plan.seqs):
            if seq is None:
                continue
            tok0 = int(plan.tokens[i, 0])
            # a last committed id outside the vocabulary feeds the same
            # sentinel the catch-up replays
            toks0[i] = tok0 if 0 <= tok0 < self.vocab else 0
            pos0s[i] = seq.total_len - 1
            max_write[i] = pos0s[i] + caps[i]
        i32 = torch.int32
        bufs = self.graphs.inputs(("propose", s, pb), {
            "tokens": ((s,), i32), "positions": ((s,), i32),
            "page_table": ((s, pb), i32), "max_write": ((s,), i32)})
        for name, arr in (("tokens", toks0), ("positions", pos0s),
                          ("page_table", plan.page_table),
                          ("max_write", max_write)):
            bufs[name].copy_(torch.from_numpy(np.ascontiguousarray(arr)))
        (props,) = self.graphs.run(("propose", s, pb),
                                   self._propose_program(), bufs, "propose",
                                   dead="max_write")
        # the copy out runs on the stream the replay ran on (the engine's)
        props = props.cpu().numpy()
        return [[int(x) for x in props[i, :caps[i]]] if caps[i] else []
                for i in range(s)]

    def committed(self, seq, accepted: int, emitted: int) -> None:
        """Record draft-cache coverage after a verify step: its rows hold
        the draft's OWN tokens, which match the committed history only
        through the accepted prefix. The proposal steps write rows for
        their K FED tokens (the slot's last token and proposals 1..K-1), so
        the Kth proposal's row is never written even when accepted: cap
        coverage at k - 1, or the next propose reads a zero row."""
        pos0 = (seq.total_len - 1) - emitted   # position before the step
        covered = pos0 + min(accepted, emitted, self.k - 1)
        self.pos[seq.request_id] = (seq.epoch, covered + 1)
