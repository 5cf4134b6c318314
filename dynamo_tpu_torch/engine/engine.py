"""NativeEngine: the PyTorch serving engine for one model on one device.

Port of dynamo_tpu/engine/engine.py for the slice's main path. The
scheduler (engine/scheduler.py) plans prefill, mixed and decode steps;
prefill and mixed steps run `models/llama.forward` and sample one token per
row (`_engine_step`); decode runs a window of `decode_steps` iterations of
`models/llama.decode_forward` (`_engine_decode_window`), the sampled token
feeding the next iteration on the device, with ONE device-to-host copy of
the window's tokens at its end.

The decode window is the JAX package's kernel-mode body
(dynamo_tpu/engine/engine.py:2308-2321): the cache is read-only inside each
step (the ragged kernel in prefix mode plus combine_self_attention), and
each step's new kv rows are scattered into the cache in place
(`_scatter_new_kv`; on an int8 cache the rows quantize there and their
values and scales land together) before the next step. Every position,
prefix length, write slot and sampling counter of a window is known on the
host when the window starts, so they are uploaded once and the loop never
waits on the device. A slot that samples eos mid-window keeps writing inside its own
pages until the window ends (the JAX window drops those writes); nothing
reads them, and its pages are freed at commit.

The engine is the synchronous dispatch -> fetch -> commit loop (the JAX
package's pipeline_depth=1; its docs hold output token-identical at any
depth). Left out of this slice: the two-deep pipeline, speculative decoding,
pipeline/tensor parallelism, streaming, the KV tiers and pool, vision, and
page extract/inject.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set

import numpy as np
import torch

from dynamo_tpu_torch.engine.config import (
    EngineConfig, ModelConfig, check_supported,
)
from dynamo_tpu_torch.engine.kv_cache import SequenceState
from dynamo_tpu_torch.engine.sampler import (
    RepPenaltyCache, SamplingArrayCache, sample_logits, seen_token_mask,
)
from dynamo_tpu_torch.engine.scheduler import (
    DecodePlan, EngineRequest, MixedPlan, PrefillPlan, SamplingParams,
    Scheduler, next_bucket, pow2_buckets, window_ladder,
)
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models.llama import AttnMetadata
from dynamo_tpu_torch.ops.attention import write_slots
from dynamo_tpu_torch.ops.kv_quant import (
    is_quantized_cache, page_bytes, quantize_rows, validate_mode,
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
        self.model_cfg = model_cfg
        self.cfg = engine_cfg
        self.eos_token_ids = set(eos_token_ids or ())
        self._eos = tuple(sorted(self.eos_token_ids))
        self.scheduler = Scheduler(engine_cfg)
        self.params = (params if params is not None else
                       llama.init_params(model_cfg, self.device, seed))
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
        self.mixed_steps = 0
        self.decode_stall_steps = 0

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
        """Nothing to release: the engine owns no threads or files."""

    def has_work(self) -> bool:
        s = self.scheduler
        return bool(s.waiting) or any(x is not None for x in s.running)

    def step(self) -> List[StepOutput]:
        """Run one scheduler step on the device; returns per-request
        events."""
        plan = self.scheduler.schedule()
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
        m.mixed_steps = self.mixed_steps
        m.decode_stall_steps = self.decode_stall_steps
        # KV representation: bytes one page occupies on the device (k + v,
        # plus scales when quantized) and the quantized bit width (0 = none)
        mc = self.model_cfg
        m.kv_page_bytes = page_bytes(
            mc.num_layers, mc.num_kv_heads, self.cfg.page_size, mc.head_dim,
            llama.torch_dtype(mc).itemsize, bool(self.kv_quant))
        m.kv_quant_bits = 8 if self.kv_quant == "int8" else 0
        return m

    def logits_nonfinite_steps(self) -> int:
        """Steps whose sampled logits held NaN or inf (waits for the
        device)."""
        return int(self._nonfinite.item())

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
            self.model_cfg, self._eos, self.params, self.cache,
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
        self.mixed_steps += 1
        return events

    def _postprocess_row(self, seq, tok, lps, i) -> StepOutput:
        if lps is None:
            return self._postprocess(seq, tok)
        return self._postprocess(seq, tok, float(lps[0][i]), lps[1][i],
                                 lps[2][i])

    def _window_rung(self, plan: DecodePlan) -> int:
        """Smallest ladder rung covering the plan's window."""
        return next((w for w in reversed(self._window_sizes)
                     if w >= max(1, plan.n_window)), self._window_sizes[0])

    def _run_decode(self, plan: DecodePlan) -> List[StepOutput]:
        temp, top_k, top_p, seeds, counters, min_toks = \
            self._sampling_arrays(plan.seqs)
        rp = self._rep_penalty_arrays(plan.seqs)
        with_lp = self._wants_logprobs(plan.seqs)
        greedy = self._samp_cache.all_greedy
        # the top_p-free sampling tail when every row has top_p disabled;
        # logprob plans keep the full tail
        fused = (not greedy and not with_lp
                 and self._samp_cache.fused_eligible)
        nw = self._window_rung(plan)
        ps = self.cfg.page_size
        # every step's position, attended prefix, write slot and sampling
        # counter is known now: stage them for the whole window at once
        s = len(plan.seqs)
        steps = np.arange(nw, dtype=np.int64)[:, None]
        pos = plan.positions[:, 0].astype(np.int64)[None, :] + steps
        max_pos = plan.max_pos.astype(np.int64)[None, :]
        prefix = np.clip(pos, 0, max_pos + 1)
        page = plan.page_table[np.arange(s)[None, :],
                               np.maximum(np.minimum(pos, max_pos), 0) // ps]
        widx = np.where(pos <= max_pos, page * ps + pos % ps, -1)
        ctr = counters.astype(np.int64)[None, :] + steps
        toks, lps, top_ids, top_lps = _engine_decode_window(
            self.model_cfg, self._eos, self.params, self.cache,
            self._dev(plan.tokens[:, 0]), self._dev(plan.page_table),
            self._dev(pos.astype(np.int32)),
            self._dev(prefix.astype(np.int32)),
            self._dev(widx.astype(np.int32)), self._dev(ctr.astype(np.int32)),
            self._dev(temp), self._dev(top_k), self._dev(top_p),
            self._dev(seeds), self._dev(min_toks),
            hist=None if rp is None else self._dev(rp[0]),
            rep_penalty=None if rp is None else self._dev(rp[1]),
            with_lp=with_lp, greedy=greedy, fused=fused,
            nonfinite=self._nonfinite)
        # the one intended host sync per decode window
        toks = toks.cpu().numpy()
        if with_lp:
            lps, top_ids, top_lps = (lps.cpu().numpy(), top_ids.cpu().numpy(),
                                     top_lps.cpu().numpy())
        self.decode_windows += 1
        self.decode_window_steps += nw
        self.decode_host_syncs += 1
        return self._commit_window(plan, toks, lps, top_ids, top_lps)

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


def _engine_step(cfg: ModelConfig, eos_ids: tuple, params, cache, tokens,
                 positions, page_table, kv_lens, write_idx, last_idx,
                 temperature, top_k, top_p, seeds, counters, min_tokens,
                 hist=None, rep_penalty=None, with_lp=False, greedy=False,
                 nonfinite=None):
    """forward + last-position logits + sample for one prefill or mixed
    step. Returns (tokens [B] int32, sampled_lp, top_ids, top_lps), the lp
    outputs None unless with_lp. The cache is updated in place."""
    meta = AttnMetadata(positions=positions, page_table=page_table,
                        kv_lens=kv_lens, write_idx=write_idx)
    last, _ = llama.forward(params, cfg, tokens, cache, meta,
                            last_idx=last_idx)          # [B, V] f32
    if nonfinite is not None:
        nonfinite += (~torch.isfinite(last)).any()
    seen = (seen_token_mask(hist, cfg.vocab_size)
            if rep_penalty is not None else None)
    return sample_logits(last, eos_ids, temperature, top_k, top_p, seeds,
                         counters, min_tokens, seen=seen,
                         rep_penalty=rep_penalty, with_lp=with_lp,
                         greedy=greedy)


def _engine_decode_window(cfg: ModelConfig, eos_ids: tuple, params, cache,
                          tokens, page_table, positions, prefix_lens,
                          write_idx, counters, temperature, top_k, top_p,
                          seeds, min_tokens, hist=None, rep_penalty=None,
                          with_lp=False, greedy=False, fused=False,
                          nonfinite=None):
    """N decode iterations, the sampled token feeding the next on the
    device. positions / prefix_lens / write_idx / counters are [N, S] (one
    row per step); tokens [S] is the fed token of step 0. Each step runs
    decode_forward with the cache read-only, then scatters the step's kv
    rows into the cache in place.

    Returns (tokens [N, S] int32, lps, top_ids, top_lps), still on the
    device; the lp outputs are None unless with_lp."""
    seen = (seen_token_mask(hist, cfg.vocab_size)
            if rep_penalty is not None else None)
    tok = tokens
    outs = []
    for t in range(positions.shape[0]):
        logits, k_news, v_news = llama.decode_forward(
            params, cfg, tok, cache, page_table, prefix_lens[t],
            positions[t])
        _scatter_new_kv(cache, k_news, v_news, write_idx[t])
        if nonfinite is not None:
            nonfinite += (~torch.isfinite(logits)).any()
        tok, lp, top_ids, top_lps = sample_logits(
            logits, eos_ids, temperature, top_k, top_p, seeds, counters[t],
            min_tokens, seen=seen, rep_penalty=rep_penalty, with_lp=with_lp,
            greedy=greedy, fused=fused)
        if seen is not None:
            seen.scatter_(1, tok[:, None].long(), True)
        outs.append((tok, lp, top_ids, top_lps))
    toks = torch.stack([o[0] for o in outs])
    if not with_lp:
        return toks, None, None, None
    return (toks, torch.stack([o[1] for o in outs]),
            torch.stack([o[2] for o in outs]),
            torch.stack([o[3] for o in outs]))
