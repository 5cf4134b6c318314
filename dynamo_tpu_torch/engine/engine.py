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

Left out of this slice: speculative decoding, pipeline/tensor parallelism,
streaming, the KV tiers and pool, vision, page extract/inject and the
gather decode window.
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
        self.scheduler = Scheduler(engine_cfg)
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
        follow-up window may still run); the engine owns no threads or
        files."""
        self._sync_stream()

    def has_work(self) -> bool:
        s = self.scheduler
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
            if self._pipeline is not None:
                return self._pipeline_step()
            with self.phases.phase("plan"):
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
        return m

    def logits_nonfinite_steps(self) -> int:
        """Steps whose sampled logits held NaN or inf (waits for the
        device)."""
        with self._on_stream():
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

    def _postprocess_row(self, seq, tok, lps, i) -> StepOutput:
        if lps is None:
            return self._postprocess(seq, tok)
        return self._postprocess(seq, tok, float(lps[0][i]), lps[1][i],
                                 lps[2][i])

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
        if self.cfg.pipeline_depth < 2 or self.scheduler.waiting:
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
        plan, staged = pend["plan"], pend["staged"]
        follow = None
        if pend.get("drain") or self.scheduler.waiting:
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
