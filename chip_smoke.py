#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (`dynamo_tpu_torch`) on one card.

    python3 chip_smoke.py

Phases (any failed check exits non-zero; nothing is caught):

1. Device: the card's name and power limit (nvidia-smi), then the build of
   every CUDA kernel in dynamo_tpu_torch/csrc/ with nvcc for sm_90a, one
   nvcc per source, all started together; each register / spill line of
   the build is printed with the kernel instantiation it belongs to, and a
   spill fails the run.
2. Kernels vs plain versions, on the same inputs:
   a. the ragged decode attention kernel (split-KV blocks + merge, one
      call) against its plain PyTorch version, in prefix and inclusive
      modes, f32 and bf16 caches: 8 and 32 rows at the llama3-8b head
      geometry (32 q heads, 8 kv heads) at hd 64 and 128 with ragged lengths
      including 0, 1, ps, ps+1 and a full table; then at hd 128 lens on and
      around the split boundaries the host picks at Pb 12, one row of 1000
      and one of Pb * ps = 4096 tokens, 8 rows up to max_model_len (2048)
      at Pb 32, GQA groups of 1, 4 and 8, and an all-empty batch (m = -1e30
      and l = ps exactly on every empty row); recycled page tails filled
      with NaN. Both compute the f32 state, so only summation order
      differs: rtol = atol = 1e-4 for f32 caches and 2e-3 for bf16 caches.
      The prefix fold and the inclusive division are compared in f32, before
      the one cast to q's dtype that both sides share (fold_f32);
   b. its int8 mode (int8 pages + per-row f32 scales) on the same cases,
      with an f32 q (rtol = atol = 1e-4) and a bf16 q (2e-3), tails holding
      garbage int8 values and NaN / inf scales;
   c. the legacy decode kernel against its plain version at hd 32/64/128 x
      f32/bf16/int8 caches (the parity geometry of tests/test_ragged_kernel
      with 32 q / 8 kv heads, ps 8, NaN-poisoned tails; normalised outputs
      within 1e-4 for f32 and int8 caches, 1e-2 for bf16 outputs), and
      against the ragged kernel's inclusive view on the same inputs; then
      its cluster schedule's cases (legacy_cases: S = 1 at 2048 tokens, 8
      rows up to max_model_len, lens on block-assignment boundaries, an
      all-clamped batch, GQA 1/4/8, ps 8/64/128) with f32, bf16 and int8
      caches (int8 with an f32 and a bf16 q), against both.
   d. the W8A16 kernel (csrc/w8a16_gemm.cu) against its plain version
      (`x @ wmat(w)`, computed in f32 from the same rounded weights) at
      every llama3-8b projection shape (wq, wk, wv, wo, w_gate, w_up,
      w_down, lm_head) at M = 1, 3, 8 and 16 with a bf16 x (max |diff| <=
      1e-2 * max |y|) and at M = 1 and 8 with an f32 x (rtol = atol =
      1e-4); at an odd N and a K the split does not divide (1000 x 333,
      4100 x 1031), f32 and bf16; at M = 512 (w_gate) through the route
      ops/quant.linear takes there (the dequantize entry, bit-identical to
      `wmat`, + torch.matmul) and through the kernel. Then CUDA-event times
      over replayed graphs (weights cycled past the L2) at M = 8 for each
      shape: the kernel, its bound (its bytes over 3.35 TB/s), its share of
      the bound, the plain version, and the library yardstick
      (torch.matmul against the bf16 weight of the same shape, twice the
      bytes); both routes at M = 16 and 512; the dequantize entry alone.
3. Small reference: the `tiny` model in f32, decode logits on the card
   (the kernels) against the same step on the CPU (the plain versions),
   within 1e-3, and the same greedy tokens from both engines; then the
   same with kv_quant="int8", and with quant="int8" (int8 weights: the
   W8A16 kernel on the card).
4. Main path: the llama3-8b card at full width with random bf16 weights,
   NativeEngine on cuda (default EngineConfig: pipeline_depth 2, every
   decode window one replay of a captured CUDA graph) ->
   NativeEngineWorker -> LocalPipeline.generate_chat, answering 8 chat
   requests (100-600 byte-token prompts, max_tokens 64, half greedy and
   half sampled with temperature 0.8, top_k 50 and a seed) twice: the
   first run captures the window graphs, the second runs on the warm
   engine. Each run is its own path and must finish every request with 64
   tokens or a stop, sample no non-finite logits, run one graph replay per
   decode window (decode_dispatches == decode_windows == replays), overlap
   windows (pipeline_overlapped > 0) and reuse staged plans
   (decode_plan_uploads < decode_windows), and launch the kernel
   num_layers x decode steps times (each replay adds the calls its graph
   captured) plus the launches of the eager warm-ups before captures; the
   first run captures at most 6 graphs (the ladder 8, 2, 1 x greedy,
   fused). One greedy request served twice must give the same tokens.
   Prints TTFT, decode tokens/s, peak memory, graphs captured, capture
   seconds, the graph pool's bytes and the engine's host-phase split, per
   run.
4b. Graph vs eager, on the main path's engine: for the greedy variant (the
   8 requests all greedy) and the fused one (the main path's mix), the next
   decode window of all 8 runs once as the graph replay and once as the
   eager `_engine_decode_window` on a clone of the cache and inputs; the
   tokens must be identical, and the largest cache difference (all pages
   but the scratch page) is printed. The fused variant's next window is
   traced with torch.profiler (the ragged split kernel must appear
   num_layers x nw times) and four engine steps after it are timed
   untraced: ms per decode step and the device-busy share.
4c. The 8 requests at pipeline_depth 1 on the same weights (the phase-4
   checks): each token stream must equal the depth-2 capturing run's.
5. int8 serving: phases 4 and 4b with EngineConfig(kv_quant="int8") on
   the same weights; also prints kv_page_bytes.
6. Kernels at the main path's shapes, on the engines' own caches after the
   runs (the bf16 cache after phase 4b, then freed so that the peak memory
   of phases 4c and 5 is their own; page table over the pages the run wrote, lens
   mid-decode): the ragged kernel (bf16 cache, then int8 cache) against
   its plain version on layers 0, L/2 and L-1 (tolerance 2e-3 for a bf16
   q), then CUDA-event times of the kernel (its launches captured in one
   CUDA graph and replayed, so its wrapper's host work cannot pace it; the
   eager per-call time is printed beside), its plain version, the library
   yardstick for the same function (page gather, dequantised for int8, +
   scaled_dot_product_attention) and the bound (valid K/V bytes, plus
   scales for int8, over 3.35 TB/s). Then the same at the full context
   (8 rows of 1536-2048 tokens, Pb 32; kernel vs plain on layer 0, the
   kernel's share of its bound). The legacy kernel on layer 0 against its
   plain version and the ragged kernel's inclusive view at both shapes,
   and for the bf16 cache its full-context time beside the ragged
   kernel's. The legacy kernel is timed the same way at the decode A/B's
   shapes, hd 128 (llama3-8b heads) and hd 64 (llama3-1b heads).
7. The int8 parity gate: dynamo_tpu_torch/bench.run_kv_quant_parity at
   llama3-8b on the main path's weights; it must pass its thresholds.
8. The decode A/B: dynamo_tpu_torch/bench.run_decode_kernel_ab at the
   llama3-8b and llama3-1b head geometries (8 rows, ps 64, Pb 4); the
   legacy, unified and unified + fused-tail arms must sample identical
   tokens. Prints the step times and ratios.

9. The HTTP path at full width: HttpService (frontend/service.py) on a
   localhost port in front of LocalPipeline -> NativeEngineWorker ->
   NativeEngine, llama3-8b with random weights from seed 0 and
   quant="int8", bf16 KV pages, the default EngineConfig. The 8 requests
   go over HTTP, 4 streamed (SSE, with usage) and 4 unary, half greedy and
   half sampled, twice (the first run captures the window graphs). Each
   run: every request finishes with 64 tokens or a stop, no non-finite
   logits, one graph replay per window, every window graph holding
   (7 L + 1) x nw W8A16 launches and L x nw ragged ones, the replays
   adding (7 L + 1) per decode step (the warm-ups and the prefill steps'
   head products come on top), GET /metrics showing llm_ttft_seconds_count
   equal to the choices served and a nonzero llm_itl_seconds_count.
   Prints the TTFT and ITL p50 / p90 from the histograms beside the
   client-side TTFT of the streamed requests, decode tokens/s, peak
   memory and weight_bytes against phase 4's bf16 engine.
10. The entry point: `python -m dynamo_tpu_torch.run in=http:0 out=native
   tiny --quant int8` as a subprocess on the card; its READY line, one
   streamed chat ending in [DONE], then the subprocess is stopped.
11. The distributed path at full width, as processes through the entry
   points: `python -m dynamo_tpu_torch.runtime.transports.server --port 0`
   (READY control-plane=:<port>); two workers started together,
   `python -m dynamo_tpu_torch.run in=endpoint:dynamo.llm.generate
   out=native llama3-8b --control-host 127.0.0.1 --control-port <port>`
   (llama3-8b at full width and depth, the same bf16 weights from seed 0 in
   both, bf16 KV pages, the default EngineConfig; each READY line names
   the card it runs on, which must be this card); two frontends,
   `python -m dynamo_tpu_torch.frontend.serve --port 0 --control-port
   <port>`, one KV-routed and one with --no-kv-routing, each listing
   llama3-8b with two instances. First a warm-up round through the
   KV-routed frontend, the traffic below on 4 other system prompts, so
   that the window graphs are captured before the measured rounds. Traffic
   through the KV-routed frontend:
   4 system prompts of 1024 byte-tokens (16 pages of 64), each followed
   by 4 distinct user turns of 64-192 byte-tokens, 16 chat requests of
   max_tokens 32 (8 greedy, 8 sampled with temperature 0.8, top_k 50 and
   a seed; 8 streamed, 8 unary). Wave 1 sends one request per prefix,
   concurrently; once the router scores every prefix on some worker
   (POST /router/match), wave 2 sends the other 12 concurrently. Checks:
   every request finishes with 32 tokens or a stop; each wave-2 request
   went to the worker that served its prefix in wave 1 with >= 16 matched
   pages (the router's decisions, GET /router/state, keyed by the
   x-request-id each request carries); llm_router_fallbacks is 0; the
   workers' own counters, their $STATS scraped over the control plane
   before and after the traffic, sum to exactly what one engine serving
   the 16 requests in the same order counts (engine/scheduler.py
   `_match_prefix`: a prompt of len tokens looks up min(hits + 1,
   (len - 1) // 64) pages and hits the leading ones already stored). The
   template `<|system|>S</s><|user|>U</s><|assistant|>` puts 1046 tokens
   before a user turn, and the turns differ from their first byte, so a
   wave-1 request hits 0 of 1 page, a wave-2 request 16 of 17: 192 hits
   of 208 lookups over 16 admitted requests (`expected_prefix_hits`
   derives this from the token ids). Every worker ran one graph replay
   per decode window (decode_dispatches == decode_windows) and launched
   the ragged kernel layers x its decode steps + its warm-up launches
   times, more than 0 in all. Then the contrast, printed and not gated:
   the --no-kv-routing frontend over 4 fresh prefixes of the same shapes
   (round-robin), both frontends' prefix hit shares and TTFT p50 / p90
   from llm_ttft_seconds (the bucket counts each round added), labelled
   as two replicas sharing one H100. Then
   one greedy request twice through the router (logprobs on): equal
   bodies apart from id / created. Then SIGTERM to both workers: each
   drains, deregisters (both frontends' instance counts fall to 0),
   prints `EXIT ... logits_nonfinite_steps=0` and exits 0; the frontends
   and the server then exit 0 on SIGINT. Each worker process is its own
   path: its launch counts start at 0 with the process and are read from
   its $STATS.

12. The disaggregated deployment at full width, as processes through the
   SDK's one command: `python -m dynamo_tpu_torch.sdk.serve
   dynamo_tpu_torch.examples.disagg.graph:Frontend -f <config>
   --start-control-plane --control-port 0`, the config being
   dynamo_tpu_torch/examples/disagg/config.json (llama3-8b at full width
   and depth, bf16 weights from seed 0 in both workers, bf16 KV pages, ps
   64, max_model_len 16384; decode max_slots 16, max_local_prefill_length
   1000, max_prefill_queue_size 2; prefill max_slots 8; max_prefill_chunk
   512) with one cut: num_pages 1024 per engine in place of 2048, two
   engines sharing one card. The supervisor starts the control plane, the
   PrefillWorker, the DecodeWorker (each printing the card it runs on,
   which must be this card) and the KV-routed Frontend. Before that, an
   aggregated NativeEngine with the decode worker's config on the same
   seed-0 weights serves round A's prompts one at a time, first plainly
   with each token's top logprobs, then through its own disaggregation
   hooks in one process (a prefill-only run, extract, inject into the
   up-front allocation, activation: the reference tokens), and is freed.
   Traffic: a warm-up of 42 chats one at a time, one for each window
   graph rounds A and B can replay (greedy or sampled x the page buckets
   3-48 of their rows x window rungs 1, 2, 8 by max_tokens 2, 3, 32; see
   WARM_BUCKETS); round A, the 4 greedy long
   chats of 1100-2560 bytes, one at a time through the decode worker's
   endpoint (token ids in every frame); round B, 12 chats at once through
   the frontend: 8 long ones of 1100-2990 bytes with no shared prefix and
   4 short ones of 100-600, max_tokens 32, half greedy and half sampled
   (temperature 0.8, top_k 50, seeded), half SSE and half unary. Checks:
   every request finishes with 32 tokens or a stop; each of round A's
   streams equals the plain aggregated engine's up to its first
   difference, where the two tokens are a near tie in the aggregated
   engine's logprobs (within two bf16 ulps of the top logit, `NEAR_TIE`),
   and equals the reference tokens; every short request is prefilled locally,
   every round-A request remotely, and each round-B long request as
   `prefill_remote(len, prefix hit, queue depth)` decides on the values
   the decode worker recorded (its prompt length equal to the client's
   token count); the prefill worker completed every remote request; the
   pages received equal the remote requests' uncached pages and the pages
   verified, with no mismatch; salvages, full re-prefills, overlap
   fall-backs, prefill timeouts, link timeouts, prefill failures and
   llm_router_fallbacks are all 0; the prefill worker launched the ragged
   kernel 0 times, the decode worker layers x decode steps + warm-up
   launches times, one replay per decode window, no graph reset, and no
   new graph during rounds A and B. Then SIGTERM to the supervisor: the frontend
   stops, each worker drains (EXIT lines with logits_nonfinite_steps=0),
   every service and the supervisor exit 0. Reported: TTFT of round A
   (client), round B's llm_ttft_seconds p50 / p90 and the client TTFT of
   its streamed remote and local requests, early first emits, each
   transfer's pages, MiB, ms and GB/s (send side), enqueue to activation,
   each worker's peak memory, the phase's seconds. The services' whole
   output goes to build/disagg_supervisor.log.

13. The KV tiers at full width (engine/offload.py, engine/kv_pool.py): one
   set of llama3-8b weights from seed 0 shared by every engine, bf16, page
   64, 8 slots, max_model_len 4096. Engines: T (num_pages 160, host_pages
   48 pinned, disk_pages 256 under build/kv_tiers), O (num_pages 512, no
   tier: every turn-2 prefix is an HBM hit) and R (num_pages 160, no tier:
   evicted prefixes are recomputed). Traffic, one request at a time, greedy,
   32 tokens (ignore_eos): 8 conversations with histories of 1536-2048
   random token ids (seeded); turn 1 serves each history, turn 2 each history
   + its 32 generated ids + a 64-token question. T and O first serve a
   warm-up of two requests at the shortest and longest page bucket the
   turns reach. Turn 1 seals ~224 pages against T's 160, so T's earliest
   pages go to host and on to disk, and turn 2 promotes them back and
   onboards them. Checks: T's streams equal O's in both turns; each turn-2
   request's prefix hits in T and in O equal the sealed pages of its turn-1
   stream, (len + 31) // 64, derived from the token ids, and turn 1 hits
   nothing; T offloaded, spilled to disk and promoted from disk, onboarded
   as many pages as its host tier hit, and dropped, failed, mismatched and
   quarantined none; conversation 0's onboarded pages in T's cache are
   byte-equal to O's; no window graph is captured after the warm-up; the
   ragged kernel launches num_layers x decode steps in each engine's turns.
   The same with int8 KV pages on T (num_pages 64, so that 4 conversations
   overflow it and each leaves HBM whole before its turn 2: a turn-2 walk
   whose own later pages are still in HBM evicts them for its onboards and
   stops there, as the JAX scheduler does) and O, 4 conversations: equal streams, int8 values and
   scales byte-equal. The shared pool: P1 and P2 (num_pages 160) attach
   one SharedKvPool; P1 serves 4 histories and publishes them, then serves
   them again from its own HBM; P2 serves the same 4, fetching from the
   pool: its streams equal P1's second run's (the same prefix hits and
   tail), it fetched sum((len - 1) // 64) pages, and the pool quarantined
   and rejected nothing. Tentpole 0 on T (`phase_failed_capture`): a
   window program that raises inside its capture, then one that breaks the
   capture with a host sync, each through `engine.graphs.run`: each raises,
   leaves no graph and no pool taking the stream's allocations; the real
   program under the same key then captures and replays the eager window's
   tokens. Reported: turn-2 (and turn-1) TTFT p50 / p90 of T, O, R (and
   int8 T, O), where R's turn-2 streams first leave O's, pages and MiB
   offloaded and onboarded, D2H and H2D GB/s, an onboard's verify, H2D and
   inject ms, settle ms, disk spill and promote ms a page, pinned host
   bytes, peak memory during each engine's run (earlier engines still
   alive), the phase's seconds.

Each path (each run of 4, 4c, 5 and 9, the A/B at each geometry, each
worker process of 11 and 12, and each engine's turns in 13) runs with every
kernel's launch count set to 0 just before it and read just after. The third line
from the end of the output is one JSON object with the kernel records, the
second from the end the nvidia-smi reading, and the last line
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import asyncio
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time

H100_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def check(cond: bool, msg: str) -> None:
    if not cond:
        print(f"FAIL: {msg}", flush=True)
        sys.exit(1)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def demangle(names) -> dict:
    """{mangled: readable} for kernel entry names, by cu++filt beside the
    toolkit's nvcc (or c++filt); a name stays mangled where neither runs.
    The readable form drops the return type, the anonymous namespace and
    the parameter list: `legacy_cluster_kernel<float, signed char, 128>`."""
    import os
    import shutil
    from dynamo_tpu_torch.ops import build
    names = sorted(names)
    tool = next((t for t in (
        os.path.join(os.path.dirname(build._nvcc()), "cu++filt"),
        shutil.which("c++filt") or "") if t and os.path.exists(t)), None)
    out = {n: n for n in names}
    if tool is None or not names:
        return out
    res = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True, timeout=60)
    lines = res.stdout.splitlines()
    if res.returncode != 0 or len(lines) != len(names):
        return out
    for n, d in zip(names, lines):
        for noise in ("(anonymous namespace)::", "<unnamed>::", "(int)"):
            d = d.replace(noise, "")
        d = d.split("(")[0]
        out[n] = d[5:] if d.startswith("void ") else d
    return out


def ptxas_lines(log: str) -> list:
    """The register and spill lines of an `nvcc -Xptxas=-v` build log, each
    prefixed with the entry function it belongs to (the `Compiling entry
    function` line before it)."""
    import re
    pairs, entry = [], "?"
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
        elif "registers" in line or "spill" in line:
            pairs.append((entry, line.replace("ptxas info    :", "").strip()))
    names = demangle({e for e, _ in pairs})
    return [f"{names[e]}: {text}" for e, text in pairs]


def cuda_ms(fn, n: int, warmup: int = 3, graph: bool = False) -> float:
    """CUDA-event time per call of fn(0) .. fn(n - 1), after `warmup`
    calls. With graph=True the n calls are captured in one CUDA graph and
    the events time its replay: a kernel wrapper's host work (argument
    checks, allocation, the ctypes call; tens of microseconds) then cannot
    pace a kernel that runs about as long, and the time is the device's."""
    import torch
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for i in range(n):
                fn(i)
        g.replay()
        torch.cuda.synchronize()
        start.record()
        g.replay()
        end.record()
    else:
        start.record()
        for i in range(n):
            fn(i)
        end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


# -- phase 2: kernel vs plain ---------------------------------------------------

PS = 64  # the kernel cases' page size, the engine's default


def ragged_cases() -> list:
    """The ragged kernel's phase-2 cases: (label, hd, S, H, Hkv, Pb, lens or
    None for ragged lens 0, 1, ps, ps + 1, the full table, then random).
    First 8 and 32 rows at the llama3-8b head geometry and hd 64 / 128;
    then, at hd 128, the split-KV schedule's edges: lens on and around the
    split boundaries the host picks at the main path's Pb 12, one row (the
    case split-KV exists for) of 1000 tokens and of the full Pb * ps =
    4096, 8 rows up to the engine's max_model_len of 2048 at its Pb bucket
    of 32, GQA groups of 1, 4 and 8, and an all-empty batch."""
    import torch
    from dynamo_tpu_torch.ops import paged_attention as pa
    cases = [(f"S={s}", hd, s, 32, 8, 8, None)
             for hd in (64, 128) for s in (8, 32)]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    b = pa._pages_per_split(8, 8, 12, sms) * PS   # tokens per split
    cases += [
        (f"S=8 split boundaries ({b} tokens a split)", 128, 8, 32, 8, 12,
         [b - 1, b, b + 1, 2 * b, 2 * b + 1, 3 * b - 1, 12 * PS,
          12 * PS - 1]),
        ("S=1 1000 tokens", 128, 1, 32, 8, 64, [1000]),
        ("S=1 4096 tokens", 128, 1, 32, 8, 64, [64 * PS]),
        ("S=8 max_model_len", 128, 8, 32, 8, 32,
         [2048, 1536, 1600, 1700, 1800, 1900, 2000, 2047]),
        ("GQA 1", 128, 4, 8, 8, 8, None),
        ("GQA 4", 128, 4, 32, 8, 8, None),
        ("GQA 8", 128, 4, 64, 8, 8, None),
        ("all empty", 128, 8, 32, 8, 12, [0] * 8),
    ]
    return cases


def kernel_case(hd: int, dtype, s: int, seed: int, h: int = 32,
                hkv: int = 8, pb: int = 8, lens=None, ps: int = PS,
                min_len: int = 0):
    """Random cache + disjoint per-row page tables + ragged lens (or the
    given ones), with every token slot at or past a row's length (at least
    min_len) filled with NaN."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    nl = 2
    p = s * pb + 1
    k = torch.randn((nl, hkv, p, ps, hd), generator=g, device="cuda")
    v = torch.randn((nl, hkv, p, ps, hd), generator=g, device="cuda")
    q = torch.randn((s, h, hd), generator=g, device="cuda")
    pt = torch.randperm(s * pb, generator=g, device="cuda").to(torch.int32)
    pt = pt.reshape(s, pb)
    special = [0, 1, ps, ps + 1, pb * ps]
    rand = torch.randint(0, pb * ps + 1, (s,), generator=g, device="cuda")
    if lens is None:
        lens = [special[i] if i < len(special) else int(rand[i])
                for i in range(s)]
    lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    pos = torch.arange(pb * ps, device="cuda")
    tail = pos[None, :] >= torch.clamp(lens, min=min_len)[:, None]
    slots = (pt.long()[:, pos // ps] * ps + pos % ps)[tail]
    for c in (k, v):
        c.view(nl, hkv, p * ps, hd)[:, :, slots] = float("nan")
    k_new = torch.randn((s, hkv, hd), generator=g, device="cuda")
    v_new = torch.randn((s, hkv, hd), generator=g, device="cuda")
    cast = [t.to(dtype) for t in (q, k, v, k_new, v_new)]
    return (*cast, pt, lens)


def fold_f32(pa, q, k_new, v_new, got, want):
    """The prefix rows' self-term fold (combine_self_attention) of the
    kernel's state and of the plain version's, both in f32: with a bf16 q
    the fold ends in one cast to bf16, shared code, and two f32 values a
    hair apart round a whole bf16 step (2**-8 relative) apart where they
    straddle a rounding midpoint, more than rtol = atol = 2e-3 allows below
    |x| = 0.95. So the states are held to the tolerance before that cast."""
    f32 = [t.float() for t in (q, k_new, v_new)]
    return (pa.combine_self_attention(*f32, *got),
            pa.combine_self_attention(*f32, *want))


def inclusive_f32(pa, q, k, v, pt, lens, ks=None, vs=None):
    """The inclusive view (lens include the current token) of a per-layer
    cache: the kernel's acc / l and the plain version's, in f32 (see
    fold_f32). The public wrapper's output must be exactly the kernel's
    acc / l cast to q's dtype."""
    import torch
    sc = () if ks is None else (ks[None], vs[None])
    lens1 = torch.clamp(lens, min=1)
    acc, _, l = pa.ragged_decode_attention(q, k[None], v[None], 0, pt, lens1,
                                           *sc)
    inc = pa.decode_paged_attention(q, k, v, pt, lens, ks, vs)
    check(torch.allclose(inc, (acc / l).to(q.dtype), rtol=0, atol=0,
                         equal_nan=True),  # padding rows may read NaN
          "decode_paged_attention is not the kernel's acc / l")
    pacc, _, pl_ = pa._ragged_plain(q, k[None], v[None], 0, pt, lens1, *sc)
    return acc / l, pacc / pl_


def phase_kernel() -> float:
    import torch
    from dynamo_tpu_torch.ops import paged_attention as pa
    worst = 0.0
    for ci, (name, hd, s, h, hkv, pb, lens_) in enumerate(ragged_cases()):
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-3)):
            q, k, v, k_new, v_new, pt, lens = kernel_case(
                hd, dtype, s, seed=hd + s + 1000 * ci, h=h, hkv=hkv,
                pb=pb, lens=lens_)
            layer = 1
            ok = lens > 0
            ps = k.shape[3]
            # prefix mode: the kernel's flash state + the self-term
            acc, m, l = pa.decode_paged_attention_prefix(
                q, k, v, layer, pt, lens)
            pacc, pm, pl_ = pa._ragged_plain(q, k, v, layer, pt, lens)
            out, pout = fold_f32(pa, q, k_new, v_new, (acc, m, l),
                                 (pacc, pm, pl_))
            # inclusive mode: lens include the current token
            inc, pinc = inclusive_f32(pa, q, k[layer], v[layer], pt, lens)
            torch.cuda.synchronize()
            # all rows of the flash state (an empty row walks one masked
            # page: m = -1e30, l = ps); inclusive rows with lens >= 1
            label = f"kernel hd={hd} {str(dtype)[6:]} {name}"
            check(bool((m[~ok] == -1e30).all())
                  and bool((l[~ok] == ps).all()),
                  f"{label}: empty rows must keep m = -1e30 and l = {ps}")
            pairs = [("acc", acc, pacc), ("m", m, pm), ("l", l, pl_),
                     ("prefix+self", out, pout)]
            if bool(ok.any()):
                pairs.append(("inclusive", inc[ok], pinc[ok]))
            errs = compare(label, pairs, tol)
            worst = max(worst, max(errs))
            print(f"{label} (H={h}, Hkv={hkv}, Pb={pb}) "
                  f"lens={lens.tolist()[:8]}... max_abs_err "
                  f"acc/m/l/prefix/inclusive = "
                  f"{' '.join(f'{e:.3g}' for e in errs)} (tol {tol})",
                  flush=True)
    return worst


def compare(label: str, pairs, tol: float) -> list:
    """Every (name, got, want) pair finite and within rtol = atol = tol;
    returns the max abs errors."""
    import torch
    errs = []
    for name, a, b in pairs:
        check(bool(torch.isfinite(a).all()), f"{label}: non-finite {name}")
        err = float((a.float() - b.float()).abs().max())
        check(torch.allclose(a.float(), b.float(), rtol=tol, atol=tol),
              f"{label}: {name} differs from its reference by {err}")
        errs.append(err)
    return errs


def quantize_case(k, v, pt, lens, seed: int):
    """int8 pages + f32 scales of float caches k/v [L, Hkv, P, ps, hd] (no
    NaN), then every slot at or past a row's length overwritten with
    garbage int8 values and NaN (k) / inf (v) scales."""
    import torch
    from dynamo_tpu_torch.ops.kv_quant import quantize_rows
    (kq, ks), (vq, vs) = quantize_rows(k), quantize_rows(v)
    nl, hkv, p, ps, hd = k.shape
    pb = pt.shape[1]
    pos = torch.arange(pb * ps, device="cuda")
    tail = pos[None, :] >= lens[:, None]
    slots = (pt.long()[:, pos // ps] * ps + pos % ps)[tail]
    g = torch.Generator(device="cuda").manual_seed(seed)
    for c in (kq, vq):
        flat = c.view(nl, hkv, p * ps, hd)
        flat[:, :, slots] = torch.randint(
            -128, 128, flat[:, :, slots].shape, generator=g, device="cuda",
            dtype=torch.int8)
    ks.view(nl, hkv, p * ps)[:, :, slots] = float("nan")
    vs.view(nl, hkv, p * ps)[:, :, slots] = float("inf")
    return kq, vq, ks, vs


def phase_kernel_int8() -> float:
    """The ragged kernel's int8 mode against its plain version (2b)."""
    import torch
    from dynamo_tpu_torch.ops import paged_attention as pa
    worst = 0.0
    for ci, (name, hd, s, h, hkv, pb, lens_) in enumerate(ragged_cases()):
        for qdt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-3)):
            q, k, v, k_new, v_new, pt, lens = kernel_case(
                hd, torch.float32, s, seed=3 * hd + s + 1000 * ci, h=h,
                hkv=hkv, pb=pb, lens=lens_)
            # kernel_case NaN-poisons the tails; quantize clean values
            k, v = torch.nan_to_num(k), torch.nan_to_num(v)
            kq, vq, ks, vs = quantize_case(k, v, pt, lens, seed=s)
            q, k_new, v_new = (t.to(qdt) for t in (q, k_new, v_new))
            layer, ps, ok = 1, k.shape[3], lens > 0
            acc, m, l = pa.decode_paged_attention_prefix(
                q, kq, vq, layer, pt, lens, ks, vs)
            pacc, pm, pl_ = pa._ragged_plain(q, kq, vq, layer, pt, lens,
                                             ks, vs)
            out, pout = fold_f32(pa, q, k_new, v_new, (acc, m, l),
                                 (pacc, pm, pl_))
            inc, pinc = inclusive_f32(pa, q, kq[layer], vq[layer], pt, lens,
                                      ks[layer], vs[layer])
            torch.cuda.synchronize()
            label = f"int8 kernel hd={hd} q {str(qdt)[6:]} {name}"
            check(bool((m[~ok] == -1e30).all())
                  and bool((l[~ok] == ps).all()),
                  f"{label}: empty rows must keep m = -1e30 and l = {ps}")
            pairs = [("acc", acc, pacc), ("m", m, pm), ("l", l, pl_),
                     ("prefix+self", out, pout)]
            if bool(ok.any()):
                pairs.append(("inclusive", inc[ok], pinc[ok]))
            errs = compare(label, pairs, tol)
            worst = max(worst, max(errs))
            print(f"{label} (H={h}, Hkv={hkv}, Pb={pb}) "
                  f"lens={lens.tolist()[:8]}... max_abs_err "
                  f"acc/m/l/prefix/inclusive = "
                  f"{' '.join(f'{e:.3g}' for e in errs)} (tol {tol})",
                  flush=True)
    return worst


def legacy_case(hd: int, kind: str, seed: int):
    """The parity geometry of tests/test_ragged_kernel.py:41-59 at 32 q / 8
    kv heads: 3 rows of 4 distinct pages (ps 8), lens 5 / 17 / 32, NaN in
    every tail slot (NaN / inf scales for int8)."""
    import torch
    from dynamo_tpu_torch.ops.kv_quant import quantize_rows
    g = torch.Generator(device="cuda").manual_seed(seed)
    s, h, hkv, p, ps, pb = 3, 32, 8, 16, 8, 4
    q = torch.randn((s, h, hd), generator=g, device="cuda")
    k = torch.randn((hkv, p, ps, hd), generator=g, device="cuda")
    v = torch.randn((hkv, p, ps, hd), generator=g, device="cuda")
    pt = ((torch.arange(s * pb, device="cuda").reshape(s, pb) * 7) % p).to(
        torch.int32)
    lens = torch.tensor([5, 17, 32], dtype=torch.int32, device="cuda")
    pos = torch.arange(pb * ps, device="cuda")
    tail = pos[None, :] >= lens[:, None]
    slots = (pt.long()[:, pos // ps] * ps + pos % ps)[tail]
    ks = vs = None
    if kind == "int8":
        (k, ks), (v, vs) = quantize_rows(k), quantize_rows(v)
        ks.view(hkv, p * ps)[:, slots] = float("nan")
        vs.view(hkv, p * ps)[:, slots] = float("inf")
    else:
        for c in (k, v):
            c.view(hkv, p * ps, hd)[:, slots] = float("nan")
        if kind == "bf16":
            q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    return q, k, v, ks, vs, pt, lens


def legacy_cases() -> list:
    """The legacy kernel's cluster-schedule cases: (label, hd, S, H, Hkv,
    ps, Pb, lens or None for kernel_case's ragged lens). Block r of a row's
    cluster of C = min(Pb, 8) blocks walks pages r, r + C, ...: one row of
    the full 2048 tokens (Pb 32, 4 pages a block), 8 rows up to
    max_model_len, lens on and around the block-assignment boundaries at
    the main path's Pb 12 (one page: rank 0 alone; C pages: every block one
    page; C + 1: rank 0 a second page), an all-clamped batch (lens 0 -> 1),
    GQA groups of 1, 4 and 8, and page sizes 8, 64 and 128 (128: two f32
    half-page stages a page at hd 128)."""
    b = 8 * PS  # tokens of one page for each block of a Pb-12 cluster
    return [
        ("S=1 2048 tokens", 128, 1, 32, 8, PS, 32, [2048]),
        ("S=8 max_model_len", 128, 8, 32, 8, PS, 32,
         [2048, 1536, 1600, 1700, 1800, 1900, 2000, 2047]),
        ("block boundaries", 128, 8, 32, 8, PS, 12,
         [PS - 1, PS, PS + 1, b - 1, b, b + 1, b + PS, 12 * PS]),
        ("all clamped", 128, 8, 32, 8, PS, 12, [0] * 8),
        ("GQA 1", 128, 4, 8, 8, PS, 8, None),
        ("GQA 4", 128, 4, 32, 8, PS, 8, None),
        ("GQA 8", 128, 4, 64, 8, PS, 8, None),
        ("ps 8", 64, 8, 32, 8, 8, 32, None),
        ("ps 128", 128, 8, 32, 8, 128, 16, None),
    ]


def legacy_check(label, q, k, v, pt, lens, ks, vs, tol) -> list:
    """The legacy kernel's output against its plain version and against
    the ragged kernel's inclusive view; returns the two max abs errors."""
    import torch
    from dynamo_tpu_torch.ops import paged_attention as pa
    from dynamo_tpu_torch.ops import paged_attention_oracle as leg
    got = leg.decode_paged_attention_legacy(q, k, v, pt, lens, ks, vs)
    want = leg._legacy_plain(q, k, v, pt, torch.clamp(lens, min=1), ks, vs)
    ragged = pa.decode_paged_attention(q, k, v, pt, lens, ks, vs)
    torch.cuda.synchronize()
    check(got.dtype == q.dtype and got.shape == q.shape,
          f"{label}: output {got.dtype} {tuple(got.shape)}")
    return compare(label, [("plain", got, want),
                           ("ragged inclusive", got, ragged)], tol)


LEGACY_KINDS = (("f32", 1e-4), ("bf16", 1e-2), ("int8", 1e-4),
                ("int8 q bf16", 1e-2))


def phase_legacy() -> float:
    """The legacy kernel against its plain version and against the ragged
    kernel's inclusive view (2c): the parity geometry, then the cluster
    schedule's cases, each with f32, bf16 and int8 caches (int8 with an f32
    and a bf16 q)."""
    import torch
    worst = 0.0
    for hd in (32, 64, 128):
        for kind, tol in (("f32", 1e-4), ("bf16", 1e-2), ("int8", 1e-4)):
            q, k, v, ks, vs, pt, lens = legacy_case(hd, kind, seed=hd)
            label = f"legacy kernel hd={hd} {kind}"
            errs = legacy_check(label, q, k, v, pt, lens, ks, vs, tol)
            worst = max(worst, errs[0])
            print(f"{label} lens={lens.tolist()}: max_abs_err vs plain "
                  f"{errs[0]:.3g}, vs the ragged kernel {errs[1]:.3g} "
                  f"(tol {tol})", flush=True)
    for ci, (name, hd, s, h, hkv, ps, pb, lens_) in enumerate(
            legacy_cases()):
        for kind, tol in LEGACY_KINDS:
            dtype = torch.bfloat16 if kind == "bf16" else torch.float32
            # a row of length 0 reads its token 0: tails from the clamp
            q, k, v, _, _, pt, lens = kernel_case(
                hd, dtype, s, seed=7 * hd + s + 1000 * ci, h=h, hkv=hkv,
                pb=pb, lens=lens_, ps=ps, min_len=1)
            ks = vs = None
            if kind.startswith("int8"):
                k, v = torch.nan_to_num(k), torch.nan_to_num(v)
                k, v, ks, vs = quantize_case(k, v, pt,
                                             torch.clamp(lens, min=1), seed=s)
                ks, vs = ks[1], vs[1]
                if kind.endswith("bf16"):
                    q = q.to(torch.bfloat16)
            label = f"legacy kernel hd={hd} {kind} {name}"
            errs = legacy_check(label, q, k[1], v[1], pt, lens, ks, vs, tol)
            worst = max(worst, errs[0])
            print(f"{label} (H={h}, Hkv={hkv}, ps={ps}, Pb={pb}) "
                  f"lens={lens.tolist()[:8]}: max_abs_err vs plain "
                  f"{errs[0]:.3g}, vs the ragged kernel {errs[1]:.3g} "
                  f"(tol {tol})", flush=True)
    return worst


# -- phase 2d: the W8A16 kernel ---------------------------------------------------

def projection_shapes(cfg) -> dict:
    """{name: (K, N)} of a model's seven projections and its head."""
    d, hd = cfg.hidden_size, cfg.head_dim
    h, hkv, f = cfg.num_heads, cfg.num_kv_heads, cfg.intermediate_size
    return {"wq": (d, h * hd), "wk": (d, hkv * hd), "wv": (d, hkv * hd),
            "wo": (h * hd, d), "w_gate": (d, f), "w_up": (d, f),
            "w_down": (f, d), "lm_head": (d, cfg.vocab_size)}


def quant_weight(k: int, n: int, seed: int) -> dict:
    """A random [K, N] weight, N(0, 1/K) as init_params draws it, quantized
    on the card (ops/quant.quantize_int8)."""
    import torch
    from dynamo_tpu_torch.ops.quant import quantize_int8
    g = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randn((k, n), generator=g, device="cuda") * k ** -0.5
    qw = quantize_int8(w)
    qw["s"] = qw["s"].reshape(-1)
    return qw


def w8a16_check(label: str, x, w, got) -> float:
    """The kernel's output `got` against the plain version on the same
    inputs, computed in f32 from the weights rounded to x's dtype (`wmat`):
    f32 x within rtol = atol = 1e-4; bf16 x (both sides' single rounding
    to bf16 at the end) max |diff| <= 1e-2 * max |y|. Returns max |diff|."""
    import torch
    from dynamo_tpu_torch.ops.quant import wmat
    want = x.float() @ wmat(w, x.dtype).float()
    check(got.dtype == x.dtype and got.shape == want.shape,
          f"{label}: output {got.dtype} {tuple(got.shape)}")
    check(bool(torch.isfinite(got).all()), f"{label}: non-finite output")
    err = float((got.float() - want).abs().max())
    if x.dtype == torch.float32:
        ok = torch.allclose(got, want, rtol=1e-4, atol=1e-4)
        tol = "rtol = atol = 1e-4"
    else:
        ok = err <= 1e-2 * float(want.abs().max())
        tol = f"1e-2 x max|y| = {1e-2 * float(want.abs().max()):.3g}"
    check(ok, f"{label}: differs from the plain version by {err} ({tol})")
    return err


def phase_w8a16() -> tuple:
    """2d: the W8A16 kernel against its plain version, then its times.
    Returns (max abs error, the timing record, the dequantize record)."""
    import torch
    from dynamo_tpu_torch.engine.config import get_model_config
    from dynamo_tpu_torch.ops import quant
    cfg = get_model_config("llama3-8b")
    shapes = projection_shapes(cfg)
    worst = 0.0
    for si, (name, (k, n)) in enumerate(shapes.items()):
        w = quant_weight(k, n, seed=si)
        g = torch.Generator(device="cuda").manual_seed(100 + si)
        for m, dt in ((1, torch.bfloat16), (3, torch.bfloat16),
                      (8, torch.bfloat16), (16, torch.bfloat16),
                      (1, torch.float32), (8, torch.float32)):
            x = torch.randn((m, k), generator=g, device="cuda").to(dt)
            got = quant.w8a16_gemm(x, w["q"], w["s"])
            torch.cuda.synchronize()
            err = w8a16_check(f"w8a16 {name} M={m} {str(dt)[6:]}", x, w, got)
            worst = max(worst, err)
        splits, per = quant.gemm_config(
            8, k, n, torch.cuda.get_device_properties(0).multi_processor_count)
        print(f"w8a16 kernel {name} (K={k}, N={n}; at M 8 bf16 {splits} "
              f"splits of {per * quant._MMA_CHUNK_K} rows): M = 1/3/8/16 "
              f"bf16 and 1/8 f32 within tolerance, max_abs_err so far "
              f"{worst:.3g}", flush=True)
        del w
    for k, n in ((1000, 333), (4100, 1031)):
        w = quant_weight(k, n, seed=k)
        g = torch.Generator(device="cuda").manual_seed(n)
        for m in (1, 3, 8, 16):
            for dt in (torch.float32, torch.bfloat16):
                x = torch.randn((m, k), generator=g, device="cuda").to(dt)
                got = quant.w8a16_gemm(x, w["q"], w["s"])
                torch.cuda.synchronize()
                worst = max(worst, w8a16_check(
                    f"w8a16 K={k} N={n} M={m} {str(dt)[6:]}", x, w, got))
        print(f"w8a16 kernel at K={k}, N={n} (odd N, a partial chunk of K): "
              f"M = 1/3/8/16 f32 and bf16 within tolerance", flush=True)
    # M = 512: the route linear takes (dequantize + matmul), bit-identical
    # dequantize, and the kernel itself
    k, n = shapes["w_gate"]
    w = quant_weight(k, n, seed=77)
    x = torch.randn((512, k), device="cuda").to(torch.bfloat16)
    deq = quant.dequantize(w, torch.bfloat16)
    check(torch.equal(deq, quant.wmat(w, torch.bfloat16)),
          "w8a16 dequantize is not bit-identical to wmat")
    via_linear = quant.linear(x, w)
    check(torch.equal(via_linear, x @ quant.wmat(w, torch.bfloat16)),
          "linear at M = 512 is not the dequantize + matmul route")
    worst = max(worst, w8a16_check("w8a16 w_gate M=512 bf16 (kernel)", x, w,
                                   quant.w8a16_gemm(x, w["q"], w["s"])))
    print("w8a16 at M = 512 (w_gate): the dequantize entry is bit-identical "
          "to wmat, linear's route equals wmat + torch.matmul exactly, and "
          "the kernel is within tolerance", flush=True)
    timing, dequant_rec = w8a16_timing(cfg, shapes)
    return worst, timing, dequant_rec


def w8a16_timing(cfg, shapes) -> tuple:
    """CUDA-event times over replayed graphs at M = 8 for each projection
    shape, with the weights cycled over copies that together exceed the
    50 MB L2 (a decode step reads each weight once): the kernel, its bound,
    the plain version (`x @ wmat(w)`), and torch.matmul against the bf16
    weight of the same shape. Then both routes at M = 16 and 512 (w_gate)
    and the dequantize entry alone. Returns the kernel's record (one decode
    step's W8A16 work: 7 projections x L + the head) and the dequantize
    entry's."""
    import torch
    from dynamo_tpu_torch.ops import quant
    bf16 = torch.bfloat16
    per_shape = {}
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    for si, (name, (k, n)) in enumerate(shapes.items()):
        copies = max(1, -(-(128 << 20) // (k * n)))
        ws = [quant_weight(k, n, seed=si) for _ in range(copies)]
        lib_copies = max(1, -(-(128 << 20) // (2 * k * n)))
        wb = [quant.wmat(ws[0], bf16) for _ in range(lib_copies)]
        x = torch.randn((8, k), device="cuda").to(bf16)
        kernel_ms = cuda_ms(lambda i: quant.w8a16_gemm(
            x, ws[i % copies]["q"], ws[i % copies]["s"]), 40, graph=True)
        plain_ms = cuda_ms(lambda i: x @ quant.wmat(ws[i % copies], bf16), 10)
        lib_ms = cuda_ms(lambda i: x @ wb[i % lib_copies], 40, graph=True)
        nbytes = k * n + 4 * n + 2 * 8 * k + 2 * 8 * n
        b = bound(nbytes, 2 * 8 * k * n, "bfloat16")
        per_shape[name] = {"K": k, "N": n, "ms": kernel_ms,
                           "plain_ms": plain_ms, "library_ms": lib_ms,
                           **b, "share_of_bound": b["bound_ms"] / kernel_ms}
        reps = 1 if name == "lm_head" else cfg.num_layers
        for key, v in (("ms", kernel_ms), ("plain_ms", plain_ms),
                       ("library_ms", lib_ms), ("bound_ms", b["bound_ms"])):
            tot[key] += reps * v
        print(f"timing w8a16 kernel {name} (M=8, K={k}, N={n}, bf16 x, "
              f"{copies} weight copies): kernel {kernel_ms:.4f} ms (graph "
              f"replay), bound {b['bound_ms']:.4f} ms ({nbytes} bytes), "
              f"{b['bound_ms'] / kernel_ms:.1%} of the bound; plain "
              f"(wmat + matmul) {plain_ms:.4f} ms; torch.matmul on the bf16 "
              f"weight {lib_ms:.4f} ms", flush=True)
        del ws, wb
        torch.cuda.empty_cache()
    # the large-M routes at w_gate's shape
    k, n = shapes["w_gate"]
    w = quant_weight(k, n, seed=5)
    routes = {}
    for m in (16, 512):
        x = torch.randn((m, k), device="cuda").to(bf16)
        routes[f"M={m}"] = {
            "kernel_ms": cuda_ms(lambda i: quant.w8a16_gemm(
                x, w["q"], w["s"]), 10, graph=True),
            "dequant_matmul_ms": cuda_ms(
                lambda i: x @ quant.dequantize(w, bf16), 10, graph=True)}
    deq_ms = cuda_ms(lambda i: quant.dequantize(w, bf16), 20, graph=True)
    deq_plain = cuda_ms(lambda i: quant.wmat(w, bf16), 10)
    deq_b = bound(k * n + 4 * n + 2 * k * n, k * n, "bfloat16")
    print(f"w8a16 routes at w_gate (K={k}, N={n}), chosen at M <= "
          f"{quant.GEMV_MAX_M}: {json.dumps(routes)}; the dequantize entry "
          f"alone {deq_ms:.4f} ms (plain wmat {deq_plain:.4f} ms, bound "
          f"{deq_b['bound_ms']:.4f} ms)", flush=True)
    print(f"w8a16 per decode step (7 x {cfg.num_layers} projections + the "
          f"head, M = 8): kernel {tot['ms']:.3f} ms, bound "
          f"{tot['bound_ms']:.3f} ms ({tot['bound_ms'] / tot['ms']:.1%}), "
          f"plain {tot['plain_ms']:.3f} ms, torch.matmul on bf16 weights "
          f"{tot['library_ms']:.3f} ms", flush=True)
    timing = {**tot, "bound_by": "bytes", "per_shape": per_shape,
              "large_m_routes": routes}
    dequant = {"ms": deq_ms, "plain_ms": deq_plain, "library_ms": None,
               "shape": [k, n], **deq_b}
    return timing, dequant


# -- phase 3: tiny f32 card vs CPU --------------------------------------------

def tree_to(tree, dev):
    """A parameter tree (with quantized {"q", "s"} leaves) on `dev`."""
    if isinstance(tree, dict):
        return {k: tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def phase_small_reference(kv_quant: str = "", quant: str = "") -> None:
    import torch
    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.engine import NativeEngine
    from dynamo_tpu_torch.engine.scheduler import SamplingParams
    from dynamo_tpu_torch.models import llama
    cfg = ModelConfig(dtype="float32", max_model_len=512, quant=quant)
    params = llama.init_params(cfg, "cpu", seed=0)
    ecfg = EngineConfig(page_size=8, num_pages=64, max_slots=4,
                        max_prefill_chunk=32, prefill_buckets=(8, 16, 32),
                        max_model_len=512, kv_quant=kv_quant)
    engines = {dev: NativeEngine(cfg, ecfg, device=dev,
                                 params=tree_to(params, dev))
               for dev in ("cpu", "cuda")}
    prompt = list(range(5, 45))
    sp = SamplingParams(max_tokens=12, temperature=0.0)
    outs = {dev: e.generate(prompt, sp, "r") for dev, e in engines.items()}
    label = (f"tiny f32{' kv_quant=' + kv_quant if kv_quant else ''}"
             f"{' quant=' + quant if quant else ''}")
    check(outs["cpu"] == outs["cuda"],
          f"{label} greedy tokens differ: cpu {outs['cpu']} cuda "
          f"{outs['cuda']}")
    # one decode step over the CPU engine's cache (the greedy run's prompt
    # sits in pages 0..6), on both devices from identical inputs
    logits = {}
    for dev, e in engines.items():
        cache = {k: t.to(dev) for k, t in engines["cpu"].cache.items()}
        tok = torch.tensor([prompt[-1], 7], device=dev)
        pt = torch.tensor([[0, 1, 2, 3, 4, 5], [0] * 6], dtype=torch.int32,
                          device=dev)
        pre = torch.tensor([37, 0], dtype=torch.int32, device=dev)
        pos = torch.tensor([37, 0], dtype=torch.int32, device=dev)
        logits[dev] = llama.decode_forward(e.params, e.model_cfg, tok, cache,
                                           pt, pre, pos)[0].cpu()
    err = float((logits["cpu"] - logits["cuda"]).abs().max())
    check(bool(torch.isfinite(logits["cuda"]).all()) and err < 1e-3,
          f"{label} decode logits cuda vs cpu differ by {err}")
    print(f"small reference: {label} greedy tokens identical on cuda and "
          f"cpu ({outs['cuda']}); decode logits max_abs_err {err:.3g}",
          flush=True)


# -- phase 4: main path ---------------------------------------------------------

class TimedEngine:
    """Forwards a worker's frames and stamps each request's first and last
    token frames (time.perf_counter)."""

    def __init__(self, inner):
        self.inner = inner
        self.stamps = {}

    async def generate(self, request, context):
        rec = self.stamps[request.request_id] = {
            "start": time.perf_counter(), "first": None, "last": None,
            "tokens": 0, "ids": []}
        async for frame in self.inner.generate(request, context):
            if frame.token_ids:
                now = time.perf_counter()
                rec["first"] = rec["first"] or now
                rec["last"] = now
                rec["tokens"] += len(frame.token_ids)
                rec["ids"] += list(frame.token_ids)
            yield frame


MAX_TOKENS = 64


def prompt_text(n_chars: int, seed: int) -> str:
    import numpy as np
    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz     "))
    return "".join(rng.choice(letters, n_chars))


def chat_requests(model: str, sampled: bool = True) -> list:
    """The main path's 8 chat requests: 100-600 byte-token prompts after
    the chat template, MAX_TOKENS each; even ones greedy, odd ones sampled
    (temperature 0.8, top_k 50, a seed each), or all greedy."""
    from dynamo_tpu_torch.protocols.openai import ChatCompletionRequest
    reqs = []
    for i, n in enumerate((80, 150, 220, 290, 360, 430, 500, 575)):
        kw = {}
        if sampled and i % 2:
            kw = dict(temperature=0.8, seed=1234 + i, ext={"top_k": 50})
        reqs.append(ChatCompletionRequest(
            model=model, max_tokens=MAX_TOKENS,
            messages=[{"role": "user", "content": prompt_text(n, i)}], **kw))
    return reqs


def reset_launch_counts() -> None:
    """Every kernel wrapper's launch count to 0 (just before a path)."""
    from dynamo_tpu_torch.ops import paged_attention as pa
    from dynamo_tpu_torch.ops import paged_attention_oracle as leg
    from dynamo_tpu_torch.ops import quant
    pa.KERNEL_LAUNCHES = 0
    leg.KERNEL_LAUNCHES = 0
    quant.KERNEL_LAUNCHES = 0
    quant.DEQUANT_LAUNCHES = 0


RAGGED, W8A16 = "ragged_decode_attention", "w8a16_gemm"

COUNTERS = ("decode_windows", "decode_window_steps", "decode_dispatches",
            "decode_host_syncs", "decode_plan_uploads", "pipeline_windows",
            "pipeline_overlapped", "pipeline_fallbacks", "mixed_steps")


async def serve_run(engine, pipe, timed, requests, tag: str, name: str,
                    smi: str) -> dict:
    """One run of the requests through the pipeline, as its own path: the
    launch counts are set to 0 just before it and read just after. Checks
    every request, the kernel launches (num_layers x decode steps, the
    graph replays' launches plus those of the warm-ups before captures),
    one graph replay per decode window and, at depth 2, the pipeline's
    overlap and reused plans. Returns the run's record and token ids."""
    import torch
    from dynamo_tpu_torch.ops import paged_attention as pa
    from dynamo_tpu_torch.protocols.delta import aggregate_chat_chunks
    from dynamo_tpu_torch.runtime.engine import Context
    cfg, gr = engine.model_cfg, engine.graphs

    async def one(i: int, req):
        chunks = [c async for c in pipe.generate_chat(
            req, Context(f"{tag}-{i}"))]
        return aggregate_chat_chunks(chunks)

    engine.phases.reset()
    torch.cuda.reset_peak_memory_stats()
    before = {k: getattr(engine, k) for k in COUNTERS}
    g0 = (gr.captured, gr.warmup_seconds + gr.capture_seconds, gr.replays,
          gr.warmup_launches[RAGGED], gr.warmup_seconds)
    reset_launch_counts()
    t_run = time.perf_counter()
    results = await asyncio.gather(*(one(i, r)
                                     for i, r in enumerate(requests)))
    wall = time.perf_counter() - t_run
    launches = pa.KERNEL_LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    d = {k: getattr(engine, k) - v for k, v in before.items()}
    captured, cap_s, replays, warm, warm_s = (
        gr.captured - g0[0], gr.warmup_seconds + gr.capture_seconds - g0[1],
        gr.replays - g0[2], gr.warmup_launches[RAGGED] - g0[3],
        gr.warmup_seconds - g0[4])
    n_prompt = []
    for i, agg in enumerate(results):
        ch = agg.choices[0]
        n = agg.usage.completion_tokens
        n_prompt.append(agg.usage.prompt_tokens)
        check(ch.finish_reason == "stop" or (ch.finish_reason == "length"
                                             and n == MAX_TOKENS),
              f"{name}: request {i} finished {ch.finish_reason!r} with {n} "
              "tokens")
        check(timed.stamps[f"{tag}-{i}"]["tokens"] == n,
              f"{name}: request {i}: usage says {n} tokens, frames carried "
              f"{timed.stamps[f'{tag}-{i}']['tokens']}")
    check(min(n_prompt) >= 100 and max(n_prompt) <= 600,
          f"prompt lengths {n_prompt} outside 100-600")
    check(engine.logits_nonfinite_steps() == 0,
          f"{name}: non-finite logits sampled")
    decode_tokens = sum(r.usage.completion_tokens for r in results) \
        - len(results)
    steps = d["decode_window_steps"]
    need = cfg.num_layers * decode_tokens / engine.cfg.decode_steps
    check(launches == cfg.num_layers * steps + warm and launches >= need,
          f"{name}: kernel launches {launches}: expected num_layers x "
          f"decode steps = {cfg.num_layers} x {steps} plus {warm} of the "
          f"warm-ups, and at least {need:.0f}")
    check(d["decode_dispatches"] == d["decode_windows"] == replays > 0,
          f"{name}: {d['decode_windows']} decode windows, "
          f"{d['decode_dispatches']} dispatches, {replays} graph replays")
    if engine.cfg.pipeline_depth > 1:
        check(d["pipeline_overlapped"] > 0
              and d["decode_plan_uploads"] < d["decode_windows"],
              f"{name}: pipeline counters {d}")
    st = [timed.stamps[f"{tag}-{i}"] for i in range(len(results))]
    ttft = [x["first"] - x["start"] for x in st]
    per_req = [(x["tokens"] - 1) / (x["last"] - x["first"]) for x in st]
    agg_rate = decode_tokens / (max(x["last"] for x in st)
                                - min(x["first"] for x in st))
    m = engine.metrics()
    pool = gr.pool_bytes()
    print(f"{name} ({tag} run, pipeline_depth "
          f"{engine.cfg.pipeline_depth}): 8 chat requests, prompts "
          f"{n_prompt} tokens, completion tokens "
          f"{[r.usage.completion_tokens for r in results]}, finish "
          f"{[r.choices[0].finish_reason for r in results]}; wall "
          f"{wall:.3f} s; counters {json.dumps(d)}; graph replays "
          f"{replays}; kernel launches {launches} (warm-ups {warm})",
          flush=True)
    print(f"{name} ({tag} run) [{smi}]: TTFT mean "
          f"{sum(ttft) / len(ttft) * 1e3:.1f} ms, max {max(ttft) * 1e3:.1f}"
          f" ms; decode {agg_rate:.1f} tok/s aggregate, "
          f"{sum(per_req) / len(per_req):.1f} tok/s per request; peak memory"
          f" {peak / 2**30:.2f} GiB; kv_page_bytes {m.kv_page_bytes} "
          f"(kv_quant_bits {m.kv_quant_bits}); graphs captured {captured} "
          f"in {cap_s:.3f} s ({warm_s:.3f} s of it eager warm-ups), "
          f"{gr.captured} held, pool {pool} bytes",
          flush=True)
    print(f"{name} ({tag} run) host phases: "
          f"{json.dumps(engine.phases.split())}", flush=True)
    return {"ids": [x["ids"] for x in st], "launches": launches,
            "n_prompt": n_prompt, "captured": captured, "stats": {
                "wall_s": wall, "ttft_mean_ms": sum(ttft) / len(ttft) * 1e3,
                "ttft_max_ms": max(ttft) * 1e3, "decode_tok_s": agg_rate,
                "per_request_tok_s": sum(per_req) / len(per_req),
                "peak_gib": peak / 2**30, "kv_page_bytes": m.kv_page_bytes,
                "graphs_captured": captured, "capture_s": cap_s,
                "warmup_s": warm_s,
                "pool_bytes": pool}}


async def serve_main_path(smi: str, kv_quant: str = "", params=None,
                          depth: int = 2, quant: str = ""):
    """Phase 4 (kv_quant "") or 5 (kv_quant "int8"), on the given weights
    or on random ones from seed 0 (int8 weights with quant "int8"): the 8
    requests served twice, the first run capturing the window graphs and
    the second on the warm engine, then one greedy request served twice.
    Returns (engine, capturing run, warm run)."""
    import torch
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import NativeEngine
    from dynamo_tpu_torch.llm.pipeline import LocalPipeline
    from dynamo_tpu_torch.llm.worker import NativeEngineWorker
    from dynamo_tpu_torch.run import build_card
    from dynamo_tpu_torch.runtime.engine import Context

    card = build_card("llama3-8b")
    cfg = dataclasses.replace(card.model_config(), quant=quant)
    t0 = time.perf_counter()
    engine = NativeEngine(cfg, EngineConfig(kv_quant=kv_quant,
                                            pipeline_depth=depth),
                          eos_token_ids=set(card.eos_token_ids), seed=0,
                          params=params, device="cuda")
    torch.cuda.synchronize()
    name = "int8 serving" if kv_quant else "main path"
    if quant:
        name += f" with {quant} weights"
    if depth != 2:
        name += f" at depth {depth}"
    print(f"{name}: {cfg.name} {quant or cfg.dtype} weights + "
          f"{engine.cache['k'].dtype} KV cache ready in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    worker = await NativeEngineWorker(engine).start()
    timed = TimedEngine(worker)
    pipe = LocalPipeline(card, timed)
    requests = chat_requests(card.name)
    first = await serve_run(engine, pipe, timed, requests, "req", name, smi)
    # the ladder (8, 2, 1) x {greedy, fused} at the run's one Pb
    check(first["captured"] <= 6,
          f"{name}: {first['captured']} graphs captured in one run")
    warm = await serve_run(engine, pipe, timed, requests, "warm", name, smi)

    # determinism: one greedy request served twice on the idle engine
    req = requests[0]
    runs = []
    for r in range(2):
        pre, _ = pipe.preprocessor.preprocess_chat(req, f"det-{r}")
        frames = [f async for f in worker.generate(pre, Context(pre.request_id))]
        runs.append([t for f in frames for t in f.token_ids])
    check(runs[0] == runs[1] and len(runs[0]) == MAX_TOKENS,
          f"{name}: greedy request not deterministic: {runs[0][:8]}... vs "
          f"{runs[1][:8]}...")
    print(f"{name}: greedy request served twice, same {len(runs[0])} "
          "tokens", flush=True)
    await worker.stop()
    return engine, first, warm


# -- phase 4b: one window as a graph replay and as the eager function ---------

def cache_diff(a: dict, b: dict) -> float:
    """Largest |a - b| over two caches' values and scales, layer by layer
    (a whole f32 copy of a bf16 cache would not fit beside it), on every
    page but the last: the scratch page that absorbs dropped writes (a
    capture's warm-up writes its rows there) and that no page table
    lists."""
    worst = 0.0
    for key in a:
        for layer in range(a[key].shape[0]):
            worst = max(worst, float((a[key][layer][:, :-1].float()
                                      - b[key][layer][:, :-1].float()
                                      ).abs().max()))
    return worst


def phase_graph_vs_eager(engine, label: str) -> dict:
    """For each window variant of the main path (greedy: the 8 requests all
    greedy; fused: the main path's mix, every top_p 1): admit the 8
    requests, step the engine until every one decodes, then run the next
    decode window twice from the same state: as the engine's graph replay
    (captured first if new) and as an eager `_engine_decode_window` on a
    clone of the cache and of the staged inputs. The tokens must be
    identical; prints the largest difference in the cache. For the fused
    variant, the next window's replay is traced with torch.profiler (the
    ragged split kernel must appear num_layers x nw times) and the steps
    after it are timed untraced: ms per decode step and the device-busy
    share. The requests are aborted at the end."""
    import torch
    from dynamo_tpu_torch.engine.scheduler import DecodePlan
    from dynamo_tpu_torch.engine.window_graph import HostCopies
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.llm.worker import to_engine_request
    from dynamo_tpu_torch.run import build_card
    card = build_card("llama3-8b")
    pre = OpenAIPreprocessor(card)
    out = {}
    for variant in ("greedy", "fused"):
        rids = []
        for i, req in enumerate(chat_requests(card.name,
                                              variant == "fused")):
            er = to_engine_request(pre.preprocess_chat(
                req, f"{label}-{variant}-{i}")[0])
            engine.add_request(er)
            rids.append(er.request_id)
        while engine.scheduler.waiting or engine._pipeline is not None:
            engine.step()
        with engine._on_stream():
            plan = engine.scheduler.schedule()
            check(isinstance(plan, DecodePlan)
                  and all(q is not None for q in plan.seqs),
                  f"{label} {variant}: the next step is not a full decode "
                  "window")
            samp = engine._sampling_arrays(plan.seqs)
            greedy = engine._samp_cache.all_greedy
            fused = not greedy and engine._samp_cache.fused_eligible
            check((greedy, fused) == (variant == "greedy",
                                      variant == "fused"),
                  f"{label} {variant}: plan greedy={greedy} fused={fused}")
            staged = engine._stage_window(plan, samp, None, False, greedy,
                                          fused)
            engine._sync_stream()
            bufs = {k: v.clone() for k, v in staged["bufs"].items()}
            cache0 = {k: v.clone() for k, v in engine.cache.items()}
            outs = engine._dispatch_staged(staged)
            engine._dec_state = staged["sig"]
            toks_g = HostCopies.wait(engine._copy_outs_async(outs))[0]
            toks_e = eager_window(engine, staged, bufs, cache0)
            torch.cuda.synchronize()
            diff = cache_diff(engine.cache, cache0)
            del cache0
            torch.cuda.empty_cache()
            check((toks_g == toks_e).all(),
                  f"{label} {variant}: graph tokens {toks_g.T.tolist()} != "
                  f"eager {toks_e.T.tolist()}")
            rec = {"nw": staged["nw"], "cache_max_abs_diff": diff}
            print(f"graph vs eager, {label} {variant} window (S "
                  f"{len(plan.seqs)}, Pb {plan.page_table.shape[1]}, nw "
                  f"{staged['nw']}): tokens identical "
                  f"({toks_g.size}); largest cache difference {diff:.6g}",
                  flush=True)
            engine._commit_window(plan, toks_g)
            if variant == "fused":
                rec.update(trace_window(engine, staged["key"]))
        for rid in rids:
            engine.abort(rid)
        while engine.has_work():
            engine.step()
        engine._sync_stream()
        out[variant] = rec
    return out


def eager_window(engine, staged, bufs, cache):
    """The staged window as an eager `_engine_decode_window` on `bufs` and
    `cache` (copies of the staged inputs and of the cache): its tokens."""
    from dynamo_tpu_torch.engine.engine import _engine_decode_window
    rp, with_lp, greedy, fused, nw = staged["key"][:5]
    return _engine_decode_window(
        engine.model_cfg, engine._eos_vec, engine.params, cache,
        bufs["tokens"], bufs["positions"], bufs["counters"],
        bufs["page_table"], bufs["max_pos"], bufs["temperature"],
        bufs["top_k"], bufs["top_p"], bufs["seeds"], bufs["min_tokens"],
        bufs["ignore_eos"], bufs["stop_ids"], n_steps=nw,
        page_size=engine.cfg.page_size, greedy=greedy,
        fused=fused)[0].cpu().numpy()


def trace_window(engine, key) -> dict:
    """The next window of the engine's requests, one graph replay of the
    program `key`, traced with torch.profiler; then four engine steps
    timed with the profiler off. Returns the kernel counts, device-busy ms of
    the traced window, the untraced ms per decode step and the share."""
    from torch.profiler import ProfilerActivity, profile
    from dynamo_tpu_torch.engine.window_graph import HostCopies
    cfg = engine.model_cfg
    with engine._on_stream():
        plan = engine.scheduler.schedule()
        samp = engine._sampling_arrays(plan.seqs)
        staged = engine._stage_window(plan, samp, None, False, False, True)
        check(staged["key"] == key, f"traced window key {staged['key']} != "
              f"{key}")
        engine._sync_stream()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            outs = engine._dispatch_staged(staged)
            toks = HostCopies.wait(engine._copy_outs_async(outs))[0]
            traced_ms = (time.perf_counter() - t0) * 1e3
        engine._dec_state = staged["sig"]
        engine._commit_window(plan, toks)
    dev = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    split = sum(e.count for e in dev if "ragged_split_kernel" in e.key)
    nw = staged["nw"]
    check(split == cfg.num_layers * nw,
          f"traced window: ragged_split_kernel ran {split} times, expected "
          f"num_layers x nw = {cfg.num_layers} x {nw}")
    # untraced: four pipelined engine steps, ending in a synchronize
    steps0 = engine.decode_window_steps
    t0 = time.perf_counter()
    for _ in range(4):
        engine.step()
    engine._sync_stream()
    wall = time.perf_counter() - t0
    steps = engine.decode_window_steps - steps0
    ms_step = wall * 1e3 / steps
    rec = {"ragged_split_in_trace": split, "kernels_in_trace": sum(
        e.count for e in dev), "traced_window_ms": traced_ms,
        "device_busy_ms": busy_ms, "untraced_ms_per_step": ms_step,
        "busy_share": busy_ms / nw / ms_step,
        "traced_busy_share": busy_ms / traced_ms}
    print(f"traced window (nw {nw}): {rec['kernels_in_trace']} kernels, "
          f"ragged split kernel {split}x = num_layers x nw; device busy "
          f"{busy_ms:.3f} ms of {traced_ms:.3f} ms wall "
          f"({rec['traced_busy_share']:.1%}); untraced "
          f"{ms_step:.3f} ms per decode step over {steps} steps, device "
          f"busy {rec['busy_share']:.1%} of it", flush=True)
    return rec


def phase_depth_one(smi: str, params, depth_two: dict) -> None:
    """The 8 requests served at pipeline_depth=1 on the main path's weights
    (its own path, with the same checks): each request's token stream must
    equal the depth-2 capturing run's."""
    import torch
    engine1, first1, _ = asyncio.run(serve_main_path(smi, params=params,
                                                     depth=1))
    for i, (a, b) in enumerate(zip(first1["ids"], depth_two["ids"])):
        check(a == b, f"request {i}: depth 1 {a[:8]}... != depth 2 "
              f"{b[:8]}...")
    print(f"pipeline_depth 1 and 2: the 8 token streams are identical "
          f"({sum(len(a) for a in first1['ids'])} tokens)", flush=True)
    engine1.cache = None
    del engine1
    torch.cuda.empty_cache()


# -- phase 6: the kernels at their paths' shapes ------------------------------

def kv_bytes(lens, hkv: int, hd: int, esz: int, quant: bool) -> int:
    """Bytes of the valid K/V rows (plus their two f32 scales when
    quantized) that one call must read."""
    per_row = hd * esz + (4 if quant else 0)
    return int(lens.sum()) * hkv * 2 * per_row


def bound(nbytes: int, flops: int, dtype: str) -> dict:
    byte_ms = nbytes / H100_BYTES_PER_S * 1e3
    op_ms = flops / PEAK_FLOPS[dtype] * 1e3
    return {"bound_ms": max(byte_ms, op_ms),
            "bound_by": "bytes" if byte_ms >= op_ms else "operations"}


def sdpa_yardstick(q, k_cache, v_cache, pt, lens, k_scale=None,
                   v_scale=None):
    """The library call for the same function: the rows' pages gathered
    (and dequantised to q's dtype for int8) + one
    scaled_dot_product_attention. Normalised [S, H, 1, hd]."""
    import torch
    import torch.nn.functional as F
    from dynamo_tpu_torch.ops.kv_quant import gather_dequant
    from dynamo_tpu_torch.ops.attention import gather_pages
    s = q.shape[0]
    if k_scale is not None:
        k = gather_dequant(k_cache, k_scale, pt, q.dtype)
        v = gather_dequant(v_cache, v_scale, pt, q.dtype)
    else:
        k, v = gather_pages(k_cache, pt), gather_pages(v_cache, pt)
    pos = torch.arange(k.shape[2], device=q.device)
    mask = (pos[None, :] < lens[:, None])[:, None, None, :]
    return F.scaled_dot_product_attention(
        q[:, :, None, :], k.transpose(0, 1), v.transpose(0, 1),
        attn_mask=mask, enable_gqa=True)


def phase_timing(engine, n_prompt, max_tokens):
    """The ragged kernel at the main path's shapes, on the engine's own
    cache (bf16 or int8 with scales): kernel vs plain on layers 0, L/2 and
    L-1, then CUDA-event times of the kernel, its plain version and the
    library yardstick, and the bound."""
    import torch
    from dynamo_tpu_torch.engine.scheduler import next_bucket
    from dynamo_tpu_torch.models.llama import torch_dtype
    from dynamo_tpu_torch.ops import paged_attention as pa
    cfg, ecfg = engine.model_cfg, engine.cfg
    s, h, hkv, hd = (ecfg.max_slots, cfg.num_heads, cfg.num_kv_heads,
                     cfg.head_dim)
    ps, nl = ecfg.page_size, cfg.num_layers
    kc, vc = engine.cache["k"], engine.cache["v"]
    ks, vs = engine.cache.get("k_scale"), engine.cache.get("v_scale")
    quant = ks is not None
    label = "int8 cache" if quant else f"{str(kc.dtype)[6:]} cache"
    # the decode plan of the run's 8 requests halfway through their tokens:
    # page-table width bucketed as the scheduler does, lens mid-decode, and
    # distinct pages per row, first the pages the run wrote KV into (in a
    # random order), then unwritten (zero) ones
    pb = next_bucket(-(-(max(n_prompt) + max_tokens) // ps),
                     engine.scheduler.page_buckets)
    g = torch.Generator(device="cuda").manual_seed(7)
    wrote = kc[0, :, :ecfg.num_pages].ne(0).any(-1).any(-1).any(0)
    check(int(wrote.sum()) > 0, f"{label}: the run wrote no KV page")
    perm = torch.randperm(ecfg.num_pages, generator=g, device="cuda")
    perm = perm[torch.argsort((~wrote[perm]).to(torch.int8), stable=True)]
    pt = perm[:s * pb].to(torch.int32).reshape(s, pb)
    lens = torch.tensor([n + max_tokens // 2 for n in n_prompt],
                        dtype=torch.int32, device="cuda")
    qdt = torch_dtype(cfg)
    q = torch.randn((s, h, hd), generator=g, device="cuda").to(qdt)
    # the kernel against its plain version on these inputs (untimed; the
    # path's launch count was read before)
    tol = 2e-3 if qdt == torch.bfloat16 else 1e-4
    errs = []
    layers = sorted({0, nl // 2, nl - 1})
    for layer in layers:
        got = pa.decode_paged_attention_prefix(q, kc, vc, layer, pt, lens,
                                               ks, vs)
        want = pa._ragged_plain(q, kc, vc, layer, pt, lens, ks, vs)
        errs += compare(f"{label} at the main path's shapes, layer {layer}",
                        zip(("acc", "m", "l"), got, want), tol)
    print(f"ragged kernel, {label} at the main path's shapes "
          f"({int(wrote.sum())} pages written by the run): layers {layers} "
          f"max_abs_err acc/m/l = {' '.join(f'{e:.3g}' for e in errs)} "
          f"(tol {tol})", flush=True)
    # the legacy kernel on the same inputs, against its plain version and
    # the ragged kernel's inclusive view (layer 0; normalised outputs in
    # q's dtype, so bf16's 1e-2)
    sc0 = (ks[0], vs[0]) if quant else (None, None)
    lerrs = legacy_check(f"legacy kernel, {label} at the main path's shapes",
                         q, kc[0], vc[0], pt, lens, *sc0, 1e-2)
    print(f"legacy kernel, {label} at the main path's shapes, layer 0: "
          f"max_abs_err vs plain {lerrs[0]:.3g}, vs the ragged kernel "
          f"{lerrs[1]:.3g} (tol 0.01)", flush=True)
    n = 200

    # each launch reads another layer's pages, as the model does: the KV
    # of one layer (~12 MB here) would otherwise sit in the 50 MB L2
    kernel_ms = cuda_ms(lambda i: pa.decode_paged_attention_prefix(
        q, kc, vc, i % nl, pt, lens, ks, vs), n, graph=True)
    eager_ms = cuda_ms(lambda i: pa.decode_paged_attention_prefix(
        q, kc, vc, i % nl, pt, lens, ks, vs), n)
    plain_ms = cuda_ms(lambda i: pa._ragged_plain(
        q, kc, vc, i % nl, pt, lens, ks, vs), 20)
    library_ms = cuda_ms(lambda i: sdpa_yardstick(
        q, kc[i % nl], vc[i % nl], pt, lens,
        *((ks[i % nl], vs[i % nl]) if quant else ())), n)
    esz = kc.element_size()
    nbytes = (kv_bytes(lens, hkv, hd, esz, quant)
              + q.numel() * q.element_size() + pt.numel() * 4
              + lens.numel() * 4 + s * h * (hd + 2) * 4)
    b = bound(nbytes, 4 * int(lens.sum()) * h * hd, cfg.dtype)
    print(f"timing ragged kernel, {label} (S={s}, H={h}, Hkv={hkv}, "
          f"hd={hd}, q {cfg.dtype}, ps={ps}, Pb={pb}, lens={lens.tolist()}):"
          f" kernel {kernel_ms:.4f} ms (graph replay; {eager_ms:.4f} ms per "
          f"eager call), plain {plain_ms:.4f} ms, "
          f"gather{'+dequant' if quant else ''}+sdpa {library_ms:.4f} ms, "
          f"bound {b['bound_ms']:.4f} ms ({nbytes} bytes)", flush=True)
    full_err, full, legacy_full = phase_timing_full_context(engine, q, perm,
                                                            label)
    return max(errs + [full_err]), {
        "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        **b, "full_context": full}, max(lerrs[0], legacy_full.pop("err")), \
        legacy_full


def phase_timing_full_context(engine, q, perm, label: str):
    """The ragged kernel at the full context on the same cache: 8 rows
    (max_slots) of 1536 to max_model_len (2048) tokens, the decode batch
    long chats produce, Pb bucketed as the scheduler does (32), distinct
    pages from `perm`, layers cycled so that each launch misses the L2.
    Kernel vs plain on layer 0, then graph-replay time, the library
    yardstick and the bound. The legacy kernel on layer 0 against its
    plain version and the ragged kernel's inclusive view, and for a bf16
    cache its graph-replay time and bound beside the ragged kernel's.
    Returns (ragged error, ragged record, legacy record with "err")."""
    import torch
    from dynamo_tpu_torch.engine.scheduler import next_bucket
    from dynamo_tpu_torch.ops import paged_attention as pa
    from dynamo_tpu_torch.ops import paged_attention_oracle as leg
    cfg, ecfg = engine.model_cfg, engine.cfg
    s, h, hkv, hd = q.shape[0], cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    ps, nl = ecfg.page_size, cfg.num_layers
    kc, vc = engine.cache["k"], engine.cache["v"]
    ks, vs = engine.cache.get("k_scale"), engine.cache.get("v_scale")
    quant = ks is not None
    top = ecfg.max_model_len
    pb = next_bucket(-(-top // ps), engine.scheduler.page_buckets)
    check(s * pb <= ecfg.num_pages, f"{label}: {s} x {pb} pages > "
          f"{ecfg.num_pages}")
    pt = perm[:s * pb].to(torch.int32).reshape(s, pb)
    lens = torch.tensor([1536 + (top - 1536) * i // (s - 1)
                         for i in range(s)], dtype=torch.int32, device="cuda")
    tol = 2e-3 if q.dtype == torch.bfloat16 else 1e-4
    got = pa.decode_paged_attention_prefix(q, kc, vc, 0, pt, lens, ks, vs)
    want = pa._ragged_plain(q, kc, vc, 0, pt, lens, ks, vs)
    errs = compare(f"{label} at the full context", zip(("acc", "m", "l"),
                                                        got, want), tol)
    kernel_ms = cuda_ms(lambda i: pa.decode_paged_attention_prefix(
        q, kc, vc, i % nl, pt, lens, ks, vs), 200, graph=True)
    plain_ms = cuda_ms(lambda i: pa._ragged_plain(
        q, kc, vc, i % nl, pt, lens, ks, vs), 10)
    library_ms = cuda_ms(lambda i: sdpa_yardstick(
        q, kc[i % nl], vc[i % nl], pt, lens,
        *((ks[i % nl], vs[i % nl]) if quant else ())), 50)
    nbytes = (kv_bytes(lens, hkv, hd, kc.element_size(), quant)
              + q.numel() * q.element_size() + pt.numel() * 4
              + lens.numel() * 4 + s * h * (hd + 2) * 4)
    b = bound(nbytes, 4 * int(lens.sum()) * h * hd, cfg.dtype)
    share = b["bound_ms"] / kernel_ms
    print(f"timing ragged kernel, {label} at the full context (S={s}, "
          f"Pb={pb}, lens={lens.tolist()}): max_abs_err acc/m/l = "
          f"{' '.join(f'{e:.3g}' for e in errs)} (tol {tol}); kernel "
          f"{kernel_ms:.4f} ms (graph replay), plain {plain_ms:.4f} ms, "
          f"gather{'+dequant' if quant else ''}+sdpa {library_ms:.4f} ms, "
          f"bound {b['bound_ms']:.4f} ms ({nbytes} bytes), "
          f"{share:.1%} of the bound", flush=True)
    sc0 = (ks[0], vs[0]) if quant else (None, None)
    lerrs = legacy_check(f"legacy kernel, {label} at the full context", q,
                         kc[0], vc[0], pt, lens, *sc0, 1e-2)
    legacy_full = {"err": lerrs[0]}
    msg = ""
    if not quant:
        leg_ms = cuda_ms(lambda i: leg.decode_paged_attention_legacy(
            q, kc[i % nl], vc[i % nl], pt, lens), 200, graph=True)
        leg_plain = cuda_ms(lambda i: leg._legacy_plain(
            q, kc[i % nl], vc[i % nl], pt, lens), 10)
        lbytes = (kv_bytes(lens, hkv, hd, kc.element_size(), False)
                  + 2 * q.numel() * q.element_size() + pt.numel() * 4
                  + lens.numel() * 4)
        lb = bound(lbytes, 4 * int(lens.sum()) * h * hd, cfg.dtype)
        legacy_full.update(ms=leg_ms, bound_ms=lb["bound_ms"],
                           plain_ms=leg_plain, library_ms=library_ms,
                           share_of_bound=lb["bound_ms"] / leg_ms)
        msg = (f"; kernel {leg_ms:.4f} ms (graph replay; the ragged kernel "
               f"{kernel_ms:.4f} ms), plain {leg_plain:.4f} ms, bound "
               f"{lb['bound_ms']:.4f} ms "
               f"({lbytes} bytes), {lb['bound_ms'] / leg_ms:.1%} of the "
               f"bound")
    print(f"legacy kernel, {label} at the full context, layer 0: "
          f"max_abs_err vs plain {lerrs[0]:.3g}, vs the ragged kernel "
          f"{lerrs[1]:.3g} (tol 0.01){msg}", flush=True)
    return max(errs), {"ms": kernel_ms, "bound_ms": b["bound_ms"],
                       "plain_ms": plain_ms, "library_ms": library_ms,
                       "share_of_bound": share}, legacy_full


def legacy_ab_inputs(model: str) -> dict:
    """The decode A/B's legacy-kernel inputs for a model's head geometry
    on the card (f32 q and caches, 8 rows, ps 64, Pb 4, lens from the A/B's
    seed), with copies of the caches that together exceed the 50 MB L2
    (one cache is 4-8 MB; the A/B's head projection flushes the L2 between
    steps), and the bytes one call must move (K/V rows below the lengths,
    q, tables, output)."""
    import torch
    from dynamo_tpu_torch.bench import PAGE_KWARGS, decode_ab_inputs
    from dynamo_tpu_torch.engine.config import get_model_config
    arrs = decode_ab_inputs(get_model_config(model), 8,
                            PAGE_KWARGS["page_size"])
    arrs.pop("w_head")
    t = {k: torch.from_numpy(a).cuda() for k, a in arrs.items()}
    k, v, lens = t["k"], t["v"], t["lens"]
    copies = -(-(128 << 20) // (2 * k.numel() * 4))
    return {"q": t["q"], "k": k, "v": v, "pt": t["pt"], "lens": lens,
            "ks": [k.clone() for _ in range(copies)],
            "vs": [v.clone() for _ in range(copies)],
            "nbytes": (kv_bytes(lens, k.shape[0], k.shape[3], 4, False)
                       + 2 * t["q"].numel() * 4 + t["pt"].numel() * 4
                       + lens.numel() * 4)}


def phase_legacy_timing(model: str):
    """The legacy kernel at the decode A/B's shapes for a model's head
    geometry (legacy_ab_inputs): kernel vs plain, then CUDA-event times of
    the kernel (cycling the cache copies), its plain version, the library
    yardstick and the bound."""
    from dynamo_tpu_torch.ops import paged_attention_oracle as leg
    a = legacy_ab_inputs(model)
    q, k, v, pt, lens = a["q"], a["k"], a["v"], a["pt"], a["lens"]
    ks, vs = a["ks"], a["vs"]
    s, h, hd = q.shape
    hkv = k.shape[0]
    copies = len(ks)
    got = leg.decode_paged_attention_legacy(q, k, v, pt, lens)
    want = leg._legacy_plain(q, k, v, pt, lens)
    err = compare(f"legacy kernel at the {model} A/B shapes",
                  [("out", got, want)], 1e-4)[0]
    kernel_ms = cuda_ms(lambda i: leg.decode_paged_attention_legacy(
        q, ks[i % copies], vs[i % copies], pt, lens), 200, graph=True)
    eager_ms = cuda_ms(lambda i: leg.decode_paged_attention_legacy(
        q, ks[i % copies], vs[i % copies], pt, lens), 200)
    plain_ms = cuda_ms(lambda i: leg._legacy_plain(
        q, ks[i % copies], vs[i % copies], pt, lens), 20)
    library_ms = cuda_ms(lambda i: sdpa_yardstick(
        q, ks[i % copies], vs[i % copies], pt, lens), 200)
    nbytes = a["nbytes"]
    del a, ks, vs
    b = bound(nbytes, 4 * int(lens.sum()) * h * hd, "float32")
    print(f"timing legacy kernel, {model} heads (S={s}, H={h}, Hkv={hkv}, "
          f"hd={hd}, f32, ps={k.shape[2]}, Pb={pt.shape[1]}, "
          f"lens={lens.tolist()}, {copies} cache copies): max_abs_err vs "
          f"plain {err:.3g} (tol 1e-4); kernel {kernel_ms:.4f} ms (graph "
          f"replay; {eager_ms:.4f} ms per eager call), plain "
          f"{plain_ms:.4f} ms, gather+sdpa {library_ms:.4f} ms, bound "
          f"{b['bound_ms']:.4f} ms ({nbytes} bytes), "
          f"{b['bound_ms'] / kernel_ms:.1%} of the bound", flush=True)
    return err, {"ms": kernel_ms, "plain_ms": plain_ms,
                 "library_ms": library_ms, **b}


# -- phase 7: the int8 parity gate --------------------------------------------

def phase_parity(engine) -> dict:
    from dynamo_tpu_torch.bench import run_kv_quant_parity
    t0 = time.perf_counter()
    verdict = run_kv_quant_parity(engine.model_cfg, params=engine.params,
                                  device="cuda",
                                  logf=lambda m: print(m, flush=True))
    check(verdict["pass"], f"kv_quant parity gate failed: {verdict}")
    print(f"parity gate at {engine.model_cfg.name}: {json.dumps(verdict)} "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    return verdict


# -- phase 8: the decode A/B --------------------------------------------------

def phase_ab(model: str) -> tuple:
    """run_decode_kernel_ab at a model's head geometry, its own path: the
    launch counts are set to 0 just before and read just after."""
    import torch
    from dynamo_tpu_torch.bench import run_decode_kernel_ab
    from dynamo_tpu_torch.engine.config import get_model_config
    from dynamo_tpu_torch.ops import paged_attention as pa
    from dynamo_tpu_torch.ops import paged_attention_oracle as leg
    cfg = get_model_config(model)
    t0 = time.perf_counter()
    reset_launch_counts()
    res = run_decode_kernel_ab(cfg, rows=8, device="cuda",
                               logf=lambda m: print(m, flush=True))
    torch.cuda.synchronize()
    launches = {"legacy": leg.KERNEL_LAUNCHES, "ragged": pa.KERNEL_LAUNCHES}
    check(res["tokens_identical"], f"A/B at {model}: tokens differ")
    check(launches["legacy"] > 0 and launches["ragged"] > 0,
          f"A/B at {model}: kernel launches {launches}")
    res.pop("tokens")
    print(f"A/B at {model} heads: {json.dumps(res)}; launches {launches}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return res, launches


# -- phase 9: the HTTP path at full width, int8 weights -------------------------

def _head(method: str, path: str, data: bytes, extra=None) -> bytes:
    """An HTTP/1.1 request head for localhost (+ `extra` headers)."""
    lines = "".join(f"{k}: {v}\r\n" for k, v in (extra or {}).items())
    return (f"{method} {path} HTTP/1.1\r\nhost: localhost\r\n"
            "content-type: application/json\r\n" + lines +
            f"content-length: {len(data)}\r\n\r\n").encode() + data


async def _http(port: int, method: str, path: str, body=None,
                extra=None) -> tuple:
    """One HTTP/1.1 request to localhost; (status, headers, body bytes),
    reading by content-length or chunked transfer (the server keeps
    connections alive)."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        data = json.dumps(body).encode() if body is not None else b""
        writer.write(_head(method, path, data, extra))
        await writer.drain()
        head = (await reader.readuntil(b"\r\n\r\n")).decode("latin-1")
        lines = head.split("\r\n")
        status = int(lines[0].split(" ")[1])
        headers = {k.strip().lower(): v.strip() for k, _, v in
                   (x.partition(":") for x in lines[1:] if ":" in x)}
        if headers.get("transfer-encoding") != "chunked":
            n = int(headers.get("content-length", "0"))
            return status, headers, await reader.readexactly(n)
        out = b""
        while True:
            size = int((await reader.readuntil(b"\r\n")).strip(), 16)
            if size == 0:
                await reader.readuntil(b"\r\n")
                return status, headers, out
            out += await reader.readexactly(size)
            await reader.readexactly(2)
    finally:
        writer.close()
        await writer.wait_closed()


async def _sse(port: int, body: dict, extra=None) -> tuple:
    """A streamed chat: (parsed frames, ended with [DONE], seconds to the
    first frame with content or None, seconds to the first frame). With
    random weights and the byte tokenizer most sampled ids (>= 259) print
    nothing, so a stream can end without content."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    t0 = time.perf_counter()
    first, frames, done = None, [], False
    first_frame = None
    try:
        writer.write(_head("POST", "/v1/chat/completions",
                           json.dumps(body).encode(), extra))
        await writer.drain()
        head = (await reader.readuntil(b"\r\n\r\n")).decode("latin-1")
        check(" 200 " in head.split("\r\n")[0], f"SSE status: {head[:40]}")
        buf = b""
        while True:
            size = int((await reader.readuntil(b"\r\n")).strip(), 16)
            if size == 0:
                break
            buf += await reader.readexactly(size)
            await reader.readexactly(2)
            while b"\n\n" in buf:
                block, buf = buf.split(b"\n\n", 1)
                payload = "\n".join(line[5:].lstrip(" ") for line in
                                    block.decode().split("\n")
                                    if line.startswith("data:"))
                if payload == "[DONE]":
                    done = True
                    continue
                frame = json.loads(payload)
                if first_frame is None:
                    first_frame = time.perf_counter() - t0
                if first is None and any(
                        (c.get("delta") or {}).get("content")
                        for c in frame.get("choices", [])):
                    first = time.perf_counter() - t0
                frames.append(frame)
    finally:
        writer.close()
        await writer.wait_closed()
    return frames, done, first, first_frame


def hist_counts(text: str, name: str) -> int:
    """The sum of a histogram's _count series in a /metrics text."""
    return sum(int(m.group(1)) for m in re.finditer(
        rf"^{name}_count{{[^}}]*}} (\d+)$", text, re.M))


async def http_run(svc, engine, timed, tag: str, smi: str) -> dict:
    """One run of the 8 requests over HTTP, its own path (launch counts 0
    just before, read just after): 4 streamed, 4 unary, checked as the
    phase-9 docstring says."""
    import torch
    from dynamo_tpu_torch.observability.serving import SERVING
    from dynamo_tpu_torch.ops import paged_attention as pa
    from dynamo_tpu_torch.ops import quant
    cfg, gr = engine.model_cfg, engine.graphs
    name = f"HTTP path ({tag} run)"
    bodies = []
    for i, req in enumerate(chat_requests(cfg.name)):
        body = req.to_json(exclude_none=True)
        if i < 4:
            body.update(stream=True,
                        stream_options={"include_usage": True})
        bodies.append(body)
    SERVING.reset()
    timed.stamps.clear()
    before = {k: getattr(engine, k) for k in COUNTERS}
    g0 = (gr.replays, dict(gr.warmup_launches), dict(gr.replay_launches))
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t_run = time.perf_counter()

    async def unary(body):
        status, _, raw = await _http(svc.port, "POST",
                                     "/v1/chat/completions", body)
        check(status == 200, f"{name}: status {status}: {raw[:200]}")
        return json.loads(raw)

    results = await asyncio.gather(*(
        _sse(svc.port, b) if b.get("stream") else unary(b) for b in bodies))
    wall = time.perf_counter() - t_run
    launches = {RAGGED: pa.KERNEL_LAUNCHES, W8A16: quant.KERNEL_LAUNCHES,
                "w8a16_dequant": quant.DEQUANT_LAUNCHES}
    peak = torch.cuda.max_memory_allocated()
    d = {k: getattr(engine, k) - v for k, v in before.items()}
    replays = gr.replays - g0[0]
    warm = {k: v - g0[1][k] for k, v in gr.warmup_launches.items()}
    replayed = {k: v - g0[2][k] for k, v in gr.replay_launches.items()}
    finishes, client_ttft, first_frames, completion = [], [], [], []
    for i, res in enumerate(results):
        if isinstance(res, tuple):
            frames, done, first, first_frame = res
            check(done, f"{name}: stream {i} did not end with [DONE]")
            first_frames.append(first_frame)
            fin = [c["finish_reason"] for f in frames
                   for c in f.get("choices", []) if c.get("finish_reason")]
            usage = next(f["usage"] for f in frames if f.get("usage"))
            if first is not None:
                client_ttft.append(first)
        else:
            fin = [res["choices"][0]["finish_reason"]]
            usage = res["usage"]
        n = usage["completion_tokens"]
        check(len(fin) == 1 and (fin[0] == "stop" or (
            fin[0] == "length" and n == MAX_TOKENS)),
            f"{name}: request {i} finished {fin} with {n} tokens")
        finishes.append(fin[0])
        completion.append(n)
    check(engine.logits_nonfinite_steps() == 0,
          f"{name}: non-finite logits sampled")
    check(d["decode_dispatches"] == d["decode_windows"] == replays > 0,
          f"{name}: {d['decode_windows']} decode windows, "
          f"{d['decode_dispatches']} dispatches, {replays} graph replays")
    nl, steps = cfg.num_layers, d["decode_window_steps"]
    for key, calls in gr.captured_calls().items():
        nw = key[4]
        check(calls[W8A16] == (7 * nl + 1) * nw and calls[RAGGED] == nl * nw,
              f"{name}: graph {key} holds {calls}, expected "
              f"{(7 * nl + 1) * nw} W8A16 and {nl * nw} ragged launches")
    check(replayed[W8A16] == (7 * nl + 1) * steps
          and replayed[RAGGED] == nl * steps
          and launches[RAGGED] == nl * steps + warm[RAGGED],
          f"{name}: replays added {replayed} launches over {steps} decode "
          f"steps; ragged launches {launches[RAGGED]} (warm-ups "
          f"{warm[RAGGED]})")
    eager_w8 = launches[W8A16] - replayed[W8A16] - warm[W8A16]
    check(eager_w8 >= 0, f"{name}: W8A16 launches {launches[W8A16]} < "
          f"replays {replayed[W8A16]} + warm-ups {warm[W8A16]}")
    status, _, raw = await _http(svc.port, "GET", "/metrics")
    text = raw.decode()
    n_ttft = hist_counts(text, "llm_ttft_seconds")
    n_itl = hist_counts(text, "llm_itl_seconds")
    check(status == 200 and n_ttft == len(bodies) and n_itl > 0,
          f"{name}: /metrics llm_ttft_seconds_count {n_ttft} (choices "
          f"{len(bodies)}), llm_itl_seconds_count {n_itl}")
    labels = (cfg.name, "standard")
    q = {f"{h}_p{int(p * 100)}_ms": getattr(SERVING, h).quantile(p, *labels)
         * 1e3 for h in ("ttft", "itl") for p in (0.5, 0.9)}
    st = list(timed.stamps.values())
    decode_tokens = sum(completion) - len(completion)
    rate = decode_tokens / (max(x["last"] for x in st)
                            - min(x["first"] for x in st))
    m = engine.metrics()
    rec = {"wall_s": wall, **q,
           # streams that printed text (see _sse), and every stream's first
           # frame (a text frame or, with no text, its finish frame)
           "client_ttft_ms": [t * 1e3 for t in client_ttft],
           "client_first_frame_ms": [t * 1e3 for t in first_frames],
           "decode_tok_s": rate, "peak_gib": peak / 2**30,
           "weight_bytes": m.weight_bytes,
           "weight_quant_bits": m.weight_quant_bits,
           "launches": launches, "warmup_launches": warm,
           "replay_launches": replayed, "eager_w8a16_launches": eager_w8,
           "decode_steps": steps, "ttft_count": n_ttft, "itl_count": n_itl,
           "counters": d}
    print(f"{name}: 8 chat requests over HTTP (4 SSE, 4 unary), completion "
          f"tokens {completion}, finish {finishes}; wall {wall:.3f} s; "
          f"counters {json.dumps(d)}; graph replays {replays}; launches "
          f"{json.dumps(launches)} = replays {json.dumps(replayed)} "
          f"((7 x {nl} + 1) x {steps} W8A16, {nl} x {steps} ragged) + "
          f"warm-ups {json.dumps(warm)} + {eager_w8} W8A16 head products of "
          f"prefill steps", flush=True)
    print(f"{name} [{smi}]: histograms TTFT p50 {q['ttft_p50_ms']:.1f} ms, "
          f"p90 {q['ttft_p90_ms']:.1f} ms, ITL p50 {q['itl_p50_ms']:.2f} ms,"
          f" p90 {q['itl_p90_ms']:.2f} ms (llm_ttft_seconds_count {n_ttft}, "
          f"llm_itl_seconds_count {n_itl}); client: first text frame of "
          f"the streams {[round(t, 1) for t in rec['client_ttft_ms']]} ms "
          f"({len(client_ttft)} of 4 streams printed text), first frame "
          f"{[round(t, 1) for t in rec['client_first_frame_ms']]} ms; "
          f"decode {rate:.1f} tok/s "
          f"aggregate; peak memory {peak / 2**30:.2f} GiB; weight_bytes "
          f"{m.weight_bytes}", flush=True)
    return rec


async def phase_http(smi: str, bf16: dict) -> dict:
    """Phase 9: the int8-weight llama3-8b engine behind HttpService, the
    8 requests twice; `bf16` holds phase 4's weight_bytes and peak memory
    to print beside this engine's."""
    import torch
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import NativeEngine
    from dynamo_tpu_torch.frontend.service import HttpService
    from dynamo_tpu_torch.llm.pipeline import LocalPipeline
    from dynamo_tpu_torch.llm.worker import NativeEngineWorker
    from dynamo_tpu_torch.run import build_card
    card = build_card("llama3-8b")
    cfg = dataclasses.replace(card.model_config(), quant="int8")
    t0 = time.perf_counter()
    engine = NativeEngine(cfg, EngineConfig(), seed=0, device="cuda",
                          eos_token_ids=set(card.eos_token_ids))
    torch.cuda.synchronize()
    print(f"HTTP path: {cfg.name} int8 weights + bf16 KV cache ready in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    worker = await NativeEngineWorker(engine).start()
    timed = TimedEngine(worker)
    svc = await HttpService("127.0.0.1", 0).start()
    svc.models.add(card.name, LocalPipeline(card, timed), card.model_type)
    try:
        runs = {tag: await http_run(svc, engine, timed, tag, smi)
                for tag in ("capturing", "warm")}
    finally:
        await svc.stop()
        await worker.stop()
    first = runs["capturing"]
    print(f"HTTP path: weight_bytes {first['weight_bytes']} (int8) against "
          f"{bf16['weight_bytes']} (bf16, phase 4): "
          f"{first['weight_bytes'] / bf16['weight_bytes']:.3f}x; peak memory"
          f" {first['peak_gib']:.2f} GiB against {bf16['peak_gib']:.2f} GiB",
          flush=True)
    engine.cache = None
    del engine
    torch.cuda.empty_cache()
    return runs


# -- phase 10: the entry point as a process ---------------------------------------

def phase_entry_point() -> dict:
    """`python -m dynamo_tpu_torch.run in=http:0 out=native tiny --quant
    int8` on the card: READY, one streamed chat ending in [DONE], then the
    process is stopped."""
    import queue
    import signal
    import threading
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "dynamo_tpu_torch.run", "in=http:0",
           "out=native", "tiny", "--quant", "int8"]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=root, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    # a thread drains the process's output (a full pipe would block it)
    lines: queue.Queue = queue.Queue()
    reader = threading.Thread(target=lambda: [
        lines.put(x) for x in iter(proc.stdout.readline, "")], daemon=True)
    reader.start()
    try:
        line, deadline = "", time.monotonic() + 300
        while not line.startswith("READY"):
            left = deadline - time.monotonic()
            check(left > 0 and proc.poll() is None,
                  f"entry point: no READY line (exit {proc.poll()})")
            try:
                line = lines.get(timeout=min(left, 5.0))
            except queue.Empty:
                continue
        m = re.match(r"READY http=:(\d+) model=tiny", line)
        check(m is not None, f"entry point: {line!r}")
        ready_s = time.perf_counter() - t0
        frames, done, first, _ = asyncio.run(asyncio.wait_for(_sse(
            int(m.group(1)), {"model": "tiny", "stream": True,
                              "max_tokens": 8, "messages": [
                                  {"role": "user", "content": "hello"}]}),
            120))
        check(done and frames, "entry point: the stream did not end with "
              "[DONE]")
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=60)
        reader.join(timeout=10)
    print(f"entry point: `{' '.join(cmd[1:])}` READY in {ready_s:.1f} s, "
          f"one streamed chat ({len(frames)} frames, first text frame "
          f"{'none' if first is None else f'{first * 1e3:.1f} ms'}) ended "
          f"with [DONE]; process stopped (exit {proc.returncode})",
          flush=True)
    return {"ready_s": ready_s, "frames": len(frames)}


# -- phase 11: the distributed path ---------------------------------------------

DIST_EP = "dynamo.llm.generate"
DIST_MAX_TOKENS = 32


class Child:
    """A subprocess of the phase (`python -m <args>` from the checkout's
    root) whose merged output a thread drains into a queue."""

    def __init__(self, name: str, args: list, session: bool = False):
        import queue
        import threading
        self.name = name
        self.lines: list = []
        self._q: queue.Queue = queue.Queue()
        root = os.path.dirname(os.path.abspath(__file__))
        env = {**os.environ, "DYN_LEASE_TTL_S": "30"}
        # session: a process group of its own, so that kill() also reaches
        # the processes it started (a supervisor's services)
        self.session = session
        self.proc = subprocess.Popen(
            [sys.executable, "-m", *args], cwd=root, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            start_new_session=session)
        self._reader = threading.Thread(target=self._drain, daemon=True)
        self._reader.start()

    def _drain(self) -> None:
        for line in iter(self.proc.stdout.readline, ""):
            self.lines.append(line.rstrip("\n"))
            self._q.put(line.rstrip("\n"))

    def tail(self, n: int = 25) -> str:
        return "\n".join(self.lines[-n:])

    def wait_line(self, prefix: str, timeout: float) -> str:
        """The first line (from now) that starts with `prefix`; fails the
        run if the process exits first or the time runs out."""
        import queue
        deadline = time.monotonic() + timeout
        while True:
            left = deadline - time.monotonic()
            check(left > 0, f"{self.name}: no {prefix!r} line in "
                  f"{timeout:.0f} s; last output:\n{self.tail()}")
            try:
                line = self._q.get(timeout=min(left, 1.0))
            except queue.Empty:
                check(self.proc.poll() is None,
                      f"{self.name} exited ({self.proc.returncode}) before "
                      f"{prefix!r}; last output:\n{self.tail()}")
                continue
            if line.startswith(prefix):
                return line

    def stop(self, sig, timeout: float) -> int:
        """Send `sig` (None: send nothing), wait for the exit; kill after
        `timeout`. Returns the exit code."""
        if self.proc.poll() is None:
            if sig is not None:
                self.proc.send_signal(sig)
            try:
                self.proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=30)
        if self.session:
            import signal
            try:
                os.killpg(self.proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        self._reader.join(timeout=10)
        return self.proc.returncode


def dist_text(n: int, seed: int) -> str:
    """n printable characters from a seed; the first one is chosen by the
    seed so that two texts of different seeds differ from their first
    byte."""
    import numpy as np
    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz,.  "))
    head = "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"[seed % 36]
    return head + "".join(rng.choice(letters, n - 1))


def dist_requests(model: str, first_prefix: int, sys_len: int) -> list:
    """16 chat bodies over 4 system prompts of `sys_len` byte-tokens (seeds
    first_prefix..first_prefix+3), each followed by 4 distinct user turns
    of 64-192 byte-tokens: (prefix, turn, body). Request i = 4 p + u is
    greedy when i is even and sampled otherwise (temperature 0.8, top_k
    50, a seed), streamed (SSE, with usage) when i // 2 is even and unary
    otherwise."""
    out = []
    for p in range(4):
        system = dist_text(sys_len, 1000 + first_prefix + p)
        for u in range(4):
            i = 4 * p + u
            body = {"model": model, "max_tokens": DIST_MAX_TOKENS,
                    "messages": [
                        {"role": "system", "content": system},
                        {"role": "user", "content": dist_text(
                            64 + 32 * u + 7 * p, 4 * u + p)}]}
            if i % 2:
                body.update(temperature=0.8, seed=4321 + i,
                            ext={"top_k": 50})
            if (i // 2) % 2 == 0:
                body.update(stream=True,
                            stream_options={"include_usage": True})
            out.append((first_prefix + p, u, body))
    return out


def expected_prefix_hits(token_lists, page: int) -> tuple:
    """(hits, lookups) of one engine serving the prompts in this order
    with nothing evicted, counted as the port scheduler counts them
    (engine/scheduler.py `_prefix_walk` / `_match_prefix`): of a prompt's
    first n_full = (len - 1) // page full pages, the leading ones an
    earlier prompt already stored are hits, and it looks up
    min(hits + 1, n_full) pages."""
    stored, hits, lookups = set(), 0, 0
    for toks in token_lists:
        n_full = (len(toks) - 1) // page
        h = 0
        while h < n_full and tuple(toks[:(h + 1) * page]) in stored:
            h += 1
        hits += h
        lookups += min(h + 1, n_full)
        stored.update(tuple(toks[:(i + 1) * page])
                      for i in range(len(toks) // page))
    return hits, lookups


def _ttft_buckets(text: str) -> dict:
    """{upper bound: cumulative count} of a /metrics text's
    llm_ttft_seconds buckets, summed over its label series."""
    cum: dict = {}
    for m in re.finditer(r'^llm_ttft_seconds_bucket\{[^}]*le="([^"]+)"\} '
                         r'(\d+)$', text, re.M):
        le = float(m.group(1))
        cum[le] = cum.get(le, 0) + int(m.group(2))
    return cum


def _ttft_quantiles(after: str, before: str = "") -> dict:
    """TTFT p50 / p90 (ms) of the requests observed between two /metrics
    texts of one frontend, from the llm_ttft_seconds bucket counts (the
    registry's estimator)."""
    from dynamo_tpu_torch.observability.metrics import _bucket_quantile
    old = _ttft_buckets(before)
    cum = {le: n - old.get(le, 0) for le, n in _ttft_buckets(after).items()}
    bounds = sorted(cum)
    counts = [cum[b] - (cum[bounds[i - 1]] if i else 0)
              for i, b in enumerate(bounds)]
    total = cum[bounds[-1]] if bounds else 0
    return {f"ttft_p{int(q * 100)}_ms":
            _bucket_quantile(bounds, counts, total, q) * 1e3
            for q in (0.5, 0.9)}


async def _dist_send(port: int, body: dict, rid: str) -> dict:
    """One chat request with an x-request-id; its finish reason,
    completion tokens, (streamed) the seconds to its first frame and
    (unary) the body."""
    extra = {"x-request-id": rid}
    if body.get("stream"):
        frames, done, _, first_frame = await _sse(port, body, extra)
        check(done, f"{rid}: the stream did not end with [DONE]")
        fin = [c["finish_reason"] for f in frames
               for c in f.get("choices", []) if c.get("finish_reason")]
        usage = next(f["usage"] for f in frames if f.get("usage"))
        out = {"finish": fin, "tokens": usage["completion_tokens"],
               "ttft_s": first_frame}
    else:
        status, _, raw = await _http(port, "POST", "/v1/chat/completions",
                                     body, extra)
        check(status == 200, f"{rid}: status {status}: {raw[:200]}")
        res = json.loads(raw)
        out = {"finish": [c["finish_reason"] for c in res["choices"]],
               "tokens": res["usage"]["completion_tokens"], "body": res}
    check(len(out["finish"]) == 1 and (out["finish"][0] == "stop" or (
        out["finish"][0] == "length"
        and out["tokens"] == body["max_tokens"])),
        f"{rid}: finished {out['finish']} with {out['tokens']} tokens")
    return out


async def _get_json(port: int, path: str, body=None) -> dict:
    status, _, raw = await _http(port, "POST" if body else "GET", path, body)
    check(status == 200, f"{path}: status {status}: {raw[:200]}")
    return json.loads(raw)


async def _poll(what: str, fn, timeout: float, poll_s: float = 0.2):
    """Await fn() until it returns a true value, for at most `timeout`."""
    deadline = time.monotonic() + timeout
    while True:
        got = await fn()
        if got:
            return got
        check(time.monotonic() < deadline, f"{what}: not within "
              f"{timeout:.0f} s")
        await asyncio.sleep(poll_s)


async def _scrape(client, n: int) -> dict:
    """{worker id: its $STATS reply} of all n workers, over the control
    plane."""
    async def all_of():
        got = await client.scrape_stats(timeout=10.0)
        return got if len(got) == n else None
    return await _poll("scraping $STATS of every worker", all_of, 60)


def _delta(after: dict, before: dict, key: str) -> int:
    return sum(after[w][key] - before[w][key] for w in after)


async def _waves(port: int, reqs: list, model: str, tag: str) -> tuple:
    """Wave 1 (one request per prefix, concurrently), then, once the
    router at `port` scores every prefix on some worker (a frontend
    without KV routing has no router: the wait is skipped), wave 2 (the
    other 12, concurrently). Returns ({request id: result}, the request
    ids in order)."""
    first = [(p, u, b) for p, u, b in reqs if u == 0]
    rest = [(p, u, b) for p, u, b in reqs if u != 0]
    rid = lambda p, u: f"{tag}-p{p}-u{u}"  # noqa: E731
    res = dict(zip([rid(p, u) for p, u, _ in first], await asyncio.gather(
        *(_dist_send(port, b, rid(p, u)) for p, u, b in first))))
    state = await _get_json(port, "/router/state")
    if state["models"][model]["kv_routed"]:
        async def every_prefix_scores():
            for p, u, b in rest:
                if u != 1:
                    continue
                m = await _get_json(port, "/router/match", {
                    "model": model, "messages": b["messages"]})
                if not m["scores"]:
                    return False
            return True
        await _poll(f"{tag}: the router scoring every prefix",
                    every_prefix_scores, 60)
    res.update(zip([rid(p, u) for p, u, _ in rest], await asyncio.gather(
        *(_dist_send(port, b, rid(p, u)) for p, u, b in rest))))
    return res, [rid(p, u) for p, u, _ in first + rest]


async def drive_distributed(cp_port: int, fe_port: int, fe2_port: int,
                            model: str, sys_len: int, n_layers: int,
                            smi: str, on_card: bool = True) -> dict:
    """Phase 11's traffic and checks against running processes (see the
    phase docstring). `on_card=False` (workers on the CPU, a rehearsal of
    the phase) skips the kernel-launch checks: CPU tensors take the
    kernels' plain versions."""
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.protocols.openai import ChatCompletionRequest
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    name = "distributed path"
    card = ModelDeploymentCard(name=model, arch=model)
    pre = OpenAIPreprocessor(card)

    async def models_listed(port):
        got = await _get_json(port, "/v1/models")
        state = await _get_json(port, "/router/state")
        return ([m["id"] for m in got["data"]] == [model]
                and len(state["models"].get(model, {}).get("instances",
                                                           {})) == 2)
    for port in (fe_port, fe2_port):
        await _poll(f"frontend :{port} listing {model} with 2 instances",
                    lambda: models_listed(port), 120)

    rt = await DistributedRuntime.connect("127.0.0.1", cp_port)
    try:
        client = await rt.namespace("dynamo").component("llm").endpoint(
            "generate").client().start()
        # a warm-up round of the same shapes on other prefixes captures
        # the window graphs, so that neither measured round pays for them
        t0 = time.perf_counter()
        await _waves(fe_port, dist_requests(model, 8, sys_len), model,
                     "warm")
        warm_s = time.perf_counter() - t0
        s0 = await _scrape(client, 2)
        text0 = (await _http(fe_port, "GET", "/metrics"))[2].decode()
        routed = dist_requests(model, 0, sys_len)
        t0 = time.perf_counter()
        res, order = await _waves(fe_port, routed, model, "kv")
        wall = time.perf_counter() - t0
        s1 = await _scrape(client, 2)
        state = await _get_json(fe_port, "/router/state")
        text = (await _http(fe_port, "GET", "/metrics"))[2].decode()

        # the router's side: wave 2 on its prefix's wave-1 worker, with
        # the prefix's pages matched there
        dec = {d["request_id"]: d
               for d in state["models"][model]["decisions"]}
        check(all(r in dec for r in order),
              f"{name}: decisions missing for "
              f"{[r for r in order if r not in dec]}")
        page = card.kv_page_size
        tokens = {(p, u): pre.preprocess_chat(
            ChatCompletionRequest.from_json(b))[0].token_ids
            for p, u, b in routed}
        shared = []
        for (p, u), toks in tokens.items():
            if u == 0:
                continue
            d, d0 = dec[f"kv-p{p}-u{u}"], dec[f"kv-p{p}-u0"]
            toks0 = tokens[(p, 0)]
            common = next(i for i, (a, c) in enumerate(zip(toks, toks0))
                          if a != c)
            shared.append(common // page)
            check(d["worker_id"] == d0["worker_id"]
                  and d["overlap_blocks"] >= sys_len // page,
                  f"{name}: kv-p{p}-u{u} went to {d['worker_id']} with "
                  f"{d['overlap_blocks']} matched pages (its prefix was "
                  f"served by {d0['worker_id']}; {common // page} pages "
                  f"shared)")
        fallbacks = re.search(r"^llm_router_fallbacks (\S+)$", text, re.M)
        check(fallbacks is not None and float(fallbacks.group(1)) == 0,
              f"{name}: llm_router_fallbacks "
              f"{fallbacks and fallbacks.group(1)}")

        # the workers' side: their summed prefix hits are one engine's
        want_hits, want_lookups = expected_prefix_hits(
            [tokens[k] for k in sorted(tokens, key=lambda k: (k[1] > 0, k))],
            page)
        hits = _delta(s1, s0, "gpu_prefix_cache_hits")
        lookups = _delta(s1, s0, "gpu_prefix_cache_lookups")
        admitted = _delta(s1, s0, "requests_admitted")
        per_worker = {w: s1[w]["requests_admitted"]
                      - s0[w]["requests_admitted"] for w in s1}
        check((hits, lookups, admitted) == (want_hits, want_lookups, 16),
              f"{name}: the workers hit {hits} of {lookups} prefix pages "
              f"over {admitted} requests; one engine serving the 16 in "
              f"order hits {want_hits} of {want_lookups}")
        for w, st in s1.items():
            check(st["decode_dispatches"] == st["decode_windows"],
                  f"{name}: worker {w} ran {st['decode_windows']} decode "
                  f"windows in {st['decode_dispatches']} dispatches")
        routed_q = _ttft_quantiles(text, text0)

        # the contrast: the other frontend, round-robin, fresh prefixes
        s2 = s1
        res2, _ = await _waves(fe2_port, dist_requests(model, 4, sys_len),
                               model, "rr")
        s3 = await _scrape(client, 2)
        text2 = (await _http(fe2_port, "GET", "/metrics"))[2].decode()
        rr_hits = _delta(s3, s2, "gpu_prefix_cache_hits")
        rr_lookups = _delta(s3, s2, "gpu_prefix_cache_lookups")
        rr_q = _ttft_quantiles(text2)

        # one greedy request twice through the router: the same tokens
        # (the logprobs of every sampled token equal too)
        greedy = dict(routed[4 * 2 + 2][2], logprobs=True)
        greedy.pop("stream", None)
        greedy.pop("stream_options", None)
        twice = [await _dist_send(fe_port, greedy, f"greedy-{i}")
                 for i in range(2)]
        strip = [{k: v for k, v in t["body"].items()
                  if k not in ("id", "created")} for t in twice]
        check(strip[0] == strip[1], f"{name}: one greedy request twice "
              f"gave {strip[0]} and {strip[1]}")
        s4 = await _scrape(client, 2)
        await client.stop()
    finally:
        await rt.shutdown()
    launches = {}
    for w, st in s4.items():
        k = st["kernel_launches"][RAGGED]
        warm = st["graph_warmup_launches"][RAGGED]
        check(not on_card or k == n_layers * st["decode_window_steps"] + warm,
              f"{name}: worker {w} launched the ragged kernel {k} times "
              f"over {st['decode_window_steps']} decode steps x {n_layers} "
              f"layers + {warm} in warm-ups")
        launches[w] = k
    check(not on_card or sum(launches.values()) > 0,
          f"{name}: no ragged launches")
    rec = {"warmup_s": warm_s, "wall_s": wall,
           "per_worker_requests": per_worker,
           "decisions": {r: [dec[r]["worker_id"], dec[r]["overlap_blocks"]]
                         for r in order},
           "prefix_hits": hits, "prefix_lookups": lookups,
           "expected": [want_hits, want_lookups],
           "kv_routed": {"hit_share": hits / lookups, **routed_q},
           "round_robin": {"hit_share": rr_hits / rr_lookups,
                           "hits": rr_hits, "lookups": rr_lookups, **rr_q},
           "launches": launches, "decode_window_steps": {
               w: st["decode_window_steps"] for w, st in s4.items()},
           "decode_windows": {w: st["decode_windows"]
                              for w, st in s4.items()}}
    print(f"{name}: after a warm-up round of the same shapes "
          f"({warm_s:.3f} s), 16 chat requests (8 SSE, 8 unary; 8 greedy, "
          f"8 sampled) over 4 system prompts of {sys_len} byte-tokens "
          f"answered in {wall:.3f} s; requests per worker {json.dumps(per_worker)}; "
          f"every wave-2 request on its prefix's worker with >= "
          f"{min(shared)} matched pages; prefix hits {hits} of {lookups} "
          f"(one engine in order: {want_hits} of {want_lookups}); router "
          f"fall-backs 0; ragged launches {json.dumps(launches)}",
          flush=True)
    print(f"{name} [two replicas sharing one card: {smi}]: KV-routed "
          f"frontend prefix hit share {hits / lookups:.4f}, TTFT p50 "
          f"{routed_q['ttft_p50_ms']:.1f} ms, p90 "
          f"{routed_q['ttft_p90_ms']:.1f} ms; round-robin frontend "
          f"(--no-kv-routing, 4 fresh prefixes) hit share "
          f"{rr_hits / rr_lookups:.4f}, TTFT p50 {rr_q['ttft_p50_ms']:.1f} "
          f"ms, p90 {rr_q['ttft_p90_ms']:.1f} ms (llm_ttft_seconds)",
          flush=True)
    return rec


def phase_distributed(smi: str, model: str = "llama3-8b",
                      sys_len: int = 1024, device_args=(),
                      device_name: str = None) -> dict:
    """Phase 11 (see the docstring at the top): the control-plane server,
    two `run.py in=endpoint` workers and two frontends as processes, the
    traffic and the checks, then SIGTERM to both workers (each drains,
    deregisters and exits 0). Every child is stopped in the `finally`."""
    import signal
    from dynamo_tpu_torch.engine.config import get_model_config
    children = []
    t0 = time.perf_counter()
    try:
        server = Child("control plane", [
            "dynamo_tpu_torch.runtime.transports.server", "--host",
            "127.0.0.1", "--port", "0"])
        children.append(server)
        cp_port = int(server.wait_line("READY control-plane=:", 120)
                      .rsplit(":", 1)[1])
        workers = [Child(f"worker {i}", [
            "dynamo_tpu_torch.run", f"in=endpoint:{DIST_EP}", "out=native",
            model, "--control-host", "127.0.0.1", "--control-port",
            str(cp_port), *device_args]) for i in range(2)]
        children += workers
        ready = [w.wait_line("READY endpoint=", 900) for w in workers]
        ready_s = time.perf_counter() - t0
        for line in ready:
            dev = line.split(" device=", 1)[1]
            check(dev == device_name, f"worker on {dev!r}, expected "
                  f"{device_name!r}: {line}")
        fronts = [Child(f"frontend{tag}", [
            "dynamo_tpu_torch.frontend.serve", "--host", "127.0.0.1",
            "--port", "0", "--control-host", "127.0.0.1", "--control-port",
            str(cp_port), *extra]) for tag, extra in (
                ("", ()), (" (no KV routing)", ("--no-kv-routing",)))]
        children += fronts
        fe_ports = [int(f.wait_line("READY http=:", 120).rsplit(":", 1)[1])
                    for f in fronts]
        rec = asyncio.run(asyncio.wait_for(drive_distributed(
            cp_port, fe_ports[0], fe_ports[1], model, sys_len,
            get_model_config(model).num_layers, smi,
            on_card=device_name != "cpu"), 900))
        rec["ready_s"] = ready_s
        # drain: SIGTERM both workers; each deregisters and exits 0
        for w in workers:
            w.proc.send_signal(signal.SIGTERM)
        codes = [w.stop(None, 120) for w in workers]
        check(codes == [0, 0], f"workers exited {codes} after SIGTERM:\n"
              + "\n".join(w.tail() for w in workers))
        for w in workers:
            exits = [x for x in w.lines if x.startswith("EXIT ")]
            check(len(exits) == 1 and " logits_nonfinite_steps=0 "
                  in exits[0], f"{w.name}: {exits or w.tail()}")

        async def deregistered():
            async def empty(port):
                st = await _get_json(port, "/router/state")
                return not st["models"].get(model, {}).get("instances")
            for port in fe_ports:
                await _poll(f"frontend :{port} dropping both instances",
                            lambda: empty(port), 60)
        asyncio.run(deregistered())
        rest = [c.stop(signal.SIGINT, 60) for c in fronts + [server]]
        check(rest == [0, 0, 0], f"frontends and server exited {rest}")
        print(f"distributed path: workers READY in {ready_s:.1f} s, drained "
              f"on SIGTERM and exited {codes}; both frontends showed 0 "
              f"instances; frontends and server exited {rest}", flush=True)
        return rec
    finally:
        for c in reversed(children):
            c.stop(signal.SIGKILL, 30)


# -- phase 12: the disaggregated deployment --------------------------------------

DISAGG_NS = "dynamo-demo"
DISAGG_GRAPH = "dynamo_tpu_torch.examples.disagg.graph:Frontend"
DISAGG_PAGES = 1024   # per engine; the reference deployment gives each 2048
# chat user-turn lengths in bytes (byte tokens; the template adds 25). A
# decode window's graph is keyed by its rows' variant (all greedy, or
# sampled), the page bucket of its longest row (admission-time pages of
# prompt + max_tokens) and its window rung (the smallest of 8, 2, 1 that
# covers the row nearest its end), and rounds A and B reach buckets 3, 6,
# 8, 12 (the short chats) and 24, 32, 48 (the long ones) at any rung, as
# the rows' timing falls. The warm-up sends one chat alone for each
# variant x bucket x rung: a user turn inside the bucket at each of its
# max_tokens, which set the rung of its windows (1, 2, then 8): 2, 3 and
# 32 for a local prefill, one more for a remote one, whose activation step
# samples its second token
WARM_BUCKETS = (120, 280, 400, 600, 1200, 1800, 2400)
WARM_MAX_TOKENS = (2, 3, DIST_MAX_TOKENS)
ROUND_A = (1100, 1400, 2100, 2560)
ROUND_B_LONG = tuple(1100 + 270 * i for i in range(8))     # 1100-2990
ROUND_B_SHORT = (100, 270, 430, 600)


def disagg_config(model: str, device: str, scale: float,
                  max_model_len: int = 0) -> dict:
    """config.json with its one listed cut (num_pages 1024 per engine, two
    engines sharing one card); a rehearsal on the CPU (`device` "cpu", a
    small model) shrinks the prompts and the threshold together by `scale`
    and may set the engines' max_model_len."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "dynamo_tpu_torch", "examples", "disagg",
                        "config.json")
    with open(path) as f:
        cfg = json.load(f)
    cfg["Frontend"]["port"] = 0
    for svc in ("DecodeWorker", "PrefillWorker"):
        cfg[svc].update(model=model, device=device, num_pages=DISAGG_PAGES)
        if max_model_len:
            cfg[svc]["max_model_len"] = max_model_len
    cfg["DecodeWorker"]["max_local_prefill_length"] = int(1000 * scale)
    return cfg


def disagg_body(model: str, n: int, seed: int, sampled: bool,
                stream: bool, scale: float,
                max_tokens: int = DIST_MAX_TOKENS) -> dict:
    body = {"model": model, "max_tokens": max_tokens,
            "messages": [{"role": "user",
                          "content": dist_text(max(8, int(n * scale)),
                                               seed)}]}
    if sampled:
        body.update(temperature=0.8, seed=777 + seed, ext={"top_k": 50})
    if stream:
        body.update(stream=True, stream_options={"include_usage": True})
    return body


def round_b(model: str, scale: float) -> list:
    """(request id, body, long?) of round B: 8 long chats and 4 short ones
    with no shared prefix, half greedy / half sampled, half SSE / half
    unary."""
    out = []
    for i, n in enumerate(ROUND_B_LONG + ROUND_B_SHORT):
        long_ = i < len(ROUND_B_LONG)
        out.append((f"B-{i}", disagg_body(model, n, 300 + i, i % 2 == 1,
                                          (i // 2) % 2 == 0, scale), long_))
    return out


async def drive_disagg(cp_port: int, fe_port: int, model: str, scale: float,
                       n_layers: int, reference: dict, pre, page: int,
                       threshold: int, smi: str, on_card: bool) -> dict:
    """Phase 12's traffic and checks against the running deployment (see
    the phase docstring)."""
    from dynamo_tpu_torch.disagg.router import DisaggregatedRouter
    from dynamo_tpu_torch.protocols.openai import ChatCompletionRequest
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    name = "disaggregated deployment"
    router = DisaggregatedRouter(threshold, 2)

    async def listed():
        got = await _get_json(fe_port, "/v1/models")
        return [m["id"] for m in got["data"]] == [model]
    await _poll(f"frontend :{fe_port} listing {model}", listed, 120)
    rt = await DistributedRuntime.connect("127.0.0.1", cp_port)
    try:
        dec_client = await rt.namespace(DISAGG_NS).component(
            "backend").endpoint("generate").client().start()
        pre_client = await rt.namespace(DISAGG_NS).component(
            "prefill").endpoint("stats").client().start()

        async def scrape():
            (d,) = (await _scrape(dec_client, 1)).values()
            (p,) = (await _scrape(pre_client, 1)).values()
            return d, p

        # warm-up: one chat at a time for every window graph rounds A and
        # B can replay (see WARM_BUCKETS), and the prefill shapes
        t0 = time.perf_counter()
        for i, n in enumerate(WARM_BUCKETS):
            prompt = pre.preprocess_chat(ChatCompletionRequest.from_json(
                disagg_body(model, n, 0, False, False, scale)))[0]
            remote = router.prefill_remote(len(prompt.token_ids), 0, 0)
            for sampled in (False, True):
                for j, mt in enumerate(WARM_MAX_TOKENS):
                    mt += remote and mt < DIST_MAX_TOKENS
                    await _dist_send(fe_port, disagg_body(
                        model, n, 1000 + 6 * i + 3 * sampled + j, sampled,
                        False, scale, mt),
                        f"W-{n}-{'s' if sampled else 'g'}{mt}")
        warm_s = time.perf_counter() - t0
        d0, p0 = await scrape()
        text0 = (await _http(fe_port, "GET", "/metrics"))[2].decode()

        # round A: the 4 greedy long chats one at a time, through the
        # decode worker's endpoint (token ids in every frame), each against
        # the plain aggregated engine's stream (equal up to a near tie) and
        # the reference engine's (equal)
        a_ttft, a_tokens, a_div = {}, {}, {}
        t0 = time.perf_counter()
        for i, rid in enumerate(reference):
            req = dict(reference[rid]["pre"], request_id=rid)
            t1 = time.perf_counter()
            toks, finish, first = [], None, None
            async for frame in await dec_client.generate(req):
                if frame.get("token_ids") and first is None:
                    first = time.perf_counter() - t1
                toks.extend(frame.get("token_ids", ()))
                finish = frame.get("finish_reason") or finish
            check(finish == "stop" or (finish == "length" and len(toks)
                                         == DIST_MAX_TOKENS),
                  f"{name}: {rid} finished {finish} after {len(toks)} "
                  "tokens")
            agg, tops = reference[rid]["aggregated"]
            a_div[rid] = divergence(toks, agg, tops)
            check(a_div[rid] is None or a_div[rid][1] <= NEAR_TIE,
                  f"{name}: {rid} left the plain aggregated engine's stream "
                  f"at (position, logprob gap) {a_div[rid]}, past a near "
                  f"tie ({NEAR_TIE}): {toks} against {agg}")
            check(toks == reference[rid]["tokens"], f"{name}: {rid} gave "
                  f"{toks}, the reference engine {reference[rid]['tokens']}")
            a_ttft[rid], a_tokens[rid] = first, len(toks)
        a_wall = time.perf_counter() - t0
        d1, p1 = await scrape()

        # round B: 12 chats at once through the KV-routed frontend
        reqs = round_b(model, scale)
        t0 = time.perf_counter()

        async def one(rid, body):
            t1 = time.perf_counter()
            res = await _dist_send(fe_port, body, rid)
            return res, time.perf_counter() - t1
        got = await asyncio.gather(*(one(rid, b) for rid, b, _ in reqs))
        b_wall = time.perf_counter() - t0

        # a stream ends once its pages are committed, a moment before the
        # prefill worker's last ack lands and it counts the item completed
        async def settled():
            d, p = await scrape()
            return (d, p) if (p["prefill"]["completed"]
                              + p["prefill"]["failed"]
                              >= d["disagg"]["remote_prefills"]) else None
        d2, p2 = await _poll(f"{name}: the prefill worker settling every "
                             "item", settled, 60)
        text2 = (await _http(fe_port, "GET", "/metrics"))[2].decode()
        await dec_client.stop()
        await pre_client.stop()
    finally:
        await rt.shutdown()

    # the decisions: round A all remote; round B's long ones as the router
    # decides on the length, prefix hit and queue depth the decode worker
    # saw; every short request local
    dec = d2["disagg"]["decisions"]
    tokens = {rid: len(reference[rid]["pre"]["token_ids"])
              for rid in reference}
    for rid, body, _ in reqs:
        tokens[rid] = len(pre.preprocess_chat(
            ChatCompletionRequest.from_json(body))[0].token_ids)
    for rid in list(reference) + [r for r, _, _ in reqs]:
        check(rid in dec, f"{name}: no decision recorded for {rid}")
        check(dec[rid]["prompt_len"] == tokens[rid], f"{name}: {rid} "
              f"decided on {dec[rid]['prompt_len']} tokens, sent "
              f"{tokens[rid]}")
    check(all(dec[rid]["remote"] for rid in reference),
          f"{name}: round A not all remote: "
          f"{ {r: dec[r] for r in reference} }")
    for rid, _, long_ in reqs:
        d = dec[rid]
        if long_:
            want = router.prefill_remote(d["prompt_len"], d["prefix_hit"],
                                         d["queue_depth"])
            check(d["remote"] == want, f"{name}: {rid} decided {d}, the "
                  f"router says remote={want}")
        else:
            check(not d["remote"], f"{name}: short {rid} went remote: {d}")
    remote = [r for r in list(reference) + [r for r, _, _ in reqs]
              if dec[r]["remote"]]

    # the transfer: completions, pages, integrity and no fall-back
    def delta(a, b, *path):
        for k in path:
            a, b = a[k], b[k]
        return a - b
    n_remote = delta(d2, d0, "disagg", "remote_prefills")
    completed = delta(p2, p0, "prefill", "completed")
    check(n_remote == len(remote) == completed, f"{name}: {n_remote} "
          f"remote prefills, {len(remote)} remote decisions, the prefill "
          f"worker completed {completed}")
    want_pages = sum(-(-dec[r]["prompt_len"] // page)
                     - dec[r]["prefix_hit"] // page for r in remote)
    received = delta(d2, d0, "disagg", "received_pages")
    verified = delta(d2, d0, "disagg", "integrity", "pages_verified")
    mismatches = delta(d2, d0, "disagg", "integrity", "mismatches")
    check(received == want_pages == verified and mismatches == 0,
          f"{name}: received {received} pages, the remote requests' "
          f"uncached pages {want_pages}, verified {verified}, mismatches "
          f"{mismatches}")
    fallbacks = {k: d2["disagg"][k] for k in (
        "salvaged_prefills", "full_reprefills", "overlap_fallbacks",
        "prefill_timeouts", "majority_committed_full_reprefills")}
    fallbacks["link_timeouts"] = p2["prefill"]["kv_transfer"]["link_timeouts"]
    fallbacks["prefill_failed"] = p2["prefill"]["failed"]
    rf = re.search(r"^llm_router_fallbacks (\S+)$", text2, re.M)
    fallbacks["llm_router_fallbacks"] = float(rf.group(1)) if rf else None
    check(all(v == 0 for v in fallbacks.values()),
          f"{name}: fall-backs {fallbacks}")

    # the kernels: the prefill worker never launched the ragged kernel;
    # the decode worker launched it layers x decode steps + warm-ups, one
    # replay per window, and its graphs were never dropped (an inject
    # writes in place); rounds A and B replayed the warm-up's graphs only
    pk = p2["kernel_launches"][RAGGED]
    dk = d2["kernel_launches"][RAGGED]
    dwarm = d2["graph_warmup_launches"][RAGGED]
    check(pk == 0, f"{name}: the prefill worker launched the ragged "
          f"kernel {pk} times")
    check(not on_card or (dk == n_layers * d2["decode_window_steps"] + dwarm
                          and dk > 0),
          f"{name}: the decode worker launched the ragged kernel {dk} "
          f"times over {d2['decode_window_steps']} decode steps x "
          f"{n_layers} layers + {dwarm} in warm-ups")
    check(d2["decode_dispatches"] == d2["decode_windows"],
          f"{name}: {d2['decode_windows']} decode windows in "
          f"{d2['decode_dispatches']} dispatches")
    graphs = [d["disagg"]["graphs"] for d in (d0, d1, d2)]
    resets = [d["disagg"]["graph_resets"] for d in (d0, d2)]
    keys = [d["disagg"]["graph_keys"] for d in (d0, d1, d2)]
    new_keys = {"round A": [k for k in keys[1] if k not in keys[0]],
                "round B": [k for k in keys[2] if k not in keys[1]]}
    check(resets[0] == resets[1] and graphs[0] <= graphs[1] <= graphs[2],
          f"{name}: graphs {graphs}, resets {resets}")
    check(not on_card or graphs[2] == graphs[0], f"{name}: rounds A and B "
          f"captured {graphs[1] - graphs[0]} and {graphs[2] - graphs[1]} "
          f"graphs after the warm-up: {new_keys}; the warm-up's {keys[0]}")

    # reported: TTFT (remote / local), transfers, activation, memory
    import numpy as np

    def quantiles(xs):
        return ({"n": len(xs), "p50": float(np.percentile(xs, 50)),
                 "p90": float(np.percentile(xs, 90))} if xs else {"n": 0})
    sse_ttft = {kind: quantiles([r["ttft_s"] * 1e3 for (rid, b, _), (r, _)
                                 in zip(reqs, got) if b.get("stream")
                                 and dec[rid]["remote"] == (kind == "remote")])
                for kind in ("remote", "local")}
    xfers = {r: p2["prefill"]["transfers"][r] for r in remote
             if r in p2["prefill"]["transfers"]}
    for x in xfers.values():
        x["mib"] = x["bytes"] / 2 ** 20
        x["gb_s"] = x["bytes"] / (x["ms"] * 1e6) if x["ms"] else None
    rec = {
        "warmup_s": warm_s, "round_a_s": a_wall, "round_b_s": b_wall,
        "remote": remote, "decisions": {r: dec[r] for r in dec
                                        if r.startswith(("A-", "B-"))},
        "round_a_ttft_ms": {r: t * 1e3 for r, t in a_ttft.items()},
        "round_a_divergence_from_plain_aggregated": a_div,
        "aggregated_top2_gap_median": float(np.median(
            [t[0][1] - t[1][1] for ref in reference.values()
             for t in ref["aggregated"][1]])),
        "round_b_latency_ms": {rid: t * 1e3 for (rid, _, _), (_, t)
                               in zip(reqs, got)},
        "round_b_client_ttft_ms": sse_ttft,
        "llm_ttft": _ttft_quantiles(text2, text0),
        "early_first_emits": delta(d2, d0, "disagg", "early_first_emits"),
        "transfers": xfers,
        "activation_ms": {r: d2["disagg"]["activation_ms"].get(r)
                          for r in remote},
        "pages": received, "fallbacks": fallbacks,
        "graphs": graphs, "warmup_graph_keys": keys[0],
        "launches": {"decode": dk, "prefill": pk},
        "decode_window_steps": d2["decode_window_steps"],
        "peak_gib": {"decode": d2["disagg"]["peak_bytes"] / 2 ** 30,
                     "prefill": p2["prefill"]["peak_bytes"] / 2 ** 30}}
    gbs = [x["gb_s"] for x in xfers.values() if x["gb_s"]]
    print(f"{name} [{smi}]: warm-up {warm_s:.3f} s; round A (4 greedy long "
          f"chats, one at a time) token-identical to the reference engine "
          f"(its disaggregation hooks in one process); against the plain "
          f"aggregated engine, the first (position, logprob gap) where a "
          f"stream left it {json.dumps(a_div)} (null: identical; tolerance "
          f"{NEAR_TIE}; its median top-1/top-2 gap "
          f"{rec['aggregated_top2_gap_median']:.4f}) of "
          f"{json.dumps(a_tokens)} tokens, client TTFT "
          f"ms {json.dumps(rec['round_a_ttft_ms'])}; round B "
          f"(12 at once) in {b_wall:.3f} s, remote {len(remote)} of "
          f"{len(reference) + len(reqs)}, {received} pages received = "
          f"verified, 0 mismatches, fall-backs 0; llm_ttft_seconds p50 "
          f"{rec['llm_ttft']['ttft_p50_ms']:.1f} ms p90 "
          f"{rec['llm_ttft']['ttft_p90_ms']:.1f} ms (round B, at the "
          f"frontend), client TTFT of the streamed requests (ms) "
          f"{json.dumps(sse_ttft)}; early first emits "
          f"{rec['early_first_emits']}; transfer GB/s "
          f"{min(gbs) if gbs else 0:.3f}-{max(gbs) if gbs else 0:.3f}; "
          f"graphs {graphs}; ragged launches decode {dk} prefill {pk}; "
          f"peak GiB decode {rec['peak_gib']['decode']:.2f} prefill "
          f"{rec['peak_gib']['prefill']:.2f}", flush=True)
    return rec


# a greedy stream of the deployment may leave the plain aggregated engine's
# only at a near tie: where the one-token prefill that writes the first
# token's KV (the disaggregated path) and the decode window (the aggregated
# one) round differently in bf16, the two may pick either of two tokens
# whose logits differ by at most two bf16 ulps at the top logit's magnitude
# (weights N(0, 1/fan_in) over a unit-RMS hidden state give logits ~N(0, 1);
# the top of 128256 sits in [4, 8), where an ulp is 2^-5). A fault in the
# pages moves the logits by far more than that
NEAR_TIE = 2.0 ** -4 + 1e-5     # + the f32 rounding of two log-softmaxes


def aggregated_run(engine, rid: str, req) -> tuple:
    """The plain aggregated engine's stream for `req`, with each token's
    top logprobs ([(token id, logprob)], best first)."""
    from dynamo_tpu_torch.engine.sampler import TOP_LOGPROBS
    from dynamo_tpu_torch.engine.scheduler import EngineRequest
    engine.add_request(EngineRequest(rid, req.prompt, dataclasses.replace(
        req.params, logprobs=TOP_LOGPROBS)))
    toks, tops, done = [], [], False
    while not done:
        for ev in engine.step():
            if ev.request_id == rid:
                if ev.token is not None:
                    toks.append(ev.token)
                    tops.append(ev.top_logprobs)
                done |= ev.finished
    return toks, tops


def divergence(toks: list, agg: list, tops: list):
    """None when a stream equals the aggregated engine's `agg`; else the
    first position where it left it and the logprob gap there between the
    aggregated engine's best token and the stream's (inf when the stream's
    token is not among the top logprobs, or one stream stopped first)."""
    for j, (x, y) in enumerate(zip(toks, agg)):
        if x != y:
            return j, tops[j][0][1] - dict(tops[j]).get(x, -math.inf)
    return None if len(toks) == len(agg) else (min(len(toks), len(agg)),
                                               math.inf)


def disagg_reference(engine, rid: str, req) -> list:
    """The disaggregated path inside one engine: a prefill-only run parks
    the prompt's pages, an up-front allocation takes them (extract + inject
    on the same engine) and activates with the first token, and the request
    decodes to its end: the computation the two workers split between
    them, step for step (the one-token chunk that writes the first token's
    KV is a prefill step there too). Returns the emitted tokens."""
    import dataclasses as dc
    from dynamo_tpu_torch.engine.scheduler import EngineRequest
    first = None
    engine.add_request(dc.replace(req, request_id=f"{rid}-p",
                                  prefill_only=True))
    while first is None:
        for ev in engine.step():
            if ev.request_id == f"{rid}-p":
                first = ev.token
    p = req.params
    if first in p.stop_token_ids or (not p.ignore_eos and first
                                     in engine.eos_token_ids):
        engine.release_parked(f"{rid}-p")
        return []
    if p.max_tokens <= 1:
        engine.release_parked(f"{rid}-p")
        return [first]
    alloc = engine.allocate_remote(EngineRequest(rid, req.prompt, p))
    start = alloc.num_cached_tokens // engine.cfg.page_size
    pages = engine.extract_pages(
        engine.scheduler.parked[f"{rid}-p"].pages[start:])
    engine.inject_pages(alloc.page_ids[start:], pages["k"], pages["v"],
                        pages.get("k_scale"), pages.get("v_scale"),
                        ready=pages["ready"])
    engine.release_parked(f"{rid}-p")
    engine.activate_remote(rid, first)
    out, done = [first], False
    while not done:
        for ev in engine.step():
            if ev.request_id == rid:
                if ev.token is not None:
                    out.append(ev.token)
                done |= ev.finished
    return out


def phase_disagg(smi: str, model: str = "llama3-8b", device: str = "cuda",
                 scale: float = 1.0, device_name: str = None,
                 max_model_len: int = 0) -> dict:
    """Phase 12 (see the docstring at the top): the reference tokens from an
    aggregated engine, then the SDK supervisor serving the disaggregated
    graph as processes, the traffic and the checks, then SIGTERM to the
    supervisor (every service drains and exits 0)."""
    import signal
    import torch
    from dynamo_tpu_torch.engine.config import get_model_config
    from dynamo_tpu_torch.examples.disagg.graph import _build
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.llm.worker import to_engine_request
    from dynamo_tpu_torch.protocols.common import to_wire
    from dynamo_tpu_torch.protocols.openai import ChatCompletionRequest
    t_phase = time.perf_counter()
    cfg = disagg_config(model, device, scale, max_model_len)
    root = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(root, "build"), exist_ok=True)
    path = os.path.join(root, "build", "disagg_config.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    # the card the decode worker registers (its context is the engine's
    # max_model_len, so no prompt's max_tokens is clamped)
    card = dataclasses.replace(
        ModelDeploymentCard(name=model, arch=model),
        context_length=cfg["DecodeWorker"]["max_model_len"])
    pre = OpenAIPreprocessor(card)
    # the references: an aggregated engine with the decode worker's config
    # on the same seed-0 weights serves round A's prompts one at a time,
    # first plainly with its top logprobs, then through its own
    # disaggregation hooks
    from dynamo_tpu_torch.engine.scheduler import Scheduler
    _, engine = _build(cfg["DecodeWorker"])
    reference = {}
    for i, n in enumerate(ROUND_A):
        body = disagg_body(model, n, 200 + i, False, False, scale)
        p, _ = pre.preprocess_chat(ChatCompletionRequest.from_json(body),
                                   request_id=f"A-{i}")
        req = to_engine_request(p)
        reference[p.request_id] = {
            "pre": to_wire(p), "req": req,
            "aggregated": aggregated_run(engine, f"agg-{i}", req)}
    # a fresh page allocator: no prefix of the plain runs is reused
    engine.scheduler = Scheduler(engine.cfg)
    engine._dec_state = None
    for rid, ref in reference.items():
        ref["tokens"] = disagg_reference(engine, rid, ref.pop("req"))
    del engine
    if device == "cuda":
        torch.cuda.empty_cache()
    children = []
    try:
        sup = Child("disagg supervisor", [
            "dynamo_tpu_torch.sdk.serve", DISAGG_GRAPH, "-f", path,
            "--start-control-plane", "--control-port", "0"], session=True)
        children.append(sup)
        ready = sup.wait_line("READY graph=", 900)
        ready_s = time.perf_counter() - t_phase
        cp_port = int(ready.rsplit("control-port=", 1)[1])
        fe_port = int(next(x for x in sup.lines if "FRONTEND http=:" in x)
                      .rsplit(":", 1)[1])
        for tag in ("DECODE", "PREFILL"):
            line = next(x for x in sup.lines if f"] {tag} device=" in x)
            dev = line.split(" device=", 1)[1].split(" engine_id=")[0]
            check(dev == device_name, f"{tag} worker on {dev!r}, expected "
                  f"{device_name!r}: {line}")
        rec = asyncio.run(asyncio.wait_for(drive_disagg(
            cp_port, fe_port, model, scale,
            get_model_config(model).num_layers, reference, pre,
            card.kv_page_size, cfg["DecodeWorker"][
                "max_local_prefill_length"], smi, device == "cuda"), 900))
        sup.proc.send_signal(signal.SIGTERM)
        code = sup.stop(None, 300)
        exits = [x for x in sup.lines if x.startswith("EXIT service=")]
        check(code == 0 and len(exits) == 4
              and all(x.endswith(" code=0") for x in exits),
              f"supervisor exited {code}: {exits}\n{sup.tail()}")
        for tag in ("decode", "prefill"):
            line = [x for x in sup.lines if f"] EXIT {tag} " in x]
            check(len(line) == 1 and "logits_nonfinite_steps=0" in line[0],
                  f"{tag} worker: {line or sup.tail()}")
        rec["ready_s"] = ready_s
        rec["phase_s"] = time.perf_counter() - t_phase
        print(f"disaggregated deployment: READY in {ready_s:.1f} s; SIGTERM "
              f"drained every service: {exits}; phase {rec['phase_s']:.1f} "
              f"s", flush=True)
        return rec
    finally:
        # a failed check leaves the deployment up: SIGTERM lets the
        # supervisor stop its services; then the whole group is killed
        for c in reversed(children):
            c.stop(signal.SIGTERM, 120)
        if children:
            # the services' whole output, for reading after the run
            with open(os.path.join(root, "build", "disagg_supervisor.log"),
                      "w") as f:
                f.write("\n".join(children[0].lines) + "\n")


# -- phase 13: the KV tiers -----------------------------------------------------

TIER_MAX_TOKENS = 32
TIER_QUESTION = 64
# llama3-8b on the card: T's HBM, host and disk pages, O's HBM pages, the
# int8 T's HBM pages, the shared-pool engines' pages and the history
# lengths in tokens; `tier_sizes` scales them for a rehearsal on the CPU
TIER_SIZES = dict(t_pages=160, host=48, disk=256, o_pages=512, t8_pages=64,
                  p_pages=160, lo=1536, hi=2048, convs=8, convs8=4)


def tier_sizes(scale: float) -> dict:
    s = dict(TIER_SIZES)
    if scale != 1.0:
        for k in ("t_pages", "host", "o_pages", "t8_pages", "p_pages",
                  "lo", "hi"):
            s[k] = max(2, int(s[k] * scale))
        s["o_pages"] = max(s["o_pages"], 64)
    return s


def tier_tokens(length: int, seed: int, vocab: int) -> list:
    """`length` random token ids from a seed."""
    import numpy as np
    return np.random.default_rng(seed).integers(
        1, vocab, size=length).tolist()


def tier_histories(n: int, lo: int, hi: int, seed: int, vocab: int) -> list:
    """n conversation histories of lo-hi random token ids (from a seed)."""
    import numpy as np
    lens = np.random.default_rng(seed).integers(lo, hi + 1, size=n)
    return [tier_tokens(int(x), seed + 1 + i, vocab)
            for i, x in enumerate(lens)]


def tier_serve(engine, rid: str, prompt: list) -> dict:
    """One request alone on the engine, greedy, TIER_MAX_TOKENS tokens
    (ignore_eos): its tokens, its TTFT (add_request to the first token's
    event, host clock) and its prefix hits (full pages matched in any
    tier)."""
    from dynamo_tpu_torch.engine.scheduler import (
        EngineRequest, SamplingParams,
    )
    hits0 = engine.scheduler._prefix_hits
    t0 = time.perf_counter()
    engine.add_request(EngineRequest(rid, list(prompt), SamplingParams(
        max_tokens=TIER_MAX_TOKENS, temperature=0.0, ignore_eos=True)))
    out, ttft, done = [], None, False
    while not done:
        for ev in engine.step():
            if ev.request_id != rid:
                continue
            if ev.token is not None:
                out.append(ev.token)
                ttft = ttft or time.perf_counter() - t0
            done |= ev.finished
    while engine.has_work():
        engine.step()
    return {"tokens": out, "ttft_s": ttft,
            "hits": engine.scheduler._prefix_hits - hits0}


def page_chain(tokens: list, n: int, page: int) -> list:
    from dynamo_tpu_torch.engine.kv_cache import page_hash
    parent, out = 0, []
    for i in range(n):
        parent = page_hash(parent, tokens[i * page:(i + 1) * page])
        out.append(parent)
    return out


def same_pages(a, b, tokens: list, n: int, label: str) -> int:
    """The n leading pages of `tokens` in engine a's cache and in engine
    b's (found by hash, wherever they sit), byte for byte on every leaf.
    Returns the bytes compared."""
    import torch
    hashes = page_chain(tokens, n, a.cfg.page_size)
    ids = []
    for eng in (a, b):
        pids = [eng.scheduler.allocator.lookup(h) for h in hashes]
        check(None not in pids, f"{label}: a page is not in HBM: {pids}")
        ids.append(pids)
    pa, pb = a.extract_pages(ids[0]), b.extract_pages(ids[1])
    if a.device.type == "cuda":
        torch.cuda.synchronize()
    nbytes = 0
    for key in a.cache:
        x, y = pa[key][:, :, :n], pb[key][:, :, :n]
        check(x.dtype == y.dtype and x.shape == y.shape
              and torch.equal(x.contiguous().view(torch.uint8),
                              y.contiguous().view(torch.uint8)),
              f"{label}: {key} of {n} onboarded pages differ from the "
              "oracle's")
        nbytes += x.numel() * x.element_size()
    return nbytes


def tier_run(engine, name: str, histories: list, questions: list,
             vocab: int, warm: bool = True, after_turn2=None) -> dict:
    """Phase 13's traffic on one engine as its own path: a warm-up of two
    requests (random prompts at the shortest and the longest page bucket
    the turns reach, so that every window graph is captured first), then
    turn 1 (each history, one at a time) and turn 2 (history + its 32
    generated ids + a 64-token question, in order). The launch counts are
    set to 0 after the warm-up and read at the end: num_layers x decode
    steps, and no graph captured (with warm=True)."""
    import torch
    from dynamo_tpu_torch.ops import paged_attention as pa
    gr, cfg = engine.graphs, engine.model_cfg
    ps = engine.cfg.page_size
    if warm:
        lo = min(len(h) for h in histories)
        hi = max(len(h) for h in histories) + TIER_MAX_TOKENS + TIER_QUESTION
        for i, n in enumerate((lo, hi)):
            tier_serve(engine, f"{name}-warm-{i}",
                       tier_tokens(n, 9000 + i, vocab))
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    g0 = (gr.captured, gr.warmup_launches[RAGGED])
    steps0 = engine.decode_window_steps
    t0 = time.perf_counter()
    turn1 = [tier_serve(engine, f"{name}-c{i}-t1", h)
             for i, h in enumerate(histories)]
    turn2 = []
    for i, h in enumerate(histories):
        turn2.append(tier_serve(engine, f"{name}-c{i}-t2",
                                h + turn1[i]["tokens"] + questions[i]))
        if after_turn2 is not None:
            after_turn2(i, turn2[-1])
    wall = time.perf_counter() - t0
    launches = pa.KERNEL_LAUNCHES
    steps = engine.decode_window_steps - steps0
    captured = gr.captured - g0[0]
    warm_launches = gr.warmup_launches[RAGGED] - g0[1]
    for i, h in enumerate(histories):
        check(len(turn1[i]["tokens"]) == TIER_MAX_TOKENS
              and len(turn2[i]["tokens"]) == TIER_MAX_TOKENS,
              f"{name}: conversation {i} stopped early")
    if engine.device.type == "cuda":
        check(launches == cfg.num_layers * steps + warm_launches
              and steps > 0,
              f"{name}: ragged launches {launches}, expected num_layers x "
              f"decode steps = {cfg.num_layers} x {steps} + {warm_launches}")
        if warm:
            check(captured == 0, f"{name}: {captured} window graphs "
                  "captured after the warm-up")
    peak = (torch.cuda.max_memory_allocated() / 2**30
            if engine.device.type == "cuda" else 0.0)
    return {"turn1": turn1, "turn2": turn2, "launches": launches,
            "decode_steps": steps, "captured": captured, "wall_s": wall,
            "peak_gib": peak}


def quantiles(xs: list) -> dict:
    import numpy as np
    return {"p50_ms": float(np.percentile(xs, 50)) * 1e3,
            "p90_ms": float(np.percentile(xs, 90)) * 1e3}


def first_difference(a: list, b: list):
    for j, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return j
    return None if len(a) == len(b) else min(len(a), len(b))


def pool_recording(engine) -> bool:
    """Does a fresh allocation on the engine's stream land in a graph
    memory pool (segment pool id other than (0, 0))?"""
    import torch
    with engine._on_stream():
        t = torch.empty(64 << 20, dtype=torch.uint8, device=engine.device)
        ptr = t.data_ptr()
        for seg in torch.cuda.memory_snapshot():
            if seg["address"] <= ptr < seg["address"] + seg["total_size"]:
                return tuple(seg["segment_pool_id"]) != (0, 0)
    return True


def phase_failed_capture(engine, vocab: int) -> dict:
    """Tentpole 0 on the card: 8 greedy requests decode; their next window
    is run through `engine.graphs.run` under a new key with a program that
    raises partway through its capture (after the whole window program),
    then with one that breaks the capture (a host sync inside it). Each
    must raise, leave no graph under the key, and leave the stream's
    allocations outside every graph pool. Then the real program under the
    same key captures and replays: its tokens must equal the eager
    window's on clones of the cache and inputs. The requests are aborted
    at the end."""
    import torch
    from dynamo_tpu_torch.engine.scheduler import (
        DecodePlan, EngineRequest, SamplingParams,
    )
    gr = engine.graphs
    rids = []
    for i in range(engine.cfg.max_slots):
        rid = f"fc-{i}"
        engine.add_request(EngineRequest(rid, tier_tokens(
            100 + 40 * i, 7000 + i, vocab), SamplingParams(
                max_tokens=64, temperature=0.0, ignore_eos=True)))
        rids.append(rid)
    while engine.scheduler.waiting or engine._pipeline is not None:
        engine.step()
    out = {}
    with engine._on_stream():
        plan = engine.scheduler.schedule()
        check(isinstance(plan, DecodePlan)
              and all(q is not None for q in plan.seqs),
              "failed capture: the next step is not a full decode window")
        samp = engine._sampling_arrays(plan.seqs)
        staged = engine._stage_window(plan, samp, None, False, True, False)
        program = engine._window_program(staged)
        key = ("failed-capture",) + staged["key"]
        for kind in ("raise", "sync"):
            captured0 = gr.captured

            def bad(b, kind=kind):
                outs = program(b)
                if torch.cuda.is_current_stream_capturing():
                    if kind == "raise":
                        raise RuntimeError("injected failure inside capture")
                    b["tokens"].sum().item()   # a host sync: not capturable
                return outs
            try:
                gr.run(key, bad, staged["bufs"])
            except RuntimeError as e:
                out[kind] = str(e).splitlines()[0][:160]
            else:
                check(False, f"failed capture ({kind}): run did not raise")
            check(key not in gr.captured_calls() and gr.captured == captured0,
                  f"failed capture ({kind}): a graph was kept")
            check(not pool_recording(engine),
                  f"failed capture ({kind}): the graph pool still takes the "
                  "engine stream's allocations")
        engine._sync_stream()
        want = eager_window(
            engine, staged, {k: v.clone() for k, v in staged["bufs"].items()},
            {k: v.clone() for k, v in engine.cache.items()})
        captured0 = gr.captured
        outs = gr.run(key, program, staged["bufs"])
        got = outs[0].cpu().numpy()
        check(gr.captured == captured0 + 1,
              "failed capture: the next run did not capture")
        check((got == want).all(),
              f"failed capture: the replay after the failures gave "
              f"{got.T.tolist()}, the eager window {want.T.tolist()}")
        check(not pool_recording(engine),
              "failed capture: the pool is recording after the replay")
    engine._dec_state = None
    for rid in rids:
        engine.abort(rid)
    while engine.has_work():
        engine.step()
    engine._sync_stream()
    out["tokens_equal"] = int(got.size)
    print(f"failed capture: both failures raised ({json.dumps(out)}), no "
          f"graph kept, pool not recording; the next capture replayed "
          f"{got.size} tokens equal to the eager window", flush=True)
    return out


def phase_tiers(smi: str, model: str = "llama3-8b", device: str = "cuda",
                scale: float = 1.0, device_name: str = None) -> dict:
    """Phase 13 (see the docstring at the top)."""
    import shutil
    import torch
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import NativeEngine
    from dynamo_tpu_torch.engine.kv_pool import POOL_STATS, SharedKvPool
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.run import build_card
    from dynamo_tpu_torch.runtime.integrity import STATS as INTEGRITY
    t_phase = time.perf_counter()
    sz = tier_sizes(scale)
    card = build_card(model)
    cfg = card.model_config()
    vocab = cfg.vocab_size
    root = os.path.dirname(os.path.abspath(__file__))
    disk_root = os.path.join(root, "build", "kv_tiers")
    shutil.rmtree(disk_root, ignore_errors=True)
    params = llama.init_params(cfg, device, 0)
    ps = card.kv_page_size
    hists = tier_histories(sz["convs"], sz["lo"], sz["hi"], 100, vocab)
    questions = [tier_tokens(TIER_QUESTION, 200 + i, vocab)
                 for i in range(sz["convs"])]
    expect = [(len(h) + TIER_MAX_TOKENS - 1) // ps for h in hists]
    i0 = dataclasses.asdict(INTEGRITY)

    def build(num_pages, host=0, disk=0, tag="", kv_quant=""):
        return NativeEngine(cfg, EngineConfig(
            page_size=ps, num_pages=num_pages, host_pages=host,
            disk_pages=disk, kv_quant=kv_quant, max_model_len=4096,
            disk_dir=os.path.join(disk_root, tag) if disk else None),
            params=params, eos_token_ids=set(card.eos_token_ids),
            device=device)

    def gate_hits(run, label, exp):
        got = [r["hits"] for r in run["turn2"]]
        check(got == exp, f"{label}: turn-2 prefix hits {got}, expected "
              f"{exp} (the sealed pages of each turn-1 stream)")
        check(all(r["hits"] == 0 for r in run["turn1"]),
              f"{label}: a turn-1 request hit a cached page")

    rec = {"sizes": sz, "expected_hits": expect}
    # O: every turn-2 prefix is an HBM hit
    oracle = build(sz["o_pages"])
    o = tier_run(oracle, "O", hists, questions, vocab)
    gate_hits(o, "O", expect)
    # T: HBM -> host -> disk and back
    tiered = build(sz["t_pages"], sz["host"], sz["disk"], "T")
    checked = {}

    def t_after(i, r):
        if i == 0:
            checked["bytes"] = same_pages(
                tiered, oracle, hists[0] + o["turn1"][0]["tokens"],
                expect[0], "T conversation 0")
    t = tier_run(tiered, "T", hists, questions, vocab, after_turn2=t_after)
    gate_hits(t, "T", expect)
    for turn in ("turn1", "turn2"):
        for i in range(len(hists)):
            check(t[turn][i]["tokens"] == o[turn][i]["tokens"],
                  f"T {turn} conversation {i}: stream differs from O's at "
                  f"{first_difference(t[turn][i]['tokens'], o[turn][i]['tokens'])}")
    hp = tiered.host_pool
    st = dataclasses.asdict(hp.stats)
    integ = {k: v - i0[k] for k, v in dataclasses.asdict(INTEGRITY).items()}
    check(st["offloaded"] > 0 and st["disk_offloaded"] > 0
          and st["disk_hits"] > 0 and st["onboarded"] == st["host_hits"] > 0
          and st["put_dropped"] == 0 and st["failed"] == 0
          and integ["mismatches"] == 0 and integ["quarantined"] == 0,
          f"T tier counters {st}, integrity {integ}")
    times = hp.times.snapshot()
    failed_capture = (phase_failed_capture(tiered, vocab)
                      if device == "cuda" else None)
    tiered.close()
    rec["T"] = {"stats": st, "integrity": integ, "times": times,
                "pinned_bytes": hp.pinned_bytes,
                "page_bytes": tiered.metrics().kv_page_bytes,
                "onboard_checked_bytes": checked["bytes"]}
    del tiered, hp, oracle
    if device == "cuda":
        torch.cuda.empty_cache()
    # R: the same traffic with no tier, every evicted prefix recomputed
    recompute = build(sz["t_pages"])
    r = tier_run(recompute, "R", hists, questions, vocab, warm=False)
    r_diff = [first_difference(r["turn2"][i]["tokens"],
                               o["turn2"][i]["tokens"])
              for i in range(len(hists))]
    del recompute
    # int8 pages through both tiers
    n8 = sz["convs8"]
    o8e = build(sz["o_pages"], kv_quant="int8")
    o8 = tier_run(o8e, "O int8", hists[:n8], questions, vocab)
    t8e = build(sz["t8_pages"], sz["host"], sz["disk"], "T8", "int8")
    checked8 = {}

    def t8_after(i, r8):
        if i == 0:
            checked8["bytes"] = same_pages(
                t8e, o8e, hists[0] + o8["turn1"][0]["tokens"], expect[0],
                "T int8 conversation 0")
    t8 = tier_run(t8e, "T int8", hists[:n8], questions, vocab,
                  after_turn2=t8_after)
    gate_hits(o8, "O int8", expect[:n8])
    gate_hits(t8, "T int8", expect[:n8])
    for turn in ("turn1", "turn2"):
        for i in range(n8):
            check(t8[turn][i]["tokens"] == o8[turn][i]["tokens"],
                  f"T int8 {turn} conversation {i}: stream differs from "
                  "O int8's")
    st8 = dataclasses.asdict(t8e.host_pool.stats)
    check(st8["offloaded"] > 0 and st8["onboarded"] == st8["host_hits"] > 0
          and st8["put_dropped"] == 0 and st8["failed"] == 0,
          f"T int8 tier counters {st8}")
    rec["T_int8"] = {"stats": st8, "times": t8e.host_pool.times.snapshot(),
                     "pinned_bytes": t8e.host_pool.pinned_bytes,
                     "onboard_checked_bytes": checked8["bytes"]}
    t8e.close()
    del t8e, o8e
    # the shared pool: P1 publishes, P2 fetches
    POOL_STATS.reset()
    pool = SharedKvPool(capacity_pages=4 * 64)
    p1 = build(sz["p_pages"])
    p1.attach_kv_pool(pool, "P1")
    p_hists = hists[:4]
    first = [tier_serve(p1, f"P1-{i}", h) for i, h in enumerate(p_hists)]
    p1.drain_kv_events()
    p1._pool_stream.drain()
    again = [tier_serve(p1, f"P1-again-{i}", h)
             for i, h in enumerate(p_hists)]
    p2 = build(sz["p_pages"])
    p2.attach_kv_pool(pool, "P2", publish=False)
    served = [tier_serve(p2, f"P2-{i}", h) for i, h in enumerate(p_hists)]
    want_fetch = sum((len(h) - 1) // ps for h in p_hists)
    pst = POOL_STATS.snapshot()
    for i in range(len(p_hists)):
        check(served[i]["tokens"] == again[i]["tokens"],
              f"P2 request {i}: stream differs from P1's at "
              f"{first_difference(served[i]['tokens'], again[i]['tokens'])}")
    check(p2.scheduler.pool_fetched_pages == want_fetch
          and pst["quarantined"] == 0 and pst["quant_rejected"] == 0
          and p1._pool_stream.failed == 0,
          f"P2 fetched {p2.scheduler.pool_fetched_pages} pages, expected "
          f"{want_fetch}; pool {pst}")
    rec["pool"] = {"stats": pst, "fetched": want_fetch,
                   "p2_equals_p1_first": sum(
                       served[i]["tokens"] == first[i]["tokens"]
                       for i in range(len(p_hists))),
                   "p2_ttft": quantiles([x["ttft_s"] for x in served]),
                   "p1_first_ttft": quantiles([x["ttft_s"] for x in first])}
    p1.close()
    p2.close()
    del p1, p2, pool, params
    shutil.rmtree(disk_root, ignore_errors=True)
    if device == "cuda":
        torch.cuda.empty_cache()
    for label, run in (("T", t), ("O", o), ("R", r), ("T int8", t8),
                       ("O int8", o8)):
        rec.setdefault("runs", {})[label] = {
            "turn2_ttft": quantiles([x["ttft_s"] for x in run["turn2"]]),
            "turn1_ttft": quantiles([x["ttft_s"] for x in run["turn1"]]),
            "turn2_hits": [x["hits"] for x in run["turn2"]],
            "launches": run["launches"], "decode_steps": run["decode_steps"],
            "captured": run["captured"], "wall_s": run["wall_s"],
            "peak_gib": run["peak_gib"]}
    rec["R_first_difference"] = r_diff
    rec["failed_capture"] = failed_capture
    tm = rec["T"]["times"]
    rec["rates"] = {
        "d2h_gb_s": tm["d2h_bytes"] / tm["d2h_s"] / 1e9 if tm["d2h_s"] else 0,
        "h2d_gb_s": tm["h2d_bytes"] / tm["h2d_s"] / 1e9 if tm["h2d_s"] else 0,
        "verify_ms_per_page": tm["verify_s"] / max(1, tm["verify_pages"]) * 1e3,
        "onboard_split_ms_per_batch": {
            "verify": tm["verify_s"] / max(1, tm["onboard_batches"]) * 1e3,
            "h2d": tm["h2d_s"] / max(1, tm["onboard_batches"]) * 1e3,
            "inject": tm["inject_s"] / max(1, tm["onboard_batches"]) * 1e3},
        "spill_ms_per_page": tm["spill_s"] / max(1, tm["spill_pages"]) * 1e3,
        "promote_ms_per_page": (tm["promote_s"] / max(1, tm["promote_pages"])
                                * 1e3),
        "settle_ms": tm["settle_s"] * 1e3}
    rec["phase_s"] = time.perf_counter() - t_phase
    st = rec["T"]["stats"]
    mib = rec["T"]["page_bytes"] / 2**20
    print(f"KV tiers [{smi}]: T/O/R turn-2 TTFT p50 / p90 "
          + ", ".join(f"{k} {v['turn2_ttft']['p50_ms']:.1f} / "
                      f"{v['turn2_ttft']['p90_ms']:.1f} ms"
                      for k, v in rec["runs"].items())
          + f"; T offloaded {st['offloaded']} pages "
          f"({st['offloaded'] * mib:.0f} MiB), onboarded {st['onboarded']} "
          f"({st['onboarded'] * mib:.0f} MiB), disk spills "
          f"{st['disk_offloaded']}, disk hits {st['disk_hits']}; "
          f"rates {json.dumps(rec['rates'])}; pinned host "
          f"{rec['T']['pinned_bytes']} bytes; R's turn-2 first difference "
          f"from O {r_diff}; pool fetched {want_fetch} pages, P2 == P1's "
          f"repeat; phase {rec['phase_s']:.1f} s", flush=True)
    return rec


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one "
              "card", file=sys.stderr)
        return 2
    from dynamo_tpu_torch.ops import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    print(f"device: {smi}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    logs = build.build()
    print(f"build: {sorted(logs) or 'cached'} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in ptxas_lines(log):
            print(f"  {name}: {line}", flush=True)
            check(" 0 bytes spill stores" in line or "spill" not in line,
                  f"{name}: ptxas spills: {line}")

    err_bf16 = phase_kernel()
    err_int8 = phase_kernel_int8()
    err_legacy = phase_legacy()
    err_w8, w8_timing, dequant_timing = phase_w8a16()
    phase_small_reference()
    phase_small_reference("int8")
    phase_small_reference(quant="int8")
    engine, first, _ = asyncio.run(serve_main_path(smi))
    bf16_ref = {"weight_bytes": engine.metrics().weight_bytes,
                "peak_gib": first["stats"]["peak_gib"]}
    graph_bf16 = phase_graph_vs_eager(engine, "bf16")
    main_err, timing, leg_err, legacy_full = phase_timing(
        engine, first["n_prompt"], MAX_TOKENS)
    # the other engines share the weights; the bf16 cache goes first, so
    # their runs' peak memory is their own
    engine.cache = None
    torch.cuda.empty_cache()
    phase_depth_one(smi, engine.params, first)
    engine_q, first_q, _ = asyncio.run(
        serve_main_path(smi, "int8", params=engine.params))
    graph_int8 = phase_graph_vs_eager(engine_q, "int8")
    main_err_q, timing_q, leg_err_q, _ = phase_timing(
        engine_q, first_q["n_prompt"], MAX_TOKENS)
    print(f"window graphs: {json.dumps({'bf16': graph_bf16, 'int8': graph_int8})}",
          flush=True)
    err_legacy = max(err_legacy, leg_err, leg_err_q)
    del engine_q
    torch.cuda.empty_cache()
    legacy = {model: phase_legacy_timing(model)
              for model in ("llama3-8b", "llama3-1b")}
    phase_parity(engine)
    del engine
    torch.cuda.empty_cache()
    ab = {model: phase_ab(model) for model in ("llama3-8b", "llama3-1b")}
    http = asyncio.run(phase_http(smi, bf16_ref))
    entry = phase_entry_point()
    print(f"HTTP path: {json.dumps({'runs': http, 'entry_point': entry})}",
          flush=True)
    dist = phase_distributed(smi, device_name=torch.cuda.get_device_name(0))
    print(f"distributed path: {json.dumps(dist)}", flush=True)
    disagg = phase_disagg(smi, device_name=torch.cuda.get_device_name(0))
    print(f"disaggregated deployment: {json.dumps(disagg)}", flush=True)
    tiers = phase_tiers(smi, device_name=torch.cuda.get_device_name(0))
    print(f"KV tiers: {json.dumps(tiers)}", flush=True)

    ragged = {"name": "ragged_decode_attention", "route": "cuda",
              "source": "dynamo_tpu_torch/csrc/ragged_decode_attention.cu",
              "replaces": "dynamo_tpu/ops/paged_attention.py:88",
              "launches": first["launches"],
              "max_abs_err": max(err_bf16, main_err), **timing,
              "distributed_launches": dist["launches"],
              "disagg_launches": disagg["launches"],
              "tiers_launches": {k: v["launches"]
                                 for k, v in tiers["runs"].items()},
              "int8": {"launches": first_q["launches"],
                       "max_abs_err": max(err_int8, main_err_q),
                       **timing_q}}
    records = [ragged]
    for model, row, line in (("llama3-8b", 2, 37), ("llama3-1b", 3, 116)):
        err, tm = legacy[model]
        if row == 2:  # hd 128 at the full context, beside the ragged kernel
            tm = {**tm, "full_context": legacy_full}
        records.append({
            "name": f"legacy_decode_attention (hd "
                    f"{ab[model][0]['head_dim']}, row {row})",
            "route": "cuda",
            "source": "dynamo_tpu_torch/csrc/legacy_decode_attention.cu",
            "replaces": f"dynamo_tpu/ops/paged_attention_oracle.py:{line}",
            "launches": ab[model][1]["legacy"],
            "max_abs_err": max(err_legacy, err), **tm})
    first_http = http["capturing"]
    source = "dynamo_tpu_torch/csrc/w8a16_gemm.cu"
    records.append({
        "name": "w8a16_gemm", "route": "cuda", "source": source,
        "replaces": "dynamo_tpu/ops/quant.py:70 (wmat, fused by XLA into the "
                    "matmul; no Pallas kernel)",
        "launches": first_http["launches"][W8A16], "max_abs_err": err_w8,
        **w8_timing})
    records.append({
        "name": "w8a16_dequant", "route": "cuda", "source": source,
        "replaces": "dynamo_tpu/ops/quant.py:70 (wmat; no Pallas kernel)",
        "launches": first_http["launches"]["w8a16_dequant"],
        "max_abs_err": 0.0, **dequant_timing})
    print(json.dumps({"kernels": records}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
