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
      and l = ps exactly on every empty row); since PR 15 also 8 rows at
      the heads of Gemma-7B (16 / 16 x 256), Phi-3-mini (32 / 32 x 96),
      Gemma-2-9B (16 / 8 x 256) and GQA groups of 12 and 16 (hd 128), and
      at Qwen2-VL-7B's (28 / 4 x 128: a group of 7, one head block with a
      masked eighth row), and at one tensor-parallel rank's (llama3-70b at
      tp 4: 16 / 2 x 128; llama3-8b at tp 2: 16 / 4 x 128; phase 22);
      recycled page tails filled with NaN. Both compute
      the f32 state, so only summation order differs: rtol = atol = 1e-4
      for f32 caches and 2e-3 for bf16 caches. The prefix fold and the
      inclusive division are compared in f32, before the one cast to q's
      dtype that both sides share (fold_f32). At those eight geometries the
      kernel is then timed
      (CUDA events over a replayed graph) at 8 rows of 400 tokens with bf16
      and int8 pages beside its bound (K + V bytes over 3.35 TB/s), its
      plain version and the library yardstick (gather + SDPA);
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
   d. the grouped W8A16 decode kernel (csrc/w8a16_gemm.cu `w8a16_group`)
      against its plain version (`x @ wmat(w)`, computed in f32 from the
      same rounded weights) at every llama3-8b group of products that
      share an input (wq | wk | wv, wo, w_gate | w_up, w_down, lm_head)
      and at odd groups (1000 x 333, 4100 x 1031, and 333 | 1031 | 128 of
      one K = 1000: N % 16 != 0 streams without TMA), M = 1, 3, 8, 9 and
      16, bf16 x, its output memory NaN-filled just before each call, max
      |diff| <= 1e-2 * max |y|, and a second call bit-equal to the first;
      the per-weight entry (its f32 CUDA-core kernel at M = 1 and 8 with
      rtol = atol = 1e-4 at every shape and M = 1, 3, 8, 16 at the odd
      ones; its register-ring bf16 kernel, the old decode kernel, at M =
      8). Then the tensor-core kernel (csrc/w8a16_large_m.cu, the route
      past GEMV_MAX_M rows) against the plain version at the eight shapes
      at M = 9, 16, 64, 100, 512 and 2048, bf16, its output memory
      NaN-filled before each call, within the bf16 tolerance; at the odd
      shapes linear past GEMV_MAX_M raises (TMA needs N % 16 == 0 and K %
      8 == 0). At M = 512 (w_gate) linear launches the tensor-core kernel
      once and the dequantize entry never, and its output is no longer
      bit-equal to the dequantize + matmul route; an f32 x keeps that route
      (the entry bit-identical to `wmat`); at M = 8 linear_group is one
      grouped launch. Then CUDA-event times over replayed graphs (weights
      cycled past the L2) for each group at M = 8: the grouped kernel, its
      bound (its bytes over 3.35 TB/s), its share of the bound, the
      grouped kernel at M = 16, the old per-weight kernel (one launch a
      weight), the plain version, and torch.matmul on the bf16 weights
      (separate products, and one product on the concatenated weight),
      summed over a decode step; the launch-cost split at wk, w_gate and
      lm_head (tools/torch_w8a16_probe.py: an empty launch of each
      kernel's grid, the old grid streaming its weights only, both kernels
      in full); the tensor-core kernel at w_gate at M =
      16, 128 and 512 beside its bound (the larger of its bytes over 3.35
      TB/s and 2 M K N over 989 TFLOP/s), the plain version, the library
      and the old route (dequantize + torch.matmul); the switch-point table
      (the grouped kernel up to M = 16, the old decode kernel and the
      tensor-core kernel at M = 8, 9, 16, 32, 64 for w_gate and wk); one
      512-token prefill step's 7 x 32 products on the tensor-core kernel,
      the old route and torch.matmul on bf16 weights; the dequantize entry
      alone.
3. Small reference: the `tiny` model in f32, decode logits on the card
   (the kernels) against the same step on the CPU (the plain versions),
   within 1e-3, and the same greedy tokens from both engines; then the
   same with kv_quant="int8", and with quant="int8" (int8 weights: the
   W8A16 kernel on the card, and past GEMV_MAX_M rows the f32 route's
   dequantize entry, which this run must launch and the tensor-core
   kernel must not); then `tiny-moe` (4 experts, top 2) in f32
   and with quant="int8" (the grouped kernel's f32 path on the card).
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
   run. Then the step ledger's A/B on the same engine (`phase_ledger_ab`,
   `phase seconds: 4 ledger`): the 8 requests admitted together and
   stepped on the calling thread, once to settle, once with the ledger off
   (`engine.ledger.configure(enabled=False)`) and once with it on: equal
   tokens and equal pipeline counters; the disabled ledger records
   nothing; each decode sample charges rows x a window rung, the rungs add
   up to the committed window steps, and each step's sample counts the
   token events that step emitted (the rest of the streams' tokens came
   out of the prefill and mixed steps). Prints ms a decode step both ways.
   Then the budget tuner's leg on the same engine (`phase_budget_tuner`,
   `phase seconds: 4 tuner`): 10 short greedy prompts of 6-17 token ids,
   max_tokens 5-8, one admitted every 3 steps under the default mixed-step
   budget (512), so the mixed and prefill steps pad most of their
   [rows, bucket] tokens; after each step a MixedBudgetTuner
   (runtime/autoscaler.py; pad_lo 0.10, pad_hi 0.30, step_frac 0.25,
   bounds 128-4096, cooldown 4 s, hysteresis 2 windows, at least 64 padded
   tokens a window) ticks on a virtual clock of 2.5 s a step, and every
   adjustment is recomputed here (`TunerRule`) from the ledger's
   useful_total / padded_total read at that tick, without reading the
   tuner's state: the applied budgets must equal the recomputed ones, at
   least one adjustment happens, the budget never reaches 0, every stream
   ends with its max_tokens, no non-finite logits; the budget is restored.
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
   (4 L + 1) x nw W8A16 launches (one a group of products that share an
   input: q | k | v, o, gate | up, down, and the head;
   `decode_w8a16_launches`, from the model's structure) and L x nw ragged
   ones, the replays adding (4 L + 1) per decode step (the warm-ups come
   on top); the prefill and mixed steps launch the tensor-core kernel
   exactly as their shapes derive (7 L a step of B x T rows past
   GEMV_MAX_M, the head when its B rows are past it;
   `int8_product_launches`), the grouped decode kernel eagerly for the
   rest (4 L a step at or below GEMV_MAX_M rows), and the dequantize
   entry 0 times; GET /metrics
   showing llm_ttft_seconds_count equal to the choices served and a
   nonzero llm_itl_seconds_count. Then phase 4b on this engine (graph
   and eager windows give identical tokens; the untraced ms a decode
   step at int8 weights).
   Prints the TTFT and ITL p50 / p90 from the histograms beside the
   client-side TTFT of the streamed requests, decode tokens/s, peak
   memory and weight_bytes against phase 4's bf16 engine.
10. The entry point: `python -m dynamo_tpu_torch.run in=http:0 out=native
   tiny --quant int8` as a subprocess on the card; its READY line, one
   streamed chat ending in [DONE], then the subprocess is stopped; the same
   for `tiny-moe --quant int8` at the same time (phase 21's storms run
   beside both).
11. The distributed path at full width, as processes through the entry
   points, over an HA control-plane pair: a durable primary, `python -m
   dynamo_tpu_torch.runtime.transports.server --port 0` whose host and
   data directory A come from a DYN_CONFIG TOML file the phase writes
   (READY control-plane=:<port>), and its hot standby (the same file,
   DYN_CONTROL_PLANE__DATA_DIR=B over the file's A, `--port 0
   --standby-of 127.0.0.1:<port>`), which must answer the role probe
   `standby`, synced, epoch 1 before any worker starts; every child then
   names the pair in the comma form "127.0.0.1:<p>,127.0.0.1:<s>"
   (`--control-host` / `--coordinator`). Two workers started together,
   `python -m dynamo_tpu_torch.run in=endpoint:dynamo.llm.generate
   out=native llama3-8b --control-host <pair> --control-port <port>
   --mixed-token-budget 0 --max-prefill-batch 1` (llama3-8b at full width
   and depth, the same bf16 weights from seed 0 in both, bf16 KV pages,
   run.py's EngineConfig with prefill steps and decode windows
   alternating and one sequence a prefill step, so that no stream's
   arithmetic follows what arrived with it: 11k compares streams batched
   apart; each READY line names the card it runs on, which must be this
   card; the workers run with DYN_PEAK_TFLOPS = 989, the H100 SXM dense
   bf16 peak, for the step ledger's MFU); the standalone router service
   `python -m dynamo_tpu_torch.kv_router.main` (READY router
   indexer=native: its index runs the C++ radix tree, built with g++ from
   dynamo_tpu_torch/native/kv_indexer.cpp; its coordinator from the file,
   DYN_ROUTER__BLOCK_SIZE=64 over the file's 32) and exporter
   `python -m dynamo_tpu_torch.observability.exporter --port 0` (READY
   metrics=:<port>; its coordinator from the file, DYN_METRICS__INTERVAL
   =0.25 over the file's 0.5, the flag's port over the file's 9091) over
   the workers' endpoint; two frontends,
   `python -m dynamo_tpu_torch.frontend.serve --port 0 --control-port
   <port>`, one KV-routed and one with --no-kv-routing, each listing
   llama3-8b with two instances. The KV-routed frontend's router runs the
   JAX serving default, TransferAwareSelector. First a warm-up round through the
   KV-routed frontend, the traffic below on 4 other system prompts, so
   that the window graphs are captured before the measured rounds. Traffic
   through the KV-routed frontend:
   4 system prompts of 1024 byte-tokens (16 pages of 64), each followed
   by 4 distinct user turns of 64-192 byte-tokens, 16 chat requests of
   max_tokens 32 (8 greedy, 8 sampled with temperature 0.8, top_k 50 and
   a seed; 8 streamed, 8 unary). Wave 1 sends one request per prefix,
   concurrently; once the router scores every prefix on some worker
   (POST /router/match), wave 2 sends the other 12 concurrently. Before
   wave 1 both workers' $STATS read 0 active requests and the routers
   scrape twice more, so that the warm-up's tail does not skew where the
   prefixes land. Checks: every request finishes with 32 tokens or a
   stop; for each of the 16 decisions (GET /router/state, keyed by the
   x-request-id each request carries, in the router's order;
   `routing_gate`): (a) each candidate's recorded matched pages equal
   those derived from the token ids and from the worker that served the
   prefix (a wave-2 request shares 16 pages with its prefix's wave-1
   request; another worker holds them only after an earlier wave-2
   request of that prefix went there, and may then read 0 or 16), and
   (b) every candidate's whole logit under the JAX serving default,
   2 x overlap - kv_usage - active - min(4, cost / 0.25) - (1 - health),
   recomputed with cost = the pages it lacks x 8 MiB (a bf16 llama3-8b
   page, from the config) over the 1e9 B/s cold prior, equals the
   recorded one within the selector's rounding (2e-4), the recorded
   overlap, transfer bytes and seconds equal the derived ones, and the
   chosen worker has the highest recorded logit; llm_router_fallbacks is
   0; (c) the
   workers' own counters, their $STATS scraped over the control plane
   before and after the traffic, sum to the prefix hits and lookups
   derived from where each request went (`routed_prefix_hits`;
   engine/scheduler.py `_match_prefix`: a prompt of len tokens looks up
   min(hits + 1, (len - 1) // 64) pages and hits the leading ones its
   worker already stored). The template
   `<|system|>S</s><|user|>U</s><|assistant|>` puts 1046 tokens before a
   user turn, and the turns differ from their first byte, so a wave-1
   request hits 0 of 1 page and a wave-2 request on its prefix's worker
   16 of 17. Printed: how many wave-2 requests went to their prefix's
   worker (the selector does not promise all 12 once one worker holds
   most prefixes). Every worker ran one graph replay
   per decode window (decode_dispatches == decode_windows) and launched
   the ragged kernel layers x its decode steps + its warm-up launches
   times, more than 0 in all. Then the contrast, printed and not gated:
   the --no-kv-routing frontend over 4 fresh prefixes of the same shapes
   (round-robin), both frontends' prefix hit shares and TTFT p50 / p90
   from llm_ttft_seconds (the bucket counts each round added), labelled
   as two replicas sharing one H100, and the routed round's ITL p50 / p90
   from llm_itl_seconds (every frame goes through the pipeline graph's
   Segment, llm/pipeline.py). Then
   one greedy request twice through the router (logprobs on): equal
   bodies apart from id / created. The frontends dispatch through the
   reliability layer (frontend/reliability.py), as every frontend does.
   The ledger (`ledger_gate`): each worker's $STATS carry engine_steps >
   0, engine_recompiles (new JAX program keys, not graph captures)
   unchanged across the routed round, and engine_mfu
   = engine_tok_s x F / peak (F = 2 x (32 x (attention + MLP) + d x
   vocab) + 5 x vocab = 1.501e10 FLOP a token, from the config). With both
   workers idle (`standalone_gates`, `phase seconds: 11 services`): the
   router service answers `route` for each system prompt with a worker
   that holds at least its 16 pages; the exporter's per-worker
   llm_requests_total_slots, llm_kv_blocks_total and llm_kv_blocks_active
   equal the workers' $STATS; a FleetRollup in this process records
   worker/{w}/{field} series equal to the same $STATS and
   fleet/workers_live 2; the router service's `state` endpoint and the
   frontend's /router/state name the native tree; the exporter's and both
   frontends' /metrics carry every llm_autoscaler_* gauge, equal to that
   process's AUTOSCALER_STATS (no controller runs there: all 0). Last, 11h's
   reference: the 4 H11 chats (phase 11's shapes on 4 fresh system
   prompts, greedy, max_tokens 32, the top 8 logprobs, streamed) one at a
   time through the KV-routed frontend.
11g. Settings, logging, llmctl and the C API (A13; `phase_g11`, `phase
   seconds: 11g`). Settings: each server, the router service and the
   exporter log the settings they took (`settings {...}`): each value
   equals the layer that should win (the file, a DYN_* variable over the
   file, a flag over both), the servers log `control plane listening on
   127.0.0.1:<port> (primary | standby)`, opened their data directories,
   and neither server nor the exporter listens on the file's port.
   Logging: every child of phase 11 (11k, 11s and 11h included) runs
   with DYN_LOG=info,<one port module>=debug (the servers'
   dynamo_tpu_torch.controlplane, every other child's
   dynamo_tpu_torch.runtime), DYN_LOGGING_JSONL=1 and a DYN_LOG_FILE of
   its own; after the phase every line of every file is one JSON record
   with ts, level, target and message, and its DEBUG records come from
   the named target, and only from it. After the gates above read their
   counts and before 11k: `python -m dynamo_tpu_torch.llmctl
   --control-host <pair> add llama3-8b-alias dynamo.llm.generate --arch
   llama3-8b --kv-routed`; `list` shows it; once the KV-routed frontend
   lists the alias, one greedy chat (a fresh system prompt of phase 11's
   shape, 32 tokens, the top 8 logprobs, streamed) twice under llama3-8b
   (a cold prefill, then a prefix hit on the same worker) and once under
   the alias: its stream equals, token strings and top-8 values within
   SAME_CONTEXT, the run that took its path (the prefix hit where the
   alias's router picked that worker, else the cold one); `remove`, and
   the alias answers 404 "model
   'llama3-8b-alias' not found", as JAX's frontend does. The C API
   (native/capi.cpp, built with g++ into build/dynamo_tpu_torch/ and
   driven through native/capi_py.py): dyn_tokens_hash equals tokens_hash
   on every full page of another fresh prompt; dyn_llm_init joins the
   primary as one live worker's id; Stored events for those pages make
   the frontend's /router/match and the router service's `route` score
   that worker with the prompt's full page count; Removed events take
   both back to 0.
11k. A worker killed mid-wave: 8 greedy streamed chats on 8 fresh system
   prompts of the same shapes (no prefix shared inside the wave, so that
   every stream is admitted and prefilled at once), max_tokens 128,
   logprobs with the top 8, through the KV-routed frontend, after a
   warm-up of the same 8 requests, each sent twice through the
   round-robin frontend (one request at a time until its first frame, so
   a request's two copies are consecutive picks), so that both workers
   hold every prompt's pages,
   each prefilled alone (the router scores every prompt on both before
   the wave): every stream prefills one page and all 8 decode together (a
   wave of fresh 1.2k-token prompts staggers their starts by seconds, and
   the first streams end before the last begin), both workers hold the
   window graphs the wave replays, and a migrated stream and its replay
   on the survivor read the same prompt KV, so they differ only where the
   survivor re-prefilled the migrated stream's tail and tokens. Once
   every
   stream holds at least 8 tokens at the client (logprob entries), the
   router's decision log (GET /router/state, keyed by x-request-id, read
   before the kill) names the worker holding each stream, and the worker
   holding the most is SIGKILLed. Checks: every stream ends with
   finish_reason length, 128 logprob entries, usage.completion_tokens 128
   and [DONE], with no error frame, and its text before the kill is a
   prefix of its final text; the frontend's
   llm_reliability_migrations_total grew by the killed worker's streams;
   the killed worker exited -9; once its lease expires /router/state lists
   one instance. Then each migrated stream is replayed on the survivor
   (the same body) and held against it position by position by its
   logprobs (the token strings and the top-8 values, within two bf16 ulps
   at the top logit's magnitude, as the ids are not on the wire): equal up
   to the first difference d, and there a near tie (top-1 less top-2 <=
   NEAR_TIE in both streams), as phase 12 holds its streams (the survivor
   re-prefills prompt + committed tokens in bf16). Where the token strings
   differ at d, d is the tie; where only the values differ (two ids of one
   string were picked at d - 1), d - 1 is.
   Printed: each stream's migration gap (client time across the kill from
   the last frame before it), p50 and max, and the first-difference
   positions.
11s. Shedding: a third frontend process on the same control plane with
   DYN_MAX_INFLIGHT=2 DYN_ADMISSION_QUEUE=0 DYN_RETRY_AFTER_S=1 (no GPU
   work; the other frontends keep their environment). Two streams are held
   open past their first frame, then two more requests answer 429 with
   retry-after 1 and the body {"error": {"message": "server overloaded,
   retry later", "code": 429}}, and llm_http_service_requests_total
   {status="shed"} grows by 2; once the held streams end a request answers
   200 and the in-flight gauge is back to 0.
   Then SIGTERM to the survivor: it drains, deregisters (both first
   frontends' instance counts fall to 0), prints `EXIT ...
   logits_nonfinite_steps=0` and exits 0. Each worker process is its own
   path: its launch counts start at 0 with the process and are read from
   its $STATS.
11h. The control plane's failover (`phase_h11`, `phase seconds: 11h`), in
   this order: (1) 64 unleased keys and 16 queue items written through a
   comma-form client (enrolled with the primary at epoch 1), each
   acknowledged; (2) the standby's own journal (read from its data
   directory) holds every one of them (replication is asynchronous: the
   window before that is the design's, not gated); (3) the primary is
   SIGKILLed; (4) the standby prints PROMOTED and answers the role probe
   primary at epoch 2 (the time from the kill is printed); (5) the three
   frontends, still enrolled with the dead primary, lose their leases
   (leases are not replicated) and end their runtimes: each exits 0 with
   `EXIT frontend lease_lost=True` within the lease TTL (30 s) plus 15 s of
   the kill; (6) a fresh comma-form client, on the promoted member at epoch
   2, reads every key back and pops every item in order; (7) a fresh
   llama3-8b worker (full width and depth, seed-0 weights, the phase's
   schedule; READY with epoch=2) and a fresh KV-routed frontend (ENROLLED
   epoch=2) start with the comma form; (8) the 4 H11 chats, one at a time
   over HTTP; (9) each streams 32 tokens with no error frame and finite
   logprobs, and equals phase 11's stream of the same chat or first
   differs at a near tie (NEAR_TIE, as 11k); the worker's decode steps
   equal those derived from the streamed tokens (each chat alone with
   logprobs: no pipelined window; the first token is the prefill's, each
   window the smallest rung of 8, 2, 1 covering what remains), and its
   ragged launches = 32 x those steps + its warm-ups; (10) the dead primary
   restarts from its data directory with --standby-of the promoted
   member, answers standby, synced, epoch 2, and 3 s later still has not
   promoted; (11) printed: the time to promotion, the journals' records
   and bytes, and phase 11's routed TTFT with the journal on. Then the
   worker drains on SIGTERM (exit 0, logits_nonfinite_steps=0) and the
   frontend and both servers exit 0 on SIGINT.

12. The disaggregated deployment at full width, as processes through the
   SDK's one command: `python -m dynamo_tpu_torch.sdk.serve
   dynamo_tpu_torch.examples.disagg.graph:Frontend -f <config>
   --start-control-plane --control-port 0 --control-data-dir <dir>` (the
   control plane journals its state, the prefill queue among it, with
   fsync), the config being
   dynamo_tpu_torch/examples/disagg/config.json (llama3-8b at full width
   and depth, bf16 weights from seed 0 in both workers, bf16 KV pages, ps
   64, max_model_len 16384; decode max_slots 16, max_local_prefill_length
   1000, max_prefill_queue_size 2; prefill max_slots 8; max_prefill_chunk
   512) with two cuts: num_pages 1024 per engine in place of 2048, two
   engines sharing one card, and num_layers 4 of the 32 (DISAGG_LAYERS,
   for the time limit; phase 20 serves the whole depth disaggregated),
   every gate derived from the 4. The supervisor starts the control plane, the
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
   llm_router_fallbacks are all 0, and so are the frontend's reliability
   migrations and retries and its hedges (the frontend dispatches through
   the reliability layer); the prefill worker launched the ragged
   kernel 0 times, the decode worker layers x decode steps + warm-up
   launches times, one replay per decode window, no graph reset, and no
   new graph during rounds A and B. The journal (`journal_push_latency`):
   200 pushes of a 256-byte item, one at a time, each timed from request
   to acknowledgement (sent once the record is fsync'd), popped back in
   order; the journal holds the prefill queue's pushes; printed: push p50,
   p90 and max, the records and bytes. Then SIGTERM to the supervisor: the frontend
   stops, each worker drains (EXIT lines with logits_nonfinite_steps=0),
   every service and the supervisor exit 0. Reported: TTFT of round A
   (client), round B's llm_ttft_seconds p50 / p90 and the client TTFT of
   its streamed remote and local requests, early first emits, each
   transfer's pages, MiB, ms and GB/s (send side), enqueue to activation,
   each worker's peak memory, the phase's seconds. The services' whole
   output goes to build/disagg_supervisor.log.

13. The KV tiers at full width (engine/offload.py, engine/kv_pool.py): one
   set of llama3-8b weights from seed 0 shared by every engine, at 4 of
   its 32 layers (TIER_LAYERS; the widths, page size and traffic
   unchanged, the gates count pages, hits and layers x steps; the cut
   keeps the script inside its time limit), bf16, page
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
   and rejected nothing. The pool service (engine/pool_service.py): P3
   publishes the same 4 histories into a ClusterKvPool of 3 in-process
   pool hosts at R = 2, and P4 serves them, fetching from the cluster,
   with one pool host killed mid-fetch (after P4's 8th page fetch; the
   watch delete not landed, so the host is still a ring member): P4's
   streams equal P1's repeat, every matched page is fetched (R = 2 leaves
   one live replica of each), at least one fetch failed over, none
   exhausted its replicas, and every request finishes its 32 tokens (0
   dropped streams). Then the pricing of those fetches (`pool_pricing`,
   `phase seconds: 13 pool pricing`): the transfer cost model holds one
   `pool:{host}` link for each host that served P4 a page, its samples
   that host's pages, summing to the pages fetched; a
   TransferAwareSelector scoring a request with the fetchable depth on two
   workers with unmeasured links prices each worker's pages at the links'
   median EWMA (the cold prior), with pool_fetch_bytes = fetchable pages x
   the page bytes derived from the config. Tentpole 0 on T (`phase_failed_capture`): a
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

14. Mixture-of-experts serving, in a child process (`chip_smoke.py
   --phase-moe`: earlier phases keep device memory here, and Mixtral's
   ~44 GiB of int8 weights need the card to itself; the child's failure
   fails the run). First the grouped W8A16 kernel (csrc/w8a16_moe_gemm.cu)
   against its plain version at Mixtral's expert shapes (gate and up
   4096 -> 14336, down 14336 -> 4096), one layer's 8 experts, bf16 x of 8
   rows an expert, with all 8 experts active, 2 (one live slot) and none:
   the W8A16 phase's tolerance, exact zeros for inactive experts (their
   output memory NaN-filled just before); CUDA-event times over replayed
   graphs per routing (kernel, bound, share, plain, torch.matmul on bf16
   copies of the active experts). Then the tensor-core kernel's grouped
   call (the prefill route) at 256 and 2048 rows an expert under the same
   three routings: active experts within the tolerance, inactive ones
   exact zeros on NaN-filled memory; kernel, bound, plain, library, and
   the old route (every expert dequantized + torch.matmul) re-timed in the
   same call; a 512-token chunk's expert products (3 x 32 launches at 256
   rows an expert) new against old. Then mixtral-8x7b, quant="int8",
   bf16 KV pages, random weights from seed 0, full width and all 32
   layers, the default EngineConfig, serves phase 4's 8 chats through
   LocalPipeline twice (capturing, then warm) with phase 4's gates, plus:
   moe_routed_tokens in the band derived from the token ids and prefix
   hits (MoeCounts.check), 0 pairs dropped by decode windows, every
   window graph holding 3 x 32 x nw grouped, (2 x 32 + 1) x nw W8A16
   (q | k | v, o and the head) and 32 x nw ragged launches, the replays
   adding 3 x 32 grouped launches a decode step; the prefill and mixed
   steps launching the tensor-core kernel exactly as their shapes derive
   (3 x 32 grouped where B x C rows an expert pass GROUPED_MAX_M, 4 x 32
   dense where B x T pass GEMV_MAX_M, the head where B does; 2 x 32
   decode-kernel launches where B x T does not) and the dequantize entry
   0 times;
   graph and eager windows give identical tokens (phase 4b).
   Reported: TTFT p50 / p90 per run, warm decode tok/s, the untraced ms
   per decode step, the drop rate, weight_bytes and peak memory.

15. Checkpoints (models/loader.py, llm/gguf.py, llm/bpe.py, the card and
   the chat template), under build/checkpoints (removed at the end), with
   this script's own writers: safetensors (`write_safetensors`), config.json
   (`hf_config`), tokenizer.json (`llama3_tokenizer_json`, its merges from
   `train_merges`) and GGUF (`write_gguf`, with Q8_0 / Q4_K / Q6_K
   quantizers), each from the port's seeded weights by the inverse of the
   loaders' mapping (`hf_entries`, `write_llama_gguf`).
   a. Every family, small (`small_family_config`: 2 layers, d 256, hd 64,
   f32 weights whose norms and biases are redrawn from the seed): llama
   untied and tied, qwen2 (q/k/v bias), phi3 (fused qkv and gate_up, hd
   96, d 384), gemma (GeGLU, embed scale, (1 + w) norms, hd 256), mixtral
   (4 experts, top 2) and a llama GGUF mixing F32, F16, Q8_0, Q4_K and
   Q6_K; on the card each run launches the ragged kernel layers x decode
   steps (+ warm-ups) times. Each loads on
   the CPU and on the card (the HF directories' configs equal the written
   ones and every leaf is bit-equal to it; the GGUF trees equal across the
   devices) and is held to phase 3's rule (`device_reference`: the same
   greedy tokens, decode logits within 1e-3). The GGUF's SentencePiece
   vocab (`spm_vocab`: byte tokens, characters and seeded merged pieces
   with tied scores) tokenizes through the native encoder
   (native/spm_bpe.cpp, built with g++; `native_spm_gate`): the card's
   preprocessor holds it with 0 build failures; 15b's 8 chats through the
   card's template and 2000 seeded strings give the Python encoder's ids;
   printed: encode microseconds per 1k tokens, native and Python, on this
   host. llama and qwen2 also load
   with quant="int8" (quantized on each device as they load; the trees
   equal across devices) and run the same rule; gemma's engine (bf16 on
   the card, the default EngineConfig) runs phase 4b on its checkpoint
   (graph and eager windows give identical tokens).
   b. llama3-8b at full width and 16 of its 32 layers (CKPT_LAYERS: with
   all 32 the whole script passed 1100 s on the card), from disk: with at
   least 17 GB free under the phase's directory (else it fails with the
   bytes needed), init_params(llama3-8b cut so, seed 0) on the card is
   written tensor
   by tensor (one D2H at a time) as a bf16 HF directory in 4 shards with
   model.safetensors.index.json, config.json (LlamaForCausalLM, the
   registry widths at that depth, no rope_scaling, bos 128000, eos
   128009), a
   tokenizer.json of the Llama-3 form (byte-level BPE on the Llama-3 split
   with ignore_merges, merges learned from a fixed corpus, the Llama-3
   specials at 128000+) and tokenizer_config.json with Llama-3's chat
   template. The reference: the card from the directory and an engine on
   the in-memory weights (run.py's EngineConfig) serve 8 chats one at a
   time (`checkpoint_chats`: greedy, 32 tokens, top-8 logprobs) through
   LocalPipeline, and are freed. Then `load_model_dir` on cuda: every leaf
   bit-equal to the written tree, RssAnon growth (sampled every 20 ms)
   under 4 GiB. Then `python -m dynamo_tpu_torch.run in=http:0 out=native
   <dir>` as a process: the 8 chats one at a time (4 SSE, 4 unary), each
   finishing, each stream's logprob entries equal to the reference's or
   first differing at a near tie (phase 11k's rule, printed), its text
   equal to DecodeStream over the reference's ids; the ragged kernel
   launched layers x decode steps + warm-ups times (the process's EXIT
   line). Then quant="int8": the load's peak device memory under the
   written bf16 tree's bytes (9.08 GB; 16.06 at 32 layers), the tree
   byte-equal to init_params(the same config, seed 0, quant="int8"), and
   `run.py ... --quant int8` serving one chat held to
   that tree's engine the same way (W8A16 launched, the dequantize entry
   never). Printed: write seconds, load seconds and GB/s (the page cache
   warm), RssAnon growth, READY seconds, TTFT p50 / p90
   (llm_ttft_seconds), the tokenizer's encode ms per 1k prompt tokens,
   the int8 load's seconds and peak. 17c runs here, after the plain
   run.py, on the same directory and chats.

16. The gather decode windows and Gemma-2 (A5), under build/checkpoints
   (removed at the end).
   a. gemma-2-9b at full width and 4 of its 42 layers (GEMMA_LAYERS: the
   cut keeps the script inside its time limit; the 4
   keep both of its alternating attention patterns; google/gemma-2-9b's
   published config.json otherwise: d 3584, 16 / 8 heads of 256, vocab
   256000,
   tied, GeGLU, sliding window 4096 on alternating layers, soft-caps 50 /
   30, query_pre_attn_scalar 256; random bf16 weights from seed 0),
   written by this script as a 4-shard HF directory with a Gemma-form
   tokenizer.json (256000 ids: a Replace normalizer, BPE with byte
   fallback) and Gemma's chat template. Traffic: 8 chats of 4.6k-7.4k
   prompt tokens, greedy, 64 tokens, top-8 logprobs, 4 SSE and 4 unary,
   one at a time (8 slots, 1024 pages), so that each is scheduled alike
   in every run. The reference gate (run last), in f32 at the same width
   and depth (one slot, 125 pages; random f32 weights from seed 0): the
   gather window against the same engine with `pregather = False` and
   eager windows, the per-token deferred gather with no window buffer and
   no graph, on the two longest chats: equal, or first differing at a
   near tie (in
   bf16 their summation-order difference, carried through tens of random
   layers, drifts past any tie rule: PERF.md §6). Then the bf16 engine on
   run.py's EngineConfig serves the 8 chats (0 ragged launches), gives the
   untraced ms per decode step with the 8 prompts decoding together, the
   base gather's ms a window and the peak memory, and the knobs'
   sensitivity: one decode step past the window of the longest chat, its
   logits with the windows removed, and with the attention soft-cap
   removed, each differ from the served ones by more than SAME_CONTEXT.
   Then `run.py in=http:0 out=native <dir> --num-pages 1024` serves the 8
   chats three rounds (cold, a warm-up on the cached prefixes, the
   measured round): every stream 64 tokens or a stop, no non-finite
   logit, the cold round held to the bf16 engine's streams (equal, or
   first differing at a near tie: hold_to_reference), the measured round
   equal to the warm-up round (their prefix hits prefill only each
   prompt's tail, in other bf16 roundings than the cold chunks: their
   first differences from the engine are reported), the resolved path
   gather, 0 ragged launches, one graph replay a window, no graph
   captured in the measured round. Printed: write / load / READY s, TTFT
   p50 / p90 cold and warm, ms per decode step, the base gather's ms,
   peak memory.
   b. The two windows at llama3-8b (random weights, seed 0; at 8 of its
   32 layers, AB_LAYERS, for the time limit): decode_kernel
   "off" (the gather window) against "auto" (the kernel window), bf16 and
   int8 pages, 8 slots, the 4 longest of phase 4's chats one at a time,
   greedy with top-8 logprobs: on bf16 pages token-identical or first
   differing at a near tie; on int8 pages, where the two windows compute
   different functions by design, the first differences are reported;
   the kernel's launches only on "auto"; each window's untraced ms per
   decode step with the 8 prompts decoding together.
   c. (inside 16a, on its in-process bf16 tree, before run.py; 16a's
   engine, on a fresh allocator, is the aggregated reference: each chat
   alone, with its top-8 logprobs) The gather window on the distributed
   path, in three rounds (`phase_gemma2_distributed`).
   R: two gather engines on 16a's EngineConfig (8 slots, 1024 pages),
   each served as an endpoint over a memory control plane, behind the KV
   router (the default TransferAwareSelector), HttpService and the
   ReliableClient; 8 SSE chats over 2 shared prompts of ~4700 tokens (past
   the 4096-token window) with user turns of 40-200 tokens, two waves of
   4, 32 greedy tokens. Gates: each wave-2 chat on a worker that served its
   prompt in wave 1, with matched pages >= the sealed pages its token ids
   share with that worker's chats; 0 router fall-backs; every stream equal
   to the reference or first differing at a near tie; both engines on the
   gather path, 0 ragged launches, one replay a window, no capture in
   wave 2. D: a prefill engine and a gather decode engine on (h)'s
   configs (local prefill up to 1000, decode 16 slots; 1024 pages each),
   the TCP transfer plane (chunk_pages 4, window 4) and a PrefillQueue
   over the default QosPolicy; 16a's four longest chats, then two of 125
   and 625 tokens, one at a time, 32 tokens. Gates: remote / local as
   prefill_remote(len, 0, 0) decides; pages received = uncached pages =
   pages verified, 0 mismatches, salvages, re-prefills, timeouts; each
   stream equal to the decode engine's own disaggregation hooks (run first,
   one at a time: its warm-up) and to the reference or a near tie; 0
   ragged launches; no capture after the warm-up. Q: with the prefill
   worker not consuming, 4 batch remote chats then 1 interactive one
   (classes through set_qos in the baggage); the dequeue order equals the
   order recomputed from the enqueue list, the policy's weights,
   priorities and aging limit (`stride_order`). Then a 2-slot decode
   engine holds two batch streams of 512 tokens (long enough to still
   decode when the remote chat's prefill and transfer land; 128 ended
   first on the card) and an interactive remote
   chat arrives: exactly one preemption of a batch stream (both slots
   batch, the arrival of priority 2 with a budget of 4), every stream at
   max_tokens, each batch stream equal to its unpreempted run or a near
   tie. Printed: R's routed TTFT p50 / p90; D's TTFT, transfer MiB, ms
   and GB/s, ms a token from the second on; Q's TTFTs by class.

17. Speculative decoding (A8; engine/spec.py, the engine's verify), spec_k
   4, greedy, MAX_TOKENS a chat, every stream held to a plain engine's on
   the same weights: equal, or first differing where the plain engine's
   top-1 less top-2 logprob is a near tie (`hold_ids`; NEAR_TIE in bf16).
   a. llama3-8b bf16 (seed 0), EngineConfig(max_model_len=4096) plus
   spec_decode="ngram": 8 chats of 512-2048 prompt tokens (template
   included), each quoting one 128-256-byte paragraph three times and
   asking for it restated, one at a time (each scheduled alike in both
   engines), in a cold round (captures) and a warm one (the cost gate
   reset before each). Every engine of 17a and 17b first serves each
   prompt with max_tokens 1 (`prime`), so that every run prefills the same
   tail over the same cached pages: the two rounds are then one
   computation, and the warm one replays the cold one's graphs. Each
   round: the ragged kernel launched target layers x (the decode steps of
   the windows it committed, their token arrays' rows, + the verify blocks
   it recorded) + the graphs' warm-ups, each verify graph holding one
   ragged call a layer (the block's 8 x 5 rows attend their prefix through
   the kernel: `block_attention`), one graph replay a verify block; verify
   replays > 0 over the two rounds; no capture in the warm round. The
   cost gate's decisions are reported (drafts passed on their cost, as a
   probe, refused). Then the 8 together (a warm-up run, then the timed
   one) with speculation and without (tok/s, reported). Then the kernels
   on the inputs of the verify with the most live rows (its [8, 5] block's
   40 rows, each slot's page table repeated 5 times, prefix lens its
   positions[:, 0]; `hold_verify_attention`), on the engine's bf16 pages
   and on int8 pages quantized from them, layers 0 and L - 1, q seeded:
   the ragged kernel in prefix mode against its plain version (2e-3), and
   `block_attention` (the f32 causal fold; on int8 pages the block's rows
   dequantized) against ops/attention.paged_attention over positions
   [0, prefix + j] at the block's real tokens (1e-2, outputs in bf16).
   Then each verify graph's replay ms (CUDA events, its writes sent to
   the scratch page) beside the plain engine's ms per decode step, as
   window steps beside the price the gate gives a verify on the card
   (engine/spec.VERIFY_STEPS). Then 2 chats with int8 weights: the
   same stream gate, and the tensor-core launches outside the warm-ups
   equal to those the prefill shapes and each verify block's [8, 5] shape
   derive (7 L + 1 a block: its 40 rows pass GEMV_MAX_M), 0 dequantize.
   b. llama3-1b at full width and depth in f32 with the draft the same
   registry model and seed (spec_decode="draft"): 2 chats one at a time;
   streams equal to the plain f32 engine's (a first difference only at a
   top-1 less top-2 <= 1e-3), acceptance >= 0.99, the draft on the ragged
   kernel, its proposal replays launching it draft layers x spec_k times
   each; the kernels on the recorded verify's inputs as in (a), f32 pages
   (1e-4 both); verify and propose replay ms.
   c. Run by 15b, while its llama3-8b directory (seed 0, the weights of
   (a)) is on disk: `python -m dynamo_tpu_torch.run in=http:0 out=native
   <dir> --spec-decode draft --spec-draft llama3-1b` as a process, 15b's 8
   chats greedy, one at a time, 4 SSE and 4 unary, without logprobs (a
   logprob plan never speculates). The directory's Llama-3-form tokenizer
   decodes every id, so the wire's text carries every token: each text
   and token count equal to 15b's reference (the in-memory engine, run.py's
   EngineConfig), or the first reference token whose text leaves the
   served text with a near tie at it or at one of the two before it
   (`hold_texts`); the EXIT $STATS carry spec_steps and
   spec_proposed_tokens > 0, the draft's proposal replays launching the
   ragged kernel draft layers x spec_k times each. Reported: acceptance,
   verify and window steps, the host ms a verify and a propose, tok/s
   against 15b's plain run.py (which asks for logprobs).

18. Vision (A11): qwen2-vl-7b at full width and depth (28 layers, d 3584,
   28 / 4 heads of 128, vocab 152064; its ViT tower 32 layers of d 1280
   over 1024 patches of a 448 x 448 image), random weights from seed 0.
   a. The tower: f32 on the card against f32 on the CPU at full width and
   2 of its layers (rtol = atol = 1e-4); the same draws in bf16 against
   f32 on the card at full depth (every patch row's cosine >= 0.999, max
   |diff| reported); the bf16 encode of one image and of 4 (CUDA events)
   beside the FLOP bound.
   b. `python -m dynamo_tpu_torch.run in=http:0 out=native qwen2-vl-7b` as
   a process (bf16, run.py's EngineConfig): 8 chats, each a text part, one
   image as an .npy data URL and a question, 64 greedy tokens, top-8
   logprobs, 4 SSE and 4 unary, one at a time, twice (cold, measured).
   The images: 5 distinct at 448 x 448 (noise, two ramps, a checkerboard
   and a flat colour, since a random tower averages noise images of one
   distribution to nearly the same embeds; chat 5, the flat colour, with
   chat 1's exact text), one at 300 x 500 (the preprocessor resizes it),
   one in 0-255 (it normalises it), chat 1's image again with another
   question. Gates:
   every stream 64 tokens; chat 1 and chat 5 stream differently (their
   logprob entries; the first token that differs is reported); the
   prefix pages run.py hit equal those the prompts' identities give (token
   ids, each image position as its image's digest and index; cold: the
   repeated image's pages of its common prefix with chat 1 and chat 5's
   pages before its image and no more; measured: each prompt's own
   pages); the decode path ragged; ragged launches = 28 x decode steps +
   warm-ups, the steps at least the decoded tokens and less than a window
   more a chat; one replay a window; no capture in the measured round.
   Reported: READY s, TTFT p50 / p90 cold and warm, weight_bytes. Then in
   process on run.py's EngineConfig and the bf16 weights: chat 1, the
   repeated image and chat 5 one at a time, each one's prefix pages equal
   to the identities' (exact, per chat); chat 1's time to its first token
   (encode + a prefill of three chunks), ms per decode step at one slot,
   peak memory.
   d. Disaggregated, in process: a DisaggDecodeWorker and a PrefillWorker
   on the bf16 weights (one tree), a memory plane and the chunked KV
   transfer server, max_local_prefill_length 256; chat 2 with
   mm_transfer="pixels" and chat 3 with "embeds" (the prefill engine's
   tower replaced by a function that fails the run). Each: 1 remote
   prefill, pages received = verified = the prompt's uncached pages, 0
   mismatches, 64 tokens equal to a fresh aggregated engine's on the same
   weights or first differing at a near tie (NEAR_TIE). Reported: the
   queue payload's bytes, the remote TTFT.
   c. f32 at full width and depth (the bf16 weights freed first): chat 1
   with 32 greedy tokens under max_prefill_chunk 512 (the span's rows in
   three chunks) and 2048 (one chunk): token-identical, or first
   differing where the one-chunk run's top-1 less top-2 logprob is under
   1e-3.

19. Streaming past the HBM page budget (A7; engine/streaming.py): the
   llama3-8b card at full width and 4 of its 32 layers (TIER_LAYERS),
   random weights from seed 0, page 64. S streams (num_pages 64,
   host_pages 256 pinned, stream_pages 8, stream_resident_pages 8,
   stream_hot_pages 2); O is the ordinary engine on the same weights
   (num_pages 512, nothing streamed). First the kernel-form partials on the
   card at the streamed decode's shapes (one query row over 9 resident pages
   with a partial tail, and a staged half of 8 slots holding 7 pages; bf16
   and int8) against `_pages_partial` as torch ops: within 2e-3 (1e-2 with
   int8 pages, whose torch form rounds the dequantized rows to bf16 where
   the kernel folds the scales in f32). Traffic, one
   request at a time: 2 greedy chats of 4096 random token ids (64 pages; at
   decode 56-57 of them cold), 32 tokens each (ignore_eos), in bf16, then
   with int8 pages (S and O both int8). Gates: each stream equals O's or
   first differs at a near tie (O's logprob of the streamed token within
   NEAR_TIE of its top); every request is streamed and its stream_steps =
   prompt chunks + decode steps; prefetch hits + lates = layers x segments
   summed over the steps and ragged launches = (layers - 1) x (1 +
   segments) summed over the decode steps, the segments derived from the
   cold page count of each step (sealed pages less the resident ones: 8,
   or 7 beside the unsealed tail page); no quarantine in a clean run; the
   engine ledger's "stream" samples number the stream steps and their
   stream_hit + stream_late sum to the prefetch takes.
   Then a 1024-token chat (16 pages, 8 cold) clean, and again with one
   armed `offload.read_tier` rot after 4 tokens: exactly 1 quarantine and
   1 recompute, the stream equal to the clean run's. Then f32 at the same depth, one
   slot, a 1024-token chat (16 pages, 8 cold), 16 tokens: S's stream
   identical to O's. Reported: ms per streamed decode step beside O's ms
   per decode token, the prefetch hit share, host-to-device GB/s of the
   window fills, stall steps, the phase's seconds.

20. Traced disaggregation under a link-cut storm (A14; runtime/tracing.py,
   disagg/*, tools/torch_trace_explain.py): llama3-8b at full width and
   depth, bf16, seed-0 weights, one tree shared by a decode engine and a
   prefill engine in process on phase 12's decode and prefill configs
   (max_local_prefill_length 1000) with 512 pages each; the port's
   HttpService and ReliableClient over a memory control plane, a
   PrefillQueue and the TCP transfer plane (RemoteTransferBackend ->
   KvTransferServer on 127.0.0.1, chunk_pages 4). The reference: the
   decode engine serving each chat aggregated, alone, with its top
   logprobs, before the workers start.
   T, traced and clean: TRACER on at sample 1.0, 4 SSE chats of ROUND_A's
   lengths one at a time, 32 greedy tokens each; the spans drained to
   build/trace_p20.jsonl (+ .chrome.json) and summarized by the explain
   tool. Gates: exactly 4 request traces, each one tree rooted at
   http.request with every parent in the trace, holding schedule, attempt,
   worker.generate, prefill.remote, queue.wait, prefill.run, kv.transfer,
   kv.transfer.chunk, kv.inject and decode.emit; kv.transfer's pages = the
   prompt's pages (ceil(tokens / 64)) and its bytes = the pages on the
   wire (each chunk padded to a power of two, the JAX chunk layout) x 2 x
   32 x 8 x 64 x 128 x 2; ceil(pages / 4) chunk spans; the decode.emit n's add up
   to the tokens served; scope:engine records present; each stream equal
   to the reference or first differing at a near tie (NEAR_TIE).
   Reported: each request's queue wait, prefill run, transfer ms and GB/s
   beside the router's pre-send est_s, inject ms and first-emit offset.
   S, under a storm: `transfer.link` (seed 53, drop p 0.12: the transfer
   storm's plan without its 30 s stall), `queue.dequeue` (seed 353, delay
   p 0.5, 10 ms) and one `remote_transfer.fetch_page` corruption; 4 fresh
   chats of the same lengths, through a stop-and-wait sender (window 1, as
   the JAX storm's: at a cut the frontier is the chunks acked). Gates: 32
   tokens and "length" each, no error frame, each equal to the reference
   or first differing at a near tie; every drop that fired absorbed by a
   reconnect of its sender (the successful transfers' resumes, plus
   link_retries + 1 a transfer that gave up); XFER_STATS.resumes >= 1 and
   equal to the kv.transfer.resume events; pages injected = the prompts'
   pages (less what a salvage kept off the wire), each verified; exactly 1
   integrity mismatch, refused and re-sent; 0 frontend migrations or
   retries; a salvage only for a transfer that gave up, else 0; everything
   disarmed afterwards. W, the same plan re-armed over 4 more fresh chats
   through the serving sender (a window of 4 chunks): the gates that hold
   at any window (every gate of S but resumes >= 1 and the one re-send, as
   a cut can land before any ack and a refused chunk's nack unread), so no
   committed page lands twice when a reconnected handshake reads the
   frontier while the cut connection's chunks still inject.
   L, the local staging hop: a LocalTransferBackend between the same two
   engines with one `remote_transfer.fetch_page` corruption, one chat of
   1100: 1 page set re-fetched, the prompt's pages verified before their
   inject, the stream equal to the reference (or a near tie).
   P, the profiler hook: a fresh NativeEngineWorker on the decode engine
   with DYN_TORCH_PROFILE_DIR set serves one 105-token chat of 32 tokens
   and stops: its chrome trace loads and names ragged_split_kernel
   (reported: its kernel events beside the derived launches).
   Over the phase: decode-engine ragged launches = 32 x the decode steps
   derived from the streams + its graphs' warm-ups; the prefill engine
   launches none.

21. The fleet storms (A13): `python tools/torch_fleet_storm.py --mode slo
   --quick` (a live tiny engine's step ledger on the card, a 16-worker
   simulated fleet's rollup, the SLO fire -> clear storm with its alerts
   on the event plane) and `--mode autoscale --quick` (the static split,
   the FleetAutoscaler and its replay over the simulated cluster, the
   MixedBudgetTuner on a live tiny engine on the card), as two processes
   at once, started just before phase 10 and run beside it (its run.py
   processes): each exits 0 with every contract met.

22. Tensor parallelism (A10 part 1; parallel/, the engine's lockstep),
   each part in a child process of its own (`chip_smoke.py --phase-tp
   22a|22b`, the two at once), its ranks processes of their own
   (parallel/launch.py).
   22a: llama3-8b at full width, TP_LAYERS = 8 of its 32 layers, bf16,
   default EngineConfig, phase 4's chats one at a time with ignore_eos,
   two rounds (capturing, measured), on an engine with no group and then
   on the tp launcher's engine on an NCCL group of one: the streams
   token-identical (an all-reduce of one rank is a copy); each round's
   ragged launches = 8 x the decode steps derived from the streams + the
   warm-ups'; one replay a window, no capture in the measured round; every
   window graph of the group's engine holds (2 L + 1) x nw + 1 captured
   all-reduce calls; the profiler's kernels in one replayed window and ms
   a decode step of both reported. 22b: llama3-70b at full width, 8 of
   its 80 layers, bf16, seed 0, phase 4's 8 chats together, 32 tokens,
   half greedy and half seeded-sampled: first the whole tree on one
   process (tp 1, ~18 GB), freed, then 4 rank processes on cuda:0 over
   gloo (`tp_engine(..., backend="gloo")`); every stream equal to tp 1's
   or first differing at a near tie, every rank's tokens rank 0's, each
   rank's weight bytes those its config and specs give, its ragged
   launches = 8 x its decode steps at 2 kv heads, window graphs "off
   (gloo)"; ms a decode step and each rank's peak memory reported. NCCL
   at world > 1 inside captured graphs, and the all-reduce's cost over
   NVLink, need four cards: not run here.

Each path (each run of 4, 4c, 5 and 9, the A/B at each geometry, each
worker process of 11 and 12, each engine's turns in 13, each run of 14,
each card run and run.py process of 15, each engine of 16, each round,
engine and run.py process of 17, the run.py process and each in-process
part of 18, each streamed run of 19, phase 20, and each round of 22a)
runs with every kernel's launch
count set to 0 just before it and read just after. Each phase prints its wall-clock
seconds on a line `phase seconds: <phase> <s>`. The third line from the
end of the output is one JSON object with the kernel records, the second
from the end the nvidia-smi reading, and the last line
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import asyncio
import dataclasses
import json
import math
import os
import re
import signal
import struct
import subprocess
import sys
import time

H100_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def check(cond: bool, msg: str) -> None:
    """Fail the run: the message goes to standard output and to standard
    error, so a reader of either end sees which gate failed."""
    if not cond:
        print(f"FAIL: {msg}", flush=True)
        print(f"FAIL: {msg}", file=sys.stderr, flush=True)
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
    cases += [(f"{name} heads", hd, 8, h, hkv, 8, None)
              for name, h, hkv, hd in GEOMETRIES]
    return cases


# the ragged kernel's geometries past llama's (hd 96 and 256, GQA groups
# over 8, qwen2-vl-7b's group of 7: one head block with a masked eighth
# row): (name, q heads, kv heads, head dim)
GEOMETRIES = (("gemma-7b", 16, 16, 256), ("phi3-mini", 32, 32, 96),
              ("gemma-2-9b", 16, 8, 256), ("GQA 12", 96, 8, 128),
              ("GQA 16", 128, 8, 128), ("qwen2-vl-7b", 28, 4, 128),
              # one tensor-parallel rank's heads (phase 22): llama3-70b at
              # tp 4, llama3-8b at tp 2
              ("llama3-70b tp-4 rank", 16, 2, 128),
              ("llama3-8b tp-2 rank", 16, 4, 128))


def phase_kernel_geometries() -> dict:
    """Phase 2a's timing of the kernel at GEOMETRIES: 8 rows of 400 tokens
    (Pb 7 at ps 64), bf16 q with bf16 and with int8 pages, each launch on
    another of 4 layers' pages; the kernel (a replayed graph), its plain
    version, the library yardstick (gather + SDPA) and the bound (K + V
    bytes, + scales for int8, over 3.35 TB/s). The kernel against its
    plain version on these inputs first (2e-3, the bf16 tolerance)."""
    import torch
    from dynamo_tpu_torch.ops import paged_attention as pa
    out = {}
    s, nl, pb, n_tok = 8, 4, 7, 400
    for ci, (name, h, hkv, hd) in enumerate(GEOMETRIES):
        g = torch.Generator(device="cuda").manual_seed(50 + ci)
        p = s * pb + 1
        k = torch.randn((nl, hkv, p, PS, hd), generator=g, device="cuda")
        v = torch.randn((nl, hkv, p, PS, hd), generator=g, device="cuda")
        q = torch.randn((s, h, hd), generator=g,
                        device="cuda").to(torch.bfloat16)
        pt = torch.randperm(s * pb, generator=g, device="cuda").to(
            torch.int32).reshape(s, pb)
        lens = torch.full((s,), n_tok, dtype=torch.int32, device="cuda")
        kq, vq, ks, vs = quantize_case(k, v, pt, lens, seed=ci)
        for kind, kc, vc, sc in (
                ("bf16", k.to(torch.bfloat16), v.to(torch.bfloat16), ()),
                ("int8", kq, vq, (ks, vs))):
            quant = bool(sc)
            got = pa.decode_paged_attention_prefix(q, kc, vc, 0, pt, lens,
                                                   *sc)
            want = pa._ragged_plain(q, kc, vc, 0, pt, lens, *sc)
            err = max(compare(f"{name} {kind} at 8 x {n_tok} tokens",
                              zip(("acc", "m", "l"), got, want), 2e-3))

            def layer_sc(i):
                return (sc[0][i % nl], sc[1][i % nl]) if quant else ()
            kernel_ms = cuda_ms(lambda i: pa.decode_paged_attention_prefix(
                q, kc, vc, i % nl, pt, lens, *sc), 200, graph=True)
            plain_ms = cuda_ms(lambda i: pa._ragged_plain(
                q, kc, vc, i % nl, pt, lens, *sc), 20)
            library_ms = cuda_ms(lambda i: sdpa_yardstick(
                q, kc[i % nl], vc[i % nl], pt, lens, *layer_sc(i)), 100)
            nbytes = kv_bytes(lens, hkv, hd, kc.element_size(), quant)
            b = bound(nbytes, 4 * int(lens.sum()) * h * hd, "bfloat16")
            rec = {"ms": kernel_ms, "plain_ms": plain_ms,
                   "library_ms": library_ms, **b,
                   "share_of_bound": b["bound_ms"] / kernel_ms,
                   "max_abs_err": err}
            out[f"{name} {kind}"] = rec
            print(f"timing ragged kernel, {name} heads ({h}/{hkv} x {hd}) "
                  f"{kind} pages, 8 rows of {n_tok} tokens: max_abs_err "
                  f"{err:.3g} (tol 2e-3); kernel {kernel_ms:.4f} ms (graph "
                  f"replay), plain {plain_ms:.4f} ms, gather"
                  f"{'+dequant' if quant else ''}+sdpa {library_ms:.4f} ms,"
                  f" bound {b['bound_ms']:.4f} ms ({nbytes} bytes), "
                  f"{rec['share_of_bound']:.1%} of the bound", flush=True)
        del k, v, kq, vq, ks, vs
    return out


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


# the products of a llama3-8b layer that share an input, in the order a
# layer runs them, and the head: one launch of the grouped decode kernel
# each (ops/quant.linear_group); the odd shapes, one weight or three of
# one K (odd N streams without TMA, 128 through it)
GROUPS = (("wq", "wk", "wv"), ("wo",), ("w_gate", "w_up"), ("w_down",),
          ("lm_head",))
GROUP_ROWS = (1, 3, 8, 9, 16)
ODD_GROUPS = ((1000, (333,)), (4100, (1031,)), (1000, (333, 1031, 128)))


def group_check(label: str, x, ws) -> float:
    """The grouped kernel on the weights `ws` of one x, its output memory
    NaN-filled just before the call (an unwritten value shows), each output
    against the plain version (`w8a16_check`), and a second call bit-equal
    to the first (a fixed order of every sum). Returns the largest
    |diff|."""
    import torch
    from dynamo_tpu_torch.ops import quant
    m = x.shape[0]
    poison = [torch.full((m, w["q"].shape[1]), float("nan"),
                         dtype=torch.bfloat16, device="cuda") for w in ws]
    del poison
    qs, ss = [w["q"] for w in ws], [w["s"] for w in ws]
    got = quant.w8a16_group(x, qs, ss)
    torch.cuda.synchronize()
    err = max(w8a16_check(f"{label} weight {i}", x, w, y)
              for i, (w, y) in enumerate(zip(ws, got)))
    again = quant.w8a16_group(x, qs, ss)
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"{label}: two calls differ")
    return err


def group_checks(shapes) -> float:
    """2d: the grouped decode kernel against its plain version at every
    llama3-8b group and the odd groups, M = GROUP_ROWS, bf16 x. Returns the
    largest |diff|."""
    import torch
    from dynamo_tpu_torch.ops import quant
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    worst = 0.0
    cases = [("|".join(names), shapes[names[0]][0],
              [shapes[nm][1] for nm in names]) for names in GROUPS]
    cases += [(f"odd {'|'.join(map(str, ns))}", k, list(ns))
              for k, ns in ODD_GROUPS]
    for ci, (label, k, ns) in enumerate(cases):
        ws = [quant_weight(k, n, seed=500 + 10 * ci + i)
              for i, n in enumerate(ns)]
        g = torch.Generator(device="cuda").manual_seed(600 + ci)
        for m in GROUP_ROWS:
            x = torch.randn((m, k), generator=g, device="cuda").to(
                torch.bfloat16)
            worst = max(worst, group_check(f"w8a16_group {label} M={m}", x,
                                           ws))
        splits, per, per_block, blocks = quant.group_config(k, ns, sms)
        print(f"w8a16 grouped kernel {label} (K={k}, N={ns}; {splits} "
              f"splits of {per * quant._GRP_CHUNK_K} rows x {blocks} "
              f"blocks of {per_block} tiles): M = "
              f"{'/'.join(map(str, GROUP_ROWS))} within tolerance on "
              f"NaN-filled outputs, repeat calls bit-equal, max_abs_err so "
              f"far {worst:.3g}", flush=True)
        del ws
        torch.cuda.empty_cache()
    return worst


def phase_w8a16() -> tuple:
    """2d: the W8A16 decode kernels against their plain versions, then
    their times. Returns (max abs error, the timing record, the dequantize
    record, the tensor-core kernel's record)."""
    import torch
    from dynamo_tpu_torch.engine.config import get_model_config
    from dynamo_tpu_torch.ops import quant
    cfg = get_model_config("llama3-8b")
    shapes = projection_shapes(cfg)
    worst = group_checks(shapes)
    # the per-weight entry: its CUDA-core kernel (f32 x, the f32 route)
    # and its register-ring kernel (bf16 x; the old column of the times)
    for si, (name, (k, n)) in enumerate(shapes.items()):
        w = quant_weight(k, n, seed=si)
        g = torch.Generator(device="cuda").manual_seed(100 + si)
        for m, dt in ((8, torch.bfloat16), (1, torch.float32),
                      (8, torch.float32)):
            x = torch.randn((m, k), generator=g, device="cuda").to(dt)
            got = quant.w8a16_gemm(x, w["q"], w["s"])
            torch.cuda.synchronize()
            err = w8a16_check(f"w8a16 {name} M={m} {str(dt)[6:]}", x, w, got)
            worst = max(worst, err)
        print(f"w8a16 per-weight entry {name} (K={k}, N={n}): M = 8 bf16 "
              f"(the old kernel) and 1/8 f32 within tolerance", flush=True)
        del w
    for k, n in ((1000, 333), (4100, 1031)):
        w = quant_weight(k, n, seed=k)
        g = torch.Generator(device="cuda").manual_seed(n)
        for m in (1, 3, 8, 16):
            x = torch.randn((m, k), generator=g, device="cuda")
            got = quant.w8a16_gemm(x, w["q"], w["s"])
            torch.cuda.synchronize()
            worst = max(worst, w8a16_check(
                f"w8a16 K={k} N={n} M={m} float32", x, w, got))
        print(f"w8a16 per-weight entry at K={k}, N={n} (odd N, a partial "
              f"chunk of K): M = 1/3/8/16 f32 within tolerance", flush=True)
    large_worst = large_m_checks(shapes)
    # M = 512: linear's route is the tensor-core kernel (one launch, no
    # dequantize), no longer bit-equal to the dequantize + matmul route
    # (its scale multiplies the f32 sum, not each weight); an f32 x keeps
    # the dequantize route, whose entry is bit-identical to wmat
    bf16 = torch.bfloat16
    k, n = shapes["w_gate"]
    w = quant_weight(k, n, seed=77)
    x = torch.randn((512, k), device="cuda").to(bf16)
    deq = quant.dequantize(w, bf16)
    check(torch.equal(deq, quant.wmat(w, bf16)),
          "w8a16 dequantize is not bit-identical to wmat")
    before = (quant.LARGE_M_LAUNCHES, quant.DEQUANT_LAUNCHES)
    via_linear = quant.linear(x, w)
    torch.cuda.synchronize()
    check((quant.LARGE_M_LAUNCHES, quant.DEQUANT_LAUNCHES)
          == (before[0] + 1, before[1]),
          f"linear at M = 512 launched {quant.LARGE_M_LAUNCHES - before[0]} "
          f"tensor-core and {quant.DEQUANT_LAUNCHES - before[1]} dequantize "
          "kernels, expected 1 and 0")
    check(torch.equal(via_linear, quant.large_m_gemm(x, w["q"], w["s"])),
          "linear at M = 512 is not the tensor-core kernel's output")
    check(not torch.equal(via_linear, x @ quant.wmat(w, bf16)),
          "linear at M = 512 still equals the dequantize + matmul route bit "
          "for bit")
    large_worst = max(large_worst, w8a16_check(
        "w8a16 w_gate M=512 bf16 (linear)", x, w, via_linear))
    x32 = x.float()
    check(torch.equal(quant.linear(x32, w), x32 @ quant.wmat(w, x32.dtype)),
          "linear at M = 512 with an f32 x is not the dequantize + matmul "
          "route")
    # linear_group at decode rows is one grouped launch, bit-equal to the
    # kernel's own call on the same group (a group of two has another grid
    # than one weight alone, so its sums run in another order)
    xs = x[:8].contiguous()
    before = quant.KERNEL_LAUNCHES
    pair = quant.linear_group(xs, [w, w])
    launched = quant.KERNEL_LAUNCHES - before
    again = quant.w8a16_group(xs, [w["q"]] * 2, [w["s"]] * 2)
    check(launched == 1 and torch.equal(pair[0], pair[1])
          and all(torch.equal(a, b) for a, b in zip(pair, again)),
          f"linear_group at M = 8 made {launched} launches, or differs "
          "from the grouped kernel's own call")
    print("w8a16 at M = 512 (w_gate): linear launches the tensor-core "
          "kernel once and no dequantize (within tolerance, not bit-equal "
          "to the dequantize route); an f32 x takes the dequantize entry, "
          "bit-identical to wmat; at M = 8 linear_group is one grouped "
          "launch", flush=True)
    del w, x, x32, deq, via_linear, xs, pair, again
    timing, dequant_rec, large_rec = w8a16_timing(cfg, shapes)
    return worst, timing, dequant_rec, {"max_abs_err": large_worst,
                                        **large_rec}


# rows of x the tensor-core kernel is held to its plain version at: past
# the decode rows, a prefill bucket's, an odd count, a 512-token chunk, a
# long prompt's
LARGE_M_ROWS = (9, 16, 64, 100, 512, 2048)


def large_m_checks(shapes) -> float:
    """2d: the tensor-core W8A16 kernel (csrc/w8a16_large_m.cu) against its
    plain version at the eight llama3-8b shapes and LARGE_M_ROWS, bf16 x,
    its output memory filled with NaN just before each call (an unwritten
    tile shows); the W8A16 bf16 tolerance. Then the shapes TMA cannot take
    (odd N): linear past the switch point raises, while the grouped
    decode kernel serves them at M <= 16 (group_checks). Returns the
    largest |diff|."""
    import torch
    from dynamo_tpu_torch.ops import quant
    bf16 = torch.bfloat16
    worst = 0.0
    for si, (name, (k, n)) in enumerate(shapes.items()):
        w = quant_weight(k, n, seed=200 + si)
        g = torch.Generator(device="cuda").manual_seed(400 + si)
        for m in LARGE_M_ROWS:
            x = torch.randn((m, k), generator=g, device="cuda").to(bf16)
            poison = torch.full((1, m, n), float("nan"), dtype=bf16,
                                device="cuda")
            del poison
            got = quant.large_m_gemm(x, w["q"], w["s"])
            torch.cuda.synchronize()
            worst = max(worst, w8a16_check(
                f"w8a16_large_m {name} M={m}", x, w, got))
            del x, got
        tile_m, splits, per, grid = quant.large_m_config(
            1, 512, k, n, torch.cuda.get_device_properties(0)
            .multi_processor_count)
        print(f"w8a16_large_m {name} (K={k}, N={n}; at M 512 tiles of "
              f"{tile_m} rows, {splits} splits of {per} k-blocks, {grid} "
              f"blocks): M = "
              f"{'/'.join(map(str, LARGE_M_ROWS))} within tolerance, no NaN "
              f"left, max_abs_err so far {worst:.3g}", flush=True)
        del w
        torch.cuda.empty_cache()
    for k, n in ((1000, 333), (4100, 1031)):
        w = quant_weight(k, n, seed=k)
        x = torch.randn((quant.GEMV_MAX_M + 1, k), device="cuda").to(bf16)
        raised = None
        try:
            quant.linear(x, w)
        except ValueError as e:
            raised = str(e)
        check(raised is not None and "N % 16" in raised,
              f"linear at K={k}, N={n}, M={quant.GEMV_MAX_M + 1} did not "
              f"refuse the shape TMA cannot take: {raised}")
        print(f"w8a16_large_m at K={k}, N={n}: linear past M = "
              f"{quant.GEMV_MAX_M} raises ({raised})", flush=True)
    return worst


def w8a16_timing(cfg, shapes) -> tuple:
    """CUDA-event times over replayed graphs for each llama3-8b group
    (GROUPS) at M = 8, the weights cycled over copies of the group that
    together pass 128 MiB (a decode step reads each weight once): the
    grouped kernel (one launch), its bound (the group's weight and scale
    bytes, x once and the outputs, over 3.35 TB/s), the old per-weight
    kernel (one launch a weight, summed), the plain version (`x @ wmat(w)`
    a weight), torch.matmul on the bf16 weights (separate products, and one
    product on the concatenated weight), and the grouped kernel at M = 16.
    Then the decode step's sums (L x the layer's groups + the head) and the
    prefill route's times. Returns the kernel's record (one decode step's
    W8A16 work), the dequantize entry's and the tensor-core kernel's."""
    import torch
    from dynamo_tpu_torch.ops import quant
    bf16 = torch.bfloat16
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_group = {}
    keys = ("ms", "m16_ms", "old_ms", "plain_ms", "library_ms",
            "library_concat_ms", "bound_ms")
    tot = {key: 0.0 for key in keys}
    for gi, names in enumerate(GROUPS):
        k = shapes[names[0]][0]
        ns = [shapes[nm][1] for nm in names]
        group_bytes = sum(k * n for n in ns)
        copies = max(1, -(-(128 << 20) // group_bytes))
        ws = [[quant_weight(k, n, seed=700 + 10 * gi + i)
               for i, n in enumerate(ns)] for _ in range(copies)]
        lib_copies = max(1, -(-(128 << 20) // (2 * group_bytes)))
        wb = [[quant.wmat(w, bf16) for w in ws[0]]
              for _ in range(lib_copies)]
        wcat = [torch.cat(b, dim=1) for b in wb] if len(ns) > 1 else None
        x = torch.randn((8, k), device="cuda").to(bf16)
        x16 = torch.randn((16, k), device="cuda").to(bf16)

        def grouped(xx, i):
            c = ws[i % copies]
            return quant.w8a16_group(xx, [w["q"] for w in c],
                                     [w["s"] for w in c])
        rec = {
            "K": k, "N": ns,
            "config": list(quant.group_config(k, ns, sms)),
            "ms": cuda_ms(lambda i: grouped(x, i), 40, graph=True),
            "m16_ms": cuda_ms(lambda i: grouped(x16, i), 40, graph=True),
            "old_ms": cuda_ms(lambda i: [quant.w8a16_gemm(
                x, w["q"], w["s"]) for w in ws[i % copies]], 40,
                graph=True),
            "plain_ms": cuda_ms(lambda i: [x @ quant.wmat(w, bf16)
                                           for w in ws[i % copies]], 10),
            "library_ms": cuda_ms(lambda i: [x @ b for b in
                                             wb[i % lib_copies]], 40,
                                  graph=True)}
        rec["library_concat_ms"] = (
            cuda_ms(lambda i: x @ wcat[i % lib_copies], 40, graph=True)
            if wcat is not None else rec["library_ms"])
        nbytes = sum(k * n + 4 * n + 2 * 8 * n for n in ns) + 2 * 8 * k
        b = bound(nbytes, 2 * 8 * k * sum(ns), "bfloat16")
        rec.update(b, share_of_bound=b["bound_ms"] / rec["ms"],
                   m16_over_m8=rec["m16_ms"] / rec["ms"])
        label = "|".join(names)
        per_group[label] = rec
        reps = 1 if names == ("lm_head",) else cfg.num_layers
        for key in keys:
            tot[key] += reps * rec[key]
        print(f"timing w8a16 group {label} (M=8, K={k}, N={ns}, bf16 x, "
              f"{copies} weight copies, grid {rec['config']}): grouped "
              f"kernel {rec['ms']:.4f} ms (one launch), bound "
              f"{b['bound_ms']:.4f} ms ({nbytes} bytes), "
              f"{rec['share_of_bound']:.1%} of the bound; M = 16 "
              f"{rec['m16_ms']:.4f} ms ({rec['m16_over_m8']:.3f}x M = 8); "
              f"old per-weight kernel {rec['old_ms']:.4f} ms "
              f"({len(ns)} launches); plain {rec['plain_ms']:.4f} ms; "
              f"torch.matmul on bf16 weights {rec['library_ms']:.4f} ms "
              f"separate, {rec['library_concat_ms']:.4f} ms concatenated",
              flush=True)
        del ws, wb, wcat
        torch.cuda.empty_cache()
    print(f"w8a16 per decode step ({len(GROUPS) - 1} x {cfg.num_layers} "
          f"group launches + the head, M = 8): grouped kernel "
          f"{tot['ms']:.3f} ms, bound {tot['bound_ms']:.3f} ms "
          f"({tot['bound_ms'] / tot['ms']:.1%}), M = 16 {tot['m16_ms']:.3f} "
          f"ms, old per-weight kernel {tot['old_ms']:.3f} ms, plain "
          f"{tot['plain_ms']:.3f} ms, torch.matmul on bf16 weights "
          f"{tot['library_ms']:.3f} ms separate / "
          f"{tot['library_concat_ms']:.3f} ms concatenated", flush=True)
    timing = {**tot, "bound_by": "bytes", "per_group": per_group,
              "launch_split": launch_split()}
    large, dequant = large_m_timing(cfg, shapes)
    return timing, dequant, large


def launch_split() -> dict:
    """2d: a decode launch's time split into parts at wk, w_gate and
    lm_head, M = 8 (tools/torch_w8a16_probe.py: an empty launch of each
    kernel's grid, the old kernel's grid streaming its weights only, both
    kernels in full), one line a shape. Returns the probe's record."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                        "torch_w8a16_probe.py")
    spec = importlib.util.spec_from_file_location("torch_w8a16_probe", path)
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    return probe.measure(probe.build_probe(), nvidia_smi())


def large_m_bound(groups: int, m: int, k: int, n: int) -> dict:
    """The tensor-core kernel's bound for `groups` active groups: bytes K N
    + 4 N + 2 M K + 2 M N a group over 3.35 TB/s against 2 M K N
    operations a group over 989 TFLOP/s, the larger."""
    return bound(groups * (k * n + 4 * n + 2 * m * k + 2 * m * n),
                 groups * 2 * m * k * n, "bfloat16")


def weight_copies(k: int, n: int, nbytes: int = 1) -> int:
    """Copies of a [K, N] weight of `nbytes` an element that together pass
    128 MiB, so that cycling through them keeps each read out of the 50 MB
    L2, as a forward pass reads each weight once."""
    return max(1, -(-(128 << 20) // (nbytes * k * n)))


def large_m_timing(cfg, shapes) -> tuple:
    """2d's times of the prefill route, CUDA-event means over replayed
    graphs with the weights cycled past the L2, all in this one call:
    - w_gate at M = 16 / 128 / 512: the tensor-core kernel, its bound, the
      plain version (`x @ wmat(w)`), the library (torch.matmul on the bf16
      weight) and the old route (the dequantize entry + torch.matmul);
    - the switch-point table: the decode kernel and the tensor-core kernel
      at M = 8, 9, 16, 32, 64 for w_gate and wk;
    - one 512-token llama3-8b prefill step's int8 products (7 x 32
      weights at M = 512): the tensor-core kernel, the old route and
      torch.matmul on bf16 weights, each shape timed once and summed over
      the layer and the 32 layers;
    - the dequantize entry alone at w_gate (plain: wmat; library: the old
      route's torch.matmul at M = 512, the product it feeds).
    Returns (the kernel's record, the dequantize entry's record)."""
    import torch
    from dynamo_tpu_torch.ops import quant
    bf16 = torch.bfloat16
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def weights(k, n, seed):
        copies = weight_copies(k, n)
        ws = [quant_weight(k, n, seed=seed + i) for i in range(copies)]
        return ws, copies

    def routes(x, ws, copies, with_plain):
        rec = {
            "ms": cuda_ms(lambda i: quant.large_m_gemm(
                x, ws[i % copies]["q"], ws[i % copies]["s"]), 20,
                graph=True),
            "old_route_ms": cuda_ms(lambda i: x @ quant.dequantize(
                ws[i % copies], bf16), 10, graph=True)}
        if with_plain:
            rec["plain_ms"] = cuda_ms(
                lambda i: x @ quant.wmat(ws[i % copies], bf16), 5)
        wb = [quant.wmat(ws[i], bf16)
              for i in range(weight_copies(*ws[0]["q"].shape, 2))]
        rec["library_ms"] = cuda_ms(lambda i: x @ wb[i % len(wb)], 20,
                                    graph=True)
        return rec

    # w_gate at M = 16 / 128 / 512
    k, n = shapes["w_gate"]
    ws, copies = weights(k, n, 5)
    per_m = {}
    for m in (16, 128, 512):
        x = torch.randn((m, k), device="cuda").to(bf16)
        rec = routes(x, ws, copies, True)
        b = large_m_bound(1, m, k, n)
        rec.update(b, share_of_bound=b["bound_ms"] / rec["ms"],
                   config=list(quant.large_m_config(1, m, k, n, sms)))
        per_m[f"M={m}"] = rec
        print(f"timing w8a16_large_m w_gate (M={m}, K={k}, N={n}, "
              f"{copies} weight copies): kernel {rec['ms']:.4f} ms, bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']}), "
              f"{rec['share_of_bound']:.1%} of the bound; plain "
              f"{rec['plain_ms']:.4f} ms; torch.matmul on the bf16 weight "
              f"{rec['library_ms']:.4f} ms; old route (dequantize + "
              f"torch.matmul) {rec['old_route_ms']:.4f} ms", flush=True)
    deq_ms = cuda_ms(lambda i: quant.dequantize(ws[i % copies], bf16), 20,
                     graph=True)
    deq_plain = cuda_ms(lambda i: quant.wmat(ws[i % copies], bf16), 10)
    deq_b = bound(k * n + 4 * n + 2 * k * n, k * n, "bfloat16")
    # no one PyTorch call computes the dequantize alone; the route's
    # library time (torch.matmul on the bf16 weight at M = 512, the product
    # the entry fed) stands beside it
    dequant = {"ms": deq_ms, "plain_ms": deq_plain, "library_ms": None,
               "route_ms": per_m["M=512"]["old_route_ms"],
               "route_library_ms": per_m["M=512"]["library_ms"],
               "shape": [k, n], **deq_b}
    print(f"w8a16 dequantize entry alone at w_gate: {deq_ms:.4f} ms (plain "
          f"wmat {deq_plain:.4f} ms, bound {deq_b['bound_ms']:.4f} ms)",
          flush=True)
    del ws
    torch.cuda.empty_cache()

    # the switch point: both kernels at the first rows past the decode step
    switch = {}
    for name in ("w_gate", "wk"):
        k, n = shapes[name]
        ws, copies = weights(k, n, 40)
        switch[name] = {}
        for m in (8, 9, 16, 32, 64):
            x = torch.randn((m, k), device="cuda").to(bf16)
            switch[name][m] = {
                "old_decode_ms": cuda_ms(lambda i: quant.w8a16_gemm(
                    x, ws[i % copies]["q"], ws[i % copies]["s"]), 20,
                    graph=True),
                "large_m_ms": cuda_ms(lambda i: quant.large_m_gemm(
                    x, ws[i % copies]["q"], ws[i % copies]["s"]), 20,
                    graph=True)}
            if m <= 16:    # the grouped kernel's rows
                switch[name][m]["decode_ms"] = cuda_ms(
                    lambda i: quant.w8a16_group(
                        x, [ws[i % copies]["q"]], [ws[i % copies]["s"]]),
                    20, graph=True)
        print(f"switch point, {name} (K={k}, N={n}): " + "; ".join(
            f"M={m} " + (f"grouped decode {v['decode_ms']:.4f} / "
                         if "decode_ms" in v else "")
            + f"old decode {v['old_decode_ms']:.4f} / tensor-core "
            f"{v['large_m_ms']:.4f} ms" for m, v in switch[name].items())
            + f" (GEMV_MAX_M = {quant.GEMV_MAX_M})", flush=True)
        del ws
        torch.cuda.empty_cache()

    # one 512-token prefill step's int8 products: 7 x L weights at M = 512
    layer = {"wq": 1, "wk": 2, "wo": 1, "w_gate": 2, "w_down": 1}
    step = {"ms": 0.0, "old_route_ms": 0.0, "library_ms": 0.0,
            "bound_ms": 0.0}
    by_shape = {}
    for name, reps in layer.items():
        k, n = shapes[name]
        ws, copies = weights(k, n, 60)
        x = torch.randn((512, k), device="cuda").to(bf16)
        rec = routes(x, ws, copies, False)
        rec.update(large_m_bound(1, 512, k, n))
        by_shape[name] = rec
        for key in step:
            step[key] += cfg.num_layers * reps * rec[key]
        del ws
        torch.cuda.empty_cache()
    print(f"one 512-token llama3-8b prefill step's int8 products (7 x "
          f"{cfg.num_layers} at M = 512): tensor-core kernel "
          f"{step['ms']:.3f} ms, old route (dequantize + torch.matmul) "
          f"{step['old_route_ms']:.3f} ms, torch.matmul on bf16 weights "
          f"{step['library_ms']:.3f} ms, bound {step['bound_ms']:.3f} ms",
          flush=True)
    main = per_m["M=512"]
    record = {"ms": main["ms"], "plain_ms": main["plain_ms"],
              "library_ms": main["library_ms"],
              "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
              "shape": "w_gate (K 4096, N 14336) at M = 512",
              "old_route_ms": main["old_route_ms"], "per_m": per_m,
              "switch_point": switch, "prefill_step": {**step,
                                                       "by_shape": by_shape}}
    return record, dequant


# -- phase 3: tiny f32 card vs CPU --------------------------------------------

def tree_to(tree, dev):
    """A parameter tree (with quantized {"q", "s"} leaves) on `dev`."""
    if isinstance(tree, dict):
        return {k: tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def phase_small_reference(kv_quant: str = "", quant: str = "",
                          model: str = "tiny") -> dict:
    from dynamo_tpu_torch.engine.config import get_model_config
    from dynamo_tpu_torch.models import llama
    cfg = dataclasses.replace(get_model_config(model), dtype="float32",
                              max_model_len=512, quant=quant)
    params = llama.init_params(cfg, "cpu", seed=0)
    label = (f"{model} f32{' kv_quant=' + kv_quant if kv_quant else ''}"
             f"{' quant=' + quant if quant else ''}")
    return device_reference(cfg, {dev: tree_to(params, dev)
                                  for dev in ("cpu", "cuda")}, label,
                            kv_quant)


def device_reference(cfg, trees: dict, label: str, kv_quant: str = ""
                     ) -> dict:
    """Phase 3's rule: engines on each device's tree ({device: params};
    "cpu" first) give the same greedy tokens, and one decode step over the
    CPU engine's cache gives decode logits within 1e-3 of the CPU's.
    Returns the card's run's kernel launches ({} without a card)."""
    import torch
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import NativeEngine
    from dynamo_tpu_torch.engine.scheduler import SamplingParams
    from dynamo_tpu_torch.models import llama
    ecfg = EngineConfig(page_size=8, num_pages=64, max_slots=4,
                        max_prefill_chunk=32, prefill_buckets=(8, 16, 32),
                        max_model_len=512, kv_quant=kv_quant)
    engines = {dev: NativeEngine(cfg, ecfg, device=dev, params=tree)
               for dev, tree in trees.items()}
    prompt = list(range(5, 45))
    sp = SamplingParams(max_tokens=12, temperature=0.0)
    outs = {"cpu": engines["cpu"].generate(prompt, sp, "r")}
    launches = {}
    for dev in engines:
        if dev == "cpu":
            continue
        # the card's run is a path of its own (for int8 weights in f32:
        # the decode kernel's f32 body, the dequantize entry +
        # torch.matmul past GEMV_MAX_M rows)
        reset_launch_counts()
        e = engines[dev]
        outs[dev] = e.generate(prompt, sp, "r")
        launches = launch_counts()
        check(outs["cpu"] == outs[dev],
              f"{label} greedy tokens differ: cpu {outs['cpu']} {dev} "
              f"{outs[dev]}")
        # the decode path the engine resolved launched the kernel layers x
        # decode steps times (+ the graphs' warm-ups), or never (gather)
        want = (cfg.num_layers * e.decode_window_steps
                + e.graphs.warmup_launches[RAGGED]
                if e.decode_path == "ragged" else 0)
        check(launches[RAGGED] == want, f"{label}: {launches[RAGGED]} ragged "
              f"launches on the {e.decode_path} path, expected {want}")
    # one decode step over the CPU engine's cache (the greedy run's prompt
    # sits in pages 0..6), on every device from identical inputs
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
    err = max(float((logits["cpu"] - x).abs().max()) for x in
              logits.values())
    check(all(bool(torch.isfinite(x).all()) for x in logits.values())
          and err < 1e-3, f"{label} decode logits differ by {err} across "
          f"{list(engines)}")
    print(f"small reference: {label} greedy tokens identical on "
          f"{' and '.join(engines)} ({outs['cpu']}); decode logits "
          f"max_abs_err {err:.3g}; the card's run launched "
          f"{json.dumps(launches)}", flush=True)
    return launches


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


def chat_requests(model: str, sampled: bool = True,
                  max_tokens: int = MAX_TOKENS) -> list:
    """The main path's 8 chat requests: 100-600 byte-token prompts after
    the chat template, max_tokens each; even ones greedy, odd ones sampled
    (temperature 0.8, top_k 50, a seed each), or all greedy."""
    from dynamo_tpu_torch.protocols.openai import ChatCompletionRequest
    reqs = []
    for i, n in enumerate((80, 150, 220, 290, 360, 430, 500, 575)):
        kw = {}
        if sampled and i % 2:
            kw = dict(temperature=0.8, seed=1234 + i, ext={"top_k": 50})
        reqs.append(ChatCompletionRequest(
            model=model, max_tokens=max_tokens,
            messages=[{"role": "user", "content": prompt_text(n, i)}], **kw))
    return reqs


def launch_counts() -> dict:
    """Every kernel wrapper's launch count."""
    from dynamo_tpu_torch.ops import paged_attention as pa
    from dynamo_tpu_torch.ops import quant
    return {RAGGED: pa.KERNEL_LAUNCHES, W8A16: quant.KERNEL_LAUNCHES,
            DEQUANT: quant.DEQUANT_LAUNCHES, MOE: quant.MOE_LAUNCHES,
            LARGE_M: quant.LARGE_M_LAUNCHES}


def reset_launch_counts() -> None:
    """Every kernel wrapper's launch count to 0 (just before a path)."""
    from dynamo_tpu_torch.ops import paged_attention as pa
    from dynamo_tpu_torch.ops import paged_attention_oracle as leg
    from dynamo_tpu_torch.ops import quant
    pa.KERNEL_LAUNCHES = 0
    leg.KERNEL_LAUNCHES = 0
    quant.KERNEL_LAUNCHES = 0
    quant.DEQUANT_LAUNCHES = 0
    quant.MOE_LAUNCHES = 0
    quant.LARGE_M_LAUNCHES = 0


RAGGED, W8A16, MOE = "ragged_decode_attention", "w8a16_gemm", "w8a16_moe_gemm"
LARGE_M, DEQUANT = "w8a16_large_m", "w8a16_dequant"


class StepShapes:
    """The (rows, tokens a row) of every prefill and mixed step an engine
    runs while attached: its device step is wrapped for the run, `detach`
    unwraps it."""

    def __init__(self, engine):
        self.engine = engine
        self.shapes = []
        run = engine._run_device_step

        def recorded(plan, reqs, mixed=False):
            self.shapes.append(tuple(plan.tokens.shape))
            return run(plan, reqs, mixed=mixed)
        engine._run_device_step = recorded

    def detach(self) -> None:
        del self.engine._run_device_step


def decode_w8a16_launches(cfg) -> int:
    """The W8A16 decode-kernel launches of one int8-weight decode step,
    from the model's structure: a layer's products that read the same
    input run as one launch (ops/quant.linear_group) - the attention's q,
    k and v projections, then its output projection; a dense MLP's gate
    and up projections, then its down projection (an MoE layer's experts
    run the grouped expert kernel instead) - and the head is one more."""
    attention = 2                       # q | k | v, then o
    mlp = 0 if cfg.is_moe else 2        # gate | up, then down
    return (attention + mlp) * cfg.num_layers + 1


def int8_product_launches(cfg, shapes) -> dict:
    """The W8A16 launches an int8-weight engine's prefill and mixed steps
    of `shapes` make, derived from their shapes and the routes of
    ops/quant.py: each step of B rows x T tokens runs its layer
    projections at M = B x T (7 a layer, or wq / wk / wv / wo on an MoE
    model, whose experts run grouped at M = B x C rows an expert with the
    dispatch's capacity C = max(int(T k / E x factor), 1)) and its head at
    M = B (the last position of each row). Past GEMV_MAX_M (GROUPED_MAX_M
    for the experts) a product is one tensor-core launch (w8a16_large_m);
    at or below it the products that share an input are one decode-kernel
    launch (4 a layer, or 2 on an MoE model: `decode_w8a16_launches`); the
    dequantize entry is never launched."""
    from dynamo_tpu_torch.ops import quant
    nl = cfg.num_layers
    large = w8 = moe = 0
    for b, t in shapes:
        if b * t > quant.GEMV_MAX_M:
            large += (4 if cfg.is_moe else 7) * nl
        else:
            w8 += decode_w8a16_launches(cfg) - 1
        if cfg.is_moe:
            cap = max(int(t * cfg.num_experts_per_tok / cfg.num_experts
                          * cfg.moe_capacity_factor), 1)
            if b * cap > quant.GROUPED_MAX_M:
                large += 3 * nl
            else:
                moe += 3 * nl
        if b > quant.GEMV_MAX_M:
            large += 1
        else:
            w8 += 1
    return {LARGE_M: large, W8A16: w8, MOE: moe, DEQUANT: 0}

COUNTERS = ("decode_windows", "decode_window_steps", "decode_dispatches",
            "decode_host_syncs", "decode_plan_uploads", "pipeline_windows",
            "pipeline_overlapped", "pipeline_fallbacks", "mixed_steps")


def prefill_launch_check(name: str, engine, shapes, launches: dict,
                         warm0: dict, replay0: dict) -> dict:
    """A run's int8 products outside the decode windows, from its launch
    counts: on an int8-weight engine the tensor-core kernel launched
    exactly as `int8_product_launches` derives from the run's prefill and
    mixed step shapes, the decode kernels' eager launches (the counts less
    what the window graphs' warm-ups and replays added) exactly as derived,
    and the dequantize entry never; a bf16 engine launches neither of the
    first two. Returns the record (the step shapes and the counts)."""
    gr = engine.graphs
    eager = {k: launches[k] - (gr.warmup_launches[k] - warm0[k])
             - (gr.replay_launches[k] - replay0[k])
             for k in (W8A16, MOE, LARGE_M, DEQUANT)}
    if not engine.quant:
        check(launches[LARGE_M] == 0 and launches[DEQUANT] == 0,
              f"{name}: a bf16-weight engine launched int8 products "
              f"{launches}")
        return {"shapes": shapes}
    want = int8_product_launches(engine.model_cfg, shapes)
    got = {LARGE_M: launches[LARGE_M], DEQUANT: launches[DEQUANT],
           W8A16: eager[W8A16], MOE: eager[MOE]}
    check(got == want and eager[LARGE_M] == launches[LARGE_M],
          f"{name}: prefill / mixed steps {shapes} launched {got} (eager; "
          f"{launches} in all), expected {want} from their shapes")
    print(f"{name}: {len(shapes)} prefill / mixed steps (rows x tokens "
          f"{shapes}) launched the tensor-core W8A16 kernel "
          f"{got[LARGE_M]} times, the decode kernels {got[W8A16]} + "
          f"{got[MOE]} (grouped) times eagerly, the dequantize entry 0 "
          "times, as their shapes derive", flush=True)
    return {"shapes": shapes, **got}


async def serve_run(engine, pipe, timed, requests, tag: str, name: str,
                    smi: str, seen_prompts=None) -> dict:
    """One run of the requests through the pipeline, as its own path: the
    launch counts are set to 0 just before it and read just after. Checks
    every request, the kernel launches (num_layers x decode steps, the
    graph replays' launches plus those of the warm-ups before captures),
    one graph replay per decode window and, at depth 2, the pipeline's
    overlap and reused plans; on an MoE engine also the expert dispatch's
    counts (`moe_counts`; seen_prompts: the prompt token ids the engine
    served before, extended here). Returns the run's record and token
    ids."""
    import torch
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
    w0, r0 = dict(gr.warmup_launches), dict(gr.replay_launches)
    if cfg.is_moe:
        moe = MoeCounts(engine)
    step_shapes = StepShapes(engine)
    reset_launch_counts()
    t_run = time.perf_counter()
    try:
        results = await asyncio.gather(*(one(i, r)
                                         for i, r in enumerate(requests)))
    finally:
        step_shapes.detach()
        if cfg.is_moe:
            moe.detach()
    wall = time.perf_counter() - t_run
    all_launches = launch_counts()
    launches = all_launches[RAGGED]
    int8_steps = prefill_launch_check(name, engine, step_shapes.shapes,
                                      all_launches, w0, r0)
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
    moe_rec = None
    if cfg.is_moe:
        moe_rec = moe.check(name, pipe, requests, results,
                            [] if seen_prompts is None else seen_prompts,
                            replays=gr.replay_launches)
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
            "n_prompt": n_prompt, "captured": captured, "moe": moe_rec,
            "all_launches": all_launches, "prefill_steps": int8_steps,
            "stats": {
                "wall_s": wall, "ttft_mean_ms": sum(ttft) / len(ttft) * 1e3,
                "ttft_max_ms": max(ttft) * 1e3,
                **{f"ttft_{k}": v for k, v in quantiles(ttft).items()},
                "decode_tok_s": agg_rate,
                "per_request_tok_s": sum(per_req) / len(per_req),
                "peak_gib": peak / 2**30, "kv_page_bytes": m.kv_page_bytes,
                "graphs_captured": captured, "capture_s": cap_s,
                "warmup_s": warm_s,
                "pool_bytes": pool}}


async def serve_main_path(smi: str, kv_quant: str = "", params=None,
                          depth: int = 2, quant: str = "",
                          model: str = "llama3-8b"):
    """Phase 4 (kv_quant "") or 5 (kv_quant "int8"), on the given weights
    or on random ones from seed 0 (int8 weights with quant "int8"): the 8
    requests served twice, the first run capturing the window graphs and
    the second on the warm engine, then one greedy request served twice.
    Phase 14 serves `model` mixtral-8x7b the same way. Returns (engine,
    capturing run, warm run)."""
    import torch
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import NativeEngine
    from dynamo_tpu_torch.llm.pipeline import LocalPipeline
    from dynamo_tpu_torch.llm.worker import NativeEngineWorker
    from dynamo_tpu_torch.run import build_card
    from dynamo_tpu_torch.runtime.engine import Context

    card = build_card(model)
    cfg = dataclasses.replace(card.model_config(), quant=quant)
    t0 = time.perf_counter()
    engine = NativeEngine(cfg, EngineConfig(kv_quant=kv_quant,
                                            pipeline_depth=depth),
                          eos_token_ids=set(card.eos_token_ids), seed=0,
                          params=params, device="cuda")
    torch.cuda.synchronize()
    name = "int8 serving" if kv_quant else "main path"
    if model != "llama3-8b":
        name = model
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
    seen = []
    first = await serve_run(engine, pipe, timed, requests, "req", name, smi,
                            seen)
    # the ladder (8, 2, 1) x {greedy, fused} at the run's one Pb
    check(first["captured"] <= 6,
          f"{name}: {first['captured']} graphs captured in one run")
    warm = await serve_run(engine, pipe, timed, requests, "warm", name, smi,
                           seen)

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


# -- phase 4 ledger: the depth-2 window with the step ledger off and on ------

def ledger_drive(engine, ers: list) -> tuple:
    """The engine requests admitted together and stepped to the end on the
    calling thread (no worker: the same plans every run): ({request id:
    tokens}, [(new ledger samples, token events) a step], the COUNTERS
    deltas, seconds)."""
    import torch
    before = {k: getattr(engine, k) for k in COUNTERS}
    for er in ers:
        engine.add_request(er)
    toks = {er.request_id: [] for er in ers}
    per_step, n0 = [], len(engine.ledger)
    t0 = time.perf_counter()
    while engine.has_work():
        evs = engine.step()
        n = len(engine.ledger)
        per_step.append((n - n0, sum(e.token is not None for e in evs)))
        n0 = n
        for e in evs:
            if e.token is not None:
                toks[e.request_id].append(e.token)
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return toks, per_step, {k: getattr(engine, k) - v
                            for k, v in before.items()}, secs


def phase_ledger_ab(engine, smi: str, model: str = "llama3-8b") -> dict:
    """Phase 4's ledger A/B on the phase-4 engine (pipeline_depth 2, warm):
    the 8 main-path requests (the same request ids every run) driven
    together once to settle, once with the ledger off
    (`engine.ledger.configure(enabled=False)`) and once with it on. The
    tokens and the pipeline counters of the two must be equal; with the
    ledger off it records nothing; with it on, each decode sample charges
    rows x n steps (n a rung of the window ladder) and the n add up to the
    committed windows' steps, and each step's sample counts as useful the
    token events that step emitted, derived from the streams. Prints ms a
    decode step both ways (run seconds over window steps)."""
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.llm.worker import to_engine_request
    from dynamo_tpu_torch.run import build_card
    name = "main path ledger A/B"
    pre = OpenAIPreprocessor(build_card(model))

    def requests():
        return [to_engine_request(pre.preprocess_chat(r, f"ledger-{i}")[0])
                for i, r in enumerate(chat_requests(model))]
    led = engine.ledger
    led.configure(enabled=True)
    ledger_drive(engine, requests())              # settle the prefix cache
    led.drain()
    led.configure(enabled=False)
    off = ledger_drive(engine, requests())
    check(len(led) == 0 and all(n == 0 for n, _ in off[1]),
          f"{name}: the disabled ledger recorded {len(led)} samples")
    led.configure(enabled=True)
    on = ledger_drive(engine, requests())
    samples = led.drain()
    check(on[0] == off[0], f"{name}: tokens differ with the ledger on: "
          + "; ".join(f"{rid} at {first_difference(on[0][rid], t)}"
                      for rid, t in off[0].items() if on[0][rid] != t))
    check(on[2] == off[2], f"{name}: pipeline counters {on[2]} with the "
          f"ledger on, {off[2]} off")
    check(len(samples) == sum(n for n, _ in on[1])
          and all(n in (0, 1) for n, _ in on[1]),
          f"{name}: {len(samples)} samples drained; the steps added "
          f"{[n for n, _ in on[1]]} (one commit a step at most)")
    ladder = set(engine._window_sizes)
    steps, it = 0, iter(samples)
    for n, events in on[1]:
        for _ in range(n):
            r = next(it)
            if r["kind"] != "decode":
                continue
            nw, rem = divmod(r["tokens_padded"], r["rows"])
            check(rem == 0 and nw in ladder,
                  f"{name}: a decode sample charges {r['tokens_padded']} "
                  f"tokens over {r['rows']} rows, not rows x a rung of "
                  f"{sorted(ladder)}")
            steps += nw
            # one commit a step: the sample's useful tokens are the token
            # events that step emitted
            check(n == 1 and r["tokens_useful"] == events,
                  f"{name}: a decode sample counts {r['tokens_useful']} "
                  f"useful tokens; its step emitted {events}")
    d = on[2]
    check(d["pipeline_fallbacks"] > 0 or steps == d["decode_window_steps"],
          f"{name}: the decode samples' steps add up to {steps}; the "
          f"engine ran {d['decode_window_steps']} window steps")
    check(steps <= d["decode_window_steps"],
          f"{name}: {steps} committed steps of "
          f"{d['decode_window_steps']} dispatched")
    emitted = sum(len(t) for t in on[0].values())
    useful = sum(r["tokens_useful"] for r in samples if r["kind"] == "decode")
    # the rest of the tokens came out of the prefill and mixed steps
    other = sum(ev for (n, ev), r in zip(
        [x for x in on[1] if x[0]], samples) if r["kind"] != "decode")
    check(useful > 0 and useful + other == emitted,
          f"{name}: decode samples count {useful} useful tokens, the other "
          f"steps emitted {other}; the streams hold {emitted}")
    ms = {k: v[3] / max(1, v[2]["decode_window_steps"]) * 1e3
          for k, v in (("off", off), ("on", on))}
    rec = {"tokens": emitted, "decode_useful": useful,
           "samples": len(samples), "decode_steps": steps,
           "counters": d, "ms_per_decode_step": ms,
           "recompiles": sum(r["recompiles"] for r in samples)}
    print(f"{name} [{smi}]: 8 requests at pipeline_depth 2, ledger off "
          f"then on: identical tokens ({emitted}), identical pipeline "
          f"counters {json.dumps(d)}; {len(samples)} samples, the decode "
          f"ones charging {steps} window steps and {useful} useful tokens; "
          f"ms a decode step (run seconds over window steps) off "
          f"{ms['off']:.3f}, on {ms['on']:.3f}", flush=True)
    return rec


# -- phase 4 tuner: the ledger-driven mixed-step budget ----------------------

# the MixedBudgetTuner's documented rule (runtime/autoscaler.py) with the
# evidence floor, cooldown and hysteresis of its fleet_storm leg, on a
# virtual clock of TUNER_TICK_S a step
TUNER = dict(pad_lo=0.10, pad_hi=0.30, step_frac=0.25, min_budget=128,
             max_budget=4096, cooldown_s=4.0, hysteresis_ticks=2,
             min_tokens=64)
TUNER_TICK_S = 2.5
TUNER_REQUESTS = 10


class TunerRule:
    """The tuner's rule recomputed from the ledger's running totals alone
    (no state read from the tuner): the windowed padding waste since the
    last consumed window, the direction, its streak, the cooldown and the
    clamped step."""

    def __init__(self, useful: int, padded: int, floor: int):
        self.u0, self.p0, self.floor = useful, padded, floor
        self.direction, self.streak, self.last_ts = None, 0, None

    def tick(self, useful: int, padded: int, budget: int, ts: float):
        c = TUNER
        dp = padded - self.p0
        if dp < c["min_tokens"]:
            return None
        pad = max(0.0, 1.0 - (useful - self.u0) / dp)
        self.u0, self.p0 = useful, padded
        if budget <= 0:
            return None
        direction = ("shrink" if pad > c["pad_hi"]
                     else "grow" if pad < c["pad_lo"] else None)
        if direction is None:
            self.direction, self.streak = None, 0
        elif direction == self.direction:
            self.streak += 1
        else:
            self.direction, self.streak = direction, 1
        if direction is None or self.streak < c["hysteresis_ticks"]:
            return None
        if self.last_ts is not None \
                and ts - self.last_ts < c["cooldown_s"]:
            return None
        if direction == "shrink":
            target = max(c["min_budget"], int(budget * (1 - c["step_frac"])))
        else:
            target = min(c["max_budget"], int(budget * (1 + c["step_frac"])))
        if target == budget:
            return None
        self.last_ts = ts
        return max(self.floor, target)


def phase_budget_tuner(engine, smi: str) -> dict:
    """Phase 4's tuner leg on the phase-4 engine (see the docstring at the
    top): TUNER_REQUESTS staggered short greedy prompts under the default
    budget, one admitted every 3 steps, a MixedBudgetTuner tick after each
    step on the virtual clock; every adjustment recomputed here
    (TunerRule) from the ledger's totals read at that tick. The budget is
    restored after the leg."""
    import random
    from dynamo_tpu_torch.engine.scheduler import (
        EngineRequest, SamplingParams,
    )
    from dynamo_tpu_torch.runtime.autoscaler import (
        AutoscalerStats, MixedBudgetTuner,
    )
    name = "main path budget tuner"
    t0 = time.perf_counter()
    sch, led = engine.scheduler, engine.ledger
    budget0, enabled0 = sch.mixed_token_budget, led.enabled
    led.configure(enabled=True)
    stats = AutoscalerStats()
    tuner = MixedBudgetTuner(sch, led, stats=stats, **TUNER)
    rule = TunerRule(led.useful_total, led.padded_total,
                     2 * min(engine.cfg.prefill_buckets))
    nonfinite0 = engine.logits_nonfinite_steps()
    rng = random.Random(13)
    want = {}
    pending = []
    for i in range(TUNER_REQUESTS):
        rid = f"tune-{i}"
        want[rid] = 5 + (i % 4)
        pending.append(EngineRequest(rid, [
            rng.randrange(3, 250) for _ in range(rng.randrange(6, 18))],
            SamplingParams(max_tokens=want[rid], temperature=0.0,
                           ignore_eos=True)))
    got = {rid: [] for rid in want}
    engine.add_request(pending.pop(0))
    steps, vts, budgets, expected, applied = 0, 0.0, [], [], []
    while engine.has_work() or pending:
        if pending and steps % 3 == 1:
            engine.add_request(pending.pop(0))
        for ev in engine.step():
            if ev.token is not None:
                got[ev.request_id].append(ev.token)
        steps += 1
        vts += TUNER_TICK_S
        exp = rule.tick(led.useful_total, led.padded_total,
                        sch.mixed_token_budget, vts)
        out = tuner.tick(vts)
        check(out == exp and (exp is None or sch.mixed_token_budget == exp),
              f"{name}: at virtual {vts:.1f} s the tuner applied {out} "
              f"(budget {sch.mixed_token_budget}); the rule recomputed "
              f"from the ledger gives {exp}")
        check(sch.mixed_token_budget > 0, f"{name}: the budget reached 0")
        budgets.append(sch.mixed_token_budget)
        if exp is not None:
            expected.append([round(vts, 1), exp])
        if out is not None:
            applied.append([round(vts, 1), out])
    nonfinite = engine.logits_nonfinite_steps() - nonfinite0
    check(all(len(got[r]) == n for r, n in want.items()) and nonfinite == 0,
          f"{name}: tokens {dict((r, len(t)) for r, t in got.items())} "
          f"of {want}; non-finite logit steps {nonfinite}")
    check(len(applied) >= 1 and applied == expected,
          f"{name}: adjustments {applied}, recomputed {expected}")
    check(stats.budget_adjustments == len(applied),
          f"{name}: AutoscalerStats counts {stats.budget_adjustments}")
    sch.set_mixed_token_budget(budget0)
    led.configure(enabled=enabled0)
    rec = {"budget_initial": budget0, "adjustments": applied,
           "budget_min": min(budgets), "steps": steps,
           "pad_frac": round(led.pad_fraction(), 4),
           "tokens": sum(map(len, got.values())),
           "seconds": time.perf_counter() - t0}
    print(f"{name} [{smi}]: {TUNER_REQUESTS} staggered short greedy "
          f"prompts over {steps} steps under the default budget {budget0}:"
          f" adjustments (virtual s, budget) {json.dumps(applied)}, each the"
          f" rule's recomputation from the ledger's totals; lowest budget "
          f"{min(budgets)}; every stream at its max_tokens, 0 non-finite "
          f"logit steps; budget restored to {budget0}", flush=True)
    return rec


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


def phase_graph_vs_eager(engine, label: str, model: str = "llama3-8b"
                         ) -> dict:
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
    card = build_card(model)
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
        fused=fused, path=engine.decode_path,
        window_bufs=staged.get("window_bufs"))[0].cpu().numpy()


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
    step_shapes = StepShapes(engine)
    reset_launch_counts()
    t_run = time.perf_counter()

    async def unary(body):
        status, _, raw = await _http(svc.port, "POST",
                                     "/v1/chat/completions", body)
        check(status == 200, f"{name}: status {status}: {raw[:200]}")
        return json.loads(raw)

    try:
        results = await asyncio.gather(*(
            _sse(svc.port, b) if b.get("stream") else unary(b)
            for b in bodies))
    finally:
        step_shapes.detach()
    wall = time.perf_counter() - t_run
    launches = launch_counts()
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
    per_step = decode_w8a16_launches(cfg)
    for key, calls in gr.captured_calls().items():
        nw = key[4]
        check(calls[W8A16] == per_step * nw and calls[RAGGED] == nl * nw,
              f"{name}: graph {key} holds {calls}, expected "
              f"{per_step * nw} W8A16 and {nl * nw} ragged launches")
    check(replayed[W8A16] == per_step * steps
          and replayed[RAGGED] == nl * steps
          and launches[RAGGED] == nl * steps + warm[RAGGED],
          f"{name}: replays added {replayed} launches over {steps} decode "
          f"steps; ragged launches {launches[RAGGED]} (warm-ups "
          f"{warm[RAGGED]})")
    prefill = prefill_launch_check(name, engine, step_shapes.shapes, launches,
                                   g0[1], g0[2])
    eager_w8 = prefill[W8A16]
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
           "prefill_steps": prefill,
           "decode_steps": steps, "ttft_count": n_ttft, "itl_count": n_itl,
           "counters": d}
    print(f"{name}: 8 chat requests over HTTP (4 SSE, 4 unary), completion "
          f"tokens {completion}, finish {finishes}; wall {wall:.3f} s; "
          f"counters {json.dumps(d)}; graph replays {replays}; launches "
          f"{json.dumps(launches)} = replays {json.dumps(replayed)} "
          f"({per_step} x {steps} W8A16, {nl} x {steps} ragged) + "
          f"warm-ups {json.dumps(warm)} + the prefill and mixed steps' "
          f"{prefill[LARGE_M]} tensor-core and {eager_w8} decode-kernel "
          "W8A16 launches", flush=True)
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
    # the int8-weight window as graph and eager (identical tokens), and
    # the untraced ms a decode step
    runs["graph_vs_eager"] = phase_graph_vs_eager(engine, "int8 weights")
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

def phase_entry_point(model: str = "tiny") -> dict:
    """`python -m dynamo_tpu_torch.run in=http:0 out=native <model> --quant
    int8` on the card (tiny, then tiny-moe): READY, one streamed chat
    ending in [DONE], then the process is stopped."""
    import queue
    import signal
    import threading
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "dynamo_tpu_torch.run", "in=http:0",
           "out=native", model, "--quant", "int8"]
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
        m = re.match(rf"READY http=:(\d+) model={model}\b", line)
        check(m is not None, f"entry point: {line!r}")
        ready_s = time.perf_counter() - t0
        frames, done, first, _ = asyncio.run(asyncio.wait_for(_sse(
            int(m.group(1)), {"model": model, "stream": True,
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
DIST_PAGE = 64            # the registry models' KV page size
# phase 11's workers: prefill steps and decode windows alternate, one
# sequence a prefill step, so no stream's arithmetic follows what else
# arrived with it
DIST_SCHEDULE = ("--mixed-token-budget", "0", "--max-prefill-batch", "1")


# the lease TTL of every child process (seconds)
CHILD_LEASE_TTL_S = "30"


# 11g: while CHILD_LOGS["dir"] is set (phase 11), every Child runs with
# DYN_LOG naming one port module at debug, JSONL records and a
# DYN_LOG_FILE of its own there (utils/logconfig.py); `files` lists them
CHILD_LOGS = {"dir": None, "files": []}
SERVER_MODULE = "dynamo_tpu_torch.runtime.transports.server"
# the module a child's DYN_LOG names: the server's connection records, and
# every other child's runtime (its connect and lease records)
DEBUG_TARGET = {"server": "dynamo_tpu_torch.controlplane",
                "client": "dynamo_tpu_torch.runtime"}


def child_log_env(name: str, module: str) -> tuple:
    """(11g's logging environment for a child, its log file): empty and
    None outside phase 11."""
    if CHILD_LOGS["dir"] is None:
        return {}, None
    target = DEBUG_TARGET["server" if module == SERVER_MODULE else "client"]
    slug = re.sub(r"[^a-z0-9]+", "-", name.lower()).strip("-")
    path = os.path.join(CHILD_LOGS["dir"],
                        f"{len(CHILD_LOGS['files']):02d}-{slug}.jsonl")
    CHILD_LOGS["files"].append({"child": name, "path": path,
                                "target": target})
    return {"DYN_LOG": f"info,{target}=debug", "DYN_LOGGING_JSONL": "1",
            "DYN_LOG_FILE": path}, path


class Child:
    """A subprocess of the phase (`python -m <args>` from the checkout's
    root) whose merged output a thread drains into a queue."""

    def __init__(self, name: str, args: list, session: bool = False,
                 env=None):
        import queue
        import threading
        self.name = name
        self.lines: list = []
        self._q: queue.Queue = queue.Queue()
        root = os.path.dirname(os.path.abspath(__file__))
        log_env, self.log_file = child_log_env(name, args[0])
        env = {**os.environ, "DYN_LEASE_TTL_S": CHILD_LEASE_TTL_S,
               **log_env, **(env or {})}
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


def _routed_key(request_id: str) -> tuple:
    """(prefix, turn) of a routed round's request id `kv-p<p>-u<u>`."""
    m = re.fullmatch(r"kv-p(\d+)-u(\d+)", request_id)
    return int(m.group(1)), int(m.group(2))


def _leading_pages(toks: list, stored: set, page: int) -> int:
    """The leading full pages of a prompt found in `stored`, counted as the
    port scheduler counts its hits (of the first (len - 1) // page)."""
    n_full, h = (len(toks) - 1) // page, 0
    while h < n_full and tuple(toks[:(h + 1) * page]) in stored:
        h += 1
    return h


def _prompt_pages(toks: list, page: int) -> set:
    return {tuple(toks[:(i + 1) * page]) for i in range(len(toks) // page)}


# the JAX serving default's constants (dynamo_tpu/kv_router/scheduler.py
# TransferAwareSelector, observability/fleet.py TransferCostModel): a link
# no transfer has measured prices at the 1e9 B/s prior; the cost is
# normalized by a 0.25 s horizon and capped at 4; the standard QoS class
# (a request without a class) weighs it 1.0
COLD_PRIOR_BPS = 1e9
HORIZON_S = 0.25
MAX_PENALTY = 4.0
STANDARD_WEIGHT = 1.0


def kv_page_bytes(cfg, page: int) -> int:
    """Bytes of one unquantized KV page (k and v over every layer), from
    the model config: 8 MiB a bf16 page at llama3-8b."""
    item = {"bfloat16": 2, "float32": 4}[cfg.dtype]
    return 2 * cfg.num_layers * cfg.num_kv_heads * page * cfg.head_dim * item


def routing_gate(name: str, tokens: dict, decisions: list,
                 page: int, page_bytes: int) -> tuple:
    """Phase 11's routing gate: what the JAX serving default
    (kv_router/scheduler.py TransferAwareSelector over the cold transfer
    cost model) promises, for each of the routed round's 16 decisions in
    the order the router made them:
    (a) each candidate's recorded matched_blocks equal the pages of the
        request's prompt that candidate holds, derived from the token ids:
        a wave-1 prefix is fresh (0 everywhere); a wave-2 request shares
        the leading pages of its prefix's wave-1 request, which the worker
        that served that request holds; another worker holds them only
        once an earlier wave-2 request of the same prefix went there, and
        then the router may not have applied its events yet (0 or them);
    (b) the whole logit, recomputed here for every candidate:
        2 x overlap - kv_usage - active - w x min(4, cost / 0.25)
        - (1 - health), with overlap = matched x page / isl, cost = the
        pages the candidate lacks (ceil(isl / page) - matched) x
        `page_bytes` (derived from the model) over the 1e9 B/s cold prior,
        w the standard class's weight 1.0 and health the recorded one;
        the recorded overlap, transfer bytes and seconds equal the derived
        ones (rounded as the selector rounds them), every link is cold,
        each recorded logit equals the recomputed one within the
        selector's 4-digit rounding of it and of kv_usage, active and
        health (4 x 5e-5 = 2e-4), and the chosen worker has the highest
        recorded logit.
    Returns (how many wave-2 requests went to their prefix's worker, the
    sorted set of pages a wave-2 request shares with its prefix)."""
    went, held, on_prefix, shared = {}, {}, 0, set()
    for d in decisions:
        p, u = _routed_key(d["request_id"])
        toks = tokens[(p, u)]
        c = _leading_pages(toks, _prompt_pages(tokens[(p, 0)], page),
                           page) if u else 0
        prefix_w = went.get((p, 0))
        check(u == 0 or prefix_w is not None,
              f"{name}: {d['request_id']} decided before its prefix")
        cands = d.get("candidates") or []
        check(len(cands) == 2, f"{name}: {d['request_id']} was scored on "
              f"{len(cands)} candidates")
        isl = max(len(toks), 1)
        required = -(-isl // page)
        logits, recorded = {}, {}
        for cand in cands:
            w = cand["worker_id"]
            allowed = ({0} if u == 0 else {c} if w == prefix_w
                       else {0, c} if w in held.get(p, ()) else {0})
            m = cand["matched_blocks"]
            check(m in allowed,
                  f"{name}: {d['request_id']}: the router matched "
                  f"{m} pages on {w}; the token ids "
                  f"and where its prefix went derive {sorted(allowed)}: "
                  f"{json.dumps(d)}")
            overlap = m * page / isl
            nbytes = max(0, required - m) * page_bytes
            cost = nbytes / COLD_PRIOR_BPS
            norm = min(MAX_PENALTY, cost / HORIZON_S)
            health = cand["health"]
            check(cand["qos"] == "standard"
                  and cand["qos_weight"] == STANDARD_WEIGHT
                  and cand["cold"] is True and 0.0 < health <= 1.0
                  and cand["overlap"] == round(overlap, 4)
                  and cand["transfer_bytes"] == nbytes
                  and cand["pool_blocks"] == 0
                  and cand["transfer_s"] == round(cost, 6)
                  and cand["transfer_norm"] == round(norm, 4),
                  f"{name}: {d['request_id']} on {w}: recorded {cand}; "
                  f"derived overlap {overlap:.6f}, {nbytes} bytes to move "
                  f"({required} pages less {m}), {cost:.6f} s at the cold "
                  "prior, the standard class")
            logits[w] = (2.0 * overlap - cand["kv_usage"] - cand["active"]
                         - STANDARD_WEIGHT * norm - (1.0 - health))
            recorded[w] = cand["logit"]
            check(abs(logits[w] - cand["logit"]) <= 2e-4,
                  f"{name}: {d['request_id']}: recorded logit "
                  f"{cand['logit']} on {w}, recomputed {logits[w]:.6f}")
        check(recorded.get(d["worker_id"]) == max(recorded.values()),
              f"{name}: {d['request_id']} went to {d['worker_id']}, not "
              f"an arg-max of the selector's logits {json.dumps(recorded)}"
              f" (recomputed {json.dumps(logits)})")
        went[(p, u)] = d["worker_id"]
        held.setdefault(p, set()).add(d["worker_id"])
        if u:
            shared.add(c)
            on_prefix += d["worker_id"] == prefix_w
    return on_prefix, sorted(shared)


def routed_prefix_hits(tokens: dict, decisions: list, page: int) -> set:
    """The (hits, lookups) totals the workers' $STATS may add over the
    routed round, derived from where each request went (the decisions'
    order): a request hits the leading pages of its prompt that its worker
    stored for an earlier request and looks up min(hits + 1, (len - 1) //
    page). Wave 1 finished before wave 2 was sent, so its pages are
    stored; an earlier wave-2 request's pages on the same worker may not
    be sealed yet when a later one is admitted, so that request counts
    either way (a set of totals)."""
    certain, maybe, totals = {}, {}, {(0, 0)}
    for d in decisions:
        p, u = _routed_key(d["request_id"])
        toks, w = tokens[(p, u)], d["worker_id"]
        n_full = (len(toks) - 1) // page
        ways = set()
        for stored in (certain.get(w, set()),
                       certain.get(w, set()) | maybe.get(w, set())):
            h = _leading_pages(toks, stored, page)
            ways.add((h, min(h + 1, n_full)))
        totals = {(a + h, b + k) for a, b in totals for h, k in ways}
        (maybe if u else certain).setdefault(w, set()).update(
            _prompt_pages(toks, page))
    return totals


def _ttft_buckets(text: str, family: str = "llm_ttft_seconds") -> dict:
    """{upper bound: cumulative count} of a /metrics text's histogram
    buckets of `family`, summed over its label series."""
    cum: dict = {}
    for m in re.finditer(rf'^{family}_bucket\{{[^}}]*le="([^"]+)"\}} '
                         r'(\d+)$', text, re.M):
        le = float(m.group(1))
        cum[le] = cum.get(le, 0) + int(m.group(2))
    return cum


def _ttft_quantiles(after: str, before: str = "",
                    family: str = "llm_ttft_seconds",
                    key: str = "ttft") -> dict:
    """TTFT (or, by `family`, ITL) p50 / p90 (ms) of the requests observed
    between two /metrics texts of one frontend, from the histogram's
    bucket counts (the registry's estimator)."""
    from dynamo_tpu_torch.observability.metrics import _bucket_quantile
    old = _ttft_buckets(before, family)
    cum = {le: n - old.get(le, 0)
           for le, n in _ttft_buckets(after, family).items()}
    bounds = sorted(cum)
    counts = [cum[b] - (cum[bounds[i - 1]] if i else 0)
              for i, b in enumerate(bounds)]
    total = cum[bounds[-1]] if bounds else 0
    return {f"{key}_p{int(q * 100)}_ms":
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


async def drive_distributed(coord: str, fe_port: int, fe2_port: int,
                            model: str, sys_len: int, n_layers: int,
                            smi: str, on_card: bool = True,
                            exporter_port: int = 0) -> dict:
    """Phase 11's traffic and checks against running processes (see the
    phase docstring). `coord`: the control-plane pair in the comma form.
    `on_card=False` (workers on the CPU, a rehearsal of the phase) skips
    the kernel-launch checks: CPU tensors take the kernels' plain
    versions. `exporter_port`: the standalone exporter's /metrics; the
    standalone router service serves `dynamo.router.route` and
    `dynamo.router.state`. Ends with 11h's reference streams: the 4
    H11 chats, one at a time, through the KV-routed frontend."""
    from dynamo_tpu_torch.engine.config import get_model_config
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.protocols.openai import ChatCompletionRequest
    from dynamo_tpu_torch.runtime.distributed import connect_coordinator
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

    rt = await connect_coordinator(coord)
    try:
        client = await rt.namespace("dynamo").component("llm").endpoint(
            "generate").client().start()
        # a warm-up round of the same shapes on other prefixes captures
        # the window graphs, so that neither measured round pays for them
        t0 = time.perf_counter()
        await _waves(fe_port, dist_requests(model, 8, sys_len), model,
                     "warm")
        warm_s = time.perf_counter() - t0

        # the warm-up's tail must not skew where the prefixes land: both
        # workers idle, then two more of the routers' scrapes (every 0.5
        # s), so that their snapshots hold these reads and no bumps
        async def idle():
            got = await client.scrape_stats(timeout=10.0)
            return len(got) == 2 and all(
                st["request_active_slots"] == 0 for st in got.values())
        await _poll(f"{name}: both workers idle after the warm-up", idle, 60)
        await asyncio.sleep(1.5)
        s0 = await _scrape(client, 2)
        text0 = (await _http(fe_port, "GET", "/metrics"))[2].decode()
        routed = dist_requests(model, 0, sys_len)
        t0 = time.perf_counter()
        res, order = await _waves(fe_port, routed, model, "kv")
        wall = time.perf_counter() - t0
        s1 = await _scrape(client, 2)
        state = await _get_json(fe_port, "/router/state")
        text = (await _http(fe_port, "GET", "/metrics"))[2].decode()

        # the router's side: every decision is the reference selector's
        dec = {d["request_id"]: d
               for d in state["models"][model]["decisions"]}
        check(all(r in dec for r in order),
              f"{name}: decisions missing for "
              f"{[r for r in order if r not in dec]}")
        page = card.kv_page_size
        tokens = {(p, u): pre.preprocess_chat(
            ChatCompletionRequest.from_json(b))[0].token_ids
            for p, u, b in routed}
        decisions = [d for d in state["models"][model]["decisions"]
                     if d["request_id"] in order]
        mcfg = get_model_config(model)
        on_prefix, shared = routing_gate(name, tokens, decisions, page,
                                         kv_page_bytes(mcfg, page))
        # the selector's margin on each decision: the winner's logit less
        # the best other candidate's, and where each load snapshot came
        # from (scraped this cycle, carried forward, defaulted)
        margins, sources = [], {}
        for p, u in tokens:
            cands = dec[f"kv-p{p}-u{u}"].get("candidates") or []
            won = [c["logit"] for c in cands
                   if c["worker_id"] == dec[f"kv-p{p}-u{u}"]["worker_id"]]
            rest = [c["logit"] for c in cands
                    if c["worker_id"] != dec[f"kv-p{p}-u{u}"]["worker_id"]]
            if won and rest:
                margins.append(round(won[0] - max(rest), 4))
            for c in cands:
                sources[c["snapshot"]] = sources.get(c["snapshot"], 0) + 1
        print(f"{name}: router decisions' logit margins (winner less the "
              f"best other) {sorted(margins)}; candidate snapshots "
              f"{json.dumps(sources)}", flush=True)
        fallbacks = re.search(r"^llm_router_fallbacks (\S+)$", text, re.M)
        check(fallbacks is not None and float(fallbacks.group(1)) == 0,
              f"{name}: llm_router_fallbacks "
              f"{fallbacks and fallbacks.group(1)}")

        # the workers' side: their summed prefix hits are those derived
        # from where each request went
        want = routed_prefix_hits(tokens, decisions, page)
        hits = _delta(s1, s0, "gpu_prefix_cache_hits")
        lookups = _delta(s1, s0, "gpu_prefix_cache_lookups")
        admitted = _delta(s1, s0, "requests_admitted")
        per_worker = {w: s1[w]["requests_admitted"]
                      - s0[w]["requests_admitted"] for w in s1}
        check((hits, lookups) in want and admitted == 16,
              f"{name}: the workers hit {hits} of {lookups} prefix pages "
              f"over {admitted} requests; where the 16 went derives "
              f"{sorted(want)}")
        for w, st in s1.items():
            check(st["decode_dispatches"] == st["decode_windows"],
                  f"{name}: worker {w} ran {st['decode_windows']} decode "
                  f"windows in {st['decode_dispatches']} dispatches")
        routed_q = {**_ttft_quantiles(text, text0), **_ttft_quantiles(
            text, text0, "llm_itl_seconds", "itl")}

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
        ledger = ledger_gate(name, s0, s1, s4, mcfg, smi)
        services = await standalone_gates(name, rt, client, tokens,
                                          exporter_port, page)
        services["autoscaler_gauges"] = await autoscaler_gauges_gate(
            name, {"frontend": fe_port, "round-robin frontend": fe2_port,
                   "exporter": exporter_port})
        fst = await _get_json(fe_port, "/router/state")
        check(fst["models"][model]["indexer"] == "native",
              f"{name}: the frontend's router runs the "
              f"{fst['models'][model]['indexer']} radix tree")
        await client.stop()
        h11_reference = [await h11_stream(fe_port, body, f"h11-ref-{i}")
                         for i, body in enumerate(h11_chats(model, sys_len))]
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
           "expected": sorted(want), "on_prefix_worker": on_prefix,
           "kv_routed": {"hit_share": hits / lookups, **routed_q},
           "round_robin": {"hit_share": rr_hits / rr_lookups,
                           "hits": rr_hits, "lookups": rr_lookups, **rr_q},
           "launches": launches, "decode_window_steps": {
               w: st["decode_window_steps"] for w, st in s4.items()},
           "decode_windows": {w: st["decode_windows"]
                              for w, st in s4.items()},
           "ledger": ledger, "services": services,
           "h11_reference": h11_reference}
    print(f"{name}: after a warm-up round of the same shapes "
          f"({warm_s:.3f} s), 16 chat requests (8 SSE, 8 unary; 8 greedy, "
          f"8 sampled) over 4 system prompts of {sys_len} byte-tokens "
          f"answered in {wall:.3f} s; requests per worker {json.dumps(per_worker)}; "
          f"{on_prefix} of 12 wave-2 requests on their prefix's worker "
          f"({shared} pages shared with it), every decision the JAX default "
          f"selector's arg-max, its whole logit (transfer and health terms "
          f"included) recomputed with the matched pages derived from the "
          f"token ids; prefix hits {hits} of {lookups} (derived "
          f"from where each went: {sorted(want)}); router fall-backs 0; "
          f"ragged launches {json.dumps(launches)}",
          flush=True)
    print(f"{name} [two replicas sharing one card: {smi}]: KV-routed "
          f"frontend prefix hit share {hits / lookups:.4f}, TTFT p50 "
          f"{routed_q['ttft_p50_ms']:.1f} ms, p90 "
          f"{routed_q['ttft_p90_ms']:.1f} ms, ITL p50 "
          f"{routed_q['itl_p50_ms']:.1f} ms, p90 "
          f"{routed_q['itl_p90_ms']:.1f} ms (through the pipeline graph's "
          f"Segment); round-robin frontend "
          f"(--no-kv-routing, 4 fresh prefixes) hit share "
          f"{rr_hits / rr_lookups:.4f}, TTFT p50 {rr_q['ttft_p50_ms']:.1f} "
          f"ms, p90 {rr_q['ttft_p90_ms']:.1f} ms (llm_ttft_seconds)",
          flush=True)
    return rec


# the card's dense bf16 peak (NVIDIA's H100 SXM data sheet, no sparsity),
# which phase 11's workers get as DYN_PEAK_TFLOPS for the ledger's MFU
PEAK_BF16_TFLOPS = 989.0


def ledger_flops_per_token(cfg) -> float:
    """The MFU numerator's FLOPs a decoded token, from the model config:
    2 x (layers x (attention projections + MLP, active experts only) +
    d x vocab) for the matmuls, plus 5 x vocab for the sampling tail;
    1.501e10 at llama3-8b."""
    d = cfg.hidden_size
    q = cfg.num_heads * cfg.head_dim
    kv = cfg.num_kv_heads * cfg.head_dim
    mlp = 3 * d * cfg.intermediate_size * (
        cfg.num_experts_per_tok if cfg.num_experts else 1)
    return (2.0 * (cfg.num_layers * (2 * d * q + 2 * d * kv + mlp)
                   + d * cfg.vocab_size) + 5.0 * cfg.vocab_size)


def ledger_gate(name: str, s0: dict, s1: dict, s4: dict, cfg,
                smi: str) -> dict:
    """Phase 11's ledger gate on each worker's $STATS (the workers run with
    DYN_PEAK_TFLOPS = PEAK_BF16_TFLOPS): steps recorded, no new program
    key across the measured round (s0 before it, s1 after), and
    engine_mfu = engine_tok_s x F / peak to the rounding of both figures
    (F from `ledger_flops_per_token`). The keys are the JAX engine's: on
    the ragged path its window key holds the gather base width and not
    the penalty history's width that the window graph's key holds, so an
    unchanged count says no new JAX program key, not that no graph was
    captured (observability/ledger.py)."""
    flops = ledger_flops_per_token(cfg)
    peak = PEAK_BF16_TFLOPS * 1e12
    out = {}
    for w, st in s4.items():
        want = st["engine_tok_s"] * flops / peak
        check(st["engine_steps"] > 0 and st["engine_tok_s"] > 0,
              f"{name}: worker {w} ledger: {st['engine_steps']} steps, "
              f"{st['engine_tok_s']} tok/s")
        new_keys = s1[w]["engine_recompiles"] - s0[w]["engine_recompiles"]
        check(new_keys == 0, f"{name}: worker {w} saw {new_keys} new "
              "program keys in the measured round")
        check(abs(st["engine_mfu"] - want) <= 1e-6,
              f"{name}: worker {w} engine_mfu {st['engine_mfu']}, "
              f"engine_tok_s {st['engine_tok_s']} x {flops:.6g} FLOP / "
              f"{peak:.4g} = {want:.8f}")
        out[w] = {k: st[k] for k in ("engine_steps", "engine_recompiles",
                                     "engine_tok_s", "engine_mfu",
                                     "engine_pad_frac")}
    print(f"{name} [{smi}; DYN_PEAK_TFLOPS {PEAK_BF16_TFLOPS}, the H100 SXM "
          f"dense bf16 peak]: each worker's step ledger "
          f"{json.dumps(out)}; {flops:.6g} FLOP a token; no new program "
          "key in the measured round", flush=True)
    return out


async def standalone_gates(name: str, rt, client, tokens: dict,
                           exporter_port: int, page: int) -> dict:
    """With both workers idle: the standalone router service answers
    `route` for each system prompt with a worker that holds at least its
    16 pages; the standalone exporter's per-worker llm_requests_total_slots
    / llm_kv_blocks_total / llm_kv_blocks_active equal the workers' $STATS;
    a FleetRollup here records worker/{w}/{field} series equal to the same
    $STATS and fleet/workers_live 2."""
    from dynamo_tpu_torch.observability.fleet import (
        WORKER_FIELDS, FleetRollup, parse_prometheus_text,
    )
    t0 = time.perf_counter()
    rclient = await rt.namespace("dynamo").component("router").endpoint(
        "route").client().start()
    await rclient.wait_for_instances(60)
    routes = {}
    for (p, u), toks in sorted(tokens.items()):
        if u != 1:
            continue
        frames = [f async for f in await rclient.generate(
            {"token_ids": list(toks)})]
        check(len(frames) == 1 and frames[0].get("worker_id") in client
              .instances and frames[0]["overlap_blocks"] >= 16,
              f"{name}: the router service routed prefix {p} as {frames}")
        routes[p] = frames[0]
    await rclient.stop()
    # the router service's `state`: the native radix tree, every event
    sclient = await rt.namespace("dynamo").component("router").endpoint(
        "state").client().start()
    await sclient.wait_for_instances(60)
    rstate = [f async for f in await sclient.generate({})]
    await sclient.stop()
    check(len(rstate) == 1 and rstate[0]["indexer"] == "native"
          and sorted(rstate[0]["instances"]) == sorted(client.instances),
          f"{name}: the router service's state {rstate}")

    async def exporter_equal():
        st = await client.scrape_stats(timeout=10.0)
        text = (await _http(exporter_port, "GET", "/metrics"))[2].decode()
        fams = parse_prometheus_text(text)
        for w, row in st.items():
            for fam, key in (("llm_requests_total_slots",
                              "request_total_slots"),
                             ("llm_kv_blocks_total", "kv_total_blocks"),
                             ("llm_kv_blocks_active", "kv_active_blocks")):
                if fams.get(fam, {}).get(f'{{worker="{w}"}}') != row[key]:
                    return None
        return len(st) == 2 and {w: {k: row[k] for k in (
            "request_total_slots", "kv_total_blocks", "kv_active_blocks")}
            for w, row in st.items()}
    exported = await _poll(f"{name}: the exporter's gauges equal to $STATS",
                           exporter_equal, 60)

    rollup = FleetRollup(client, interval_s=1.0)

    async def rollup_equal():
        ts = time.time()
        snap = await rollup.scrape_once(ts=ts)
        st = await client.scrape_stats(timeout=10.0)
        store = rollup.store
        if snap["workers"] != 2 or len(st) != 2 \
                or store.get("fleet/workers_live").latest() != 2.0:
            return None
        for w, row in st.items():
            for f in WORKER_FIELDS:
                got = store.get(f"worker/{w}/{f}")
                if got is None or got.latest() != float(row.get(f, 0)):
                    return None
        return snap
    await _poll(f"{name}: the fleet rollup's series equal to $STATS",
                rollup_equal, 60)
    out = {"routes": routes, "exported": exported,
           "router_state": rstate[0],
           "rollup_series": len(rollup.store),
           "seconds": time.perf_counter() - t0}
    print(f"{name}: standalone router service routed the 4 system prompts "
          f"to {json.dumps({p: [r['worker_id'], r['overlap_blocks']] for p, r in routes.items()})}"
          f" (worker, matched pages); standalone exporter's per-worker "
          f"gauges equal $STATS {json.dumps(exported)}; a FleetRollup "
          f"recorded {len(rollup.store)} series equal to $STATS, "
          f"fleet/workers_live 2; the router service's index runs the "
          f"{rstate[0]['indexer']} radix tree ({rstate[0]['events_applied']}"
          f" events applied); {out['seconds']:.2f} s", flush=True)
    print(f"phase seconds: 11 services {out['seconds']:.1f}", flush=True)
    return out


def reliability_counts(text: str) -> dict:
    """The frontend's reliability counters in a /metrics text:
    migrations, retries and hedges fired."""
    out = {}
    for key, metric in (("migrations", "llm_reliability_migrations_total"),
                        ("retries", "llm_reliability_retries_total"),
                        ("hedges", "llm_hedge_fired")):
        m = re.search(rf"^{metric} (\S+)$", text, re.M)
        check(m is not None, f"/metrics has no {metric}")
        out[key] = float(m.group(1))
    return out


KILL_TOKENS = 128
KILL_AT = 8        # every stream holds this many tokens at the kill
KILL_TOP = 8       # top logprobs a token


class Stream:
    """One streamed chat read frame by frame: its logprob entries (the
    token string, its logprob, the top values), text, finish reasons,
    usage, error frames and each frame's arrival time."""

    def __init__(self, rid: str):
        self.rid = rid
        self.entries: list = []
        self.text = ""
        self.finish: list = []
        self.usage = None
        self.done = False
        self.errors: list = []
        self.times: list = []
        self.first_frame = asyncio.Event()

    def feed(self, event: str, payload: str) -> None:
        self.times.append(time.perf_counter())
        self.first_frame.set()
        if event == "error":
            self.errors.append(payload)
            return
        if payload == "[DONE]":
            self.done = True
            return
        frame = json.loads(payload)
        if frame.get("usage"):
            self.usage = frame["usage"]
        for c in frame.get("choices", []):
            self.text += (c.get("delta") or {}).get("content") or ""
            for e in (c.get("logprobs") or {}).get("content") or ():
                self.entries.append((e["token"], e["logprob"], sorted(
                    (t["logprob"] for t in e["top_logprobs"]),
                    reverse=True)))
            if c.get("finish_reason"):
                self.finish.append(c["finish_reason"])
                if c["finish_reason"] == "error":
                    self.errors.append(frame)


async def _stream_into(port: int, body: dict, st: Stream,
                       on_frame=None) -> Stream:
    """Send a streamed chat (x-request-id st.rid) and feed every SSE
    event into `st`, calling on_frame() after each."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        writer.write(_head("POST", "/v1/chat/completions",
                           json.dumps(body).encode(),
                           {"x-request-id": st.rid}))
        await writer.drain()
        head = (await reader.readuntil(b"\r\n\r\n")).decode("latin-1")
        check(" 200 " in head.split("\r\n")[0],
              f"{st.rid}: SSE status {head[:40]}")
        buf = b""
        while True:
            size = int((await reader.readuntil(b"\r\n")).strip(), 16)
            if size == 0:
                break
            buf += await reader.readexactly(size)
            await reader.readexactly(2)
            while b"\n\n" in buf:
                block, buf = buf.split(b"\n\n", 1)
                lines = block.decode().split("\n")
                event = next((x[6:].strip() for x in lines
                              if x.startswith("event:")), "")
                st.feed(event, "\n".join(x[5:].lstrip(" ") for x in lines
                                         if x.startswith("data:")))
                if on_frame is not None:
                    on_frame()
    finally:
        writer.close()
        await writer.wait_closed()
    return st


def kill_body(model: str, p: int, u: int, sys_len: int) -> dict:
    """Phase 11k's request (prefix seed p, user turn u): the phase's
    shapes, greedy, streamed with usage and the top logprobs."""
    return {"model": model, "max_tokens": KILL_TOKENS, "stream": True,
            "stream_options": {"include_usage": True}, "logprobs": True,
            "top_logprobs": KILL_TOP, "messages": [
                {"role": "system", "content": dist_text(sys_len, 1000 + p)},
                {"role": "user", "content": dist_text(
                    64 + 32 * u + 7 * p, 4 * u + p)}]}


# a greedy stream of the deployment may leave the plain aggregated engine's
# only at a near tie: where the one-token prefill that writes the first
# token's KV (the disaggregated path) and the decode window (the aggregated
# one) round differently in bf16, the two may pick either of two tokens
# whose logits differ by at most two bf16 ulps at the top logit's magnitude
# (weights N(0, 1/fan_in) over a unit-RMS hidden state give logits ~N(0, 1);
# the top of 128256 sits in [4, 8), where an ulp is 2^-5). A fault in the
# pages moves the logits by far more than that
NEAR_TIE = 2.0 ** -4 + 1e-5     # + the f32 rounding of two log-softmaxes

# two token positions are the same token in the same context when their
# strings match and their top values agree within four bf16 ulps at the top
# logit's magnitude: each of two workers' bf16 computations may round up to
# two ulps away (a different context moves them by far more)
SAME_CONTEXT = 2 * NEAR_TIE


def first_difference_of(a: list, b: list):
    """The first position where two streams' logprob entries differ (None
    when they agree throughout and have the same length)."""
    for j, (x, y) in enumerate(zip(a, b)):
        if x[0] != y[0] or abs(x[1] - y[1]) > SAME_CONTEXT or any(
                abs(p - q) > SAME_CONTEXT for p, q in zip(x[2], y[2])):
            return j
    return None if len(a) == len(b) else min(len(a), len(b))


async def drive_kill(fe_port: int, rr_port: int, model: str, sys_len: int,
                     workers: dict) -> dict:
    """Phase 11k (see the docstring at the top): the wave, the kill of the
    worker holding the most streams, the checks, the replay on the
    survivor. `workers`: {worker id: Child}; `rr_port`: the round-robin
    frontend, which places the warm-up."""
    name = "distributed path, worker killed mid-wave"
    reqs = {f"kill-p{p}": kill_body(model, p, p % 2, sys_len)
            for p in range(12, 20)}
    # the warm-up, the same requests, each twice through the round-robin
    # frontend, every request sent once the one before has its first frame
    # (so its two copies are consecutive picks: one on each worker): both
    # workers hold every prompt's pages, each prefilled alone, and the
    # logprob window graphs the wave replays, so a migrated stream and its
    # replay on the survivor read the same prompt KV
    t0 = time.perf_counter()
    tasks = []
    for rid, body in reqs.items():
        for i in range(2):
            first = asyncio.Event()
            tasks.append(asyncio.create_task(_stream_into(
                rr_port, body, Stream(f"warm-{rid}-{i}"), first.set)))
            waiter = asyncio.create_task(first.wait())
            await asyncio.wait({tasks[-1], waiter}, timeout=120,
                               return_when=asyncio.FIRST_COMPLETED)
            waiter.cancel()
    warm = await asyncio.gather(*tasks)
    check(all(st.done and not st.errors for st in warm),
          f"{name}: the warm-up wave: "
          f"{[(st.rid, st.finish, st.errors[:1]) for st in warm]}")

    async def on_both():
        for body in reqs.values():
            m = await _get_json(fe_port, "/router/match", {
                "model": model, "messages": body["messages"]})
            if sorted(m["scores"]) != sorted(workers) or min(
                    m["scores"].values()) < (m["isl"] - 1) // DIST_PAGE:
                return False
        return True
    await _poll(f"{name}: the router scoring every prompt's pages on both "
                "workers", on_both, 60)
    warm_s = time.perf_counter() - t0
    text0 = (await _http(fe_port, "GET", "/metrics"))[2].decode()
    rel0 = reliability_counts(text0)
    streams = {rid: Stream(rid) for rid in reqs}
    ready = asyncio.Event()

    def on_frame():
        if all(len(s.entries) >= KILL_AT for s in streams.values()):
            ready.set()
    tasks = [asyncio.create_task(_stream_into(fe_port, body, streams[rid],
                                              on_frame))
             for rid, body in reqs.items()]
    await asyncio.wait_for(ready.wait(), 300)
    state = await _get_json(fe_port, "/router/state")
    dec = {d["request_id"]: d["worker_id"]
           for d in state["models"][model]["decisions"]}
    check(all(r in dec for r in reqs), f"{name}: no decision for "
          f"{[r for r in reqs if r not in dec]}")
    held = {w: sorted(r for r in reqs if dec[r] == w) for w in workers}
    killed = max(sorted(held), key=lambda w: len(held[w]))
    at_kill = {rid: len(s.entries) for rid, s in streams.items()}
    text_at_kill = {rid: s.text for rid, s in streams.items()}
    t_kill = time.perf_counter()
    workers[killed].proc.send_signal(signal.SIGKILL)
    check(all(KILL_AT <= n < KILL_TOKENS for n in at_kill.values()),
          f"{name}: token counts at the kill {at_kill}")
    await asyncio.wait_for(asyncio.gather(*tasks), 600)
    wave_s = time.perf_counter() - t_kill
    for rid, st in streams.items():
        check(not st.errors and st.done and st.finish == ["length"]
              and len(st.entries) == KILL_TOKENS and st.usage
              and st.usage["completion_tokens"] == KILL_TOKENS
              and st.text.startswith(text_at_kill[rid]),
              f"{name}: {rid} ended with errors {st.errors[:2]}, [DONE] "
              f"{st.done}, finish {st.finish}, {len(st.entries)} entries, "
              f"usage {st.usage}")
    text1 = (await _http(fe_port, "GET", "/metrics"))[2].decode()
    rel1 = reliability_counts(text1)
    migrated = held[killed]
    migrations = rel1["migrations"] - rel0["migrations"]
    check(migrations == len(migrated), f"{name}: {migrations} migrations, "
          f"the killed worker {killed} held {len(migrated)} streams "
          f"{migrated}")
    code = workers[killed].proc.wait(timeout=60)
    check(code == -signal.SIGKILL, f"{name}: the killed worker exited "
          f"{code}")

    async def one_instance():
        st = await _get_json(fe_port, "/router/state")
        return len(st["models"].get(model, {}).get("instances", {})) == 1
    t0 = time.perf_counter()
    await _poll(f"{name}: /router/state listing one instance once the "
                "lease expires", one_instance, 120, poll_s=0.5)
    lease_s = time.perf_counter() - t0 + wave_s

    # the migration gap: the client's time across the kill from the last
    # frame before it to the frame the stream resumed with
    gaps = {}
    for rid in migrated:
        ts = streams[rid].times
        i = max(j for j, t in enumerate(ts) if t <= t_kill)
        gaps[rid] = max(b - a for a, b in zip(ts[i:], ts[i + 1:]))
    # each migrated stream against the same request served on the survivor
    replays = dict(zip(migrated, await asyncio.gather(*(
        _stream_into(fe_port, reqs[rid], Stream(f"replay-{rid}"))
        for rid in migrated))))
    firsts = {}
    for rid in migrated:
        a, b = streams[rid].entries, replays[rid].entries
        check(replays[rid].done and len(b) == KILL_TOKENS,
              f"{name}: the replay of {rid} gave {len(b)} entries")
        firsts[rid] = near_tie_difference(
            name, f"{rid} (killed at {at_kill[rid]}) against its replay",
            a, b)
    rel2 = reliability_counts(
        (await _http(fe_port, "GET", "/metrics"))[2].decode())
    import numpy as np
    g = sorted(gaps.values())
    rec = {"killed": killed, "held": held, "tokens_at_kill": at_kill,
           "migrations": migrations,
           "retries": rel1["retries"] - rel0["retries"],
           "replay_retries": rel2["retries"] - rel1["retries"],
           "migration_gap_s": gaps,
           "migration_gap_p50_s": float(np.percentile(g, 50)),
           "migration_gap_max_s": max(g),
           "first_difference": firsts, "warmup_s": warm_s,
           "wave_s_after_kill": wave_s,
           "kill_to_one_instance_s": lease_s}
    print(f"{name}: killed {killed} holding {len(migrated)} of "
          f"{len(reqs)} streams at {json.dumps(at_kill)} tokens; every "
          f"stream ended with {KILL_TOKENS} tokens, length, [DONE], no error "
          f"frame; migrations {migrations}, retries {rec['retries']}; "
          f"migration gap p50 {rec['migration_gap_p50_s']:.3f} s max "
          f"{rec['migration_gap_max_s']:.3f} s; against the replay on the "
          f"survivor, first (position, what differs, top-2 gap) "
          f"{json.dumps(firsts)} (null: equal throughout); one instance "
          f"{lease_s:.1f} s after the kill", flush=True)
    return rec


async def drive_shed(port: int, model: str, sys_len: int) -> dict:
    """Phase 11s (see the docstring at the top) against the shedding
    frontend at `port`."""
    name = "distributed path, shedding frontend"

    async def listed():
        got = await _get_json(port, "/v1/models")
        return [m["id"] for m in got["data"]] == [model]
    await _poll(f"{name}: listing {model}", listed, 120)
    text0 = (await _http(port, "GET", "/metrics"))[2].decode()
    held = [Stream(f"held-{i}") for i in range(2)]
    tasks = [asyncio.create_task(_stream_into(
        port, kill_body(model, 24 + i, 0, sys_len), st)) for i, st in
        enumerate(held)]
    for st in held:
        await asyncio.wait_for(st.first_frame.wait(), 300)
    small = {"model": model, "max_tokens": 4, "messages": [
        {"role": "user", "content": dist_text(64, 31)}]}
    shed = [await _http(port, "POST", "/v1/chat/completions", small,
                        {"x-request-id": f"shed-{i}"}) for i in range(2)]
    check(not any(t.done() for t in tasks), f"{name}: a held stream ended "
          "before the two requests were shed")
    for status, headers, raw in shed:
        check(status == 429 and headers.get("retry-after") == "1"
              and json.loads(raw) == {"error": {
                  "message": "server overloaded, retry later",
                  "code": 429}},
              f"{name}: status {status}, retry-after "
              f"{headers.get('retry-after')}, body {raw[:200]}")
    await asyncio.wait_for(asyncio.gather(*tasks), 600)
    for st in held:
        check(st.done and st.finish == ["length"] and not st.errors,
              f"{name}: held stream {st.rid}: {st.finish} {st.errors[:2]}")
    status, _, raw = await _http(port, "POST", "/v1/chat/completions",
                                 small, {"x-request-id": "after"})
    check(status == 200, f"{name}: after the held streams, status "
          f"{status}: {raw[:200]}")
    text = (await _http(port, "GET", "/metrics"))[2].decode()

    def sheds(t):
        return sum(float(x) for x in re.findall(
            r'^llm_http_service_requests_total\{[^}]*status="shed"\} '
            r'(\S+)$', t, re.M))
    inflight = re.findall(r"^llm_http_service_inflight_requests\{[^}]*\} "
                          r"(\S+)$", text, re.M)
    n = sheds(text) - sheds(text0)
    check(n == 2 and inflight and all(float(x) == 0 for x in inflight),
          f"{name}: {n} shed requests counted, in flight {inflight}")
    print(f"{name} (DYN_MAX_INFLIGHT=2 DYN_ADMISSION_QUEUE=0 "
          f"DYN_RETRY_AFTER_S=1): with 2 streams held, 2 requests answered "
          f"429, retry-after 1, the JAX error body; "
          f'llm_http_service_requests_total{{status="shed"}} +{n:.0f}; '
          f"after the held streams ended, 200 and 0 in flight", flush=True)
    return {"shed": n, "statuses": [s for s, _, _ in shed],
            "retry_after": [h.get("retry-after") for _, h, _ in shed]}


# -- phase 11h: the control plane's failover ------------------------------------

H11_KEYS = 64         # unleased keys written before the primary dies
H11_ITEMS = 16        # queue items pushed before it dies
H11_QUEUE = "chip.h11"
H11_PROMPTS = range(24, 28)   # prefix seeds no other phase-11 chat uses
# a frontend of the dead primary must end its runtime within its lease TTL
# (the children's DYN_LEASE_TTL_S) plus this margin
H11_EXIT_MARGIN_S = 15.0


def h11_chats(model: str, sys_len: int) -> list:
    """11h's 4 chats: phase 11's shapes (a system prompt of sys_len
    byte-tokens and a user turn), greedy, DIST_MAX_TOKENS tokens, streamed
    with the top KILL_TOP logprobs, on prefixes no other chat of the phase
    caches."""
    return [dict(kill_body(model, p, p % 4, sys_len),
                 max_tokens=DIST_MAX_TOKENS) for p in H11_PROMPTS]


async def h11_stream(port: int, body: dict, rid: str) -> list:
    """One H11 chat through the frontend at `port`: checked to its
    max_tokens with no error frame; returns its logprob entries."""
    st = await _stream_into(port, body, Stream(rid))
    check(st.done and not st.errors and st.finish == ["length"]
          and len(st.entries) == body["max_tokens"]
          and st.usage["completion_tokens"] == body["max_tokens"]
          and all(math.isfinite(e[1]) and all(map(math.isfinite, e[2]))
                  for e in st.entries),
          f"{rid}: errors {st.errors[:2]}, [DONE] {st.done}, finish "
          f"{st.finish}, {len(st.entries)} entries, usage {st.usage}")
    return [list(e[:2]) + [list(e[2])] for e in st.entries]


def near_tie_difference(name: str, rid: str, a: list, b: list):
    """None when two streams' logprob entries agree throughout, else
    [position, what differs, top-1 less top-2 there]; fails the run unless
    the first difference sits at a near tie in both streams (NEAR_TIE)."""
    d = first_difference_of(a, b)
    if d is None:
        return None
    # the tokens differ at d: d itself is the tie. Only the values differ
    # (equal strings): two ids of one string were picked at d - 1, which
    # is the tie. Either way both streams must see it
    case = "token" if a[d][0] != b[d][0] else "context"
    at = d if case == "token" else d - 1
    check(at >= 0, f"{name}: {rid} differs in the values of its first "
          "token")
    tie = max(x[2][0] - x[2][1] for x in (a[at], b[at]))
    check(tie <= NEAR_TIE, f"{name}: {rid} differs at position {d} "
          f"({case} differs), and position {at} is no near tie in both "
          f"streams (top-1 less top-2 up to {tie:.4f} > {NEAR_TIE})")
    return [d, case, round(tie, 5)]


def window_steps(tokens: int) -> int:
    """Decode steps a worker runs for one request alone whose stream held
    `tokens` tokens with logprobs (no pipelined follow-up window): the
    first token is its prefill's, and each window takes the smallest rung
    of the ladder covering what remains, else the largest."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.scheduler import window_ladder
    ladder = window_ladder(EngineConfig().decode_steps)
    steps, left = 0, tokens - 1
    while left > 0:
        w = next((r for r in reversed(ladder) if r >= left), ladder[0])
        steps += w
        left -= w
    return steps


async def autoscaler_gauges_gate(name: str, ports: dict) -> dict:
    """Every llm_autoscaler_* gauge on each process's /metrics, equal to
    that process's AUTOSCALER_STATS: none of them hosts a controller, so
    the counters of a fresh AutoscalerStats (all 0)."""
    from dynamo_tpu_torch.runtime.autoscaler import AutoscalerStats
    want = AutoscalerStats().snapshot()
    out = {}
    for what, port in ports.items():
        text = (await _http(port, "GET", "/metrics"))[2].decode()
        got = {}
        for field in want:
            m = re.search(rf"^llm_autoscaler_{field} (\S+)$", text, re.M)
            check(m is not None, f"{name}: the {what}'s /metrics has no "
                  f"llm_autoscaler_{field}")
            got[field] = float(m.group(1))
        check(got == {k: float(v) for k, v in want.items()},
              f"{name}: the {what}'s llm_autoscaler_* {got}, its "
              f"AUTOSCALER_STATS {want}")
        out[what] = len(got)
    return out


def cp_role(port: int) -> dict:
    """A control-plane member's role probe ({role, synced, epoch}); an
    unreachable member gives {}."""
    from dynamo_tpu_torch.runtime.transports.wire import oneshot_request
    try:
        return asyncio.run(oneshot_request("127.0.0.1", port,
                                           {"op": "role"}, 3.0))
    except (OSError, ConnectionError, asyncio.IncompleteReadError,
            asyncio.TimeoutError):
        return {}


def wait_role(what: str, port: int, timeout: float, **want) -> dict:
    deadline = time.monotonic() + timeout
    while True:
        got = cp_role(port)
        if all(got.get(k) == v for k, v in want.items()):
            return got
        check(time.monotonic() < deadline, f"{what}: role {got}, not "
              f"{want}, within {timeout:.0f} s")
        time.sleep(0.2)


def journal_stats(data_dir: str) -> dict:
    """A member's journal: its records (length-prefixed, read as the
    server replays them) and the bytes of its journal and snapshot."""
    from dynamo_tpu_torch.runtime.transports.journal import _read_records
    path = os.path.join(data_dir, "journal.bin")
    recs = list(_read_records(path)) if os.path.exists(path) else []
    size = sum(os.path.getsize(os.path.join(data_dir, f))
               for f in ("journal.bin", "snapshot.bin")
               if os.path.exists(os.path.join(data_dir, f)))
    return {"records": recs, "bytes": size}


async def h11_writes(coord: str) -> dict:
    """Step 1: H11_KEYS unleased keys and H11_ITEMS queue items through a
    comma-form client, every one acknowledged."""
    from dynamo_tpu_torch.runtime.transports.tcp import (
        ControlPlaneClient, parse_addrs,
    )
    c = await ControlPlaneClient(addrs=parse_addrs(coord)).connect()
    try:
        for i in range(H11_KEYS):
            await c.put(f"chip/h11/key{i:03d}", f"value-{i}".encode())
        for i in range(H11_ITEMS):
            await c.queue_push(H11_QUEUE, f"item-{i:02d}".encode())
        return {"epoch": c.epoch, "port": c.port}
    finally:
        await c.close()


async def h11_read_back(coord: str) -> dict:
    """Step 6: a fresh comma-form client on the promoted member reads every
    key back and pops every item, in order."""
    from dynamo_tpu_torch.runtime.transports.tcp import (
        ControlPlaneClient, parse_addrs,
    )
    c = await ControlPlaneClient(addrs=parse_addrs(coord)).connect(60.0)
    try:
        vals = [await c.get(f"chip/h11/key{i:03d}") for i in range(H11_KEYS)]
        items = [await c.queue_pop(H11_QUEUE, 5.0) for _ in range(H11_ITEMS)]
        return {"epoch": c.epoch, "port": c.port,
                "keys_ok": vals == [f"value-{i}".encode()
                                    for i in range(H11_KEYS)],
                "items_ok": items == [f"item-{i:02d}".encode()
                                      for i in range(H11_ITEMS)],
                "depth_after": await c.queue_depth(H11_QUEUE)}
    finally:
        await c.close()


def phase_h11(smi: str, model: str, sys_len: int, ctx: dict,
              device_args=(), device_name: str = None) -> dict:
    """Phase 11h (see the docstring at the top), after 11s and the
    survivor's drain: acknowledged writes, the standby's copy of them, the
    primary SIGKILLed, the promotion at epoch 2, the old frontends' runtimes
    ending on their lost leases, the writes read back, a fresh llama3-8b
    worker and frontend serving the 4 H11 chats against phase 11's
    streams, and the dead primary rejoining as a standby. `ctx`: phase
    11's children and ports (primary, standby, coord, data dirs, the
    frontends, the reference streams, the routed TTFT)."""
    from dynamo_tpu_torch.engine.config import get_model_config
    from dynamo_tpu_torch.runtime.distributed import connect_coordinator
    name = "control-plane failover"
    t_phase = time.perf_counter()
    primary, standby = ctx["primary"], ctx["standby"]
    coord, p_port, s_port = ctx["coord"], ctx["p_port"], ctx["s_port"]
    children = ctx["children"]
    # 1. acknowledged writes through the comma form (the primary, epoch 1)
    w = asyncio.run(asyncio.wait_for(h11_writes(coord), 60))
    check(w == {"epoch": 1, "port": p_port}, f"{name}: the writer "
          f"enrolled with {w}, not the primary at epoch 1")

    # 2. the standby has applied them: its own journal holds every put and
    # push (replication is asynchronous; the window is not gated)
    def applied():
        recs = journal_stats(ctx["s_dir"])["records"]
        keys = [r["key"] for r in recs if r.get("op") == "put"
                and r["key"].startswith("chip/h11/")]
        items = [r["payload"] for r in recs if r.get("op") == "qpush"
                 and r["queue"] == H11_QUEUE]
        return len(keys) == H11_KEYS and len(items) == H11_ITEMS
    deadline = time.monotonic() + 30
    while not applied():
        check(time.monotonic() < deadline, f"{name}: the standby's journal "
              f"lacks the writes after 30 s")
        time.sleep(0.1)
    primary_journal = journal_stats(ctx["p_dir"])
    # 3. SIGKILL the primary
    t_kill = time.perf_counter()
    primary.proc.send_signal(signal.SIGKILL)
    check(primary.proc.wait(timeout=60) == -signal.SIGKILL,
          f"{name}: the primary exited {primary.proc.returncode}")
    # 4. the standby answers as primary at epoch 2
    standby.wait_line("PROMOTED control-plane=:", 60)
    role = wait_role(f"{name}: the standby", s_port, 30, role="primary",
                     epoch=2)
    promote_s = time.perf_counter() - t_kill
    # 5. every frontend still enrolled with the dead primary ends its
    # runtime (its lease is gone) within the lease TTL plus a margin
    ttl = float(CHILD_LEASE_TTL_S)
    ended = {}
    for f in ctx["frontends"]:
        left = ttl + H11_EXIT_MARGIN_S - (time.perf_counter() - t_kill)
        try:
            f.proc.wait(timeout=max(0.1, left))
        except subprocess.TimeoutExpired:
            check(False, f"{name}: {f.name} still running "
                  f"{ttl + H11_EXIT_MARGIN_S:.0f} s after the primary's "
                  f"death:\n{f.tail()}")
        f.stop(None, 10)
        exits = [x for x in f.lines if x.startswith("EXIT frontend ")]
        check(f.proc.returncode == 0 and exits == [
            "EXIT frontend lease_lost=True"], f"{name}: {f.name} exited "
            f"{f.proc.returncode} with {exits}:\n{f.tail()}")
        ended[f.name] = round(time.perf_counter() - t_kill, 3)
    # 6. a fresh comma-form client reads every write back, in order
    back = asyncio.run(asyncio.wait_for(h11_read_back(coord), 90))
    check(back == {"epoch": 2, "port": s_port, "keys_ok": True,
                   "items_ok": True, "depth_after": 0},
          f"{name}: read back from the promoted member: {back}")
    # 7. a fresh worker and a fresh KV-routed frontend enroll at epoch 2
    t0 = time.perf_counter()
    worker = Child("worker (after failover)", [
        "dynamo_tpu_torch.run", f"in=endpoint:{DIST_EP}", "out=native",
        model, "--control-host", coord, "--control-port", str(s_port),
        *DIST_SCHEDULE, *device_args],
        env={"DYN_PEAK_TFLOPS": str(PEAK_BF16_TFLOPS)})
    children.append(worker)
    ready = worker.wait_line("READY endpoint=", 900)
    check(" epoch=2 " in ready and ready.split(" device=", 1)[1]
          == device_name, f"{name}: {ready}")
    worker_id = ready.split(" worker=", 1)[1].split()[0]
    front = Child("frontend (after failover)", [
        "dynamo_tpu_torch.frontend.serve", "--host", "127.0.0.1",
        "--port", "0", "--control-host", coord])
    children.append(front)
    enrolled = front.wait_line("ENROLLED epoch=", 120)
    check(enrolled == "ENROLLED epoch=2", f"{name}: the frontend {enrolled}")
    fe_port = int(front.wait_line("READY http=:", 120).rsplit(":", 1)[1])
    ready_s = time.perf_counter() - t0

    # 8-9. the 4 chats, one at a time; each stream against phase 11's
    async def serve():
        async def listed():
            st = await _get_json(fe_port, "/router/state")
            m = st["models"].get(model, {})
            return list(m.get("instances", {})) == [worker_id] \
                and m.get("indexer") == "native"
        await _poll(f"{name}: the new frontend listing the new worker",
                    listed, 120)
        streams = [await h11_stream(fe_port, body, f"h11-{i}")
                   for i, body in enumerate(h11_chats(model, sys_len))]
        rt = await connect_coordinator(coord)
        try:
            client = await rt.namespace("dynamo").component("llm").endpoint(
                "generate").client().start()
            st = (await _scrape(client, 1))[worker_id]
            await client.stop()
        finally:
            await rt.shutdown()
        text = (await _http(fe_port, "GET", "/metrics"))[2].decode()
        return streams, st, _ttft_quantiles(text)
    streams, st, ttft = asyncio.run(asyncio.wait_for(serve(), 900))
    firsts = {f"h11-{i}": near_tie_difference(name, f"h11-{i}", ref, got)
              for i, (ref, got) in enumerate(zip(ctx["h11_reference"],
                                                 streams))}
    n_layers = get_model_config(model).num_layers
    steps = sum(window_steps(len(x)) for x in streams)
    k = st["kernel_launches"][RAGGED]
    warm = st["graph_warmup_launches"][RAGGED]
    check(st["decode_window_steps"] == steps,
          f"{name}: the new worker ran {st['decode_window_steps']} decode "
          f"steps; the streams' tokens derive {steps}")
    check(device_name == "cpu" or (k == n_layers * steps + warm and k > 0),
          f"{name}: the new worker launched the ragged kernel {k} times; "
          f"{n_layers} x {steps} derived decode steps + {warm} in warm-ups")
    # 10. the dead primary, restarted from its data dir as the promoted
    # member's standby, rejoins at epoch 2 and does not promote
    t0 = time.perf_counter()
    reborn = Child("control plane (old primary, rejoined)", [
        "dynamo_tpu_torch.runtime.transports.server", "--host", "127.0.0.1",
        "--port", str(p_port), "--data-dir", ctx["p_dir"],
        "--standby-of", f"127.0.0.1:{s_port}"])
    children.append(reborn)
    reborn.wait_line("READY control-plane=:", 120)
    rejoined = wait_role(f"{name}: the old primary", p_port, 60,
                         role="standby", synced=True, epoch=2)
    time.sleep(3.0)
    check(cp_role(p_port) == rejoined and cp_role(s_port)["role"]
          == "primary" and not any(x.startswith("PROMOTED")
                                   for x in reborn.lines),
          f"{name}: 3 s after rejoining: old primary {cp_role(p_port)}, "
          f"promoted member {cp_role(s_port)}")
    rejoin_s = time.perf_counter() - t0
    # stop: the worker drains (SIGTERM, exit 0), the rest on SIGINT
    worker.proc.send_signal(signal.SIGTERM)
    code = worker.stop(None, 120)
    exits = [x for x in worker.lines if x.startswith("EXIT ")]
    check(code == 0 and len(exits) == 1
          and " logits_nonfinite_steps=0 " in exits[0],
          f"{name}: the new worker exited {code}: {exits or worker.tail()}")
    rest = [c.stop(signal.SIGINT, 60) for c in (front, reborn, standby)]
    check(rest == [0, 0, 0], f"{name}: frontend and servers exited {rest}")
    promoted = journal_stats(ctx["s_dir"])
    rec = {"promote_s": promote_s, "role_after": role,
           "frontends_ended_s": ended, "read_back": back,
           "worker_ready_s": ready_s, "ragged_launches": k,
           "derived_decode_steps": steps, "warmup_launches": warm,
           "first_difference": firsts, "rejoin_s": rejoin_s,
           "journal": {
               "primary_records": len(primary_journal["records"]),
               "primary_bytes": primary_journal["bytes"],
               "promoted_records": len(promoted["records"]),
               "promoted_bytes": promoted["bytes"]},
           "ttft_after_failover": ttft,
           "routed_ttft_with_journal": ctx["routed_ttft"],
           "phase_s": time.perf_counter() - t_phase}
    print(f"{name} [{smi}]: {H11_KEYS} keys and {H11_ITEMS} queue items "
          f"acknowledged and on the standby's journal; primary SIGKILLed; "
          f"standby primary at epoch 2 in {promote_s:.3f} s; the old "
          f"frontends' runtimes ended at {json.dumps(ended)} s (lease TTL "
          f"{ttl:.0f} s); every key and item read back in order; a fresh "
          f"{model} worker READY in {ready_s:.1f} s served the 4 chats "
          f"(first difference from phase 11's streams "
          f"{json.dumps(firsts)}, null: equal throughout), ragged launches "
          f"{k} = {n_layers} x {steps} derived decode steps + {warm}; the "
          f"old primary rejoined as a standby at epoch 2 in "
          f"{rejoin_s:.1f} s and did not promote; journal records / bytes "
          f"{json.dumps(rec['journal'])}; routed TTFT p50 with the journal "
          f"{ctx['routed_ttft']['ttft_p50_ms']:.1f} ms", flush=True)
    print(f"phase seconds: 11h {rec['phase_s']:.1f}", flush=True)
    return rec


# -- phase 11g: settings, logging, llmctl and the C API -------------------------

G11_PROMPTS = (32, 33)   # prefix seeds no other phase-11 chat uses


def write_toml(path: str, tables: dict) -> None:
    """A DYN_CONFIG file of {table: {key: str | int | float | bool}}."""
    lines = []
    for table, keys in tables.items():
        lines.append(f"[{table}]")
        for k, v in keys.items():
            lines.append(f"{k} = " + ("true" if v is True else "false"
                                      if v is False else json.dumps(v)))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def log_records(child: "Child") -> list:
    """The JSONL records of a child's DYN_LOG_FILE so far."""
    with open(child.log_file) as f:
        return [json.loads(x) for x in f if x.strip()]


def settings_gate(name: str, want: dict) -> dict:
    """11g: each launch binary's effective settings, from the `settings
    {...}` record it logs at start, equal the layer that should win ({child:
    (its logger, the expected dict)})."""
    out = {}
    for child, (target, expect) in want.items():
        got = [json.loads(r["message"][len("settings "):])
               for r in log_records(child) if r["target"] == target
               and r["message"].startswith("settings ")]
        check(got == [expect], f"{name}: {child.name} took the settings "
              f"{got}; the file, the DYN_* variables and the flags give "
              f"{expect}")
        out[child.name] = expect
    return out


def child_log_gate(name: str) -> dict:
    """11g's logging gate over every phase-11 child's DYN_LOG_FILE: each
    line one JSON record with ts, level, target and message, and DEBUG
    records present and from the target DYN_LOG named alone (everything
    else stays at info). Returns {child: {level: records}}."""
    out = {}
    for f in CHILD_LOGS["files"]:
        check(os.path.exists(f["path"]), f"{name}: {f['child']} wrote no "
              f"log file ({f['path']})")
        with open(f["path"]) as fh:
            lines = fh.read().splitlines()
        levels, debug = {}, set()
        for i, line in enumerate(lines):
            try:
                r = json.loads(line)
            except ValueError:
                r = None
            check(isinstance(r, dict)
                  and {"ts", "level", "target", "message"} <= set(r)
                  and str(r["ts"]).endswith("Z"),
                  f"{name}: {f['child']}'s log line {i + 1} is no JSONL "
                  f"record: {line[:200]!r}")
            levels[r["level"]] = levels.get(r["level"], 0) + 1
            if r["level"] == "DEBUG":
                debug.add(r["target"])
        check(debug == {f["target"]}, f"{name}: {f['child']}'s DEBUG "
              f"records come from {sorted(debug)}; DYN_LOG named "
              f"{f['target']} alone")
        out[f["child"]] = levels
    return out


def page_chain_of(tokens: list, page: int) -> list:
    """[(chained page hash, page tokens)] of a prompt's full pages, as a
    worker's allocator chains them (engine/kv_cache.py page_hash)."""
    from dynamo_tpu_torch.engine.kv_cache import page_hash
    out, parent = [], 0
    for i in range(len(tokens) // page):
        toks = list(tokens[i * page:(i + 1) * page])
        parent = page_hash(parent, toks)
        out.append((parent, toks))
    return out


def llmctl(coord: str, *argv) -> list:
    """One `python -m dynamo_tpu_torch.llmctl` call as a child: its printed
    lines (the JSONL log records on its stderr left out)."""
    c = Child(f"llmctl {argv[0]}", ["dynamo_tpu_torch.llmctl",
                                    "--control-host", coord, *argv])
    code = c.stop(None, 120)
    check(code == 0, f"llmctl {' '.join(argv)} exited {code}:\n"
          + c.tail())
    return [x for x in c.lines if not x.startswith("{")]


async def drive_g11_alias(fe_port: int, model: str, alias: str,
                          sys_len: int) -> dict:
    """11g's llmctl chats: once the KV-routed frontend lists the alias, one
    greedy chat (fresh system prompt, 32 tokens, the top 8 logprobs,
    streamed) twice under the model's own name, the first a cold prefill
    and the second a prefix hit on the same worker (the router's pick),
    then once under the alias. The alias's reference is the run that took
    its path: the second where the alias landed on that worker (a prefix
    hit), else the first (a cold prefill on the other worker)."""
    async def listed():
        got = await _get_json(fe_port, "/v1/models")
        return alias in [m["id"] for m in got["data"]]
    await _poll(f"the frontend listing {alias}", listed, 60)
    body = dict(kill_body(model, G11_PROMPTS[0], 0, sys_len),
                max_tokens=DIST_MAX_TOKENS)
    own = [await h11_stream(fe_port, body, f"g11-own-{i}") for i in range(2)]
    via = await h11_stream(fe_port, dict(body, model=alias), "g11-alias")
    state = await _get_json(fe_port, "/router/state")
    went = {rid: next((d["worker_id"] for d in state["models"][m]["decisions"]
                       if d["request_id"] == rid), None)
            for m, rid in ((model, "g11-own-0"), (model, "g11-own-1"),
                           (alias, "g11-alias"))}
    check(went["g11-own-1"] == went["g11-own-0"], f"distributed path "
          f"(11g): the repeated chat left its prefix's worker: {went}")
    ref = own[1] if went["g11-alias"] == went["g11-own-0"] else own[0]
    return {"reference": ref, "alias": via, "workers": went,
            "prefix_hit": ref is own[1]}


async def drive_g11_capi(coord: str, cp_port: int, fe_port: int, model: str,
                         sys_len: int, wid: str) -> dict:
    """11g's C API: the library built with g++ joins the control plane under
    the live worker `wid`, publishes Stored events for the full pages of a
    prompt neither worker holds, then Removed events for them; the
    frontend's router (/router/match) and the router service (`route`)
    score that worker with the prompt's page count, then 0."""
    from dynamo_tpu_torch import native
    from dynamo_tpu_torch.engine.kv_cache import tokens_hash
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.native.capi_py import CApi
    from dynamo_tpu_torch.protocols.openai import ChatCompletionRequest
    from dynamo_tpu_torch.runtime.distributed import connect_coordinator
    name = "distributed path (11g C API)"
    api = CApi()
    check(native.NATIVE_STATS.build_failures == 0 and
          native.library_path("capi").exists(),
          f"{name}: {native.NATIVE_STATS.last_error}")
    body = kill_body(model, G11_PROMPTS[1], 0, sys_len)
    pre = OpenAIPreprocessor(ModelDeploymentCard(name=model, arch=model))
    toks = pre.preprocess_chat(ChatCompletionRequest.from_json(body))[0] \
        .token_ids
    page = 64
    blocks = page_chain_of(toks, page)
    n = len(blocks)
    hashes = [api.tokens_hash(t) == tokens_hash(t) for _, t in blocks]
    check(all(hashes), f"{name}: dyn_tokens_hash differs from tokens_hash "
          f"on pages {[i for i, ok in enumerate(hashes) if not ok]}")
    match_body = {"model": model, "messages": body["messages"]}
    rt = await connect_coordinator(coord)
    try:
        rclient = await rt.namespace("dynamo").component("router").endpoint(
            "route").client().start()
        await rclient.wait_for_instances(60)

        async def scores():
            m = await _get_json(fe_port, "/router/match", match_body)
            frames = [f async for f in await rclient.generate(
                {"token_ids": list(toks)})]
            return m["scores"], frames[0]
        fe0, svc0 = await scores()
        check(not any(fe0.values()) and svc0["best_overlap_blocks"] == 0,
              f"{name}: the fresh prompt is held already: frontend "
              f"{fe0}, router service {svc0}")
        await asyncio.to_thread(api.init, "dynamo", "llm", wid, page,
                                "127.0.0.1", cp_port)
        await asyncio.to_thread(api.publish_stored, 1 << 32, None, blocks)

        async def stored():
            fe, svc = await scores()
            return (fe == {wid: n} and svc["worker_id"] == wid
                    and svc["overlap_blocks"] == n) and (fe, svc)
        fe1, svc1 = await _poll(f"{name}: {n} stored pages scored on {wid}",
                                stored, 30)
        await asyncio.to_thread(api.publish_removed, (1 << 32) + 1,
                                [bh for bh, _ in blocks])

        async def removed():
            fe, svc = await scores()
            return (not fe.get(wid) and svc["best_overlap_blocks"] == 0) \
                and (fe, svc)
        fe2, svc2 = await _poll(f"{name}: the removed pages unscored",
                                removed, 30)
        api.shutdown()
        await rclient.stop()
    finally:
        await rt.shutdown()
    return {"worker": wid, "pages": n, "tokens": len(toks),
            "hashes_equal": len(hashes), "stored": [fe1, svc1],
            "removed": [fe2, svc2]}


def phase_g11(coord: str, cp_port: int, fe_port: int, model: str,
              sys_len: int, wid: str) -> dict:
    """11g (see the docstring at the top): llmctl add / list / chat /
    remove against phase 11's control plane, then the C API."""
    name = "distributed path (11g)"
    t0 = time.perf_counter()
    alias = f"{model}-alias"
    added = llmctl(coord, "add", alias, DIST_EP, "--arch", model,
                   "--kv-routed")
    check(f"added chat model {alias} -> {DIST_EP}" in added,
          f"{name}: llmctl add printed {added}")
    listed = llmctl(coord, "list")
    check(f"chat/{alias}\t{DIST_EP}\tkv_routed=True" in listed,
          f"{name}: llmctl list printed {listed}")
    chats = asyncio.run(asyncio.wait_for(drive_g11_alias(
        fe_port, model, alias, sys_len), 300))
    diff = first_difference_of(chats["reference"], chats["alias"])
    check(diff is None, f"{name}: the alias's stream first differs from "
          f"its reference at position {diff} (workers "
          f"{json.dumps(chats['workers'])})")
    removed = llmctl(coord, "remove", alias)
    check(f"removed both model {alias}" in removed,
          f"{name}: llmctl remove printed {removed}")

    async def unknown():
        async def gone():
            got = await _get_json(fe_port, "/v1/models")
            return alias not in [m["id"] for m in got["data"]]
        await _poll(f"{name}: the frontend dropping {alias}", gone, 60)
        return await _http(fe_port, "POST", "/v1/chat/completions", {
            "model": alias, "max_tokens": 4,
            "messages": [{"role": "user", "content": "hi"}]})
    status, _, raw = asyncio.run(asyncio.wait_for(unknown(), 120))
    check(status == 404 and json.loads(raw)["error"]["message"]
          == f"model '{alias}' not found",
          f"{name}: {alias} after llmctl remove: {status} {raw[:200]}")
    t1 = time.perf_counter()
    capi = asyncio.run(asyncio.wait_for(drive_g11_capi(
        coord, cp_port, fe_port, model, sys_len, wid), 300))
    out = {"alias": alias, "listed": listed, "workers": chats["workers"],
           "alias_prefix_hit": chats["prefix_hit"], "unknown_status": status,
           "capi": capi, "llmctl_s": t1 - t0,
           "capi_s": time.perf_counter() - t1}
    print(f"{name}: llmctl added {alias} -> {DIST_EP} (list: "
          f"{json.dumps(listed)}); a greedy 32-token chat twice under "
          f"{model} and once under {alias} (workers "
          f"{json.dumps(chats['workers'])}): the alias's stream equals the "
          f"{'prefix-hit' if chats['prefix_hit'] else 'cold'} run's "
          f"throughout; after llmctl remove {alias} answers {status}; the "
          f"C API on "
          f"worker {wid}: {capi['hashes_equal']} dyn_tokens_hash values "
          f"equal tokens_hash, {capi['pages']} stored pages of a "
          f"{capi['tokens']}-token prompt scored on {wid} by the frontend "
          f"and the router service, 0 after the removal; "
          f"{out['llmctl_s']:.1f} s + {out['capi_s']:.1f} s", flush=True)
    print(f"phase seconds: 11g {time.perf_counter() - t0:.1f}", flush=True)
    return out


def phase_distributed(smi: str, model: str = "llama3-8b",
                      sys_len: int = 1024, device_args=(),
                      device_name: str = None) -> dict:
    """Phase 11 (see the docstring at the top): the control-plane server,
    two `run.py in=endpoint` workers and two frontends as processes, the
    traffic and the checks, 11k (one worker SIGKILLed mid-wave) and 11s (a
    third, shedding frontend), then SIGTERM to the survivor (it drains,
    deregisters and exits 0). Every child is stopped in the `finally`."""
    import shutil
    import tempfile
    from dynamo_tpu_torch.engine.config import get_model_config
    children = []
    t0 = time.perf_counter()
    # the control plane: a durable primary and its hot standby, each
    # journaling into a data directory of its own; both start from the
    # DYN_CONFIG file, the standby's data directory from a variable, their
    # ports from the flag (11g); every child logs JSONL into logs/
    data = tempfile.mkdtemp(prefix="chip_smoke_cp_")
    CHILD_LOGS.update(dir=os.path.join(data, "logs"), files=[])
    os.makedirs(CHILD_LOGS["dir"])
    try:
        p_dir, s_dir = os.path.join(data, "a"), os.path.join(data, "b")
        cfg_path = os.path.join(data, "dyn.toml")
        cp_file = {"host": "127.0.0.1", "port": 6230, "data_dir": p_dir,
                   "fsync": True}
        write_toml(cfg_path, {"control_plane": cp_file})
        server = Child("control plane (primary)", [
            SERVER_MODULE, "--port", "0"], env={"DYN_CONFIG": cfg_path})
        children.append(server)
        cp_port = int(server.wait_line("READY control-plane=:", 120)
                      .rsplit(":", 1)[1])
        standby = Child("control plane (standby)", [
            SERVER_MODULE, "--port", "0", "--standby-of",
            f"127.0.0.1:{cp_port}"],
            env={"DYN_CONFIG": cfg_path, "DYN_CONTROL_PLANE__DATA_DIR": s_dir})
        children.append(standby)
        s_port = int(standby.wait_line("READY control-plane=:", 120)
                     .rsplit(":", 1)[1])
        pair = wait_role("the standby before any worker", s_port, 60,
                         role="standby", synced=True, epoch=1)
        coord = f"127.0.0.1:{cp_port},127.0.0.1:{s_port}"
        print(f"distributed path: control plane primary :{cp_port} "
              f"(journaled), standby :{s_port} {json.dumps(pair)}",
              flush=True)
        workers = [Child(f"worker {i}", [
            "dynamo_tpu_torch.run", f"in=endpoint:{DIST_EP}", "out=native",
            model, "--control-host", coord, "--control-port",
            str(cp_port), *DIST_SCHEDULE, *device_args],
            env={"DYN_PEAK_TFLOPS": str(PEAK_BF16_TFLOPS)})
            for i in range(2)]
        children += workers
        ready = [w.wait_line("READY endpoint=", 900) for w in workers]
        ready_s = time.perf_counter() - t0
        # the standalone router service and exporter over the workers'
        # endpoint, started before any traffic so that the router service
        # applies every stored page's event; their coordinator from the
        # DYN_CONFIG file, the router's page size and the exporter's scrape
        # interval from variables over the file's, the exporter's port from
        # its flag over the file's (11g)
        ns, comp, ep = DIST_EP.split(".")
        write_toml(cfg_path, {
            "control_plane": cp_file,
            "router": {"coordinator": coord, "block_size": 32},
            "metrics": {"coordinator": coord, "port": 9091,
                        "interval": 0.5}})
        services = [
            Child("router service", [
                "dynamo_tpu_torch.kv_router.main", "--namespace", ns,
                "--component", comp, "--endpoint", ep],
                env={"DYN_CONFIG": cfg_path, "DYN_ROUTER__BLOCK_SIZE": "64"}),
            Child("exporter", [
                "dynamo_tpu_torch.observability.exporter", "--namespace",
                ns, "--component", comp, "--endpoint", ep, "--port", "0"],
                env={"DYN_CONFIG": cfg_path, "DYN_METRICS__INTERVAL": "0.25"})]
        children += services
        rline = services[0].wait_line("READY router", 120)
        check(rline == "READY router indexer=native",
              f"router service: {rline}")
        exporter_port = int(services[1].wait_line("READY metrics=:", 120)
                            .rsplit(":", 1)[1])
        # 11g: each value in effect, from the layer that should win
        listening = {c.name: [r["message"] for r in log_records(c)
                              if r["message"].startswith("control plane "
                                                         "listening on ")]
                     for c in (server, standby)}
        check(listening == {
            server.name: [f"control plane listening on 127.0.0.1:{cp_port} "
                          "(primary)"],
            standby.name: [f"control plane listening on 127.0.0.1:{s_port} "
                           "(standby)"]}
              and os.path.isdir(p_dir) and os.path.isdir(s_dir)
              and 6230 not in (cp_port, s_port) and exporter_port != 9091,
              f"distributed path (11g): servers {listening}, data "
              f"directories {os.listdir(data)}, exporter :{exporter_port}")
        settings = settings_gate("distributed path (11g)", {
            server: (DEBUG_TARGET["server"], {
                "host": "127.0.0.1", "port": 0, "data_dir": p_dir,
                "fsync": True, "standby_of": None}),
            standby: (DEBUG_TARGET["server"], {
                "host": "127.0.0.1", "port": 0, "data_dir": s_dir,
                "fsync": True, "standby_of": f"127.0.0.1:{cp_port}"}),
            services[0]: ("dynamo_tpu_torch.router_main", {
                "coordinator": coord, "block_size": 64}),
            services[1]: ("dynamo_tpu_torch.metrics_exporter", {
                "coordinator": coord, "port": 0, "interval": 0.25})})
        print(f"distributed path (11g): settings in effect "
              f"{json.dumps(settings)} (DYN_CONFIG {cfg_path}; the "
              f"standby's data_dir from DYN_CONTROL_PLANE__DATA_DIR, the "
              f"router's block_size from DYN_ROUTER__BLOCK_SIZE and the "
              f"exporter's interval from DYN_METRICS__INTERVAL over the "
              f"file; the ports from the flags over the file's 6230 / "
              f"9091)", flush=True)
        for line in ready:
            dev = line.split(" device=", 1)[1]
            check(dev == device_name, f"worker on {dev!r}, expected "
                  f"{device_name!r}: {line}")
        fronts = [Child(f"frontend{tag}", [
            "dynamo_tpu_torch.frontend.serve", "--host", "127.0.0.1",
            "--port", "0", "--control-host", coord, *extra])
            for tag, extra in (
                ("", ()), (" (no KV routing)", ("--no-kv-routing",)))]
        children += fronts
        fe_ports = [int(f.wait_line("READY http=:", 120).rsplit(":", 1)[1])
                    for f in fronts]
        rec = asyncio.run(asyncio.wait_for(drive_distributed(
            coord, fe_ports[0], fe_ports[1], model, sys_len,
            get_model_config(model).num_layers, smi,
            on_card=device_name != "cpu", exporter_port=exporter_port), 900))
        rec["ready_s"] = ready_s
        rec["settings"] = settings
        by_id = {line.split(" worker=", 1)[1].split()[0]: w
                 for line, w in zip(ready, workers)}
        # 11g: llmctl and the C API, after every count above was read
        rec["g11"] = phase_g11(coord, cp_port, fe_ports[0], model, sys_len,
                               sorted(by_id)[0])
        for svc in services:
            svc.stop(signal.SIGTERM, 30)
        # 11k: SIGKILL the worker holding the most of a wave's streams
        t0 = time.perf_counter()
        rec["kill"] = asyncio.run(asyncio.wait_for(drive_kill(
            fe_ports[0], fe_ports[1], model, sys_len, by_id), 900))
        rec["kill"]["phase_s"] = time.perf_counter() - t0
        survivor = next(w for i, w in by_id.items()
                        if i != rec["kill"]["killed"])
        # 11s: a third frontend that sheds past 2 requests in flight
        t0 = time.perf_counter()
        shedding = Child("frontend (shedding)", [
            "dynamo_tpu_torch.frontend.serve", "--host", "127.0.0.1",
            "--port", "0", "--control-host", coord],
            env={"DYN_MAX_INFLIGHT": "2",
                                "DYN_ADMISSION_QUEUE": "0",
                                "DYN_RETRY_AFTER_S": "1"})
        children.append(shedding)
        fronts.append(shedding)
        shed_port = int(shedding.wait_line("READY http=:", 120)
                        .rsplit(":", 1)[1])
        rec["shed"] = asyncio.run(asyncio.wait_for(drive_shed(
            shed_port, model, sys_len), 900))
        rec["shed"]["phase_s"] = time.perf_counter() - t0
        # drain: SIGTERM the survivor; it deregisters and exits 0
        survivor.proc.send_signal(signal.SIGTERM)
        codes = [survivor.stop(None, 120)]
        check(codes == [0], f"the survivor exited {codes} after SIGTERM:\n"
              + survivor.tail())
        exits = [x for x in survivor.lines if x.startswith("EXIT ")]
        check(len(exits) == 1 and " logits_nonfinite_steps=0 "
              in exits[0], f"{survivor.name}: {exits or survivor.tail()}")

        async def deregistered():
            async def empty(port):
                st = await _get_json(port, "/router/state")
                return not st["models"].get(model, {}).get("instances")
            for port in fe_ports:
                await _poll(f"frontend :{port} dropping both instances",
                            lambda: empty(port), 60)
        asyncio.run(deregistered())
        print(f"distributed path: workers READY in {ready_s:.1f} s; one "
              f"killed mid-wave (-9), the survivor drained on SIGTERM and "
              f"exited {codes[0]}; the routing frontends showed 0 "
              f"instances", flush=True)
        rec["failover"] = phase_h11(smi, model, sys_len, {
            "primary": server, "standby": standby, "coord": coord,
            "p_port": cp_port, "s_port": s_port, "p_dir": p_dir,
            "s_dir": s_dir, "frontends": fronts, "children": children,
            "h11_reference": rec.pop("h11_reference"),
            "routed_ttft": rec["kv_routed"]}, device_args, device_name)
        for c in reversed(children):
            c.stop(signal.SIGKILL, 30)
        rec["logs"] = child_log_gate("distributed path (11g)")
        print(f"distributed path (11g): {len(rec['logs'])} children logged "
              f"JSONL, DEBUG records from the target DYN_LOG named alone: "
              f"{json.dumps(rec['logs'])}", flush=True)
        return rec
    finally:
        for c in reversed(children):
            c.stop(signal.SIGKILL, 30)
        CHILD_LOGS.update(dir=None, files=[])
        shutil.rmtree(data, ignore_errors=True)


# -- phase 12: the disaggregated deployment --------------------------------------

DISAGG_NS = "dynamo-demo"
DISAGG_GRAPH = "dynamo_tpu_torch.examples.disagg.graph:Frontend"
DISAGG_PAGES = 1024   # per engine; the reference deployment gives each 2048
DISAGG_LAYERS = 4     # phase 12's depth of 32 (phase 20 runs all 32)
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
    # the frontend dispatches through the reliability layer: no stream of
    # the phase migrated, retried or hedged
    reliability = reliability_counts(text2)
    check(all(v == 0 for v in reliability.values()),
          f"{name}: the frontend's reliability counters {reliability}")

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
        "reliability": reliability, "graphs": graphs, "warmup_graph_keys": keys[0],
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
          f"verified, 0 mismatches, fall-backs 0, 0 migrations, 0 retries, "
          f"0 hedges; llm_ttft_seconds p50 "
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


def aggregated_run(engine, rid: str, req, tops: bool = True) -> tuple:
    """The plain aggregated engine's stream for `req`, with each token's
    top logprobs ([(token id, logprob)], best first); `tops` False keeps
    the request's own sampling parameters (the windows a served request
    replays)."""
    from dynamo_tpu_torch.engine.sampler import TOP_LOGPROBS
    from dynamo_tpu_torch.engine.scheduler import EngineRequest
    params = (dataclasses.replace(req.params, logprobs=TOP_LOGPROBS)
              if tops else req.params)
    engine.add_request(EngineRequest(rid, req.prompt, params))
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


JOURNAL_PUSHES = 200   # queue pushes timed against phase 12's journal


async def journal_push_latency(cp_port: int, data_dir: str) -> dict:
    """Phase 12's journal: JOURNAL_PUSHES sequential pushes of a 256-byte
    item to a queue of their own, each timed from the request to its
    acknowledgement (which the server sends once the record is fsync'd),
    then popped again; the prefill queue's own records beside them."""
    from dynamo_tpu_torch.runtime.transports.tcp import ControlPlaneClient
    c = await ControlPlaneClient("127.0.0.1", cp_port).connect()
    try:
        lat = []
        for i in range(JOURNAL_PUSHES):
            t0 = time.perf_counter()
            await c.queue_push("chip.journal_probe",
                               i.to_bytes(4, "little") * 64)
            lat.append(time.perf_counter() - t0)
        popped = [await c.queue_pop("chip.journal_probe", 5.0)
                  for _ in range(JOURNAL_PUSHES)]
        check(popped == [i.to_bytes(4, "little") * 64
                         for i in range(JOURNAL_PUSHES)],
              "phase 12's journal: the probe items came back out of order")
    finally:
        await c.close()
    js = journal_stats(data_dir)
    ops = {}
    for r in js["records"]:
        key = f"{r['op']} {r.get('queue', '')}".strip()
        ops[key] = ops.get(key, 0) + 1
    q = quantiles(lat)
    out = {"push_p50_ms": q["p50_ms"], "push_p90_ms": q["p90_ms"],
           "push_max_ms": max(lat) * 1e3, "records": len(js["records"]),
           "bytes": js["bytes"], "ops": ops}
    prefill = sum(n for k, n in ops.items()
                  if k.startswith("qpush ") and "prefill" in k)
    check(prefill > 0, f"phase 12's journal holds no prefill-queue push: "
          f"{ops}")
    print(f"disaggregated deployment: the control plane's journal (fsync "
          f"on) acknowledged {JOURNAL_PUSHES} pushes in p50 "
          f"{out['push_p50_ms']:.3f} ms, p90 {out['push_p90_ms']:.3f} ms, "
          f"max {out['push_max_ms']:.3f} ms; it holds {out['records']} "
          f"records ({out['bytes']} bytes): {json.dumps(ops)}", flush=True)
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
    n_layers = min(DISAGG_LAYERS, get_model_config(model).num_layers)
    for svc in ("DecodeWorker", "PrefillWorker"):
        cfg[svc]["num_layers"] = n_layers
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
    import shutil
    import tempfile
    cp_dir = tempfile.mkdtemp(prefix="chip_smoke_disagg_cp_")
    try:
        # the control plane journals its state (the prefill queue among
        # it) into cp_dir, fsync'd: a push is acknowledged once durable
        sup = Child("disagg supervisor", [
            "dynamo_tpu_torch.sdk.serve", DISAGG_GRAPH, "-f", path,
            "--start-control-plane", "--control-port", "0",
            "--control-data-dir", cp_dir], session=True)
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
            cp_port, fe_port, model, scale, n_layers, reference, pre,
            card.kv_page_size, cfg["DecodeWorker"][
                "max_local_prefill_length"], smi, device == "cuda"), 900))
        rec["journal"] = asyncio.run(asyncio.wait_for(
            journal_push_latency(cp_port, cp_dir), 120))
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
        shutil.rmtree(cp_dir, ignore_errors=True)


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


def phase_pool_service(build, hists: list, expect: list, ps: int,
                       num_pages: int, kill_after: int = 8) -> dict:
    """Phase 13's pool-service run (see the docstring at the top): P3
    publishes `hists` into a ClusterKvPool of 3 hosts at R = 2, P4 serves
    them from it with one host killed after `kill_after` page fetches;
    `expect` are P1's repeat streams. Then the router's pricing of those
    fetches (`pool_pricing`)."""
    from dynamo_tpu_torch.engine.kv_pool import POOL_STATS
    from dynamo_tpu_torch.engine.pool_service import (
        REMOTE_STATS, RING_STATS, ClusterKvPool, KvPoolHost,
    )
    from dynamo_tpu_torch.observability.fleet import TRANSFER_MODEL
    t0 = time.perf_counter()
    POOL_STATS.reset()
    REMOTE_STATS.reset()
    RING_STATS.reset()
    TRANSFER_MODEL.reset()
    cl = ClusterKvPool(replicas=2)
    for i in range(3):
        cl.add_host(KvPoolHost(f"ph{i}", capacity_pages=4 * 64))
    cl.run_rebalance()
    p3 = build(num_pages)
    p3.attach_kv_pool(cl, "P3")
    for i, h in enumerate(hists):
        tier_serve(p3, f"P3-{i}", h)
    p3.drain_kv_events()
    p3._pool_stream.drain()
    published = len(cl)
    p3.close()
    del p3
    killed = {}
    fetch = cl.fetch
    # the pages each host served to P4's replica walks, counted here
    served_by: dict = {}
    walking = []

    def counting(host):
        inner = host.fetch_page

        def fetch_page(seq_hash, mode=""):
            arrays = inner(seq_hash, mode)
            if walking and arrays is not None:
                served_by[host.host_id] = served_by.get(host.host_id, 0) + 1
            return arrays
        host.fetch_page = fetch_page
    for host in cl._hosts.values():
        counting(host)

    def fetch_then_kill(seq_hash, mode=""):
        walking.append(1)
        try:
            out = fetch(seq_hash, mode)
        finally:
            walking.pop()
        if not killed and REMOTE_STATS.fetch_pages >= kill_after:
            # the host dies; its watch delete has not landed yet
            victim = max(cl._hosts.values(), key=len)
            victim.kill()
            killed["host"] = victim.host_id
            killed["after_pages"] = REMOTE_STATS.fetch_pages
        return out
    cl.fetch = fetch_then_kill
    p4 = build(num_pages)
    p4.attach_kv_pool(cl, "P4", publish=False)
    served = [tier_serve(p4, f"P4-{i}", h) for i, h in enumerate(hists)]
    want = sum((len(h) - 1) // ps for h in hists)
    rs = REMOTE_STATS.snapshot()
    for i, r in enumerate(served):
        check(len(r["tokens"]) == TIER_MAX_TOKENS,
              f"pool service: P4 request {i} ended after "
              f"{len(r['tokens'])} tokens (a dropped stream)")
        check(r["tokens"] == expect[i],
              f"pool service: P4 request {i}: stream differs from P1's at "
              f"{first_difference(r['tokens'], expect[i])}")
    check(killed and p4.scheduler.pool_fetched_pages == want
          and rs["fetch_failovers"] >= 1 and rs["fetch_exhausted"] == 0
          and rs["stale_epoch_landed"] == 0,
          f"pool service: P4 fetched {p4.scheduler.pool_fetched_pages} "
          f"pages, expected {want}; killed {killed}; remote {rs}")
    page_bytes = kv_page_bytes(p4.model_cfg, ps)
    check(p4.metrics().kv_page_bytes == page_bytes,
          f"pool service: P4 reports {p4.metrics().kv_page_bytes} bytes a "
          f"page; its config derives {page_bytes}")
    p4.close()
    pricing = pool_pricing(served_by, rs["fetch_pages"], page_bytes,
                           (len(hists[0]) - 1) // ps, len(hists[0]), ps)
    out = {"published_pages": published, "fetched": want, "killed": killed,
           "remote": rs, "ring": RING_STATS.snapshot(), "pricing": pricing,
           "p4_ttft": quantiles([x["ttft_s"] for x in served]),
           "seconds": time.perf_counter() - t0}
    print(f"pool service: 3 hosts, R = 2, {published} pages published; "
          f"{killed['host']} killed after {killed['after_pages']} fetches; "
          f"P4 fetched {want} pages with {rs['fetch_failovers']} failovers, "
          f"0 dropped streams, streams equal P1's; "
          f"{out['seconds']:.1f} s", flush=True)
    return out


def pool_pricing(served_by: dict, fetched: int, page_bytes: int,
                 fetchable: int, isl: int, ps: int) -> dict:
    """Phase 13's pricing gate: after P4's fetches the process-global
    transfer cost model holds one `pool:{host}` link for each host that
    served P4 a page (`served_by`, counted around the hosts' fetch_page),
    with as many samples as that host served, summing to the pages fetched.
    A TransferAwareSelector scoring a request of `isl` tokens whose first
    `fetchable` pages sit in the pool, on two workers that hold none of
    them (their own links unmeasured), prices each fetch at those EWMAs:
    the cold prior is the median of the measured links, so each worker's
    transfer seconds are (pages to move + fetchable) x page_bytes over that
    median, and its pool_fetch_bytes are fetchable x page_bytes."""
    import random
    from dynamo_tpu_torch.kv_router.indexer import MatchResult
    from dynamo_tpu_torch.kv_router.scheduler import (
        SchedulingRequest, TransferAwareSelector,
    )
    from dynamo_tpu_torch.kv_router.scoring import (
        ProcessedEndpoints, WorkerMetrics,
    )
    from dynamo_tpu_torch.observability.fleet import TRANSFER_MODEL
    t0 = time.perf_counter()
    snap = TRANSFER_MODEL.snapshot()
    links = {k: v["samples"] for k, v in snap.items()
             if k.startswith("pool:")}
    check(links == {f"pool:{h}": n for h, n in served_by.items()}
          and sum(links.values()) == fetched > 0,
          f"pool pricing: transfer links {links}, hosts served "
          f"{served_by}, {fetched} pages fetched")
    bws = sorted(TRANSFER_MODEL.bandwidth_bytes_per_s(k) for k in links)
    median = bws[len(bws) // 2]
    sel = TransferAwareSelector(rng=random.Random(0),
                                health_of=lambda w: 1.0)
    eps = ProcessedEndpoints({w: WorkerMetrics(
        request_total_slots=8, kv_total_blocks=1000, kv_page_bytes=page_bytes,
        request_active_slots=i) for i, w in enumerate(("wa", "wb"))})
    sel.select_worker(eps, SchedulingRequest(isl, MatchResult(),
                                             pool_matched=fetchable), ps)
    required = -(-isl // ps)
    for w, c in sel.last_components.items():
        want_s = required * page_bytes / max(1.0, median)
        check(c["pool_blocks"] == fetchable
              and c["pool_fetch_bytes"] == fetchable * page_bytes
              and c["transfer_bytes"] == (required - fetchable) * page_bytes
              and c["cold"] and c["transfer_s"] == round(want_s, 6),
              f"pool pricing: {w} scored {c}; derived {fetchable} fetchable "
              f"pages of {page_bytes} bytes, {required} required, "
              f"{want_s:.6f} s at the pool links' median {median:.1f} B/s")
    out = {"links": links, "median_bytes_per_s": median,
           "page_bytes": page_bytes, "fetchable": fetchable,
           "components": sel.last_components}
    print(f"pool pricing: {len(links)} pool:{{host}} links, samples "
          f"{json.dumps(links)} = {fetched} pages fetched; a request of "
          f"{isl} tokens with {fetchable} pool pages prices "
          f"{fetchable * page_bytes} fetch bytes a worker at the links' "
          f"median {median:.4g} B/s", flush=True)
    print(f"phase seconds: 13 pool pricing {time.perf_counter() - t0:.1f}",
          flush=True)
    return out


# depth cuts that keep the script inside its time limit: the layers of
# llama3-8b that phases 13 and 19 (TIER_LAYERS) and 16b's window A/B
# (AB_LAYERS) run (widths unchanged; their gates count pages, hits and
# layers x steps)
TIER_LAYERS = 4
AB_LAYERS = 8


def phase_tiers(smi: str, model: str = "llama3-8b", device: str = "cuda",
                scale: float = 1.0, device_name: str = None,
                layers: int = TIER_LAYERS) -> dict:
    """Phase 13 (see the docstring at the top), at `layers` of the model's
    depth when that cuts it (0: all)."""
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
    if 0 < layers < cfg.num_layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
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
    del p1, p2, pool
    rec["pool_service"] = phase_pool_service(
        build, p_hists, [a["tokens"] for a in again], ps, sz["p_pages"])
    del params
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


# -- phase 14: mixture-of-experts serving (mixtral-8x7b, int8 experts) ----------

MOE_RESULT = "PHASE14 "    # the child's result line: this prefix, then JSON


class MoeCounts:
    """An MoE engine's expert-dispatch counts over one serving run: the
    routed and dropped pairs its committed programs added, and the drops
    that decode windows added (the engine's window fetch is wrapped for the
    run; `detach` unwraps it)."""

    def __init__(self, engine):
        self.engine = engine
        self.routed0 = engine.moe_routed_tokens
        self.dropped0 = engine.moe_dropped_tokens
        self.steps0 = engine.decode_window_steps
        self.replays0 = dict(engine.graphs.replay_launches)
        self.window_dropped = 0.0
        fetch = engine._fetch_and_commit

        def counted(plan, handle):
            d0 = engine.moe_dropped_tokens
            try:
                return fetch(plan, handle)
            finally:
                self.window_dropped += engine.moe_dropped_tokens - d0
        engine._fetch_and_commit = counted

    def detach(self) -> None:
        del self.engine._fetch_and_commit

    def check(self, name: str, pipe, requests, results, seen: list,
              replays: dict) -> dict:
        """The run's gates. Routed pairs: k x num_layers per real token
        each step routes, the prompt tokens actually prefilled (the prompt
        less the pages an earlier prompt stored, `expected_prefix_hits`
        from the token ids) plus the decode rows written: n - 1 for a
        stream of n tokens (a stop token counted in n), or n when the last
        token of a stream that ran to max_tokens was fed by a window step
        (its row is written at max_pos, the JAX rule; whether a window or
        the host's commit came first is not visible outside the engine),
        so the count must lie in that band. Decode windows drop nothing (a
        decode row is one token a batch row: capacity 1, and its top-k
        experts are distinct). Every window graph holds 3 x num_layers x
        nw grouped launches, (4 x num_layers + 1) x nw W8A16 ones with int8
        weights and num_layers x nw ragged ones; the replays add 3 x
        num_layers grouped launches a decode step."""
        eng = self.engine
        cfg, ps = eng.model_cfg, eng.cfg.page_size
        prompts = [pipe.preprocessor.preprocess_chat(r, f"moe-{i}")[0]
                   .token_ids for i, r in enumerate(requests)]
        hits = (expected_prefix_hits(seen + prompts, ps)[0]
                - expected_prefix_hits(seen, ps)[0])
        seen.extend(prompts)
        prefilled = sum(len(p) for p in prompts) - ps * hits
        fins = [r.choices[0].finish_reason for r in results]
        rows = sum(r.usage.completion_tokens + (f == "stop") - 1
                   for r, f in zip(results, fins))
        per = cfg.num_experts_per_tok * cfg.num_layers
        lo = per * (prefilled + rows)
        hi = lo + per * fins.count("length")
        routed = eng.moe_routed_tokens - self.routed0
        dropped = eng.moe_dropped_tokens - self.dropped0
        check(lo <= routed <= hi and routed % per == 0,
              f"{name}: moe_routed_tokens added {routed}, expected k x "
              f"layers = {per} x (prefilled {prefilled} + decode rows "
              f"{rows} .. + {fins.count('length')}) = {lo} .. {hi}")
        check(self.window_dropped == 0,
              f"{name}: decode windows dropped {self.window_dropped} pairs")
        nl, steps = cfg.num_layers, eng.decode_window_steps - self.steps0
        for key, calls in eng.graphs.captured_calls().items():
            nw = key[4]
            w8 = decode_w8a16_launches(cfg) * nw if eng.quant else 0
            check(calls[MOE] == 3 * nl * nw and calls[RAGGED] == nl * nw
                  and calls[W8A16] == w8,
                  f"{name}: graph {key} holds {calls}, expected "
                  f"{3 * nl * nw} grouped, {w8} W8A16 and {nl * nw} ragged "
                  "launches")
        added = replays[MOE] - self.replays0[MOE]
        check(added == 3 * nl * steps,
              f"{name}: the replays added {added} grouped launches over "
              f"{steps} decode steps, expected {3 * nl * steps}")
        rec = {"routed": routed, "dropped": dropped,
               "window_dropped": self.window_dropped,
               "expected_routed": [lo, hi], "prefilled_tokens": prefilled,
               "prefix_hit_pages": hits, "decode_rows": rows,
               "drop_rate": dropped / routed if routed else 0.0}
        print(f"{name}: MoE dispatch routed {routed:.0f} (token, expert) "
              f"pairs in {lo}..{hi} = {per} x (prefilled {prefilled} "
              f"tokens + {rows}..{rows + fins.count('length')} decode "
              f"rows), dropped {dropped:.0f} ({rec['drop_rate']:.3%}), "
              f"0 by decode windows; every window graph holds 3 x {nl} x "
              f"nw grouped launches", flush=True)
        return rec


def moe_kernel_phase() -> tuple:
    """14.1: the grouped W8A16 kernel against its plain version at
    Mixtral's three expert shapes (gate and up 4096 -> 14336, down 14336 ->
    4096), one layer's slice of 8 experts, bf16 x of M = 8 rows an expert,
    under three routings: all 8 experts active, 2 (one live slot) and none.
    Active experts within the W8A16 phase's tolerance, inactive ones exact
    zeros (y's memory is filled with NaN just before, so an unwritten tile
    shows). Then CUDA-event times over replayed graphs per routing: the
    kernel, its bound (the active experts' weights and scales, their x, all
    of y, over 3.35 TB/s), the plain version and torch.matmul on bf16
    copies of the active experts; and the prefill route (dequantize +
    torch.matmul, M = 256 rows an expert: a 512-token chunk of one batch
    row). Returns (max abs error, the kernel's record)."""
    import torch
    from dynamo_tpu_torch.engine.config import get_model_config
    from dynamo_tpu_torch.ops import quant
    cfg = get_model_config("mixtral-8x7b")
    e, d, f = cfg.num_experts, cfg.hidden_size, cfg.intermediate_size
    shapes = {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}
    routings = {"all 8 active": list(range(e)), "2 active": [2, 5],
                "none active": []}
    m, bf16 = 8, torch.bfloat16
    worst, large_worst, per_shape = 0.0, 0.0, {}
    for si, (name, (k, n)) in enumerate(shapes.items()):
        g = torch.Generator(device="cuda").manual_seed(300 + si)
        q = torch.empty((e, k, n), dtype=torch.int8, device="cuda")
        s = torch.empty((e, 1, n), dtype=torch.float32, device="cuda")
        for j in range(e):
            part = quant.quantize_int8(torch.randn(
                (k, n), generator=g, device="cuda", dtype=bf16) * k ** -0.5)
            q[j].copy_(part["q"])
            s[j].copy_(part["s"])
        x = torch.randn((e, m, k), generator=g, device="cuda").to(bf16)
        rec = {}
        for label, ids in routings.items():
            active = torch.zeros((e,), dtype=torch.int32, device="cuda")
            active[ids] = 1
            poison = torch.full((e, m, n), float("nan"), dtype=bf16,
                                device="cuda")
            del poison
            got = quant.grouped_w8a16(x, q, s, active)
            torch.cuda.synchronize()
            for j in range(e):
                if j in ids:
                    worst = max(worst, w8a16_check(
                        f"grouped {name} expert {j} ({label})", x[j],
                        {"q": q[j], "s": s[j].reshape(-1)}, got[j]))
                else:
                    check(bool((got[j] == 0).all()),
                          f"grouped {name} expert {j} ({label}): an "
                          "inactive expert's output is not exact zeros")
            ms = cuda_ms(lambda i: quant.grouped_w8a16(x, q, s, active), 20,
                         graph=True)
            plain = cuda_ms(lambda i: quant.grouped_w8a16_plain(
                x, q, s, active), 3)
            lib = None
            if ids:
                xa = x[ids].contiguous()
                wa = quant.wmat({"q": q[ids], "s": s[ids]}, bf16)
                lib = cuda_ms(lambda i: torch.matmul(xa, wa), 20, graph=True)
                del xa, wa
            a = len(ids)
            nbytes = a * (k * n + 4 * n + 2 * m * k) + 2 * e * m * n
            b = bound(nbytes, 2 * m * k * n * a, "bfloat16")
            rec[label] = {"ms": ms, "plain_ms": plain, "library_ms": lib,
                          **b, "share_of_bound": b["bound_ms"] / ms,
                          "active": a}
            print(f"timing grouped w8a16 {name} (E={e}, M={m}, K={k}, "
                  f"N={n}, {label}): kernel {ms:.4f} ms (graph replay), "
                  f"bound {b['bound_ms']:.4f} ms ({nbytes} bytes), "
                  f"{b['bound_ms'] / ms:.1%} of the bound; plain "
                  f"{plain:.4f} ms; torch.matmul on the active experts' "
                  f"bf16 weights {'n/a' if lib is None else f'{lib:.4f}'}"
                  " ms", flush=True)
        large = {}
        for mm in (256, 2048):
            lw, lrec = moe_large_m(name, q, s, mm, routings, g)
            large_worst = max(large_worst, lw)
            large[f"M={mm}"] = lrec
        rec["large_m"] = large
        rec["prefill_route_ms"] = large["M=256"]["all 8 active"]["ms"]
        rec["old_prefill_route_ms"] = large["M=256"]["old_route_ms"]
        per_shape[name] = rec
        del q, s, x
        torch.cuda.empty_cache()
    nl = cfg.num_layers
    step = {key: nl * sum(per_shape[p]["all 8 active"][key] for p in shapes)
            for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    one_slot = {key: nl * sum(per_shape[p]["2 active"][key] for p in shapes)
                for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    prefill = nl * sum(per_shape[p]["prefill_route_ms"] for p in shapes)
    old_prefill = nl * sum(per_shape[p]["old_prefill_route_ms"]
                           for p in shapes)
    chunk = {key: nl * sum(per_shape[p]["large_m"]["M=256"]["all 8 active"]
                           [key] for p in shapes)
             for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    print(f"grouped w8a16 per decode step (3 x {nl} launches, every expert "
          f"active): kernel {step['ms']:.3f} ms, bound "
          f"{step['bound_ms']:.3f} ms ({step['bound_ms'] / step['ms']:.1%}),"
          f" plain {step['plain_ms']:.3f} ms, torch.matmul on bf16 experts "
          f"{step['library_ms']:.3f} ms; one live slot (2 active): "
          f"{one_slot['ms']:.3f} ms against {one_slot['bound_ms']:.3f}, "
          f"plain {one_slot['plain_ms']:.3f} ms, torch.matmul on the 2 "
          f"active bf16 experts {one_slot['library_ms']:.3f} ms; "
          f"the prefill route's expert products for one 512-token chunk "
          f"(3 x {nl} tensor-core launches, 256 rows an expert): "
          f"{prefill:.3f} ms against the old route's (dequantize + "
          f"torch.matmul, re-timed here) {old_prefill:.3f} ms; bound "
          f"{chunk['bound_ms']:.3f} ms, torch.matmul on bf16 experts "
          f"{chunk['library_ms']:.3f} ms", flush=True)
    return worst, {**step, "bound_by": "bytes", "one_live_slot": one_slot,
                   "prefill_route_ms_per_step": prefill,
                   "old_prefill_route_ms_per_step": old_prefill,
                   "per_shape": per_shape}, {
        "max_abs_err": large_worst, "chunk": chunk,
        "old_route_ms_per_chunk": old_prefill}


def moe_large_m(name: str, q, s, m: int, routings: dict, g) -> tuple:
    """14.1: the tensor-core kernel's grouped call over one layer's 8
    experts at M rows an expert, under each routing: active experts within
    the W8A16 bf16 tolerance of the plain version, inactive ones exact
    zeros (y's memory NaN-filled just before); then CUDA-event times over
    replayed graphs: the kernel, its bound (the active experts' work and
    bytes, and all of y), the plain version (`grouped_w8a16_plain`),
    torch.matmul on bf16 copies of the active experts, and once the old
    route as it ran (every expert dequantized + torch.matmul). Returns
    (max |diff|, the record)."""
    import torch
    from dynamo_tpu_torch.ops import quant
    bf16 = torch.bfloat16
    e, k, n = q.shape
    x = torch.randn((e, m, k), generator=g, device="cuda").to(bf16)
    worst, rec = 0.0, {}
    for label, ids in routings.items():
        active = torch.zeros((e,), dtype=torch.int32, device="cuda")
        active[ids] = m
        poison = torch.full((e, m, n), float("nan"), dtype=bf16,
                            device="cuda")
        del poison
        got = quant.grouped_linear(x, {"q": q, "s": s}, active)
        torch.cuda.synchronize()
        for j in range(e):
            if j in ids:
                worst = max(worst, w8a16_check(
                    f"w8a16_large_m grouped {name} M={m} expert {j} "
                    f"({label})", x[j], {"q": q[j], "s": s[j].reshape(-1)},
                    got[j]))
            else:
                check(bool((got[j] == 0).all()),
                      f"w8a16_large_m grouped {name} M={m} expert {j} "
                      f"({label}): an inactive expert's output is not "
                      "exact zeros")
        del got
        ms = cuda_ms(lambda i: quant.large_m_gemm(x, q, s, active), 5,
                     graph=True)
        plain = cuda_ms(lambda i: quant.grouped_w8a16_plain(
            x, q, s, active), 2)
        lib = None
        if ids:
            xa = x[ids].contiguous()
            wa = quant.wmat({"q": q[ids], "s": s[ids]}, bf16)
            lib = cuda_ms(lambda i: torch.matmul(xa, wa), 5, graph=True)
            del xa, wa
        # the active experts' weights, scales and x, and all of y (the
        # inactive experts' rows are written as zeros)
        a = len(ids)
        b = bound(a * (k * n + 4 * n + 2 * m * k) + 2 * e * m * n,
                  2 * m * k * n * a, "bfloat16")
        rec[label] = {"ms": ms, "plain_ms": plain, "library_ms": lib, **b,
                      "share_of_bound": b["bound_ms"] / ms,
                      "active": len(ids)}
        print(f"timing w8a16_large_m grouped {name} (E={e}, M={m}, K={k}, "
              f"N={n}, {label}): kernel {ms:.4f} ms, bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']}), "
              f"{b['bound_ms'] / ms:.1%} of the bound; plain {plain:.4f} "
              f"ms; torch.matmul on the active experts' bf16 weights "
              f"{'n/a' if lib is None else f'{lib:.4f}'} ms", flush=True)
    rec["old_route_ms"] = cuda_ms(lambda i: [
        torch.matmul(x[j], quant.dequantize({"q": q[j], "s": s[j]}, bf16))
        for j in range(e)], 2, graph=True)
    print(f"timing the old prefill route for {name} (E={e}, M={m}: every "
          f"expert dequantized + torch.matmul): {rec['old_route_ms']:.4f} ms",
          flush=True)
    del x
    torch.cuda.empty_cache()
    return worst, rec


def phase_moe(smi: str) -> dict:
    """Phase 14, in its own process: the kernel (moe_kernel_phase), then
    mixtral-8x7b with int8 weights at full width and depth, bf16 KV pages,
    random weights from seed 0, the default EngineConfig, serving the 8
    chats twice through LocalPipeline (serve_main_path: every phase-4 gate,
    plus MoeCounts' gates), one window as graph and eager
    (phase_graph_vs_eager, with the traced window and the untraced ms per
    decode step)."""
    import torch
    t0 = time.perf_counter()
    err, kernel, large_m = moe_kernel_phase()
    torch.cuda.empty_cache()
    engine, first, warm = asyncio.run(serve_main_path(
        smi, quant="int8", model="mixtral-8x7b"))
    graph = phase_graph_vs_eager(engine, "mixtral-8x7b int8",
                                 model="mixtral-8x7b")
    m = engine.metrics()
    rec = {"kernel": kernel, "max_abs_err": err, "large_m": large_m,
           "launches": first["all_launches"],
           "warm_launches": warm["all_launches"],
           "runs": {"capturing": {**first["stats"], **first["moe"]},
                    "warm": {**warm["stats"], **warm["moe"]}},
           "graph_vs_eager": graph, "weight_bytes": m.weight_bytes,
           "drop_rate": engine.moe_drop_rate(),
           "phase_s": time.perf_counter() - t0}
    print(f"mixtral-8x7b int8 [{smi}]: weight_bytes {m.weight_bytes}, "
          f"TTFT p50 / p90 capturing {first['stats']['ttft_p50_ms']:.1f} / "
          f"{first['stats']['ttft_p90_ms']:.1f} ms, warm "
          f"{warm['stats']['ttft_p50_ms']:.1f} / "
          f"{warm['stats']['ttft_p90_ms']:.1f} ms; warm decode "
          f"{warm['stats']['decode_tok_s']:.1f} tok/s; untraced "
          f"{graph['fused']['untraced_ms_per_step']:.3f} ms a decode step; "
          f"peak {max(first['stats']['peak_gib'], warm['stats']['peak_gib']):.2f}"
          f" GiB; drop rate {rec['drop_rate']:.4%}; phase "
          f"{rec['phase_s']:.1f} s", flush=True)
    return rec


def moe_main() -> int:
    """`chip_smoke.py --phase-moe`: phase 14 alone, in the process main()
    starts for it, on kernels main() has built; its last line is the
    result (MOE_RESULT + JSON)."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke --phase-moe: CUDA is not available",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rec = phase_moe(nvidia_smi())
    print(MOE_RESULT + json.dumps(rec), flush=True)
    return 0


def phase_moe_child() -> dict:
    """Phase 14 in a child process: the engines of earlier phases keep
    device memory in this one, and Mixtral's ~44 GiB of int8 weights need
    the card to itself. The child's output passes through; a non-zero exit
    or a missing result line fails the run."""
    import gc
    import torch
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--phase-moe"], cwd=root,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    result, tail = None, []
    try:
        for line in proc.stdout:
            if line.startswith(MOE_RESULT):
                result = json.loads(line[len(MOE_RESULT):])
            else:
                print(line, end="", flush=True)
                tail = (tail + [line.rstrip("\n")])[-25:]
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    check(rc == 0 and result is not None,
          f"phase 14 (mixtral-8x7b, child process) exited {rc}"
          f"{'' if result is not None else ' without its result line'}"
          "; last output:\n" + "\n".join(tail))
    return result


# -- phase 15: checkpoints ----------------------------------------------------

ST_CODES = {"float32": "F32", "float16": "F16", "bfloat16": "BF16",
            "int8": "I8", "uint8": "U8", "int32": "I32", "int64": "I64"}


def write_safetensors(path: str, entries: list) -> int:
    """A .safetensors file from [(name, fetch)]: fetch() gives the tensor
    (on any device), called twice: once for the header's shapes (a view
    costs nothing), once to copy it to the host and write it, one tensor
    at a time. Returns the file's bytes."""
    import torch
    header, off = {}, 0
    for name, fetch in entries:
        t = fetch()
        n = t.numel() * t.element_size()
        header[name] = {"dtype": ST_CODES[str(t.dtype)[6:]],
                        "shape": list(t.shape), "data_offsets": [off, off + n]}
        off += n
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)) + head)
        for name, fetch in entries:
            t = fetch().contiguous().cpu()
            f.write(t.reshape(-1).view(torch.uint8).numpy())
    return 8 + len(head) + off


HF_ARCH = {"llama": "LlamaForCausalLM", "qwen2": "Qwen2ForCausalLM",
           "phi3": "Phi3ForCausalLM", "gemma": "GemmaForCausalLM",
           "gemma2": "Gemma2ForCausalLM", "mixtral": "MixtralForCausalLM"}


def hf_config(cfg, family: str, bos: int, eos: int) -> dict:
    """config.json for `cfg`: what models/loader.config_from_hf maps back
    onto it."""
    out = {"architectures": [HF_ARCH[family]], "model_type": family,
           "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
           "intermediate_size": cfg.intermediate_size,
           "num_hidden_layers": cfg.num_layers,
           "num_attention_heads": cfg.num_heads,
           "num_key_value_heads": cfg.num_kv_heads,
           "head_dim": cfg.head_dim, "rope_theta": cfg.rope_theta,
           "rms_norm_eps": cfg.rms_norm_eps,
           "max_position_embeddings": cfg.max_model_len,
           "tie_word_embeddings": cfg.tie_word_embeddings,
           "dtype": cfg.dtype, "bos_token_id": bos, "eos_token_id": eos}
    if family in ("gemma", "gemma2"):
        out["hidden_activation"] = "gelu_pytorch_tanh"
    else:
        out["hidden_act"] = "silu"
    if family == "gemma2":
        out.update(attn_logit_softcapping=cfg.attn_softcap,
                   final_logit_softcapping=cfg.final_softcap,
                   query_pre_attn_scalar=round(cfg.query_scale ** -2),
                   sliding_window=cfg.sliding_window)
    if family == "qwen2":
        out["use_sliding_window"] = False
    if family == "mixtral":
        out.update(num_local_experts=cfg.num_experts,
                   num_experts_per_tok=cfg.num_experts_per_tok)
    return out


def hf_entries(cfg, params, family: str) -> list:
    """[(HF tensor name, fetch)] of a parameter tree: the inverse of
    models/loader.py's mapping ([in, out] leaves back to [out, in], Phi-3's
    q | k | v and gate | up fused, Mixtral's experts one by one)."""
    import torch
    lp = params["layers"]
    out = [("model.embed_tokens.weight", lambda: params["embed"])]

    def add(name, fn):
        out.append((name, fn))
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}."
        add(pre + "input_layernorm.weight", lambda i=i: lp["attn_norm"][i])
        if family == "phi3":
            add(pre + "self_attn.qkv_proj.weight", lambda i=i: torch.cat(
                [lp[k][i].T for k in ("wq", "wk", "wv")]))
        else:
            for k in "qkv":
                add(pre + f"self_attn.{k}_proj.weight",
                    lambda i=i, k=k: lp[f"w{k}"][i].T)
        if cfg.attn_bias:
            for k in "qkv":
                add(pre + f"self_attn.{k}_proj.bias",
                    lambda i=i, k=k: lp[f"w{k}_b"][i])
        add(pre + "self_attn.o_proj.weight", lambda i=i: lp["wo"][i].T)
        if cfg.post_norms:   # Gemma-2's four norms a layer
            for ours, theirs in (("post_attn_norm", "post_attention"),
                                 ("mlp_norm", "pre_feedforward"),
                                 ("post_mlp_norm", "post_feedforward")):
                add(pre + f"{theirs}_layernorm.weight",
                    lambda i=i, k=ours: lp[k][i])
        else:
            add(pre + "post_attention_layernorm.weight",
                lambda i=i: lp["mlp_norm"][i])
        if cfg.is_moe:
            moe = pre + "block_sparse_moe."
            add(moe + "gate.weight", lambda i=i: lp["router"][i].T)
            for e in range(cfg.num_experts):
                for ours, theirs in (("w_gate", "w1"), ("w_up", "w3"),
                                     ("w_down", "w2")):
                    add(moe + f"experts.{e}.{theirs}.weight",
                        lambda i=i, e=e, k=ours: lp[k][i, e].T)
        elif family == "phi3":
            add(pre + "mlp.gate_up_proj.weight", lambda i=i: torch.cat(
                [lp["w_gate"][i].T, lp["w_up"][i].T]))
            add(pre + "mlp.down_proj.weight", lambda i=i: lp["w_down"][i].T)
        else:
            for ours, theirs in (("w_gate", "gate"), ("w_up", "up"),
                                 ("w_down", "down")):
                add(pre + f"mlp.{theirs}_proj.weight",
                    lambda i=i, k=ours: lp[k][i].T)
    add("model.norm.weight", lambda: params["final_norm"])
    if not cfg.tie_word_embeddings:
        add("lm_head.weight", lambda: params["lm_head"].T)
    return out


def write_hf_dir(path: str, cfg, params, family: str, bos: int, eos: int,
                 shards: int = 1) -> int:
    """An HF-style directory: config.json and the tensors in `shards`
    safetensors files (with model.safetensors.index.json past one).
    Returns the bytes written."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_config(cfg, family, bos, eos), f, indent=1)
    entries = hf_entries(cfg, params, family)
    if shards == 1:
        return write_safetensors(os.path.join(path, "model.safetensors"),
                                 entries)
    sizes = [f().numel() * f().element_size() for _, f in entries]
    total, groups, acc = sum(sizes), [[] for _ in range(shards)], 0
    for e, n in zip(entries, sizes):
        groups[min(acc * shards // total, shards - 1)].append(e)
        acc += n
    names = [f"model-{k + 1:05d}-of-{shards:05d}.safetensors"
             for k in range(shards)]
    written = sum(write_safetensors(os.path.join(path, n), g)
                  for n, g in zip(names, groups))
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": {
            name: n for n, g in zip(names, groups) for name, _ in g}}, f)
    return written


# the Llama-3 pre-tokenizer pattern (its published tokenizer.json)
LLAMA3_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|"
                r"\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|"
                r"\s+(?!\S)|\s+")
LLAMA3_SPECIALS = {0: "<|begin_of_text|>", 1: "<|end_of_text|>",
                   6: "<|start_header_id|>", 7: "<|end_header_id|>",
                   9: "<|eot_id|>"}
# Meta-Llama-3-8B-Instruct's chat template
LLAMA3_TEMPLATE = (
    "{% set loop_messages = messages %}{% for message in loop_messages %}"
    "{% set content = '<|start_header_id|>' + message['role'] + "
    "'<|end_header_id|>\n\n'+ message['content'] | trim + '<|eot_id|>' %}"
    "{% if loop.index0 == 0 %}{% set content = bos_token + content %}"
    "{% endif %}{{ content }}{% endfor %}{% if add_generation_prompt %}"
    "{{ '<|start_header_id|>assistant<|end_header_id|>\n\n' }}{% endif %}")
TOKENIZER_CORPUS = (
    "The quick brown fox jumps over the lazy dog. Serving a checkpoint "
    "means reading its config, its tokenizer and its weights, then "
    "answering chats token by token. It's 2026; we'll keep streams "
    "identical, they're checked against the in-memory engine. Numbers "
    "like 12345, 3.14159 and 1,000,000 split in runs of three. Unicode: "
    "café, naïve, Ångström, 東京, 😀.\n\tIndented code: def f(x): return "
    "x ** 2\r\n")


def train_merges(corpus: str, n: int) -> list:
    """A byte-level BPE's first n merges, learned deterministically: the
    most frequent adjacent pair over the corpus's pre-tokens (the Llama-3
    split), ties to the smallest pair."""
    import collections
    from dynamo_tpu_torch.llm.bpe import BYTES_CHAR, compile_onig
    words = collections.Counter(
        tuple(BYTES_CHAR[b] for b in m.group().encode())
        for m in compile_onig(LLAMA3_SPLIT).finditer(corpus))
    merges = []
    for _ in range(n):
        pairs = collections.Counter()
        for w, c in words.items():
            for pair in zip(w, w[1:]):
                pairs[pair] += c
        if not pairs:
            break
        best = min(pairs.items(), key=lambda kv: (-kv[1], kv[0]))[0]
        merges.append(best)
        joined = collections.Counter()
        for w, c in words.items():
            out, i = [], 0
            while i < len(w):
                if w[i:i + 2] == best:
                    out.append(w[i] + w[i + 1])
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            joined[tuple(out)] += c
        words = joined
    return merges


def llama3_tokenizer_json(vocab_size: int = 128256,
                          n_merges: int = 600) -> dict:
    """A tokenizer.json of the Llama-3 form: a byte-level BPE on the
    Llama-3 split with ignore_merges, merges learned by `train_merges`
    from a fixed corpus, ids past the merges filled with two- and
    three-character byte strings up to 128000, and the Llama-3 special
    tokens at 128000+ (the reserved ones named as Meta names them)."""
    from dynamo_tpu_torch.llm.bpe import BYTES_CHAR
    chars = sorted(BYTES_CHAR.values())
    vocab = {c: i for i, c in enumerate(chars)}
    merges = train_merges(TOKENIZER_CORPUS * 3, n_merges)
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    first = 128000
    for a in chars:
        for b in chars:
            if len(vocab) >= first:
                break
            vocab.setdefault(a + b, len(vocab))
    for a in chars:
        for b in chars:
            for c in chars:
                if len(vocab) >= first:
                    break
                vocab.setdefault(a + b + c, len(vocab))
    reserved = 0
    added = []
    for k in range(vocab_size - first):
        name = LLAMA3_SPECIALS.get(k)
        if name is None:
            name = f"<|reserved_special_token_{reserved}|>"
            reserved += 1
        added.append({"id": first + k, "content": name, "single_word": False,
                      "lstrip": False, "rstrip": False, "normalized": False,
                      "special": True})
    return {"version": "1.0", "truncation": None, "padding": None,
            "added_tokens": added, "normalizer": None,
            "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
                {"type": "Split", "pattern": {"Regex": LLAMA3_SPLIT},
                 "behavior": "Isolated", "invert": False},
                {"type": "ByteLevel", "add_prefix_space": False,
                 "trim_offsets": True, "use_regex": False}]},
            "post_processor": None,
            "decoder": {"type": "ByteLevel", "add_prefix_space": True,
                        "trim_offsets": True, "use_regex": True},
            "model": {"type": "BPE", "dropout": None, "unk_token": None,
                      "continuing_subword_prefix": None,
                      "end_of_word_suffix": None, "fuse_unk": False,
                      "byte_fallback": False, "ignore_merges": True,
                      "vocab": vocab, "merges": [list(m) for m in merges]}}


# -- GGUF, written as tests/test_gguf.py writes it ----------------------------

def _gguf_str(s: str) -> bytes:
    b = s.encode()
    return struct.pack("<Q", len(b)) + b


def _gguf_value(vtype: int, v) -> bytes:
    fmts = {0: "<B", 1: "<b", 2: "<H", 3: "<h", 4: "<I", 5: "<i", 6: "<f",
            7: "<?", 10: "<Q", 11: "<q", 12: "<d"}
    if vtype in fmts:
        return struct.pack(fmts[vtype], v)
    return _gguf_str(v)


def write_gguf(path: str, metadata: dict, tensors: dict) -> None:
    """metadata {key: (vtype, value) | (9, (etype, [values]))}; tensors
    {name: (ggml type, row-major shape, raw bytes)}; alignment 32."""
    align = 32
    out = bytearray(b"GGUF" + struct.pack("<I", 3)
                    + struct.pack("<QQ", len(tensors), len(metadata)))
    for key, (vtype, value) in metadata.items():
        out += _gguf_str(key) + struct.pack("<I", vtype)
        if vtype == 9:
            etype, values = value
            out += struct.pack("<IQ", etype, len(values))
            for v in values:
                out += _gguf_value(etype, v)
        else:
            out += _gguf_value(vtype, value)
    offset, blobs = 0, []
    for name, (gtype, shape, raw) in tensors.items():
        dims = list(reversed(shape))
        out += _gguf_str(name) + struct.pack("<I", len(dims))
        out += b"".join(struct.pack("<Q", d) for d in dims)
        out += struct.pack("<IQ", gtype, offset)
        blobs.append((offset, raw))
        offset += (len(raw) + align - 1) // align * align
    out += b"\x00" * (-len(out) % align)
    data = bytearray(offset)
    for off, raw in blobs:
        data[off:off + len(raw)] = raw
    with open(path, "wb") as f:
        f.write(out + data)


def q8_0_bytes(x):
    """llama.cpp Q8_0: blocks of 32, an f16 scale and 32 int8 values."""
    import numpy as np
    flat = np.ascontiguousarray(x, np.float32).reshape(-1, 32)
    d = np.abs(flat).max(axis=1, keepdims=True) / 127.0
    d[d == 0] = 1.0
    q = np.clip(np.round(flat / d), -127, 127).astype(np.int8)
    blocks = np.concatenate([d.astype(np.float16).view(np.uint8),
                             q.view(np.uint8)], axis=1)
    return blocks.tobytes()


def q4_k_bytes(x):
    """llama.cpp Q4_K: super-blocks of 256 (f16 d, f16 dmin, 12 bytes of
    6-bit scales and mins for 8 sub-blocks of 32, 128 nibble bytes);
    value = d * sc * q - dmin * m."""
    import numpy as np
    v = np.ascontiguousarray(x, np.float32).reshape(-1, 8, 32)
    lo = np.minimum(v.min(axis=2), 0.0)
    scale = (v.max(axis=2) - lo) / 15.0
    d = np.maximum(scale.max(axis=1), 1e-12) / 63.0
    dmin = np.maximum((-lo).max(axis=1), 1e-12) / 63.0
    d16, dmin16 = d.astype(np.float16), dmin.astype(np.float16)
    sc = np.clip(np.round(scale / d16.astype(np.float32)[:, None]), 1, 63
                 ).astype(np.uint8)
    mn = np.clip(np.round(-lo / dmin16.astype(np.float32)[:, None]), 0, 63
                 ).astype(np.uint8)
    step = (d16.astype(np.float32)[:, None] * sc)[:, :, None]
    off = (dmin16.astype(np.float32)[:, None] * mn)[:, :, None]
    q = np.clip(np.round((v + off) / step), 0, 15).astype(np.uint8)
    packed = np.empty((v.shape[0], 12), np.uint8)
    packed[:, 0:4] = sc[:, 0:4] | ((sc[:, 4:8] >> 4) << 6)
    packed[:, 4:8] = mn[:, 0:4] | ((mn[:, 4:8] >> 4) << 6)
    packed[:, 8:12] = (sc[:, 4:8] & 0x0F) | ((mn[:, 4:8] & 0x0F) << 4)
    nib = q.reshape(-1, 4, 2, 32)
    qs = (nib[:, :, 0] | (nib[:, :, 1] << 4)).reshape(-1, 128)
    return np.concatenate([d16[:, None].view(np.uint8),
                           dmin16[:, None].view(np.uint8), packed, qs],
                          axis=1).tobytes()


def q6_k_bytes(x):
    """llama.cpp Q6_K: super-blocks of 256 (128 low-nibble bytes, 64
    high-2-bit bytes, 16 int8 scales, f16 d); value = d * sc * (q - 32)."""
    import numpy as np
    v = np.ascontiguousarray(x, np.float32).reshape(-1, 16, 16)
    amax = np.abs(v).max(axis=2)
    d = np.maximum(amax.max(axis=1), 1e-12) / (32.0 * 127.0)
    d16 = d.astype(np.float16)
    sc = np.clip(np.round(amax / 32.0 / d16.astype(np.float32)[:, None]),
                 1, 127).astype(np.int8)
    step = (d16.astype(np.float32)[:, None] * sc)[:, :, None]
    q = (np.clip(np.round(v / step), -32, 31) + 32).astype(np.uint8)
    q = q.reshape(-1, 2, 4, 32)          # half, quarter, l
    ql = np.empty((q.shape[0], 2, 64), np.uint8)
    ql[:, :, :32] = (q[:, :, 0] & 0x0F) | ((q[:, :, 2] & 0x0F) << 4)
    ql[:, :, 32:] = (q[:, :, 1] & 0x0F) | ((q[:, :, 3] & 0x0F) << 4)
    qh = ((q[:, :, 0] >> 4) | ((q[:, :, 1] >> 4) << 2)
          | ((q[:, :, 2] >> 4) << 4) | ((q[:, :, 3] >> 4) << 6))
    return np.concatenate([ql.reshape(-1, 128), qh.reshape(-1, 64),
                           sc.view(np.uint8), d16[:, None].view(np.uint8)],
                          axis=1).tobytes()


GGML = {"F32": 0, "F16": 1, "Q8_0": 8, "Q4_K": 12, "Q6_K": 14}


def write_llama_gguf(path: str, cfg, params) -> dict:
    """A llama GGUF of a parameter tree (llm/gguf.py's mapping inverted)
    mixing F32 norms, an F16 embedding, Q8_0 / Q4_K / Q6_K projections and
    a Q6_K head. Returns {ggml type: tensors of that type}."""
    import numpy as np
    quant = {"F32": lambda a: a.astype(np.float32).tobytes(),
             "F16": lambda a: a.astype(np.float16).tobytes(),
             "Q8_0": q8_0_bytes, "Q4_K": q4_k_bytes, "Q6_K": q6_k_bytes}
    tensors, kinds = {}, {}

    def put(name, t, kind):
        a = t.float().cpu().numpy()
        tensors[name] = (GGML[kind], a.shape, quant[kind](a))
        kinds[kind] = kinds.get(kind, 0) + 1
    lp = params["layers"]
    put("token_embd.weight", params["embed"], "F16")
    put("output_norm.weight", params["final_norm"], "F32")
    put("output.weight", params["lm_head"].T, "Q6_K")
    for i in range(cfg.num_layers):
        for name, key, kind in (
                ("attn_q", "wq", "Q8_0"), ("attn_k", "wk", "Q4_K"),
                ("attn_v", "wv", "F16"), ("attn_output", "wo", "Q8_0"),
                ("ffn_gate", "w_gate", "Q4_K"), ("ffn_up", "w_up", "Q8_0"),
                ("ffn_down", "w_down", "Q6_K")):
            put(f"blk.{i}.{name}.weight", lp[key][i].T, kind)
        put(f"blk.{i}.attn_norm.weight", lp["attn_norm"][i], "F32")
        put(f"blk.{i}.ffn_norm.weight", lp["mlp_norm"][i], "F32")
    tokens, scores = spm_vocab(cfg.vocab_size)
    write_gguf(path, {
        "general.architecture": (8, "llama"),
        "general.name": (8, "tiny-llama-gguf"),
        "llama.embedding_length": (4, cfg.hidden_size),
        "llama.block_count": (4, cfg.num_layers),
        "llama.feed_forward_length": (4, cfg.intermediate_size),
        "llama.attention.head_count": (4, cfg.num_heads),
        "llama.attention.head_count_kv": (4, cfg.num_kv_heads),
        "llama.attention.layer_norm_rms_epsilon": (6, cfg.rms_norm_eps),
        "llama.rope.freq_base": (6, cfg.rope_theta),
        "llama.context_length": (4, cfg.max_model_len),
        "tokenizer.ggml.model": (8, "llama"),
        "tokenizer.ggml.tokens": (9, (8, tokens)),
        "tokenizer.ggml.scores": (9, (6, scores)),
        "tokenizer.ggml.bos_token_id": (4, 1),
        "tokenizer.ggml.eos_token_id": (4, 2),
    }, tensors)
    return kinds


SPM_CHARS = ["\u2581"] + list("abcdefghijklmnopqrstuvwxyz") + ["\u00e9",
                                                              "\u4e2d"]


def spm_vocab(n: int, seed: int = 15) -> tuple:
    """(tokens, scores) of 15a's GGUF SentencePiece vocab, n entries:
    <unk> <s> </s>, the 256 <0xXX> byte tokens, the space marker, a-z, e
    acute and one CJK character, then pieces merged from two earlier ones
    drawn from a seeded generator, scores integers in [-8, 8] (ties)."""
    import random
    rng = random.Random(seed)
    tokens = (["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
              + SPM_CHARS)
    pieces, seen = list(SPM_CHARS), set(tokens)
    while len(tokens) < n:
        merged = rng.choice(pieces) + rng.choice(pieces)
        if len(merged) <= 8 and merged not in seen:
            seen.add(merged)
            pieces.append(merged)
            tokens.append(merged)
    scores = [0.0] * 259 + [float(rng.randint(-8, 8))
                            for _ in range(n - 259)]
    return tokens[:n], scores[:n]


def spm_fuzz(n: int, pieces: list, seed: int = 1515) -> list:
    """n seeded strings of 0-40 parts: the vocab's merged pieces (the space
    marker as a space), its characters, spaces and characters it lacks
    (upper case, punctuation, a newline, an emoji: byte fallback)."""
    import random
    rng = random.Random(seed)
    alphabet = ([p.replace("\u2581", " ") for p in pieces]
                + list("abcdefghijklmnopqrstuvwxyz") + [" "] * 8
                + ["\u00e9", "\u4e2d", "Z", "Q", "!", ",", "\n",
                   "\U0001f600", "\u00fc"])
    return ["".join(rng.choice(alphabet) for _ in range(rng.randint(0, 40)))
            for _ in range(n)]


def native_spm_gate(path: str) -> dict:
    """15a's native SentencePiece gate on the GGUF checkpoint's card: its
    preprocessor's tokenizer encodes through the native library (built
    with g++, 0 build failures); the card's chats (15b's, through the
    template) tokenize to the same ids through the Python encoder, and so
    do 2000 seeded strings; encode microseconds per 1k tokens, native and
    Python, on this host."""
    from dynamo_tpu_torch import native
    from dynamo_tpu_torch.llm.gguf import _spm_encode
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.protocols.openai import ChatCompletionRequest
    name = "checkpoints (15a native SentencePiece)"
    card = ModelDeploymentCard.from_gguf(path)
    pre = OpenAIPreprocessor(card)
    tok = pre.tokenizer
    check(tok._native is not None and native.NATIVE_STATS.build_failures == 0
          and native.library_path("spm_bpe").exists(),
          f"{name}: native encoder {tok._native}, build failures "
          f"{native.NATIVE_STATS.build_failures} "
          f"({native.NATIVE_STATS.last_error})")

    def python(text):
        return _spm_encode(text, tok._ids, tok._scores, tok._byte_ids,
                           tok.unk_token_id, tok.SPACE, tok._add_prefix)
    chats = [ChatCompletionRequest.from_json(b)
             for b in checkpoint_chats(card.name)]
    native_ids = [pre.preprocess_chat(c)[0].token_ids for c in chats]
    enc, tok._native = tok._native, None
    try:
        python_ids = [pre.preprocess_chat(c)[0].token_ids for c in chats]
    finally:
        tok._native = enc
    check(native_ids == python_ids, f"{name}: the card's chats tokenize "
          "differently through the native and the Python encoder")
    texts = spm_fuzz(2000, tok.tokens[259 + len(SPM_CHARS):])
    bad = [t for t in texts if tok.encode(t) != python(t)]
    check(not bad, f"{name}: {len(bad)} of {len(texts)} fuzz strings "
          f"differ, first {bad[0]!r}" if bad else "")
    ids = [tok.encode(t) for t in texts]
    n_tok = sum(map(len, ids))
    # ids of pieces merged from two or more characters
    merged = sum(i >= 259 + len(SPM_CHARS) for x in ids for i in x)
    times = {}
    for label, fn in (("native", tok.encode), ("python", python)):
        t0 = time.perf_counter()
        for t in texts:
            fn(t)
        times[label] = (time.perf_counter() - t0) * 1e6 / (n_tok / 1e3)
    out = {"chats": len(chats), "chat_tokens": sum(map(len, native_ids)),
           "fuzz": len(texts), "fuzz_tokens": n_tok,
           "us_per_1k_tokens": times}
    print(f"{name} [this host's CPU]: the GGUF card's tokenizer encodes "
          f"through the native library (0 build failures); {len(chats)} "
          f"chats ({out['chat_tokens']} tokens) and {len(texts)} fuzz "
          f"strings ({n_tok} tokens, {merged} of them merged pieces) "
          f"id-equal to the Python encoder; encode "
          f"{times['native']:.1f} us per 1k tokens native, "
          f"{times['python']:.1f} Python", flush=True)
    return out


# 15a's families: each one's departures from SMALL_BASE
SMALL_KNOBS = {
    "llama": {}, "llama_tied": dict(tie_word_embeddings=True),
    "qwen2": dict(attn_bias=True),
    # Phi-3-mini's head dim (96; its hidden size is heads x 96) and
    # Gemma-7B's (256), which the ragged kernel takes since PR 15
    "phi3": dict(hidden_size=384, num_heads=4, num_kv_heads=4, head_dim=96),
    "gemma": dict(embed_scale=16.0, norm_plus_one=True, mlp_act="gelu_tanh",
                  tie_word_embeddings=True, rms_norm_eps=1e-6, head_dim=256),
    "mixtral": dict(num_experts=4, num_experts_per_tok=2,
                    intermediate_size=256),
    "gguf": {}}
SMALL_BASE = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
                  num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64,
                  rope_theta=10000.0, max_model_len=2048, dtype="float32")


def small_family_config(family: str):
    """15a's tiny configs: hd 64 (Phi-3 at 96, Gemma at 256), widths whose
    rows the K-quant blocks (256) and the kernels take."""
    from dynamo_tpu_torch.engine.config import ModelConfig
    return ModelConfig(name=family, **{**SMALL_BASE,
                                       **SMALL_KNOBS.get(family, {})})


def seeded_tree(cfg, seed: int):
    """init_params on the CPU (f32), its norms and biases redrawn from the
    seed so that every architecture branch changes the output."""
    import torch
    from dynamo_tpu_torch.models import llama
    params = llama.init_params(cfg, "cpu", seed=seed)
    gen = torch.Generator().manual_seed(seed + 1)
    shift = 1.0 if cfg.norm_plus_one else 0.0
    for key, leaf in params["layers"].items():
        if key.endswith("norm"):
            leaf.copy_(torch.rand(leaf.shape, generator=gen) + 0.5 - shift)
        elif key.endswith("_b"):
            leaf.copy_(torch.randn(leaf.shape, generator=gen) * 0.5)
    params["final_norm"].copy_(
        torch.rand(params["final_norm"].shape, generator=gen) + 0.5 - shift)
    return params


def same_trees(trees: dict) -> bool:
    """Every device's tree equal to the first's."""
    first, *rest = trees.values()
    return all(trees_equal(first, t) for t in rest)


def trees_equal(a, b) -> bool:
    """Equal keys, dtypes, shapes and bits (compared on a's device)."""
    import torch
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(trees_equal(a[k], b[k])
                                            for k in a)
    return a.dtype == b.dtype and torch.equal(a, b.to(a.device))


def phase_checkpoints_small(root: str, devices=("cpu", "cuda")) -> dict:
    """15a (see the docstring at the top): tiny checkpoints of every
    family and one mixed GGUF, written from seeded weights, loaded on each
    device and held to phase 3's rule; llama and qwen2 also with int8
    weights; gemma's engine runs one window as graph and as eager. Returns
    the kernel launches of the card's runs, by label."""
    import torch
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import NativeEngine
    from dynamo_tpu_torch.llm.gguf import (
        GGUFFile, config_from_gguf, load_params_from_gguf,
    )
    from dynamo_tpu_torch.models.loader import load_model_dir
    launches = {}
    for family in SMALL_KNOBS:
        cfg = small_family_config(family)
        params = seeded_tree(cfg, seed=15)
        path = os.path.join(root, family + (".gguf" if family == "gguf"
                                            else ""))
        if family == "gguf":
            kinds = write_llama_gguf(path, cfg, params)
            g = GGUFFile(path)
            cfg = dataclasses.replace(config_from_gguf(g), dtype="float32")
            trees = {dev: load_params_from_gguf(g, cfg, device=dev)
                     for dev in devices}
            g.close()
            check(same_trees(trees), "gguf: the trees loaded on "
                  f"{devices} differ")
            label = f"gguf ({json.dumps(kinds)})"
            native_spm_gate(path)
        else:
            write_hf_dir(path, cfg, params, family.split("_")[0], 1, 2)
            trees = {}
            for dev in devices:
                # the f32 override: a checkpoint loads in bf16 by default
                got, trees[dev] = load_model_dir(path, dtype=cfg.dtype,
                                                 device=dev)
                check(dataclasses.replace(got, name=cfg.name) == cfg,
                      f"{family}: config_from_hf gave {got}, written {cfg}")
                check(trees_equal(trees[dev], params),
                      f"{family}: leaves loaded on {dev} differ from the "
                      "written ones")
            label = f"{family} checkpoint"
        launches[label] = device_reference(cfg, trees, label)
        if family in ("llama", "qwen2"):
            qcfg = dataclasses.replace(cfg, quant="int8")
            qtrees = {dev: load_model_dir(path, dtype=cfg.dtype, device=dev,
                                          quant="int8")[1]
                      for dev in devices}
            check(same_trees(qtrees), f"{family}: int8 trees "
                  "differ across devices")
            launches[label + " int8"] = device_reference(
                qcfg, qtrees, label + " quant=int8")
        if family == "gemma" and "cuda" in devices:
            _, bf16 = load_model_dir(path, dtype="bfloat16", device="cuda")
            engine = NativeEngine(dataclasses.replace(cfg, dtype="bfloat16"),
                                  EngineConfig(), params=bf16,
                                  eos_token_ids={2}, device="cuda")
            phase_graph_vs_eager(engine, "gemma checkpoint", model=path)
            del engine, bf16
        del trees
        if "cuda" in devices:
            torch.cuda.empty_cache()
    return launches


def rss_anon() -> tuple:
    """(the process's anonymous resident bytes, where they were read): the
    RssAnon line of /proc/self/status, or where a kernel's status has
    none (a sandboxed one), resident less shared pages of
    /proc/self/statm (the shared count holds the file-backed pages, the
    mapped checkpoint among them)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("RssAnon:"):
                return int(line.split()[1]) * 1024, "RssAnon"
    with open("/proc/self/statm") as f:
        _, resident, shared = (int(x) for x in f.read().split()[:3])
    return ((resident - shared) * os.sysconf("SC_PAGE_SIZE"),
            "statm resident - shared")


class RssSampler:
    """The largest growth of the anonymous resident memory (`rss_anon`)
    over a block, sampled every 20 ms by a thread (the loader copies one
    tensor at a time)."""

    def __enter__(self):
        import threading
        self.base, self.source = rss_anon()
        self.peak = self.base
        self._stop = threading.Event()

        def run():
            while not self._stop.wait(0.02):
                self.peak = max(self.peak, rss_anon()[0])
        self._t = threading.Thread(target=run, daemon=True)
        self._t.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._t.join()
        self.peak = max(self.peak, rss_anon()[0])

    @property
    def growth(self) -> int:
        return self.peak - self.base


CKPT_TOKENS = 32
CKPT_TOP = 8


def checkpoint_chats(model: str) -> list:
    """15b's 8 chats: a system prompt and a user turn of natural-looking
    text, greedy, CKPT_TOKENS tokens, top logprobs; 4 streamed, 4 unary."""
    words = ("the quick brown fox jumps over lazy dog serving checkpoint "
             "tokens stream card kernel weights chat 2026 café 東京 😀 "
             "it's we'll they're 12345").split()
    import numpy as np
    out = []
    for i in range(8):
        rng = np.random.default_rng(150 + i)
        user = " ".join(rng.choice(words, 20 + 25 * i))
        body = {"model": model, "max_tokens": CKPT_TOKENS, "temperature": 0.0,
                "logprobs": True, "top_logprobs": CKPT_TOP, "messages": [
                    {"role": "system", "content": "You answer briefly."},
                    {"role": "user", "content": user}]}
        if i % 2 == 0:
            body.update(stream=True, stream_options={"include_usage": True})
        out.append(body)
    return out


def _entries_of(content: list) -> list:
    """(token, logprob, top values best first) of a logprobs content list
    (Stream.entries' form)."""
    return [(e["token"], e["logprob"], sorted(
        (t["logprob"] for t in e["top_logprobs"]), reverse=True))
        for e in content]


async def reference_chats(card, engine, bodies: list) -> list:
    """Each body through LocalPipeline on `engine` one at a time: [(logprob
    entries, text, token ids)]."""
    from dynamo_tpu_torch.llm.pipeline import LocalPipeline
    from dynamo_tpu_torch.llm.worker import NativeEngineWorker
    from dynamo_tpu_torch.protocols.delta import aggregate_chat_chunks
    from dynamo_tpu_torch.protocols.openai import ChatCompletionRequest
    from dynamo_tpu_torch.runtime.engine import Context
    worker = await NativeEngineWorker(engine).start()
    timed = TimedEngine(worker)
    pipe = LocalPipeline(card, timed)
    out = []
    try:
        for i, body in enumerate(bodies):
            req = ChatCompletionRequest.from_json(
                {k: v for k, v in body.items()
                 if k not in ("stream", "stream_options")})
            chunks = [c async for c in pipe.generate_chat(
                req, Context(f"ref-{i}"))]
            agg = aggregate_chat_chunks(chunks)
            rid = next(r for r in timed.stamps
                       if r == f"ref-{i}" or r.startswith(f"ref-{i}#"))
            out.append((_entries_of(agg.choices[0].logprobs["content"]),
                        agg.choices[0].message.content,
                        list(timed.stamps[rid]["ids"])))
    finally:
        await worker.stop()
    return out


async def served_chats(port: int, bodies: list) -> list:
    """The bodies over HTTP one at a time: [(logprob entries, text)]."""
    out = []
    for i, body in enumerate(bodies):
        if body.get("stream"):
            st = await _stream_into(port, body, Stream(f"ckpt-{i}"))
            check(st.done and not st.errors and len(st.finish) == 1,
                  f"checkpoints: stream {i} ended {st.finish} "
                  f"{st.errors} done={st.done}")
            out.append((st.entries, st.text))
        else:
            status, _, raw = await _http(port, "POST", "/v1/chat/completions",
                                         body)
            check(status == 200, f"checkpoints: request {i}: {status} "
                  f"{raw[:200]}")
            res = json.loads(raw)
            ch = res["choices"][0]
            check(ch["finish_reason"] in ("stop", "length"),
                  f"checkpoints: request {i} finished {ch['finish_reason']}")
            out.append((_entries_of(ch["logprobs"]["content"]),
                        ch["message"]["content"]))
    return out


def hold_to_reference(name: str, served: list, ref: list, tokenizer) -> list:
    """Each served stream against the reference's: equal entries, or a
    first difference at a near tie (phase 11k's rule), and the text equal
    to DecodeStream over the reference's ids (up to the difference).
    Returns the first differences (None where identical)."""
    from dynamo_tpu_torch.llm.tokenizer import DecodeStream
    firsts = []
    for i, ((a, text), (b, _, ids)) in enumerate(zip(served, ref)):
        check(len(b) == len(ids), f"{name}: reference {i} has {len(b)} "
              f"entries for {len(ids)} ids")
        d = first_difference_of(a, b)
        ds = DecodeStream(tokenizer)
        upto = len(ids) if d is None else d
        want = "".join(ds.step(t) for t in ids[:upto])
        if d is None:
            check(text == want, f"{name}: chat {i}'s text {text!r} != "
                  f"DecodeStream over the reference's ids {want!r}")
            firsts.append(None)
            continue
        case = "token" if a[d][0] != b[d][0] else "context"
        at = d if case == "token" else d - 1
        check(at >= 0, f"{name}: chat {i} differs in its first token's "
              "values")
        tie = max(x[2][0] - x[2][1] for x in (a[at], b[at]))
        check(tie <= NEAR_TIE and text.startswith(want),
              f"{name}: chat {i} leaves the reference at {d} ({case}), "
              f"top-1 less top-2 {tie:.4f} (near tie <= {NEAR_TIE})")
        firsts.append([d, case, round(tie, 5)])
        print(f"{name}: chat {i} first differs from the reference at "
              f"token {d} ({case}), a near tie ({tie:.5f})", flush=True)
    return firsts


def serve_checkpoint(path: str, bodies: list, extra=(), name="",
                     rounds: int = 1) -> dict:
    """`python -m dynamo_tpu_torch.run in=http:0 out=native <path>` as a
    process: READY seconds, the bodies' results (served one at a time,
    `rounds` times), its EXIT stats line.
    "results" are the last round's, "rounds" each round's results, its
    start (time.time()), seconds and the /metrics text after it."""
    import signal
    t0 = time.perf_counter()
    proc = Child(name, ["dynamo_tpu_torch.run", "in=http:0", "out=native",
                        path, *extra])
    per_round = []
    try:
        line = proc.wait_line("READY http=:", 600)
        ready_s = time.perf_counter() - t0
        port = int(re.match(r"READY http=:(\d+)", line).group(1))
        for _ in range(rounds):
            start, t1 = time.time(), time.perf_counter()
            results = asyncio.run(asyncio.wait_for(
                served_chats(port, bodies), 600))
            took = time.perf_counter() - t1
            metrics = asyncio.run(_http(port, "GET", "/metrics"))[2].decode()
            per_round.append({"start": start, "results": results,
                              "seconds": took, "metrics": metrics})
        code = proc.stop(signal.SIGINT, 120)
        exits = [x for x in proc.lines if x.startswith("EXIT ")]
        check(code == 0 and len(exits) == 1, f"{name}: exit {code}, "
              f"{exits or proc.tail()}")
    finally:
        proc.stop(signal.SIGKILL, 30)
    m = re.match(r"EXIT logits_nonfinite_steps=(\d+) stats=(.*)$", exits[0])
    check(m is not None and m.group(1) == "0", f"{name}: {exits[0][:300]}")
    # the load inside READY, as run.py logs it
    loads = [float(x.group(1)) for x in (
        re.search(r"loaded .* in ([0-9.]+) s$", ln) for ln in proc.lines)
        if x]
    # a registry model's weights are drawn, not loaded
    check(len(loads) == int(os.path.exists(path)),
          f"{name}: run.py logged {len(loads)} loads")
    return {"ready_s": ready_s, "load_s": loads[0] if loads else None,
            "results": per_round[-1]["results"],
            "metrics": per_round[-1]["metrics"], "rounds": per_round,
            "stats": json.loads(m.group(2))}


def synchronize(device: str) -> None:
    import torch
    if device == "cuda":
        torch.cuda.synchronize()


def empty_cache(device: str) -> None:
    import torch
    if device == "cuda":
        torch.cuda.empty_cache()


def served_config(card):
    """The EngineConfig run.py builds for `card` with its default flags."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    return EngineConfig(page_size=card.kv_page_size, max_model_len=min(
        card.context_length, card.model_config().max_model_len))


# the layers of llama3-8b that 15b writes, loads and serves (its widths and
# vocabulary unchanged): a depth cut that keeps the script inside its time
# limit
CKPT_LAYERS = 16


def phase_checkpoint_8b(root: str, smi: str, cfg=None,
                        device: str = "cuda", draft: str = "llama3-1b") -> dict:
    """15b (see the docstring at the top): llama3-8b at full width and
    CKPT_LAYERS of its depth written to disk, loaded, and served by run.py
    as a process, and
    17c on the same directory (`draft` proposing). `cfg` and device "cpu"
    rehearse it on the CPU (a narrow model with llama3-8b's vocabulary;
    the draft there the directory itself); the card-only checks (kernel
    launches, device memory) are skipped there."""
    import shutil
    import torch
    from dynamo_tpu_torch.engine.config import get_model_config
    from dynamo_tpu_torch.engine.engine import NativeEngine
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.models.loader import load_model_dir
    on_card = device == "cuda"
    cfg = cfg or dataclasses.replace(get_model_config("llama3-8b"),
                                     num_layers=CKPT_LAYERS)
    name = f"checkpoints, {cfg.name}"
    extra = () if on_card else ("--device", "cpu")
    need = 17 * 10 ** 9 if on_card else 10 ** 9
    os.makedirs(root, exist_ok=True)
    free = shutil.disk_usage(root).free
    check(free >= need, f"{name}: {free} bytes free under {root}; the "
          f"bf16 checkpoint needs {need} (up to 16.06 GB and its "
          "tokenizer)")
    path = os.path.join(root, "llama3-8b")
    rec = {}
    try:
        params = llama.init_params(cfg, device, seed=0)
        t0 = time.perf_counter()
        nbytes = write_hf_dir(path, cfg, params, "llama", 128000, 128009,
                              shards=4)
        with open(os.path.join(path, "tokenizer.json"), "w") as f:
            json.dump(llama3_tokenizer_json(), f)
        with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
            json.dump({"chat_template": LLAMA3_TEMPLATE,
                       "bos_token": "<|begin_of_text|>",
                       "eos_token": "<|eot_id|>"}, f)
        rec["write_s"] = time.perf_counter() - t0
        rec["bytes"] = nbytes
        print(f"{name}: wrote {nbytes} bytes (4 bf16 shards, "
              f"tokenizer.json, chat template) in {rec['write_s']:.1f} s",
              flush=True)

        card = ModelDeploymentCard.from_hf_dir(path)
        tok = card.load_tokenizer()
        bodies = checkpoint_chats(card.name)
        # the reference: this card, an engine on the in-memory weights
        engine = NativeEngine(card.model_config(), served_config(card),
                              params=params,
                              eos_token_ids=set(card.eos_token_ids),
                              device=device)
        check(engine.model_cfg.dtype == "bfloat16",
              f"{name}: the card's dtype {engine.model_cfg.dtype}")
        ref = asyncio.run(reference_chats(card, engine, bodies))
        engine.cache = None
        del engine
        empty_cache(device)
        # the tokenizer on the request path: encode ms per 1k prompt tokens
        from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
        from dynamo_tpu_torch.protocols.openai import ChatCompletionRequest
        pre = OpenAIPreprocessor(card, tok)
        prompts = [pre._render_chat(ChatCompletionRequest.from_json(b))[0]
                   for b in bodies]
        t0 = time.perf_counter()
        n_tok = sum(len(tok.encode(p)) for p in prompts)
        rec["encode_ms_per_1k"] = ((time.perf_counter() - t0) * 1e3
                                   / n_tok * 1000)

        # the loader on the card: bit-equal leaves, RssAnon growth
        synchronize(device)
        with RssSampler() as rss:
            t0 = time.perf_counter()
            lcfg, loaded = load_model_dir(path, device=device)
            synchronize(device)
            rec["load_s"] = time.perf_counter() - t0
        rec["rss_anon_growth"] = rss.growth
        rec["rss_source"] = rss.source
        rec["load_gb_s"] = nbytes / rec["load_s"] / 1e9
        check(dataclasses.replace(lcfg, name=cfg.name) == cfg,
              f"{name}: config_from_hf gave {lcfg}")
        check(trees_equal(loaded, params), f"{name}: loaded leaves differ "
              "from the written ones")
        check(rss.growth < 4 * 2 ** 30, f"{name}: anonymous memory "
              f"({rss.source}) grew by {rss.growth} bytes while loading "
              f"(limit 4 GiB)")
        print(f"{name}: load_model_dir on {device} in {rec['load_s']:.2f} s "
              f"({rec['load_gb_s']:.2f} GB/s, the page cache warm from the "
              f"write), every leaf bit-equal to the written tree, "
              f"anonymous memory growth {rss.growth / 2 ** 20:.1f} MiB "
              f"({rss.source}) [{smi}]", flush=True)
        del loaded, params
        empty_cache(device)

        # run.py as a process on the directory
        served = serve_checkpoint(path, bodies, extra,
                                  name=f"{name} (run.py)")
        rec["ready_s"] = served["ready_s"]
        rec["ready_load_s"] = served["load_s"]
        rec["first_differences"] = hold_to_reference(
            name, served["results"], ref, tok)
        st = served["stats"]
        k = st["kernel_launches"][RAGGED]
        warm = st["graph_warmup_launches"].get(RAGGED, 0)
        check(not on_card
              or k == cfg.num_layers * st["decode_window_steps"] + warm > 0,
              f"{name}: run.py launched the ragged kernel {k} times over "
              f"{st['decode_window_steps']} decode steps x "
              f"{cfg.num_layers} layers + {warm} in warm-ups")
        rec["launches"] = st["kernel_launches"]
        rec.update(_ttft_quantiles(served["metrics"]))
        print(f"{name}: run.py READY in {rec['ready_s']:.1f} s, of which "
              f"its load {rec['ready_load_s']:.2f} s (run.py's log); 8 "
              f"chats (4 "
              f"SSE, 4 unary) one at a time, every one finished, "
              f"{sum(d is None for d in rec['first_differences'])} of 8 "
              f"token-identical to the in-memory engine; TTFT p50 "
              f"{rec['ttft_p50_ms']:.1f} ms (llm_ttft_seconds); encode "
              f"{rec['encode_ms_per_1k']:.2f} ms per 1k prompt tokens "
              f"(Python BPE on the host); ragged launches {k} [{smi}]",
              flush=True)
        rec["spec_entry"] = phase_spec_entry(
            smi, path, bodies, ref, tok, served["rounds"][-1]["seconds"],
            draft if on_card else path, extra)

        # int8: quantized as it loads, below the bf16 tree's peak
        synchronize(device)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        _, q8 = load_model_dir(path, device=device, quant="int8")
        synchronize(device)
        rec["int8_load_s"] = time.perf_counter() - t0
        rec["int8_load_peak_bytes"] = (
            torch.cuda.max_memory_allocated() - base if on_card else 0)
        check(rec["int8_load_peak_bytes"] < nbytes, f"{name}: int8 load "
              f"peaked at {rec['int8_load_peak_bytes']} bytes, the bf16 "
              f"tree {nbytes}")
        want = llama.init_params(dataclasses.replace(cfg, quant="int8"),
                                 device, seed=0)
        check(trees_equal(q8, want), f"{name}: the int8 load differs from "
              "init_params(quant='int8')")
        del q8
        empty_cache(device)
        qcard = ModelDeploymentCard.from_hf_dir(path)
        engine = NativeEngine(
            dataclasses.replace(qcard.model_config(), quant="int8"),
            served_config(qcard), params=want,
            eos_token_ids=set(qcard.eos_token_ids), device=device)
        qref = asyncio.run(reference_chats(qcard, engine, bodies[:1]))
        engine.cache = None
        del engine, want
        empty_cache(device)
        qserved = serve_checkpoint(path, bodies[:1],
                                   ("--quant", "int8") + extra,
                                   name=f"{name} int8 (run.py)")
        rec["int8_first_difference"] = hold_to_reference(
            name + " int8", qserved["results"], qref, tok)[0]
        rec["int8_ready_s"] = qserved["ready_s"]
        rec["int8_launches"] = qserved["stats"]["kernel_launches"]
        check(not on_card or (rec["int8_launches"][W8A16] > 0
                              and rec["int8_launches"][DEQUANT] == 0),
              f"{name} int8: run.py launched {rec['int8_launches']}")
        same = rec["int8_first_difference"] is None
        print(f"{name} int8: load_model_dir(quant='int8') in "
              f"{rec['int8_load_s']:.2f} s, peak "
              f"{rec['int8_load_peak_bytes'] / 1e9:.2f} GB on the card "
              f"(bf16 tree {nbytes / 1e9:.2f} GB), byte-equal to "
              f"init_params(quant="
              f"'int8'); run.py --quant int8 READY in "
              f"{rec['int8_ready_s']:.1f} s, one chat "
              f"{'token-identical' if same else 'within a near tie'} "
              f"[{smi}]", flush=True)
    finally:
        shutil.rmtree(path, ignore_errors=True)
    return rec


def phase_checkpoints(smi: str) -> dict:
    """Phase 15: 15a then 15b, under build/checkpoints (removed)."""
    import shutil
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "checkpoints")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    t0 = time.perf_counter()
    try:
        small = phase_checkpoints_small(root)
        big = phase_checkpoint_8b(root, smi)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    big["phase_s"] = time.perf_counter() - t0
    return {"small_launches": small, **big}


# -- phase 16: the gather decode windows and Gemma-2 (A5) -----------------------

# the layers of gemma-2-9b that 16a writes, loads and serves (its widths
# unchanged): a depth cut that keeps the script inside its time limit
GEMMA_LAYERS = 4

# google/gemma-2-9b's published config.json (its architecture, widths,
# vocabulary, soft-caps, query scale and sliding window), named here and not
# fetched; the weights are random
GEMMA2_9B_HF = {
    "architectures": ["Gemma2ForCausalLM"], "model_type": "gemma2",
    "vocab_size": 256000, "hidden_size": 3584, "intermediate_size": 14336,
    "num_hidden_layers": 42, "num_attention_heads": 16,
    "num_key_value_heads": 8, "head_dim": 256,
    "hidden_activation": "gelu_pytorch_tanh", "rms_norm_eps": 1e-06,
    "rope_theta": 10000.0, "max_position_embeddings": 8192,
    "sliding_window": 4096, "attn_logit_softcapping": 50.0,
    "final_logit_softcapping": 30.0, "query_pre_attn_scalar": 256,
    "tie_word_embeddings": True, "attention_bias": False,
    "bos_token_id": 2, "eos_token_id": 1, "pad_token_id": 0,
    "torch_dtype": "float32"}
# Gemma's chat template (its tokenizer_config.json)
GEMMA_TEMPLATE = (
    "{{ bos_token }}{% if messages[0]['role'] == 'system' %}"
    "{{ raise_exception('System role not supported') }}{% endif %}"
    "{% for message in messages %}"
    "{% if (message['role'] == 'user') != (loop.index0 % 2 == 0) %}"
    "{{ raise_exception('Conversation roles must alternate "
    "user/assistant/user/assistant/...') }}{% endif %}"
    "{% if (message['role'] == 'assistant') %}{% set role = 'model' %}"
    "{% else %}{% set role = message['role'] %}{% endif %}"
    "{{ '<start_of_turn>' + role + '\n' + message['content'] | trim + "
    "'<end_of_turn>\n' }}{% endfor %}{% if add_generation_prompt %}"
    "{{'<start_of_turn>model\n'}}{% endif %}")
GEMMA_SPECIALS = {0: "<pad>", 1: "<eos>", 2: "<bos>", 3: "<unk>",
                  4: "<mask>", 106: "<start_of_turn>", 107: "<end_of_turn>"}
LONG_WORDS = ("the quick brown fox jumps over lazy dog while the server "
              "streams tokens from a long document about kernels, pages, "
              "windows and caches; every chat reads thousands of words "
              "before it answers").split()


def train_spm_merges(corpus: str, n: int) -> list:
    """The first n merges of a SentencePiece-style BPE (spaces as "▁",
    each piece a word with its leading "▁"), learned deterministically:
    the most frequent adjacent pair, ties to the smallest."""
    import collections
    words = collections.Counter(
        tuple(w) for w in re.findall("▁?[^▁]+|▁", corpus.replace(" ", "▁")))
    merges = []
    for _ in range(n):
        pairs = collections.Counter()
        for w, c in words.items():
            for pair in zip(w, w[1:]):
                pairs[pair] += c
        if not pairs:
            break
        best = min(pairs.items(), key=lambda kv: (-kv[1], kv[0]))[0]
        merges.append(best)
        joined = collections.Counter()
        for w, c in words.items():
            out, i = [], 0
            while i < len(w):
                if w[i:i + 2] == best:
                    out.append(w[i] + w[i + 1])
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            joined[tuple(out)] += c
        words = joined
    return merges


def gemma_tokenizer_json(vocab_size: int = 256000, n_merges: int = 400
                         ) -> dict:
    """A tokenizer.json of the Gemma form: BPE with byte fallback over text
    whose spaces a Replace normalizer turns into "▁" (no pre-tokenizer),
    the decoder Replace + ByteFallback + Fuse; Gemma's specials at their
    ids, <0x00>-<0xFF> at 217-472, the corpus's characters and learned
    merges, and inert filler pieces up to `vocab_size` ids."""
    corpus = " ".join(LONG_WORDS) + " " + TOKENIZER_CORPUS
    vocab = {name: i for i, name in GEMMA_SPECIALS.items()}
    for i in range(5, 217):
        vocab.setdefault(f"<unused{i}>", i)
    for b in range(256):
        vocab[f"<0x{b:02X}>"] = 217 + b
    merges = train_spm_merges(corpus * 3, n_merges)
    for ch in sorted(set(corpus.replace(" ", "▁"))):
        vocab.setdefault(ch, len(vocab))
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    filler = [chr(0x3400 + k) for k in range(640)]
    for a in filler:
        for b in filler:
            if len(vocab) >= vocab_size:
                break
            vocab.setdefault("▁" + a + b, len(vocab))
    added = [{"id": i, "content": name, "single_word": False,
              "lstrip": False, "rstrip": False, "normalized": False,
              "special": True} for i, name in sorted(GEMMA_SPECIALS.items())]
    return {"version": "1.0", "truncation": None, "padding": None,
            "added_tokens": added,
            "normalizer": {"type": "Replace", "pattern": {"String": " "},
                           "content": "▁"},
            "pre_tokenizer": None, "post_processor": None,
            "decoder": {"type": "Sequence", "decoders": [
                {"type": "Replace", "pattern": {"String": "▁"},
                 "content": " "},
                {"type": "ByteFallback"}, {"type": "Fuse"}]},
            "model": {"type": "BPE", "dropout": None, "unk_token": "<unk>",
                      "continuing_subword_prefix": None,
                      "end_of_word_suffix": None, "fuse_unk": True,
                      "byte_fallback": True, "ignore_merges": False,
                      "vocab": vocab, "merges": [list(m) for m in merges]}}


def long_chats(card, tok, lo: int = 4600, hi: int = 7400,
               max_tokens: int = 64) -> list:
    """16a's 8 chats: one user turn each whose rendered prompt is lo..hi
    tokens (evenly spaced), greedy, max_tokens, top-8 logprobs; even ones
    streamed, odd ones unary."""
    import numpy as np
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.protocols.openai import ChatCompletionRequest
    pre = OpenAIPreprocessor(card, tok)
    out = []
    for i in range(8):
        target = lo + (hi - lo) * i // 7
        rng = np.random.default_rng(160 + i)
        words = list(rng.choice(LONG_WORDS, target))
        body = {}
        for _ in range(6):
            body = {"model": card.name, "max_tokens": max_tokens,
                    "temperature": 0.0, "logprobs": True,
                    "top_logprobs": CKPT_TOP, "messages": [
                        {"role": "user", "content": " ".join(words)}]}
            n = len(tok.encode(pre._render_chat(
                ChatCompletionRequest.from_json(body))[0]))
            if abs(n - target) <= target // 50:
                break
            keep = max(1, int(len(words) * target / n))
            words = (words * 2)[:keep]
        body["n_prompt"] = n
        if i % 2 == 0:
            body.update(stream=True, stream_options={"include_usage": True})
        out.append(body)
    return out


def steady_ms_per_step(engine, prompts: list, warm: int = 2,
                       timed: int = 4) -> float:
    """Untraced ms per decode step: the prompts (token ids) admitted
    greedy with ignore_eos and room for the windows, stepped until every
    one decodes, `warm` steps (captures), then `timed` pipelined steps
    ending in a synchronize, over the decode steps they ran. The requests
    are aborted after."""
    from dynamo_tpu_torch.engine.scheduler import EngineRequest, SamplingParams
    n = (warm + timed + 2) * engine.cfg.decode_steps
    for i, p in enumerate(prompts):
        engine.add_request(EngineRequest(f"steady-{i}", list(p), SamplingParams(
            max_tokens=n, temperature=0.0, ignore_eos=True)))
    while engine.scheduler.waiting or engine._pipeline is not None:
        engine.step()
    for _ in range(warm):
        engine.step()
    engine._sync_stream()
    steps0 = engine.decode_window_steps
    t0 = time.perf_counter()
    for _ in range(timed):
        engine.step()
    engine._sync_stream()
    ms = (time.perf_counter() - t0) * 1e3 / max(
        1, engine.decode_window_steps - steps0)
    for i in range(len(prompts)):
        engine.abort(f"steady-{i}")
    while engine.has_work():
        engine.step()
    engine._sync_stream()
    return ms


def sensitivity(engine, prompt: list, tol: float) -> dict:
    """The gather path's knobs on the decode step one past the window: the
    prompt (longer than the window) prefilled on a cache of its own, then
    the next token's decode_forward logits with the served config, with
    its windows removed and with its attention soft-cap removed. Each
    variant must differ from the served logits by more than `tol`."""
    import torch
    from dynamo_tpu_torch.models import llama
    cfg, ps = engine.model_cfg, engine.cfg.page_size
    n = len(prompt) - 1
    check(n > (cfg.sliding_window or 0), f"sensitivity: a {n}-token prefix "
          f"does not pass the {cfg.sliding_window}-token window")
    pages = -(-len(prompt) // ps)
    dev = engine.device
    cache = llama.init_cache(cfg, pages + 1, ps, dev)
    pt = torch.arange(pages, dtype=torch.int32, device=dev)[None]
    ids = torch.tensor(prompt, dtype=torch.int32, device=dev)
    for c0 in range(0, n, 512):
        c1 = min(n, c0 + 512)
        pos = torch.arange(c0, c1, dtype=torch.int32, device=dev)[None]
        meta = llama.AttnMetadata(pos, pt, torch.tensor([c1], dtype=torch.int32,
                                                        device=dev), pos)
        llama.forward(engine.params, cfg, ids[None, c0:c1], cache, meta,
                      last_idx=torch.tensor([c1 - c0 - 1], device=dev),
                      path="gather")
    tok = ids[n:n + 1]
    pre = torch.tensor([n], dtype=torch.int32, device=dev)
    out = {}
    for label, c in (("served", cfg),
                     ("no windows", dataclasses.replace(cfg, sliding_window=0)),
                     ("no attention soft-cap",
                      dataclasses.replace(cfg, attn_softcap=0.0))):
        out[label] = llama.decode_forward(engine.params, c, tok, cache, pt,
                                          pre, pre, path="gather")[0][0]
    rec = {}
    for label in ("no windows", "no attention soft-cap"):
        d = float((out[label] - out["served"]).abs().max())
        rec[label] = d
        check(d > tol, f"sensitivity: {label} moves the logits by {d} at "
              f"position {n}, within the gate's {tol}")
    del cache
    return rec


def phase_gemma2(root: str, smi: str, device: str = "cuda", hf=None,
                 lo: int = 4600, hi: int = 7400) -> dict:
    """16a (see the docstring at the top): gemma-2-9b at full width and
    GEMMA_LAYERS of its depth (`hf` overrides) written to disk with its tokenizer and chat template; the gather
    window held to the same engine's eager per-token deferred gather in
    f32; the bf16 serving engine's step, base gather, memory and knobs;
    then run.py serving the 8 long chats three rounds as a process, held
    to that engine. `hf` (a narrow config.json), `lo` / `hi` (the prompts'
    token counts) and device "cpu" rehearse it on the CPU (the card-only
    checks skipped)."""
    import shutil
    import torch
    from dynamo_tpu_torch.engine.engine import NativeEngine, _gather_base
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.models.loader import config_from_hf, load_model_dir
    from dynamo_tpu_torch.protocols.openai import ChatCompletionRequest
    on_card = device == "cuda"
    hf = hf or dict(GEMMA2_9B_HF, num_hidden_layers=GEMMA_LAYERS)
    cfg = config_from_hf(hf)
    name = f"gemma-2 ({cfg.name})"
    pages = 1024
    extra = ("--num-pages", str(pages)) + (() if on_card else
                                           ("--device", "cpu"))
    need = 19 * 10 ** 9 if on_card else 10 ** 9
    os.makedirs(root, exist_ok=True)
    free = shutil.disk_usage(root).free
    check(free >= need, f"{name}: {free} bytes free under {root}; the bf16 "
          f"checkpoint needs {need}")
    path = os.path.join(root, "gemma-2-9b")
    rec = {}
    try:
        params = llama.init_params(cfg, device, seed=0)
        t0 = time.perf_counter()
        nbytes = write_hf_dir(path, cfg, params, "gemma2", 2, 1, shards=4)
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(hf, f, indent=1)
        with open(os.path.join(path, "tokenizer.json"), "w") as f:
            json.dump(gemma_tokenizer_json(hf["vocab_size"]), f)
        with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
            json.dump({"chat_template": GEMMA_TEMPLATE, "bos_token": "<bos>",
                       "eos_token": "<eos>"}, f)
        rec["write_s"] = time.perf_counter() - t0
        rec["bytes"] = nbytes
        card = ModelDeploymentCard.from_hf_dir(path)
        tok = card.load_tokenizer()
        bodies = long_chats(card, tok, lo, hi)
        rec["prompt_tokens"] = [b.pop("n_prompt") for b in bodies]
        served_cfg = dataclasses.replace(served_config(card), num_pages=pages)
        print(f"{name}: wrote {nbytes} bytes (4 bf16 shards, a "
              f"{hf['vocab_size']}-id Gemma-form tokenizer.json, Gemma's "
              f"chat template) in {rec['write_s']:.1f} s; chats of "
              f"{rec['prompt_tokens']} prompt tokens; EngineConfig "
              f"{served_cfg}", flush=True)
        synchronize(device)
        t0 = time.perf_counter()
        _, loaded = load_model_dir(path, device=device)
        synchronize(device)
        rec["load_s"] = time.perf_counter() - t0
        check(trees_equal(loaded, params), f"{name}: loaded leaves differ "
              "from the written ones")
        del loaded
        empty_cache(device)

        # the bf16 serving engine in process (run.py's EngineConfig): the
        # chats one at a time (run.py is held to these streams), then the
        # step with the 8 prompts decoding together, the base gather, the
        # peak memory and the knobs' sensitivity
        engine = NativeEngine(card.model_config(), served_cfg, params=params,
                              eos_token_ids=set(card.eos_token_ids),
                              device=device)
        check(engine.decode_path == "gather" and engine.pregather
              and engine.model_cfg.dtype == "bfloat16",
              f"{name}: the engine resolved {engine.decode_path} "
              f"({engine.decode_path_reason}) in {engine.model_cfg.dtype}")
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        ref = asyncio.run(reference_chats(card, engine, bodies))
        rec["engine_chats_s"] = time.perf_counter() - t0
        check(launch_counts()[RAGGED] == 0, f"{name}: the engine launched "
              f"the ragged kernel {launch_counts()[RAGGED]} times")
        pre = OpenAIPreprocessor(card, tok)
        prompts = [pre.preprocess_chat(ChatCompletionRequest.from_json(
            {k: v for k, v in b.items() if k not in ("stream",
                                                     "stream_options")}),
            f"p{i}")[0].token_ids for i, b in enumerate(bodies)]
        rec["ms_per_step"] = steady_ms_per_step(engine, prompts)
        if on_card:
            rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        s = engine.cfg.max_slots
        base_pb = engine.scheduler.page_buckets[-1]
        kb, vb, _, _ = engine._window_bufs(s, base_pb,
                                           max(engine._window_sizes))
        table = torch.arange(s * base_pb, dtype=torch.int32,
                             device=engine.device).reshape(s, base_pb)
        lens = torch.tensor(rec["prompt_tokens"], dtype=torch.int32,
                            device=engine.device)
        if on_card:
            rec["base_gather_ms"] = cuda_ms(
                lambda i: _gather_base(engine.cache, table, kb, vb, lens), 3,
                warmup=1)
        rec["base_gather_bytes"] = 2 * kb.numel() * kb.element_size()
        rec["sensitivity"] = sensitivity(engine, prompts[-1], SAME_CONTEXT)
        print(f"{name}: load_model_dir {rec['load_s']:.2f} s, every leaf "
              f"bit-equal; in process the 8 chats one at a time in "
              f"{rec['engine_chats_s']:.1f} s; the gather window untraced "
              f"{rec['ms_per_step']:.2f} ms per decode step with 8 slots "
              f"live; the base gather {rec.get('base_gather_ms', 0):.2f} ms a"
              f" window ({rec['base_gather_bytes']} bytes written, Pb "
              f"{base_pb}); peak {rec.get('peak_gib', 0):.2f} GiB; one step "
              f"past the window the logits move by {rec['sensitivity']} "
              f"without the windows / the attention soft-cap (gate > "
              f"{SAME_CONTEXT}) [{smi}]", flush=True)
        del kb, vb
        # 16c on this tree, the engine its aggregated reference
        rec["distributed"] = phase_gemma2_distributed(
            smi, card, tok, params, served_cfg, engine, bodies, device)
        engine.cache = None
        del engine, params
        empty_cache(device)

        # run.py: a cold round (prefill, captures), a warm-up round on the
        # cached prefixes, then the measured round; one chat at a time, as
        # the in-process engine served them
        served = serve_checkpoint(path, bodies, extra, name=f"{name} (run.py)",
                                  rounds=3)
        rec["ready_s"], rec["ready_load_s"] = served["ready_s"], served["load_s"]
        st = served["stats"]
        rounds = served["rounds"]
        for k, rnd in enumerate(rounds):
            for i, (entries, _) in enumerate(rnd["results"]):
                check(0 < len(entries) <= 64, f"{name}: round {k} chat {i}: "
                      f"{len(entries)} tokens")
        # the cold round is the in-process engine's computation: held to
        # it; the warm rounds prefill only each prompt's tail after a
        # prefix hit (other bf16 roundings than the cold chunks): held to
        # each other exactly, and to the engine only reported
        rec["first_differences"] = hold_to_reference(
            f"{name} cold round", rounds[0]["results"], ref, tok)
        rec["warm_first_differences"] = [
            first_difference_of(a, b) for (a, _), (b, _, _) in zip(
                rounds[2]["results"], ref)]
        check([r[0] for r in rounds[2]["results"]]
              == [r[0] for r in rounds[1]["results"]],
              f"{name}: the measured round's streams differ from the "
              "warm-up round's")
        check(st["decode_path"] == "gather", f"{name}: run.py resolved "
              f"{st['decode_path']} ({st['decode_path_reason']})")
        check(st["kernel_launches"][RAGGED] == 0, f"{name}: run.py launched "
              f"the ragged kernel {st['kernel_launches'][RAGGED]} times")
        g = st["graphs"]
        check(not on_card or (g["replays"] == st["decode_windows"]
                              == st["decode_dispatches"]
                              == g["replay_paths"].get("gather", 0) > 0),
              f"{name}: {g['replays']} replays ({g['replay_paths']}) for "
              f"{st['decode_windows']} windows")
        late = [t for t in g["capture_times"] if t >= rounds[2]["start"]]
        check(not late, f"{name}: {len(late)} window graphs captured in the "
              f"measured round (after the warm-up)")
        rec["captured"] = g["captured"]
        rec["cold"] = _ttft_quantiles(rounds[0]["metrics"])
        rec["warm"] = _ttft_quantiles(rounds[2]["metrics"],
                                      rounds[1]["metrics"])
        rec["launches"] = st["kernel_launches"]
        print(f"{name}: run.py READY in {rec['ready_s']:.1f} s (its load "
              f"{rec['ready_load_s']:.2f} s); 3 rounds of the 8 chats one at "
              f"a time (4 SSE, 4 unary), every stream 64 tokens or a stop; "
              f"the cold round held to the in-process engine "
              f"{rec['first_differences']}, the measured round equal to the "
              f"warm-up round (first differences from the engine "
              f"{rec['warm_first_differences']}, reported); path gather, "
              f"ragged launches 0, {g['replays']} replays = windows, "
              f"{g['captured']} graphs captured, none in the measured round;"
              f" TTFT p50 / p90 cold {rec['cold']['ttft_p50_ms']:.1f} / "
              f"{rec['cold']['ttft_p90_ms']:.1f} ms, warm "
              f"{rec['warm']['ttft_p50_ms']:.1f} / "
              f"{rec['warm']['ttft_p90_ms']:.1f} ms [{smi}]", flush=True)
        # the two longest chats (the check takes ~17 s a chat on the card)
        rec["f32"] = gather_window_f32(card, bodies[-2:],
                                       rec["prompt_tokens"][-2:], device, smi)
    finally:
        shutil.rmtree(path, ignore_errors=True)
    return rec


# -- phase 16c: Gemma-2 routed and disaggregated on the gather window ---------

# R's shared system prompts: past gemma-2-9b's 4096-token window, or 3/5 of
# a narrower config's context
GEMMA_DIST_SYS = 4700
GEMMA_DIST_TOKENS = 32
GEMMA_Q_TOKENS = 8
# long enough that both batch streams still decode when the interactive
# chat's remote prefill lands (~0.5 s on the card; a step ~5-6 ms)
GEMMA_PREEMPT_TOKENS = 512
GEMMA_DIST_NS = "gemma-dist"


def sized_text(tok, target: int, seed: int) -> str:
    """Words of LONG_WORDS (numpy seed `seed`) that the tokenizer encodes to
    `target` tokens, within 2%."""
    import numpy as np
    words = list(np.random.default_rng(seed).choice(LONG_WORDS, target))
    text = " ".join(words)
    for _ in range(8):
        n = len(tok.encode(text))
        if abs(n - target) <= max(2, target // 50):
            break
        words = (words * 2)[:max(1, int(len(words) * target / n))]
        text = " ".join(words)
    return text


def gemma_chat(model: str, text: str, max_tokens: int,
               stream: bool = True) -> dict:
    body = {"model": model, "max_tokens": max_tokens, "temperature": 0.0,
            "messages": [{"role": "user", "content": text}]}
    if stream:
        body.update(stream=True, stream_options={"include_usage": True})
    return body


def stride_order(classes: list, policy) -> list:
    """The order a class-aware queue owes items enqueued with `classes`
    (FIFO within a class), recomputed from the policy's weights,
    priorities and aging limit: the backlogged class with the lowest
    virtual pass goes next (the higher priority, then the name, on a tie),
    its pass advancing by 1 / weight; a class skipped aging_limit times in
    a row goes first."""
    left = {}
    for i, c in enumerate(classes):
        left.setdefault(c, []).append(i)
    passes, skipped, out = {}, {}, []
    while any(left.values()):
        backlog = [c for c, q in left.items() if q]
        floor = min(passes.values()) if passes else 0.0
        for c in backlog:
            passes[c] = max(passes.get(c, floor), floor)
            skipped.setdefault(c, 0)

        def key(c):
            return (passes[c], -policy.classes[c].priority, c)
        aged = sorted((c for c in backlog
                       if skipped[c] >= policy.aging_limit), key=key)
        c = (aged or sorted(backlog, key=key))[0]
        out.append(left[c].pop(0))
        passes[c] += 1.0 / policy.classes[c].weight
        skipped[c] = 0
        for o in backlog:
            if o != c:
                skipped[o] += 1
    return out


def phase_gemma2_distributed(smi: str, card, tok, params, served_cfg,
                             ref_engine, bodies: list,
                             device: str = "cuda") -> dict:
    """16c (see the docstring at the top): 16a's tree routed (R),
    disaggregated (D) and under the class-aware queue and a cross-class
    preemption (Q); `ref_engine` is 16a's in-process engine, the
    aggregated reference. On the CPU (a narrow config) the card-only
    checks are skipped."""
    return asyncio.run(asyncio.wait_for(_gemma2_distributed(
        smi, card, tok, params, served_cfg, ref_engine, bodies, device),
        900))


async def _gemma2_distributed(smi, card, tok, params, served_cfg,
                              ref_engine, bodies, device) -> dict:
    import torch
    from dynamo_tpu_torch.disagg.queue import PrefillQueue
    from dynamo_tpu_torch.disagg.remote_transfer import (
        KvTransferServer, RemoteTransferBackend,
    )
    from dynamo_tpu_torch.disagg.router import DisaggregatedRouter
    from dynamo_tpu_torch.disagg.worker import (
        DisaggDecodeWorker, PrefillWorker,
    )
    from dynamo_tpu_torch.engine.engine import NativeEngine
    from dynamo_tpu_torch.engine.scheduler import Scheduler
    from dynamo_tpu_torch.frontend.discovery import (
        ModelWatcher, register_model,
    )
    from dynamo_tpu_torch.frontend.service import HttpService
    from dynamo_tpu_torch.kv_router.router import KvRouter
    from dynamo_tpu_torch.llm import worker as llm_worker
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.protocols.openai import ChatCompletionRequest
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.runtime.engine import Context
    from dynamo_tpu_torch.runtime.integrity import (
        STATS as INTEGRITY, XFER_STATS,
    )
    from dynamo_tpu_torch.runtime.qos import (
        QOS_STATS, QosPolicy, set_qos,
    )
    from dynamo_tpu_torch.runtime.transports.memory import MemoryPlane
    name = "16c"
    on_card = device == "cuda"
    t_phase = time.perf_counter()
    model = card.name
    ps = served_cfg.page_size
    pre = OpenAIPreprocessor(card, tok)
    mcfg = card.model_config()
    eos = set(card.eos_token_ids)
    rec = {}

    def prep(body, rid):
        p, _ = pre.preprocess_chat(ChatCompletionRequest.from_json(
            {k: v for k, v in body.items()
             if k not in ("stream", "stream_options")}), rid)
        return p

    def engine(cfg):
        e = NativeEngine(mcfg, cfg, params=params, eos_token_ids=eos,
                         device=device)
        check(e.decode_path == "gather" and e.pregather, f"{name}: an "
              f"engine resolved {e.decode_path} ({e.decode_path_reason})")
        return e

    def free(*engines):
        for e in engines:
            e.cache = None
        empty_cache(device)

    # the aggregated reference: 16a's engine on a fresh allocator, each
    # chat alone, with its top logprobs
    ref_engine.scheduler = Scheduler(ref_engine.cfg)
    ref_engine._dec_state = None
    refs = {}

    def reference(rid, p):
        refs[rid] = aggregated_run(ref_engine, f"ref-{rid}",
                                   llm_worker.to_engine_request(p))
        return refs[rid]

    def hold(label, toks, rid):
        d = divergence(toks, *refs[rid])
        check(d is None or d[1] <= NEAR_TIE, f"{name}: {label} left the "
              f"aggregated reference at (position, logprob gap) {d}, past "
              f"a near tie ({NEAR_TIE})")
        return d

    # -- R: two gather workers behind the KV router ----------------------
    t0 = time.perf_counter()
    sys_len = min(GEMMA_DIST_SYS, served_cfg.max_model_len * 3 // 5)
    systems = [sized_text(tok, sys_len, 1600 + s) for s in range(2)]
    chats = []      # (wave, system, rid, body)
    for w in range(2):
        for k in range(4):
            s = k % 2
            user = sized_text(tok, 40 + (160 * (4 * w + k)) // 7,
                              1700 + 4 * w + k)
            chats.append((w, s, f"R{w}{k}", gemma_chat(
                model, systems[s] + "\n\n" + user, GEMMA_DIST_TOKENS)))
    prompts = {rid: prep(b, rid) for _, _, rid, b in chats}
    for rid, p in prompts.items():
        reference(rid, p)
    rec["reference_s"] = time.perf_counter() - t0

    class Tap(llm_worker.NativeEngineWorker):
        """Records each served stream's token ids by its prompt."""

        async def generate(self, request, context):
            ids = tuple(request["token_ids"] if isinstance(request, dict)
                        else request.token_ids)
            toks = self.streams.setdefault(ids, [])
            async for frame in super().generate(request, context):
                toks.extend((frame.get("token_ids") or ())
                            if isinstance(frame, dict)
                            else (frame.token_ids or ()))
                yield frame

    r_engines = [engine(served_cfg) for _ in range(2)]
    plane = MemoryPlane()
    rts, workers = [], {}
    reset_launch_counts()
    for i, e in enumerate(r_engines):
        w = await Tap(e).start()
        w.streams = {}
        rt = await DistributedRuntime.create_local(plane, f"g{i}")
        await llm_worker.serve_llm_worker(rt, GEMMA_DIST_NS, "gemma", w)
        rts.append(rt)
        workers[f"g{i}"] = w
    frt = await DistributedRuntime.create_local(plane, "frontend")
    rts.append(frt)
    svc = await HttpService("127.0.0.1", 0).start()

    async def make_router(component, client, card_):
        return await KvRouter(component, client,
                              block_size=card_.kv_page_size).start()
    svc.watcher = await ModelWatcher(
        frt, svc.models, make_router=make_router,
        reliability_metrics=svc.reliability).start()
    await register_model(frt.kv, model, GEMMA_DIST_NS, "gemma", card,
                         model_type="chat", kv_routed=True)
    try:
        async def ready():
            st = await _get_json(svc.port, "/router/state")
            m = st["models"].get(model)
            return m is not None and len(m["instances"]) == 2
        await _poll(f"{name}: the router seeing both workers", ready, 60,
                    0.05)
        fb0 = (await _get_json(svc.port, "/router/state"))["router"][
            "fallbacks"]
        res = {}
        wave1 = [(rid, b) for w, _, rid, b in chats if w == 0]
        wave2 = [(rid, b) for w, _, rid, b in chats if w == 1]
        res.update(zip([r for r, _ in wave1], await asyncio.gather(
            *(_dist_send(svc.port, b, r) for r, b in wave1))))

        async def scored():
            for _, b in wave2:
                m = await _get_json(svc.port, "/router/match", {
                    "model": model, "messages": b["messages"]})
                if not m["scores"]:
                    return False
            return True
        await _poll(f"{name}: the router scoring every prompt", scored, 60,
                    0.05)
        captured1 = [e.graphs.captured for e in r_engines]
        res.update(zip([r for r, _ in wave2], await asyncio.gather(
            *(_dist_send(svc.port, b, r) for r, b in wave2))))
        state = await _get_json(svc.port, "/router/state")
    finally:
        await svc.watcher.stop()
        await svc.stop()
        for rt in rts:
            await rt.shutdown()
        for w in workers.values():
            await w.stop()
    decs = {d["request_id"]: d for d in state["models"][model]["decisions"]}
    check(set(decs) >= set(prompts), f"{name}: R's router decided "
          f"{sorted(decs)} of {sorted(prompts)}")
    went = {}
    wave2_pages = []
    for w, s, rid, _ in chats:
        d = decs[rid]
        if w == 1:
            homes = {went[r] for ww, ss, r, _ in chats
                     if ww == 0 and ss == s}
            check(d["worker_id"] in homes, f"{name}: {rid} went to "
                  f"{d['worker_id']}, its prompt's wave-1 chats to {homes}")
            ids = prompts[rid].token_ids
            derived = max(
                len(os.path.commonprefix([ids, prompts[r].token_ids])) // ps
                for ww, ss, r, _ in chats
                if ww == 0 and ss == s and went[r] == d["worker_id"])
            got = d["scores"].get(d["worker_id"], 0)
            check(got >= derived > 0, f"{name}: {rid} matched {got} pages "
                  f"on {d['worker_id']}, its sealed prefix holds {derived}")
            wave2_pages.append((got, derived))
        went[rid] = d["worker_id"]
    fallbacks = state["router"]["fallbacks"] - fb0
    check(fallbacks == 0, f"{name}: {fallbacks} router fall-backs")
    r_div = {}
    for rid, p in prompts.items():
        served = workers[went[rid]].streams.get(tuple(p.token_ids))
        check(served is not None and len(served) == res[rid]["tokens"],
              f"{name}: {rid}'s stream not found on {went[rid]}")
        r_div[rid] = hold(rid, served, rid)
    ragged = launch_counts()[RAGGED]
    check(ragged == 0, f"{name}: R launched the ragged kernel {ragged} "
          f"times")
    for i, e in enumerate(r_engines):
        g = e.graphs
        check(not on_card or g.replays == e.decode_dispatches
              == g.replay_paths.get("gather", 0), f"{name}: worker g{i}: "
              f"{g.replays} replays ({g.replay_paths}) for "
              f"{e.decode_dispatches} windows")
    captured2 = [e.graphs.captured for e in r_engines]
    check(captured2 == captured1, f"{name}: graphs captured in wave 2 "
          f"({captured1} -> {captured2})")
    rec["R"] = {"picks": went, "wave2_pages": wave2_pages,
                "divergence": r_div,
                "ttft": quantiles([r["ttft_s"] for r in res.values()]),
                "captured": captured2, "ragged_launches": ragged,
                "seconds": time.perf_counter() - t0}
    print(f"{name} R [{smi}]: 8 SSE chats of "
          f"{[len(p.token_ids) for p in prompts.values()]} tokens over 2 "
          f"shared prompts, two waves of 4 through the KV router: picks "
          f"{went}, wave 2 matched / derived pages {wave2_pages}, 0 "
          f"fall-backs, streams against the aggregated engine {r_div}, "
          f"path gather on both, ragged launches 0, graphs {captured2} "
          f"(none in wave 2), routed TTFT p50 / p90 "
          f"{rec['R']['ttft']['p50_ms']:.1f} / "
          f"{rec['R']['ttft']['p90_ms']:.1f} ms", flush=True)
    free(*r_engines)
    del r_engines, workers

    # -- D: a prefill worker feeding a gather decode worker -------------------
    t0 = time.perf_counter()
    threshold = 1000
    dcfg = dataclasses.replace(served_cfg, max_slots=16, num_pages=1024,
                               max_prefill_chunk=512)
    pcfg = dataclasses.replace(served_cfg, max_slots=8, num_pages=1024,
                               max_prefill_chunk=512)
    dec_eng, pre_eng = engine(dcfg), engine(pcfg)
    longs = [dict(b, max_tokens=GEMMA_DIST_TOKENS) for b in bodies[-4:]]
    shorts = [gemma_chat(model, sized_text(tok, n, 1800 + n),
                         GEMMA_DIST_TOKENS, False) for n in (125, 625)]
    d_pre = {f"D{i}": prep(b, f"D{i}")
             for i, b in enumerate(longs + shorts)}
    want_remote = {rid: DisaggregatedRouter(threshold, 2).prefill_remote(
        len(p.token_ids), 0, 0) for rid, p in d_pre.items()}
    check([want_remote[f"D{i}"] for i in range(6)]
          == [True] * 4 + [False] * 2, f"{name}: D's chats decide "
          f"{want_remote} (lengths {[len(p.token_ids) for p in d_pre.values()]})")
    # the decode engine's own disaggregation hooks (remote chats) or an
    # aggregated run (local ones), one at a time: its window graphs for
    # these shapes, and the streams the served ones must equal
    own = {}
    for rid, p in d_pre.items():
        reference(rid, p)
        req = llm_worker.to_engine_request(p)
        own[rid] = (disagg_reference(dec_eng, f"own-{rid}", req)
                    if want_remote[rid] else
                    aggregated_run(dec_eng, f"own-{rid}", req,
                                   tops=False)[0])
    dec_eng.scheduler = Scheduler(dec_eng.cfg)
    dec_eng._dec_state = None
    rec["d_reference_s"] = time.perf_counter() - t0

    qplane = MemoryPlane()
    queue = PrefillQueue(qplane.messaging, GEMMA_DIST_NS, model,
                         qos_policy=QosPolicy())
    router = DisaggregatedRouter(threshold, 2, model)
    decode = DisaggDecodeWorker(dec_eng, qplane.messaging, router, queue,
                                worker_id="gdec-0", prefill_timeout_s=300.0)
    server = await KvTransferServer(decode, "gdec-0").start()
    await server.register(qplane.kv)
    tx = RemoteTransferBackend(qplane.kv, chunk_pages=4)
    prefill = PrefillWorker(llm_worker.NativeEngineWorker(pre_eng), queue,
                            tx, qplane.messaging, dequeue_timeout_s=0.05)
    x0, i0 = XFER_STATS.snapshot(), INTEGRITY.snapshot()
    reset_launch_counts()
    keys0 = set(dec_eng.graphs.captured_calls())
    d_out, d_ttft, d_itl = {}, {}, {}
    await decode.start()
    await prefill.start()
    try:
        for rid, p in d_pre.items():
            ts = time.perf_counter()
            toks, stamps = [], []
            async for f in decode.generate(p, Context(rid)):
                for t in f.token_ids or ():
                    toks.append(t)
                    stamps.append(time.perf_counter() - ts)
            d_out[rid], d_ttft[rid] = toks, stamps[0]
            # from the second token on (a remote chat's second token waits
            # for its transfer): one step of the gather window a token
            d_itl[rid] = ((stamps[-1] - stamps[1])
                          / max(1, len(stamps) - 2) * 1e3)
    finally:
        await prefill.stop()
    st = decode.stats_handler()["disagg"]
    xfers = dict(prefill.transfers)
    xd = {k: v - x0[k] for k, v in XFER_STATS.snapshot().items()}
    idl = {k: v - i0[k] for k, v in INTEGRITY.snapshot().items()}
    remote = [rid for rid in d_pre if want_remote[rid]]
    for rid in d_pre:
        check(st["decisions"][rid]["remote"] == want_remote[rid],
              f"{name}: {rid} went {st['decisions'][rid]}, prefill_remote "
              f"says remote={want_remote[rid]}")
        check(d_out[rid] == own[rid], f"{name}: {rid} served {d_out[rid]} "
              f"where the decode engine's own hooks gave {own[rid]}")
    d_div = {rid: hold(rid, d_out[rid], rid) for rid in d_pre}
    uncached = sum(-(-len(d_pre[r].token_ids) // ps) for r in remote)
    check(st["received_pages"] == uncached == idl["pages_verified"]
          and idl["mismatches"] == 0, f"{name}: pages received "
          f"{st['received_pages']}, derived {uncached}, integrity {idl}")
    check(st["salvaged_prefills"] == st["full_reprefills"]
          == st["prefill_timeouts"] == 0, f"{name}: D's salvages / "
          f"re-prefills / timeouts {st}")
    check((st["remote_prefills"], st["local_prefills"]) == (4, 2),
          f"{name}: {st['remote_prefills']} remote / "
          f"{st['local_prefills']} local prefills")
    ragged = launch_counts()[RAGGED]
    check(ragged == 0, f"{name}: D launched the ragged kernel {ragged} "
          f"times")
    late = set(dec_eng.graphs.captured_calls()) - keys0
    check(not late, f"{name}: the decode engine captured {sorted(late)} "
          f"after its warm-up")
    nbytes = sum(xfers[r]["bytes"] for r in remote)
    xfer_ms = sum(xfers[r]["ms"] for r in remote)
    mib = nbytes / 2 ** 20
    rec["D"] = {"decisions": want_remote, "divergence": d_div,
                "ttft_ms": {r: d_ttft[r] * 1e3 for r in d_pre},
                "pages": uncached, "transfers": {r: xfers[r]
                                                 for r in remote},
                "transfer_mib": mib, "transfer_ms": xfer_ms,
                "transfer_gbs": nbytes / max(xfer_ms, 1e-9) / 1e6,
                "kv_transfer": xd, "integrity": idl,
                "ms_per_token": d_itl, "ragged_launches": ragged,
                "seconds": time.perf_counter() - t0}
    print(f"{name} D [{smi}]: 6 chats of "
          f"{[len(p.token_ids) for p in d_pre.values()]} tokens one at a "
          f"time: remote {remote} as prefill_remote decides, {uncached} "
          f"pages received = verified, 0 mismatches / salvages / "
          f"re-prefills / timeouts, streams equal the decode engine's own "
          f"hooks and against the aggregated engine {d_div}; TTFT "
          f"{ {r: round(v * 1e3, 1) for r, v in d_ttft.items()} } ms; "
          f"transfers {mib:.1f} MiB in {xfer_ms:.1f} ms "
          f"({rec['D']['transfer_gbs']:.3f} GB/s); ms a token from the "
          f"second on (a gather window step, one slot live) "
          f"{ {r: round(v, 2) for r, v in d_itl.items()} }; ragged "
          f"launches 0, no capture after the warm-up", flush=True)

    # -- Q: the class-aware queue and one cross-class preemption ---------------
    t0 = time.perf_counter()
    reset_launch_counts()
    policy = queue.qos_policy
    # the queue holds all five before the prefill worker consumes: a depth
    # bound of 2 (D's) would send the third one local
    router = decode.disagg_router = DisaggregatedRouter(threshold, 8, model)
    q_bodies = [gemma_chat(model, sized_text(tok, 1100 + 40 * i, 1900 + i),
                           GEMMA_Q_TOKENS, False) for i in range(5)]
    classes = ["batch"] * 4 + ["interactive"]
    q_pre = [prep(b, f"Q{i}") for i, b in enumerate(q_bodies)]
    order = []
    dequeue = queue.dequeue_leased

    async def recording(*a, **kw):
        got = await dequeue(*a, **kw)
        if got is not None:
            order.append(got[0].request_id)
        return got
    queue.dequeue_leased = recording
    prefill_q = PrefillWorker(llm_worker.NativeEngineWorker(pre_eng), queue,
                              tx, qplane.messaging, dequeue_timeout_s=0.05)
    q_first = {}

    async def one(i):
        ctx = Context(f"Q{i}")
        set_qos(ctx.baggage, classes[i])
        toks = []
        async for f in decode.generate(q_pre[i], ctx):
            if f.token_ids and f"Q{i}" not in q_first:
                q_first[f"Q{i}"] = time.perf_counter()
            toks.extend(f.token_ids or ())
        return toks
    tasks = []
    for i in range(5):
        tasks.append(asyncio.create_task(one(i)))

        async def queued(n=i + 1):
            return await queue.depth() >= n
        await _poll(f"{name}: Q{i} queued", queued, 60, 0.01)
    t_start = time.perf_counter()
    await prefill_q.start()
    try:
        q_out = await asyncio.wait_for(asyncio.gather(*tasks), 300)
    finally:
        await prefill_q.stop()
        queue.dequeue_leased = dequeue
    want_order = [f"Q{i}" for i in stride_order(classes, policy)]
    check(order == want_order, f"{name}: dequeued {order}, the policy "
          f"owes {want_order}")
    check(all(len(t) == GEMMA_Q_TOKENS for t in q_out), f"{name}: Q's "
          f"streams {[len(t) for t in q_out]} tokens")
    q_ttft = {r: (q_first[r] - t_start) * 1e3 for r in q_first}

    # one cross-class preemption on a 2-slot decode engine
    await decode.stop()
    await server.stop()
    free(dec_eng)
    p_eng = engine(dataclasses.replace(served_cfg, max_slots=2,
                                       num_pages=1024))
    p_bodies = [gemma_chat(model, sized_text(tok, n, 2000 + n),
                           GEMMA_PREEMPT_TOKENS, False) for n in (150, 260)]
    p_pre = [prep(b, f"P{i}") for i, b in enumerate(p_bodies)]
    i_pre = prep(gemma_chat(model, sized_text(tok, 1150, 2100),
                            GEMMA_DIST_TOKENS, False), "Pi")
    p_ref = {f"P{i}": aggregated_run(p_eng, f"pref-{i}",
                                     llm_worker.to_engine_request(p))
             for i, p in enumerate(p_pre)}
    p_eng.scheduler = Scheduler(p_eng.cfg)
    p_eng._dec_state = None
    pdecode = DisaggDecodeWorker(p_eng, qplane.messaging, router, queue,
                                 worker_id="gdec-1", prefill_timeout_s=300.0)
    pserver = await KvTransferServer(pdecode, "gdec-1").start()
    await pserver.register(qplane.kv)
    prefill_p = PrefillWorker(llm_worker.NativeEngineWorker(pre_eng), queue,
                              tx, qplane.messaging, dequeue_timeout_s=0.05)
    pre0 = QOS_STATS.preemptions_total
    by0 = dict(QOS_STATS.preempted_by_class)
    progress = {}

    async def stream(p, rid, cls):
        ctx = Context(rid)
        set_qos(ctx.baggage, cls)
        toks = progress.setdefault(rid, [])
        async for f in pdecode.generate(p, ctx):
            toks.extend(f.token_ids or ())
        return toks
    await pdecode.start()
    await prefill_p.start()
    try:
        batch = [asyncio.create_task(stream(p, f"P{i}", "batch"))
                 for i, p in enumerate(p_pre)]

        async def both_decoding():
            return all(len(progress.get(f"P{i}", ())) >= 8
                       for i in range(2))
        await _poll(f"{name}: both batch streams decoding", both_decoding,
                    120, 0.01)
        inter = await asyncio.wait_for(stream(i_pre, "Pi", "interactive"),
                                       300)
        p_out = await asyncio.wait_for(asyncio.gather(*batch), 300)
    finally:
        await prefill_p.stop()
        await pdecode.stop()
        await pserver.stop()
        await tx.close()
    preempts = QOS_STATS.preemptions_total - pre0
    victims = {k: v - by0.get(k, 0)
               for k, v in QOS_STATS.preempted_by_class.items()}
    # 2 slots both held by batch, an interactive arrival of priority 2
    # with a budget of 4: exactly one batch stream gives up its slot
    check(preempts == 1 and victims.get("batch") == 1, f"{name}: "
          f"{preempts} preemptions ({victims}), derived 1 of a batch "
          f"stream")
    check(len(inter) == GEMMA_DIST_TOKENS and all(
        len(t) == GEMMA_PREEMPT_TOKENS for t in p_out), f"{name}: the "
          f"streams ended with {len(inter)} / {[len(t) for t in p_out]} "
          f"tokens")
    p_div = {}
    for i, toks in enumerate(p_out):
        d = divergence(toks, *p_ref[f"P{i}"])
        check(d is None or d[1] <= NEAR_TIE, f"{name}: P{i} left its "
              f"unpreempted run at {d}")
        p_div[f"P{i}"] = d
    ragged = launch_counts()[RAGGED]
    check(ragged == 0, f"{name}: Q launched the ragged kernel {ragged} "
          f"times")
    rec["Q"] = {"order": order, "want": want_order, "ttft_ms": q_ttft,
                "preemptions": preempts, "divergence": p_div,
                "ragged_launches": ragged,
                "seconds": time.perf_counter() - t0}
    print(f"{name} Q [{smi}]: 4 batch then 1 interactive remote chats "
          f"queued before the prefill worker started: dequeued {order} = "
          f"the policy's {want_order}; TTFT from the start "
          f"{ {r: round(v, 1) for r, v in q_ttft.items()} } ms "
          f"(interactive Q4 beside batch Q0-Q3); a 2-slot decode engine "
          f"with two batch streams of {GEMMA_PREEMPT_TOKENS} tokens: "
          f"{preempts} preemption of a batch stream by the interactive "
          f"chat, every stream at max_tokens, the batch streams against "
          f"their unpreempted runs {p_div}", flush=True)
    free(p_eng, pre_eng)
    rec["seconds"] = time.perf_counter() - t_phase
    print(f"phase seconds: 16c {rec['seconds']:.1f}", flush=True)
    return rec


def gather_window_f32(card, bodies: list, prompt_tokens: list, device: str,
                      smi: str) -> dict:
    """16a's reference gate: the gather window against the same engine's
    eager per-token deferred gather (`pregather = False`, eager windows:
    no window buffer, no graph), at the served width and depth in f32 (random
    f32 weights from seed 0; one slot, so that the weights, the cache and
    the base fit beside each other). In f32 the two differ by summation
    order alone, so every stream must be equal or first differ at a near
    tie; in bf16 that order difference, carried through tens of random layers,
    moves the logprobs past two bf16 ulps within tens of tokens (PR 15's
    call 5), a drift no tie rule separates from a fault. The window runs
    first, the reference second; the cache holds one chat, so each chat's
    prefill is cold in both."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import NativeEngine
    from dynamo_tpu_torch.models import llama
    cfg = dataclasses.replace(card.model_config(), dtype="float32")
    ps = card.kv_page_size
    # the longest chat and its 64 tokens, and room to spare
    pages = -(-(max(prompt_tokens) + 64) // ps) + 8
    params = llama.init_params(cfg, device, seed=0)
    engine = NativeEngine(cfg, EngineConfig(
        page_size=ps, num_pages=pages, max_slots=1,
        max_model_len=cfg.max_model_len), params=params,
        eos_token_ids=set(card.eos_token_ids), device=device)
    t0 = time.perf_counter()
    window = asyncio.run(reference_chats(card, engine, bodies))
    engine.pregather = False
    engine.graphs.eager = True
    reference = asyncio.run(reference_chats(card, engine, bodies))
    took = time.perf_counter() - t0
    firsts = ab_entries("gemma-2 f32 window vs eager deferred gather",
                        window, reference)
    engine.cache = None
    del engine, params
    empty_cache(device)
    print(f"gemma-2 (gemma2) f32, {card.model_config().num_layers} layers, "
          f"one slot, {pages} "
          f"pages: the gather window against the eager per-token deferred "
          f"gather on {len(bodies)} chats of {prompt_tokens} prompt tokens:"
          f" first differences {firsts} ({took:.1f} s) [{smi}]", flush=True)
    return {"first_differences": firsts, "pages": pages, "seconds": took}


def ab_entries(name: str, a: list, b: list, gate: bool = True) -> list:
    """Two engines' streams of the same chats: equal entries, or a first
    difference at a near tie (hold_to_reference's rule, without text);
    with gate=False the first differences and their gaps are only
    returned."""
    firsts = []
    for i, ((x, _, _), (y, _, _)) in enumerate(zip(a, b)):
        d = first_difference_of(x, y)
        if d is None:
            firsts.append(None)
            continue
        case = "token" if x[d][0] != y[d][0] else "context"
        at = d if case == "token" else d - 1
        check(at >= 0, f"{name}: chat {i} differs in its first token")
        tie = max(e[2][0] - e[2][1] for e in (x[at], y[at]))
        check(not gate or tie <= NEAR_TIE, f"{name}: chat {i} differs at "
              f"{d} ({case}), top-1 less top-2 {tie:.4f} (near tie <= "
              f"{NEAR_TIE})")
        firsts.append([d, case, round(tie, 5)])
    return firsts


def phase_decode_windows_ab(smi: str, params=None,
                            model: str = "llama3-8b",
                            device: str = "cuda",
                            layers: int = AB_LAYERS) -> dict:
    """16b: the gather window (decode_kernel="off") against the ragged
    kernel window ("auto") at `model` on the same weights, bf16 and int8
    KV pages, 8 slots: the 4 longest of phase 4's 8 chats one at a time
    (each scheduled alike in both engines), greedy (a near tie is a greedy
    pick's notion) with top-8 logprobs; then each window's untraced ms per
    decode step on the 8 chats' prompts, all 8 slots live. On bf16 pages the
    streams must be token-identical or first differ at a near tie. On
    int8 pages the two windows compute different functions by design (the
    kernel window reads the rows its own window wrote quantized and folds
    the scales in f32; the gather window holds its rows in full precision
    until its end and reads the base dequantized to the model dtype, as
    the JAX package's gather window does: ROADMAP.md §C), so their first
    differences and gaps are reported, not gated; every stream must still
    end, and every logit be finite. At `layers` of the model's depth when
    that cuts it (0: all)."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import NativeEngine
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.run import build_card
    card = build_card(model)
    cfg = card.model_config()
    if 0 < layers < cfg.num_layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    if params is None:
        params = llama.init_params(cfg, device, seed=0)
    reqs = chat_requests(card.name, sampled=False)
    # the streams of the 4 longest chats (one at a time); the timing runs
    # all 8 prompts together
    bodies = [dict(r.to_json(exclude_none=True), logprobs=True,
                   top_logprobs=CKPT_TOP) for r in reqs[4:]]
    pre = OpenAIPreprocessor(card)
    prompts = [pre.preprocess_chat(r, f"ab-{i}")[0].token_ids
               for i, r in enumerate(reqs)]
    out = {}
    for kv in ("", "int8"):
        runs = {}
        for mode in ("auto", "off"):
            engine = NativeEngine(
                dataclasses.replace(cfg, decode_kernel=mode),
                EngineConfig(kv_quant=kv), params=params,
                eos_token_ids=set(card.eos_token_ids), device=device)
            want = "ragged" if mode == "auto" else "gather"
            check(engine.decode_path == want, f"16b {mode}: resolved "
                  f"{engine.decode_path}")
            reset_launch_counts()
            streams = asyncio.run(reference_chats(card, engine, bodies))
            ragged = launch_counts()[RAGGED]
            check(device != "cuda" or (ragged > 0) == (mode == "auto"),
                  f"16b {mode}: {ragged} ragged launches")
            check(engine.logits_nonfinite_steps() == 0
                  and all(0 < len(e) <= MAX_TOKENS for e, _, _ in streams),
                  f"16b {mode} {kv or 'bf16'}: a stream was empty or a "
                  "logit was not finite")
            runs[mode] = {"streams": streams, "ragged_launches": ragged,
                          "ms_per_step": steady_ms_per_step(engine,
                                                            prompts)}
            engine.cache = None
            del engine
            empty_cache(device)
        label = f"decode windows {kv or 'bf16'} pages"
        firsts = ab_entries(label, runs["auto"]["streams"],
                            runs["off"]["streams"], gate=not kv)
        out[kv or "bf16"] = {
            "first_differences": firsts,
            **{f"{m}_ms_per_step": runs[m]["ms_per_step"] for m in runs},
            "auto_ragged_launches": runs["auto"]["ragged_launches"]}
        print(f"{label} ({model}, 8 slots): the gather window (off) against "
              f"the kernel window (auto): first differences [position, "
              f"kind, top-1 less top-2] {firsts}"
              f"{' (reported, not gated)' if kv else ''}; untraced "
              f"{runs['off']['ms_per_step']:.3f} ms per decode step "
              f"(gather) vs {runs['auto']['ms_per_step']:.3f} (kernel) "
              f"[{smi}]", flush=True)
    return out


def phase_a5(smi: str) -> dict:
    """Phase 16: 16a under build/checkpoints (removed), then 16b."""
    import shutil
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "checkpoints")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    t0 = time.perf_counter()
    try:
        gemma2 = phase_gemma2(root, smi)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    t1 = time.perf_counter()
    ab = phase_decode_windows_ab(smi)
    return {"gemma2": gemma2, "gemma2_s": t1 - t0, "windows_ab": ab,
            "windows_ab_s": time.perf_counter() - t1}


# -- phase 17: speculative decoding -------------------------------------------

SPEC_K = 4
SPEC_TIE_F32 = 1e-3   # a near tie of f32 logits (their rounding is ~1e-5)
SPEC_WORDS = ("the server keeps each request on its pages while the router "
              "scores prefixes and the worker streams tokens back to the "
              "client over one connection ").split()


def spec_chats(card, n: int = 8, lo: int = 512, hi: int = 2048,
               seed: int = 17) -> list:
    """17a's chats: n greedy user turns whose prompts (the chat template
    included) take lo..hi byte-tokens, spread evenly, each quoting one
    paragraph of 128-256 bytes three times between fillers and asking for
    it restated; MAX_TOKENS each."""
    import numpy as np
    rng = np.random.default_rng(seed)
    ask = " Restate the quoted paragraph word for word."
    bare = {"model": card.name, "max_tokens": MAX_TOKENS,
            "temperature": 0.0, "messages": [{"role": "user",
                                              "content": ""}]}
    overhead = len(chat_prompts(card, [bare])[0])
    out = []
    for i in range(n):
        size = lo + (hi - lo) * i // max(1, n - 1) - overhead - len(ask)
        para = ""
        plen = int(rng.integers(128, min(256, size // 3 - 2) + 1))
        while len(para) < plen:
            para += SPEC_WORDS[int(rng.integers(len(SPEC_WORDS)))] + " "
        para = para[:plen]
        filler = prompt_text(size - 3 * (plen + 2), 100 + i)
        third = len(filler) // 3
        content = (f"{filler[:third]}\"{para}\"{filler[third:2 * third]}"
                   f"\"{para}\"{filler[2 * third:]}\"{para}\"{ask}")
        out.append(dict(bare, messages=[{"role": "user",
                                         "content": content}]))
    return out


def chat_prompts(card, bodies: list) -> list:
    """The token ids each chat body's prompt becomes (the card's
    preprocessor and chat template)."""
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.protocols.openai import ChatCompletionRequest
    pre = OpenAIPreprocessor(card)
    return [pre.preprocess_chat(ChatCompletionRequest.from_json(b),
                                f"p-{i}")[0].token_ids
            for i, b in enumerate(bodies)]


def drive_ids(engine, prompts: list, tag: str, together: bool = False,
              top: int = 0) -> dict:
    """The prompts (token ids) greedy, MAX_TOKENS each, through
    engine.add_request / step: one at a time (each scheduled alike in
    every engine), or all admitted together. With `top`, each token's top
    logprobs ride along. Returns {"streams": [(ids, top-1 less top-2 per
    token or None)], "seconds", "tokens"}."""
    from dynamo_tpu_torch.engine.scheduler import EngineRequest, SamplingParams
    params = SamplingParams(max_tokens=MAX_TOKENS, temperature=0.0,
                            logprobs=top or None)
    streams = {}
    t0 = time.perf_counter()

    def run(rids):
        while any(not streams[r][2] for r in rids):
            for ev in engine.step():
                ids, gaps, _ = streams[ev.request_id]
                if ev.token is not None:
                    ids.append(ev.token)
                    tops = ev.top_logprobs or []
                    gaps.append(tops[0][1] - tops[1][1] if len(tops) > 1
                                else None)
                if ev.finished:
                    streams[ev.request_id] = (ids, gaps, True)
    rids = [f"{tag}-{i}" for i in range(len(prompts))]
    for rid, p in zip(rids, prompts):
        streams[rid] = ([], [], False)
        engine.add_request(EngineRequest(rid, list(p), params))
        if not together:
            run([rid])
    run(rids)
    engine._sync_stream()
    took = time.perf_counter() - t0
    out = [(streams[r][0], streams[r][1]) for r in rids]
    return {"streams": out, "seconds": took,
            "tokens": sum(len(ids) for ids, _ in out)}


def prime(engine, prompts: list) -> None:
    """Each prompt once with max_tokens 1, one at a time: its full pages
    sealed in the prefix cache, so that every later run of it prefills
    the same tail over the same cached pages (the same computation in
    every engine and round)."""
    from dynamo_tpu_torch.engine.scheduler import SamplingParams
    for i, p in enumerate(prompts):
        engine.generate(list(p), SamplingParams(max_tokens=1,
                                                temperature=0.0),
                        f"prime-{i}")


def hold_ids(name: str, got: list, ref: list, tie: float = NEAR_TIE) -> list:
    """Each stream (ids) against the reference's (ids, gaps): equal, or
    first differing at a position where the reference's top-1 less top-2
    is at most `tie` (an eos or stop there ends one stream early). Returns
    the first differences [position, gap] (None where equal)."""
    firsts = []
    for i, ((ids, _), (rids, gaps)) in enumerate(zip(got, ref)):
        d = next((j for j, (a, b) in enumerate(zip(ids, rids)) if a != b),
                 None)
        if d is None and len(ids) != len(rids):
            d = min(len(ids), len(rids))
        if d is None:
            firsts.append(None)
            continue
        gap = gaps[d] if d < len(gaps) else None
        check(gap is not None and gap <= tie,
              f"{name}: stream {i} leaves the plain engine's at token {d} "
              f"(of {len(rids)}), where its top-1 less top-2 is {gap} "
              f"(a near tie is <= {tie})")
        firsts.append([d, round(gap, 6)])
    return firsts


class SpecRecorder:
    """Wraps an engine's window commit, verify and cost gate: the decode
    steps of the windows it commits (the rows of each committed token
    array), each verify block's shape (S, K + 1), drafts and committed
    tokens, the gate's decisions (drafts passed on their cost, passed as a
    probe, refused), and the input buffers of the verify with the most live
    rows (cloned: `hold_verify_attention` runs the kernels on them)."""

    def __init__(self, engine):
        self.engine = engine
        self.window_steps = 0
        self.blocks = []
        self.gate = {"cost": 0, "probe": 0, "refused": 0}
        self.inputs, self._live = None, 0
        commit, verify = engine._commit_window, engine._run_spec_decode
        worthwhile, bound_ok = engine._spec_worthwhile, engine._spec_bound_ok

        def committed(plan, toks, *a, **kw):
            self.window_steps += toks.shape[0]
            return commit(plan, toks, *a, **kw)

        def verified(plan, drafts, counters, min_toks):
            events = verify(plan, drafts, counters, min_toks)
            s, kp1 = len(plan.seqs), engine.cfg.spec_k + 1
            self.blocks.append({
                "shape": (s, kp1), "drafts": sum(map(len, drafts)),
                "tokens": sum(ev.token is not None for ev in events)})
            live = sum(seq is not None for seq in plan.seqs)
            if live >= self._live:
                bufs = engine.graphs._inputs[
                    ("verify", s, kp1, plan.page_table.shape[1])]
                self.inputs = {n: bufs[n].clone() for n in
                               ("positions", "page_table", "write_idx")}
                self._live = live
            return events

        def gated(plan, d_total):
            n_live, nw, window, price = engine._spec_gate_terms(plan)
            cost = ((n_live + engine._spec_acc_ema * d_total) * window
                    > n_live * nw * price)
            ok = worthwhile(plan, d_total)
            self.gate["cost" if cost else "probe" if ok else "refused"] += 1
            return ok

        def bounded(plan):
            ok = bound_ok(plan)
            if not ok and any(seq is not None for seq in plan.seqs):
                self.gate["refused"] += 1
            return ok
        engine._commit_window = committed
        engine._run_spec_decode = verified
        engine._spec_worthwhile = gated
        engine._spec_bound_ok = bounded

    def reset(self) -> None:
        self.window_steps = 0
        self.blocks = []
        self.gate = dict.fromkeys(self.gate, 0)

    def detach(self) -> None:
        for name in ("_commit_window", "_run_spec_decode",
                     "_spec_worthwhile", "_spec_bound_ok"):
            delattr(self.engine, name)


def verify_product_launches(cfg, s: int, kp1: int) -> dict:
    """The W8A16 launches one verify of an [S, K + 1] block makes on an
    int8-weight dense model, from its shape and ops/quant.py's routes:
    past GEMV_MAX_M rows each of a layer's 7 products and the head (all S
    x (K + 1) rows: the verify reads every position's logits) is one
    tensor-core launch, else the decode kernel's 4 a layer + 1."""
    from dynamo_tpu_torch.ops import quant
    if s * kp1 > quant.GEMV_MAX_M:
        return {LARGE_M: 7 * cfg.num_layers + 1, W8A16: 0}
    return {LARGE_M: 0, W8A16: decode_w8a16_launches(cfg)}


def replay_ms(graphs, key, dead: str, n: int = 20) -> float:
    """CUDA-event ms per replay of the graph at `key`, its `dead` input
    filled with -1 first (every row's writes go to the scratch page; the
    same launches and reads). Run after the gated runs: the inputs are
    left so."""
    import torch
    graph = graphs._graphs[key][0]
    for bufs in graphs._inputs.values():
        if dead in bufs:
            bufs[dead].fill_(-1)
    with torch.cuda.stream(graphs.stream):
        graph.replay()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            graph.replay()
        end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def hold_verify_attention(name: str, engine, inputs: dict,
                          quant: bool = False) -> list:
    """The kernels of a verify on one verify's inputs as the engine ran
    them (`SpecRecorder.inputs`: its S x (K + 1) rows, each slot's page
    table repeated K + 1 times, prefix lens = positions[:, 0]), over the
    engine's cache (`quant`: int8 pages and scales quantized from the
    pages the verify reads, as an int8 cache stores them), layers 0 and
    L - 1, q seeded:
    (1) the ragged kernel in prefix mode on those rows against its plain
    version (2e-3 with a bf16 q, 1e-4 f32);
    (2) `block_attention`, the block's rows read back from the cache at
    positions prefix + j, against ops/attention.paged_attention over
    positions [0, prefix + j] on the same inputs, at the block's real
    tokens (normalised in q's dtype: 1e-2 bf16, 1e-4 f32).
    Not a path run: its launches are no path's. Returns the kernel's max
    abs errors (acc, m, l) and block_attention's."""
    import torch
    from dynamo_tpu_torch.models.llama import torch_dtype
    from dynamo_tpu_torch.ops import attention as att
    from dynamo_tpu_torch.ops import paged_attention as pa
    from dynamo_tpu_torch.ops.kv_quant import dequantize_rows, quantize_rows
    cfg, ps = engine.model_cfg, engine.cfg.page_size
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dev = engine.device
    pt, widx = inputs["page_table"], inputs["write_idx"]
    prefix = inputs["positions"][:, 0].contiguous()
    s, t = widx.shape
    real = widx >= 0
    check(bool(real.any()), f"{name}: the recorded verify has no real row")
    kc, vc = engine.cache["k"], engine.cache["v"]  # dynalint: kv-codec
    qdt = torch_dtype(cfg)
    g = torch.Generator(device=dev).manual_seed(17)
    q = torch.randn((s, t, h, hd), generator=g, device=dev).to(qdt)
    pos = prefix[:, None].long() + torch.arange(t, device=dev)[None, :]
    if quant:
        # the pages the verify reads, renumbered, as int8 pages
        ids, inv = torch.unique(pt.long(), return_inverse=True)
        lpt = inv.to(torch.int32)
    else:
        lpt = pt
    col = torch.clamp(pos // ps, max=pt.shape[1] - 1)
    slot = (lpt.long().gather(1, col) * ps + pos % ps).reshape(-1)
    tol, btol = (2e-3, 1e-2) if qdt == torch.bfloat16 else (1e-4, 1e-4)
    kind = "int8 pages" if quant else f"{str(kc.dtype)[6:]} pages"
    errs, berrs = [], []
    for layer in sorted({0, cfg.num_layers - 1}):
        if quant:
            (k8, ks), (v8, vs) = (quantize_rows(c[layer][:, ids])
                                  for c in (kc, vc))
            lk, lv, lks, lvs, li = k8[None], v8[None], ks[None], vs[None], 0
        else:
            lk, lv, lks, lvs, li = kc, vc, None, None, layer
        rows = q.reshape(s * t, h, hd)
        rpt = lpt.repeat_interleave(t, dim=0)
        rlen = prefix.repeat_interleave(t).to(torch.int32)
        got = pa.decode_paged_attention_prefix(rows, lk, lv, li, rpt, rlen,
                                               lks, lvs)
        want = pa._ragged_plain(rows, lk, lv, li, rpt, rlen, lks, lvs)
        errs += compare(f"{name}: the ragged kernel on a verify's {s * t} "
                        f"rows, {kind}, layer {layer}",
                        zip(("acc", "m", "l"), got, want), tol)

        def block(cache, scale):
            r = cache[li].reshape(hkv, -1, hd)[:, slot]
            r = r.reshape(hkv, s, t, hd).permute(1, 2, 0, 3)
            if scale is not None:
                sc = scale[li].reshape(hkv, -1)[:, slot]
                r = dequantize_rows(r, sc.reshape(hkv, s, t).permute(1, 2, 0),
                                    qdt)
            return r.contiguous()
        got = pa.block_attention(q, block(lk, lks), block(lv, lvs), lk, lv,
                                 li, lpt, prefix, lks, lvs)
        want = att.paged_attention(
            q, lk[li], lv[li], lpt, prefix + real.sum(1).to(prefix.dtype),
            pos.to(torch.int32), *((lks[li], lvs[li]) if quant else ()))
        berrs += compare(f"{name}: block_attention on a verify's [{s}, {t}] "
                         f"block, {kind}, layer {layer}",
                         [("out", got[real], want[real])], btol)
    print(f"{name}: a verify's inputs ([{s}, {t}] block, "
          f"{int(real.any(1).sum())} live slots, prefixes "
          f"{prefix.tolist()}), {kind}: the ragged kernel on its {s * t} "
          f"rows vs plain, max_abs_err acc/m/l "
          f"{' '.join(f'{e:.3g}' for e in errs)} (tol {tol}); "
          f"block_attention vs paged_attention "
          f"{' '.join(f'{e:.3g}' for e in berrs)} (tol {btol})", flush=True)
    return [max(errs), max(berrs)]


def spec_round(name: str, engine, rec, prompts: list, ref: list, tag: str,
               device: str, tie: float = NEAR_TIE) -> dict:
    """One gated round of a speculative engine over the prompts, one at a
    time, with every launch count set to 0 before it: the streams held to
    the plain engine's (`hold_ids`), every logit finite, each verify one
    graph replay, and the ragged kernel launched target layers x (the
    committed windows' decode steps + the verify blocks: a block's S x (K
    + 1) rows attend their prefix in one launch a layer) + the graphs'
    warm-ups + a draft model's:
    draft layers x spec_k a proposal replay, draft layers a one-token
    catch-up (the kernel's inclusive mode), its graphs' warm-ups."""
    rec.reset()
    reset_launch_counts()
    gr = engine.graphs
    cap0, rep0 = gr.captured, gr.replay_paths.get("verify", 0)
    keys0 = set(gr._graphs)
    draft = engine._draft
    if draft is not None:
        dg = draft.graphs
        d0 = (dg.replays, dg.replay_launches[RAGGED],
              dg.warmup_launches[RAGGED], draft.catchup_buckets.get(1, 0))
    warm0 = dict(gr.warmup_launches)
    spec0 = (engine.spec_steps, engine.spec_proposed_tokens,
             engine.spec_accepted_tokens)
    # the cost gate starts every round from the same state
    engine._spec_acc_ema, engine._spec_gate_skips = 1.0, 0
    run = drive_ids(engine, prompts, tag)
    launches = launch_counts()
    new_keys = [str(k) for k in gr._graphs if k not in keys0]
    print(f"{name}: {len(rec.blocks)} verify blocks, {rec.window_steps} "
          f"window steps, {run['tokens']} tokens in {run['seconds']:.2f} s; "
          f"the cost gate {json.dumps(rec.gate)}; graphs captured "
          f"{new_keys}", flush=True)
    firsts = hold_ids(name, run["streams"], ref, tie)
    check(engine.logits_nonfinite_steps() == 0, f"{name}: a non-finite "
          "logit")
    steps = engine.spec_steps - spec0[0]
    proposed = engine.spec_proposed_tokens - spec0[1]
    accepted = engine.spec_accepted_tokens - spec0[2]
    replays = gr.replay_paths.get("verify", 0) - rep0
    nl = engine.model_cfg.num_layers
    want = nl * (rec.window_steps + len(rec.blocks)) + (
        gr.warmup_launches[RAGGED] - warm0[RAGGED])
    draft_ragged = draft_replays = 0
    if draft is not None:
        draft_replays = dg.replays - d0[0]
        draft_ragged = dg.replay_launches[RAGGED] - d0[1]
        if device == "cuda":
            check(draft.path == "ragged" and draft_ragged
                  == draft.cfg.num_layers * engine.cfg.spec_k * draft_replays,
                  f"{name}: the draft ({draft.path}) launched the ragged "
                  f"kernel {draft_ragged} times in {draft_replays} proposal "
                  f"replays")
        want += draft_ragged + dg.warmup_launches[RAGGED] - d0[2] + (
            draft.cfg.num_layers * (draft.catchup_buckets.get(1, 0) - d0[3]))
    verify_ragged = [c.get(RAGGED, 0) for k, c in gr.captured_calls().items()
                     if k[0] == "verify"]
    if device == "cuda":
        check(replays == len(rec.blocks), f"{name}: {replays} verify "
              f"replays for {len(rec.blocks)} verify blocks")
        check(all(n == nl for n in verify_ragged), f"{name}: verify graphs "
              f"hold {verify_ragged} ragged calls, not {nl} (a layer each)")
        check(launches[RAGGED] == want, f"{name}: {launches[RAGGED]} ragged "
              f"launches, derived {nl} layers x ({rec.window_steps} window "
              f"steps + {len(rec.blocks)} verify blocks) + warm-ups = "
              f"{want}")
    decode_tokens = run["tokens"] - len(prompts)
    check(sum(b["tokens"] for b in rec.blocks) <= decode_tokens,
          f"{name}: the verify blocks committed more tokens than the run")
    return {"streams": run["streams"], "seconds": run["seconds"],
            "tokens": run["tokens"], "first_differences": firsts,
            "verify_blocks": len(rec.blocks), "verify_replays": replays,
            "draft_replays": draft_replays,
            "draft_ragged_launches": draft_ragged,
            "window_steps": rec.window_steps, "gate": dict(rec.gate),
            "captured": gr.captured - cap0,
            "captured_keys": new_keys,
            "launches": launches, "spec_steps": steps,
            "proposed": proposed, "accepted": accepted,
            "acceptance": accepted / proposed if proposed else None,
            "verify_tokens": sum(b["tokens"] for b in rec.blocks)}


def phase_spec_ngram(smi: str, params, cfg, card, device: str = "cuda",
                     n_int8: int = 2) -> dict:
    """17a (see the docstring at the top)."""
    from dynamo_tpu_torch.engine import spec as spec_mod
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import NativeEngine
    name = "17a spec ngram"
    eos = set(card.eos_token_ids)
    prompts = chat_prompts(card, spec_chats(card))
    lens = [len(p) for p in prompts]
    ecfg = EngineConfig(max_model_len=4096)
    scfg = dataclasses.replace(ecfg, spec_decode="ngram", spec_k=SPEC_K)
    t0 = time.perf_counter()
    plain = NativeEngine(cfg, ecfg, params=params, eos_token_ids=eos,
                         device=device)
    prime(plain, prompts)
    ref = drive_ids(plain, prompts, "ref", top=CKPT_TOP)
    # the 8 together twice: the first run captures their window graphs
    drive_ids(plain, prompts, "plain8w", together=True)
    plain_together = drive_ids(plain, prompts, "plain8", together=True)
    window_ms = steady_ms_per_step(plain, prompts) if device == "cuda" \
        else None
    plain.cache = None
    del plain
    empty_cache(device)
    engine = NativeEngine(cfg, scfg, params=params, eos_token_ids=eos,
                          device=device)
    prime(engine, prompts)
    rec = SpecRecorder(engine)
    cold = spec_round(f"{name} cold", engine, rec, prompts,
                      ref["streams"], "cold", device)
    warm = spec_round(f"{name} warm", engine, rec, prompts,
                      ref["streams"], "warm", device)
    check(warm["captured"] == 0, f"{name}: {warm['captured']} graphs "
          f"captured in the warm round: {warm['captured_keys']}")
    if device == "cuda":
        check(cold["verify_replays"] + warm["verify_replays"] > 0,
              f"{name}: no verify ran in either round")
    engine._spec_acc_ema, engine._spec_gate_skips = 1.0, 0
    drive_ids(engine, prompts, "spec8w", together=True)
    engine._spec_acc_ema, engine._spec_gate_skips = 1.0, 0
    rec.reset()
    together = drive_ids(engine, prompts, "spec8", together=True)
    gate8 = dict(rec.gate)
    rec.detach()
    # the kernels on the recorded verify's inputs (its 8 x 5 rows once the
    # 8 chats ran together), bf16 pages and int8 ones
    verify_errs = [max(e) for e in zip(*(
        hold_verify_attention(name, engine, rec.inputs, quant)
        for quant in (False, True)))]
    # each verify graph's replay: its page-table width sets the gather
    vkeys = sorted(k for k in engine.graphs._graphs if k[0] == "verify")
    verify_ms = {}
    if device == "cuda":
        verify_ms = {f"Pb {k[3]}": replay_ms(engine.graphs, k, "write_idx")
                     for k in vkeys}
    engine.cache = None
    del engine
    empty_cache(device)
    # the gate's verify price on the card against this run's ratio
    steps = {k: v / window_ms for k, v in verify_ms.items()} if window_ms \
        else {}
    out = {"prompt_tokens": [min(lens), max(lens)], "cold": cold,
           "warm": warm, "window_ms_per_step": window_ms,
           "verify_ms": verify_ms, "verify_window_steps": steps,
           "gate_verify_steps": spec_mod.VERIFY_STEPS,
           "gate_together": gate8, "verify_max_abs_err": verify_errs,
           "tok_s_plain": plain_together["tokens"]
           / plain_together["seconds"],
           "tok_s_spec": together["tokens"] / together["seconds"]}
    for r in (cold, warm):
        del r["streams"]
    print(f"{name} ({cfg.name} {cfg.dtype}, {len(prompts)} chats of "
          f"{min(lens)}-{max(lens)} prompt tokens, one at a time): cold "
          f"{json.dumps({k: cold[k] for k in ('verify_blocks', 'window_steps', 'proposed', 'accepted', 'acceptance', 'first_differences', 'gate', 'captured', 'seconds')})}; "
          f"warm {json.dumps({k: warm[k] for k in ('verify_blocks', 'window_steps', 'proposed', 'accepted', 'acceptance', 'first_differences', 'gate', 'captured', 'seconds')})}; "
          f"verify replay ms [8, 5] {json.dumps(verify_ms)}, window "
          f"{window_ms} ms a decode step (8 slots): a verify "
          f"{json.dumps({k: round(v, 3) for k, v in steps.items()})} window "
          f"steps (the gate prices it at {spec_mod.VERIFY_STEPS}); 8 "
          f"together (warm): {out['tok_s_spec']:.1f} tok/s with "
          f"speculation (the gate {json.dumps(gate8)}), "
          f"{out['tok_s_plain']:.1f} without ({time.perf_counter() - t0:.1f}"
          f" s) [{smi}]", flush=True)
    out["int8"] = spec_ngram_int8(smi, params, cfg, card, prompts[:n_int8],
                                  device)
    return out


def spec_ngram_int8(smi: str, params, cfg, card, prompts: list,
                    device: str) -> dict:
    """17a's int8-weight leg: the plain and the ngram engine on int8
    weights (quantized from the same bf16 ones), one at a time; the
    streams held to the plain int8 engine's, and the tensor-core launches
    as the prefill shapes and the verify blocks' shapes derive them."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import NativeEngine
    from dynamo_tpu_torch.ops.quant import quantize_params
    name = "17a spec ngram int8 weights"
    eos = set(card.eos_token_ids)
    qcfg = dataclasses.replace(cfg, quant="int8")
    qparams = quantize_params(params)
    ecfg = EngineConfig(max_model_len=4096)
    plain = NativeEngine(qcfg, ecfg, params=qparams, eos_token_ids=eos,
                         device=device)
    prime(plain, prompts)
    ref = drive_ids(plain, prompts, "ref", top=CKPT_TOP)
    plain.cache = None
    del plain
    engine = NativeEngine(qcfg, dataclasses.replace(
        ecfg, spec_decode="ngram", spec_k=SPEC_K), params=qparams,
        eos_token_ids=eos, device=device)
    prime(engine, prompts)
    rec = SpecRecorder(engine)
    shapes = StepShapes(engine)
    warm0 = dict(engine.graphs.warmup_launches)
    rep0 = dict(engine.graphs.replay_launches)
    run = spec_round(name, engine, rec, prompts, ref["streams"], "q",
                     device)
    shapes.detach()
    rec.detach()
    gr = engine.graphs
    derived = int8_product_launches(qcfg, shapes.shapes)
    for b in rec.blocks:
        for k, v in verify_product_launches(qcfg, *b["shape"]).items():
            derived[k] = derived.get(k, 0) + v
    got = run["launches"]
    large = (got[LARGE_M] - (gr.warmup_launches[LARGE_M] - warm0[LARGE_M]))
    if device == "cuda":
        check(large == derived[LARGE_M] and got[DEQUANT] == 0,
              f"{name}: {large} tensor-core launches outside the warm-ups "
              f"(derived {derived[LARGE_M]}: prefill shapes "
              f"{shapes.shapes}, {len(rec.blocks)} verify blocks), "
              f"{got[DEQUANT]} dequantize launches")
    engine.cache = None
    del engine, qparams
    empty_cache(device)
    del run["streams"]
    print(f"{name} ({len(prompts)} chats): "
          f"{json.dumps({k: run[k] for k in ('verify_blocks', 'window_steps', 'proposed', 'accepted', 'first_differences', 'launches')})}; "
          f"tensor-core launches {large} = derived {derived[LARGE_M]} "
          f"[{smi}]", flush=True)
    return {**run, "large_m_derived": derived[LARGE_M],
            "large_m_replays": gr.replay_launches[LARGE_M] - rep0[LARGE_M]}


def phase_spec_exact(smi: str, model: str = "llama3-1b",
                     device: str = "cuda", n: int = 2) -> dict:
    """17b (see the docstring at the top)."""
    from dynamo_tpu_torch.engine import config as cfg_mod
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import NativeEngine
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.run import build_card
    name = "17b spec identical draft f32"
    card = build_card(model)
    reg = f"{model}-f32"
    cfg = dataclasses.replace(card.model_config(), dtype="float32",
                              name=reg)
    cfg_mod._CONFIGS[reg] = cfg
    eos = set(card.eos_token_ids)
    prompts = chat_prompts(card, spec_chats(card, n=n))
    ecfg = EngineConfig(max_model_len=4096)
    t0 = time.perf_counter()
    params = llama.init_params(cfg, device, seed=0)
    try:
        plain = NativeEngine(cfg, ecfg, params=params, eos_token_ids=eos,
                             device=device)
        prime(plain, prompts)
        ref = drive_ids(plain, prompts, "ref", top=CKPT_TOP)
        plain.cache = None
        del plain
        engine = NativeEngine(cfg, dataclasses.replace(
            ecfg, spec_decode="draft", spec_draft_model=reg, spec_k=SPEC_K),
            params=params, eos_token_ids=eos, device=device, seed=0)
        draft = engine._draft
        check(draft.path == engine.decode_path == "ragged",
              f"{name}: the draft decodes through {draft.path}")
        prime(engine, prompts)
        rec = SpecRecorder(engine)
        dg = draft.graphs
        run = spec_round(name, engine, rec, prompts, ref["streams"], "x",
                         device, tie=SPEC_TIE_F32)
        rec.detach()
        acc = run["acceptance"]
        check(acc is not None and acc >= 0.99, f"{name}: acceptance {acc} "
              f"({run['accepted']} of {run['proposed']}): a stale draft row")
        run["verify_max_abs_err"] = hold_verify_attention(name, engine,
                                                          rec.inputs)
        times = {}
        if device == "cuda":
            times = {"verify_ms": {
                f"Pb {k[3]}": replay_ms(engine.graphs, k, "write_idx")
                for k in sorted(engine.graphs._graphs) if k[0] == "verify"},
                "propose_ms": {f"Pb {k[2]}": replay_ms(dg, k, "max_write")
                               for k in sorted(dg._graphs)}}
        engine.cache = None
        del engine, draft
    finally:
        cfg_mod._CONFIGS.pop(reg, None)
    del params
    empty_cache(device)
    del run["streams"]
    print(f"{name} ({model} at full width and depth, {len(prompts)} chats, "
          f"draft = target): "
          f"{json.dumps({k: run[k] for k in ('verify_blocks', 'window_steps', 'proposed', 'accepted', 'acceptance', 'first_differences', 'gate')})}; "
          f"draft ragged launches {run['draft_ragged_launches']} in "
          f"{run['draft_replays']} proposal replays; {json.dumps(times)} "
          f"({time.perf_counter() - t0:.1f} s) [{smi}]", flush=True)
    return {**run, **times}


async def spec_served(port: int, bodies: list) -> list:
    """17c's chats over HTTP one at a time (no logprobs: a logprob plan
    never speculates): [(text, completion tokens, finish reason)]."""
    out = []
    for i, body in enumerate(bodies):
        if body.get("stream"):
            st = await _stream_into(port, body, Stream(f"spec-{i}"))
            check(st.done and not st.errors and len(st.finish) == 1
                  and st.usage, f"17c: stream {i} ended {st.finish} "
                  f"{st.errors} done={st.done}")
            out.append((st.text, st.usage["completion_tokens"],
                        st.finish[0]))
            continue
        status, _, raw = await _http(port, "POST", "/v1/chat/completions",
                                     body)
        check(status == 200, f"17c: request {i}: {status} {raw[:200]}")
        res = json.loads(raw)
        ch = res["choices"][0]
        out.append((ch["message"]["content"],
                    res["usage"]["completion_tokens"], ch["finish_reason"]))
    return out


def phase_spec_entry(smi: str, path: str, bodies: list, ref: list, tok,
                     plain_s: float, draft: str = "llama3-1b",
                     extra=()) -> dict:
    """17c (see the docstring at the top), run by 15b while its llama3-8b
    directory is on disk: run.py serves the directory with `draft`
    proposing, through its Llama-3-form tokenizer (every id decodes), the
    chats without logprobs; each held to 15b's reference (`hold_texts`).
    `plain_s`: 15b's plain run.py over the same chats (with logprobs)."""
    name = "17c run.py --spec-decode draft"
    t0 = time.perf_counter()
    plain = [{k: v for k, v in b.items()
              if k not in ("logprobs", "top_logprobs")} for b in bodies]
    srv = serve_spec(path, draft, plain, extra)
    firsts = hold_texts(name, srv["results"], ref, tok)
    st = srv["stats"]
    dstats = st.get("draft", {})
    on_card = "--device" not in extra
    check(st.get("spec_steps", 0) > 0 and st.get("spec_proposed_tokens", 0) > 0
          and (not on_card or dstats.get("replays", 0) > 0),
          f"{name}: $STATS spec "
          f"counters {[st.get(k) for k in ('spec_steps', 'spec_proposed_tokens', 'spec_accepted_tokens')]}, draft {dstats}")
    draft_ragged = dstats["replay_launches"][RAGGED]
    if on_card:
        check(dstats["path"] == "ragged" and draft_ragged ==
              dstats["layers"] * dstats["k"] * dstats["replays"],
              f"{name}: the draft ({dstats['path']}) launched the ragged "
              f"kernel {draft_ragged} times in {dstats['replays']} proposal "
              f"replays of {dstats['layers']} layers x {dstats['k']} steps")
    tokens = sum(n for _, n, _ in srv["results"])
    phases = st.get("phases", {})

    def per(phase):
        p = phases.get(phase)
        return p["seconds"] * 1e3 / p["count"] if p else None
    out = {"first_differences": firsts, "ready_s": srv["ready_s"],
           "spec_steps": st["spec_steps"],
           "window_steps": st.get("decode_window_steps"),
           "proposed": st["spec_proposed_tokens"],
           "accepted": st["spec_accepted_tokens"],
           "draft_replays": dstats["replays"],
           "draft_ragged_launches": draft_ragged,
           "verify_replays": st["graphs"]["replay_paths"].get("verify", 0),
           "launches": st["kernel_launches"],
           "verify_ms_host": per("verify"), "propose_ms_host": per("propose"),
           "tok_s_spec": tokens / srv["seconds"],
           "tok_s_plain_run_py": sum(len(ids) for _, _, ids in ref) / plain_s,
           "seconds": time.perf_counter() - t0}
    print(f"{name} ({path}, draft {draft}; {len(bodies)} chats one at a "
          f"time, 4 SSE + 4 unary, no logprobs): {json.dumps(out)} [{smi}]",
          flush=True)
    return out


def hold_texts(name: str, served: list, ref: list, tok,
               lag: int = 2) -> list:
    """Each served (text, completion tokens, finish) against the
    reference's (entries, text, ids), through a tokenizer that decodes
    every id: the text equal to DecodeStream over the reference's ids and
    the token counts equal; else the first reference token whose text
    leaves the served text (or that the served stream lacks) must have a
    near tie (top-1 less top-2 <= NEAR_TIE) at it or at one of the `lag`
    tokens before it (a BPE token's text can be a prefix of another's, so
    the ids may part a token or two before the texts do). Returns the
    first differences [token, gap] (None where equal)."""
    from dynamo_tpu_torch.llm.tokenizer import DecodeStream
    firsts = []
    for i, ((text, n_tok, finish), (entries, _, ids)) in enumerate(
            zip(served, ref)):
        ds = DecodeStream(tok)
        want = [ds.step(t) for t in ids]
        if text == "".join(want) and n_tok == len(ids):
            firsts.append(None)
            continue
        d, acc = 0, ""
        while d < len(ids) and d < n_tok and text.startswith(acc + want[d]):
            acc += want[d]
            d += 1
        gaps = [e[2][0] - e[2][1] for e in entries[max(0, d - lag):d + 1]]
        check(gaps and min(gaps) <= NEAR_TIE, f"{name}: chat {i} ({n_tok} "
              f"tokens, {finish}) leaves the reference's text by token {d} "
              f"of {len(ids)}, with no near tie at it or the {lag} before "
              f"it (top-1 less top-2 {[round(x, 5) for x in gaps]})")
        firsts.append([d, round(min(gaps), 5)])
    return firsts


def serve_spec(path: str, draft: str, bodies: list, extra=()) -> dict:
    """`python -m dynamo_tpu_torch.run in=http:0 out=native <path>
    --spec-decode draft --spec-draft <draft>` as a process: READY, the
    bodies one at a time, its EXIT stats."""
    t0 = time.perf_counter()
    proc = Child("17c run.py", ["dynamo_tpu_torch.run", "in=http:0",
                                "out=native", path, "--spec-decode",
                                "draft", "--spec-draft", draft,
                                "--spec-k", str(SPEC_K), *extra])
    try:
        line = proc.wait_line("READY http=:", 600)
        ready_s = time.perf_counter() - t0
        port = int(re.match(r"READY http=:(\d+)", line).group(1))
        t1 = time.perf_counter()
        results = asyncio.run(asyncio.wait_for(spec_served(port, bodies),
                                               600))
        took = time.perf_counter() - t1
        code = proc.stop(signal.SIGINT, 120)
        exits = [x for x in proc.lines if x.startswith("EXIT ")]
        check(code == 0 and len(exits) == 1, f"17c run.py: exit {code}, "
              f"{exits or proc.tail()}")
    finally:
        proc.stop(signal.SIGKILL, 30)
    m = re.match(r"EXIT logits_nonfinite_steps=(\d+) stats=(.*)$", exits[0])
    check(m is not None and m.group(1) == "0", f"17c run.py: {exits[0][:300]}")
    return {"ready_s": ready_s, "results": results, "seconds": took,
            "stats": json.loads(m.group(2))}


def phase_spec(smi: str, device: str = "cuda") -> dict:
    """Phase 17: 17a on llama3-8b (seed 0, bf16), then 17b (17c runs in
    15b)."""
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.run import build_card
    t0 = time.perf_counter()
    card = build_card("llama3-8b")
    cfg = card.model_config()
    params = llama.init_params(cfg, device, seed=0)
    ngram = phase_spec_ngram(smi, params, cfg, card, device)
    del params
    empty_cache(device)
    t1 = time.perf_counter()
    exact = phase_spec_exact(smi, device=device)
    return {"ngram": ngram, "ngram_s": t1 - t0, "exact": exact,
            "exact_s": time.perf_counter() - t1}


# -- phase 18: vision (A11) ------------------------------------------------------

VL_MODEL = "qwen2-vl-7b"
VL_TOP = 8


def vl_pixels(seed: int, h: int = 448, w: int = 448):
    import numpy as np
    return np.random.default_rng(seed).random((h, w, 3), dtype=np.float32)


def npy_url(px) -> str:
    """An image as the preprocessor takes it: a base64 .npy data URL."""
    import base64
    import io

    import numpy as np
    buf = io.BytesIO()
    np.save(buf, px)
    return "data:application/x-npy;base64," + base64.b64encode(
        buf.getvalue()).decode()


def vl_body(lead: str, px, ask: str, stream: bool) -> dict:
    body = {"model": VL_MODEL, "max_tokens": MAX_TOKENS, "temperature": 0.0,
            "logprobs": True, "top_logprobs": VL_TOP, "messages": [{
                "role": "user", "content": [
                    {"type": "text", "text": lead},
                    {"type": "image_url", "image_url": {"url": npy_url(px)}},
                    {"type": "text", "text": ask}]}]}
    if stream:
        body.update(stream=True, stream_options={"include_usage": True})
    return body


# 18b's chats by role: chat 4 has chat 0's exact text with another image,
# chat 7 chat 0's image and leading text with another question
VL_LABELS = ("noise", "horizontal ramp", "vertical ramp", "checkerboard",
             "chat 1's text, a flat colour", "300 x 500", "0-255",
             "chat 1's image again, another question")
VL_OTHER_IMAGE, VL_SAME_IMAGE = 4, 7


def vl_images() -> list:
    """18b's 8 images, f32 [H, W, 3]: 5 distinct 448 x 448 ones (noise, a
    horizontal and a vertical ramp under noise, a checkerboard of 56-pixel
    squares, a flat colour), a 300 x 500 one (noise on a grey), one in 0-255
    (a diagonal ramp), then the first again."""
    import numpy as np
    yy, xx = np.mgrid[0:448, 0:448].astype(np.float32) / 448.0
    noise = vl_pixels(1801) * 0.2
    board = ((np.mgrid[0:448, 0:448] // 56).sum(0) % 2).astype(np.float32)
    out = [vl_pixels(1800),
           np.stack([xx, 1 - xx, xx * 0.5], -1) * 0.8 + noise,
           np.stack([yy, yy * 0.5, 1 - yy], -1) * 0.8 + noise,
           np.repeat(board[..., None], 3, -1),
           np.broadcast_to(np.float32([0.85, 0.25, 0.4]), (448, 448, 3)),
           0.25 + 0.5 * vl_pixels(1805, 300, 500),
           np.round(np.repeat(((xx + yy) / 2)[..., None], 3, -1) * 255.0)]
    out.append(out[0])
    return [np.ascontiguousarray(x, np.float32) for x in out]


def vl_chats() -> list:
    """18b's 8 image chats: a text part (150-213 bytes), one image of
    vl_images (an .npy data URL), a question (40-61 bytes); greedy,
    MAX_TOKENS, top-8 logprobs; even ones streamed. Chat 4 has chat 0's
    text, chat 7 chat 0's image and leading text with another question;
    the 300 x 500 image (chat 5) the preprocessor resizes, the 0-255 one
    (chat 6) it normalises."""
    lead = [prompt_text(150 + 9 * i, 1800 + i) for i in range(8)]
    ask = [prompt_text(40 + 3 * i, 1900 + i) for i in range(8)]
    lead[VL_OTHER_IMAGE], ask[VL_OTHER_IMAGE] = lead[0], ask[0]
    lead[VL_SAME_IMAGE] = lead[0]
    images = vl_images()
    return [vl_body(lead[i], images[i], ask[i], i % 2 == 0)
            for i in range(8)]


def vl_preprocessed(card, bodies: list) -> list:
    """Each body as the port's preprocessor makes it (token ids with the
    placeholders, image parts)."""
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.protocols.openai import ChatCompletionRequest
    pre = OpenAIPreprocessor(card)
    return [pre.preprocess_chat(ChatCompletionRequest.from_json(
        {k: v for k, v in b.items() if k not in ("stream",
                                                 "stream_options")}),
        f"vl-{i}")[0] for i, b in enumerate(bodies)]


def vl_identities(pre, n_patch: int) -> list:
    """A prompt as identities: its token ids, each image position as (the
    image bytes' digest, its index in the span). A position's KV is the same
    in two prompts when its identity and every one before it are."""
    import hashlib
    ids = list(pre.token_ids)
    for p in pre.mm_parts or ():
        digest = hashlib.sha256(p.data).hexdigest()
        for j in range(n_patch):
            ids[p.offset + j] = (digest, j)
    return ids


def expected_prefix_pages(prompts: list, page: int, seen=()) -> list:
    """Each prompt's prefix-cache hits in pages when the prompts arrive one
    at a time after `seen`: the whole pages of its longest common prefix
    with an earlier prompt (inside that prompt), at most (len - 1) // page
    (the last token is always computed). From the identities alone."""
    out, before = [], list(seen)
    for ids in prompts:
        best = 0
        for old in before:
            n = 0
            for a, b in zip(ids, old):
                if a != b:
                    break
                n += 1
            best = max(best, min(n, len(old)) // page)
        out.append(min(best, (len(ids) - 1) // page))
        before.append(ids)
    return out


def tree_cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: tree_cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


def phase_vision_tower(smi: str) -> dict:
    """18a: qwen2-vl-7b's tower, f32 draws from seed 0: on the card
    against the CPU at full width and 2 of its layers (rtol = atol =
    1e-4); the same draws in bf16 against f32 on the card at full depth
    (every patch row's cosine >= 0.999); the bf16 encode time of one image
    and of 4 beside the FLOP bound."""
    import torch
    from dynamo_tpu_torch.engine.config import get_model_config
    from dynamo_tpu_torch.models import vision
    name = "phase 18a (the vision tower)"
    cfg = get_model_config(VL_MODEL)
    vc = cfg.vision
    rec = {}
    f32 = dataclasses.replace(cfg, dtype="float32")
    two = dataclasses.replace(f32, vision=dataclasses.replace(
        vc, num_layers=2))
    shallow = vision.init_params(
        two, "cuda", torch.Generator(device="cuda").manual_seed(0))
    px = torch.from_numpy(vl_pixels(1800)[None])
    card_out = vision.encode(shallow, two, px.cuda()).cpu()
    cpu_out = vision.encode(tree_to(shallow, "cpu"), two, px)
    rec["f32_card_vs_cpu_max_abs_err"] = compare(
        f"{name}: f32, 2 layers, card vs CPU", [("embeds", card_out,
                                                 cpu_out)], 1e-4)[0]
    del shallow, card_out, cpu_out
    full = vision.init_params(
        f32, "cuda", torch.Generator(device="cuda").manual_seed(0))
    half = tree_cast(full, torch.bfloat16)
    bf = dataclasses.replace(cfg, dtype="bfloat16")
    want = vision.encode(full, f32, px.cuda())[0]
    got = vision.encode(half, bf, px.cuda())[0].float()
    cos = torch.nn.functional.cosine_similarity(got, want, dim=-1)
    rec["bf16_vs_f32_min_cos"] = float(cos.min())
    rec["bf16_vs_f32_max_abs_diff"] = float((got - want).abs().max())
    rec["f32_max_abs"] = float(want.abs().max())
    check(bool(torch.isfinite(got).all())
          and rec["bf16_vs_f32_min_cos"] >= 0.999,
          f"{name}: bf16 against f32 at full depth: min patch-row cosine "
          f"{rec['bf16_vs_f32_min_cos']:.6f} (gate >= 0.999)")
    del full, want, got
    n = vision.num_patches(vc)
    d, f = vc.hidden_size, vc.intermediate_size
    # q, k, v, o, the two MLP products and P.V / scores, the patch embed
    # and the projection, 2 FLOPs a multiply-add
    rec["flop_per_image"] = 2 * n * (
        vc.num_layers * (4 * d * d + 2 * n * d + 2 * d * f)
        + vc.patch_size ** 2 * 3 * d + d * cfg.hidden_size)
    for b in (1, 4):
        x = torch.rand((b, vc.image_size, vc.image_size, 3),
                       generator=torch.Generator(device="cuda").manual_seed(b),
                       device="cuda")
        rec[f"encode_ms_{b}"] = cuda_ms(
            lambda i: vision.encode(half, bf, x), 5, warmup=2)
        rec[f"bound_ms_{b}"] = b * rec["flop_per_image"] / PEAK_FLOPS[
            "bfloat16"] * 1e3
    print(f"{name}: f32 card vs CPU at 2 layers max_abs_err "
          f"{rec['f32_card_vs_cpu_max_abs_err']:.3g} (tol 1e-4); bf16 vs f32 "
          f"at {vc.num_layers} layers min patch-row cosine "
          f"{rec['bf16_vs_f32_min_cos']:.6f} (gate 0.999), max |diff| "
          f"{rec['bf16_vs_f32_max_abs_diff']:.4g} (f32 max |x| "
          f"{rec['f32_max_abs']:.4g}); bf16 encode {rec['encode_ms_1']:.2f} "
          f"ms an image, {rec['encode_ms_4']:.2f} ms a batch of 4 "
          f"({rec['flop_per_image'] / 1e12:.3f} TFLOP an image; bound "
          f"{rec['bound_ms_1']:.3f} / {rec['bound_ms_4']:.3f} ms at 989 "
          f"TFLOP/s) [{smi}]", flush=True)
    del half
    torch.cuda.empty_cache()
    return rec


def phase_vision_http(smi: str, card, bodies: list, prompts: list) -> dict:
    """18b: `run.py in=http:0 out=native qwen2-vl-7b` as a process (bf16,
    seed 0, run.py's EngineConfig) serves the 8 image chats one at a time,
    twice (a cold round, then a measured one)."""
    name = "phase 18b (image chats over HTTP)"
    cfg = card.model_config()
    page = card.kv_page_size
    served = serve_checkpoint(VL_MODEL, bodies, name=f"{name} (run.py)",
                              rounds=2)
    st, rounds = served["stats"], served["rounds"]
    rec = {"ready_s": served["ready_s"]}
    for k, rnd in enumerate(rounds):
        for i, (entries, _) in enumerate(rnd["results"]):
            check(len(entries) == MAX_TOKENS, f"{name}: round {k} chat {i} "
                  f"({VL_LABELS[i]}): {len(entries)} tokens, not "
                  f"{MAX_TOKENS} (max_tokens)")
    # the same text with another image: the streams (tokens, logprobs and
    # top logprobs) must differ; an image that never reached the prefill
    # leaves them equal, bit for bit
    cold = [entries for entries, _ in rounds[0]["results"]]
    check(cold[0] != cold[VL_OTHER_IMAGE], f"{name}: chat 1 and chat "
          f"{VL_OTHER_IMAGE + 1} (its text, another image) streamed the "
          f"same entries")
    pairs = list(zip(cold[0], cold[VL_OTHER_IMAGE]))
    rec["other_image_first_token_difference"] = next(
        (j for j, (a, b) in enumerate(pairs) if a[0] != b[0]), None)
    rec["other_image_max_logprob_difference"] = max(
        abs(a[1] - b[1]) for a, b in pairs)
    # the prefix hits, from the prompts' identities: in the cold round the
    # repeated image's pages of its common prefix with chat 1 and the other
    # image's pages before its offset (no other chat shares a page); in the
    # measured round each prompt's own pages
    want_cold = expected_prefix_pages(prompts, page)
    want_warm = expected_prefix_pages(prompts, page, prompts)
    offset = 0
    while prompts[0][offset] == prompts[VL_OTHER_IMAGE][offset]:
        offset += 1
    check(want_cold[VL_OTHER_IMAGE] == offset // page
          and want_cold[VL_SAME_IMAGE] > offset // page + 1
          and sum(want_cold) == want_cold[VL_OTHER_IMAGE]
          + want_cold[VL_SAME_IMAGE],
          f"{name}: the traffic's prefix structure {want_cold} (image "
          f"offset {offset})")
    hits = st["gpu_prefix_cache_hits"]
    check(hits == sum(want_cold) + sum(want_warm),
          f"{name}: run.py hit {hits} prefix pages; the prompts' identities "
          f"give {want_cold} cold + {want_warm} warm")
    check(st["decode_path"] == "ragged", f"{name}: run.py decoded through "
          f"{st['decode_path']} ({st['decode_path_reason']})")
    steps = st["decode_window_steps"]
    tokens = sum(len(e) for rnd in rounds for e, _ in rnd["results"])
    k = st["kernel_launches"][RAGGED]
    warm = st["graph_warmup_launches"].get(RAGGED, 0)
    # each chat decodes its tokens but the prefill's first, in windows of
    # 8 at most: at least that many steps, fewer than one window more
    n_chats = 2 * len(bodies)
    check(tokens - n_chats <= steps < tokens - n_chats
          + n_chats * served_config(card).decode_steps,
          f"{name}: {steps} decode steps for "
          f"{tokens} tokens in {n_chats} chats")
    check(k == cfg.num_layers * steps + warm > 0, f"{name}: run.py launched "
          f"the ragged kernel {k} times over {steps} decode steps x "
          f"{cfg.num_layers} layers + {warm} in warm-ups")
    g = st["graphs"]
    check(g["replays"] == st["decode_windows"] == st["decode_dispatches"]
          == g["replay_paths"].get("ragged", 0) > 0,
          f"{name}: {g['replays']} replays ({g['replay_paths']}) for "
          f"{st['decode_windows']} windows")
    late = [t for t in g["capture_times"] if t >= rounds[1]["start"]]
    check(not late, f"{name}: {len(late)} window graphs captured in the "
          f"measured round")
    rec.update(
        cold=_ttft_quantiles(rounds[0]["metrics"]),
        warm=_ttft_quantiles(rounds[1]["metrics"], rounds[0]["metrics"]),
        prefix_pages={"cold": want_cold, "warm": want_warm, "run.py": hits},
        launches=st["kernel_launches"], decode_window_steps=steps,
        warmup_launches=warm, captured=g["captured"],
        weight_bytes=st["weight_bytes"], rounds_s=[r["seconds"]
                                                   for r in rounds])
    print(f"{name}: run.py READY in {rec['ready_s']:.1f} s; 2 rounds of the "
          f"8 chats (4 SSE, 4 unary) one at a time, every stream "
          f"{MAX_TOKENS} tokens; chat 1 and chat {VL_OTHER_IMAGE + 1} "
          f"differ (their first different token at "
          f"{rec['other_image_first_token_difference']}, their tokens' "
          f"logprobs by up to "
          f"{rec['other_image_max_logprob_difference']:.4f}); prefix pages {hits} = cold {want_cold} + warm "
          f"{want_warm}; path ragged, {k} launches = {cfg.num_layers} x "
          f"{steps} steps + {warm}; {g['replays']} replays = windows, "
          f"{g['captured']} graphs, none in the measured round; TTFT p50 / "
          f"p90 cold {rec['cold']['ttft_p50_ms']:.1f} / "
          f"{rec['cold']['ttft_p90_ms']:.1f} ms, warm "
          f"{rec['warm']['ttft_p50_ms']:.1f} / "
          f"{rec['warm']['ttft_p90_ms']:.1f} ms; weight_bytes "
          f"{rec['weight_bytes']} [{smi}]", flush=True)
    return rec


def vl_run(engine, pre, rid: str, logprobs=None) -> tuple:
    """One preprocessed chat through the engine alone: (ids, each token's
    top logprobs [(id, logprob)] best first or None, seconds to the first
    token)."""
    from dynamo_tpu_torch.llm.worker import to_engine_request
    req = to_engine_request(dataclasses.replace(pre, request_id=rid))
    if logprobs is not None:
        req.params = dataclasses.replace(req.params, logprobs=logprobs)
    t0 = time.perf_counter()
    engine.add_request(req)
    ids, tops, first, done = [], [], None, False
    while not done:
        for ev in engine.step():
            if ev.request_id != rid:
                continue
            if ev.token is not None:
                first = first or time.perf_counter() - t0
                ids.append(ev.token)
                tops.append(ev.top_logprobs)
            done |= ev.finished
    return ids, tops, first


def phase_vision_engine(smi: str, card, params, pres: list,
                        prompts: list, device: str = "cuda") -> dict:
    """18b in process, on run.py's EngineConfig and the bf16 weights
    (seed 0): chat 1, the repeated image and the other image one at a
    time, each one's prefix hits equal to its pages derived from the
    prompts' identities; chat 1's time to its first token (encode and a
    prefill of three chunks), ms per decode step, peak memory."""
    import torch
    from dynamo_tpu_torch.engine.engine import NativeEngine
    name = "phase 18b (in process)"
    page = card.kv_page_size
    engine = NativeEngine(card.model_config(), served_config(card),
                          params=params, device=device)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    order = [0, VL_SAME_IMAGE, VL_OTHER_IMAGE]
    want = expected_prefix_pages([prompts[i] for i in order], page)
    rec = {"prefix_pages": {}, "ttft_s": {}}
    sch = engine.scheduler
    for i, w in zip(order, want):
        h0 = sch._prefix_hits
        ids, _, first = vl_run(engine, pres[i], f"vl-agg-{i}")
        got = sch._prefix_hits - h0
        check(got == w and len(ids) == MAX_TOKENS,
              f"{name}: chat {i + 1} ({VL_LABELS[i]}) hit {got} prefix "
              f"pages, its prompt's identities give {w}; {len(ids)} tokens")
        rec["prefix_pages"][VL_LABELS[i]] = got
        rec["ttft_s"][VL_LABELS[i]] = first
    rec["ms_per_step"] = steady_ms_per_step(engine, [pres[1].token_ids])
    rec["peak_gib"] = (torch.cuda.max_memory_allocated() / 2 ** 30
                       if device == "cuda" else 0.0)
    rec["weight_bytes"] = engine.metrics().weight_bytes
    rec["prompt_tokens"] = len(pres[0].token_ids)
    print(f"{name}: prefix pages {rec['prefix_pages']} (derived {want}); "
          f"chat 1 ({rec['prompt_tokens']} prompt tokens, 1024 of them "
          f"image) to its first token {rec['ttft_s'][VL_LABELS[0]] * 1e3:.1f}"
          f" ms (encode + a 3-chunk prefill, cold); one slot "
          f"{rec['ms_per_step']:.2f} ms per decode step; peak "
          f"{rec['peak_gib']:.2f} GiB; weight_bytes {rec['weight_bytes']} "
          f"[{smi}]", flush=True)
    engine.cache = None
    del engine
    empty_cache(device)
    return rec


def phase_vision_disagg(smi: str, card, params, pres: list,
                        prompts: list, device: str = "cuda") -> dict:
    """18d: a DisaggDecodeWorker and a PrefillWorker over one memory plane
    and one bf16 params tree, the KV pages over the chunked transfer server,
    max_local_prefill_length below the prompts' lengths; one image chat in
    each mm_transfer mode (chat 2 in "pixels", chat 3 in "embeds", where
    the prefill engine's tower raises). Each takes the remote path (1
    remote prefill), its pages received = verified with no mismatch, and
    its stream equals a fresh engine's aggregated run on the same weights,
    or first differs at a near tie."""
    import torch
    from dynamo_tpu_torch.disagg.queue import PrefillQueue
    from dynamo_tpu_torch.disagg.remote_transfer import (
        KvTransferServer, RemoteTransferBackend,
    )
    from dynamo_tpu_torch.disagg.router import DisaggregatedRouter
    from dynamo_tpu_torch.disagg.worker import (
        DisaggDecodeWorker, PrefillWorker,
    )
    from dynamo_tpu_torch.engine.engine import NativeEngine
    from dynamo_tpu_torch.engine.sampler import TOP_LOGPROBS
    from dynamo_tpu_torch.llm.worker import NativeEngineWorker
    from dynamo_tpu_torch.runtime.engine import Context
    from dynamo_tpu_torch.runtime.integrity import STATS as INTEGRITY
    from dynamo_tpu_torch.runtime.transports.codec import packb
    from dynamo_tpu_torch.runtime.transports.memory import MemoryPlane
    name = "phase 18d (disaggregated image chats)"
    mcfg, ecfg = card.model_config(), served_config(card)
    page = card.kv_page_size
    dec_eng = NativeEngine(mcfg, ecfg, params=params, device=device)
    pre_eng = NativeEngine(mcfg, ecfg, params=params, device=device)
    rec = {}

    async def one(mode: str, pre) -> dict:
        plane = MemoryPlane()
        queue = PrefillQueue(plane.messaging, "ns", VL_MODEL)
        shipped = []
        enqueue = queue.enqueue

        async def counted(req):
            shipped.append(len(packb(req.to_json())))
            return await enqueue(req)
        queue.enqueue = counted
        router = DisaggregatedRouter(max_local_prefill_length=256,
                                     max_prefill_queue_size=8,
                                     model=VL_MODEL)
        decode = DisaggDecodeWorker(dec_eng, plane.messaging, router, queue,
                                    worker_id=f"dec-{mode}",
                                    prefill_timeout_s=120.0,
                                    mm_transfer=mode)
        server = await KvTransferServer(decode, f"dec-{mode}").start()
        await server.register(plane.kv)
        transfer = RemoteTransferBackend(plane.kv)
        prefill = PrefillWorker(NativeEngineWorker(pre_eng), queue, transfer,
                                plane.messaging)
        await decode.start()
        await prefill.start()
        v0, m0 = INTEGRITY.pages_verified, INTEGRITY.mismatches
        toks, first = [], None
        try:
            t0 = time.perf_counter()
            async for f in decode.generate(pre, Context(pre.request_id)):
                if f.token_ids and first is None:
                    first = time.perf_counter() - t0
                toks.extend(f.token_ids)
            seconds = time.perf_counter() - t0
        finally:
            await prefill.stop()
            await decode.stop()
            await transfer.close()
            await server.stop()
        return {"tokens": toks, "remote_prefills": decode.remote_prefills,
                "received_pages": server.received_pages,
                "verified": INTEGRITY.pages_verified - v0,
                "mismatches": INTEGRITY.mismatches - m0,
                "queue_bytes": shipped, "ttft_s": first, "seconds": seconds}

    ref_eng = NativeEngine(mcfg, ecfg, params=params, device=device)
    seen = []   # the prompts the decode engine holds pages of
    for mode, i in (("pixels", 1), ("embeds", 2)):
        pre = dataclasses.replace(pres[i], request_id=f"vl-{mode}")
        if mode == "embeds":
            def tower_ran(*a, **k):
                check(False, f"{name}: the prefill engine's tower ran in "
                      "embeds mode")
            pre_eng.encode_image = tower_ran
        r = asyncio.run(asyncio.wait_for(one(mode, pre), 300))
        pre_eng.__dict__.pop("encode_image", None)
        want_pages = -(-len(pre.token_ids) // page) - expected_prefix_pages(
            [prompts[i]], page, seen)[0]
        seen.append(prompts[i])
        check(r["remote_prefills"] == 1, f"{name}: {mode}: "
              f"{r['remote_prefills']} remote prefills")
        check(r["received_pages"] == r["verified"] == want_pages
              and r["mismatches"] == 0, f"{name}: {mode}: received "
              f"{r['received_pages']} pages, verified {r['verified']}, the "
              f"prompt's {want_pages}, mismatches {r['mismatches']}")
        ids, tops, _ = vl_run(ref_eng, pres[i], f"vl-ref-{mode}",
                              TOP_LOGPROBS)
        d = divergence(r["tokens"], ids, tops)
        check(len(r["tokens"]) == MAX_TOKENS and (d is None
                                                  or d[1] <= NEAR_TIE),
              f"{name}: {mode}: the stream leaves the aggregated run at "
              f"{d} ({len(r['tokens'])} tokens; near tie <= {NEAR_TIE})")
        r["first_difference"] = d
        r["tokens"] = len(r["tokens"])
        rec[mode] = r
        print(f"{name}: {mode}: 1 remote prefill, {r['received_pages']} "
              f"pages received = verified, 0 mismatches; queue payload "
              f"{r['queue_bytes']} bytes; remote TTFT {r['ttft_s'] * 1e3:.1f}"
              f" ms; against the aggregated run: "
              f"{'equal' if d is None else d} [{smi}]", flush=True)
    for e in (dec_eng, pre_eng, ref_eng):
        e.cache = None
    empty_cache(device)
    return rec


def phase_vision_chunks(smi: str, card, pre, device: str = "cuda") -> dict:
    """18c: one image chat (1024 patches, ~200 text tokens) in f32 at full
    width and depth (seed 0), 32 greedy tokens, with max_prefill_chunk 512
    (the span over three chunks) and 2048 (one chunk): token-identical, or
    first differing where the one-chunk run's top-1 less top-2 logprob is
    under 1e-3 (the one-chunk run's logprob of its token less that of the
    chunked run's, `divergence`)."""
    import torch
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import NativeEngine
    from dynamo_tpu_torch.engine.sampler import TOP_LOGPROBS
    from dynamo_tpu_torch.models import llama
    name = "phase 18c (the span across prefill chunks, f32)"
    cfg = dataclasses.replace(card.model_config(), dtype="float32")
    params = llama.init_params(cfg, device, seed=0)
    pre = dataclasses.replace(pre, stop=dataclasses.replace(
        pre.stop, max_tokens=32))
    out = {}
    for chunk in (512, 2048):
        ecfg = EngineConfig(page_size=card.kv_page_size, num_pages=64,
                            max_slots=1, max_model_len=2048,
                            max_prefill_chunk=chunk,
                            prefill_buckets=(16, 32, 64, 128, 256, 512,
                                             1024, 2048))
        engine = NativeEngine(cfg, ecfg, params=params, device=device)
        chunks = []
        build = engine.scheduler._build_prefill

        def spy(batch, tb, decode_rows=(), build=build, chunks=chunks):
            plan = build(batch, tb, decode_rows)
            if plan.mm_mask is not None:
                chunks.append(int(plan.mm_mask.sum()))
            return plan
        engine.scheduler._build_prefill = spy
        ids, tops, _ = vl_run(engine, pre, f"vl-f32-{chunk}", TOP_LOGPROBS)
        check(engine.logits_nonfinite_steps() == 0 and len(ids) == 32,
              f"{name}: chunk {chunk}: {len(ids)} tokens, "
              f"{engine.logits_nonfinite_steps()} non-finite steps")
        out[chunk] = {"ids": ids, "tops": tops, "span_rows": chunks}
        engine.cache = None
        del engine
        empty_cache(device)
    n_patch = sum(out[2048]["span_rows"])
    check(len(out[512]["span_rows"]) >= 2 and sum(out[512]["span_rows"])
          == n_patch == 1024 and len(out[2048]["span_rows"]) == 1,
          f"{name}: the span's rows by chunk {out[512]['span_rows']} / "
          f"{out[2048]['span_rows']}")
    d = divergence(out[512]["ids"], out[2048]["ids"], out[2048]["tops"])
    check(d is None or d[1] < 1e-3, f"{name}: the chunked stream leaves the "
          f"one-chunk stream at {d} (an f32 near tie is < 1e-3)")
    del params
    empty_cache(device)
    rec = {"span_rows": {k: v["span_rows"] for k, v in out.items()},
           "first_difference": d}
    print(f"{name}: the span's rows by chunk {rec['span_rows']}; 32 greedy "
          f"tokens {'identical' if d is None else f'first differ at {d}'} "
          f"[{smi}]", flush=True)
    return rec


def phase_vision(smi: str) -> dict:
    """Phase 18: 18a, 18b (the process, then in process), 18d, 18c; each
    part's seconds."""
    import torch
    from dynamo_tpu_torch.models import llama, vision
    from dynamo_tpu_torch.run import build_card
    rec, secs = {}, {}
    t0 = time.perf_counter()
    rec["tower"] = phase_vision_tower(smi)
    secs["18a"] = time.perf_counter() - t0
    card = build_card(VL_MODEL)
    bodies = vl_chats()
    pres = vl_preprocessed(card, bodies)
    n_patch = vision.num_patches(card.model_config().vision)
    prompts = [vl_identities(p, n_patch) for p in pres]
    t0 = time.perf_counter()
    reset_launch_counts()
    rec["http"] = phase_vision_http(smi, card, bodies, prompts)
    secs["18b run.py"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    params = llama.init_params(card.model_config(), "cuda", seed=0)
    reset_launch_counts()
    rec["engine"] = phase_vision_engine(smi, card, params, pres, prompts)
    rec["engine"]["launches"] = launch_counts()
    secs["18b in process"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    reset_launch_counts()
    rec["disagg"] = phase_vision_disagg(smi, card, params, pres, prompts)
    rec["disagg"]["launches"] = launch_counts()
    secs["18d"] = time.perf_counter() - t0
    del params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    reset_launch_counts()
    rec["chunks"] = phase_vision_chunks(smi, card, pres[0])
    rec["chunks"]["launches"] = launch_counts()
    secs["18c"] = time.perf_counter() - t0
    rec["seconds"] = secs
    for part, s in secs.items():
        print(f"phase seconds: {part} {s:.1f}", flush=True)
    return rec


# -- phase 19: streaming past the HBM page budget ------------------------------

# llama3-8b on the card: S's HBM and host pages, its window halves, resident
# budget and hot prefix, the chats' prompt tokens, and the f32 check's
# prompt and tokens; a CPU rehearsal passes smaller ones
STREAM_SIZES = dict(num_pages=64, host=256, window=8, resident=8, hot=2,
                    prompt=4096, chats=2, f32_prompt=1024, f32_tokens=16)


def stream_counts(n_prompt: int, max_tokens: int, ps: int, budget: int,
                  window: int, layers: int) -> tuple:
    """(stream steps, prefetch takes, ragged launches) of one streamed
    request, derived from its lengths and the residency rules: a step that
    starts at token `start` attends start // ps sealed pages, of which
    min(sealed, budget) stay resident (budget - 1 beside an unsealed tail
    page); the rest are cold, in ceil(cold / window) segments a layer. A
    prefill chunk runs every partial as torch ops; a decode step launches
    the ragged kernel for the resident pages and each segment in every
    layer but layer 0."""
    def segments(start):
        sealed = start // ps
        tail = 1 if start % ps else 0
        return -(-(sealed - min(sealed, budget - tail)) // window)
    steps = takes = ragged = 0
    start = 0
    while start < n_prompt:
        takes += layers * segments(start)
        start += min(ps - start % ps, n_prompt - start)
        steps += 1
    for j in range(max_tokens - 1):
        n = segments(n_prompt + j)
        takes += layers * n
        ragged += (layers - 1) * (1 + n)
        steps += 1
    return steps, takes, ragged


def stream_serve(engine, rid: str, prompt: list, max_tokens: int,
                 arm=None) -> dict:
    """One greedy request alone on the engine (ignore_eos), with the ragged
    kernel's launch count set to 0 just before and read just after: its
    tokens, TTFT, ms per decode step (first token to last, host clock),
    whether it streamed, the STREAM_STATS delta and the engine ledger's
    "stream" samples of the run (their count and their summed prefetch
    hits and lates). `arm` = (n, fn): fn() once the n-th token arrived."""
    import torch
    from dynamo_tpu_torch.engine.scheduler import (
        EngineRequest, SamplingParams,
    )
    from dynamo_tpu_torch.engine.streaming import STREAM_STATS
    from dynamo_tpu_torch.ops import paged_attention
    s0 = STREAM_STATS.snapshot()
    engine.ledger.drain()
    paged_attention.KERNEL_LAUNCHES = 0
    t0 = time.perf_counter()
    engine.add_request(EngineRequest(rid, list(prompt), SamplingParams(
        max_tokens=max_tokens, temperature=0.0, ignore_eos=True)))
    streamed = any(q.request_id == rid
                   for q in engine.scheduler.stream_active)
    out, stamps, done = [], [], False
    while not done:
        for ev in engine.step():
            if ev.request_id != rid:
                continue
            if ev.token is not None:
                out.append(ev.token)
                stamps.append(time.perf_counter())
                if arm is not None and len(out) == arm[0]:
                    arm[1]()
            done |= ev.finished
    while engine.has_work():
        engine.step()
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    launches = paged_attention.KERNEL_LAUNCHES
    s1 = STREAM_STATS.snapshot()
    samples = [r for r in engine.ledger.drain() if r["kind"] == "stream"]
    return {"tokens": out, "ttft_s": stamps[0] - t0,
            "ms_per_step": ((stamps[-1] - stamps[0]) / max(1, len(out) - 1)
                            * 1e3),
            "streamed": streamed, "launches": launches,
            "stats": {k: s1[k] - s0[k] for k in s0},
            "ledger": {"stream_samples": len(samples), "prefetch_takes": sum(
                r["stream_hit"] + r["stream_late"] for r in samples)}}


def near_tie_gap(engine, rid: str, context: list, token: int) -> float:
    """The engine's top logprob less its logprob of `token` after `context`
    (one greedy step with the top-8 logprobs; inf when `token` is not among
    them)."""
    from dynamo_tpu_torch.engine.scheduler import (
        EngineRequest, SamplingParams,
    )
    engine.add_request(EngineRequest(rid, list(context), SamplingParams(
        max_tokens=1, temperature=0.0, ignore_eos=True, logprobs=8)))
    top = None
    while engine.has_work():
        for ev in engine.step():
            if ev.request_id == rid and ev.top_logprobs is not None:
                top = dict(ev.top_logprobs)
    check(top is not None, f"near tie: no logprobs for {rid}")
    if token not in top:
        return float("inf")
    return max(top.values()) - top[token]


def stream_partial_check(cfg, device: str = "cuda") -> dict:
    """The kernel-form partials at the streamed decode's shapes against
    `_pages_partial` as torch ops on the same inputs: one query row (the
    model's heads) over 9 resident pages, the last holding 37 tokens, and a
    staged half of 8 slots holding 7 pages, with bf16 and int8 pages. The
    normalised output and m within 2e-3, l within 2e-3 relative; with int8
    pages 1e-2, since the torch form rounds the dequantized rows to bf16
    (the JAX form) where the kernel folds the scales in f32. Returns the
    largest differences."""
    import torch
    from dynamo_tpu_torch.engine import streaming as st
    from dynamo_tpu_torch.ops.kv_quant import dequantize_rows, quantize_rows
    hkv, hd, ps = cfg.num_kv_heads, cfg.head_dim, 64
    h = cfg.num_heads
    g = torch.Generator().manual_seed(19)
    dt = torch.bfloat16
    q = torch.randn((1, h, hd), generator=g).to(device, dt)
    k = torch.randn((2, hkv, 20, ps, hd), generator=g).to(device, dt)
    v = torch.randn((2, hkv, 20, ps, hd), generator=g).to(device, dt)
    table = torch.tensor([3, 11, 5, 7, 1, 9, 14, 2, 17], device=device)
    lens = torch.tensor([ps] * 8 + [37], dtype=torch.int32, device=device)
    out = {}
    for quant in (False, True):
        cache = {"k": k, "v": v}
        if quant:
            kq, ks = quantize_rows(k)
            vq, vs = quantize_rows(v)
            cache = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
        kp = cache["k"][1].index_select(1, table)
        vp = cache["v"][1].index_select(1, table)
        if quant:
            kp = dequantize_rows(kp, cache["k_scale"][1].index_select(
                1, table), dt)
            vp = dequantize_rows(vp, cache["v_scale"][1].index_select(
                1, table), dt)
        want = st._pages_partial(q, kp, vp, lens, hd ** -0.5, False)
        got = st._kernel_partial(
            q, cache["k"], cache["v"], 1, table[None].to(torch.int32),
            lens.sum()[None].to(torch.int32), cache.get("k_scale"),
            cache.get("v_scale"))
        w = 8
        staged = (cache["k"][0][:, :w].contiguous(),
                  cache["v"][0][:, :w].contiguous(),
                  cache["k_scale"][0][:, :w].contiguous() if quant else None,
                  cache["v_scale"][0][:, :w].contiguous() if quant else None,
                  torch.tensor([ps] * 7 + [0], dtype=torch.int32,
                               device=device),
                  torch.tensor([7 * ps], dtype=torch.int32, device=device),
                  torch.arange(w, dtype=torch.int32, device=device)[None])
        g_ = h // hkv
        zero = (torch.zeros((1, hkv, g_, hd), device=device),
                torch.full((1, hkv, g_), -1e30, device=device),
                torch.zeros((1, hkv, g_), device=device))
        seg_want = st._stream_seg_merge(cfg, False, q, staged, *zero)
        seg_got = st._stream_seg_merge(cfg, False, q, staged, *zero,
                                       kernel=True)
        for name, a, b in (("resident", got, want),
                           ("segment", seg_got, seg_want)):
            o_err = float(((a[0] / a[2][..., None])
                           - (b[0] / b[2][..., None])).abs().max())
            m_err = float((a[1] - b[1]).abs().max())
            l_err = float(((a[2] - b[2]).abs() / b[2]).max())
            label = f"{name} {'int8' if quant else 'bf16'}"
            tol = 1e-2 if quant else 2e-3
            check(o_err <= tol and m_err <= tol and l_err <= tol,
                  f"streamed partial, {label}: the kernel form differs from "
                  f"the torch ops by {o_err} (out), {m_err} (m), {l_err} "
                  "(l, relative)")
            out[label] = max(o_err, m_err, l_err)
    print(f"streamed partials: the kernel form against the torch ops at "
          f"{h} / {hkv} heads of {hd}: {json.dumps(out)}", flush=True)
    return out


def phase_streaming(smi: str, model: str = "llama3-8b", device: str = "cuda",
                    layers: int = TIER_LAYERS, sizes: dict = None) -> dict:
    """Phase 19 (see the docstring at the top), at `layers` of the model's
    depth when that cuts it (0: all)."""
    import torch
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.engine.engine import NativeEngine
    from dynamo_tpu_torch.run import build_card
    from dynamo_tpu_torch.runtime import faults
    t_phase = time.perf_counter()
    sz = dict(STREAM_SIZES, **(sizes or {}))
    card = build_card(model)
    cfg = card.model_config()
    if 0 < layers < cfg.num_layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    ps = card.kv_page_size
    n_tok = TIER_MAX_TOKENS
    rec = {"sizes": sz, "layers": cfg.num_layers,
           "partials": stream_partial_check(cfg, device)}
    prompts = [tier_tokens(sz["prompt"], 1900 + i, cfg.vocab_size)
               for i in range(sz["chats"])]
    max_len = (-(-(sz["prompt"] + n_tok) // ps) + 2) * ps

    def build(c, params, kv_quant="", stream=True):
        kw = dict(page_size=ps, kv_quant=kv_quant, max_model_len=max_len)
        if stream:
            kw.update(num_pages=sz["num_pages"], host_pages=sz["host"],
                      stream_pages=sz["window"],
                      stream_resident_pages=sz["resident"],
                      stream_hot_pages=sz["hot"])
        else:
            kw.update(num_pages=512)
        return NativeEngine(c, EngineConfig(**kw), params=params,
                            eos_token_ids=set(card.eos_token_ids),
                            device=device)

    def gate(label, got, ref, o, prompt, counts):
        steps, takes, ragged = counts
        st = got["stats"]
        check(got["streamed"] and len(got["tokens"]) == len(ref["tokens"]),
              f"{label}: streamed {got['streamed']}, "
              f"{len(got['tokens'])} tokens")
        check(st["stream_steps"] == steps
              and st["prefetch_hit"] + st["prefetch_late"] == takes
              and st["pages_quarantined"] == 0,
              f"{label}: stream steps {st['stream_steps']} (expected "
              f"{steps}), prefetch hits + lates {st['prefetch_hit']} + "
              f"{st['prefetch_late']} (expected {takes}), stats {st}")
        # the engine ledger: one "stream" sample a streamed step, whose
        # prefetch deltas add up to the derived takes
        check(got["ledger"] == {"stream_samples": steps,
                                "prefetch_takes": takes},
              f"{label}: the ledger's stream samples {got['ledger']}, "
              f"expected {steps} samples and {takes} prefetch takes")
        if device == "cuda":
            check(got["launches"] == ragged,
                  f"{label}: {got['launches']} ragged launches, expected "
                  f"{ragged} ((layers - 1) x (1 + segments) a decode step)")
        j = first_difference(got["tokens"], ref["tokens"])
        gap = 0.0
        if j is not None:
            gap = near_tie_gap(o, f"{label}-tie", prompt + ref["tokens"][:j],
                               got["tokens"][j])
            check(gap <= NEAR_TIE,
                  f"{label}: stream leaves the ordinary engine's at token "
                  f"{j} with a logprob gap of {gap} (> {NEAR_TIE})")
        return {"first_difference": j, "gap": gap}

    budget = max(2, sz["resident"])
    counts = stream_counts(len(prompts[0]), n_tok, ps, budget, sz["window"],
                           cfg.num_layers)
    params = llama.init_params(cfg, device, 0)
    for kv in ("", "int8"):
        label = kv or "bf16"
        o = build(cfg, params, kv, stream=False)
        s_eng = build(cfg, params, kv)
        runs = []
        for i, prompt in enumerate(prompts):
            ref = stream_serve(o, f"O-{label}-{i}", prompt, n_tok)
            got = stream_serve(s_eng, f"S-{label}-{i}", prompt, n_tok)
            cmp = gate(f"streamed {label} chat {i}", got, ref, o, prompt,
                       counts)
            runs.append({"ms_per_step": got["ms_per_step"],
                         "ordinary_ms_per_token": ref["ms_per_step"],
                         "ttft_s": got["ttft_s"],
                         "ordinary_ttft_s": ref["ttft_s"],
                         "launches": got["launches"], "stats": got["stats"],
                         **cmp, "tokens": got["tokens"]})
        pool = s_eng._streamer.pool
        entry = {"runs": runs, "expected": dict(zip(
            ("stream_steps", "prefetch_takes", "ragged_launches"), counts)),
                 "h2d_gb_s": (pool.h2d_bytes / pool.h2d_s / 1e9
                              if pool.h2d_s else None),
                 "h2d_bytes": pool.h2d_bytes, "fills": pool.fills}
        if not kv:
            # one rotten tier read during a shorter chat, run clean first
            def arm():
                faults.REGISTRY.arm("offload.read_tier", faults.FaultSchedule(
                    0, [faults.FaultSpec("corrupt", p=1.0, n=1)]))
            short = tier_tokens(sz["f32_prompt"], 1950, cfg.vocab_size)
            clean = stream_serve(s_eng, "S-clean", short, n_tok)
            try:
                rot = stream_serve(s_eng, "S-rot", short, n_tok, arm=(4, arm))
            finally:
                faults.REGISTRY.disarm()
            st = rot["stats"]
            check(st["pages_quarantined"] == 1 and st["pages_recomputed"] == 1
                  and rot["tokens"] == clean["tokens"],
                  f"streamed rot: {st['pages_quarantined']} quarantined, "
                  f"{st['pages_recomputed']} recomputed, stream differs at "
                  f"{first_difference(rot['tokens'], clean['tokens'])}")
            entry["rot"] = {"quarantined": 1, "recomputed": 1,
                            "ms_per_step": rot["ms_per_step"]}
        rec[label] = entry
        o.close()
        s_eng.close()
        del o, s_eng
        if device == "cuda":
            torch.cuda.empty_cache()
    del params
    if device == "cuda":
        torch.cuda.empty_cache()
    # f32, one slot, at the same depth: identical streams
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = llama.init_params(cfg32, device, 0)
    prompt = tier_tokens(sz["f32_prompt"], 1950, cfg.vocab_size)
    o = build(cfg32, params, stream=False)
    s_eng = build(cfg32, params)
    ref = stream_serve(o, "O-f32", prompt, sz["f32_tokens"])
    got = stream_serve(s_eng, "S-f32", prompt, sz["f32_tokens"])
    counts32 = stream_counts(len(prompt), sz["f32_tokens"], ps, budget,
                             sz["window"], cfg.num_layers)
    gate("streamed f32", got, ref, o, prompt, counts32)
    check(got["tokens"] == ref["tokens"],
          f"streamed f32: stream differs from the ordinary engine's at "
          f"{first_difference(got['tokens'], ref['tokens'])}")
    rec["f32"] = {"tokens": len(got["tokens"]), "launches": got["launches"],
                  "ms_per_step": got["ms_per_step"]}
    o.close()
    s_eng.close()
    del o, s_eng, params
    if device == "cuda":
        torch.cuda.empty_cache()
    rec["phase_s"] = time.perf_counter() - t_phase
    b = rec["bf16"]
    hits = sum(r["stats"]["prefetch_hit"] for r in b["runs"])
    lates = sum(r["stats"]["prefetch_late"] for r in b["runs"])
    rec["hit_share"] = hits / max(1, hits + lates)
    rec["stall_steps"] = sum(r["stats"]["stall_steps"] for r in b["runs"])
    print(f"streaming [{smi}]: {sz['prompt']}-token chats through a "
          f"{sz['num_pages']}-page budget ({cfg.num_layers} layers): ms per "
          f"streamed decode step "
          + ", ".join(f"{k} {[round(r['ms_per_step'], 3) for r in rec[k]['runs']]}"
                      f" (ordinary "
                      f"{[round(r['ordinary_ms_per_token'], 3) for r in rec[k]['runs']]}"
                      " ms a token)" for k in ("bf16", "int8"))
          + f"; prefetch hit share {rec['hit_share']:.4f}; window fills "
          f"{b['h2d_gb_s']} GB/s host to device; stall steps "
          f"{rec['stall_steps']}; ragged launches "
          f"{[r['launches'] for r in b['runs']]} (expected "
          f"{b['expected']['ragged_launches']} each); rot: 1 quarantined, 1 "
          f"recomputed, stream unchanged; f32 identical; phase "
          f"{rec['phase_s']:.1f} s", flush=True)
    for k in ("bf16", "int8"):
        for r in rec[k]["runs"]:
            del r["tokens"]
    return rec


# -- phase 20: traced disaggregation under a link-cut storm -----------------------

TRACED_PAGES = 512        # per engine: two engines and one weight tree
TRACED_CHUNK_PAGES = 4
TRACED_LEGS = ("schedule", "attempt", "worker.generate", "prefill.remote",
               "queue.wait", "prefill.run", "kv.transfer",
               "kv.transfer.chunk", "kv.inject", "decode.emit")
# the transfer storm's link plan without its 30 s stall, and its queue
# jitter (tools/torch_chaos.py TRANSFER_STORM_PLAN)
STORM_PLAN = {
    "transfer.link": {"seed": 53, "specs": [{"kind": "drop", "p": 0.12}]},
    "queue.dequeue": {"seed": 353, "specs": [
        {"kind": "delay", "p": 0.5, "delay_s": 0.01}]},
    "remote_transfer.fetch_page": {"seed": 0, "specs": [
        {"kind": "corrupt", "p": 1.0, "n": 1}]},
}
PROFILE_TURN = 80         # P's user turn in bytes: a 105-token prompt


def wire_pages(pages: int, chunk: int) -> int:
    """Pages a transfer of `pages` puts on the wire: each chunk padded with
    zero pages to a power of two (the JAX `_stage_chunk` layout)."""
    out = 0
    for start in range(0, pages, chunk):
        n = min(chunk, pages - start)
        out += 1 << (n - 1).bit_length()
    return out


def request_traces(spans: list) -> dict:
    """trace id -> its spans, the scope:* pseudo-traces left out."""
    out = {}
    for s in spans:
        if not s["trace_id"].startswith("scope:"):
            out.setdefault(s["trace_id"], []).append(s)
    return out


def traced_split(mine: list) -> dict:
    """One request trace's legs in ms: queue wait, prefill run, transfer
    (and its GB/s beside the router's pre-send estimate), injects, and the
    first emit's offset from the HTTP root."""
    def named(n):
        return [s for s in mine if s["name"] == n]
    root = named("http.request")[0]
    (x,) = named("kv.transfer")
    emits = sorted(named("decode.emit"), key=lambda s: s["ts"])
    return {"queue_wait_ms": sum(s["dur"] for s in named("queue.wait")) * 1e3,
            "prefill_run_ms": sum(s["dur"] for s in named("prefill.run")) * 1e3,
            "transfer_ms": x["dur"] * 1e3,
            "transfer_gb_s": x["attrs"]["bytes"] / x["dur"] / 1e9,
            "est_ms": x["attrs"]["est_s"] * 1e3,
            "est_cold": x["attrs"]["est_cold"],
            "inject_ms": sum(s["dur"] for s in named("kv.inject")) * 1e3,
            "first_emit_ms": (emits[0]["ts"] - root["ts"]) * 1e3}


def write_spans(path: str, spans: list) -> None:
    from dynamo_tpu_torch.runtime.tracing import chrome_trace
    with open(path, "w") as f:
        f.writelines(json.dumps(s) + "\n" for s in spans)
    with open(path + ".chrome.json", "w") as f:
        json.dump(chrome_trace(spans), f)


def phase_traced_disagg(smi: str, model: str = "llama3-8b",
                        device: str = "cuda", scale: float = 1.0,
                        device_name: str = None,
                        max_model_len: int = 0) -> dict:
    """Phase 20 (see the docstring at the top); a rehearsal on the CPU
    (`device` "cpu", a small model) shrinks the prompts and the threshold
    together by `scale`, may set the engines' max_model_len, and ships
    one-page chunks to give the storm as many chunks to cut."""
    return asyncio.run(asyncio.wait_for(_traced_disagg(
        smi, model, device, scale, device_name, max_model_len), 600))


async def _traced_disagg(smi, model, device, scale, device_name,
                         max_model_len) -> dict:
    import torch
    from dynamo_tpu_torch.disagg.queue import PrefillQueue
    from dynamo_tpu_torch.disagg.remote_transfer import (
        KvTransferServer, RemoteTransferBackend,
    )
    from dynamo_tpu_torch.disagg.router import DisaggregatedRouter
    from dynamo_tpu_torch.disagg.transfer import LocalTransferBackend
    from dynamo_tpu_torch.disagg.worker import (
        DisaggDecodeWorker, PrefillWorker,
    )
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import NativeEngine
    from dynamo_tpu_torch.engine.scheduler import Scheduler
    from dynamo_tpu_torch.examples.disagg.graph import _build, _device_name
    from dynamo_tpu_torch.frontend.discovery import (
        ModelWatcher, register_model,
    )
    from dynamo_tpu_torch.frontend.service import HttpService
    from dynamo_tpu_torch.llm import worker as llm_worker
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.protocols.openai import ChatCompletionRequest
    from dynamo_tpu_torch.runtime import faults
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.runtime.engine import Context
    from dynamo_tpu_torch.runtime.integrity import (
        STATS as INTEGRITY, XFER_STATS,
    )
    from dynamo_tpu_torch.runtime.tracing import TRACER
    from dynamo_tpu_torch.runtime.transports.memory import MemoryPlane
    from tools.torch_trace_explain import summarize
    name = "traced disaggregation"
    t_phase = time.perf_counter()
    chunk_pages = TRACED_CHUNK_PAGES if device == "cuda" else 1
    cfg = disagg_config(model, device, scale, max_model_len)
    for svc in ("DecodeWorker", "PrefillWorker"):
        cfg[svc]["num_pages"] = TRACED_PAGES
    card, dec_eng = _build(cfg["DecodeWorker"])
    check(device_name is None or _device_name(dec_eng) == device_name,
          f"traced disaggregation: the decode engine on "
          f"{_device_name(dec_eng)!r}, expected {device_name!r}")
    pc = cfg["PrefillWorker"]
    pre_eng = NativeEngine(dec_eng.model_cfg, EngineConfig(
        page_size=int(pc["page_size"]), num_pages=TRACED_PAGES,
        max_slots=int(pc["max_slots"]),
        max_prefill_chunk=int(pc["max_prefill_chunk"]),
        max_model_len=int(pc["max_model_len"])),
        params=dec_eng.params, eos_token_ids=set(card.eos_token_ids),
        device=device)
    mcfg, ps = dec_eng.model_cfg, card.kv_page_size
    page_bytes = (2 * mcfg.num_layers * mcfg.num_kv_heads * ps
                  * mcfg.head_dim * torch.empty((), dtype=getattr(
                      torch, mcfg.dtype)).element_size())
    threshold = cfg["DecodeWorker"]["max_local_prefill_length"]
    pre = OpenAIPreprocessor(card)
    n_tok = DIST_MAX_TOKENS

    def body(n, seed, stream=True):
        return disagg_body(model, n, seed, False, stream, scale, n_tok)

    chats = {"T": [body(n, 2000 + i) for i, n in enumerate(ROUND_A)],
             "S": [body(n, 2100 + i) for i, n in enumerate(ROUND_A)],
             "W": [body(n, 2400 + i) for i, n in enumerate(ROUND_A)],
             "L": [body(ROUND_A[0], 2200, False)],
             "P": [body(PROFILE_TURN, 2300, False)]}
    # the references: the decode engine serving each chat alone
    reference = []
    for rnd, bodies in chats.items():
        for i, b in enumerate(bodies):
            p, _ = pre.preprocess_chat(ChatCompletionRequest.from_json(b),
                                       request_id=f"{rnd}-{i}")
            req = llm_worker.to_engine_request(p)
            check(len(req.prompt) > threshold or rnd == "P",
                  f"{name}: chat {rnd}-{i} of {len(req.prompt)} tokens "
                  f"stays local (threshold {threshold})")
            toks, tops = aggregated_run(dec_eng, f"ref-{rnd}-{i}", req)
            reference.append({"round": rnd, "prompt": req.prompt, "pre": p,
                              "tokens": toks, "tops": tops,
                              "pages": -(-len(req.prompt) // ps)})
    # a fresh page allocator: no prefix of the references is reused
    dec_eng.scheduler = Scheduler(dec_eng.cfg)
    dec_eng._dec_state = None
    refs = {r: [x for x in reference if x["round"] == r] for r in chats}
    ref_s = time.perf_counter() - t_phase

    def hold(label, toks, ref):
        d = divergence(toks, ref["tokens"], ref["tops"])
        check(d is None or d[1] <= NEAR_TIE, f"{name}: {label} left the "
              f"reference stream at (position, logprob gap) {d}, past a "
              f"near tie ({NEAR_TIE}): {toks} against {ref['tokens']}")
        return d

    class Tapped(DisaggDecodeWorker):
        """The decode worker, recording each served stream's token ids in
        arrival order (the SSE carries text)."""

        async def generate(self, request, context):
            toks = []
            self.streams.append(toks)
            async for frame in super().generate(request, context):
                toks.extend(frame.token_ids or ())
                yield frame

    reset_launch_counts()
    steps0 = dec_eng.decode_window_steps
    warm0 = {k: dict(e.graphs.warmup_launches)
             for k, e in (("decode", dec_eng), ("prefill", pre_eng))}
    replay0 = {k: dict(e.graphs.replay_launches)
               for k, e in (("decode", dec_eng), ("prefill", pre_eng))}
    saved_trace = (TRACER.enabled, TRACER.sample_rate)
    TRACER.configure(enabled=True, sample_rate=1.0)
    TRACER.reset()
    plane = MemoryPlane()
    ns = DISAGG_NS
    wrt = await DistributedRuntime.create_local(plane, "dec-0")
    queue = PrefillQueue(plane.messaging, ns, model)
    router = DisaggregatedRouter(
        threshold, cfg["DecodeWorker"]["max_prefill_queue_size"], model)
    decode = Tapped(dec_eng, plane.messaging, router, queue,
                    worker_id="dec-0", prefill_timeout_s=300.0)
    decode.streams = []
    server = await KvTransferServer(decode, "dec-0").start()
    await server.register(plane.kv)
    tx = RemoteTransferBackend(plane.kv, chunk_pages=chunk_pages)
    tx_s = RemoteTransferBackend(plane.kv, chunk_pages=chunk_pages,
                                 window_chunks=1)
    prefill = PrefillWorker(llm_worker.NativeEngineWorker(pre_eng), queue,
                            tx, plane.messaging, dequeue_timeout_s=0.05)
    await decode.start()
    await prefill.start()
    await llm_worker.serve_llm_worker(wrt, ns, "backend", decode)
    frt = await DistributedRuntime.create_local(plane, "frontend")
    svc = await HttpService("127.0.0.1", 0).start()
    watcher = await ModelWatcher(
        frt, svc.models, reliability_metrics=svc.reliability).start()
    await register_model(frt.kv, model, ns, "backend", card,
                         model_type="chat")
    rec = {"reference_s": ref_s}
    try:
        async def listed():
            return model in svc.models.chat
        await _poll(f"{name}: the frontend listing {model}", listed, 60,
                    0.02)

        async def serve(rnd):
            out = []
            for i, b in enumerate(chats[rnd]):
                n0 = len(decode.streams)
                frames, done, _, _ = await _sse(svc.port, b)
                check(len(decode.streams) == n0 + 1, f"{name}: {rnd}-{i} "
                      f"reached the decode worker "
                      f"{len(decode.streams) - n0} times")
                usage = [f["usage"] for f in frames if f.get("usage")]
                finish = [c.get("finish_reason") for f in frames
                          for c in f.get("choices", [])
                          if c.get("finish_reason")]
                check(done and finish == ["length"] and usage
                      and usage[-1]["completion_tokens"] == n_tok
                      and not any("error" in f for f in frames),
                      f"{name}: {rnd}-{i} ended {finish}, usage {usage}, "
                      f"[DONE] {done}")
                toks = decode.streams[-1]
                check(len(toks) == n_tok, f"{name}: {rnd}-{i} served "
                      f"{len(toks)} tokens")
                out.append({"tokens": toks, "divergence": hold(
                    f"{rnd}-{i}", toks, refs[rnd][i])})
            return out

        # T: traced and clean
        t0 = time.perf_counter()
        streams_t = await serve("T")
        rec["round_t_s"] = time.perf_counter() - t0
        spans_t = TRACER.drain()
        root = os.path.dirname(os.path.abspath(__file__))
        os.makedirs(os.path.join(root, "build"), exist_ok=True)
        write_spans(os.path.join(root, "build", "trace_p20.jsonl"), spans_t)
        traces = request_traces(spans_t)
        check(len(traces) == len(chats["T"]), f"{name}: {len(traces)} "
              f"request traces for {len(chats['T'])} chats")
        split = {}
        by_rid = {}
        for tid, mine in traces.items():
            ids = {s["span_id"] for s in mine}
            roots = [s["name"] for s in mine if s["parent_id"] not in ids]
            check(roots == ["http.request"] and all(
                s["parent_id"] in ids for s in mine
                if s["name"] != "http.request"),
                f"{name}: trace {tid} is no single tree under http.request "
                f"(roots {roots})")
            names = {s["name"] for s in mine}
            missing = [n for n in TRACED_LEGS if n not in names]
            check(not missing, f"{name}: trace {tid} lacks {missing}")
            rid = next(s for s in mine if s["name"] == "prefill.remote"
                       )["attrs"]["request_id"]
            by_rid[rid] = mine
        for i, got in enumerate(streams_t):
            ref = refs["T"][i]
            mine = next(m for m in by_rid.values() if any(
                s["name"] == "prefill.run"
                and s["attrs"]["tokens"] == len(ref["prompt"]) for s in m))
            xs = [s for s in mine if s["name"] == "kv.transfer"]
            chunks = [s for s in mine if s["name"] == "kv.transfer.chunk"]
            emitted = sum(s["attrs"]["n"] for s in mine
                          if s["name"] == "decode.emit")
            pages = ref["pages"]
            nbytes = wire_pages(pages, chunk_pages) * page_bytes
            check(len(xs) == 1 and xs[0]["attrs"]["pages"] == pages
                  and xs[0]["attrs"]["bytes"] == nbytes
                  and len(chunks) == -(-pages // chunk_pages)
                  and emitted == len(got["tokens"]),
                  f"{name}: T-{i}: transfers {[x['attrs'] for x in xs]}, "
                  f"{len(chunks)} chunk spans, emits of {emitted} tokens; "
                  f"derived {pages} pages, {nbytes} bytes on the wire, "
                  f"{-(-pages // chunk_pages)} chunks, "
                  f"{len(got['tokens'])} tokens")
            split[f"T-{i}"] = dict(traced_split(mine), pages=pages,
                                   tokens=len(ref["prompt"]))
        check(any(s["trace_id"] == "scope:engine" for s in spans_t),
              f"{name}: no scope:engine record in round T")
        rec["round_t"] = {"split": split, "divergence": [
            g["divergence"] for g in streams_t], "spans": len(spans_t)}
        print(f"{name} [{smi}]: round T, 4 traced chats one at a time in "
              f"{rec['round_t_s']:.3f} s ({len(spans_t)} spans, "
              f"build/trace_p20.jsonl): per request "
              f"{json.dumps(split)}", flush=True)
        print("\n".join(f"  {line}" for line in
                        summarize(spans_t).splitlines()), flush=True)

        async def storm(rnd, sender):
            """The chats of `rnd` under STORM_PLAN through `sender`: the
            gates that hold at any window."""
            metrics0 = (await _http(svc.port, "GET", "/metrics"))[2].decode()
            x0, i0 = XFER_STATS.snapshot(), INTEGRITY.snapshot()
            recv0, salv0 = server.received_pages, decode.salvaged_prefills
            full0 = decode.full_reprefills
            faults.REGISTRY.reset_counters()
            faults.REGISTRY.arm_from_dict(STORM_PLAN)
            prefill.transfer = sender
            try:
                t0 = time.perf_counter()
                streams = await serve(rnd)
                secs = time.perf_counter() - t0
            finally:
                snap = faults.REGISTRY.snapshot()
                faults.REGISTRY.disarm()
                prefill.transfer = tx
            spans = TRACER.drain()
            write_spans(os.path.join(root, "build",
                                     f"trace_p20_storm_{rnd}.jsonl"), spans)
            metrics1 = (await _http(svc.port, "GET", "/metrics"))[2].decode()
            xd = {k: v - x0[k] for k, v in XFER_STATS.snapshot().items()}
            idl = {k: v - i0[k] for k, v in INTEGRITY.snapshot().items()}
            xfer = [s for s in spans if s["name"] == "kv.transfer"]
            gave_up = [s for s in xfer if s["error"]]
            absorbed = (sum(s["attrs"].get("resumes", 0) for s in xfer
                            if not s["error"])
                        + len(gave_up) * (sender.link_retries + 1))
            drops = snap["injected"].get("transfer.link", 0)
            resume_events = sum(s["name"] == "kv.transfer.resume"
                                for s in spans)
            salvaged = decode.salvaged_prefills - salv0
            received = server.received_pages - recv0
            want_pages = sum(r["pages"] for r in refs[rnd])
            rel = {k: reliability_counts(metrics1)[k]
                   - reliability_counts(metrics0)[k]
                   for k in ("migrations", "retries")}
            label = f"{name} {rnd} (window {sender.window_chunks})"
            check(drops == absorbed, f"{label}: {drops} transfer.link "
                  f"drops fired, {absorbed} absorbed by reconnects "
                  f"({len(gave_up)} transfers gave up)")
            check(xd["resumes"] == resume_events,
                  f"{label}: XFER_STATS.resumes {xd['resumes']}, "
                  f"{resume_events} kv.transfer.resume events")
            # a transfer that gave up keeps its committed pages (salvaged),
            # and its decode side prefills only the rest; no committed
            # page lands twice, whatever the window
            want_injected = (want_pages - sum(s["attrs"]["pages"]
                                              for s in gave_up)
                             + xd["salvaged_pages"])
            check(salvaged == len(gave_up)
                  and decode.full_reprefills == full0
                  and received == want_injected,
                  f"{label}: {received} pages injected for {want_pages} "
                  f"derived, {salvaged} salvages for {len(gave_up)} "
                  f"transfers given up, {decode.full_reprefills - full0} "
                  f"full re-prefills, {xd['salvaged_pages']} pages "
                  "salvaged")
            check(idl["mismatches"] == 1
                  and idl["pages_verified"] == received,
                  f"{label}: integrity deltas {idl} for {received} pages "
                  "injected, expected 1 mismatch refused and every "
                  "injected page verified")
            check(rel == {"migrations": 0, "retries": 0},
                  f"{label}: the frontend's reliability counters moved: "
                  f"{rel}")
            check(not faults.REGISTRY.enabled, f"{label}: faults still "
                  "armed")
            out = {"faults": snap, "xfer": xd, "integrity": idl,
                   "salvaged": salvaged, "gave_up": len(gave_up),
                   "resume_events": resume_events, "pages": received,
                   "seconds": secs, "divergence": [g["divergence"]
                                                   for g in streams]}
            print(f"{label} [{smi}]: under the storm in {secs:.3f} s: "
                  f"{drops} link drops absorbed ({len(gave_up)} transfers "
                  f"gave up, {salvaged} salvages), {xd['resumes']} resumes "
                  f"= resume events, {received} pages injected of "
                  f"{want_pages}, integrity {json.dumps(idl)}, queue "
                  f"delays {snap['injected'].get('queue.dequeue', 0)}, 0 "
                  f"migrations, 0 retries; first differences "
                  f"{out['divergence']}", flush=True)
            return streams, out

        # S: the same under a storm, through a stop-and-wait sender as the
        # JAX storm's: at a cut the committed frontier is the chunks acked,
        # so a cut past the first chunk resumes and a refused chunk's nack
        # is read before the next chunk is sent
        streams_s, rec["round_s"] = await storm("S", tx_s)
        xs, ids = rec["round_s"]["xfer"], rec["round_s"]["integrity"]
        check(xs["resumes"] >= 1 and ids["refetches"] == 1,
              f"{name}: round S resumed {xs['resumes']} time(s) and "
              f"re-sent {ids['refetches']} chunk(s); expected a resume and "
              "the refused chunk re-sent once")
        # W: the serving sender (a window of 4) under the same plan: a cut
        # can land before any ack, and the reconnected handshake can read
        # the frontier while the cut connection's chunks still inject
        streams_w, rec["round_w"] = await storm("W", tx)
    finally:
        faults.REGISTRY.disarm()
        await watcher.stop()
        await svc.stop()
        await prefill.stop()
        await decode.stop()
        await server.stop()
        await tx.close()
        await tx_s.close()
        await frt.shutdown()
        await wrt.shutdown()

    # L: the local backend's staging hop between the same two engines
    queue_l = PrefillQueue(plane.messaging, ns, model + "-local")
    dec_l = DisaggDecodeWorker(dec_eng, plane.messaging, router, queue_l,
                               worker_id="dec-L", prefill_timeout_s=300.0)
    local = LocalTransferBackend()
    local.register("dec-L", dec_l)
    pre_l = PrefillWorker(llm_worker.NativeEngineWorker(pre_eng), queue_l,
                          local, plane.messaging, dequeue_timeout_s=0.05)
    i0 = INTEGRITY.snapshot()
    await dec_l.start()
    await pre_l.start()
    faults.REGISTRY.arm_from_dict({"remote_transfer.fetch_page":
                                   STORM_PLAN["remote_transfer.fetch_page"]})
    try:
        ref = refs["L"][0]
        toks = []
        async for f in dec_l.generate(ref["pre"], Context("L-0")):
            check(f.finish_reason is None or f.finish_reason.value in (
                "length", "stop"), f"{name}: L-0 ended {f}")
            toks.extend(f.token_ids or ())
    finally:
        faults.REGISTRY.disarm()
        await pre_l.stop()
        await dec_l.stop()
    idl = {k: v - i0[k] for k, v in INTEGRITY.snapshot().items()}
    check(idl["refetches"] == 1 and idl["mismatches"] >= 1
          and idl["pages_verified"] == ref["pages"]
          and dec_l.remote_prefills == 1 and dec_l.full_reprefills == 0,
          f"{name}: L-0 integrity {idl} for {ref['pages']} pages, remote "
          f"{dec_l.remote_prefills}, full re-prefills "
          f"{dec_l.full_reprefills}")
    rec["round_l"] = {"integrity": idl, "divergence": hold("L-0", toks, ref),
                      "tokens": len(toks)}

    # P: the profiler hook on a fresh worker over the decode engine
    prof_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "build", "torch_profile_p20")
    os.environ[llm_worker.PROFILE_DIR_ENV] = prof_dir
    try:
        w = await llm_worker.NativeEngineWorker(dec_eng).start()
        check(w.profile_path is not None, f"{name}: the worker did not "
              "start the profiler")
        ref = refs["P"][0]
        toks_p = []
        try:
            async for f in w.generate(ref["pre"], Context("P-0")):
                toks_p.extend(f.token_ids or ())
        finally:
            await w.stop()
    finally:
        os.environ.pop(llm_worker.PROFILE_DIR_ENV, None)
    with open(w.profile_path) as f:
        events = json.load(f)["traceEvents"]
    kern = [e for e in events if e.get("cat") == "kernel"
            and "ragged_split_kernel" in e.get("name", "")]
    n_layers = mcfg.num_layers
    derived_p = n_layers * window_steps(len(toks_p))
    check(device != "cuda" or kern, f"{name}: the profiler's trace "
          f"({len(events)} events) names no ragged_split_kernel")
    rec["round_p"] = {"trace": os.path.relpath(w.profile_path, root),
                      "events": len(events), "ragged_kernel_events":
                      len(kern), "derived_launches": derived_p,
                      "tokens": len(toks_p)}
    print(f"{name} [{smi}]: round L re-fetched {idl['refetches']} time(s), "
          f"{idl['pages_verified']} pages verified before their inject, "
          f"stream {rec['round_l']['divergence'] or 'identical'}; round P "
          f"profiled {len(toks_p)} tokens: {len(events)} trace events, "
          f"{len(kern)} ragged_split_kernel events beside {derived_p} "
          f"derived launches ({n_layers} x {window_steps(len(toks_p))} "
          "steps)", flush=True)
    TRACER.configure(enabled=saved_trace[0], sample_rate=saved_trace[1])
    TRACER.reset()

    # the launches over the phase
    got = launch_counts()[RAGGED]
    served = ([len(g["tokens"]) for g in streams_t + streams_s + streams_w]
              + [len(toks)])
    steps = sum(window_steps(n - 1) for n in served) \
        + window_steps(len(toks_p))
    warm = dec_eng.graphs.warmup_launches[RAGGED] - warm0["decode"][RAGGED]
    pre_launches = (pre_eng.graphs.warmup_launches[RAGGED]
                    - warm0["prefill"][RAGGED]
                    + pre_eng.graphs.replay_launches[RAGGED]
                    - replay0["prefill"][RAGGED])
    ran = dec_eng.decode_window_steps - steps0
    check(ran == steps, f"{name}: the decode engine ran {ran} decode "
          f"steps, the streams derive {steps}")
    check(device != "cuda" or (got == n_layers * steps + warm
                               and pre_launches == 0),
          f"{name}: {got} ragged launches; {n_layers} x {steps} derived "
          f"decode steps + {warm} in warm-ups; the prefill engine's "
          f"{pre_launches}")
    rec["launches"] = {"decode": got, "prefill": pre_launches,
                       "derived_steps": steps, "warmup": warm}
    rec["phase_s"] = time.perf_counter() - t_phase
    del dec_eng, pre_eng
    if device == "cuda":
        torch.cuda.empty_cache()
    return rec


# -- phase 21: the fleet storms ----------------------------------------------------

def phase_storms(smi: str, device: str = "cuda", beside=None) -> tuple:
    """21: `tools/torch_fleet_storm.py --mode slo --quick` and `--mode
    autoscale --quick` as two processes at once, their live engines on
    `device`: each exits 0 with every contract met. `beside()` (another
    phase) runs in this process meanwhile. Returns (each mode's contracts
    and seconds, what `beside()` returned)."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    procs = {mode: subprocess.Popen(
        [sys.executable, os.path.join(root, "tools", "torch_fleet_storm.py"),
         "--mode", mode, "--quick", "--no-artifact", "--device", device],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for mode in ("slo", "autoscale")}
    out = {}
    try:
        side = beside() if beside is not None else None
        for mode, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=300)
            lines = stdout.splitlines()
            start = lines.index("{") if "{" in lines else len(lines)
            report = json.loads("\n".join(lines[start:]) or "{}")
            contracts = report.get("contracts", {})
            check(proc.returncode == 0 and contracts
                  and all(contracts.values()),
                  f"storms: --mode {mode} exited {proc.returncode} with "
                  f"contracts {contracts}:\n{stdout[-1500:]}\n"
                  f"{stderr[-1500:]}")
            out[mode] = {"contracts": contracts,
                         "seconds": time.perf_counter() - t0,
                         "elapsed_s": report.get("elapsed_s")}
            if mode == "autoscale":
                out[mode]["budget_tuning"] = report["budget_tuning"]
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(30)
    print(f"storms [{smi}; the live engines on {device}]: "
          f"{json.dumps(out)}", flush=True)
    print(f"phase seconds: 21 {time.perf_counter() - t0:.1f}", flush=True)
    return out, side


# -- phase 22: tensor parallelism ----------------------------------------------

TP_RESULT = "PHASE22 "      # a child's result line: this prefix, then JSON
TP_LAYERS = 8               # 22a's depth of llama3-8b's 32, 22b's of 70b's 80
TP_RANKS = 4                # 22b: llama3-70b's tp-4 ranks, on one card
TP_MAX_TOKENS = 32          # 22b's tokens a chat
TP_SAMPLED_TOP_K = 50       # chat_requests' top_k on its sampled chats


def tp_requests(card, max_tokens: int, logprobs=None,
                ignore_eos: bool = False) -> list:
    """Phase 4's 8 chats (even ones greedy, odd ones seeded-sampled) as
    engine requests through the card's preprocessor and template."""
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.llm.worker import to_engine_request
    pre = OpenAIPreprocessor(card)
    out = []
    for i, req in enumerate(chat_requests(card.name, max_tokens=max_tokens)):
        er = to_engine_request(pre.preprocess_chat(req, f"tp-{i}")[0])
        er.params = dataclasses.replace(er.params, logprobs=logprobs,
                                        ignore_eos=ignore_eos)
        out.append(er)
    return out


def tp_drive(engine, reqs: list, tag: str, together: bool) -> dict:
    """The requests through engine.add_request / step, one at a time or
    admitted together: each stream's ids and, with logprobs, its top-1 less
    top-2 a token; the seconds."""
    streams = {}

    def run(rids):
        while any(not streams[r][2] for r in rids):
            for ev in engine.step():
                ids, gaps, _ = streams[ev.request_id]
                if ev.token is not None:
                    ids.append(ev.token)
                    tops = ev.top_logprobs or []
                    gaps.append(tops[0][1] - tops[1][1] if len(tops) > 1
                                else None)
                if ev.finished:
                    streams[ev.request_id] = (ids, gaps, True)
    t0 = time.perf_counter()
    rids = []
    for i, er in enumerate(reqs):
        rid = f"{tag}-{i}"
        rids.append(rid)
        streams[rid] = ([], [], False)
        engine.add_request(dataclasses.replace(er, request_id=rid))
        if not together:
            run([rid])
    run(rids)
    engine._sync_stream()
    return {"streams": [streams[r][:2] for r in rids],
            "seconds": time.perf_counter() - t0}


def traced_step(engine, prompts: list) -> dict:
    """One steady decode step of the prompts (greedy, ignore_eos), the
    window graph it replays traced by torch.profiler: the CUDA kernels the
    trace names, by count."""
    from torch.profiler import ProfilerActivity, profile
    from dynamo_tpu_torch.engine.scheduler import EngineRequest, SamplingParams
    for i, p in enumerate(prompts):
        engine.add_request(EngineRequest(f"prof-{i}", list(p), SamplingParams(
            max_tokens=8 * engine.cfg.decode_steps, temperature=0.0,
            ignore_eos=True)))
    while engine.scheduler.waiting or engine._pipeline is None:
        engine.step()
    engine._sync_stream()
    for _ in range(4):     # a step whose follow-up window is refused
        r0 = engine.graphs.replays   # replays none: trace the next one
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            engine.step()
            engine._sync_stream()
        if engine.graphs.replays == r0 + 1:
            break
    check(engine.graphs.replays == r0 + 1, "the traced step replayed "
          f"{engine.graphs.replays - r0} window graphs, expected 1")
    names = {}
    for e in prof.key_averages():
        if e.self_device_time_total > 0:
            names[e.key] = names.get(e.key, 0) + e.count
    for i in range(len(prompts)):
        engine.abort(f"prof-{i}")
    while engine.has_work():
        engine.step()
    engine._sync_stream()
    return names


def phase_tp_one(smi: str) -> dict:
    """22a: llama3-8b at full width (TP_LAYERS of its 32 layers), bf16,
    default EngineConfig, phase 4's chats one at a time with ignore_eos
    (every stream MAX_TOKENS long, so its decode steps follow from its
    length), two rounds (capturing, measured), on an engine with no group
    and then on the tp launcher's engine on an NCCL group of one. Gates:
    the streams of the two engines token-identical; per round ragged
    launches = layers x the steps derived from the streams + the warm-ups'
    launches; one replay a window; no capture in the measured round; on
    the group's engine every window graph holds (2 L + 1) x nw + 1
    captured all-reduce calls (two a layer, the vocab gather a step, the
    token check a window), and their replays add that many. Reported: the
    profiler's kernels in one replayed window of each engine (at one rank
    NCCL launches nothing for an in-place sum), ms a decode step of both."""
    import gc
    import torch
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import NativeEngine
    from dynamo_tpu_torch.parallel.launch import tp_engine
    from dynamo_tpu_torch.run import build_card
    card = build_card("llama3-8b")
    cfg = dataclasses.replace(card.model_config(), num_layers=TP_LAYERS)
    reqs = tp_requests(card, MAX_TOKENS, ignore_eos=True)
    prompts = [er.prompt for er in reqs]
    n_l = cfg.num_layers
    out = {}

    def serve(engine, label: str) -> dict:
        rec = {}
        g = engine.graphs
        for rnd in ("capture", "measured"):
            cap0, rep0 = g.captured, g.replays
            warm0 = g.warmup_launches[RAGGED]
            coll0 = g.replay_collectives["tp_all_reduce"]
            before = {k: getattr(engine, k) for k in COUNTERS}
            reset_launch_counts()
            res = tp_drive(engine, reqs, f"{label}-{rnd}", together=False)
            launches = launch_counts()[RAGGED]
            d = {k: getattr(engine, k) - v for k, v in before.items()}
            lens = [len(ids) for ids, _ in res["streams"]]
            check(lens == [MAX_TOKENS] * len(reqs),
                  f"22a {label} {rnd}: stream lengths {lens}")
            derived = sum(window_steps(n) for n in lens)
            warm = g.warmup_launches[RAGGED] - warm0
            check(d["decode_window_steps"] == derived,
                  f"22a {label} {rnd}: {d['decode_window_steps']} decode "
                  f"steps, derived from the streams {derived}")
            check(launches == n_l * derived + warm,
                  f"22a {label} {rnd}: ragged launches {launches}, expected "
                  f"{n_l} x {derived} + {warm} of the warm-ups")
            check(d["decode_dispatches"] == d["decode_windows"]
                  == g.replays - rep0 > 0,
                  f"22a {label} {rnd}: counters {d}, replays "
                  f"{g.replays - rep0}")
            if rnd == "measured":
                check(g.captured == cap0, f"22a {label}: "
                      f"{g.captured - cap0} graphs captured in the measured "
                      "round")
            rec[rnd] = {"streams": [ids for ids, _ in res["streams"]],
                        "seconds": res["seconds"], "launches": launches,
                        "derived_steps": derived, "warmup_launches": warm,
                        "windows": d["decode_windows"],
                        "collectives": g.replay_collectives[
                            "tp_all_reduce"] - coll0}
        if engine._comm is not None:
            for key, calls in g.captured_collectives().items():
                nw = key[4]
                want = (2 * n_l + 1) * nw + 1
                check(calls["tp_all_reduce"] == want,
                      f"22a: the window graph {key} holds "
                      f"{calls['tp_all_reduce']} all-reduce calls, expected "
                      f"(2 x {n_l} + 1) x {nw} + 1 = {want}")
        rec["ms_per_step"] = steady_ms_per_step(engine, prompts)
        trace = traced_step(engine, prompts)
        split = sum(n for k, n in trace.items() if "ragged_split_kernel" in k)
        check(split > 0 and split % n_l == 0,
              f"22a {label}: the traced window ran ragged_split_kernel "
              f"{split} times, not a multiple of {n_l} layers")
        rec["trace"] = {"kernels": sum(trace.values()),
                        "ragged_split_kernel": split}
        rec["nccl_kernels_in_trace"] = {k: v for k, v in trace.items()
                                        if "nccl" in k.lower()}
        rec["graphs_captured"] = g.captured
        return rec

    t0 = time.perf_counter()
    engine = NativeEngine(cfg, EngineConfig(),
                          eos_token_ids=set(card.eos_token_ids), seed=0,
                          device="cuda")
    out["no_group"] = serve(engine, "no group")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase seconds: 22a no group {time.perf_counter() - t0:.1f}",
          flush=True)
    t0 = time.perf_counter()
    with tp_engine(cfg, EngineConfig(tp=1), device="cuda", seed=0,
                   eos_token_ids=card.eos_token_ids) as engine:
        check(engine._comm.backend == "nccl" and engine._comm.size == 1
              and engine.window_graph_mode == "on",
              f"22a: the launcher's engine holds {engine._comm.backend} x "
              f"{engine._comm.size}, window graphs {engine.window_graph_mode}")
        out["group_of_one"] = serve(engine, "NCCL group of one")
        ranks = engine.tp_stats(sync=True)
    print(f"phase seconds: 22a group of one {time.perf_counter() - t0:.1f}",
          flush=True)
    a, b = out["no_group"], out["group_of_one"]
    for rnd in ("capture", "measured"):
        check(a[rnd]["streams"] == b[rnd]["streams"],
              f"22a {rnd}: the group of one's streams differ from the "
              "engine's without a group")
    check(a["measured"]["collectives"] == 0
          and b["measured"]["collectives"] > 0,
          f"22a: collectives replayed {a['measured']['collectives']} / "
          f"{b['measured']['collectives']}")
    check(ranks[0]["token_mismatches"] == 0, f"22a: {ranks}")
    for label, r in out.items():
        for rnd in ("capture", "measured"):
            r[rnd].pop("streams")
    print(f"22a [{smi}]: streams identical (2 rounds x 8 chats of "
          f"{MAX_TOKENS} tokens); ms a decode step "
          f"{a['ms_per_step']:.3f} without a group, "
          f"{b['ms_per_step']:.3f} on the NCCL group of one; collectives "
          f"replayed in the measured round {b['measured']['collectives']}; "
          f"NCCL kernels the profiler saw in a replayed window "
          f"{b['nccl_kernels_in_trace'] or 'none'}", flush=True)
    return out


def rank_weight_bytes(cfg, tp: int, rank: int) -> int:
    """The bytes of rank's Megatron shard, from the config alone: q, k, v
    and wo by heads, w_gate / w_up / w_down by the FFN width, lm_head by
    ceil(V / tp) columns (the last rank's shorter), norms and embed whole."""
    d, hd, f, v = (cfg.hidden_size, cfg.head_dim, cfg.intermediate_size,
                   cfg.vocab_size)
    h, hkv = cfg.num_heads // tp, max(1, cfg.num_kv_heads // tp)
    per_layer = (2 * d + d * h * hd * 2 + d * hkv * hd * 2
                 + 3 * d * (f // tp))
    step = -(-v // tp)
    cols = max(0, min(v, (rank + 1) * step) - rank * step)
    head = 0 if cfg.tie_word_embeddings else d * cols
    n = cfg.num_layers * per_layer + v * d + d + head
    return n * (2 if cfg.dtype == "bfloat16" else 4)


def sampled_gap(cfg, params, context: list, er, counter: int,
                device: str = "cuda") -> float:
    """Top-1 less top-2, in logit units, of the sampler's scores at the
    last position of `context` (one plain forward of it on a cache of its
    own): the scaled logits with top-k kept plus the Gumbel noise of
    (seed, counter), times the temperature. A perturbation of the logits
    smaller than this cannot change the sampled token."""
    import torch
    from dynamo_tpu_torch.engine.sampler import _uniform01, make_keys
    from dynamo_tpu_torch.models import llama
    n, ps = len(context), PS
    pages = -(-n // ps)
    cache = llama.init_cache(cfg, pages + 1, ps, device)
    i32 = dict(dtype=torch.int32, device=device)
    meta = llama.AttnMetadata(
        positions=torch.arange(n, **i32)[None],
        page_table=torch.arange(pages, **i32)[None],
        kv_lens=torch.tensor([n], **i32),
        write_idx=torch.arange(n, **i32)[None])
    logits, _ = llama.forward(params, cfg, torch.tensor([context], **i32),
                              cache, meta, last_idx=torch.tensor([n - 1],
                                                                 **i32))
    t = float(er.params.temperature)
    scaled = logits[0].float() / t
    keep = torch.topk(scaled, er.params.top_k).indices
    keys = make_keys(torch.tensor([er.params.seed], **i32),
                     torch.tensor([counter], **i32))
    noise = -torch.log(-torch.log(_uniform01(keys, scaled.numel())[0]))
    top2 = torch.topk((scaled + noise)[keep], 2).values
    return float(top2[0] - top2[1]) * t


def phase_tp_70b(smi: str, model: str = "llama3-70b", device: str = "cuda",
                 layers: int = TP_LAYERS, tp: int = TP_RANKS,
                 dtype: str = "") -> dict:
    """22b: llama3-70b at full width (TP_LAYERS of its 80 layers), bf16,
    seed 0, default EngineConfig; phase 4's 8 chats admitted together,
    TP_MAX_TOKENS each, half greedy and half seeded-sampled, top-2
    logprobs. First the whole tree on one process at tp 1 (the reference),
    freed; then TP_RANKS rank processes on cuda:0 over gloo (the
    launcher's backend argument: NCCL refuses two ranks on one card), each
    drawing its shard of the same seeded draws. Gates: every stream equal
    to the reference's or first differing at a near tie (greedy: the
    reference's top-1 less top-2; sampled: the sampler's scores, recomputed
    by `sampled_gap`); every rank's tokens rank 0's (no on-device mismatch,
    equal digests); each rank's weight bytes those `rank_weight_bytes`
    derives; each rank's ragged launches = layers x its decode steps
    (eager windows: no warm-ups), its cache at Hkv / tp kv heads; window
    graphs "off (gloo)" on every rank, every window eager. Reported: ms a
    decode step at tp 4 (gloo) beside tp 1, each rank's peak memory (the
    ranks share the card and its SMs). `model`, `device`, `layers`, `tp`
    and `dtype` size a rehearsal on the CPU (gloo ranks there too)."""
    import gc
    import torch
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import NativeEngine
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.parallel.launch import tp_engine
    from dynamo_tpu_torch.run import build_card
    cuda = device == "cuda"
    card = build_card(model)
    cfg = dataclasses.replace(card.model_config(), num_layers=layers,
                              dtype=dtype or card.model_config().dtype)
    reqs = tp_requests(card, TP_MAX_TOKENS, logprobs=2)
    prompts = [er.prompt for er in reqs]
    n_prompt = [len(p) for p in prompts]
    check(min(n_prompt) >= 100 and max(n_prompt) <= 600,
          f"22b: prompt lengths {n_prompt} outside 100-600")
    out = {"prompt_tokens": n_prompt}
    t0 = time.perf_counter()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    engine = NativeEngine(cfg, EngineConfig(),
                          eos_token_ids=set(card.eos_token_ids), seed=0,
                          device=device)
    ref = tp_drive(engine, reqs, "ref", together=True)
    ref_ms = steady_ms_per_step(engine, prompts)
    out["tp1"] = {"weight_bytes": engine.metrics().weight_bytes,
                  "peak_bytes": (torch.cuda.max_memory_allocated() if cuda
                                 else 0),
                  "ms_per_step": ref_ms, "seconds": ref["seconds"]}
    del engine
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        # rank 0's peak is its own, not the reference's
        torch.cuda.reset_peak_memory_stats()
    print(f"phase seconds: 22b tp 1 {time.perf_counter() - t0:.1f}",
          flush=True)
    t0 = time.perf_counter()
    with tp_engine(cfg, EngineConfig(tp=tp), device=device, backend="gloo",
                   devices=[f"{device}:0" if cuda else "cpu"] * tp, seed=0,
                   eos_token_ids=card.eos_token_ids) as engine:
        ready_s = time.perf_counter() - t0
        s0 = engine.tp_stats(sync=True)
        got = tp_drive(engine, reqs, "tp", together=True)
        s1 = engine.tp_stats(sync=True)
        tp_ms = steady_ms_per_step(engine, prompts)
        mode = engine.window_graph_mode
    print(f"phase seconds: 22b tp {tp} {time.perf_counter() - t0:.1f}",
          flush=True)
    want_mode = "off (gloo)" if cuda else "off (cpu)"
    check(mode == want_mode, f"22b: window graphs {mode!r}")
    firsts, params = [], None
    for i, (er, (ids, _), (rids, gaps)) in enumerate(
            zip(reqs, got["streams"], ref["streams"])):
        d = next((j for j, (a, b) in enumerate(zip(ids, rids)) if a != b),
                 None)
        if d is None:
            check(len(ids) == len(rids), f"22b: chat {i} holds {len(ids)} "
                  f"tokens, the reference {len(rids)}")
            firsts.append(None)
            continue
        if er.params.temperature <= 0:
            gap = gaps[d]
        else:
            if params is None:
                params = llama.init_params(cfg, device, 0)
            gap = sampled_gap(cfg, params, list(er.prompt) + rids[:d], er, d,
                              device)
        check(gap is not None and gap <= NEAR_TIE,
              f"22b: chat {i} at tp {tp} leaves the tp-1 stream at "
              f"token {d}, where the top-1 less top-2 is {gap} (a near tie "
              f"is <= {NEAR_TIE})")
        firsts.append([d, round(gap, 6)])
    del params
    ranks = []
    for a, b in zip(s0, s1):
        r = b["rank"]
        launches = (b["kernel_launches"][RAGGED]
                    - a["kernel_launches"][RAGGED])
        steps = b["decode_window_steps"] - a["decode_window_steps"]
        windows = b["decode_windows"] - a["decode_windows"]
        want_bytes = rank_weight_bytes(cfg, tp, r)
        check(b["token_mismatches"] == 0
              and b["token_digest"] == s1[0]["token_digest"],
              f"22b: rank {r} sampled other tokens than rank 0: {b}")
        check(b["weight_bytes"] == want_bytes,
              f"22b: rank {r} holds {b['weight_bytes']} weight bytes, the "
              f"config and the specs give {want_bytes}")
        check(b["kv_heads"] == cfg.num_kv_heads // tp,
              f"22b: rank {r}'s cache holds {b['kv_heads']} kv heads")
        # the plain version (CPU tensors) counts no launch
        check(steps == s1[0]["decode_window_steps"]
              - s0[0]["decode_window_steps"] > 0
              and launches == (cfg.num_layers * steps if cuda else 0),
              f"22b: rank {r}: ragged launches {launches}, expected "
              f"{cfg.num_layers} x {steps} decode steps (rank 0's "
              f"{s1[0]['decode_window_steps'] - s0[0]['decode_window_steps']})")
        check(b["window_graphs"] == want_mode
              and b["eager_windows"] - a["eager_windows"] == windows > 0
              and b["graphs_captured"] == 0,
              f"22b: rank {r}: window graphs {b['window_graphs']}, "
              f"{b['eager_windows'] - a['eager_windows']} eager of "
              f"{windows} windows, {b['graphs_captured']} captured")
        ranks.append({"rank": r, "ragged_launches": launches,
                      "decode_steps": steps, "windows": windows,
                      "all_reduces": b["all_reduces"] - a["all_reduces"],
                      "weight_bytes": b["weight_bytes"],
                      "peak_bytes": b.get("peak_bytes", 0),
                      "kv_heads": b["kv_heads"]})
    out.update(ranks=ranks, first_differences=firsts, ready_s=ready_s,
               tp_ms_per_step=tp_ms, seconds=got["seconds"],
               same=sum(f is None for f in firsts))
    print(f"22b [{smi}]: {model} ({layers} layers) at tp "
          f"{tp} over gloo on one card: {out['same']} of {len(reqs)} "
          f"streams identical to tp 1, first differences {firsts}; every "
          f"rank's tokens rank 0's; ragged launches "
          f"{[x['ragged_launches'] for x in ranks]} = {cfg.num_layers} x "
          f"{ranks[0]['decode_steps']} decode steps a rank at "
          f"{ranks[0]['kv_heads']} kv heads; weight bytes "
          f"{[x['weight_bytes'] for x in ranks]} (tp 1 "
          f"{out['tp1']['weight_bytes']}); peak GiB a rank "
          f"{[round(x['peak_bytes'] / 2**30, 2) for x in ranks]} (tp 1 "
          f"{out['tp1']['peak_bytes'] / 2**30:.2f}); ms a decode step "
          f"{tp_ms:.3f} at tp {tp} (gloo, eager windows, the ranks' "
          f"processes sharing the card) beside {ref_ms:.3f} at tp 1 (graph "
          f"windows); ranks ready in {ready_s:.1f} s", flush=True)
    return out


def tp_main(part: str) -> int:
    """`chip_smoke.py --phase-tp 22a|22b`: that part of phase 22 alone, in
    the process main() starts for it, on kernels main() has built; its
    last line is the result (TP_RESULT + JSON)."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke --phase-tp: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fn = {"22a": phase_tp_one, "22b": phase_tp_70b}[part]
    rec = fn(nvidia_smi())
    print(TP_RESULT + json.dumps(rec), flush=True)
    return 0


def phase_tp_child(part: str) -> dict:
    """A part of phase 22 in a child process of its own (its ranks are
    processes too): the engines of earlier phases keep device memory in
    this one. The child's output passes through; a non-zero exit or a
    missing result line fails the run."""
    import gc
    import torch
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--phase-tp", part],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    result, tail = None, []
    try:
        for line in proc.stdout:
            if line.startswith(TP_RESULT):
                result = json.loads(line[len(TP_RESULT):])
            else:
                print(line, end="", flush=True)
                tail = (tail + [line.rstrip("\n")])[-25:]
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    check(rc == 0 and result is not None,
          f"phase {part} (child process) exited {rc}"
          f"{'' if result is not None else ' without its result line'}"
          "; last output:\n" + "\n".join(tail))
    return result


def timed(name: str, fn, *args, **kw):
    """fn(*args, **kw), its wall-clock seconds printed on a line of its
    own (the time limit's budget by phase)."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    print(f"phase seconds: {name} {time.perf_counter() - t0:.1f}",
          flush=True)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one "
              "card", file=sys.stderr)
        return 2
    from dynamo_tpu_torch.ops import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()
    smi = nvidia_smi()
    print(f"device: {smi}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    logs = build.build()
    print(f"build: {sorted(logs) or 'cached'} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(f"phase seconds: 1 {time.perf_counter() - t0:.1f}", flush=True)
    for name, log in logs.items():
        for line in ptxas_lines(log):
            print(f"  {name}: {line}", flush=True)
            check(" 0 bytes spill stores" in line or "spill" not in line,
                  f"{name}: ptxas spills: {line}")

    err_bf16 = timed("2a", phase_kernel)
    err_int8 = timed("2b", phase_kernel_int8)
    geometries = timed("2a geometries", phase_kernel_geometries)
    err_legacy = timed("2c", phase_legacy)
    err_w8, w8_timing, dequant_timing, large_m = timed("2d", phase_w8a16)
    t0 = time.perf_counter()
    phase_small_reference()
    phase_small_reference("int8")
    f32_int8 = phase_small_reference(quant="int8")
    check(f32_int8[DEQUANT] > 0 and f32_int8[LARGE_M] == 0,
          f"tiny f32 int8 on the card launched {f32_int8}: an f32 x past "
          "GEMV_MAX_M rows takes the dequantize entry, never the "
          "tensor-core kernel")
    phase_small_reference(model="tiny-moe")
    phase_small_reference(quant="int8", model="tiny-moe")
    print(f"phase seconds: 3 {time.perf_counter() - t0:.1f}", flush=True)
    engine, first, _ = timed("4", lambda: asyncio.run(serve_main_path(smi)))
    ledger_ab = timed("4 ledger", phase_ledger_ab, engine, smi)
    timed("4 tuner", phase_budget_tuner, engine, smi)
    bf16_ref = {"weight_bytes": engine.metrics().weight_bytes,
                "peak_gib": first["stats"]["peak_gib"]}
    graph_bf16 = timed("4b", phase_graph_vs_eager, engine, "bf16")
    main_err, timing, leg_err, legacy_full = timed(
        "6", phase_timing, engine, first["n_prompt"], MAX_TOKENS)
    # the other engines share the weights; the bf16 cache goes first, so
    # their runs' peak memory is their own
    engine.cache = None
    torch.cuda.empty_cache()
    timed("4c", phase_depth_one, smi, engine.params, first)
    engine_q, first_q, _ = timed("5", lambda: asyncio.run(
        serve_main_path(smi, "int8", params=engine.params)))
    graph_int8 = timed("5 (4b)", phase_graph_vs_eager, engine_q, "int8")
    main_err_q, timing_q, leg_err_q, _ = timed(
        "5 (6)", phase_timing, engine_q, first_q["n_prompt"], MAX_TOKENS)
    print(f"window graphs: {json.dumps({'bf16': graph_bf16, 'int8': graph_int8})}",
          flush=True)
    err_legacy = max(err_legacy, leg_err, leg_err_q)
    del engine_q
    torch.cuda.empty_cache()
    legacy = timed("6 legacy", lambda: {
        model: phase_legacy_timing(model)
        for model in ("llama3-8b", "llama3-1b")})
    timed("7", phase_parity, engine)
    del engine
    torch.cuda.empty_cache()
    ab = timed("8", lambda: {model: phase_ab(model)
                             for model in ("llama3-8b", "llama3-1b")})
    http = timed("9", lambda: asyncio.run(phase_http(smi, bf16_ref)))
    # phase 21's storms run beside phase 10's run.py processes, and those
    # two beside each other (a failed gate's SystemExit reaches this thread
    # through the future)
    def entry_points():
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(2) as ex:
            futs = {m: ex.submit(phase_entry_point, m)
                    for m in ("tiny", "tiny-moe")}
            return {m: f.result() for m, f in futs.items()}
    _, entry = phase_storms(smi, beside=lambda: timed("10", entry_points))
    print(f"HTTP path: {json.dumps({'runs': http, 'entry_point': entry})}",
          flush=True)
    dist = timed("11", phase_distributed, smi,
                 device_name=torch.cuda.get_device_name(0))
    print(f"distributed path: {json.dumps(dist)}", flush=True)
    disagg = timed("12", phase_disagg, smi,
                   device_name=torch.cuda.get_device_name(0))
    print(f"disaggregated deployment: {json.dumps(disagg)}", flush=True)
    tiers = timed("13", phase_tiers, smi,
                  device_name=torch.cuda.get_device_name(0))
    print(f"KV tiers: {json.dumps(tiers)}", flush=True)
    moe = timed("14", phase_moe_child)
    print(f"mixture of experts: {json.dumps(moe)}", flush=True)
    ckpt = timed("15", phase_checkpoints, smi)
    print(f"checkpoints: {json.dumps(ckpt)}", flush=True)
    small = ckpt["small_launches"]
    a5 = timed("16", phase_a5, smi)
    print(f"gather decode windows and gemma-2: {json.dumps(a5)}", flush=True)
    spec = timed("17", phase_spec, smi)
    print(f"speculative decoding: {json.dumps(spec)}", flush=True)
    vl = timed("18", phase_vision, smi)
    print(f"vision: {json.dumps(vl)}", flush=True)
    stream = timed("19", phase_streaming, smi)
    print(f"streaming: {json.dumps(stream)}", flush=True)
    traced = timed("20", phase_traced_disagg, smi,
                   device_name=torch.cuda.get_device_name(0))
    print(f"traced disaggregation: {json.dumps(traced)}", flush=True)
    # 22a and 22b in two child processes at once (a failed gate's
    # SystemExit reaches this thread through its future)
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(2) as ex:
        futs = {part: ex.submit(timed, part, phase_tp_child, part)
                for part in ("22a", "22b")}
        tp = {part: f.result() for part, f in futs.items()}
    print(f"tensor parallelism: {json.dumps(tp)}", flush=True)
    print(f"phase seconds: all {time.perf_counter() - t_all:.1f}",
          flush=True)

    def ckpt_launches(kernel: str) -> dict:
        """A kernel's launches in phase 15's runs on the card: each small
        checkpoint's, run.py's on llama3-8b (bf16, int8)."""
        out = {label: got.get(kernel, 0) for label, got in small.items()}
        out["llama3-8b run.py"] = ckpt["launches"][kernel]
        out["llama3-8b run.py int8"] = ckpt["int8_launches"][kernel]
        return out

    ragged = {"name": "ragged_decode_attention", "route": "cuda",
              "source": "dynamo_tpu_torch/csrc/ragged_decode_attention.cu",
              "replaces": "dynamo_tpu/ops/paged_attention.py:88",
              "launches": first["launches"],
              "max_abs_err": max(err_bf16, main_err, *(
                  g["max_abs_err"] for g in geometries.values()),
                  *stream["partials"].values(),
                  spec["ngram"]["verify_max_abs_err"][0],
                  spec["exact"]["verify_max_abs_err"][0]), **timing,
              "distributed_launches": dist["launches"],
              "disagg_launches": disagg["launches"],
              "tiers_launches": {k: v["launches"]
                                 for k, v in tiers["runs"].items()},
              "checkpoint_launches": ckpt_launches(RAGGED),
              "a5_launches": {
                  "gemma-2-9b run.py (gather)":
                      a5["gemma2"]["launches"][RAGGED],
                  **{f"gemma-2-9b 16c {k} (gather)":
                     a5["gemma2"]["distributed"][k]["ragged_launches"]
                     for k in ("R", "D", "Q")},
                  **{f"llama3-8b {kv} auto window":
                     v["auto_ragged_launches"]
                     for kv, v in a5["windows_ab"].items()}},
              "spec_launches": {
                  "17a ngram cold (target windows and verify blocks)":
                      spec["ngram"]["cold"]["launches"][RAGGED],
                  "17a ngram warm": spec["ngram"]["warm"]["launches"][RAGGED],
                  "17b draft proposals (llama3-1b heads, f32)":
                      spec["exact"]["draft_ragged_launches"],
                  "17b, all (target windows, draft proposals and "
                  "catch-ups)": spec["exact"]["launches"][RAGGED],
                  "17c run.py draft proposals (llama3-1b heads)":
                      ckpt["spec_entry"]["draft_ragged_launches"],
                  "17c run.py, all":
                      ckpt["spec_entry"]["launches"][RAGGED]},
              "vision_launches": {
                  "18b run.py (qwen2-vl-7b heads, 28 / 4 x 128)":
                      vl["http"]["launches"][RAGGED],
                  "18b in process": vl["engine"]["launches"][RAGGED],
                  "18d decode worker, both modes":
                      vl["disagg"]["launches"][RAGGED],
                  "18c f32, both chunkings":
                      vl["chunks"]["launches"][RAGGED]},
              "stream_launches": {
                  f"19 streamed {kv} chat {i} ((layers - 1) x (1 + "
                  "segments) a decode step)": r["launches"]
                  for kv in ("bf16", "int8")
                  for i, r in enumerate(stream[kv]["runs"])},
              "traced_disagg_launches": {
                  "20 decode engine (32 x derived steps + warm-ups)":
                      traced["launches"]["decode"],
                  "20 prefill engine": traced["launches"]["prefill"]},
              "tp_launches": {
                  **{f"22a llama3-8b ({TP_LAYERS} layers) {label}, "
                     f"{rnd} round ({TP_LAYERS} x derived steps + "
                     "warm-ups)": tp["22a"][key][rnd]["launches"]
                     for key, label in (("no_group", "no group"),
                                        ("group_of_one",
                                         "NCCL group of one"))
                     for rnd in ("capture", "measured")},
                  **{f"22b llama3-70b tp-{TP_RANKS} rank {r['rank']} "
                     f"({r['kv_heads']} kv heads, gloo, eager)":
                     r["ragged_launches"] for r in tp["22b"]["ranks"]}},
              "geometries": geometries,
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
        "kernel": "w8a16_group (one launch a group of products that share "
                  "x)",
        "replaces": "dynamo_tpu/ops/quant.py:70 (wmat, fused by XLA into the "
                    "matmul; no Pallas kernel)",
        "launches": first_http["launches"][W8A16],
        "moe_launches": moe["launches"][W8A16],
        "checkpoint_launches": ckpt_launches(W8A16), "max_abs_err": err_w8,
        **w8_timing})
    records.append({
        "name": "w8a16_dequant", "route": "cuda", "source": source,
        "replaces": "dynamo_tpu/ops/quant.py:70 (wmat; no Pallas kernel)",
        # its path is the f32 route now (phase 3's tiny f32 int8 run on
        # the card); the serving runs launch it 0 times
        "launches": f32_int8[DEQUANT],
        "serving_launches": {"http": first_http["launches"][DEQUANT],
                             "moe": moe["launches"][DEQUANT]},
        "max_abs_err": 0.0, **dequant_timing})
    records.append({
        "name": LARGE_M, "route": "cuda",
        "source": "dynamo_tpu_torch/csrc/w8a16_large_m.cu",
        "replaces": "dynamo_tpu/ops/quant.py:70 and dynamo_tpu/ops/moe.py:77 "
                    "(wmat under the matmul and the expert einsums, fused by "
                    "XLA; no Pallas kernel): the dequantize entry + "
                    "torch.matmul route it takes over",
        "launches": first_http["launches"][LARGE_M],
        "moe_launches": moe["launches"][LARGE_M],
        "checkpoint_launches": ckpt_launches(LARGE_M),
        "spec_verify_launches": {
            "17a int8 verify blocks [8, 5] (replays)":
                spec["ngram"]["int8"]["large_m_replays"],
            "17a int8 run, all (derived)":
                spec["ngram"]["int8"]["large_m_derived"]},
        **large_m, "max_abs_err": max(large_m["max_abs_err"],
                                      moe["large_m"]["max_abs_err"]),
        "mixtral_chunk": moe["large_m"]})
    records.append({
        "name": MOE, "route": "cuda",
        "source": "dynamo_tpu_torch/csrc/w8a16_moe_gemm.cu",
        "replaces": "dynamo_tpu/ops/moe.py:77 (the expert einsums over "
                    "wmat, fused by XLA; no Pallas kernel)",
        "launches": moe["launches"][MOE],
        "max_abs_err": moe["max_abs_err"], **moe["kernel"]})
    print(json.dumps({"kernels": records}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--phase-moe"]:
        sys.exit(moe_main())
    if sys.argv[1:2] == ["--phase-tp"] and len(sys.argv) == 3:
        sys.exit(tp_main(sys.argv[2]))
    sys.exit(main())
