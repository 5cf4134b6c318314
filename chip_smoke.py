#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (`dynamo_tpu_torch`) on one card.

    python3 chip_smoke.py

Phases (any failed check exits non-zero; nothing is caught):

1. Device: the card's name and power limit (nvidia-smi), then the build of
   every CUDA kernel in dynamo_tpu_torch/csrc/ with nvcc for sm_90a.
2. Kernel vs plain: the ragged decode attention kernel against its plain
   PyTorch version on the same inputs, in prefix and inclusive modes, at
   head dims 64 and 128, f32 and bf16 caches, 8 and 32 rows at the
   llama3-8b head geometry (32 q heads, 8 kv heads), ragged lengths
   including 0, 1, ps, ps+1 and a full table, recycled page tails filled
   with NaN. Both compute in f32, so only summation order differs:
   rtol = atol = 1e-4 for f32 caches and 2e-3 for bf16 caches.
3. Small reference: the `tiny` model in f32, decode logits on the card
   (the kernel) against the same step on the CPU (the plain version),
   within 1e-3, and the same greedy tokens from both engines.
4. Main path: the llama3-8b card at full width with random bf16 weights,
   NativeEngine on cuda (default EngineConfig) -> NativeEngineWorker ->
   LocalPipeline.generate_chat, answering 8 chat requests (100-600
   byte-token prompts, max_tokens 64, half greedy and half sampled with
   temperature 0.8, top_k 50 and a seed). Every request must finish with 64
   tokens or a stop, no sampled logits may be non-finite, the kernel's
   launch count must equal num_layers x decode steps run, and one greedy
   request served twice must give the same tokens. Prints TTFT, decode
   tokens/s and peak memory.
5. Kernel at the main path's shapes, on the engine's own cache after the
   run (page table over the pages the run wrote, lens mid-decode): the
   kernel against its plain version on layers 0, L/2 and L-1 (tolerance
   2e-3 for bf16), then CUDA-event times of the kernel, its plain version,
   gather + scaled_dot_product_attention as a yardstick, and the bound (KV
   bytes over 3.35 TB/s).

The second-to-last line of output is one JSON object with the kernel
records, the line before it the nvidia-smi reading, and the last line
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import asyncio
import json
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


def cuda_ms(fn, n: int, warmup: int = 3) -> float:
    import torch
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(n):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


# -- phase 2: kernel vs plain ---------------------------------------------------

def kernel_case(hd: int, dtype, s: int, seed: int):
    """Random cache + disjoint per-row page tables + ragged lens, with every
    token slot at or past a row's length filled with NaN."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    h, hkv, ps, pb, nl = 32, 8, 64, 8, 2
    p = s * pb + 1
    k = torch.randn((nl, hkv, p, ps, hd), generator=g, device="cuda")
    v = torch.randn((nl, hkv, p, ps, hd), generator=g, device="cuda")
    q = torch.randn((s, h, hd), generator=g, device="cuda")
    pt = torch.randperm(s * pb, generator=g, device="cuda").to(torch.int32)
    pt = pt.reshape(s, pb)
    special = [0, 1, ps, ps + 1, pb * ps]
    rand = torch.randint(0, pb * ps + 1, (s,), generator=g, device="cuda")
    lens = torch.tensor([special[i] if i < len(special) else int(rand[i])
                         for i in range(s)], dtype=torch.int32, device="cuda")
    pos = torch.arange(pb * ps, device="cuda")
    tail = pos[None, :] >= lens[:, None]                       # [S, Pb*ps]
    slots = (pt.long()[:, pos // ps] * ps + pos % ps)[tail]
    for c in (k, v):
        c.view(nl, hkv, p * ps, hd)[:, :, slots] = float("nan")
    k_new = torch.randn((s, hkv, hd), generator=g, device="cuda")
    v_new = torch.randn((s, hkv, hd), generator=g, device="cuda")
    cast = [t.to(dtype) for t in (q, k, v, k_new, v_new)]
    return (*cast, pt, lens)


def phase_kernel() -> float:
    import torch
    from dynamo_tpu_torch.ops import paged_attention as pa
    worst = 0.0
    for hd in (64, 128):
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-3)):
            for s in (8, 32):
                q, k, v, k_new, v_new, pt, lens = kernel_case(
                    hd, dtype, s, seed=hd + s)
                layer = 1
                ok = lens > 0
                ps = k.shape[3]
                # prefix mode: the kernel's flash state + the self-term
                acc, m, l = pa.decode_paged_attention_prefix(
                    q, k, v, layer, pt, lens)
                pacc, pm, pl_ = pa._ragged_plain(q, k, v, layer, pt, lens)
                out = pa.combine_self_attention(q, k_new, v_new, acc, m, l)
                pout = pa.combine_self_attention(q, k_new, v_new, pacc, pm,
                                                 pl_)
                # inclusive mode: lens include the current token
                inc = pa.decode_paged_attention(q, k[layer], v[layer], pt,
                                                lens)
                a2, _, l2 = pa._ragged_plain(
                    q, k[layer][None], v[layer][None], 0, pt,
                    torch.clamp(lens, min=1))
                pinc = (a2 / l2).to(q.dtype)
                torch.cuda.synchronize()
                # all rows of the flash state (an empty row walks one masked
                # page: m = -1e30, l = ps); inclusive rows with lens >= 1
                pairs = [("acc", acc, pacc), ("m", m, pm), ("l", l, pl_),
                         ("prefix+self", out.float(), pout.float()),
                         ("inclusive", inc[ok].float(), pinc[ok].float())]
                check(bool((m[~ok] == -1e30).all())
                      and bool((l[~ok] == ps).all()),
                      f"hd={hd} {dtype} S={s}: empty rows must keep "
                      f"m = -1e30 and l = {ps}")
                errs = []
                for name, a, b in pairs:
                    check(bool(torch.isfinite(a).all()),
                          f"hd={hd} {dtype} S={s}: non-finite {name}")
                    err = float((a - b).abs().max())
                    close = torch.allclose(a, b, rtol=tol, atol=tol)
                    check(close, f"hd={hd} {dtype} S={s}: {name} differs "
                          f"from the plain version by {err}")
                    errs.append(err)
                worst = max(worst, max(errs))
                print(f"kernel hd={hd} {str(dtype)[6:]} S={s} "
                      f"lens={lens.tolist()[:6]}... max_abs_err "
                      f"acc/m/l/prefix/inclusive = "
                      f"{' '.join(f'{e:.3g}' for e in errs)} (tol {tol})",
                      flush=True)
    return worst


# -- phase 3: tiny f32 card vs CPU ---------------------------------------------

def phase_small_reference() -> None:
    import torch
    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.engine import NativeEngine
    from dynamo_tpu_torch.engine.scheduler import SamplingParams
    from dynamo_tpu_torch.models import llama
    cfg = ModelConfig(dtype="float32", max_model_len=512)
    params = llama.init_params(cfg, "cpu", seed=0)
    ecfg = EngineConfig(page_size=8, num_pages=64, max_slots=4,
                        max_prefill_chunk=32, prefill_buckets=(8, 16, 32),
                        max_model_len=512)
    engines = {dev: NativeEngine(
        cfg, ecfg, device=dev,
        params={"embed": params["embed"].to(dev),
                "final_norm": params["final_norm"].to(dev),
                "lm_head": params["lm_head"].to(dev),
                "layers": {k: t.to(dev) for k, t in
                           params["layers"].items()}})
        for dev in ("cpu", "cuda")}
    prompt = list(range(5, 45))
    sp = SamplingParams(max_tokens=12, temperature=0.0)
    outs = {dev: e.generate(prompt, sp, "r") for dev, e in engines.items()}
    check(outs["cpu"] == outs["cuda"],
          f"tiny f32 greedy tokens differ: cpu {outs['cpu']} cuda "
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
        logits[dev] = llama.decode_forward(e.params, cfg, tok, cache, pt,
                                           pre, pos)[0].cpu()
    err = float((logits["cpu"] - logits["cuda"]).abs().max())
    check(bool(torch.isfinite(logits["cuda"]).all()) and err < 1e-3,
          f"tiny f32 decode logits cuda vs cpu differ by {err}")
    print(f"small reference: tiny f32 greedy tokens identical on cuda and "
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


def chat_requests(model: str) -> list:
    """The main path's 8 chat requests: 100-600 byte-token prompts after
    the chat template, MAX_TOKENS each; even ones greedy, odd ones sampled
    (temperature 0.8, top_k 50, a seed each)."""
    from dynamo_tpu_torch.protocols.openai import ChatCompletionRequest
    reqs = []
    for i, n in enumerate((80, 150, 220, 290, 360, 430, 500, 575)):
        kw = {}
        if i % 2:
            kw = dict(temperature=0.8, seed=1234 + i, ext={"top_k": 50})
        reqs.append(ChatCompletionRequest(
            model=model, max_tokens=MAX_TOKENS,
            messages=[{"role": "user", "content": prompt_text(n, i)}], **kw))
    return reqs


async def serve_main_path(smi: str):
    import torch
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import NativeEngine
    from dynamo_tpu_torch.llm.pipeline import LocalPipeline
    from dynamo_tpu_torch.llm.worker import NativeEngineWorker
    from dynamo_tpu_torch.ops import paged_attention as pa
    from dynamo_tpu_torch.protocols.delta import aggregate_chat_chunks
    from dynamo_tpu_torch.run import build_card
    from dynamo_tpu_torch.runtime.engine import Context

    card = build_card("llama3-8b")
    cfg = card.model_config()
    t0 = time.perf_counter()
    engine = NativeEngine(cfg, EngineConfig(),
                          eos_token_ids=set(card.eos_token_ids), seed=0,
                          device="cuda")
    torch.cuda.synchronize()
    print(f"main path: {cfg.name} {cfg.dtype} weights + KV cache ready in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    worker = await NativeEngineWorker(engine).start()
    timed = TimedEngine(worker)
    pipe = LocalPipeline(card, timed)
    max_tokens = MAX_TOKENS
    requests = chat_requests(card.name)

    async def one(i: int, req):
        chunks = [c async for c in pipe.generate_chat(
            req, Context(f"req-{i}"))]
        return aggregate_chat_chunks(chunks)

    torch.cuda.reset_peak_memory_stats()
    pa.KERNEL_LAUNCHES = 0
    steps0 = engine.decode_window_steps
    t_run = time.perf_counter()
    results = await asyncio.gather(*(one(i, r)
                                     for i, r in enumerate(requests)))
    wall = time.perf_counter() - t_run
    launches = pa.KERNEL_LAUNCHES
    window_steps = engine.decode_window_steps - steps0
    peak = torch.cuda.max_memory_allocated()

    n_prompt = []
    for i, agg in enumerate(results):
        ch = agg.choices[0]
        n = agg.usage.completion_tokens
        n_prompt.append(agg.usage.prompt_tokens)
        check(ch.finish_reason == "stop" or (ch.finish_reason == "length"
                                             and n == max_tokens),
              f"request {i} finished {ch.finish_reason!r} with {n} tokens")
        check(timed.stamps[f"req-{i}"]["tokens"] == n,
              f"request {i}: usage says {n} tokens, frames carried "
              f"{timed.stamps[f'req-{i}']['tokens']}")
    check(min(n_prompt) >= 100 and max(n_prompt) <= 600,
          f"prompt lengths {n_prompt} outside 100-600")
    check(engine.logits_nonfinite_steps() == 0, "non-finite logits sampled")
    decode_tokens = sum(r.usage.completion_tokens for r in results) \
        - len(results)
    need = cfg.num_layers * decode_tokens / engine.cfg.decode_steps
    check(launches == cfg.num_layers * window_steps and launches >= need,
          f"kernel launches {launches}: expected num_layers x decode steps "
          f"= {cfg.num_layers} x {window_steps}, and at least {need:.0f}")
    m = engine.metrics()
    st = [timed.stamps[f"req-{i}"] for i in range(len(results))]
    ttft = [s["first"] - s["start"] for s in st]
    per_req = [(s["tokens"] - 1) / (s["last"] - s["first"]) for s in st]
    agg_rate = decode_tokens / (max(s["last"] for s in st)
                                - min(s["first"] for s in st))
    print(f"main path: 8 chat requests, prompts {n_prompt} tokens, "
          f"completion tokens {[r.usage.completion_tokens for r in results]}"
          f", finish {[r.choices[0].finish_reason for r in results]}; "
          f"wall {wall:.3f} s; decode windows {m.decode_windows}, window "
          f"steps {window_steps}, mixed steps {m.mixed_steps}; kernel "
          f"launches {launches}", flush=True)
    print(f"main path [{smi}]: TTFT mean {sum(ttft) / len(ttft) * 1e3:.1f}"
          f" ms, max {max(ttft) * 1e3:.1f} ms; decode {agg_rate:.1f} tok/s "
          f"aggregate, {sum(per_req) / len(per_req):.1f} tok/s per request;"
          f" peak memory {peak / 2**30:.2f} GiB", flush=True)

    # determinism: one greedy request served twice on the idle engine
    req = requests[0]
    runs = []
    for r in range(2):
        pre, _ = pipe.preprocessor.preprocess_chat(req, f"det-{r}")
        frames = [f async for f in worker.generate(pre, Context(pre.request_id))]
        runs.append([t for f in frames for t in f.token_ids])
    check(runs[0] == runs[1] and len(runs[0]) == max_tokens,
          f"greedy request not deterministic: {runs[0][:8]}... vs "
          f"{runs[1][:8]}...")
    print(f"main path: greedy request served twice, same {len(runs[0])} "
          "tokens", flush=True)
    await worker.stop()
    return engine, launches, n_prompt, max_tokens


# -- phase 5: the kernel at the main path's shapes ----------------------------

def phase_timing(engine, n_prompt, max_tokens):
    import torch
    import torch.nn.functional as F
    from dynamo_tpu_torch.engine.scheduler import next_bucket
    from dynamo_tpu_torch.ops import paged_attention as pa
    cfg, ecfg = engine.model_cfg, engine.cfg
    s, h, hkv, hd = (ecfg.max_slots, cfg.num_heads, cfg.num_kv_heads,
                     cfg.head_dim)
    ps, nl = ecfg.page_size, cfg.num_layers
    kc, vc = engine.cache["k"], engine.cache["v"]
    # the decode plan of the run's 8 requests halfway through their tokens:
    # page-table width bucketed as the scheduler does, lens mid-decode, and
    # distinct pages per row, first the pages the run wrote KV into (in a
    # random order), then unwritten (zero) ones
    pb = next_bucket(-(-(max(n_prompt) + max_tokens) // ps),
                     engine.scheduler.page_buckets)
    g = torch.Generator(device="cuda").manual_seed(7)
    wrote = kc[0, :, :ecfg.num_pages].ne(0).any(-1).any(-1).any(0)
    check(int(wrote.sum()) > 0, "the main path wrote no KV page")
    perm = torch.randperm(ecfg.num_pages, generator=g, device="cuda")
    perm = perm[torch.argsort((~wrote[perm]).to(torch.int8), stable=True)]
    pt = perm[:s * pb].to(torch.int32).reshape(s, pb)
    lens = torch.tensor([n + max_tokens // 2 for n in n_prompt],
                        dtype=torch.int32, device="cuda")
    q = torch.randn((s, h, hd), generator=g, device="cuda").to(kc.dtype)
    # the kernel against its plain version on these inputs (untimed; the
    # main path's launch count was read before)
    tol = 2e-3 if kc.dtype == torch.bfloat16 else 1e-4
    errs = []
    layers = sorted({0, nl // 2, nl - 1})
    for layer in layers:
        got = pa.decode_paged_attention_prefix(q, kc, vc, layer, pt, lens)
        want = pa._ragged_plain(q, kc, vc, layer, pt, lens)
        for name, a, b in zip(("acc", "m", "l"), got, want):
            check(bool(torch.isfinite(a).all()),
                  f"main-path shapes, layer {layer}: non-finite {name}")
            err = float((a - b).abs().max())
            check(torch.allclose(a, b, rtol=tol, atol=tol),
                  f"main-path shapes, layer {layer}: {name} differs from "
                  f"the plain version by {err}")
            errs.append(err)
    print(f"kernel at the main path's shapes ({int(wrote.sum())} pages "
          f"written by the run): layers {layers} max_abs_err "
          f"acc/m/l = {' '.join(f'{e:.3g}' for e in errs)} (tol {tol})",
          flush=True)
    n = 200
    # each launch reads another layer's pages, as the model does: the KV
    # of one layer (~12 MB here) would otherwise sit in the 50 MB L2
    kernel_ms = cuda_ms(lambda i: pa.decode_paged_attention_prefix(
        q, kc, vc, i % nl, pt, lens), n)
    plain_ms = cuda_ms(lambda i: pa._ragged_plain(
        q, kc, vc, i % nl, pt, lens), 20)
    pos = torch.arange(pb * ps, device="cuda")
    mask = (pos[None, :] < lens[:, None])[:, None, None, :]

    def library(i):
        ids = pt.reshape(-1).long()
        k = kc[i % nl].index_select(1, ids).reshape(hkv, s, pb * ps, hd)
        v = vc[i % nl].index_select(1, ids).reshape(hkv, s, pb * ps, hd)
        return F.scaled_dot_product_attention(
            q[:, :, None, :], k.transpose(0, 1), v.transpose(0, 1),
            attn_mask=mask, enable_gqa=True)
    library_ms = cuda_ms(library, n)
    tot = int(lens.sum())
    esz = kc.element_size()
    nbytes = (tot * hkv * hd * 2 * esz + q.numel() * esz + pt.numel() * 4
              + lens.numel() * 4 + s * h * (hd + 2) * 4)
    flops = 4 * tot * h * hd
    byte_ms = nbytes / H100_BYTES_PER_S * 1e3
    op_ms = flops / PEAK_FLOPS[cfg.dtype] * 1e3
    print(f"timing (S={s}, H={h}, Hkv={hkv}, hd={hd}, {cfg.dtype}, ps={ps}, "
          f"Pb={pb}, lens={lens.tolist()}): kernel {kernel_ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, gather+sdpa {library_ms:.4f} ms, bound "
          f"{max(byte_ms, op_ms):.4f} ms ({nbytes} bytes)", flush=True)
    return max(errs), {
        "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": max(byte_ms, op_ms),
        "bound_by": "bytes" if byte_ms >= op_ms else "operations"}


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
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)

    max_err = phase_kernel()
    phase_small_reference()
    engine, launches, n_prompt, max_tokens = asyncio.run(
        serve_main_path(smi))
    main_err, timing = phase_timing(engine, n_prompt, max_tokens)
    record = {"name": "ragged_decode_attention", "route": "cuda",
              "source": "dynamo_tpu_torch/csrc/ragged_decode_attention.cu",
              "replaces": "dynamo_tpu/ops/paged_attention.py:88",
              "launches": launches, "max_abs_err": max(max_err, main_err),
              **timing}
    print(json.dumps({"kernels": [record]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
