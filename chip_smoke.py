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

Each path (each run of 4, 4c, 5 and 9, and the A/B at each geometry) runs
with every kernel's launch count set to 0 just before it and read just
after. The third line
from the end of the output is one JSON object with the kernel records, the
second from the end the nvidia-smi reading, and the last line
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import asyncio
import dataclasses
import json
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
    from dynamo_tpu_torch.engine.engine import _engine_decode_window
    from dynamo_tpu_torch.engine.scheduler import DecodePlan
    from dynamo_tpu_torch.engine.window_graph import HostCopies
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.llm.worker import to_engine_request
    from dynamo_tpu_torch.run import build_card
    card = build_card("llama3-8b")
    pre = OpenAIPreprocessor(card)
    cfg = engine.model_cfg
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
            toks_e = _engine_decode_window(
                cfg, engine._eos_vec, engine.params, cache0, bufs["tokens"],
                bufs["positions"], bufs["counters"], bufs["page_table"],
                bufs["max_pos"], bufs["temperature"], bufs["top_k"],
                bufs["top_p"], bufs["seeds"], bufs["min_tokens"],
                bufs["ignore_eos"], bufs["stop_ids"], n_steps=staged["nw"],
                page_size=engine.cfg.page_size, greedy=greedy,
                fused=fused)[0].cpu().numpy()
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

async def _http(port: int, method: str, path: str, body=None) -> tuple:
    """One HTTP/1.1 request to localhost; (status, headers, body bytes),
    reading by content-length or chunked transfer (the server keeps
    connections alive)."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        data = json.dumps(body).encode() if body is not None else b""
        writer.write(f"{method} {path} HTTP/1.1\r\nhost: localhost\r\n"
                     "content-type: application/json\r\n"
                     f"content-length: {len(data)}\r\n\r\n".encode() + data)
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


async def _sse(port: int, body: dict) -> tuple:
    """A streamed chat: (parsed frames, ended with [DONE], seconds to the
    first frame with content or None, seconds to the first frame). With
    random weights and the byte tokenizer most sampled ids (>= 259) print
    nothing, so a stream can end without content."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    t0 = time.perf_counter()
    first, frames, done = None, [], False
    first_frame = None
    try:
        data = json.dumps(body).encode()
        writer.write(b"POST /v1/chat/completions HTTP/1.1\r\nhost: localhost"
                     b"\r\ncontent-type: application/json\r\ncontent-length: "
                     + str(len(data)).encode() + b"\r\n\r\n" + data)
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

    ragged = {"name": "ragged_decode_attention", "route": "cuda",
              "source": "dynamo_tpu_torch/csrc/ragged_decode_attention.cu",
              "replaces": "dynamo_tpu/ops/paged_attention.py:88",
              "launches": first["launches"],
              "max_abs_err": max(err_bf16, main_err), **timing,
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
