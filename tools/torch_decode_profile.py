#!/usr/bin/env python3
"""Where a decode step of the PyTorch/H100 port spends its time.

    python3 tools/torch_decode_profile.py [--windows 3] [--kv-quant int8]
        [--quant int8] [--decode-kernel off]

The JAX tool's two passes (tools/decode_profile.py, docs/PERF.md §1) over
the port's llama3-8b NativeEngine on one card (random bf16 weights from
seed 0, default EngineConfig; `--kv-quant int8` for int8 KV pages,
`--quant int8` for int8 weights through the W8A16 kernel, `--decode-kernel
off` for the gather window in place of the ragged kernel's), each with
chip_smoke.py's 8 chat requests (its `chat_requests`, through the chat
template) admitted at once:

1. attribution: pipeline_depth=1 with `engine.profile_sync`, so each
   window's dispatch waits for the device and the engine's PhaseTimer
   splits the host's time exactly (plan, upload, dispatch, device, fetch,
   commit);
2. overlap: pipeline_depth=2, the serving loop: the pipeline's counters,
   the untraced ms per decode step, and the device-busy share, untraced
   (device time of the traced step over the untraced step time) and
   traced (over the traced step's own wall time).

Each pass calls `engine.step()` until no request waits and a decode window
has run (it captures the window's graph), times `--windows` steps with the
host clock (ending in a synchronize) and traces one more with
torch.profiler. Prints one JSON line per pass and the kernels that take the
most device time, and the traced step's device time in the weight products
(`gemm_ms_traced`: cuBLAS's kernels for bf16 weights, the W8A16 kernel for
int8 ones). Then the overlap pass's decode step split into its parts,
each timed alone (CUDA events over a replayed graph) at the step's own
shapes (the running requests' lengths and page tables, 8 slots): the
gather window's base gather (a window's, and its share of a step), the
attention of every layer (the gather window's split attention, or the
ragged kernel and its self-term fold), the weight products of every layer
and the head at 8 rows, and the rest of the device step (norms, RoPE,
sampling, the window's writes: its glue). Imports only the port
(dynamo_tpu_torch), torch and chip_smoke.py.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

COUNTERS = ("decode_windows", "decode_window_steps", "decode_dispatches",
            "decode_host_syncs", "decode_plan_uploads", "pipeline_windows",
            "pipeline_overlapped", "pipeline_fallbacks")


# kernel-name fragments of the weight products: cuBLAS's GEMMs and the port's
# W8A16 kernels
GEMM_KERNELS = ("gemm", "Gemm", "nvjet", "cutlass", "xmma", "w8a16")


def run_pass(cfg, card, params, kv_quant: str, depth: int,
             windows: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import chat_requests
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import NativeEngine
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.llm.worker import to_engine_request

    engine = NativeEngine(cfg,
                          EngineConfig(kv_quant=kv_quant,
                                       pipeline_depth=depth),
                          eos_token_ids=set(card.eos_token_ids),
                          params=params, device="cuda")
    engine.profile_sync = depth == 1
    pre = OpenAIPreprocessor(card)
    for i, req in enumerate(chat_requests(card.name)):
        engine.add_request(to_engine_request(
            pre.preprocess_chat(req, f"r{i}")[0]))
    # prefill and mixed steps until nothing waits, then one decode window
    # (its graph is captured there)
    while engine.scheduler.waiting or engine.decode_windows == 0:
        engine.step()
    torch.cuda.synchronize()
    captured = engine.graphs.captured
    engine.phases.reset()
    before = {k: getattr(engine, k) for k in COUNTERS}
    t0 = time.perf_counter()
    for _ in range(windows):
        engine.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    d = {k: getattr(engine, k) - v for k, v in before.items()}
    steps = d["decode_window_steps"]
    split = engine.phases.split()
    s0 = engine.decode_window_steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        traced_wall = time.perf_counter() - t1
    traced_steps = engine.decode_window_steps - s0
    if engine.graphs.captured != captured or not steps or not traced_steps:
        raise RuntimeError(f"depth {depth}: a timed step captured a graph "
                           "or ran no decode window")
    dev = [e for e in prof.key_averages() if e.device_type.name == "CUDA"
           and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    ms_step = wall * 1e3 / steps
    rec = {
        "pass": "attribution" if depth == 1 else "overlap",
        "pipeline_depth": depth, "profile_sync": engine.profile_sync,
        "kv_quant": kv_quant or "bf16", "quant": cfg.quant or "bf16",
        "decode_path": engine.decode_path,
        "timed_steps": windows,
        "decode_steps": steps, "wall_ms": wall * 1e3,
        "ms_per_decode_step": ms_step, "counters": d,
        "host_ms_per_window": {k: v["seconds"] * 1e3 / windows
                               for k, v in split.items()},
        "phases": split,
        "traced_decode_steps": traced_steps,
        "traced_wall_ms": traced_wall * 1e3,
        "device_busy_ms": busy_ms,
        "device_busy_ms_per_step": busy_ms / traced_steps,
        "busy_share_untraced": busy_ms / traced_steps / ms_step,
        "busy_share_traced": busy_ms / (traced_wall * 1e3),
        "kernels_traced": sum(e.count for e in dev),
        "gemm_ms_traced": sum(e.self_device_time_total for e in dev
                              if any(k in e.key for k in GEMM_KERNELS)) / 1e3,
        "graphs_captured": captured, "pool_bytes": engine.graphs.pool_bytes(),
    }
    ranked = sorted(dev, key=lambda e: -e.self_device_time_total)
    own = ("ragged_split_kernel", "merge_splits_kernel")
    rec["top_kernels"] = [
        (round(e.self_device_time_total / 1e3, 3), e.count, e.key[:90])
        for i, e in enumerate(ranked)
        if i < 12 or any(k in e.key for k in own)]
    if depth == 2:
        rec["split"] = split_step(engine, rec["device_busy_ms_per_step"])
    engine.cache = None
    return rec


def split_step(engine, device_ms_per_step: float) -> dict:
    """The decode step's parts, each timed alone at the running requests'
    shapes: {base_gather_ms_per_window, base_gather_ms_per_step,
    attention_ms, gemm_ms, glue_ms} (ms a step; glue = the traced device
    step less the others)."""
    import numpy as np
    import torch

    from chip_smoke import cuda_ms
    from dynamo_tpu_torch.engine.engine import _gather_base
    from dynamo_tpu_torch.engine.scheduler import next_bucket
    from dynamo_tpu_torch.models.llama import _layer_w
    from dynamo_tpu_torch.ops.attention import decode_attention_split
    from dynamo_tpu_torch.ops.paged_attention import (
        combine_self_attention, decode_paged_attention_prefix,
    )
    from dynamo_tpu_torch.ops.quant import linear, linear_group

    cfg, ecfg, dev = engine.model_cfg, engine.cfg, engine.device
    ps, s, nl = ecfg.page_size, ecfg.max_slots, cfg.num_layers
    seqs = engine.scheduler.running
    lens = np.array([q.total_len - 1 if q is not None else 0 for q in seqs],
                    np.int32)
    pb = next_bucket(max(len(q.pages) for q in seqs if q is not None),
                     engine.scheduler.page_buckets)
    table = np.full((s, pb), ecfg.num_pages, np.int32)
    for i, q in enumerate(seqs):
        if q is not None:
            table[i, :len(q.pages)] = q.pages
    table_t = torch.from_numpy(table).to(dev)
    lens_t = torch.from_numpy(lens).to(dev)
    dt = engine.params["embed"].dtype
    gen = torch.Generator(device=dev).manual_seed(0)
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = torch.randn((s, h, hd), generator=gen, device=dev).to(dt)
    k_new = torch.randn((s, hkv, hd), generator=gen, device=dev).to(dt)
    v_new = torch.randn((s, hkv, hd), generator=gen, device=dev).to(dt)
    nw = max(engine._window_sizes)
    out = {}
    if engine.decode_path == "gather":
        base_pb = min(next_bucket(max(1, -(-int(lens.max()) // ps)),
                                  engine.scheduler.page_buckets), pb)
        kb, vb, kw, vw = engine._window_bufs(s, base_pb, nw)
        out["base_gather_ms_per_window"] = cuda_ms(
            lambda i: _gather_base(engine.cache, table_t[:, :base_pb], kb,
                                   vb, lens_t), 3, graph=True)
        out["base_gather_ms_per_step"] = out["base_gather_ms_per_window"] / nw
        lw = cfg.layer_windows()
        win = torch.full((s,), nw // 2, dtype=torch.int32, device=dev)

        def attention(i):
            for l in range(nl):
                decode_attention_split(
                    q, kb[l], vb[l], kw[l], vw[l], k_new, v_new, lens_t, win,
                    softcap=cfg.attn_softcap, q_scale=cfg.query_scale,
                    window=None if lw is None else lw[l])
    else:
        out["base_gather_ms_per_window"] = out["base_gather_ms_per_step"] = 0.0
        ks, vs = engine.cache.get("k_scale"), engine.cache.get("v_scale")

        def attention(i):
            for l in range(nl):
                acc, m, lsum = decode_paged_attention_prefix(
                    q, engine.cache["k"], engine.cache["v"], l, table_t,
                    lens_t, ks, vs)
                combine_self_attention(q, k_new, v_new, acc, m, lsum)
    out["attention_ms"] = cuda_ms(attention, 3, graph=True)
    lp = engine.params["layers"]
    x = torch.randn((s, 1, cfg.hidden_size), generator=gen,
                    device=dev).to(dt)
    xf = torch.randn((s, 1, cfg.intermediate_size), generator=gen,
                     device=dev).to(dt)
    xo = torch.randn((s, 1, h * hd), generator=gen, device=dev).to(dt)
    head = (engine.params["embed"].T if cfg.tie_word_embeddings
            else engine.params["lm_head"])

    def gemms(i):
        for l in range(nl):
            linear_group(x, [_layer_w(lp, k, l) for k in ("wq", "wk", "wv")])
            linear(xo, _layer_w(lp, "wo", l))
            linear_group(x, [_layer_w(lp, k, l) for k in ("w_gate", "w_up")])
            linear(xf, _layer_w(lp, "w_down", l))
        linear(x, head)
    out["gemm_ms"] = cuda_ms(gemms, 3, graph=True)
    out["glue_ms"] = (device_ms_per_step - out["attention_ms"]
                      - out["gemm_ms"] - out["base_gather_ms_per_step"])
    return out


def main() -> int:
    import torch

    from chip_smoke import nvidia_smi
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.run import build_card

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--windows", type=int, default=3)
    p.add_argument("--kv-quant", default="", choices=("", "int8"))
    p.add_argument("--quant", default="", choices=("", "int8"))
    p.add_argument("--decode-kernel", default="auto",
                   choices=("auto", "on", "off"))
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("torch_decode_profile: needs a CUDA card", file=sys.stderr)
        return 2
    smi = nvidia_smi()
    card = build_card("llama3-8b")
    cfg = dataclasses.replace(card.model_config(), quant=args.quant,
                              decode_kernel=args.decode_kernel)
    params = llama.init_params(cfg, "cuda", seed=0)
    print(f"device: {smi}; torch {torch.__version__}", flush=True)
    for depth in (1, 2):
        rec = run_pass(cfg, card, params, args.kv_quant, depth, args.windows)
        torch.cuda.empty_cache()
        print(f"{rec['pass']} pass ({rec['quant']} weights, "
              f"{rec['kv_quant']} KV pages, pipeline_depth "
              f"{depth}, profile_sync {rec['profile_sync']}): "
              f"{rec['decode_steps']} decode steps in {rec['wall_ms']:.2f} ms"
              f" = {rec['ms_per_decode_step']:.3f} ms per decode step; "
              f"device busy {rec['device_busy_ms_per_step']:.3f} ms a step "
              f"({rec['busy_share_untraced']:.1%} of the untraced step, "
              f"{rec['busy_share_traced']:.1%} of the traced one); host ms "
              f"per window {json.dumps(rec['host_ms_per_window'])}; weight "
              f"products {rec['gemm_ms_traced']:.3f} ms of the traced "
              f"{rec['traced_decode_steps']} steps", flush=True)
        for ms, n, key in rec["top_kernels"]:
            print(f"  {ms:9.3f} ms  {n:6d}x  {key}", flush=True)
        if "split" in rec:
            print(f"the {rec['decode_path']} window's decode step, its "
                  f"parts timed alone (ms a step): "
                  f"{json.dumps(rec['split'])}", flush=True)
        print(json.dumps({k: v for k, v in rec.items()
                          if k != "top_kernels"}), flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
