#!/usr/bin/env python3
"""Where a streamed decode step's host time goes, on the card.

    python3 tools/torch_stream_probe.py [--out build/stream_probe.json]

Two parts, at llama3-8b's page geometry (8 kv heads x 64 tokens x 128,
bf16; one layer's slice of a page is 128 KB, a page of 8 layers 1 MB):
- the window pool's ways to stage a segment of 8 pages' layer slices
  (1 MB): a host copy of the slices into pinned staging (`torch.stack`,
  JAX's np.stack) from a pinned and from a pageable slab, one DMA a slice
  straight out of a pinned slab (what engine/streaming.WindowPool does),
  and one 1 MB DMA from pinned staging; then the pin gate's verify,
  `runtime/integrity.tensor_checksum` over 57 pages (a decode step's cold
  pages), one at a time and in the tier's hashing threads;
- a streamed llama3-8b engine at 8 of its 32 layers (chip_smoke.py phase
  19's S: page 64, 64 HBM pages, 256 pinned host pages, window halves of
  8, 8 resident, 2 hot) on a 4096-token prompt: 8 decode steps timed
  (host clock, ending in a synchronize) and profiled with cProfile (the
  20 functions of most own time).
Prints the card's name and power limit and each figure, and writes the
record as JSON. Needs the card.
"""
from __future__ import annotations

import argparse
import cProfile
import dataclasses
import io
import json
import os
import pstats
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def rate(nbytes: int, seconds: float) -> dict:
    return {"ms": seconds * 1e3, "gb_s": nbytes / seconds / 1e9}


def staging(reps: int = 100) -> dict:
    """The segment staging ways and the verify, as the docstring says."""
    import torch
    from dynamo_tpu_torch.engine.offload import Hasher
    from dynamo_tpu_torch.runtime.integrity import tensor_checksum
    out = {}
    shape = (256, 8, 8, 64, 128)      # slots, layers, kv heads, ps, hd
    for pin in (True, False):
        slab = torch.zeros(shape, dtype=torch.bfloat16, pin_memory=pin)
        slab.view(torch.int16).random_(-1000, 1000)
        views = [slab[i * 7 + 3][5] for i in range(8)]
        stag = torch.empty((8,) + shape[2:], dtype=torch.bfloat16,
                           pin_memory=True)
        nbytes = stag.numel() * stag.element_size()
        for _ in range(3):
            torch.stack(views, out=stag)
        t = time.perf_counter()
        for _ in range(reps):
            torch.stack(views, out=stag)
        out[f"host stack, {'pinned' if pin else 'pageable'} slab"] = rate(
            nbytes, (time.perf_counter() - t) / reps)
        pages = [slab[i] for i in range(57)]
        pbytes = 57 * pages[0].numel() * pages[0].element_size()
        t = time.perf_counter()
        for p in pages:
            tensor_checksum(p)
        out[f"verify 57 pages, one at a time, {'pinned' if pin else 'pageable'}"] = rate(
            pbytes, time.perf_counter() - t)
        h = Hasher("probe")
        t = time.perf_counter()
        h.map(tensor_checksum, pages)
        out[f"verify 57 pages, hashing threads, {'pinned' if pin else 'pageable'}"] = rate(
            pbytes, time.perf_counter() - t)
        h.close()
        if not pin:
            continue
        dst = torch.empty(stag.shape, dtype=stag.dtype, device="cuda")
        st = torch.cuda.Stream()
        for way, fn in (
                ("one DMA a slice from the pinned slab",
                 lambda: [dst[i].copy_(v, non_blocking=True)
                          for i, v in enumerate(views)]),
                ("one 1 MB DMA from pinned staging",
                 lambda: dst.copy_(stag, non_blocking=True))):
            with torch.cuda.stream(st):
                for _ in range(3):
                    fn()
            torch.cuda.synchronize()
            t = time.perf_counter()
            with torch.cuda.stream(st):
                for _ in range(reps):
                    fn()
            torch.cuda.synchronize()
            out[way] = rate(nbytes, (time.perf_counter() - t) / reps)
    return out


def streamed_steps(steps: int = 8) -> dict:
    """Phase 19's S engine: `steps` decode steps timed and profiled."""
    import torch
    import chip_smoke
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import NativeEngine
    from dynamo_tpu_torch.engine.scheduler import (
        EngineRequest, SamplingParams,
    )
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.run import build_card
    card = build_card("llama3-8b")
    cfg = dataclasses.replace(card.model_config(),
                              num_layers=chip_smoke.TIER_LAYERS)
    params = llama.init_params(cfg, "cuda", 0)
    sz = chip_smoke.STREAM_SIZES
    eng = NativeEngine(cfg, EngineConfig(
        page_size=card.kv_page_size, num_pages=sz["num_pages"],
        host_pages=sz["host"], stream_pages=sz["window"],
        stream_resident_pages=sz["resident"], stream_hot_pages=sz["hot"],
        max_model_len=4224), params=params, device="cuda")
    eng.add_request(EngineRequest("probe", chip_smoke.tier_tokens(
        sz["prompt"], 1900, cfg.vocab_size), SamplingParams(
            max_tokens=steps + 8, temperature=0.0, ignore_eos=True)))
    tokens = 0
    while tokens < 4:
        tokens += sum(ev.token is not None for ev in eng.step())
    prof = cProfile.Profile()
    t = time.perf_counter()
    prof.enable()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    prof.disable()
    ms = (time.perf_counter() - t) / steps * 1e3
    text = io.StringIO()
    pstats.Stats(prof, stream=text).sort_stats("tottime").print_stats(20)
    eng.close()
    return {"ms_per_step": ms, "profile": text.getvalue()}


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "build" / "stream_probe.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_stream_probe: needs the card", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    rec = {"device": smi, "cpus": os.cpu_count(), "staging": staging()}
    for way, r in rec["staging"].items():
        print(f"{way}: {r['ms']:.3f} ms, {r['gb_s']:.2f} GB/s", flush=True)
    rec["streamed"] = streamed_steps()
    print(f"streamed decode step (8 of llama3-8b's layers, 57 cold pages): "
          f"{rec['streamed']['ms_per_step']:.2f} ms", flush=True)
    print(rec["streamed"]["profile"], flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
