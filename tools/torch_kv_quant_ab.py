#!/usr/bin/env python3
"""bf16 against int8 KV pages (or weights) end to end, in turns, on one card.

    python3 tools/torch_kv_quant_ab.py [--turns 2] [--warmup 1] [--weights]

Serves chip_smoke.py's main path (the llama3-8b card at full width, random
weights from seed 0, default EngineConfig, its 8 chat requests through
NativeEngineWorker and LocalPipeline, with all of its checks) with
kv_quant "" and "int8" in the order "", int8, int8, "" (`--turns` pairs),
every run on the same weights and a fresh engine, so that drift does not
fall on one mode. With `--weights` the two modes are the weights' instead
(ModelConfig.quant "" and "int8", bf16 KV pages); each engine then draws
its weights from seed 0 itself, so no other weight tree sits in the card's
memory beside it. `--warmup` rounds of one run in each mode go first and
are not counted: the process's first run pays one-time start-up costs
(several times a warm run's TTFT). Prints each run's warm-run TTFT,
decode tokens/s, peak memory, kv_page_bytes and weight_bytes, then the
per-mode means and the int8/bf16 ratios. Imports only the port
(dynamo_tpu_torch), torch and chip_smoke.py.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    import torch

    from chip_smoke import nvidia_smi, serve_main_path
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.run import build_card

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--turns", type=int, default=2)
    p.add_argument("--warmup", type=int, default=1)
    p.add_argument("--weights", action="store_true",
                   help="compare bf16 and int8 weights, not KV pages")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("torch_kv_quant_ab: needs a CUDA card", file=sys.stderr)
        return 2
    smi = nvidia_smi()
    params = None if args.weights else llama.init_params(
        build_card("llama3-8b").model_config(), "cuda", seed=0)
    order = ["", "int8", "int8", ""] * ((args.turns + 1) // 2)
    runs = {"": [], "int8": []}
    for i, mode in enumerate(["", "int8"] * args.warmup
                             + order[:2 * args.turns]):
        if args.weights:
            engine, _, warm = asyncio.run(serve_main_path(smi, quant=mode))
        else:
            engine, _, warm = asyncio.run(serve_main_path(smi, mode, params))
        stats = dict(warm["stats"],
                     weight_bytes=engine.metrics().weight_bytes)
        engine.cache = None
        del engine
        torch.cuda.empty_cache()
        if i >= 2 * args.warmup:
            runs[mode].append(stats)
    keys = ("ttft_mean_ms", "ttft_max_ms", "decode_tok_s",
            "per_request_tok_s", "peak_gib", "wall_s", "weight_bytes")
    mean = {mode: {k: sum(r[k] for r in rs) / len(rs) for k in keys}
            for mode, rs in runs.items()}
    print(json.dumps({"device": smi, "axis": "weights" if args.weights
                      else "kv pages", "order": order[:2 * args.turns],
                      "runs": runs, "mean": mean,
                      "int8_over_bf16": {k: mean["int8"][k] / mean[""][k]
                                         for k in keys}}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
