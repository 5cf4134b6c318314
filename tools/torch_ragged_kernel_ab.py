#!/usr/bin/env python3
"""Time the ragged decode kernel of a checkout at the main path's shapes and
at the full context, so that two versions of the kernel compare in one run.

    python3 tools/torch_ragged_kernel_ab.py [--checkout DIR] [--n 200]
                                            [--profile]

`--checkout` names the root of the checkout whose `dynamo_tpu_torch` is
timed (default: this one); its kernel builds into that checkout's `build/`.
Run it once per checkout, in turns (A, B, B, A), in one call on one card.

Inputs, made on the card from seed 0 at the llama3-8b head geometry (32 q
/ 8 kv heads, hd 128, bf16 q, ps 64), for a bf16 cache and an int8 cache
with its scales, 8 layers of 257 pages, cycled so that each launch misses
the 50 MB L2:
- main: 8 rows of 137-632 tokens, Pb 12 (chip_smoke.py phase 6's shape);
- full: 8 rows of 1536-2048 tokens, Pb 32 (max_slots rows at the default
  max_model_len, the scheduler's page bucket).
Each time is CUDA events over one replayed CUDA graph of `--n` launches
(chip_smoke.cuda_ms). `--profile` adds each CUDA kernel's mean device time
per call over 20 eager calls traced with torch.profiler (so the split and
merge kernels show apart). Prints one JSON line with the times, the bounds
(the bytes the call must move over 3.35 TB/s, chip_smoke.bound) and the
card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def kernel_times(fn, n: int) -> dict:
    """Mean device time per call (us) of each CUDA kernel that n eager calls
    of fn(0) .. fn(n - 1) launch, from a torch.profiler trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            fn(i)
        torch.cuda.synchronize()
    return {e.key[:48]: e.self_device_time_total / n
            for e in prof.key_averages() if e.self_device_time_total > 0}


def main() -> int:
    import torch

    from chip_smoke import bound, cuda_ms, kv_bytes, nvidia_smi

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--checkout", default=str(ROOT))
    p.add_argument("--n", type=int, default=200)
    p.add_argument("--profile", action="store_true")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("torch_ragged_kernel_ab: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.checkout).resolve()))
    from dynamo_tpu_torch.ops import paged_attention as pa
    from dynamo_tpu_torch.ops.kv_quant import quantize_rows

    g = torch.Generator(device="cuda").manual_seed(0)
    nl, hkv, h, hd, ps, s = 8, 8, 32, 128, 64, 8
    n_pages = s * 32 + 1
    shape = (nl, hkv, n_pages, ps, hd)
    k = torch.randn(shape, generator=g, device="cuda", dtype=torch.bfloat16)
    v = torch.randn(shape, generator=g, device="cuda", dtype=torch.bfloat16)
    (kq, ks), (vq, vs) = quantize_rows(k), quantize_rows(v)
    q = torch.randn((s, h, hd), generator=g, device="cuda",
                    dtype=torch.bfloat16)
    perm = torch.randperm(n_pages - 1, generator=g, device="cuda")
    shapes = {
        "main": (12, [137 + (632 - 137) * i // (s - 1) for i in range(s)]),
        "full": (32, [1536 + 512 * i // (s - 1) for i in range(s)]),
    }
    out = {"checkout": str(Path(args.checkout).resolve()),
           "device": nvidia_smi()}
    for name, (pb, lens) in shapes.items():
        pt = perm[:s * pb].to(torch.int32).reshape(s, pb)
        lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
        for mode, kc, vc, sc in (("bf16", k, v, ()),
                                 ("int8", kq, vq, (ks, vs))):
            ms = cuda_ms(lambda i: pa.decode_paged_attention_prefix(
                q, kc, vc, i % nl, pt, lens, *sc), args.n, graph=True)
            nbytes = (kv_bytes(lens, hkv, hd, kc.element_size(), bool(sc))
                      + q.numel() * 2 + pt.numel() * 4 + lens.numel() * 4
                      + s * h * (hd + 2) * 4)
            b = bound(nbytes, 4 * int(lens.sum()) * h * hd, "bfloat16")
            out[f"{name}_{mode}"] = rec = {
                "ms": ms, "bound_ms": b["bound_ms"],
                "share_of_bound": b["bound_ms"] / ms}
            if args.profile:
                rec["device_us"] = kernel_times(lambda i: (
                    pa.decode_paged_attention_prefix(
                        q, kc, vc, i % nl, pt, lens, *sc)), 20)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
