#!/usr/bin/env python3
"""Time the ragged (or the legacy) decode kernel of a checkout, so that two
versions of a kernel compare in one run.

    python3 tools/torch_ragged_kernel_ab.py [--checkout DIR] [--n 200]
                                            [--kernel ragged|legacy]
                                            [--profile]

`--checkout` names the root of the checkout whose `dynamo_tpu_torch` is
timed (default: this one); its kernels build into that checkout's `build/`.
Run it once per checkout, in turns (A, B, B, A), in one call on one card.

Inputs are made on the card from seed 0 at the llama3-8b head geometry (32
q / 8 kv heads, hd 128, bf16 q, ps 64): a bf16 cache and an int8 cache with
its scales, 8 layers of 257 pages, cycled so that each launch misses the
50 MB L2.
- `--kernel ragged` (default): the ragged kernel in prefix mode at
  - main: 8 rows of 137-632 tokens, Pb 12 (chip_smoke.py phase 6's shape);
  - full: 8 rows of 1536-2048 tokens, Pb 32 (max_slots rows at the default
    max_model_len, the scheduler's page bucket);
  in both cache modes.
- `--kernel legacy`: the legacy kernel at the decode A/B's shapes (f32, 8
  rows, ps 64, Pb 4, rng-18 lens; llama3-8b heads at hd 128 and llama3-1b
  heads at hd 64; chip_smoke.legacy_ab_inputs, L2-exceeding cache copies
  cycled), then at the full context above with the bf16 cache.
Each time is CUDA events over one replayed CUDA graph of `--n` launches
(chip_smoke.cuda_ms). `--profile` adds each CUDA kernel's mean device time
per call over 20 eager calls traced with torch.profiler (so the ragged
call's split and merge kernels show apart). Prints one JSON line with the
times, the bounds (the bytes the call must move over 3.35 TB/s,
chip_smoke.bound), the shares of the bound and the card.
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


def legacy_times(out: dict, n: int, profile: bool, full) -> None:
    """The legacy kernel at the decode A/B's shapes (hd 128 and 64), then
    at the full context on the bf16 cache: full = (q, k, v, pt, lens)."""
    from chip_smoke import bound, cuda_ms, kv_bytes, legacy_ab_inputs
    from dynamo_tpu_torch.ops import paged_attention_oracle as leg
    for model in ("llama3-8b", "llama3-1b"):
        a = legacy_ab_inputs(model)
        q, pt, lens, ks, vs = a["q"], a["pt"], a["lens"], a["ks"], a["vs"]
        s, h, hd = q.shape

        def call(i):
            return leg.decode_paged_attention_legacy(
                q, ks[i % len(ks)], vs[i % len(vs)], pt, lens)
        ms = cuda_ms(call, n, graph=True)
        b = bound(a["nbytes"], 4 * int(lens.sum()) * h * hd, "float32")
        out[f"ab_hd{hd}"] = rec = {"ms": ms, "bound_ms": b["bound_ms"],
                                   "share_of_bound": b["bound_ms"] / ms}
        if profile:
            rec["device_us"] = kernel_times(call, 20)
        del a, ks, vs
    q, k, v, pt, lens = full
    nl, hkv, _, _, hd = k.shape
    s, h, _ = q.shape

    def call(i):
        return leg.decode_paged_attention_legacy(q, k[i % nl], v[i % nl], pt,
                                                 lens)
    ms = cuda_ms(call, n, graph=True)
    nbytes = (kv_bytes(lens, hkv, hd, 2, False) + 2 * q.numel() * 2
              + pt.numel() * 4 + lens.numel() * 4)
    b = bound(nbytes, 4 * int(lens.sum()) * h * hd, "bfloat16")
    out["full_bf16"] = rec = {"ms": ms, "bound_ms": b["bound_ms"],
                              "share_of_bound": b["bound_ms"] / ms}
    if profile:
        rec["device_us"] = kernel_times(call, 20)


def main() -> int:
    import torch

    from chip_smoke import bound, cuda_ms, kv_bytes, nvidia_smi

    p = argparse.ArgumentParser(description=" ".join(__doc__.splitlines()[:2]))
    p.add_argument("--checkout", default=str(ROOT))
    p.add_argument("--n", type=int, default=200)
    p.add_argument("--kernel", choices=("ragged", "legacy"),
                   default="ragged")
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
    q = torch.randn((s, h, hd), generator=g, device="cuda",
                    dtype=torch.bfloat16)
    perm = torch.randperm(n_pages - 1, generator=g, device="cuda")
    shapes = {
        "main": (12, [137 + (632 - 137) * i // (s - 1) for i in range(s)]),
        "full": (32, [1536 + 512 * i // (s - 1) for i in range(s)]),
    }
    out = {"checkout": str(Path(args.checkout).resolve()),
           "kernel": args.kernel, "device": nvidia_smi()}
    if args.kernel == "legacy":
        pb, lens = shapes["full"]
        pt = perm[:s * pb].to(torch.int32).reshape(s, pb)
        lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
        legacy_times(out, args.n, args.profile, (q, k, v, pt, lens))
        print(json.dumps(out), flush=True)
        return 0
    (kq, ks), (vq, vs) = quantize_rows(k), quantize_rows(v)
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
