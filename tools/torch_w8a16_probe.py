#!/usr/bin/env python3
"""Split a W8A16 decode launch's time into parts, on the card.

    python3 tools/torch_w8a16_probe.py [--out build/w8a16_probe.json]

At llama3-8b's wk (4096 x 1024), w_gate (4096 x 14336) and lm_head
(4096 x 128256) with M = 8 bf16 rows, CUDA-event times over a replayed
graph of 40 launches, the weights cycled over copies past the 50 MB L2 (a
decode step reads each weight once):
- the per-weight register-ring kernel (`quant.w8a16_gemm`, bf16 x): an
  empty cluster launch of its grid, the same grid streaming its weight
  bytes only (tools/w8a16_launch_probe.cu), and the full kernel;
- the grouped decode kernel (`quant.w8a16_group`, one weight): an empty
  launch of its grid (clusters, shared memory and the programmatic
  dependent launch as the kernel launches), without the programmatic
  launch, and the full kernel;
- the bound: the call's bytes (K N + 4 N + 2 M K + 2 M N) over 3.35 TB/s.
Prints one line a shape and the card's name and power limit, and writes
the record as JSON. Needs the card; builds the probe library with the
flags of dynamo_tpu_torch/ops/build.py into build/. chip_smoke.py's
phase 2d calls `build_probe` and `measure` too.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

H100_BYTES_PER_S = 3.35e12
SHAPES = {"wk": (4096, 1024), "w_gate": (4096, 14336),
          "lm_head": (4096, 128256)}
M = 8
LAUNCHES = 40


def build_probe():
    from dynamo_tpu_torch.ops import build
    src = ROOT / "tools" / "w8a16_launch_probe.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(
        build.NVCC_FLAGS).encode()).hexdigest()[:16]
    out = ROOT / "build" / f"w8a16_launch_probe-{digest}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        r = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o",
                            str(out), str(src)], capture_output=True,
                           text=True)
        if r.returncode != 0:
            raise RuntimeError(f"probe build failed (nvcc exit "
                               f"{r.returncode}):\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.probe_empty.restype = ctypes.c_int
    lib.probe_empty.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.probe_stream.restype = ctypes.c_int
    lib.probe_stream.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 4
                                 + [ctypes.c_uint, ctypes.c_void_p,
                                    ctypes.c_void_p])
    return lib


def graph_ms(fn, n: int = LAUNCHES) -> float:
    """CUDA-event time per call of fn(0) .. fn(n - 1) captured in one CUDA
    graph and replayed (after a warm-up and one replay)."""
    import torch
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(n):
            fn(i)
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def measure(lib, smi: str) -> dict:
    """The split at each of SHAPES, printed one line a shape; returns the
    record. `lib`: the probe library (`build_probe()`)."""
    import torch
    from dynamo_tpu_torch.ops import quant
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sink = torch.zeros(1, dtype=torch.int32, device="cuda")
    bf16 = torch.bfloat16
    rec = {"device": smi, "m": M, "shapes": {}}

    def check(err: int, what: str) -> None:
        if err != 0:
            raise RuntimeError(f"{what}: CUDA error {err}")

    for name, (k, n) in SHAPES.items():
        copies = max(1, -(-(128 << 20) // (k * n)))
        g = torch.Generator(device="cuda").manual_seed(0)
        ws = []
        for _ in range(copies):
            w = torch.randn((k, n), generator=g, device="cuda") * k ** -0.5
            qw = quant.quantize_int8(w)
            ws.append({"q": qw["q"], "s": qw["s"].reshape(-1)})
            del w
        x = torch.randn((M, k), generator=g, device="cuda").to(bf16)
        stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
        # the per-weight register-ring kernel's grid and times
        splits, per = quant.gemm_config(M, k, n, sms)
        tiles = -(-n // quant._MMA_TILE_N)
        old = {
            "grid": [splits, tiles], "per": per,
            "empty_ms": graph_ms(lambda i: check(lib.probe_empty(
                splits, tiles, 256, splits, 0, 0, stream()), "empty")),
            "stream_ms": graph_ms(lambda i: check(lib.probe_stream(
                ws[i % copies]["q"].data_ptr(), k, n, splits, per,
                0x9E3779B9, sink.data_ptr(), stream()), "stream")),
            "full_ms": graph_ms(lambda i: quant.w8a16_gemm(
                x, ws[i % copies]["q"], ws[i % copies]["s"]))}
        # the grouped kernel's grid (one weight) and times
        gs, gper, per_block, blocks = quant.group_config(k, [n], sms)
        smem = quant.GROUP_SMEM_BYTES
        new = {
            "grid": [gs, blocks], "per": gper, "tiles_per_block": per_block,
            "empty_pdl_ms": graph_ms(lambda i: check(lib.probe_empty(
                gs, blocks, 160, gs, smem, 1, stream()), "empty")),
            "empty_ms": graph_ms(lambda i: check(lib.probe_empty(
                gs, blocks, 160, gs, smem, 0, stream()), "empty")),
            "full_ms": graph_ms(lambda i: quant.w8a16_group(
                x, [ws[i % copies]["q"]], [ws[i % copies]["s"]]))}
        nbytes = k * n + 4 * n + 2 * M * k + 2 * M * n
        bound_ms = nbytes / H100_BYTES_PER_S * 1e3
        rec["shapes"][name] = {"K": k, "N": n, "bytes": nbytes,
                               "bound_ms": bound_ms, "per_weight": old,
                               "grouped": new, "weight_copies": copies}
        print(f"probe {name} (K={k}, N={n}, M={M}; bound {bound_ms:.4f} "
              f"ms): per-weight kernel grid {splits} x {tiles} (clusters of "
              f"{splits}): empty launch {old['empty_ms']:.4f} ms, streaming "
              f"its weights only {old['stream_ms']:.4f} ms, full kernel "
              f"{old['full_ms']:.4f} ms; grouped kernel grid {gs} x "
              f"{blocks} ({per_block} tiles a block, clusters of {gs}): "
              f"empty launch {new['empty_pdl_ms']:.4f} ms (programmatic "
              f"launch) / {new['empty_ms']:.4f} ms (plain), full kernel "
              f"{new['full_ms']:.4f} ms [{smi}]", flush=True)
        del ws, x
        torch.cuda.empty_cache()
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "build"
                                         / "w8a16_probe.json"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_w8a16_probe: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    rec = measure(build_probe(), smi)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rec, indent=1))
    print(json.dumps({"probe": str(out.relative_to(ROOT)) if
                      out.is_relative_to(ROOT) else str(out)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
