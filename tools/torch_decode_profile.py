#!/usr/bin/env python3
"""Where a decode step of the PyTorch/H100 port spends its time.

    python3 tools/torch_decode_profile.py [--windows 2] [--kv-quant int8]

Builds the port's llama3-8b NativeEngine on one card (random bf16 weights,
default EngineConfig; `--kv-quant int8` for int8 KV pages) and admits
chip_smoke.py's 8 chat requests (its `chat_requests`, through the chat
template). It calls `engine.step()` until a step is a pure decode window
with nothing left waiting, so all 8 requests are in decode slots; then it
times `--windows` more steps with the host clock (each ending in a
synchronize) and traces one more with torch.profiler. Prints the window's
wall time per decode step, the device-busy share (sum of kernel time over wall time), and the kernels that
take the most device time. Imports only the port (dynamo_tpu_torch), torch
and chip_smoke.py.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import chat_requests, nvidia_smi
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import NativeEngine
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.llm.worker import to_engine_request
    from dynamo_tpu_torch.run import build_card

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--windows", type=int, default=2)
    p.add_argument("--kv-quant", default="", choices=("", "int8"))
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("torch_decode_profile: needs a CUDA card", file=sys.stderr)
        return 2
    smi = nvidia_smi()
    card = build_card("llama3-8b")
    engine = NativeEngine(card.model_config(),
                          EngineConfig(kv_quant=args.kv_quant),
                          eos_token_ids=set(card.eos_token_ids), seed=0,
                          device="cuda")
    pre = OpenAIPreprocessor(card)
    for i, req in enumerate(chat_requests(card.name)):
        engine.add_request(to_engine_request(
            pre.preprocess_chat(req, f"r{i}")[0]))

    def step():
        """One engine step: (wall s, decode steps it ran, was a window)."""
        windows, steps = engine.decode_windows, engine.decode_window_steps
        t0 = time.perf_counter()
        engine.step()               # a window ends in its one host copy
        torch.cuda.synchronize()
        return (time.perf_counter() - t0,
                engine.decode_window_steps - steps,
                engine.decode_windows > windows)

    # prefill and mixed steps until a step is a decode window with nothing
    # waiting: all 8 requests decode from here on (that window warms up)
    while not (step()[2] and engine.metrics().num_requests_waiting == 0):
        pass
    times = [step() for _ in range(args.windows)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced = step()
    wall, steps, _ = traced
    if not all(is_window for _, _, is_window in times + [traced]):
        print("a timed step was not a decode window", file=sys.stderr)
        return 1
    events = prof.key_averages()
    dev = [e for e in events if e.device_type.name == "CUDA"
           and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in dev)
    print(f"device: {smi}; torch {torch.__version__}")
    for w, n, _ in times:
        print(f"window: {n} steps in {w * 1e3:.2f} ms = "
              f"{w / n * 1e3:.2f} ms per decode step (8 slots)")
    print(f"traced window: {steps} steps, wall {wall * 1e3:.2f} ms, device "
          f"busy {busy_us / 1e3:.2f} ms ({busy_us / 1e3 / (wall * 1e3):.1%}"
          f" of wall), {sum(e.count for e in dev)} kernel launches")
    ranked = sorted(dev, key=lambda e: -e.self_device_time_total)
    # the top 15, then the port's own kernels wherever they rank
    own = ("ragged_split_kernel", "merge_splits_kernel", "legacy_decode")
    for i, e in enumerate(ranked):
        if i < 15 or any(k in e.key for k in own):
            print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x"
                  f"  {e.key[:90]}")
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
