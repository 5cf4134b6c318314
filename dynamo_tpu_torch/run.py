"""Single-command launcher: `python -m dynamo_tpu_torch.run in=X out=Y model`.

Port of dynamo_tpu/run.py for the slice: one process that wires an input to
an engine and runs it.

Inputs:
  in=http[:PORT]     OpenAI HTTP frontend (default port 8080; 0 picks a free
                     port); prints `READY http=:<port> model=<name>` and
                     serves until interrupted
  in=text            interactive chat REPL
  in=stdin           one prompt from stdin -> streamed completion -> exit
  in=batch:FILE      JSONL prompts ({"prompt": ...}) -> JSONL completions
  in=none            build the engine and exit

Outputs (engines):
  out=native         the in-process PyTorch engine (random-init weights)
  out=echo           deterministic token-echo engine (no hardware)

Model: a registry name ("tiny", "llama3-1b", "llama3-8b", "llama3-70b").
The engine runs on CUDA unless `--device cpu` is given; `--quant int8`
stores the seven projections and the head as int8 with per-output-channel
scales (ops/quant.py; on the card every decode projection runs the W8A16
kernel); `--kv-quant int8` stores the KV cache as int8 pages with per-row
scales. Control-plane endpoints (in=endpoint) come with a later slice.
"""
from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import logging
import sys
import uuid

from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.pipeline import LocalPipeline
from dynamo_tpu_torch.llm.worker import EchoTokenEngine, NativeEngineWorker
from dynamo_tpu_torch.protocols.delta import aggregate_chat_chunks
from dynamo_tpu_torch.protocols.openai import ChatCompletionRequest
from dynamo_tpu_torch.runtime.engine import Context

log = logging.getLogger("dynamo_tpu_torch.run")


def build_card(model_spec: str) -> ModelDeploymentCard:
    return ModelDeploymentCard(name=model_spec, arch=model_spec,
                               tokenizer_kind="byte")


async def build_engine(out_spec: str, card: ModelDeploymentCard, args):
    if out_spec == "echo":
        return EchoTokenEngine(delay_s=args.echo_delay)
    if out_spec != "native":
        raise SystemExit(f"unknown out={out_spec!r}")
    from dynamo_tpu_torch.engine.engine import NativeEngine
    model_cfg = card.model_config()
    if args.quant:
        model_cfg = dataclasses.replace(model_cfg, quant=args.quant)
    eng_cfg = EngineConfig(
        page_size=card.kv_page_size, num_pages=args.num_pages,
        max_slots=args.max_slots, max_prefill_chunk=args.max_prefill_chunk,
        max_model_len=min(card.context_length, model_cfg.max_model_len),
        kv_quant=args.kv_quant)
    engine = NativeEngine(model_cfg, eng_cfg,
                          eos_token_ids=set(card.eos_token_ids),
                          device=args.device)
    return await NativeEngineWorker(engine).start()


async def run_http(pipe: LocalPipeline, card, port: int) -> None:
    from dynamo_tpu_torch.frontend.service import HttpService
    service = await HttpService(port=port).start()
    service.models.add(card.name, pipe, card.model_type)
    print(f"READY http=:{service.port} model={card.name}", flush=True)
    try:
        await asyncio.Event().wait()
    finally:
        await service.stop()


async def _stream_chat(pipe: LocalPipeline, card, prompt: str,
                       max_tokens: int, out=sys.stdout) -> None:
    req = ChatCompletionRequest(
        model=card.name, stream=True, max_tokens=max_tokens,
        messages=[{"role": "user", "content": prompt}])
    async for chunk in pipe.generate_chat(req, Context(uuid.uuid4().hex)):
        for choice in chunk.choices:
            if choice.delta.content:
                out.write(choice.delta.content)
                out.flush()
    out.write("\n")


async def run_text(pipe: LocalPipeline, card, max_tokens: int) -> None:
    print(f"model={card.name}; empty line to exit", flush=True)
    loop = asyncio.get_running_loop()
    while True:
        line = await loop.run_in_executor(None, lambda: input("> "))
        if not line.strip():
            return
        await _stream_chat(pipe, card, line, max_tokens)


async def run_stdin(pipe: LocalPipeline, card, max_tokens: int) -> None:
    prompt = sys.stdin.read().strip()
    await _stream_chat(pipe, card, prompt, max_tokens)


async def run_batch(pipe: LocalPipeline, card, path: str,
                    max_tokens: int) -> None:
    """JSONL in ({"prompt": ...}), JSONL out ({"prompt", "text",
    "finish_reason", "completion_tokens"})."""
    with open(path) as f:
        prompts = [json.loads(line)["prompt"] for line in f if line.strip()]

    async def one(prompt):
        req = ChatCompletionRequest(
            model=card.name, stream=False, max_tokens=max_tokens,
            messages=[{"role": "user", "content": prompt}])
        chunks = [c async for c in pipe.generate_chat(req, Context())]
        agg = aggregate_chat_chunks(chunks)
        return {"prompt": prompt,
                "text": agg.choices[0].message.content,
                "finish_reason": agg.choices[0].finish_reason,
                "completion_tokens": (agg.usage.completion_tokens
                                      if agg.usage else None)}

    results = await asyncio.gather(*(one(p) for p in prompts))
    for r in results:
        print(json.dumps(r), flush=True)


async def amain(argv=None) -> None:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("io", nargs="+",
                   help="in=... out=... [model] (order-free key=value)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--max-tokens", type=int, default=256)
    p.add_argument("--num-pages", type=int, default=512)
    p.add_argument("--max-slots", type=int, default=8)
    p.add_argument("--max-prefill-chunk", type=int, default=512)
    p.add_argument("--quant", default="", choices=("", "int8"),
                   help="weight-only quantization: int8 projections and "
                        "head with per-output-channel f32 scales, half "
                        "the weight bytes of bf16 (ops/quant.py)")
    p.add_argument("--kv-quant", default="", choices=("", "int8"),
                   help="KV-cache page quantization: int8 pages + per-row "
                        "f32 scales, about half the bytes per page "
                        "(ops/kv_quant.py; parity-gated by "
                        "dynamo_tpu_torch/bench.py)")
    p.add_argument("--echo-delay", type=float, default=0.0)
    p.add_argument("-v", "--verbose", action="store_true")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.verbose else logging.INFO)

    in_spec, out_spec, model_spec = "text", "echo", "tiny"
    for tok in args.io:
        if tok.startswith("in="):
            in_spec = tok[3:]
        elif tok.startswith("out="):
            out_spec = tok[4:]
        else:
            model_spec = tok

    card = build_card(model_spec)
    engine = await build_engine(out_spec, card, args)
    pipe = LocalPipeline(card, engine)
    try:
        if in_spec == "http" or (in_spec.startswith("http:")
                                 and in_spec[5:].isdigit()):
            port = int(in_spec[5:]) if in_spec != "http" else 8080
            await run_http(pipe, card, port)
        elif in_spec == "text":
            await run_text(pipe, card, args.max_tokens)
        elif in_spec == "stdin":
            await run_stdin(pipe, card, args.max_tokens)
        elif in_spec.startswith("batch:"):
            await run_batch(pipe, card, in_spec[len("batch:"):],
                            args.max_tokens)
        elif in_spec == "none":
            print("READY (in=none; engine built, exiting)", flush=True)
        else:
            raise SystemExit(f"unknown in={in_spec!r}")
    finally:
        if isinstance(engine, NativeEngineWorker):
            await engine.stop()


def main() -> None:
    try:
        asyncio.run(amain())
    except (KeyboardInterrupt, EOFError):
        pass


if __name__ == "__main__":
    main()
