"""Single-command launcher: `python -m dynamo_tpu_torch.run in=X out=Y model`.

Port of dynamo_tpu/run.py for the slice: one process that wires an input to
an engine and runs it.

Inputs:
  in=http[:PORT]     OpenAI HTTP frontend (default port 8080; 0 picks a free
                     port); prints `READY http=:<port> model=<name>` and
                     serves until interrupted, then an `EXIT` line with the
                     engine's $STATS (metrics, kernel launches); honours
                     the DYN_* admission, deadline and QoS knobs of
                     frontend/serve.py
  in=text            interactive chat REPL
  in=stdin           one prompt from stdin -> streamed completion -> exit
  in=batch:FILE      JSONL prompts ({"prompt": ...}) -> JSONL completions
  in=endpoint:NS.COMP.EP  serve the engine as a control-plane endpoint
                     (worker mode; --control-host / --control-port name the
                     server of `python -m dynamo_tpu_torch.runtime.
                     transports.server`): registers the instance and the
                     model (KV-routed), publishes KV events and metrics,
                     prints `READY endpoint=... model=... worker=...
                     device=...`, drains on SIGTERM and prints an `EXIT`
                     line with the engine's non-finite logit steps
  in=none            build the engine and exit

Outputs (engines):
  out=native         the in-process PyTorch engine (the checkpoint's
                     weights, or random weights from seed 0 for a registry
                     model)
  out=echo           deterministic token-echo engine (no hardware)

Model: an HF-style checkpoint directory (config.json, *.safetensors,
tokenizer.json [, tokenizer_config.json with a chat template]), a `.gguf`
file, or a registry name ("tiny", "tiny-moe", "llama3-1b", "llama3-8b",
"llama3-70b", "mixtral-8x7b"). A checkpoint's config sets the
architecture, its tokenizer and chat template the card's; its weights load
onto the device the engine serves from (models/loader.py, llm/gguf.py),
in bfloat16 as the JAX package serves them (config.json's dtype is not
read) unless `--dtype float32` is given. The engine runs on CUDA
unless `--device cpu` is given; `--quant int8` stores the seven
projections and the head as
int8 with per-output-channel scales (ops/quant.py; each layer slice of a
checkpoint is quantized on the device as it loads; on the card every
decode projection runs the W8A16 kernel, and an MoE model's expert
products the grouped W8A16 kernel), which is how mixtral-8x7b fits one
H100; `--kv-quant int8` stores the KV cache as int8 pages with per-row
scales; `--host-pages N` gives the engine a host-DRAM KV tier of N pages
(pinned on the card: at llama3-8b 8,388,608 bytes a bf16 page, 4,325,376
an int8 one); `--spec-decode ngram|draft [--spec-k K] [--spec-draft
MODEL]` verifies K prompt-lookup or draft-model tokens a target forward on
greedy plans (engine/spec.py; the draft a registry name with random
weights from seed 0, or an HF directory, of the served model's
vocabulary). A frontend for endpoint workers is `python -m
dynamo_tpu_torch.frontend.serve`.
"""
from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import logging
import os
import sys
import time
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
    if os.path.isdir(model_spec):
        return ModelDeploymentCard.from_hf_dir(model_spec)
    if model_spec.endswith(".gguf") and os.path.isfile(model_spec):
        return ModelDeploymentCard.from_gguf(model_spec)
    return ModelDeploymentCard(name=model_spec, arch=model_spec,
                               tokenizer_kind="byte")


def load_weights(card: ModelDeploymentCard, model_cfg, device):
    """The checkpoint's parameters on `device` (int8 leaves quantized as
    they load when model_cfg.quant says so), or None for a registry
    model."""
    from dynamo_tpu_torch.models.loader import (
        checkpoint_kind, load_params_from_hf,
    )
    kind = checkpoint_kind(card.model_path)
    if not kind:
        return None
    log.info("loading weights from %s", card.model_path)
    t0 = time.perf_counter()
    if kind == "gguf":
        from dynamo_tpu_torch.llm.gguf import GGUFFile, load_params_from_gguf
        g = GGUFFile(card.model_path)
        try:
            params = load_params_from_gguf(g, model_cfg, device=device)
        finally:
            g.close()
    else:
        params = load_params_from_hf(card.model_path, model_cfg,
                                     device=device)
    log.info("loaded %s in %.2f s", card.model_path,
             time.perf_counter() - t0)
    return params


async def build_engine(out_spec: str, card: ModelDeploymentCard, args):
    if out_spec == "echo":
        return EchoTokenEngine(delay_s=args.echo_delay)
    if out_spec != "native":
        raise SystemExit(f"unknown out={out_spec!r}")
    from dynamo_tpu_torch.engine.engine import NativeEngine, resolve_device
    model_cfg = card.model_config()
    if args.quant or args.dtype:
        model_cfg = dataclasses.replace(model_cfg,
                                        quant=args.quant or model_cfg.quant,
                                        dtype=args.dtype or model_cfg.dtype)
    params = load_weights(card, model_cfg, resolve_device(args.device))
    eng_cfg = EngineConfig(
        page_size=card.kv_page_size, num_pages=args.num_pages,
        max_slots=args.max_slots, max_prefill_chunk=args.max_prefill_chunk,
        mixed_token_budget=args.mixed_token_budget,
        max_prefill_batch=args.max_prefill_batch,
        max_model_len=min(card.context_length, model_cfg.max_model_len),
        host_pages=args.host_pages, kv_quant=args.kv_quant,
        spec_decode=args.spec_decode, spec_k=args.spec_k,
        spec_draft_model=args.spec_draft)
    engine = NativeEngine(model_cfg, eng_cfg, params=params,
                          eos_token_ids=set(card.eos_token_ids),
                          device=args.device)
    return await NativeEngineWorker(engine).start()


async def run_http(pipe: LocalPipeline, card, port: int) -> None:
    from dynamo_tpu_torch.frontend.serve import service_options
    from dynamo_tpu_torch.frontend.service import HttpService
    # the DYN_* admission, deadline and QoS knobs, as frontend/serve.py
    service = await HttpService(port=port, **service_options()).start()
    service.models.add(card.name, pipe, card.model_type)
    print(f"READY http=:{service.port} model={card.name}", flush=True)
    try:
        await asyncio.Event().wait()
    finally:
        await service.stop()


async def run_endpoint(engine, card, spec: str, args) -> None:
    from dynamo_tpu_torch.frontend.discovery import register_model
    from dynamo_tpu_torch.llm.worker import (
        install_graceful_drain, serve_llm_worker,
    )
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    try:
        ns, comp, ep = spec.split(".", 2)
    except ValueError:
        raise SystemExit("in=endpoint needs NS.COMPONENT.ENDPOINT")
    runtime = await DistributedRuntime.connect(
        args.control_host, args.control_port)
    served = await serve_llm_worker(runtime, ns, comp, engine, endpoint=ep)
    # KV-routed: the worker publishes its allocator's events (the JAX
    # run.py registers kv_routed=False, so its frontend never routes by KV)
    await register_model(runtime.kv, card.name, ns, comp, card, endpoint=ep,
                         model_type=card.model_type, kv_routed=True)
    install_graceful_drain(runtime, served)
    device = "none"
    if isinstance(engine, NativeEngineWorker):
        dev = engine.engine.device
        device = dev.type
        if dev.type == "cuda":
            import torch
            device = torch.cuda.get_device_name(dev)
    print(f"READY endpoint={spec} model={card.name} "
          f"worker={runtime.worker_id} epoch={runtime.epoch} "
          f"device={device}", flush=True)
    await runtime.shutdown_event.wait()
    if isinstance(engine, NativeEngineWorker):
        m = engine.engine.metrics()
        print(f"EXIT worker={runtime.worker_id} "
              f"logits_nonfinite_steps="
              f"{engine.engine.logits_nonfinite_steps()} "
              f"requests_admitted={m.requests_admitted} "
              f"lease_lost={runtime.lease_lost}", flush=True)


async def _stream_chat(pipe: LocalPipeline, card, prompt: str,
                       max_tokens: int) -> None:
    # the stream in use at the call, not the one at import (a caller may
    # have replaced sys.stdout since)
    out = sys.stdout
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
                   help="in=... out=... [model: checkpoint directory, "
                        ".gguf file or registry name] (order-free)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--dtype", default="", choices=("", "bfloat16", "float32"),
                   help="the model dtype (default: the model config's, "
                        "bfloat16 for every checkpoint, as in JAX)")
    p.add_argument("--max-tokens", type=int, default=256)
    p.add_argument("--num-pages", type=int, default=512)
    p.add_argument("--max-slots", type=int, default=8)
    p.add_argument("--max-prefill-chunk", type=int, default=512)
    p.add_argument("--mixed-token-budget", type=int,
                   default=EngineConfig.mixed_token_budget,
                   help="device tokens a mixed prefill + decode step holds "
                        "(rows x token bucket); 0 alternates prefill steps "
                        "and decode windows")
    p.add_argument("--max-prefill-batch", type=int,
                   default=EngineConfig.max_prefill_batch,
                   help="sequences one prefill step may hold; 1 prefills "
                        "each alone")
    p.add_argument("--quant", default="", choices=("", "int8"),
                   help="weight-only quantization: int8 projections and "
                        "head with per-output-channel f32 scales, half "
                        "the weight bytes of bf16 (ops/quant.py)")
    p.add_argument("--kv-quant", default="", choices=("", "int8"),
                   help="KV-cache page quantization: int8 pages + per-row "
                        "f32 scales, about half the bytes per page "
                        "(ops/kv_quant.py; parity-gated by "
                        "dynamo_tpu_torch/bench.py)")
    p.add_argument("--host-pages", type=int, default=0,
                   help="host-DRAM KV tier in pages (0 = off): evicted KV "
                        "pages spill to pinned host memory and come back on "
                        "prefix hits (engine/offload.py)")
    p.add_argument("--spec-decode", default="",
                   choices=("", "ngram", "draft"),
                   help="speculative decoding: 'ngram' verifies "
                        "prompt-lookup drafts, 'draft' a small draft "
                        "model's tokens, in one target forward (greedy "
                        "plans; the plain greedy output)")
    p.add_argument("--spec-k", type=int, default=4,
                   help="draft tokens verified per forward with "
                        "--spec-decode")
    p.add_argument("--spec-draft", default="",
                   help="draft model for --spec-decode draft: a registry "
                        "name or an HF checkpoint dir (its vocabulary must "
                        "be the served model's)")
    p.add_argument("--echo-delay", type=float, default=0.0)
    p.add_argument("--control-host", default="127.0.0.1")
    p.add_argument("--control-port", type=int, default=5550)
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
        if in_spec.startswith("endpoint:"):
            await run_endpoint(engine, card, in_spec[len("endpoint:"):],
                               args)
        elif in_spec == "http" or (in_spec.startswith("http:")
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
            if in_spec.startswith("http"):
                # what the served run did: the engine's metrics and the
                # kernel launch counts (the $STATS an endpoint worker gives)
                print(f"EXIT logits_nonfinite_steps="
                      f"{engine.engine.logits_nonfinite_steps()} stats="
                      f"{json.dumps(engine.stats_handler())}", flush=True)
            await engine.stop()


def main() -> None:
    try:
        asyncio.run(amain())
    except (KeyboardInterrupt, EOFError):
        pass


if __name__ == "__main__":
    main()
