"""The canonical disaggregated serving graph, on the port.

Copied from examples/disagg/graph.py (with `config.yaml` and
`config.cpu.yaml` as `config.json` and `config.cpu.json` beside this
file, the same values). Three services:

- Frontend        OpenAI HTTP, model discovery and KV-aware routing
- DecodeWorker    DisaggDecodeWorker + KvTransferServer + model
                  registration
- PrefillWorker   the prefill queue's consumer + RemoteTransferBackend;
                  it serves a `stats` endpoint whose $STATS carries its
                  counters

`config.json` carries the reference deployment's values (llama3-8b, KV
block 64, max_model_len 16384, one decode and one prefill engine,
max_local_prefill_length 1000, max_prefill_queue_size 2). The engines run
on the card (random weights from seed 0); a config section with
`"device": "cpu"` runs its engine on the CPU (`config.cpu.json`: the tiny
model and a threshold of 10 tokens, so a short chat already prefills
remotely).

Run (one command):
  python -m dynamo_tpu_torch.sdk.serve \\
      dynamo_tpu_torch.examples.disagg.graph:Frontend \\
      -f dynamo_tpu_torch/examples/disagg/config.cpu.json \\
      --start-control-plane --control-port 0

then:
  curl -N localhost:8099/v1/chat/completions \\
    -H 'Content-Type: application/json' \\
    -d '{"model": "tiny", "stream": true, "max_tokens": 16,
         "messages": [{"role": "user", "content": "hello"}]}'

SIGTERM (or SIGINT) to the supervisor stops the frontend, drains the decode
worker (in-flight streams finish, then it deregisters) and the prefill
worker (in-flight items finish and ack), each printing an EXIT line.
"""
from __future__ import annotations

import dataclasses

from dynamo_tpu_torch.disagg.queue import PrefillQueue
from dynamo_tpu_torch.disagg.remote_transfer import (
    KvTransferServer, RemoteTransferBackend,
)
from dynamo_tpu_torch.disagg.router import DisaggregatedRouter
from dynamo_tpu_torch.disagg.worker import (
    DisaggDecodeWorker, PrefillWorker as QueuePrefillWorker,
)
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import NativeEngine
from dynamo_tpu_torch.frontend.discovery import register_model
from dynamo_tpu_torch.frontend.serve import run_frontend
from dynamo_tpu_torch.llm.worker import NativeEngineWorker, serve_llm_worker
from dynamo_tpu_torch.run import build_card
from dynamo_tpu_torch.sdk import async_on_start, depends, endpoint, service
from dynamo_tpu_torch.sdk.config import ServiceConfig

NS = "dynamo-demo"


def _build(cfg: dict):
    """Model card + engine from one service's config section. The card
    carries the engine's max_model_len as its context length: the frontend
    clamps max_tokens to the card's context, so a card left at its 2048
    default would cut a longer prompt's completion to one token."""
    card = build_card(cfg.get("model", "tiny"))
    model_cfg = card.model_config()
    max_len = int(cfg.get("max_model_len",
                          min(card.context_length, model_cfg.max_model_len)))
    card = dataclasses.replace(card, context_length=max_len)
    engine = NativeEngine(
        model_cfg,
        EngineConfig(
            page_size=int(cfg.get("page_size", 64)),
            num_pages=int(cfg.get("num_pages", 128)),
            max_slots=int(cfg.get("max_slots", 4)),
            max_prefill_chunk=int(cfg.get("max_prefill_chunk", 512)),
            prefill_buckets=tuple(
                cfg.get("prefill_buckets", (16, 64, 256, 512))),
            max_model_len=max_len,
        ),
        eos_token_ids=set(card.eos_token_ids),
        device=cfg.get("device", "cuda"))
    return card, engine


def _device_name(engine) -> str:
    dev = engine.device
    if dev.type != "cuda":
        return dev.type
    import torch
    return torch.cuda.get_device_name(dev)


@service(name="PrefillWorker", namespace=NS, component="prefill")
class PrefillWorker:
    """Prefill engine consuming the durable queue; ships KV pages to the
    decode workers over the remote transfer plane."""

    @async_on_start
    async def boot(self):
        cfg = ServiceConfig.global_instance().for_service("PrefillWorker")
        card, engine = _build(cfg)
        queue = PrefillQueue(self.runtime.messaging, NS, card.name)
        transfer = RemoteTransferBackend(self.runtime.kv)
        self.worker = await QueuePrefillWorker(
            NativeEngineWorker(engine), queue, transfer,
            self.runtime.messaging,
            max_inflight=int(cfg.get("max_inflight", 4))).start()
        print(f"PREFILL device={_device_name(engine)}", flush=True)

    @endpoint()
    async def stats(self, request, context):
        yield self.stats_handler()

    def stats_handler(self) -> dict:
        return self.worker.stats_handler()

    async def drain(self) -> None:
        # dynalint: unbounded-io-ok=drain-is-bounded-by-its-timeout_s
        summary = await self.worker.drain(timeout_s=60.0)
        print(f"EXIT prefill completed={self.worker.completed} "
              f"re_leased={summary['re_leased']} logits_nonfinite_steps="
              f"{self.worker.worker.engine.logits_nonfinite_steps()}",
              flush=True)


@service(name="DecodeWorker", namespace=NS, component="backend")
class DecodeWorker:
    """Decode engine with conditional remote prefill and the KV-injection
    server."""

    prefill = depends(PrefillWorker)  # start-order edge; coupled via queue

    @async_on_start
    async def boot(self):
        cfg = ServiceConfig.global_instance().for_service("DecodeWorker")
        card, engine = _build(cfg)
        queue = PrefillQueue(self.runtime.messaging, NS, card.name)
        router = DisaggregatedRouter(
            # the reference example's values: threshold 10, queue gate 2
            max_local_prefill_length=int(
                cfg.get("max_local_prefill_length", 10)),
            max_prefill_queue_size=int(
                cfg.get("max_prefill_queue_size", 2)),
            model=card.name)
        self._watch = router.start_watching(self.runtime.kv)
        worker = DisaggDecodeWorker(
            engine, self.runtime.messaging, router, queue,
            worker_id=f"decode-{self.runtime.worker_id}",
            prefill_timeout_s=float(cfg.get("prefill_timeout_s", 120.0)))
        await worker.start()
        self.kv_server = await KvTransferServer(
            worker, worker.engine_id).start()
        await self.kv_server.register(self.runtime.kv, self.runtime.lease.id)
        self.served = await serve_llm_worker(self.runtime, NS, "backend",
                                             worker)
        await register_model(self.runtime.kv, card.name, NS, "backend",
                             card, model_type=card.model_type,
                             kv_routed=True)
        self.worker = worker
        print(f"DECODE device={_device_name(engine)} "
              f"engine_id={worker.engine_id}", flush=True)

    async def drain(self) -> None:
        # dynalint: unbounded-io-ok=drain-is-bounded-by-its-timeout_s
        await self.served.drain(timeout_s=60.0, poll_s=0.2)
        await self.worker.stop()
        await self.kv_server.stop()
        self._watch.cancel()
        print(f"EXIT decode remote_prefills={self.worker.remote_prefills} "
              f"local_prefills={self.worker.local_prefills} "
              f"logits_nonfinite_steps="
              f"{self.worker.engine.logits_nonfinite_steps()}", flush=True)


@service(name="Frontend", namespace=NS, component="frontend")
class Frontend:
    """OpenAI HTTP frontend; the processor and router roles run in-process
    through the model watcher's discovery-built pipeline."""

    decode = depends(DecodeWorker)  # start-order edge

    @async_on_start
    async def boot(self):
        cfg = ServiceConfig.global_instance().for_service("Frontend")
        self.http = await run_frontend(
            self.runtime, host=cfg.get("host", "127.0.0.1"),
            port=int(cfg.get("port", 8099)),
            kv_routing=bool(cfg.get("kv_routing", True)))
        print(f"FRONTEND http=:{self.http.port}", flush=True)

    async def drain(self) -> None:
        await self.http.watcher.stop()
        await self.http.stop()
