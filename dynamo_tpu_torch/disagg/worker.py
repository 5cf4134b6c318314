"""Disaggregated decode and prefill workers.

Copied from dynamo_tpu/disagg/worker.py:41-980.

Decode side (`DisaggDecodeWorker`): per request, prefill locally or
remotely. Remote: allocate the decode pages up front, enqueue a
RemotePrefillRequest on the durable queue, keep serving the other requests
while the prefill engine works, and splice the request into the decode
batch when its KV has landed. With early decode (the default, and only
with a chunk-committed KvTransferServer attached) the prefill side's first
token is emitted as soon as it is sampled and decode activates once the
transfer's committed frontier covers every page. A failed or timed-out
remote prefill salvages the committed prefix (re-prefilling only the
tail) or, when nothing committed, prefills locally from token zero; both
are counted (`salvaged_prefills`, `full_reprefills`, `overlap_fallbacks`)
on $STATS, with the transfer and integrity counters, a log of recent
decisions and each remote request's enqueue -> activation time.

Prefill side (`PrefillWorker`): consume the queue under leases, run the
prefill-only request on its own engine, notify the first token early, push
the KV pages to the decode engine over the transfer backend, notify the
completion, ack. A cancel broadcast drops a queued item or aborts a running
one; an item whose client deadline passed is dropped at dequeue; `drain`
stops consuming and leaves unfinished items to their leases.

Multimodal requests (JAX :54, :72-80, :203-225, :258-269, :861-864): the
decode worker's `mm_transfer` picks what the queue carries. "pixels" (the
default) ships the request's image parts and the prefill worker's tower
encodes them; "embeds" encodes once on the decode side (its allocation
needs the salts anyway) and ships the projected patch embeds with their
salts, so the prefill side never runs its tower.

With a shared or cross-host KV pool attached to the prefill engine, an
item whose prompt matches two or more pool pages re-arms its lease before
the engine claims them (`_touch_for_pool_claim`, JAX :945-972): a ladder of
verified remote fetches, each possibly failing over, may outlast the lease,
and a redelivery mid-fetch would start a second sender.

Tracing (JAX :254-534, :838-921): the decode side's `prefill.remote`
span covers enqueue -> completion or timeout, and its context rides the
queued item (`RemotePrefillRequest.trace`), so the prefill side's
`queue.wait` (derived from `enqueued_unix`: the processes share no
monotonic clock), `prefill.run` and transfer spans land in the same trace.
Each emitted frame records a `decode.emit` instant (`first`, `early` on the
first token) and a salvage a `kv.salvage` instant. A drain counts on
DRAIN_STATS as the JAX drain does (`drains_started`, `cancelled_streams`
for the items left to their leases, `drains_completed`).
"""
from __future__ import annotations

import asyncio
import dataclasses
import logging
import time
from collections import OrderedDict

import numpy as np

from dynamo_tpu_torch.disagg.protocols import (
    PrefillCancel, PrefillCompletion, RemotePrefillRequest, cancel_subject,
    completion_subject,
)
from dynamo_tpu_torch.disagg.queue import PrefillQueue
from dynamo_tpu_torch.disagg.router import DisaggregatedRouter
from dynamo_tpu_torch.disagg.transfer import TransferBackend
from dynamo_tpu_torch.engine.scheduler import EngineRequest
from dynamo_tpu_torch.llm.worker import NativeEngineWorker, to_engine_request
from dynamo_tpu_torch.protocols.common import (
    EngineOutput, FinishReason, ImagePart, PreprocessedRequest,
    preprocessed_from_wire,
)
from dynamo_tpu_torch.runtime.component import DRAIN_STATS
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.integrity import STATS as INTEGRITY, XFER_STATS
from dynamo_tpu_torch.runtime.qos import qos_of
from dynamo_tpu_torch.runtime.tracing import TRACER, TraceContext

log = logging.getLogger("dynamo_tpu_torch.disagg")

_LOG_LEN = 256  # recent decisions / transfers kept for $STATS


def _bounded_put(d: OrderedDict, key, value) -> None:
    d[key] = value
    while len(d) > _LOG_LEN:
        d.popitem(last=False)


def _peak_bytes(engine) -> int:
    """The engine device's peak allocated bytes (0 on the CPU)."""
    if engine.device.type != "cuda":
        return 0
    import torch
    return int(torch.cuda.max_memory_allocated(engine.device))


class DisaggDecodeWorker(NativeEngineWorker):
    """Decode worker with conditional remote prefill."""

    serving_role = "decode"

    def __init__(self, engine, messaging, disagg_router: DisaggregatedRouter,
                 prefill_queue: PrefillQueue, worker_id: str = "",
                 prefill_timeout_s: float = 120.0, early_decode: bool = True,
                 mm_transfer: str = "pixels"):
        super().__init__(engine)
        self.messaging = messaging
        self.disagg_router = disagg_router
        self.prefill_queue = prefill_queue
        self.engine_id = worker_id or f"decode-{id(self):x}"
        self.prefill_timeout_s = prefill_timeout_s
        # early decode: emit the first token when the prefill samples it
        # and gate activation on this worker's committed frontier (needs
        # an attached KvTransferServer; otherwise the early notify is
        # ignored and the final completion activates)
        self.early_decode = early_decode
        # multimodal payload on the prefill queue: "pixels" re-encodes on
        # the prefill side; "embeds" ships this worker's tower output and
        # the salts, so the tower runs once a request
        if mm_transfer not in ("pixels", "embeds"):
            raise ValueError(f"mm_transfer must be 'pixels' or 'embeds', "
                             f"got {mm_transfer!r}")
        self.mm_transfer = mm_transfer
        self.notify_subject = completion_subject(self.engine_id)
        self._completions: dict[str, asyncio.Future] = {}
        self._notify_task: asyncio.Task | None = None
        self.remote_prefills = 0
        self.local_prefills = 0
        # fallback disposition: salvages kept a committed prefix and
        # prefilled only the tail; full re-prefills started from token
        # zero; majority_committed_full_reprefills would be full restarts
        # that threw away a >= 50 % committed transfer (a tripwire: salvage
        # takes any frontier > 0)
        self.salvaged_prefills = 0
        self.full_reprefills = 0
        self.majority_committed_full_reprefills = 0
        self.prefill_timeouts = 0
        # early decode: first tokens emitted while the transfer streamed,
        # and overlap attempts that fell back before activation
        self.early_first_emits = 0
        self.overlap_fallbacks = 0
        # recent requests: the local/remote decision and its inputs, and
        # the remote ones' enqueue -> activation time
        self.decisions: OrderedDict = OrderedDict()
        self.activations: OrderedDict = OrderedDict()
        # set by KvTransferServer when one is attached to this worker
        self.kv_transfer_server = getattr(self, "kv_transfer_server", None)

    async def start(self):
        await super().start()
        # subscribe before returning: a completion published right after
        # start cannot be dropped
        sub = await self.messaging.subscribe(self.notify_subject)
        self._notify_task = asyncio.create_task(self._notify_loop(sub))
        return self

    async def stop(self):
        if self._notify_task:
            self._notify_task.cancel()
            try:
                await self._notify_task
            except asyncio.CancelledError:
                pass
            self._notify_task = None
        await super().stop()

    async def _notify_loop(self, sub):
        async for _subject, payload in sub:
            try:
                done = PrefillCompletion.from_bytes(payload)
            except Exception:  # dynalint: swallow-ok=malformed-peer-frame-logged
                log.exception("malformed prefill completion: %r",
                              payload[:200])
                continue
            if done.transfer_pending and not (
                    self.early_decode
                    and self.kv_transfer_server is not None):
                # wait-for-completion mode: only the final or an error
                # completion may resolve the wait
                continue
            fut = self._completions.pop(done.request_id, None)
            if fut is not None and not fut.done():
                fut.set_result(done)

    # -- request path ---------------------------------------------------------

    async def generate(self, request, context: Context):
        pre = (preprocessed_from_wire(request) if isinstance(request, dict)
               else request)
        req = to_engine_request(pre)
        use_remote = False
        # a short prompt can never go remote (a prefix hit only shrinks the
        # uncached length): skip the engine and queue round trips
        if len(req.prompt) > self.disagg_router.max_local_prefill_length:
            try:
                prefix_hit = await self.submit(
                    lambda eng: eng.scheduler.peek_prefix(req.prompt))
                depth = await self.prefill_queue.depth()
                use_remote = self.disagg_router.prefill_remote(
                    len(req.prompt), prefix_hit, depth)
                _bounded_put(self.decisions, req.request_id, {
                    "prompt_len": len(req.prompt), "prefix_hit": prefix_hit,
                    "queue_depth": depth, "remote": use_remote})
            except Exception:  # dynalint: swallow-ok=falls-back-to-local-prefill
                log.exception("disagg decision failed; prefilling locally")
        else:
            _bounded_put(self.decisions, req.request_id, {
                "prompt_len": len(req.prompt), "remote": False})
        if not use_remote:
            self.local_prefills += 1
            async for frame in super().generate(pre, context):
                yield frame
            return
        async for frame in self._generate_remote(pre, req, context):
            yield frame

    async def _broadcast_cancel(self, rid: str) -> None:
        """Tell the prefill fleet this request's remote prefill is moot: on
        every abandoning exit (client stop, timeout, deadline)."""
        try:
            await self.messaging.publish(
                cancel_subject(self.prefill_queue.name),
                PrefillCancel(request_id=rid).to_bytes())
        except Exception:  # dynalint: swallow-ok=best-effort-cancel-broadcast
            log.exception("prefill cancel publish failed for %s", rid)

    def _committed_frontier(self, rid: str, alloc_epoch: int) -> int:
        """Transfer-list pages the attached transfer server committed for
        this allocation (0 without a server: the local backend is
        all-or-nothing)."""
        srv = self.kv_transfer_server
        if srv is None:
            return 0
        return srv.committed_frontier(rid, alloc_epoch)

    def _register(self, request_id: str) -> asyncio.Queue:
        q: asyncio.Queue = asyncio.Queue()
        self._queues[request_id] = q
        return q

    async def _generate_remote(self, pre: PreprocessedRequest,
                               req: EngineRequest, context: Context):
        rid = req.request_id
        mm_parts = pre.mm_parts
        if self.mm_transfer == "embeds" and req.mm_pixels:
            # encode once here (allocate_remote would, for the salts), then
            # ship the embeds and salts: the prefill side skips its tower
            req = await self.submit(lambda eng: eng._resolve_mm(req))
            mm_parts = [
                ImagePart(offset=int(off), shape=list(emb.shape),
                          dtype="float32", kind="embeds", salt=int(salt),
                          data=np.ascontiguousarray(
                              emb, np.float32).tobytes())
                for off, emb, salt in req.mm_spans or []]
        try:
            alloc = await self.submit(lambda eng: eng.allocate_remote(req))
        except ValueError as e:
            # admission rejection: the local path's error frame
            yield EngineOutput(finish_reason=FinishReason.ERROR, text=str(e))
            return
        if alloc is None:
            log.info("remote alloc failed for %s; local fallback", rid)
            self.local_prefills += 1
            async for frame in super().generate(pre, context):
                yield frame
            return
        # until the sequence is released or activated, every exit frees
        # the up-front allocation (a staged abort)
        holding = True
        try:
            self.remote_prefills += 1
            fut: asyncio.Future = asyncio.get_running_loop().create_future()
            self._completions[rid] = fut
            remaining = context.time_remaining()
            t_enqueue = time.monotonic()
            # "prefill.remote" covers enqueue -> completion or timeout; the
            # queued item carries its context, so the prefill side's spans
            # nest under it in the request's one trace
            with TRACER.span("prefill.remote", context.trace,
                             request_id=rid, pages=len(alloc.page_ids),
                             cached_tokens=alloc.num_cached_tokens) as rsp:
                rtc = rsp.context()
                await self.prefill_queue.enqueue(RemotePrefillRequest(
                    engine_id=self.engine_id, request_id=rid,
                    token_ids=list(pre.token_ids), sampling=pre.sampling,
                    stop=pre.stop, page_ids=alloc.page_ids,
                    num_cached_tokens=alloc.num_cached_tokens,
                    page_size=self.engine.cfg.page_size,
                    alloc_epoch=alloc.alloc_epoch,
                    notify_subject=self.notify_subject,
                    deadline_unix=(time.time() + remaining
                                   if remaining is not None else None),
                    mm_parts=mm_parts,
                    trace=rtc.to_wire() if rtc is not None else None,
                    enqueued_unix=time.time(), qos=qos_of(context.baggage)))
                stop_task = asyncio.create_task(context.wait_stopped())
                try:
                    await asyncio.wait(
                        {asyncio.ensure_future(fut), stop_task},
                        timeout=self.prefill_timeout_s,
                        return_when=asyncio.FIRST_COMPLETED)
                finally:
                    stop_task.cancel()
                self._completions.pop(rid, None)
                rsp.set(completed=fut.done(), stopped=context.is_stopped)
            if context.is_stopped:
                await self._broadcast_cancel(rid)
                yield EngineOutput(finish_reason=FinishReason.CANCELLED)
                return
            completion = fut.result() if fut.done() else None
            if completion is not None and completion.error is None \
                    and completion.transfer_pending \
                    and completion.first_token is not None:
                hold = [True]
                try:
                    async for frame in self._generate_overlapped(
                            pre, req, context, alloc, completion, hold,
                            t_enqueue):
                        yield frame
                finally:
                    holding = hold[0]
                return
            if completion is None or completion.error:
                if completion is None:
                    self.prefill_timeouts += 1
                    await self._broadcast_cancel(rid)
                if context.deadline_expired:
                    await self.submit(lambda eng: eng.release_remote(rid))
                    holding = False
                    yield EngineOutput(
                        finish_reason=FinishReason.ERROR,
                        text="deadline exceeded during remote prefill")
                    return
                frontier = self._committed_frontier(rid, alloc.alloc_epoch)
                if frontier > 0:
                    # salvage the committed prefix; prefill only the tail
                    ps = self.engine.cfg.page_size
                    valid_pages = alloc.num_cached_tokens // ps + frontier
                    log.warning("remote prefill failed for %s (%s); "
                                "salvaging %d committed page(s)", rid,
                                completion.error if completion else
                                "timeout", frontier)
                    self.salvaged_prefills += 1
                    XFER_STATS.salvaged_pages += frontier
                    q = self._register(rid)
                    try:
                        salvaged = await self.submit(
                            lambda eng: eng.salvage_remote(rid, valid_pages))
                        TRACER.event("kv.salvage", context.trace,
                                     request_id=rid, pages=frontier,
                                     tokens=salvaged)
                        async for frame in self._stream(rid, context, q):
                            yield frame
                        holding = False
                    finally:
                        self._queues.pop(rid, None)
                    return
                log.warning("remote prefill failed for %s (%s); full local "
                            "fallback (nothing committed)", rid,
                            completion.error if completion else "timeout")
                self.full_reprefills += 1
                shipped = (len(alloc.page_ids) - alloc.num_cached_tokens
                           // self.engine.cfg.page_size)
                if shipped > 0 and frontier >= 0.5 * shipped:
                    self.majority_committed_full_reprefills += 1
                await self.submit(lambda eng: eng.release_remote(rid))
                holding = False
                self.local_prefills += 1
                async for frame in super().generate(pre, context):
                    yield frame
                return
            # the KV pages are injected (the transfer precedes the notify)
            first = int(completion.first_token)
            p = req.params
            # the local path's stop semantics: hidden stop ids and eos are
            # never emitted
            hidden_stop = first in p.stop_token_ids
            eos = (not p.ignore_eos) and first in self.engine.eos_token_ids
            if hidden_stop or eos or p.max_tokens <= 1:
                await self.submit(lambda eng: eng.release_remote(rid))
                holding = False
                if not (hidden_stop or eos):
                    TRACER.event("decode.emit", context.trace, n=1,
                                 first=True)
                    yield EngineOutput(token_ids=[first])
                yield EngineOutput(finish_reason=(
                    FinishReason.STOP if (hidden_stop or eos)
                    else FinishReason.LENGTH))
                return
            TRACER.event("decode.emit", context.trace, n=1, first=True)
            yield EngineOutput(token_ids=[first])
            q = self._register(rid)
            try:
                await self.submit(
                    lambda eng: eng.activate_remote(rid, first))
                _bounded_put(self.activations, rid,
                             (time.monotonic() - t_enqueue) * 1e3)
                async for frame in self._stream(rid, context, q):
                    yield frame
                holding = False  # _stream owns cleanup from activation on
            finally:
                self._queues.pop(rid, None)
        finally:
            self._completions.pop(rid, None)
            if self.kv_transfer_server is not None:
                self.kv_transfer_server.forget(rid)
            if holding:
                self._pending_aborts.append(rid)
                self._wake.set()

    async def _overlap_wait(self, rid: str, context: Context,
                            q: asyncio.Queue):
        """Wait for the first decode frame of an overlap-gated request, a
        failure notify, a client stop or the timeout: ("frame", output) |
        ("stopped", None) | ("error", completion or None). A duplicate or
        final success notify is absorbed."""
        loop = asyncio.get_running_loop()
        deadline = loop.time() + self.prefill_timeout_s
        stop_task = asyncio.create_task(context.wait_stopped())
        get = asyncio.create_task(q.get())
        try:
            while True:
                err_fut: asyncio.Future = loop.create_future()
                self._completions[rid] = err_fut
                timeout = deadline - loop.time()
                if timeout <= 0:
                    return ("error", None)
                done, _ = await asyncio.wait(
                    {get, err_fut, stop_task}, timeout=timeout,
                    return_when=asyncio.FIRST_COMPLETED)
                if get in done:
                    return ("frame", get.result())
                if stop_task in done:
                    return ("stopped", None)
                if err_fut in done:
                    comp = err_fut.result()
                    if comp.error:
                        return ("error", comp)
                    continue
                return ("error", None)   # timeout
        finally:
            self._completions.pop(rid, None)
            if not get.done():
                get.cancel()
            stop_task.cancel()

    async def _generate_overlapped(self, pre: PreprocessedRequest,
                                   req: EngineRequest, context: Context,
                                   alloc, completion, hold, t_enqueue):
        """Early decode: emit the sampled first token now, arm the
        committed-frontier gate, and stream once it opens. A failure before
        it opens takes the salvage / re-prefill decisions of the
        non-overlapped path, the emitted first token charged through the
        resume machinery, never emitted again."""
        rid = req.request_id
        first = int(completion.first_token)
        p = req.params
        ps = self.engine.cfg.page_size
        hidden_stop = first in p.stop_token_ids
        eos = (not p.ignore_eos) and first in self.engine.eos_token_ids
        if hidden_stop or eos or p.max_tokens <= 1:
            # no decode will run: settle now; the sender's remaining chunks
            # fail on the pending guard
            await self.submit(lambda eng: eng.release_remote(rid))
            hold[0] = False
            if not (hidden_stop or eos):
                TRACER.event("decode.emit", context.trace, n=1,
                             first=True, early=True)
                yield EngineOutput(token_ids=[first])
            yield EngineOutput(finish_reason=(
                FinishReason.STOP if (hidden_stop or eos)
                else FinishReason.LENGTH))
            return
        # the first token is emitted while the KV tail is still in flight
        self.early_first_emits += 1
        TRACER.event("decode.emit", context.trace, n=1, first=True,
                     early=True)
        yield EngineOutput(token_ids=[first])
        srv = self.kv_transfer_server
        epoch = alloc.alloc_epoch
        start_page = alloc.num_cached_tokens // ps
        needed = len(alloc.page_ids) - start_page
        q = self._register(rid)

        def frontier():
            # polled by the engine's gate; the first reading that covers
            # the transfer list is the activation instant
            f = srv.committed_frontier(rid, epoch)
            if f >= needed and rid not in self.activations:
                _bounded_put(self.activations, rid,
                             (time.monotonic() - t_enqueue) * 1e3)
            return f

        try:
            await self.submit(lambda eng: eng.preactivate_remote(
                rid, first, needed, frontier))
            kind, val = await self._overlap_wait(rid, context, q)
            if kind == "frame":
                if val.token_ids:
                    TRACER.event("decode.emit", context.trace,
                                 n=len(val.token_ids))
                yield val
                if val.finish_reason is not None:
                    hold[0] = False   # the engine already finished it
                    return
                async for f2 in self._stream(rid, context, q):
                    yield f2
                hold[0] = False
                return
            if kind == "stopped":
                # the caller's finally stages the abort, which drops the
                # gate and the allocation
                await self._broadcast_cancel(rid)
                yield EngineOutput(finish_reason=FinishReason.CANCELLED)
                return
            # failed or timed out before any decode frame: disarm the gate,
            # unless activation won the race (then decode owns the request)
            still_gated = await self.submit(
                lambda eng: eng.cancel_overlap(rid))
            if not still_gated:
                async for f2 in self._stream(rid, context, q):
                    yield f2
                hold[0] = False
                return
            failure = val
            self.overlap_fallbacks += 1
            if failure is None:
                self.prefill_timeouts += 1
                await self._broadcast_cancel(rid)
            if context.deadline_expired:
                await self.submit(lambda eng: eng.release_remote(rid))
                hold[0] = False
                yield EngineOutput(
                    finish_reason=FinishReason.ERROR,
                    text="deadline exceeded during remote prefill")
                return
            frontier_now = self._committed_frontier(rid, epoch)
            if frontier_now > 0:
                log.warning("remote prefill failed for %s mid-overlap "
                            "(%s); salvaging %d committed page(s)", rid,
                            failure.error if failure else "timeout",
                            frontier_now)
                self.salvaged_prefills += 1
                XFER_STATS.salvaged_pages += frontier_now
                salvaged = await self.submit(lambda eng: eng.salvage_remote(
                    rid, start_page + frontier_now, first_token=first))
                TRACER.event("kv.salvage", context.trace, request_id=rid,
                             pages=frontier_now, tokens=salvaged)
                async for f2 in self._stream(rid, context, q):
                    yield f2
                hold[0] = False
                return
            # nothing committed: a full local prefill through the resume
            # machinery (token_ids carries the emitted first token)
            log.warning("remote prefill failed for %s mid-overlap (%s); "
                        "full local fallback (nothing committed)", rid,
                        failure.error if failure else "timeout")
            self.full_reprefills += 1
            await self.submit(lambda eng: eng.release_remote(rid))
            hold[0] = False
            self.local_prefills += 1
            fb = dataclasses.replace(
                pre, token_ids=list(pre.token_ids) + [first],
                resume_committed=1 + (pre.resume_committed or 0))
            self._queues.pop(rid, None)   # super().generate registers again
            async for f2 in super().generate(fb, context):
                yield f2
        finally:
            self._queues.pop(rid, None)

    def stats_handler(self) -> dict:
        stats = super().stats_handler()
        srv = self.kv_transfer_server
        stats["disagg"] = {
            "remote_prefills": self.remote_prefills,
            "local_prefills": self.local_prefills,
            "salvaged_prefills": self.salvaged_prefills,
            "full_reprefills": self.full_reprefills,
            "majority_committed_full_reprefills":
                self.majority_committed_full_reprefills,
            "prefill_timeouts": self.prefill_timeouts,
            "early_first_emits": self.early_first_emits,
            "overlap_fallbacks": self.overlap_fallbacks,
            "overlap_activations":
                self.engine.scheduler.overlap_activations,
            "received_pages": srv.received_pages if srv is not None else 0,
            "decisions": dict(self.decisions),
            "activation_ms": dict(self.activations),
            "integrity": INTEGRITY.snapshot(),
            "kv_transfer": XFER_STATS.snapshot(),
            "graphs": self.engine.graphs.captured,
            # (rp, lp, greedy, fused, nw, S, Pb, stop width, hist width)
            "graph_keys": [list(k) for k in
                           self.engine.graphs.captured_calls()],
            "graph_resets": self.engine.graphs.resets,
            "peak_bytes": _peak_bytes(self.engine),
        }
        return stats


class PrefillWorker:
    """Queue consumer running prefill-only requests on its own engine.

    Consumption is leased: the item is acked only after the completion
    notify (success or a clean failure), so a worker that dies mid-item
    leaves the lease to expire and the item is redelivered. A duplicate run
    after a completed transfer fails safely on the decode side's pending
    guard."""

    serving_role = "prefill"

    def __init__(self, worker: NativeEngineWorker, queue: PrefillQueue,
                 transfer: TransferBackend, messaging,
                 dequeue_timeout_s: float = 1.0, max_inflight: int = 4,
                 lease_s: float = 60.0, early_notify: bool = True):
        self.worker = worker
        self.queue = queue
        self.transfer = transfer
        self.messaging = messaging
        self.dequeue_timeout_s = dequeue_timeout_s
        self.lease_s = lease_s
        # early decode: notify the first token (transfer_pending) before
        # the transfer; a decode worker without the overlap ignores it
        self.early_notify = early_notify
        # cap concurrent handlers so excess work stays in the durable
        # queue, whose depth is the routers' backpressure signal
        self._slots = asyncio.Semaphore(max_inflight)
        self._loop_task: asyncio.Task | None = None
        self._cancel_task: asyncio.Task | None = None
        self._inflight: set[asyncio.Task] = set()
        # rid -> (task, lease token) for in-flight cancellation
        self._handling: dict[str, tuple] = {}
        # cancels that arrived before their item was dequeued (bounded)
        self._cancelled: "OrderedDict[str, None]" = OrderedDict()
        self.completed = 0
        self.failed = 0
        self.cancelled = 0
        self.expired = 0   # items dropped at dequeue: client deadline passed
        # recent transfers: rid -> {pages, bytes, ms}
        self.transfers: OrderedDict = OrderedDict()

    async def start(self) -> "PrefillWorker":
        await self.worker.start()
        # subscribe before consuming: a cancel racing the first dequeue
        # cannot be missed
        sub = await self.messaging.subscribe(cancel_subject(self.queue.name))
        self._cancel_task = asyncio.create_task(self._cancel_loop(sub))
        self._loop_task = asyncio.create_task(self._consume())
        return self

    async def stop(self) -> None:
        for attr in ("_loop_task", "_cancel_task"):
            task = getattr(self, attr)
            if task:
                task.cancel()
                try:
                    await task
                except asyncio.CancelledError:
                    pass
                setattr(self, attr, None)
        for t in list(self._inflight):
            t.cancel()
        await self.worker.stop()

    async def drain(self, timeout_s: float = 30.0,
                    poll_s: float = 0.05) -> dict:
        """Planned shutdown: stop consuming (queued work stays durable for
        the other consumers), give in-flight items up to timeout_s to
        finish and ack, then stop. Items unacked at the deadline are
        cancelled without an ack: their leases redeliver them."""
        DRAIN_STATS.drains_started += 1
        if self._loop_task:
            self._loop_task.cancel()
            try:
                await self._loop_task
            except asyncio.CancelledError:
                pass
            self._loop_task = None
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout_s
        while self._inflight and loop.time() < deadline:
            await asyncio.sleep(poll_s)
        releasing = len(self._inflight)
        if releasing:
            log.warning("prefill drain: %d item(s) past the deadline; "
                        "leases will redeliver them", releasing)
        DRAIN_STATS.cancelled_streams += releasing
        await self.stop()
        DRAIN_STATS.drains_completed += 1
        return {"re_leased": releasing}

    def _note_cancelled(self, rid: str) -> None:
        _bounded_put(self._cancelled, rid, None)

    async def _cancel_loop(self, sub) -> None:
        async for _subject, payload in sub:
            try:
                cancel = PrefillCancel.from_bytes(payload)
            except Exception:  # dynalint: swallow-ok=malformed-peer-frame-logged
                log.exception("malformed prefill cancel: %r", payload[:200])
                continue
            rid = cancel.request_id
            entry = self._handling.get(rid)
            if entry is None:
                self._note_cancelled(rid)
                continue
            task, token = entry
            self.cancelled += 1
            log.info("prefill %s cancelled mid-run (client gone)", rid)
            # settle the lease first: a dropped item is never redelivered
            await self.queue.ack(token)
            task.cancel()
            await self.worker.submit(lambda eng, rid=rid: eng.abort(rid))

    async def _consume(self) -> None:
        while True:
            await self._slots.acquire()  # before dequeue: backpressure
            try:                         # stays visible in the queue depth
                got = await self.queue.dequeue_leased(
                    timeout=self.dequeue_timeout_s, lease_s=self.lease_s)
            except asyncio.CancelledError:
                self._slots.release()
                raise
            except Exception:  # noqa: BLE001 (retried)
                self._slots.release()
                log.exception("prefill dequeue failed; retrying")
                await asyncio.sleep(0.5)
                continue
            if got is None:
                self._slots.release()
                continue
            req, token = got
            if req.request_id in self._cancelled:
                # the client went away before the prefill started
                self._cancelled.pop(req.request_id, None)
                self.cancelled += 1
                await self.queue.ack(token)
                self._slots.release()
                continue
            if req.deadline_unix is not None \
                    and time.time() >= req.deadline_unix:
                # the deadline passed in the queue: settle the lease and
                # tell the decode side now
                self.expired += 1
                log.info("prefill %s expired in queue; dropped at dequeue",
                         req.request_id)
                await self.queue.ack(token)
                await self._notify(req, PrefillCompletion(
                    request_id=req.request_id,
                    error="deadline exceeded before prefill started"))
                self._slots.release()
                continue
            # handled concurrently: the engine batches the prefills
            task = asyncio.create_task(self._handle(req, token))
            self._inflight.add(task)
            self._handling[req.request_id] = (task, token)

            def done(t, task=task, rid=req.request_id):
                self._inflight.discard(task)
                if self._handling.get(rid, (None,))[0] is task:
                    self._handling.pop(rid, None)
                self._slots.release()

            task.add_done_callback(done)

    async def _touch_for_pool_claim(self, req: RemotePrefillRequest,
                                    token: str) -> bool:
        """Re-arm the lease before a long pool claim: when the attached pool
        holds a multi-page prefix of this prompt, the engine's claim ladder
        (page-by-page verified fetches, each possibly failing over across
        replicas) may outlast `lease_s`; a touch here keeps the queue from
        redelivering the item mid-fetch. A one-page (or no) match keeps the
        normal lease. True when the lease was re-armed (False: no pool, a
        short match, or the lease already expired, in which case whichever
        sender finishes first wins: chunk commits are idempotent)."""
        try:
            eng = self.worker.engine
            pool = getattr(eng, "kv_pool", None)
            if pool is None:
                return False
            from dynamo_tpu_torch.engine.kv_pool import matched_pool_pages
            matched = matched_pool_pages(pool, req.token_ids,
                                         eng.cfg.page_size)
        except Exception:  # noqa: BLE001 — the re-arm is best effort; the
            return False   # lease covers the default case
        if matched < 2:
            return False
        return await self.queue.touch(token, self.lease_s)

    async def _handle(self, req: RemotePrefillRequest, token: str) -> None:
        rid = req.request_id
        # the decode side's prefill.remote context, across the queue hop
        trace = TraceContext.from_wire(req.trace)
        if req.enqueued_unix is not None:
            # the leased-queue wait, from the wall-clock enqueue instant
            TRACER.record_span(
                "queue.wait", trace,
                max(0.0, time.time() - req.enqueued_unix), request_id=rid)
        try:
            eng_ps = self.worker.engine.cfg.page_size
            if req.page_size != eng_ps:
                raise ValueError(f"page size mismatch: decode "
                                 f"{req.page_size} != prefill {eng_ps}")
            await self._touch_for_pool_claim(req, token)
            with TRACER.span("prefill.run", trace, request_id=rid,
                             tokens=len(req.token_ids)):
                q: asyncio.Queue = asyncio.Queue()
                self.worker._queues[rid] = q
                try:
                    er = to_engine_request(PreprocessedRequest(
                        request_id=rid, token_ids=req.token_ids,
                        sampling=req.sampling, stop=req.stop,
                        mm_parts=req.mm_parts), qos=req.qos)
                    er.prefill_only = True
                    self.worker._pending_adds.append(er)
                    self.worker._wake.set()
                    frame: EngineOutput = await q.get()
                finally:
                    self.worker._queues.pop(rid, None)
            if frame.finish_reason != FinishReason.PREFILL_DONE:
                raise RuntimeError(
                    f"prefill ended with {frame.finish_reason}: {frame.text}")
            first_token = frame.token_ids[0]
            # ship only the pages the decode side does not have
            start_page = req.num_cached_tokens // eng_ps
            if self.early_notify:
                await self._notify(req, PrefillCompletion(
                    request_id=rid, first_token=first_token,
                    transfer_pending=True,
                    total_pages=len(req.page_ids) - start_page))

            def extract(eng):
                seq = eng.scheduler.parked[rid]
                return eng.extract_pages(seq.pages[start_page:])
            pages = await self.worker.submit(extract)
            # the transfer may outlast the dequeue lease: re-arm it (an
            # expired lease means a duplicate sender; the decode side's
            # idempotent commits absorb it)
            await self.queue.touch(token, self.lease_s)
            budget_s = None
            if req.deadline_unix is not None:
                budget_s = req.deadline_unix - time.time()
                if budget_s <= 0:
                    raise RuntimeError(
                        "deadline exceeded before transfer started")
            dst = req.page_ids[start_page:]
            t0 = time.monotonic()
            await self.transfer.send_pages(
                req.engine_id, rid, dst, pages["k"], pages["v"],
                k_scale=pages.get("k_scale"), v_scale=pages.get("v_scale"),
                trace=trace, alloc_epoch=req.alloc_epoch, budget_s=budget_s,
                ready=pages.get("ready"))
            nb = pages["k"].shape[2]
            page_bytes = sum(t.numel() * t.element_size()
                             for key, t in pages.items()
                             if key != "ready" and t is not None) // nb
            _bounded_put(self.transfers, rid, {
                "pages": len(dst), "bytes": page_bytes * len(dst),
                "ms": (time.monotonic() - t0) * 1e3})
            del pages
            await self.worker.submit(lambda eng: eng.release_parked(rid))
            self.completed += 1
            await self._notify(req, PrefillCompletion(
                request_id=rid, first_token=first_token))
            await self.queue.ack(token)
        except asyncio.CancelledError:
            # worker death (stop / cancel): no ack, the lease redelivers
            raise
        except Exception as e:  # noqa: BLE001 (the decode side falls back)
            log.exception("remote prefill %s failed", rid)
            self.failed += 1
            await self.worker.submit(lambda eng: eng.abort(rid))
            await self._notify(req, PrefillCompletion(
                request_id=rid, error=str(e)))
            # a clean failure: the decode side was told and prefills
            # locally, so a redelivery would run the request twice
            await self.queue.ack(token)

    async def _notify(self, req: RemotePrefillRequest,
                      done: PrefillCompletion) -> None:
        try:
            await self.messaging.publish(req.notify_subject, done.to_bytes())
        except Exception:  # dynalint: swallow-ok=decode-timeout-covers-lost-notify
            log.exception("completion notify failed for %s", req.request_id)

    def stats_handler(self) -> dict:
        """The prefill worker's counters beside its engine's $STATS."""
        stats = self.worker.stats_handler()
        stats["prefill"] = {
            "completed": self.completed, "failed": self.failed,
            "cancelled": self.cancelled, "expired": self.expired,
            "transfers": dict(self.transfers),
            "integrity": INTEGRITY.snapshot(),
            "kv_transfer": XFER_STATS.snapshot(),
            "peak_bytes": _peak_bytes(self.worker.engine)}
        return stats
