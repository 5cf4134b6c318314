"""The port's chunk-committed transfer plane (dynamo_tpu_torch/disagg/
remote_transfer.py) over loopback TCP: tests/test_remote_transfer.py's
scenarios held to the aggregated port engine, and its frames to the JAX
sender's.

On the `tiny` config in float32 (the JAX weights carried over by
`params_from_jax`), on the CPU, with the in-memory control plane for the
queue and discovery and real sockets for the pages:
- end to end equal to the aggregated engine; int8 pages about halve the
  wire bytes; one frame per page;
- an inject after the decode side released the request is refused, and
  the pooled connection stays usable; a stale allocation epoch is fenced;
- a cut link (the test closes the socket at a chosen chunk) resumes from
  the committed frontier, token-identical; a sender that dies mid-stream is
  replaced by the re-leased item's sender, which ships only the unacked
  tail; an unrecoverable sender leaves the committed prefix to salvage; a
  decode worker restarted on a new port is resolved again; the deadline
  budget is enforced; a corrupted byte is caught and the chunk re-staged;
- a frame that carries only the JAX sender's xxh3-64 sums is refused, and
  a port frame equals the JAX sender's frame for the same pages (f32, bf16,
  int8 + scales) apart from the checksum key;
- one 16-page llama3-8b chunk packs and unpacks without copying its
  payload;
- two processes (the port's SDK serving config.cpu.json) give the
  aggregated engine's greedy tokens.

Tolerance: token identity; frames compared byte for byte.
"""
import asyncio
import json
import os
import pathlib
import signal
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from dynamo_tpu.disagg.remote_transfer import (
    RemoteTransferBackend as JRemoteTransfer,
    transfer_key as j_transfer_key,
)
from dynamo_tpu.engine.config import (
    EngineConfig as JEngineConfig, ModelConfig as JModelConfig,
)
from dynamo_tpu.engine.engine import NativeEngine as JNativeEngine
from dynamo_tpu.runtime.transports.memory import MemoryPlane as JPlane
from dynamo_tpu_torch.disagg.queue import PrefillQueue
from dynamo_tpu_torch.disagg.remote_transfer import (
    KvTransferServer, RemoteTransferBackend, TransferBudgetExceeded,
    transfer_key,
)
from dynamo_tpu_torch.disagg.router import DisaggregatedRouter
from dynamo_tpu_torch.disagg.worker import DisaggDecodeWorker, PrefillWorker
from dynamo_tpu_torch.engine.config import (
    EngineConfig as TEngineConfig, ModelConfig as TModelConfig,
)
from dynamo_tpu_torch.engine.engine import NativeEngine as TNativeEngine
from dynamo_tpu_torch.engine.scheduler import (
    EngineRequest as TRequest, SamplingParams as TSamplingParams,
)
from dynamo_tpu_torch.llm.worker import NativeEngineWorker
from dynamo_tpu_torch.models.llama import params_from_jax
from dynamo_tpu_torch.ops.kv_quant import page_bytes
from dynamo_tpu_torch.protocols.common import (
    PreprocessedRequest, StopConditions,
)
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.integrity import (
    STATS as INTEGRITY, SUMS_KEY, XFER_STATS, page_checksum,
)
from dynamo_tpu_torch.runtime.transports.codec import pack_parts, unpackb
from dynamo_tpu_torch.runtime.transports.memory import MemoryPlane
from dynamo_tpu_torch.runtime.transports.wire import read_frame, write_frame

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
JCFG = JModelConfig(dtype="float32", max_model_len=512, decode_kernel="off")
TCFG = TModelConfig(dtype="float32", max_model_len=512)
PAGE = 8
ENGINE_KW = dict(page_size=PAGE, num_pages=64, max_slots=4,
                 max_prefill_chunk=32, prefill_buckets=(8, 16, 32),
                 max_model_len=512)
PROMPT = list(range(100, 120))      # 3 pages
LONG = list(range(50, 90))          # 5 pages
GREEDY = dict(max_tokens=6, temperature=0.0, ignore_eos=True)


@pytest.fixture(scope="module")
def port_params():
    eng = JNativeEngine(JCFG, JEngineConfig(**ENGINE_KW), seed=0)
    return params_from_jax(jax.device_get(eng.params), TCFG, "cpu")


def make_engine(port_params, kv_quant=""):
    return TNativeEngine(TCFG, TEngineConfig(**ENGINE_KW, kv_quant=kv_quant),
                         params=port_params, device="cpu")


_EXPECT = {}


def expected(port_params, prompt, kv_quant=""):
    key = (tuple(prompt), kv_quant)
    if key not in _EXPECT:
        _EXPECT[key] = make_engine(port_params, kv_quant).generate(
            prompt, TSamplingParams(**GREEDY), f"o{len(_EXPECT)}")
    return _EXPECT[key]


def pre(rid, prompt):
    return PreprocessedRequest(request_id=rid, token_ids=list(prompt),
                               stop=StopConditions(max_tokens=6,
                                                   ignore_eos=True))


async def drive(gen):
    toks, reason = [], None
    async for f in gen:
        toks.extend(f.token_ids)
        if f.finish_reason is not None:
            reason = f.finish_reason.value
    return toks, reason


async def remote_stack(plane, port_params, chunk_pages=16, kv_quant="",
                       transfer=None, prefill_timeout_s=30.0, **prefill_kw):
    """The disagg workers wired through the remote transfer over TCP."""
    queue = PrefillQueue(plane.messaging, "ns", "tiny")
    router = DisaggregatedRouter(max_local_prefill_length=4,
                                 max_prefill_queue_size=8, model="tiny")
    decode = DisaggDecodeWorker(
        make_engine(port_params, kv_quant), plane.messaging, router, queue,
        worker_id="dec-0", prefill_timeout_s=prefill_timeout_s)
    server = await KvTransferServer(decode, "dec-0").start()
    await server.register(plane.kv)
    transfer = transfer or RemoteTransferBackend(plane.kv,
                                                 chunk_pages=chunk_pages)
    prefill = PrefillWorker(
        NativeEngineWorker(make_engine(port_params, kv_quant)), queue,
        transfer, plane.messaging, **prefill_kw)
    return decode, prefill, server, transfer


async def run_one(port_params, rid, prompt, setup=None, **kw):
    plane = MemoryPlane()
    decode, prefill, server, transfer = await remote_stack(
        plane, port_params, **kw)
    if setup is not None:
        setup(transfer)
    await decode.start()
    await prefill.start()
    try:
        out = await asyncio.wait_for(drive(decode.generate(
            pre(rid, prompt), Context(rid))), 60)
    finally:
        await prefill.stop()
        await decode.stop()
        await transfer.close()
        await server.stop()
    return out, decode, prefill, server, transfer


def prefilled_pages(port_params, rid, prompt, kv_quant=""):
    """A prefill-only run on its own engine; its extracted pages."""
    eng = make_engine(port_params, kv_quant)
    r = TRequest(rid, list(prompt), TSamplingParams(**GREEDY))
    r.prefill_only = True
    eng.add_request(r)
    while eng.has_work():
        eng.step()
    return eng.extract_pages(eng.scheduler.parked[rid].pages)


# -- end to end ----------------------------------------------------------------

def test_remote_transfer_e2e_matches_aggregated(port_params):
    (toks, reason), decode, prefill, server, transfer = asyncio.run(
        run_one(port_params, "r1", PROMPT))
    assert (toks, reason) == (expected(port_params, PROMPT), "length")
    assert decode.remote_prefills == prefill.completed == 1
    assert server.received_pages == transfer.sent_pages == 3
    # early decode: the first token went out before the transfer landed
    assert decode.early_first_emits == 1
    assert decode.engine.scheduler.overlap_activations == 1
    st = decode.stats_handler()["disagg"]
    assert st["received_pages"] == 3
    assert st["salvaged_prefills"] == st["full_reprefills"] == 0
    assert prefill.stats_handler()["prefill"]["transfers"]["r1"][
        "pages"] == 3


def test_remote_transfer_int8_halves_wire_bytes(port_params):
    b0, p0 = XFER_STATS.bytes_sent, XFER_STATS.pages_sent
    (toks, reason), _, _, server, transfer = asyncio.run(
        run_one(port_params, "rq", PROMPT, kv_quant="int8"))
    bytes_sent = XFER_STATS.bytes_sent - b0
    assert (toks, reason) == (expected(port_params, PROMPT, "int8"),
                              "length")
    assert server.received_pages == transfer.sent_pages == 3
    assert XFER_STATS.pages_sent - p0 == 3
    f32_pb = page_bytes(TCFG.num_layers, TCFG.num_kv_heads, PAGE,
                        TCFG.head_dim, 4, False)
    int8_pb = page_bytes(TCFG.num_layers, TCFG.num_kv_heads, PAGE,
                         TCFG.head_dim, 4, True)
    # 3 pages in a pow2 frame of 4: int8 values + f32 scales
    assert bytes_sent == 4 * int8_pb
    assert f32_pb / int8_pb >= 1.8


def test_remote_transfer_one_frame_per_page(port_params):
    f0 = XFER_STATS.fetches
    (toks, _), _, _, server, _ = asyncio.run(
        run_one(port_params, "t1", LONG, chunk_pages=1))
    assert toks == expected(port_params, LONG)
    assert server.received_pages == 5 and XFER_STATS.fetches - f0 == 5


# -- refusals ------------------------------------------------------------------

async def _bare_decode(port_params, plane):
    decode = NativeEngineWorker(make_engine(port_params))
    await decode.start()
    server = await KvTransferServer(decode, "dec-0").start()
    await server.register(plane.kv)
    return decode, server


def test_remote_inject_rejected_after_release(port_params):
    pages = prefilled_pages(port_params, "race", PROMPT)

    async def main():
        plane = MemoryPlane()
        decode, server = await _bare_decode(port_params, plane)
        # one-page chunks + a 3-deep window: the rejection arrives while
        # acks are unread, which must not poison the pooled connection
        transfer = RemoteTransferBackend(plane.kv, chunk_pages=1,
                                         window_chunks=3)
        try:
            alloc = await decode.submit(lambda eng: eng.allocate_remote(
                TRequest("race", PROMPT, TSamplingParams(**GREEDY))))
            await decode.submit(lambda eng: eng.release_remote("race"))
            with pytest.raises(RuntimeError, match="no longer pending"):
                await transfer.send_pages("dec-0", "race", alloc.page_ids,
                                          pages["k"], pages["v"])
            alloc2 = await decode.submit(lambda eng: eng.allocate_remote(
                TRequest("ok", PROMPT, TSamplingParams(**GREEDY))))
            await transfer.send_pages("dec-0", "ok", alloc2.page_ids,
                                      pages["k"], pages["v"])
            assert transfer.sent_pages == 3
        finally:
            await transfer.close()
            await server.stop()
            await decode.stop()
        return server.received_pages

    assert asyncio.run(main()) == 3


def test_stale_epoch_chunk_fenced(port_params):
    pages = prefilled_pages(port_params, "race", PROMPT)

    async def main():
        plane = MemoryPlane()
        decode, server = await _bare_decode(port_params, plane)
        transfer = RemoteTransferBackend(plane.kv, chunk_pages=1)
        s0 = XFER_STATS.stale_chunks
        try:
            req = TRequest("race", PROMPT, TSamplingParams(**GREEDY))
            alloc1 = await decode.submit(lambda e: e.allocate_remote(req))
            await decode.submit(lambda e: e.release_remote("race"))
            alloc2 = await decode.submit(lambda e: e.allocate_remote(req))
            assert alloc2.alloc_epoch > alloc1.alloc_epoch > 0
            with pytest.raises(RuntimeError, match="StaleEpochError"):
                await transfer.send_pages(
                    "dec-0", "race", alloc1.page_ids, pages["k"],
                    pages["v"], alloc_epoch=alloc1.alloc_epoch)
            assert XFER_STATS.stale_chunks - s0 >= 1
            assert server.received_pages == 0
            await transfer.send_pages(
                "dec-0", "race", alloc2.page_ids, pages["k"], pages["v"],
                alloc_epoch=alloc2.alloc_epoch)
            assert server.received_pages == 3
        finally:
            await transfer.close()
            await server.stop()
            await decode.stop()

    asyncio.run(main())


def test_transfer_budget_exhausted_fails_fast(port_params):
    pages = prefilled_pages(port_params, "rb", PROMPT)

    async def main():
        plane = MemoryPlane()
        decode, server = await _bare_decode(port_params, plane)
        transfer = RemoteTransferBackend(plane.kv, chunk_pages=1)
        try:
            alloc = await decode.submit(lambda e: e.allocate_remote(
                TRequest("rb", PROMPT, TSamplingParams(**GREEDY))))
            with pytest.raises(TransferBudgetExceeded):
                await asyncio.wait_for(transfer.send_pages(
                    "dec-0", "rb", alloc.page_ids, pages["k"], pages["v"],
                    budget_s=0.0), 10)
            assert server.received_pages == 0
        finally:
            await transfer.close()
            await server.stop()
            await decode.stop()

    asyncio.run(main())


# -- the resume matrix ----------------------------------------------------------

class CutLink(RemoteTransferBackend):
    """Closes its pooled socket before staging chunk `cut_at` (`times`
    times): the next write finds the connection gone."""

    def __init__(self, kv, cut_at, times=1, **kw):
        super().__init__(kv, **kw)
        self.cut_at, self.times, self.cuts = cut_at, times, 0

    async def _chunk_gate(self, chunk_idx):
        if chunk_idx >= self.cut_at and self.cuts < self.times:
            self.cuts += 1
            for _reader, writer in list(self._conns.values()):
                writer.close()
            await asyncio.sleep(0.05)


@pytest.mark.parametrize("cut_chunk", [0, 1, 2])
def test_link_cut_resumes_token_identical(port_params, cut_chunk):
    r0 = XFER_STATS.resumes

    def setup(transfer):
        transfer.window_chunks = 1   # everything before the cut is acked

    async def main():
        plane = MemoryPlane()
        tx = CutLink(plane.kv, cut_chunk, chunk_pages=1)
        setup(tx)
        decode, prefill, server, _ = await remote_stack(
            plane, port_params, transfer=tx)
        await decode.start()
        await prefill.start()
        try:
            out = await asyncio.wait_for(drive(decode.generate(
                pre("rl", PROMPT), Context("rl"))), 60)
        finally:
            await prefill.stop()
            await decode.stop()
            await tx.close()
            await server.stop()
        return out, server.received_pages, tx.sent_pages, tx.cuts

    (toks, reason), rx, sent, cuts = asyncio.run(main())
    assert (toks, reason) == (expected(port_params, PROMPT), "length")
    assert rx == sent == 3 and cuts == 1   # each page injected once
    if cut_chunk > 0:
        assert XFER_STATS.resumes - r0 == 1


def test_sender_death_resumes_from_acked_frontier(port_params):
    """The prefill worker dies with 2 of 5 chunks acked: the re-leased
    item's replacement sender opens with the handshake and ships only the
    3-page tail."""
    r0 = XFER_STATS.resumes

    class StallAfter(RemoteTransferBackend):
        async def _chunk_gate(self, chunk_idx):
            if chunk_idx >= 2:
                await asyncio.Event().wait()

    async def main():
        plane = MemoryPlane()
        decode, doomed, server, _ = await remote_stack(
            plane, port_params,
            transfer=StallAfter(plane.kv, chunk_pages=1, window_chunks=1),
            prefill_timeout_s=60.0, dequeue_timeout_s=0.1, lease_s=0.5)
        surv_tx = RemoteTransferBackend(plane.kv, chunk_pages=1,
                                        window_chunks=1)
        survivor = PrefillWorker(
            NativeEngineWorker(make_engine(port_params)), doomed.queue,
            surv_tx, plane.messaging, dequeue_timeout_s=0.1, lease_s=10.0)
        await decode.start()
        await doomed.start()
        task = asyncio.create_task(drive(decode.generate(
            pre("rd", LONG), Context("rd"))))
        deadline = time.monotonic() + 30
        while not any(s.committed_pages >= 2
                      for s in server._sessions.values()):
            assert time.monotonic() < deadline, "no chunk committed"
            await asyncio.sleep(0.02)
        await doomed.stop()
        await survivor.start()
        out = await asyncio.wait_for(task, 120)
        redelivered = plane.messaging.redeliveries
        await survivor.stop()
        await decode.stop()
        await server.stop()
        await surv_tx.close()
        return out, redelivered, surv_tx.sent_pages

    (toks, reason), redelivered, sent = asyncio.run(main())
    assert (toks, reason) == (expected(port_params, LONG), "length")
    assert redelivered >= 1 and sent == 3
    assert XFER_STATS.resumes - r0 >= 1


def test_unrecoverable_sender_salvages_committed_prefix(port_params):
    """The link dies for good after 3 of 5 chunks committed: the decode
    worker keeps those pages and prefills only the rest locally (the first
    token was already emitted early), token-identical."""
    s0 = XFER_STATS.salvaged_pages

    async def main():
        plane = MemoryPlane()
        tx = CutLink(plane.kv, 3, times=1000, chunk_pages=1,
                     window_chunks=1, link_retries=1)
        decode, prefill, server, _ = await remote_stack(
            plane, port_params, transfer=tx)
        await decode.start()
        await prefill.start()
        try:
            out = await asyncio.wait_for(drive(decode.generate(
                pre("rs", LONG), Context("rs"))), 120)
        finally:
            await prefill.stop()
            await decode.stop()
            await tx.close()
            await server.stop()
        return out, decode.stats_handler()["disagg"]

    (toks, reason), st = asyncio.run(main())
    assert (toks, reason) == (expected(port_params, LONG), "length")
    assert (st["salvaged_prefills"], st["full_reprefills"],
            st["overlap_fallbacks"],
            st["majority_committed_full_reprefills"]) == (1, 0, 1, 0)
    assert XFER_STATS.salvaged_pages - s0 == 3


def test_decode_restart_on_new_port_reresolves(port_params):
    prompt2 = list(range(130, 150))

    async def main():
        plane = MemoryPlane()
        decode, prefill, server, transfer = await remote_stack(
            plane, port_params)
        await decode.start()
        await prefill.start()
        server2 = None
        try:
            out1 = await asyncio.wait_for(drive(decode.generate(
                pre("r1", PROMPT), Context("r1"))), 60)
            old_port = server.port
            await server.stop()
            server2 = await KvTransferServer(decode, "dec-0").start()
            await server2.register(plane.kv)
            assert server2.port != old_port
            out2 = await asyncio.wait_for(drive(decode.generate(
                pre("r2", prompt2), Context("r2"))), 60)
            return (out1, out2, server2.received_pages,
                    transfer._meta["dec-0"]["port"], server2.port)
        finally:
            await prefill.stop()
            await decode.stop()
            await transfer.close()
            if server2 is not None:
                await server2.stop()

    out1, out2, rx2, cached, new = asyncio.run(main())
    assert out1[0] == expected(port_params, PROMPT)
    assert out2[0] == expected(port_params, prompt2)
    assert rx2 == 3 and cached == new


def test_corrupted_byte_caught_and_restaged(port_params):
    """A byte flipped after the capture checksum (a bad wire) is caught
    before the inject; the sender stages the chunk again and the stream is
    token-identical."""
    class FlipOnce(RemoteTransferBackend):
        flipped = 0

        @staticmethod
        def _flip(staged):
            k_np = staged[0]
            k_np.reshape(-1).view(np.uint8)[7] ^= 0xFF
            return staged

        def _stage_chunk(self, *a, **k):
            staged = super()._stage_chunk(*a, **k)
            if not FlipOnce.flipped:
                FlipOnce.flipped = 1
                return self._flip(staged)
            return staged

    m0, f0 = INTEGRITY.mismatches, INTEGRITY.refetches

    async def main():
        plane = MemoryPlane()
        tx = FlipOnce(plane.kv, chunk_pages=1)
        decode, prefill, server, _ = await remote_stack(
            plane, port_params, transfer=tx)
        await decode.start()
        await prefill.start()
        try:
            return await asyncio.wait_for(drive(decode.generate(
                pre("rc", PROMPT), Context("rc"))), 60), \
                server.received_pages
        finally:
            await prefill.stop()
            await decode.stop()
            await tx.close()
            await server.stop()

    (toks, reason), rx = asyncio.run(main())
    assert (toks, reason) == (expected(port_params, PROMPT), "length")
    assert rx == 3
    assert INTEGRITY.mismatches - m0 == 1 and INTEGRITY.refetches - f0 == 1


def test_jax_key_only_frame_refused(port_params):
    """The JAX sender (xxh3-64 sums under "sums") against the port's
    receiver: refused as unverifiable, nothing injected."""
    pages = prefilled_pages(port_params, "jx", PROMPT)

    async def main():
        plane = MemoryPlane()
        decode, server = await _bare_decode(port_params, plane)
        jplane = JPlane()
        await jplane.kv.put(j_transfer_key("dec-0"), msgpack.packb(
            server.connection_info, use_bin_type=True))
        jtx = JRemoteTransfer(jplane.kv, chunk_pages=16)
        try:
            alloc = await decode.submit(lambda e: e.allocate_remote(
                TRequest("jx", PROMPT, TSamplingParams(**GREEDY))))
            with pytest.raises(RuntimeError,
                               match="IntegrityRejected.*xxh3-64"):
                await jtx.send_pages("dec-0", "jx", alloc.page_ids,
                                     pages["k"].numpy(), pages["v"].numpy())
            return server.received_pages
        finally:
            await jtx.close()
            await server.stop()
            await decode.stop()

    assert asyncio.run(main()) == 0


async def _captured_frames(send):
    """Frames a sender writes to a fake endpoint that acks everything."""
    frames = []

    async def on_connect(reader, writer):
        try:
            while True:
                try:
                    frame = await read_frame(reader)
                except (asyncio.IncompleteReadError, ConnectionResetError):
                    return
                if frame.get("op") == "resume":
                    write_frame(writer, {"ok": True, "committed": 0})
                else:
                    frames.append(frame)
                    write_frame(writer, {"ok": True})
                await writer.drain()
        finally:
            writer.close()

    server = await asyncio.start_server(on_connect, "127.0.0.1", 0)
    info = {"host": "127.0.0.1",
            "port": server.sockets[0].getsockname()[1]}
    try:
        await send(info)
    finally:
        server.close()
        await server.wait_closed()
    return frames


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_port_frame_equals_jax_frame(kind):
    """The same pages through the JAX sender and the port's: the frames are
    equal apart from the checksum key, chunking and pow2 padding included,
    and the port's sums are BLAKE2b-64 over each page as stored."""
    rng = np.random.default_rng(5)
    shape = (2, 2, 6, PAGE, 16)      # 6 pages: chunks of 4 + 2
    if kind == "int8":
        vals = [rng.integers(-127, 128, shape).astype(np.int8)
                for _ in range(2)]
        scales = [rng.random(shape[:-1]).astype(np.float32)
                  for _ in range(2)]
        jarrs, tarrs = vals + scales, [torch.from_numpy(a)
                                       for a in vals + scales]
    else:
        f = [rng.standard_normal(shape).astype(np.float32)
             for _ in range(2)]
        if kind == "bfloat16":
            jarrs = [jnp.asarray(a, jnp.bfloat16) for a in f]
            tarrs = [torch.from_numpy(a).to(torch.bfloat16) for a in f]
        else:
            jarrs, tarrs = f, [torch.from_numpy(a) for a in f]
    ids = [11, 3, 7, 20, 4]          # 5 of the 6 pages ship

    async def via_jax(info):
        plane = JPlane()
        await plane.kv.put(j_transfer_key("e"),
                           msgpack.packb(info, use_bin_type=True))
        tx = JRemoteTransfer(plane.kv, chunk_pages=4)
        scales = dict(k_scale=jarrs[2], v_scale=jarrs[3]) \
            if kind == "int8" else {}
        await tx.send_pages("e", "r", ids, jarrs[0], jarrs[1],
                            alloc_epoch=9, **scales)
        await tx.close()

    async def via_port(info):
        plane = MemoryPlane()
        await plane.kv.put(transfer_key("e"), msgpack.packb(
            info, use_bin_type=True))
        tx = RemoteTransferBackend(plane.kv, chunk_pages=4)
        scales = dict(k_scale=tarrs[2], v_scale=tarrs[3]) \
            if kind == "int8" else {}
        await tx.send_pages("e", "r", ids, tarrs[0], tarrs[1],
                            alloc_epoch=9, **scales)
        await tx.close()

    jframes = asyncio.run(_captured_frames(via_jax))
    tframes = asyncio.run(_captured_frames(via_port))
    assert len(jframes) == len(tframes) == 2
    for jf, tf in zip(jframes, tframes):
        jsums, tsums = jf.pop("sums"), tf.pop(SUMS_KEY)
        assert jf == tf
        assert len(jsums) == len(tsums) == len(tf["page_ids"])
        dt = {"float32": np.float32, "bfloat16": np.int16,
              "int8": np.int8}[kind]
        k = np.frombuffer(tf["k"], dt).reshape(tf["shape"])
        v = np.frombuffer(tf["v"], dt).reshape(tf["shape"])
        extra = []
        if kind == "int8":
            extra = [np.frombuffer(tf[s], np.float32).reshape(
                tf["shape"][:-1]) for s in ("k_scale", "v_scale")]
        for i, s in enumerate(tsums):
            assert s == page_checksum(k[:, :, i], v[:, :, i],
                                      *[e[:, :, i] for e in extra])
    assert [f["shape"][2] for f in tframes] == [4, 1]
    assert tframes[1]["page_ids"] == [4]


def test_chunk_codec_passes_payloads_through():
    """One 16-page llama3-8b chunk (bf16: 2 x 64 MiB) packs without a copy
    of its payloads (they are the parts themselves) and unpacks into views
    of the body. Measured on a shared CPU: pack ~0.1 ms, unpack ~0.2 ms;
    the bound leaves room for a loaded machine, far below the ~50 ms one
    copy of 128 MiB would take."""
    k = np.zeros((32, 8, 16, 64, 128), np.int16)
    v = np.ones_like(k)
    frame = {"request_id": "r", "alloc_epoch": 1, "chunk_idx": 0,
             "base": 0, "total": 47, "page_ids": list(range(16)),
             "shape": list(k.shape), "dtype": "bfloat16",
             "k": k.data, "v": v.data, SUMS_KEY: list(range(16))}
    t0 = time.perf_counter()
    parts = pack_parts(frame)
    pack_s = time.perf_counter() - t0
    assert any(p is not None and isinstance(p, memoryview)
               and p.obj is k for p in parts)
    body = b"".join(parts)
    t0 = time.perf_counter()
    got = unpackb(body, zero_copy=True)
    unpack_s = time.perf_counter() - t0
    assert isinstance(got["k"], memoryview) and got["k"].obj is body
    assert got["k"].nbytes == k.nbytes == 64 * 2 ** 20
    assert np.array_equal(np.frombuffer(got["v"], np.int16), v.reshape(-1))
    assert pack_s < 0.02 and unpack_s < 0.02, (pack_s, unpack_s)
    assert msgpack.unpackb(body, raw=False)["shape"] == list(k.shape)


# -- two processes through the SDK -----------------------------------------------

def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_processes_sdk_exact_greedy_parity(tmp_path):
    """`python -m dynamo_tpu_torch.sdk.serve ...graph:Frontend -f
    config.cpu.json`: the decode and prefill workers in their own processes,
    the pages crossing between them over the transfer plane; greedy
    streams through the decode worker's endpoint equal an aggregated engine
    built in this process from the same config and seed; SIGTERM drains
    every service and the supervisor exits 0."""
    from dynamo_tpu_torch.examples.disagg.graph import _build
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

    cfg_path = REPO / "dynamo_tpu_torch/examples/disagg/config.cpu.json"
    cfg = json.loads(cfg_path.read_text())
    cfg["Frontend"]["port"] = _free_port()
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, 250, n).tolist() for n in (20, 130)]
    _, agg = _build(cfg["DecodeWorker"])
    expect = [agg.generate(p, TSamplingParams(max_tokens=8,
                                              ignore_eos=True), f"a{i}")
              for i, p in enumerate(prompts)]
    env = {**os.environ, "PYTHONPATH": str(REPO), "DYN_LEASE_TTL_S": "30"}
    sup = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.sdk.serve",
         "dynamo_tpu_torch.examples.disagg.graph:Frontend", "-f", str(path),
         "--start-control-plane", "--control-port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=REPO,
        env=env, text=True)
    lines = []
    try:
        while True:
            line = sup.stdout.readline()
            assert line, "supervisor exited early:\n" + "".join(lines)
            lines.append(line)
            if line.startswith("READY graph="):
                break
        port = int(line.rsplit("control-port=", 1)[1])

        async def drive_all():
            rt = await DistributedRuntime.connect("127.0.0.1", port)
            client = await rt.namespace("dynamo-demo").component(
                "backend").endpoint("generate").client().start()
            await client.wait_for_instances()
            outs = []
            for i, p in enumerate(prompts):
                toks = []
                stream = await client.generate(PreprocessedRequest(
                    request_id=f"two-proc-{i}", token_ids=p,
                    stop=StopConditions(max_tokens=8, ignore_eos=True)))
                async for frame in stream:
                    toks.extend(frame.get("token_ids", ()))
                outs.append(toks)
            stats = await client.scrape_stats(timeout=10.0)
            await client.stop()
            await rt.shutdown()
            return outs, stats

        outs, stats = asyncio.run(asyncio.wait_for(drive_all(), 180))
        assert outs == expect
        (st,) = stats.values()
        assert st["disagg"]["remote_prefills"] == 2
        assert st["disagg"]["received_pages"] == \
            sum(-(-len(p) // 64) for p in prompts)
        sup.send_signal(signal.SIGTERM)
        rest = sup.communicate(timeout=120)[0]
        assert sup.returncode == 0, rest
        for svc in ("Frontend/0", "DecodeWorker/0", "PrefillWorker/0",
                    "control-plane"):
            assert f"EXIT service={svc} code=0" in rest, rest
    finally:
        if sup.poll() is None:
            sup.kill()
            sup.wait(30)
