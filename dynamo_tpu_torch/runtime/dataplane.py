"""Response-plane transport: direct call-home streams (TCP, or UDS same-host).

Like the reference, responses never transit the message broker: the requester
registers a pending stream on its local server and sends its address with
the request; the responder dials back ("call home"), sends a prologue
(ok/error), then pumps response frames (reference:
lib/runtime/src/pipeline/network/tcp/server.rs:74-380, tcp/client.rs:77-130,
egress/push.rs:104-166). The connection is bidirectional: the requester can
send a {"stop": true} control frame to cancel generation mid-stream, and a
dropped connection stops the responder's engine (the reference's
monitor_for_disconnects / context kill path).

Alternative same-host plane (the reference's ZMQ/IPC data-plane option,
SURVEY.md §2.1): alongside TCP the server also listens on a unix-domain
socket and advertises its path; a responder on the SAME machine (the path
exists locally) dials the UDS instead — kernel-local streams with no TCP
stack in the hot loop — and falls back to TCP on any UDS failure.

Copied from dynamo_tpu/runtime/dataplane.py. The unix socket's path is made
per process and per server (pid + a random suffix, :94-95), so servers in
parallel test workers never collide. The responder's control-frame watcher
is held on the writer until the stream ends (the loop keeps tasks weakly).
The `DYN_DATAPLANE=tcp` switch (the UDS listener off) and the UDS accept
counter are left out: the port always offers both and prefers the socket.
"""
from __future__ import annotations

import asyncio
import logging
import os
import tempfile
import uuid
from typing import AsyncIterator, Dict, Optional, Tuple

from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.transports.wire import read_frame, write_frame

log = logging.getLogger("dynamo_tpu_torch.dataplane")

_END = object()

# Responder emits a keepalive frame whenever the engine takes longer than
# this between output items; the requester's inactivity timeout (below) only
# fires after several missed keepalives, i.e. when the peer is actually gone
# — not merely slow (a giant prefill before the first token is legitimate).
KEEPALIVE_INTERVAL_S = 15.0
INACTIVITY_TIMEOUT_S = 60.0
# call-home dial bound: a requester that vanished between dispatch and
# dial-back must cost seconds, not the OS connect timeout's minutes
CONNECT_TIMEOUT_S = 10.0


class StreamInactiveError(RuntimeError):
    """Typed dead-stream signal: no frames (not even keepalives) arrived
    within the inactivity window — the responder process is gone or wedged,
    as opposed to backpressured/slow."""


class PendingStream:
    def __init__(self, stream_id: str):
        self.stream_id = stream_id
        self.queue: asyncio.Queue = asyncio.Queue()
        self.writer: Optional[asyncio.StreamWriter] = None
        self.connected = asyncio.Event()


class DataPlaneServer:
    """Per-process TCP server accepting call-home response connections."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 advertise_host: Optional[str] = None):
        self.host, self.port = host, port
        self.advertise_host = advertise_host or host
        self._pending: Dict[str, PendingStream] = {}
        self._server = None
        # same-host UDS listener, advertised alongside TCP
        self._uds_server = None
        self.uds_path: Optional[str] = None

    async def start(self):
        if self._server is None:
            self._server = await asyncio.start_server(
                self._on_connect, self.host, self.port)
            self.port = self._server.sockets[0].getsockname()[1]
        if self._uds_server is None:
            path = os.path.join(
                tempfile.gettempdir(),
                f"dynamo-dp-{os.getpid()}-{uuid.uuid4().hex[:8]}.sock")
            try:
                self._uds_server = await asyncio.start_unix_server(
                    self._on_connect, path)
                self.uds_path = path
            except (OSError, NotImplementedError):  # pragma: no cover
                log.warning("UDS data plane unavailable; TCP only")
        return self

    async def stop(self):
        if self._server:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        if self._uds_server:
            self._uds_server.close()
            await self._uds_server.wait_closed()
            self._uds_server = None
        if self.uds_path:
            try:
                os.unlink(self.uds_path)
            except OSError:
                pass
            self.uds_path = None

    @property
    def connection_info(self) -> Dict[str, object]:
        info: Dict[str, object] = {"host": self.advertise_host,
                                   "port": self.port}
        if self.uds_path:
            info["uds"] = self.uds_path
        return info

    def register(self) -> PendingStream:
        stream = PendingStream(uuid.uuid4().hex)
        self._pending[stream.stream_id] = stream
        return stream

    def unregister(self, stream_id: str) -> None:
        self._pending.pop(stream_id, None)

    async def _on_connect(self, reader, writer):
        stream = None
        try:
            hello = await read_frame(reader, CONNECT_TIMEOUT_S)
            stream = self._pending.get(hello.get("stream_id", ""))
            if stream is None:
                write_frame(writer, {"ok": False, "error": "unknown stream"})
                await writer.drain()
                writer.close()
                return
            stream.writer = writer
            stream.connected.set()
            write_frame(writer, {"ok": True})
            await writer.drain()
            while True:
                frame = await read_frame(reader)
                stream.queue.put_nowait(frame)
                if frame.get("end"):
                    break
        except (asyncio.IncompleteReadError, ConnectionResetError,
                asyncio.TimeoutError):
            if stream is not None:
                stream.queue.put_nowait(
                    {"end": True, "error": "response stream lost"})
        finally:
            if stream is not None:
                self._pending.pop(stream.stream_id, None)
            writer.close()

    async def stream_responses(
            self, stream: PendingStream,
            timeout: Optional[float] = None) -> AsyncIterator[bytes]:
        """Yield response payload frames until end; raises on stream error.

        Keepalive frames reset the inactivity timer without being yielded,
        so a slow-but-alive responder (long prefill, deep queue) is never
        killed; a truly dead peer raises StreamInactiveError after
        `timeout` seconds of total silence. timeout=None reads the module
        constant at call time so deployments can tune it.
        """
        if timeout is None:
            timeout = INACTIVITY_TIMEOUT_S
        try:
            while True:
                try:
                    frame = await asyncio.wait_for(stream.queue.get(), timeout)
                except asyncio.TimeoutError:
                    raise StreamInactiveError(
                        f"no response frames for {timeout:.0f}s "
                        f"(responder dead or unreachable)") from None
                if frame.get("keepalive"):
                    continue
                if frame.get("error"):
                    raise RuntimeError(frame["error"])
                if "data" in frame and frame["data"] is not None:
                    yield frame["data"]
                if frame.get("end"):
                    return
        finally:
            self.unregister(stream.stream_id)
            if stream.writer is not None:
                stream.writer.close()

    async def send_stop(self, stream: PendingStream) -> None:
        """Cancel generation: send a stop control frame back to the responder."""
        if stream.writer is not None and not stream.writer.is_closing():
            write_frame(stream.writer, {"stop": True})
            await stream.writer.drain()


async def call_home(
    connection_info: Dict[str, object],
    stream_id: str,
    context: Context,
) -> Tuple[asyncio.StreamReader, asyncio.StreamWriter]:
    """Responder side: dial the requester and complete the handshake.

    Prefers the requester's advertised unix socket when its path exists
    on THIS machine (same-host fast path; falls back to TCP on any UDS
    failure — the path existing doesn't prove it is the same requester,
    e.g. after a host reboot reused a pid). Also spawns a reader task
    that maps incoming {"stop": true} frames and connection loss onto
    the request Context.
    """
    reader = writer = None
    uds = connection_info.get("uds")
    if uds and os.path.exists(uds):
        try:
            reader, writer = await asyncio.wait_for(
                asyncio.open_unix_connection(uds), CONNECT_TIMEOUT_S)
        except (OSError, NotImplementedError, asyncio.TimeoutError):
            reader = writer = None
    if reader is None:
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(
                connection_info["host"], int(connection_info["port"])),
            CONNECT_TIMEOUT_S)
    write_frame(writer, {"stream_id": stream_id})
    await writer.drain()
    ack = await read_frame(reader, CONNECT_TIMEOUT_S)
    if not ack.get("ok"):
        writer.close()
        raise ConnectionError(ack.get("error", "handshake rejected"))

    async def watch_control():
        try:
            while True:
                frame = await read_frame(reader)
                if frame.get("stop"):
                    context.stop_generating()
        except (asyncio.IncompleteReadError, ConnectionResetError,
                asyncio.CancelledError):
            context.stop_generating()

    task = asyncio.create_task(watch_control())
    writer._dynamo_watch_task = task  # cancelled when stream finishes
    return reader, writer


async def close_with_error(writer: asyncio.StreamWriter, message: str) -> None:
    """Responder side: report a failure and tear the stream down."""
    try:
        write_frame(writer, {"end": True, "error": message})
        await writer.drain()
    except (ConnectionResetError, BrokenPipeError):
        pass
    finally:
        task = getattr(writer, "_dynamo_watch_task", None)
        if task:
            task.cancel()
        writer.close()


async def _next_with_keepalive(writer: asyncio.StreamWriter, it):
    """Await the next engine item, emitting a keepalive frame every
    KEEPALIVE_INTERVAL_S while the engine is silent. Returns (_END, None)
    on exhaustion."""
    nxt = asyncio.ensure_future(it.__anext__())
    while True:
        try:
            return await asyncio.wait_for(
                asyncio.shield(nxt), KEEPALIVE_INTERVAL_S)
        except asyncio.CancelledError:
            # handler teardown: propagate cancellation into the engine
            # generator like the old `async for` did, instead of leaving
            # the shielded __anext__ running detached
            nxt.cancel()
            raise
        except asyncio.TimeoutError:
            try:
                write_frame(writer, {"keepalive": True})
                await writer.drain()
            except Exception:
                # requester is gone: don't orphan the in-flight engine step
                nxt.cancel()
                raise
        except StopAsyncIteration:
            return _END


async def pump_stream(writer: asyncio.StreamWriter, gen,
                      context: Context) -> None:
    """Responder side: forward engine output frames into the TCP socket."""
    try:
        it = gen.__aiter__()
        while True:
            item = await _next_with_keepalive(writer, it)
            if item is _END:
                break
            write_frame(writer, {"data": item})
            await writer.drain()
        write_frame(writer, {"end": True})
        await writer.drain()
    except (ConnectionResetError, BrokenPipeError):
        context.stop_generating()
    except Exception as e:  # noqa: BLE001 — forwarded to the requester
        try:
            write_frame(writer, {"end": True,
                                 "error": f"{type(e).__name__}: {e}"})
            await writer.drain()
        except (ConnectionResetError, BrokenPipeError):
            pass
    finally:
        task = getattr(writer, "_dynamo_watch_task", None)
        if task:
            task.cancel()
        writer.close()
