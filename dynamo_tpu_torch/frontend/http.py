"""Minimal asyncio HTTP/1.1 server with SSE streaming support.

Copied from dynamo_tpu/frontend/http.py, unchanged apart from the logger's
name (stdlib only). The reference serves OpenAI routes through axum
(reference: lib/llm/src/http/service/service_v2.rs:23-130); the port
depends on no web framework, so the frontend carries its own small HTTP
layer: route
table, JSON bodies, keep-alive for unary responses, chunked transfer for SSE
streams, and client-disconnect detection (the hook the service uses to call
`stop_generating`, reference: openai.rs:414-470 monitor_for_disconnects).
"""
from __future__ import annotations

import asyncio
import json
import logging
from typing import Any, AsyncIterator, Awaitable, Callable, Dict, Optional, Tuple

log = logging.getLogger("dynamo_tpu_torch.http")

MAX_BODY = 64 * 1024 * 1024
MAX_HEADER = 64 * 1024


class Request:
    def __init__(self, method: str, path: str, query: str,
                 headers: Dict[str, str], body: bytes):
        self.method = method
        self.path = path
        self.query = query
        self.headers = headers
        self.body = body
        # set for handlers that want to observe client disconnect
        self.disconnected = asyncio.Event()

    def json(self) -> Any:
        try:
            return json.loads(self.body or b"{}")
        except json.JSONDecodeError as e:
            raise HttpError(400, f"invalid JSON body: {e}")


class HttpError(Exception):
    def __init__(self, status: int, message: str,
                 headers: Optional[Dict[str, str]] = None):
        super().__init__(message)
        self.status = status
        self.message = message
        self.headers = headers or {}


class Response:
    def __init__(self, status: int = 200, body: bytes = b"",
                 content_type: str = "application/json",
                 headers: Optional[Dict[str, str]] = None):
        self.status = status
        self.body = body
        self.content_type = content_type
        self.headers = headers or {}

    @classmethod
    def json(cls, obj: Any, status: int = 200) -> "Response":
        return cls(status, json.dumps(obj).encode())

    @classmethod
    def text(cls, text: str, status: int = 200,
             content_type: str = "text/plain; charset=utf-8") -> "Response":
        return cls(status, text.encode(), content_type)

    @classmethod
    def error(cls, status: int, message: str,
              headers: Optional[Dict[str, str]] = None) -> "Response":
        resp = cls.json({"error": {"message": message, "code": status}},
                        status)
        if headers:
            resp.headers.update(headers)
        return resp


class StreamingResponse:
    """Chunked-transfer response fed by an async byte generator (SSE)."""

    def __init__(self, gen: AsyncIterator[bytes],
                 content_type: str = "text/event-stream"):
        self.gen = gen
        self.content_type = content_type


Handler = Callable[[Request], Awaitable["Response | StreamingResponse"]]

STATUS_TEXT = {200: "OK", 400: "Bad Request", 404: "Not Found",
               405: "Method Not Allowed", 422: "Unprocessable Entity",
               429: "Too Many Requests", 500: "Internal Server Error",
               503: "Service Unavailable"}


class HttpServer:
    def __init__(self, host: str = "0.0.0.0", port: int = 8080):
        self.host = host
        self.port = port
        self._routes: Dict[Tuple[str, str], Handler] = {}
        self._server: Optional[asyncio.AbstractServer] = None

    def route(self, method: str, path: str, handler: Handler) -> None:
        self._routes[(method.upper(), path)] = handler

    async def start(self) -> "HttpServer":
        self._server = await asyncio.start_server(
            self._serve_conn, self.host, self.port, limit=MAX_HEADER)
        if self.port == 0:
            self.port = self._server.sockets[0].getsockname()[1]
        return self

    async def stop(self) -> None:
        if self._server:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    # -- connection handling -------------------------------------------------

    async def _serve_conn(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                try:
                    req = await self._read_request(reader)
                except HttpError as e:
                    await self._write_response(
                        writer, Response.error(e.status, e.message))
                    break
                if req is None:
                    break
                keep_alive = await self._dispatch(req, reader, writer)
                if not keep_alive:
                    break
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        except Exception:  # dynalint: swallow-ok=connection-scoped-error-logged
            log.exception("connection handler error")
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:  # dynalint: swallow-ok=best-effort-socket-close
                pass

    async def _read_request(self, reader: asyncio.StreamReader
                            ) -> Optional[Request]:
        try:
            head = await reader.readuntil(b"\r\n\r\n")
        except (asyncio.IncompleteReadError, ConnectionError):
            return None
        except asyncio.LimitOverrunError:
            raise HttpError(400, "headers too large")
        lines = head.decode("latin-1").split("\r\n")
        try:
            method, target, _version = lines[0].split(" ", 2)
        except ValueError:
            raise HttpError(400, "malformed request line")
        path, _, query = target.partition("?")
        headers = {}
        for line in lines[1:]:
            if ":" in line:
                k, _, v = line.partition(":")
                headers[k.strip().lower()] = v.strip()
        try:
            length = int(headers.get("content-length", "0"))
        except ValueError:
            raise HttpError(400, "invalid content-length")
        if length < 0:
            raise HttpError(400, "invalid content-length")
        if length > MAX_BODY:
            raise HttpError(400, "body too large")
        body = await reader.readexactly(length) if length else b""
        return Request(method.upper(), path, query, headers, body)

    async def _dispatch(self, req: Request, reader: asyncio.StreamReader,
                        writer: asyncio.StreamWriter) -> bool:
        handler = self._routes.get((req.method, req.path))
        if handler is None:
            if any(p == req.path for (_m, p) in self._routes):
                await self._write_response(
                    writer, Response.error(405, "method not allowed"))
            else:
                await self._write_response(
                    writer, Response.error(404, f"no route {req.path}"))
            return True
        try:
            result = await handler(req)
        except HttpError as e:
            await self._write_response(
                writer, Response.error(e.status, e.message, e.headers))
            return True
        except Exception as e:
            log.exception("handler error on %s %s", req.method, req.path)
            await self._write_response(
                writer, Response.error(500, f"{type(e).__name__}: {e}"))
            return True
        if isinstance(result, StreamingResponse):
            await self._write_stream(req, result, reader, writer)
            return False  # streamed responses close the connection
        await self._write_response(writer, result)
        return True

    async def _write_response(self, writer: asyncio.StreamWriter,
                              resp: Response) -> None:
        status_line = (f"HTTP/1.1 {resp.status} "
                       f"{STATUS_TEXT.get(resp.status, 'Unknown')}\r\n")
        headers = {
            "content-type": resp.content_type,
            "content-length": str(len(resp.body)),
            **resp.headers,
        }
        head = status_line + "".join(
            f"{k}: {v}\r\n" for k, v in headers.items()) + "\r\n"
        writer.write(head.encode("latin-1") + resp.body)
        await writer.drain()

    async def _write_stream(self, req: Request, resp: StreamingResponse,
                            reader: asyncio.StreamReader,
                            writer: asyncio.StreamWriter) -> None:
        head = ("HTTP/1.1 200 OK\r\n"
                f"content-type: {resp.content_type}\r\n"
                "cache-control: no-cache\r\n"
                "transfer-encoding: chunked\r\n"
                "connection: close\r\n\r\n")
        writer.write(head.encode("latin-1"))
        await writer.drain()

        # watch for the client going away while we stream (reference:
        # monitor_for_disconnects): any read returning EOF means disconnect
        async def monitor():
            try:
                await reader.read(1)
            except Exception:  # dynalint: swallow-ok=errors-and-eof-both-mean-disconnect
                pass
            req.disconnected.set()

        mon = asyncio.create_task(monitor())
        try:
            async for chunk in resp.gen:
                if req.disconnected.is_set():
                    break
                if not chunk:
                    continue
                writer.write(f"{len(chunk):x}\r\n".encode() + chunk + b"\r\n")
                await writer.drain()
            writer.write(b"0\r\n\r\n")
            await writer.drain()
        except (ConnectionError, asyncio.CancelledError):
            req.disconnected.set()
            raise
        finally:
            mon.cancel()
            gen_close = getattr(resp.gen, "aclose", None)
            if gen_close is not None:
                try:
                    await gen_close()
                except Exception:  # dynalint: swallow-ok=best-effort-stream-close
                    pass
