"""Length-prefixed MessagePack framing shared by the control and data planes.

Copied from dynamo_tpu/runtime/transports/wire.py:15-84: one MessagePack map
per frame behind a 4-byte big-endian length, at most MAX_FRAME bytes. The
port encodes with its own codec (transports/codec.py, byte-identical to
`msgpack.packb(..., use_bin_type=True)`), so its frames and the JAX
package's are the same bytes. A frame is written as a list of buffers
(`codec.pack_parts`), so a KV page frame's payloads reach the socket
without being copied into one body first, and `read_frame(...,
zero_copy=True)` hands its bin payloads out as views of the frame's body.
`oneshot_request` (the HA role probe and fencing dial) is left out with
the standby it serves.
"""
from __future__ import annotations

import asyncio
import struct
from typing import Any, Dict, Optional

from dynamo_tpu_torch.runtime.transports.codec import (
    pack_parts, packb, unpackb,
)

MAX_FRAME = 256 * 1024 * 1024  # KV pages can be large


def pack(msg: Dict[str, Any]) -> bytes:
    body = packb(msg)
    return struct.pack(">I", len(body)) + body


async def _read_frame_inner(reader: asyncio.StreamReader,
                            zero_copy: bool = False) -> Dict[str, Any]:
    # dynalint: unbounded-io-ok=bounded by read_frame(timeout=) or the caller's wrapper
    header = await reader.readexactly(4)
    (length,) = struct.unpack(">I", header)
    if length > MAX_FRAME:
        raise ValueError(f"frame of {length} bytes exceeds max {MAX_FRAME}")
    # dynalint: unbounded-io-ok=bounded by read_frame(timeout=) or the caller's wrapper
    body = await reader.readexactly(length)
    return unpackb(body, zero_copy=zero_copy)


async def read_frame(reader: asyncio.StreamReader,
                     timeout: Optional[float] = None,
                     zero_copy: bool = False) -> Dict[str, Any]:
    """Read one frame. `timeout` (seconds) bounds the whole frame, header
    and body together; None leaves the bound to the caller (an idle
    server-side pump, or an enclosing wait_for). zero_copy: bin payloads
    as read-only memoryviews of the body."""
    if timeout is None:
        return await _read_frame_inner(reader, zero_copy)
    return await asyncio.wait_for(_read_frame_inner(reader, zero_copy),
                                  timeout)


def write_frame(writer: asyncio.StreamWriter, msg: Dict[str, Any]) -> None:
    parts = pack_parts(msg)
    if len(parts) == 1:     # no large payload: one buffer, as pack() gives
        writer.write(struct.pack(">I", len(parts[0])) + parts[0])
        return
    size = sum(memoryview(p).nbytes for p in parts)
    if size > MAX_FRAME:
        raise ValueError(f"frame of {size} bytes exceeds max {MAX_FRAME}")
    writer.writelines([struct.pack(">I", size), *parts])
