"""Length-prefixed MessagePack framing shared by the control and data planes.

Copied from dynamo_tpu/runtime/transports/wire.py:15-84: one MessagePack map
per frame behind a 4-byte big-endian length, at most MAX_FRAME bytes. The
port encodes with its own codec (transports/codec.py, byte-identical to
`msgpack.packb(..., use_bin_type=True)`), so its frames and the JAX
package's are the same bytes. `oneshot_request` (the HA role probe and
fencing dial) is left out with the standby it serves.
"""
from __future__ import annotations

import asyncio
import struct
from typing import Any, Dict, Optional

from dynamo_tpu_torch.runtime.transports.codec import packb, unpackb

MAX_FRAME = 256 * 1024 * 1024  # KV pages can be large


def pack(msg: Dict[str, Any]) -> bytes:
    body = packb(msg)
    return struct.pack(">I", len(body)) + body


async def _read_frame_inner(reader: asyncio.StreamReader) -> Dict[str, Any]:
    # dynalint: unbounded-io-ok=bounded by read_frame(timeout=) or the caller's wrapper
    header = await reader.readexactly(4)
    (length,) = struct.unpack(">I", header)
    if length > MAX_FRAME:
        raise ValueError(f"frame of {length} bytes exceeds max {MAX_FRAME}")
    # dynalint: unbounded-io-ok=bounded by read_frame(timeout=) or the caller's wrapper
    body = await reader.readexactly(length)
    return unpackb(body)


async def read_frame(reader: asyncio.StreamReader,
                     timeout: Optional[float] = None) -> Dict[str, Any]:
    """Read one frame. `timeout` (seconds) bounds the whole frame, header
    and body together; None leaves the bound to the caller (an idle
    server-side pump, or an enclosing wait_for)."""
    if timeout is None:
        return await _read_frame_inner(reader)
    return await asyncio.wait_for(_read_frame_inner(reader), timeout)


def write_frame(writer: asyncio.StreamWriter, msg: Dict[str, Any]) -> None:
    writer.write(pack(msg))
