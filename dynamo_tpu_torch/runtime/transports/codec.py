"""A pure-Python MessagePack codec for the control and data planes' frames.

The JAX package frames its control-plane and data-plane messages with the
`msgpack` package (dynamo_tpu/runtime/transports/wire.py:15-84 and the
`msgpack.packb` / `msgpack.unpackb` calls in runtime/component.py). The
port depends on torch and numpy alone, so it carries its own codec for the
types its frames hold: nil, bool, int (every width), float64, str, bin,
array and map.

`packb(obj)` gives the same bytes as `msgpack.packb(obj, use_bin_type=True)`
(the smallest integer format, str8 and bin families, float64 always, maps
in insertion order, tuples as arrays), and `unpackb(b)` the same objects as
`msgpack.unpackb(b, raw=False)` (str decoded as UTF-8, bin as bytes, arrays
as lists). So the port's control plane and the JAX one speak one wire
format. Extension types, float32 packing and the streaming Unpacker are
left out; `unpackb` still reads a float32 that another packer wrote.

KV page frames carry 100+ MiB of bin payload. `pack_parts(obj)` gives the
same bytes as a list of buffers in which every bin payload of at least
64 KiB is the caller's own buffer (a writer sends them with
`writelines`, no copy), and `unpackb(data, zero_copy=True)` returns bin
payloads as read-only memoryview slices of `data` instead of copies.
Neither loops over a payload's elements.
"""
from __future__ import annotations

import struct
from typing import Any

__all__ = ["packb", "pack_parts", "unpackb"]

# bin payloads at least this long stay their own buffer in pack_parts
_BIG = 64 * 1024

_U8, _U16, _U32, _U64 = (struct.Struct(f) for f in (">B", ">H", ">I", ">Q"))
_I8, _I16, _I32, _I64 = (struct.Struct(f) for f in (">b", ">h", ">i", ">q"))
_F32, _F64 = struct.Struct(">f"), struct.Struct(">d")


def _pack_int(x: int, out: bytearray) -> None:
    if x >= 0:
        if x < 0x80:
            out.append(x)
        elif x <= 0xFF:
            out += b"\xcc" + _U8.pack(x)
        elif x <= 0xFFFF:
            out += b"\xcd" + _U16.pack(x)
        elif x <= 0xFFFFFFFF:
            out += b"\xce" + _U32.pack(x)
        elif x <= 0xFFFFFFFFFFFFFFFF:
            out += b"\xcf" + _U64.pack(x)
        else:
            raise OverflowError("Integer value out of range")
    elif x >= -32:
        out.append(x & 0xFF)
    elif x >= -0x80:
        out += b"\xd0" + _I8.pack(x)
    elif x >= -0x8000:
        out += b"\xd1" + _I16.pack(x)
    elif x >= -0x80000000:
        out += b"\xd2" + _I32.pack(x)
    elif x >= -0x8000000000000000:
        out += b"\xd3" + _I64.pack(x)
    else:
        raise OverflowError("Integer value out of range")


def _pack_len(n: int, fix: int, fix_max: int, codes: bytes,
              out: bytearray) -> None:
    """A length header: the fix form below `fix_max`, else the 8- (when
    `codes` has three entries), 16- or 32-bit form."""
    if n < fix_max:
        out.append(fix | n)
        return
    if len(codes) == 3 and n <= 0xFF:
        out += codes[0:1] + _U8.pack(n)
    elif n <= 0xFFFF:
        out += codes[-2:-1] + _U16.pack(n)
    elif n <= 0xFFFFFFFF:
        out += codes[-1:] + _U32.pack(n)
    else:
        raise ValueError("object too large to pack")


def _pack(obj: Any, out: bytearray, parts=None) -> None:
    """Append obj's encoding to `out`; with a `parts` list, large bin
    payloads are appended to it as their own buffers (after flushing
    `out`'s bytes there) instead of being copied into `out`."""
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out += b"\xcb" + _F64.pack(obj)
    elif isinstance(obj, str):
        data = str.encode(obj, "utf-8")
        if len(data) < 32:
            out.append(0xA0 | len(data))
        else:
            _pack_len(len(data), 0, 0, b"\xd9\xda\xdb", out)
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = memoryview(obj).cast("B")
        _pack_len(data.nbytes, 0, 0, b"\xc4\xc5\xc6", out)
        if parts is not None and data.nbytes >= _BIG:
            parts.append(bytes(out))
            del out[:]
            parts.append(data)
        else:
            out += data
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 16, b"\xdc\xdd", out)
        for item in obj:
            _pack(item, out, parts)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 16, b"\xde\xdf", out)
        for k, v in obj.items():
            _pack(k, out, parts)
            _pack(v, out, parts)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj: Any) -> bytes:
    """MessagePack bytes of `obj` (msgpack.packb(obj, use_bin_type=True))."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def pack_parts(obj: Any) -> list:
    """packb(obj) as a list of buffers whose concatenation is those bytes;
    bin payloads of 64 KiB or more are the caller's buffers, not copies."""
    parts: list = []
    out = bytearray()
    _pack(obj, out, parts)
    if out or not parts:
        parts.append(bytes(out))
    return parts


class _Reader:
    __slots__ = ("buf", "pos", "view")

    def __init__(self, buf: bytes, zero_copy: bool = False):
        self.buf = buf
        self.pos = 0
        # bin payloads as slices of this view (zero_copy) or as copies
        self.view = memoryview(buf).toreadonly() if zero_copy else None

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("Unpack failed: incomplete input")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def num(self, s: struct.Struct):
        end = self.pos + s.size
        if end > len(self.buf):
            raise ValueError("Unpack failed: incomplete input")
        (v,) = s.unpack_from(self.buf, self.pos)
        self.pos = end
        return v


# header byte -> (kind, length struct or fixed value)
_SIZED = {
    0xC4: ("bin", _U8), 0xC5: ("bin", _U16), 0xC6: ("bin", _U32),
    0xD9: ("str", _U8), 0xDA: ("str", _U16), 0xDB: ("str", _U32),
    0xDC: ("array", _U16), 0xDD: ("array", _U32),
    0xDE: ("map", _U16), 0xDF: ("map", _U32),
}
_NUMS = {
    0xCA: _F32, 0xCB: _F64, 0xCC: _U8, 0xCD: _U16, 0xCE: _U32, 0xCF: _U64,
    0xD0: _I8, 0xD1: _I16, 0xD2: _I32, 0xD3: _I64,
}


def _unpack(r: _Reader) -> Any:
    b = r.num(_U8)
    if b < 0x80:
        return b
    if b >= 0xE0:
        return b - 0x100
    if b <= 0x8F:
        return _unpack_map(r, b & 0x0F)
    if b <= 0x9F:
        return [_unpack(r) for _ in range(b & 0x0F)]
    if b <= 0xBF:
        return r.take(b & 0x1F).decode("utf-8")
    if b == 0xC0:
        return None
    if b == 0xC2:
        return False
    if b == 0xC3:
        return True
    s = _NUMS.get(b)
    if s is not None:
        return r.num(s)
    sized = _SIZED.get(b)
    if sized is None:
        raise ValueError(f"Unpack failed: unsupported type byte 0x{b:02x}")
    kind, ls = sized
    n = r.num(ls)
    if kind == "bin":
        if r.view is not None:
            start, r.pos = r.pos, r.pos + n
            if r.pos > len(r.buf):
                raise ValueError("Unpack failed: incomplete input")
            return r.view[start:r.pos]
        return r.take(n)
    if kind == "str":
        return r.take(n).decode("utf-8")
    if kind == "array":
        return [_unpack(r) for _ in range(n)]
    return _unpack_map(r, n)


def _unpack_map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        k = _unpack(r)
        if not isinstance(k, (str, bytes)):
            raise ValueError(f"{type(k).__name__} is not allowed for map key")
        out[k] = _unpack(r)
    return out


def unpackb(data: bytes, zero_copy: bool = False) -> Any:
    """The object MessagePack bytes encode (msgpack.unpackb(data,
    raw=False)); trailing bytes are an error. With zero_copy, bin payloads
    are read-only memoryviews into `data`."""
    r = _Reader(data if isinstance(data, bytes) else bytes(data), zero_copy)
    obj = _unpack(r)
    if r.pos != len(r.buf):
        raise ValueError("Unpack failed: extra data")
    return obj
