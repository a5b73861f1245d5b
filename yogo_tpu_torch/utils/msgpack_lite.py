"""Minimal msgpack decoder and encoder for the native `.ckpt` format.

Checkpoints are written by flax's msgpack serializer
(yogo_tpu/utils/checkpoint.py:58-117). The port must read and write them on
machines that have neither `msgpack` nor `flax`, so it carries a codec for
the subset those files use: nil/bool, ints, floats, str, bin, arrays, maps,
and ext type 1, flax's ndarray, whose payload is itself a msgpack array
`[shape, dtype-name, raw little-endian C-order bytes]`. Any other ext code
raises on reading; `packb` writes the smallest form of each type, as
msgpack's own packer does, and numpy scalars as 0-d ndarrays.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

EXT_NDARRAY = 1


class MsgpackError(ValueError):
    pass


def _ndarray(payload: bytes) -> np.ndarray:
    shape, dtype_name, buf = unpackb(payload)
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    if dtype_name == "bfloat16":
        raise MsgpackError("bfloat16 checkpoint leaves are not supported")
    return np.frombuffer(buf, dtype=np.dtype(dtype_name)).reshape(shape)


def _ext(code: int, payload: bytes) -> Any:
    if code != EXT_NDARRAY:
        raise MsgpackError(f"unsupported msgpack ext type {code}")
    return _ndarray(payload)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.data):
            raise MsgpackError("truncated msgpack data")
        out = self.data[self.pos : end].tobytes()
        self.pos = end
        return out

    def unpack(self, fmt: str) -> Tuple:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))

    def obj(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode()
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {
            0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
            0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
            0xDC: (">H", "array"), 0xDD: (">I", "array"),
            0xDE: (">H", "map"), 0xDF: (">I", "map"),
            0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
        }
        if b in sized:
            fmt, kind = sized[b]
            (n,) = self.unpack(fmt)
            if kind == "bin":
                return self.take(n)
            if kind == "str":
                return self.take(n).decode()
            if kind == "array":
                return self.array(n)
            if kind == "map":
                return self.map(n)
            (code,) = self.unpack(">b")
            return _ext(code, self.take(n))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            (code,) = self.unpack(">b")
            return _ext(code, self.take(fixext[b]))
        scalars = {
            0xCA: ">f", 0xCB: ">d",
            0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
        }
        if b in scalars:
            return self.unpack(scalars[b])[0]
        raise MsgpackError(f"unsupported msgpack type byte 0x{b:02x}")

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out


def unpackb(data: bytes) -> Any:
    """Decode one msgpack object that spans all of `data`."""
    r = _Reader(data)
    out = r.obj()
    if r.pos != len(r.data):
        raise MsgpackError(f"{len(r.data) - r.pos} trailing bytes")
    return out


# flax splits larger leaves into chunks; nothing the port writes comes near
MAX_NDARRAY_BYTES = 2**30


def _pack_sized(out: bytearray, n: int, forms: Tuple[Tuple[int, int, str], ...]) -> None:
    """Append the header of the first (limit, type byte, length format)
    whose limit holds n."""
    for limit, byte, fmt in forms:
        if n < limit:
            out.append(byte)
            out += struct.pack(fmt, n)
            return
    raise MsgpackError(f"object of length {n} is too long for msgpack")


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v <= 0x7F:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v + 0x100)
    elif v >= 0:
        _pack_sized(out, v, ((2**8, 0xCC, ">B"), (2**16, 0xCD, ">H"),
                             (2**32, 0xCE, ">I"), (2**64, 0xCF, ">Q")))
    else:
        for bits, byte, fmt in ((8, 0xD0, ">b"), (16, 0xD1, ">h"), (32, 0xD2, ">i"), (64, 0xD3, ">q")):
            if v >= -(2 ** (bits - 1)):
                out.append(byte)
                out += struct.pack(fmt, v)
                return
        raise MsgpackError(f"integer {v} is out of msgpack's range")


def _pack_ext(out: bytearray, code: int, payload: bytes) -> None:
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(payload) in fixext:
        out.append(fixext[len(payload)])
    else:
        _pack_sized(out, len(payload), ((2**8, 0xC7, ">B"), (2**16, 0xC8, ">H"), (2**32, 0xC9, ">I")))
    out += struct.pack(">b", code)
    out += payload


def _pack(out: bytearray, obj: Any) -> None:
    if obj is None:
        out.append(0xC0)
    elif isinstance(obj, (bool, np.bool_)):
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        raw = obj.encode()
        if len(raw) < 32:
            out.append(0xA0 | len(raw))
        else:
            _pack_sized(out, len(raw), ((2**8, 0xD9, ">B"), (2**16, 0xDA, ">H"), (2**32, 0xDB, ">I")))
        out += raw
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        _pack_sized(out, len(obj), ((2**8, 0xC4, ">B"), (2**16, 0xC5, ">H"), (2**32, 0xC6, ">I")))
        out += obj
    elif isinstance(obj, (list, tuple)):
        if len(obj) < 16:
            out.append(0x90 | len(obj))
        else:
            _pack_sized(out, len(obj), ((2**16, 0xDC, ">H"), (2**32, 0xDD, ">I")))
        for item in obj:
            _pack(out, item)
    elif isinstance(obj, dict):
        if len(obj) < 16:
            out.append(0x80 | len(obj))
        else:
            _pack_sized(out, len(obj), ((2**16, 0xDE, ">H"), (2**32, 0xDF, ">I")))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    elif isinstance(obj, (np.ndarray, np.generic)):
        arr = np.asarray(obj)
        if arr.dtype.hasobject or arr.nbytes > MAX_NDARRAY_BYTES:
            raise MsgpackError(f"cannot pack an ndarray of {arr.dtype}, {arr.nbytes} bytes")
        if arr.dtype.byteorder == ">":
            arr = arr.astype(arr.dtype.newbyteorder("<"))
        _pack_ext(out, EXT_NDARRAY, packb([list(arr.shape), arr.dtype.name, arr.tobytes("C")]))
    else:
        raise MsgpackError(f"cannot pack {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    """Encode nil/bool/int/float/str/bytes/list/tuple/dict/ndarray as one
    msgpack object that `unpackb`, msgpack and flax's
    `serialization.msgpack_restore` read back."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)
