"""A reader of the `.ckpt` checkpoints the benchmark serves, frozen here so
that the plain reference reads its weights with no code of the program.

The file is one msgpack map {"meta": JSON str, "variables": flax tree,
["opt_state": bytes]}; arrays are msgpack ext type 1, a msgpack array
[shape, dtype name, raw little-endian C-order bytes] (flax's layout; the
decoder is a copy of yogo_tpu_torch/utils/msgpack_lite.py's reader).
`torch_weights` turns the flax tree into the torch layout the reference
takes: conv kernels HWIO -> OIHW, norms' scale -> weight, BN statistics
as running_mean / running_var.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Any, Dict, Tuple

import numpy as np


class CkptError(ValueError):
    pass


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.data):
            raise CkptError("truncated msgpack data")
        out = self.data[self.pos:end].tobytes()
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
            return [self.obj() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode()
        if b in (0xC0, 0xC2, 0xC3):
            return {0xC0: None, 0xC2: False, 0xC3: True}[b]
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
                return [self.obj() for _ in range(n)]
            if kind == "map":
                return self.map(n)
            (code,) = self.unpack(">b")
            return _ext(code, self.take(n))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            (code,) = self.unpack(">b")
            return _ext(code, self.take(fixext[b]))
        scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in scalars:
            return self.unpack(scalars[b])[0]
        raise CkptError(f"unsupported msgpack type byte 0x{b:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out


def _ext(code: int, payload: bytes) -> np.ndarray:
    if code != 1:
        raise CkptError(f"unsupported msgpack ext type {code}")
    r = _Reader(payload)
    shape, dtype, buf = r.obj()
    if isinstance(dtype, bytes):
        dtype = dtype.decode()
    return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)


def read(path) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(meta, variables as the flax tree of numpy arrays)."""
    r = _Reader(Path(path).read_bytes())
    payload = r.obj()
    if r.pos != len(r.data):
        raise CkptError("trailing bytes after the checkpoint")
    return json.loads(payload["meta"]), payload["variables"]


def torch_weights(variables: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """A conv stack's flax variables -> {torch name: float32 array}."""
    out = {}
    for module, leaves in variables["params"].items():
        for leaf, a in leaves.items():
            a = np.asarray(a, np.float32)
            if leaf == "kernel":
                out[f"{module}.weight"] = np.ascontiguousarray(a.transpose(3, 2, 0, 1))
            elif leaf == "scale":
                out[f"{module}.weight"] = a.copy()
            elif leaf == "bias":
                out[f"{module}.bias"] = a.copy()
            else:
                raise CkptError(f"unexpected parameter {module}/{leaf}")
    for module, stats in variables.get("batch_stats", {}).items():
        out[f"{module}.running_mean"] = np.asarray(stats["mean"], np.float32).copy()
        out[f"{module}.running_var"] = np.asarray(stats["var"], np.float32).copy()
    return out
