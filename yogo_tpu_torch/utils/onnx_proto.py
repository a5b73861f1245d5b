"""Minimal ONNX protobuf wire-format encoder/decoder (the port's own copy
of yogo_tpu/utils/onnx_proto.py, numpy only).

No onnx package is installed, so `export` writes ModelProto bytes directly
(protobuf wire format is stable and simple: varints + length-delimited
fields). Field numbers follow onnx.proto3 (ONNX IR). Only the subset needed
for YOGO graphs is implemented:
ModelProto / GraphProto / NodeProto / AttributeProto / TensorProto /
ValueInfoProto / TypeProto / TensorShapeProto / OperatorSetIdProto.

`model(..., producer="yogo_tpu")` keeps the JAX package's producer string
as its default, so a graph exported by either package is the same bytes
(tests/test_torch_export.py holds them equal).

The decoder exists so exports can be round-trip-verified (and executed by
yogo_tpu_torch.utils.onnx_interp) without onnxruntime; files produced here
load in stock onnx/onnxruntime.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple

import numpy as np

# TensorProto.DataType
FLOAT = 1
UINT8 = 2
INT8 = 3
UINT16 = 4
INT16 = 5
INT32 = 6
INT64 = 7
BOOL = 9
FLOAT16 = 10
DOUBLE = 11

NP_TO_ONNX = {
    np.dtype(np.float32): FLOAT,
    np.dtype(np.uint8): UINT8,
    np.dtype(np.int64): INT64,
}
# parser accepts a wider set than the writer emits (torch graphs carry
# int32/bool/fp16 initializers)
ONNX_TO_NP = {v: k for k, v in NP_TO_ONNX.items()}
ONNX_TO_NP.update(
    {
        INT8: np.dtype(np.int8),
        UINT16: np.dtype(np.uint16),
        INT16: np.dtype(np.int16),
        INT32: np.dtype(np.int32),
        BOOL: np.dtype(np.bool_),
        FLOAT16: np.dtype(np.float16),
        DOUBLE: np.dtype(np.float64),
    }
)

# AttributeProto.AttributeType
ATTR_FLOAT = 1
ATTR_INT = 2
ATTR_STRING = 3
ATTR_TENSOR = 4
ATTR_FLOATS = 6
ATTR_INTS = 7


# ------------------------------------------------------------------ encoding
def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def enc_varint(field: int, value: int) -> bytes:
    return _tag(field, 0) + _varint(value)


def enc_bytes(field: int, value: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(value)) + value


def enc_str(field: int, value: str) -> bytes:
    return enc_bytes(field, value.encode())


def enc_float(field: int, value: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", value)


def enc_packed_varints(field: int, values) -> bytes:
    payload = b"".join(_varint(int(v)) for v in values)
    return enc_bytes(field, payload)


def tensor_proto(name: str, array: np.ndarray) -> bytes:
    array = np.ascontiguousarray(array)
    dt = NP_TO_ONNX[array.dtype]
    msg = b"".join(
        [
            enc_packed_varints(1, array.shape),  # dims
            enc_varint(2, dt),  # data_type
            enc_str(8, name),  # name
            enc_bytes(9, array.tobytes()),  # raw_data
        ]
    )
    return msg


def attribute(name: str, value: Any) -> bytes:
    parts = [enc_str(1, name)]
    if isinstance(value, (float, np.floating)):
        parts += [enc_float(2, float(value)), enc_varint(20, ATTR_FLOAT)]
    elif isinstance(value, bool) or isinstance(value, (int, np.integer)):
        parts += [enc_varint(3, int(value)), enc_varint(20, ATTR_INT)]
    elif isinstance(value, str):
        parts += [enc_str(4, value), enc_varint(20, ATTR_STRING)]
    elif isinstance(value, np.ndarray):
        parts += [enc_bytes(5, tensor_proto(name + "_t", value)),
                  enc_varint(20, ATTR_TENSOR)]
    elif isinstance(value, (list, tuple)) and all(
        isinstance(v, (int, np.integer)) for v in value
    ):
        parts += [enc_packed_varints(8, value), enc_varint(20, ATTR_INTS)]
    elif isinstance(value, (list, tuple)):
        payload = b"".join(struct.pack("<f", float(v)) for v in value)
        parts += [enc_bytes(7, payload), enc_varint(20, ATTR_FLOATS)]
    else:
        raise TypeError(f"unsupported attribute type for {name}: {type(value)}")
    return b"".join(parts)


def node(
    op_type: str,
    inputs: List[str],
    outputs: List[str],
    name: str = "",
    **attrs,
) -> bytes:
    parts = [enc_str(1, i) for i in inputs]
    parts += [enc_str(2, o) for o in outputs]
    if name:
        parts.append(enc_str(3, name))
    parts.append(enc_str(4, op_type))
    for k, v in attrs.items():
        # NodeProto.attribute is field 5 (field 7 is `domain`!): a writer and
        # parser sharing the wrong field would agree with each other, which
        # tests/test_onnx_cross_validation.py checks against torch.onnx
        parts.append(enc_bytes(5, attribute(k, v)))
    return b"".join(parts)


def value_info(name: str, elem_type: int, shape: Tuple) -> bytes:
    dims = b""
    for d in shape:
        if isinstance(d, str):
            dims += enc_bytes(1, enc_str(2, d))  # dim_param
        else:
            dims += enc_bytes(1, enc_varint(1, int(d)))  # dim_value
    tensor_type = enc_varint(1, elem_type) + enc_bytes(2, dims)
    type_proto = enc_bytes(1, tensor_type)
    return enc_str(1, name) + enc_bytes(2, type_proto)


def graph(
    nodes: List[bytes],
    name: str,
    inputs: List[bytes],
    outputs: List[bytes],
    initializers: List[bytes],
) -> bytes:
    parts = [enc_bytes(1, n) for n in nodes]
    parts.append(enc_str(2, name))
    parts += [enc_bytes(5, t) for t in initializers]
    parts += [enc_bytes(11, i) for i in inputs]
    parts += [enc_bytes(12, o) for o in outputs]
    return b"".join(parts)


def model(graph_bytes: bytes, opset: int = 17, producer: str = "yogo_tpu") -> bytes:
    opset_import = enc_varint(2, opset)  # default domain ""
    return b"".join(
        [
            enc_varint(1, 8),  # ir_version 8
            enc_str(2, producer),
            enc_str(3, "0.1.0"),
            enc_bytes(7, graph_bytes),
            enc_bytes(8, opset_import),
        ]
    )


# ------------------------------------------------------------------ decoding
def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def parse_message(buf: bytes) -> Dict[int, List[Any]]:
    """Parse one protobuf message into {field: [raw values]}; length-delimited
    fields stay bytes (parse nested messages recursively as needed)."""
    fields: Dict[int, List[Any]] = {}
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 2:
            length, pos = _read_varint(buf, pos)
            val = buf[pos : pos + length]
            pos += length
        elif wire == 5:
            val = struct.unpack("<f", buf[pos : pos + 4])[0]
            pos += 4
        else:  # pragma: no cover
            raise ValueError(f"unsupported wire type {wire}")
        fields.setdefault(field, []).append(val)
    return fields


def _to_signed64(v: int) -> int:
    """protobuf int64 fields encode negatives as 10-byte varints;
    reinterpret the unsigned value as two's-complement."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _unpack_varints(buf: bytes) -> List[int]:
    out = []
    pos = 0
    while pos < len(buf):
        v, pos = _read_varint(buf, pos)
        out.append(_to_signed64(v))
    return out


def _repeated_int64(values: List[Any]) -> List[int]:
    """Decode a repeated int64 field that may be PACKED (one bytes blob of
    varints - what this module's writer emits) or NON-PACKED (one varint
    record per element - what torch.onnx emits). The protobuf spec requires
    parsers to accept both."""
    out: List[int] = []
    for v in values:
        if isinstance(v, (bytes, bytearray)):
            out.extend(_unpack_varints(v))
        else:
            out.append(_to_signed64(v))
    return out


def _repeated_float32(values: List[Any]) -> List[float]:
    """Decode a repeated float field, PACKED (bytes of fixed32) or
    NON-PACKED (one fixed32 record per element)."""
    out: List[float] = []
    for v in values:
        if isinstance(v, (bytes, bytearray)):
            out.extend(np.frombuffer(v, np.float32).tolist())
        else:
            out.append(float(v))
    return out


def parse_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    f = parse_message(buf)
    dims = _repeated_int64(f.get(1, []))
    dtype = ONNX_TO_NP[f[2][0]]
    name = f[8][0].decode() if 8 in f else ""
    raw = f[9][0] if 9 in f else b""
    if raw:
        arr = np.frombuffer(raw, dtype=dtype).reshape(dims)
    elif 7 in f and dtype == np.int64:  # int64_data field, repeated
        arr = np.asarray(_repeated_int64(f[7]), np.int64).reshape(dims)
    elif 4 in f and dtype == np.float32:  # float_data field (packed or not)
        arr = np.asarray(_repeated_float32(f[4]), np.float32).reshape(dims)
    elif 5 in f:  # int32_data: also carries int8/16, uint8/16, bool, fp16
        vals = np.asarray(_repeated_int64(f[5]), np.int64)
        if dtype == np.float16:
            arr = vals.astype(np.uint16).view(np.float16).reshape(dims)
        else:
            arr = vals.astype(dtype).reshape(dims)
    elif int(np.prod(dims)) == 0:
        arr = np.zeros(dims, dtype=dtype)
    else:
        raise ValueError(
            f"tensor {name!r}: no supported data field for dtype "
            f"{np.dtype(dtype).name} with dims {dims}"
        )
    return name, arr


def parse_attribute(buf: bytes) -> Tuple[str, Any]:
    f = parse_message(buf)
    name = f[1][0].decode()
    atype = f[20][0] if 20 in f else None
    if atype == ATTR_FLOAT:
        return name, f[2][0]
    if atype == ATTR_INT:
        return name, _to_signed64(f[3][0])
    if atype == ATTR_STRING:
        return name, f[4][0].decode()
    if atype == ATTR_TENSOR:
        return name, parse_tensor(f[5][0])[1]
    if atype == ATTR_INTS:
        return name, _repeated_int64(f.get(8, []))
    if atype == ATTR_FLOATS:
        # packed or non-packed, possibly absent (empty list)
        return name, _repeated_float32(f.get(7, []))
    raise ValueError(f"unsupported attribute type {atype}")


def parse_node(buf: bytes) -> Dict[str, Any]:
    f = parse_message(buf)
    return {
        "inputs": [b.decode() for b in f.get(1, [])],
        "outputs": [b.decode() for b in f.get(2, [])],
        "name": f[3][0].decode() if 3 in f else "",
        "op_type": f[4][0].decode(),
        # NodeProto.attribute = field 5 per onnx.proto3
        "attrs": dict(parse_attribute(a) for a in f.get(5, [])),
    }


def parse_model(buf: bytes) -> Dict[str, Any]:
    m = parse_message(buf)
    g = parse_message(m[7][0])
    nodes = [parse_node(n) for n in g.get(1, [])]
    inits = dict(parse_tensor(t) for t in g.get(5, []))

    def vi_names(key):
        names = []
        for vi in g.get(key, []):
            names.append(parse_message(vi)[1][0].decode())
        return names

    return {
        "ir_version": m.get(1, [None])[0],
        "producer": m.get(2, [b""])[0].decode(),
        "nodes": nodes,
        "initializers": inits,
        "inputs": vi_names(11),
        "outputs": vi_names(12),
        # reuse the already-parsed graph: re-parsing m[7][0] would copy
        # every initializer's raw weight bytes a second time
        "graph_name": g.get(2, [b""])[0].decode(),
    }
