"""Minimal protobuf wire-format encode/decode for ONNX interop (a copy
of ``mxnet_tpu/contrib/onnx/_proto.py``: the port imports nothing of the
JAX package).

The port needs no `onnx` package: the exporter emits (and the
importer parses) the protobuf wire format directly — the format is simple:
varints, fixed32/64, and length-delimited fields. Only the subset of
onnx.proto needed for ModelProto round-trips is modeled (ref message/field
numbers: onnx/onnx.proto3).
"""
from __future__ import annotations

import struct
from typing import Dict, List, Tuple, Union

# wire types
VARINT, FIXED64, BYTES, FIXED32 = 0, 1, 2, 5


def write_varint(n: int) -> bytes:
    if n < 0:
        n &= (1 << 64) - 1  # two's-complement 64-bit, 10-byte varint
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return write_varint((field << 3) | wire)


def f_varint(field: int, value: int) -> bytes:
    return _tag(field, VARINT) + write_varint(int(value))


def f_bytes(field: int, data: Union[bytes, str]) -> bytes:
    if isinstance(data, str):
        data = data.encode('utf-8')
    return _tag(field, BYTES) + write_varint(len(data)) + data


def f_float(field: int, value: float) -> bytes:
    return _tag(field, FIXED32) + struct.pack('<f', float(value))


def f_packed_varints(field: int, values) -> bytes:
    payload = b''.join(write_varint(int(v)) for v in values)
    return f_bytes(field, payload)


def f_packed_floats(field: int, values) -> bytes:
    payload = b''.join(struct.pack('<f', float(v)) for v in values)
    return f_bytes(field, payload)


# ---- decoding ---------------------------------------------------------------

def read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            break
        shift += 7
    return result, pos


def to_signed(n: int) -> int:
    """Interpret a varint as a signed int64 (protobuf int32/int64)."""
    if n >= (1 << 63):
        n -= (1 << 64)
    return n


def parse_message(buf: bytes) -> Dict[int, List]:
    """Parse one message into {field_number: [raw values in order]}.
    VARINT → int, FIXED32 → 4 bytes, FIXED64 → 8 bytes, BYTES → bytes."""
    fields: Dict[int, List] = {}
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == VARINT:
            val, pos = read_varint(buf, pos)
        elif wire == BYTES:
            ln, pos = read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == FIXED32:
            val = buf[pos:pos + 4]
            pos += 4
        elif wire == FIXED64:
            val = buf[pos:pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        fields.setdefault(field, []).append(val)
    return fields


def get_str(fields, num, default='') -> str:
    if num in fields:
        return fields[num][-1].decode('utf-8')
    return default


def get_int(fields, num, default=0) -> int:
    if num in fields:
        return to_signed(fields[num][-1])
    return default


def get_float(fields, num, default=0.0) -> float:
    if num in fields:
        return struct.unpack('<f', fields[num][-1])[0]
    return default


def get_repeated_ints(fields, num) -> List[int]:
    """Repeated int64 field: either packed (one bytes blob) or repeated
    varints."""
    out = []
    for v in fields.get(num, []):
        if isinstance(v, int):
            out.append(to_signed(v))
        else:  # packed
            pos = 0
            while pos < len(v):
                val, pos = read_varint(v, pos)
                out.append(to_signed(val))
    return out


def get_repeated_floats(fields, num) -> List[float]:
    out = []
    for v in fields.get(num, []):
        if isinstance(v, bytes) and len(v) == 4:
            out.append(struct.unpack('<f', v)[0])
        elif isinstance(v, bytes):  # packed
            out.extend(struct.unpack(f'<{len(v)//4}f', v))
    return out
