"""Minimal protobuf wire-format reader/writer.

Used for the Prometheus remote read/write bodies (prompb.WriteRequest /
ReadRequest / ReadResponse) without a protoc dependency — the message
shapes are tiny and stable (reference: src/servers/src/prometheus.rs works
from the same prompb definitions).
"""

from __future__ import annotations

import struct
from typing import Iterator, List, Tuple


def read_varint(data: memoryview, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")


def write_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def iter_fields(data: memoryview) -> Iterator[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, value) over a message body."""
    pos = 0
    n = len(data)
    while pos < n:
        key, pos = read_varint(data, pos)
        field, wt = key >> 3, key & 0x07
        if wt == 0:                          # varint
            v, pos = read_varint(data, pos)
            yield field, wt, v
        elif wt == 1:                        # 64-bit
            v = bytes(data[pos:pos + 8])
            pos += 8
            yield field, wt, v
        elif wt == 2:                        # length-delimited
            ln, pos = read_varint(data, pos)
            v = data[pos:pos + ln]
            pos += ln
            yield field, wt, v
        elif wt == 5:                        # 32-bit
            v = bytes(data[pos:pos + 4])
            pos += 4
            yield field, wt, v
        else:
            raise ValueError(f"unsupported wire type {wt}")


def zigzag_decode(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


def field_bytes(field: int, payload: bytes) -> bytes:
    return write_varint((field << 3) | 2) + write_varint(len(payload)) + payload


def field_varint(field: int, value: int) -> bytes:
    if value < 0:
        value &= (1 << 64) - 1
    return write_varint(field << 3) + write_varint(value)


def field_double(field: int, value: float) -> bytes:
    return write_varint((field << 3) | 1) + struct.pack("<d", value)


def decode_double(raw: bytes) -> float:
    return struct.unpack("<d", raw)[0]


def decode_sint64(v: int) -> int:
    """Interpret a varint as two's-complement int64 (proto int64)."""
    if v >= 1 << 63:
        v -= 1 << 64
    return v
