"""Protobuf wire-format encoders (``bigdl_tpu/utils/protowire.py``): the
varint, tag, length-delimited, float and double field rules that the
TensorBoard event writer (``visualization/tensorboard.py``) needs."""

from __future__ import annotations

import struct


def varint(x: int) -> bytes:
    if x < 0:
        raise ValueError(f"varint fields must be non-negative, got {x}")
    out = b""
    while True:
        b = x & 0x7F
        x >>= 7
        if x:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def tag(fnum: int, wtype: int) -> bytes:
    return varint((fnum << 3) | wtype)


def field_varint(fnum: int, val: int) -> bytes:
    return tag(fnum, 0) + varint(val)


def field_double(fnum: int, val: float) -> bytes:
    return tag(fnum, 1) + struct.pack("<d", val)


def field_float(fnum: int, val: float) -> bytes:
    return tag(fnum, 5) + struct.pack("<f", val)


def field_bytes(fnum: int, val: bytes) -> bytes:
    return tag(fnum, 2) + varint(len(val)) + val
