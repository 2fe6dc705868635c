"""TF event-file writer and reader with no TensorFlow dependency
(``bigdl_tpu/visualization/tensorboard.py``).

Protobuf ``Event`` records (wall_time=1 double, step=2 int64,
file_version=3 string, summary=5 message; ``Summary.Value``: tag=1
string, simple_value=2 float, histo=5 message) in TFRecord framing:
u64-le length, masked crc32c of the length, payload, masked crc32c of the
payload. The records are byte-identical to the JAX package's for the same
tag, value and step, apart from ``wall_time``, and any TensorBoard reads
them.
"""

from __future__ import annotations

import os
import struct
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.utils.protowire import (
    field_bytes, field_double, field_float, field_varint,
)


def _crc_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli, reflected polynomial 0x82F63B78)."""
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _event(summary_value: bytes, step: int,
           wall_time: Optional[float]) -> bytes:
    return (field_double(1, time.time() if wall_time is None else wall_time)
            + field_varint(2, int(step))
            + field_bytes(5, field_bytes(1, summary_value)))


def scalar_event(tag: str, value: float, step: int,
                 wall_time: Optional[float] = None) -> bytes:
    sv = field_bytes(1, tag.encode()) + field_float(2, float(value))
    return _event(sv, step, wall_time)


def _packed_doubles(num: int, vals) -> bytes:
    return field_bytes(num, b"".join(struct.pack("<d", float(v))
                                     for v in vals))


def histogram_event(tag: str, values, step: int, bins: int = 30,
                    wall_time: Optional[float] = None) -> bytes:
    """TF ``HistogramProto`` event (the ``Parameters/...`` histograms of a
    TrainSummary); ``values`` is a host array (see :func:`to_host`)."""
    v = np.asarray(values, np.float64).reshape(-1)
    if v.size == 0:
        v = np.zeros((1,))
    counts, edges = np.histogram(v, bins=bins)
    histo = (field_double(1, float(v.min()))
             + field_double(2, float(v.max()))
             + field_double(3, float(v.size))
             + field_double(4, float(v.sum()))
             + field_double(5, float((v * v).sum()))
             + _packed_doubles(6, edges[1:])
             + _packed_doubles(7, counts))
    sv = field_bytes(1, tag.encode()) + field_bytes(5, histo)
    return _event(sv, step, wall_time)


def version_event() -> bytes:
    return field_double(1, time.time()) + field_bytes(3, b"brain.Event:2")


def frame_record(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", masked_crc(header))
            + payload + struct.pack("<I", masked_crc(payload)))


def to_host(values) -> np.ndarray:
    """A tensor on any device (or an array) as a float64 host array, read
    from the device once."""
    if isinstance(values, torch.Tensor):
        values = values.detach().to("cpu", torch.float64).numpy()
    return np.asarray(values, np.float64)


class FileWriter:
    """Append-only event-file writer; the file is named
    ``events.out.tfevents.<µs timestamp>.<suffix>`` (TensorBoard's
    convention)."""

    def __init__(self, log_dir: str, suffix: str = "bigdl_tpu") -> None:
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(
            log_dir, f"events.out.tfevents.{int(time.time() * 1e6)}.{suffix}")
        self._f = open(self.path, "ab")
        self._write(version_event())

    def _write(self, payload: bytes) -> None:
        self._f.write(frame_record(payload))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write(scalar_event(tag, value, step))

    def add_histogram(self, tag: str, values, step: int) -> None:
        """``values``: a tensor on any device or a host array."""
        self._write(histogram_event(tag, to_host(values), step))

    def close(self) -> None:
        self._f.close()


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    shift = n = 0
    while True:
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, i
        shift += 7


def parse_message(buf: bytes) -> Dict[int, list]:
    """One protobuf message: {field number: [values]} (nested messages
    stay bytes)."""
    i, out = 0, {}
    while i < len(buf):
        key, i = _read_varint(buf, i)
        num, wire = key >> 3, key & 7
        if wire == 1:
            val = struct.unpack_from("<d", buf, i)[0]
            i += 8
        elif wire == 5:
            val = struct.unpack_from("<f", buf, i)[0]
            i += 4
        elif wire == 2:
            ln, i = _read_varint(buf, i)
            val = buf[i:i + ln]
            i += ln
        else:
            val, i = _read_varint(buf, i)
        out.setdefault(num, []).append(val)
    return out


def read_events(path: str) -> List[Dict[int, list]]:
    """Every record of an event file, parsed one message level deep."""
    with open(path, "rb") as f:
        data = f.read()
    out, i = [], 0
    while i + 12 <= len(data):
        (ln,) = struct.unpack_from("<Q", data, i)
        out.append(parse_message(data[i + 12:i + 12 + ln]))
        i += 12 + ln + 4
    return out


def read_scalars(path: str) -> List[Tuple[str, float, int]]:
    """An event file's scalars as (tag, value, step) triples."""
    out = []
    for ev in read_events(path):
        step = ev.get(2, [0])[0]
        for summary in ev.get(5, []):
            for value_msg in parse_message(summary).get(1, []):
                v = parse_message(value_msg)
                if 1 in v and 2 in v:
                    out.append((v[1][0].decode(), v[2][0], step))
    return out

