"""Host-side block stores and their array codec
(``bigdl_tpu/parallel/block_store.py:72-208``).

A block store is an immutable-once-put byte store keyed by strings — the
BlockManager analog the serving plane's KV-row handoff
(``serving/disagg.py``) and host KV tier (``serving/kv_tier.py``) ride:

* :class:`MemBlockStore` — an in-process dict behind one lock;
* :class:`FsBlockStore` — a shared directory, atomic by write-temp and
  ``os.rename``, so separate processes on one host exchange blocks.

:func:`encode_array` / :func:`decode_array` are the reference's codec,
byte for byte: ``b"BDBS"``, the dtype code's length and text, the rank,
one little-endian int64 per dimension, then the raw C-order bytes. The
codec takes a numpy array or a CPU torch tensor. numpy has no bfloat16,
so a bf16 tensor is written under the dtype NAME ``"bfloat16"`` with its
raw 2-byte words, exactly as the JAX package writes an ``ml_dtypes``
bfloat16 array; :func:`decode_array` returns a CPU torch tensor and
rebuilds bf16 as a ``view(torch.bfloat16)`` of the int16 words. A blob
therefore decodes to the same bits in either package, both ways.

Not carried: the JAX coordination-service store (a ``torch.distributed``
store is its counterpart, ROADMAP.md A.2.g) and the gradient-drop
parameter plane on top of the stores (A.5).
"""

from __future__ import annotations

import os
import struct
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

_MAGIC = b"BDBS"


def _host_bytes(arr):
    """(dtype code, shape, raw C-order bytes) of a numpy array or a CPU
    tensor; bf16 by name, its words as int16."""
    if isinstance(arr, torch.Tensor):
        if arr.device.type != "cpu":
            raise ValueError(
                "encode_array takes host data: read device tensors back "
                "through a fence first (serving/fences.py)")
        t = arr.detach().contiguous()
        if t.dtype == torch.bfloat16:
            return "bfloat16", tuple(t.shape), \
                t.view(torch.int16).numpy().tobytes()
        arr = t.numpy()
    arr = np.asarray(arr)
    shape = arr.shape      # before ascontiguousarray: it promotes 0-d to 1-d
    arr = np.ascontiguousarray(arr)
    code = arr.dtype.str
    if code.lstrip("<>|=").startswith("V"):
        code = arr.dtype.name   # an extension dtype, e.g. "bfloat16"
    return code, shape, arr.tobytes()


def encode_array(arr) -> bytes:
    """Self-describing little header + raw bytes (module docstring)."""
    code, shape, raw = _host_bytes(arr)
    dt = code.encode()
    head = _MAGIC + struct.pack("<B", len(dt)) + dt
    head += struct.pack("<B", len(shape)) + b"".join(
        struct.pack("<q", s) for s in shape)
    return head + raw


def decode_array(blob) -> torch.Tensor:
    """Inverse of :func:`encode_array` (``blob`` bytes or a memoryview of
    them): a CPU tensor owning its bytes."""
    if bytes(blob[:4]) != _MAGIC:
        raise ValueError("not a block-store array blob")
    off = 4
    (ndt,) = struct.unpack_from("<B", blob, off)
    off += 1
    code = bytes(blob[off:off + ndt]).decode()
    off += ndt
    (nsh,) = struct.unpack_from("<B", blob, off)
    off += 1
    shape = struct.unpack_from(f"<{nsh}q", blob, off) if nsh else ()
    off += 8 * nsh
    if code == "bfloat16":
        words = np.frombuffer(blob, dtype="<i2", offset=off).copy()
        return torch.from_numpy(words).view(torch.bfloat16).reshape(shape)
    try:
        dt = np.dtype(code)
    except TypeError:
        raise ValueError(
            f"unsupported array dtype {code!r} in a block-store blob") \
            from None
    arr = np.frombuffer(blob, dtype=dt, offset=off).reshape(shape).copy()
    return torch.from_numpy(arr)


class BlockStore:
    """Abstract immutable-once-put block store (the BlockManager analog)."""

    def put(self, key: str, value: bytes) -> None:
        raise NotImplementedError

    def try_get(self, key: str) -> Optional[bytes]:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def contains(self, key: str) -> bool:
        """Existence probe without fetching the value where the backend
        can (the fallback fetches and discards): polling loops such as a
        handoff channel's ``pending()`` call it per tick."""
        return self.try_get(key) is not None

    def get_blocking(self, key: str, timeout_s: float,
                     poll_s: float = 0.002) -> bytes:
        deadline = time.monotonic() + timeout_s
        while True:
            v = self.try_get(key)
            if v is not None:
                return v
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"block {key!r} not published within {timeout_s}s — a "
                    "peer process likely died")
            time.sleep(poll_s)


class MemBlockStore(BlockStore):
    """In-process dict backend, thread-safe (one lock); not visible
    across processes — use :class:`FsBlockStore` for that."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._blocks: Dict[str, bytes] = {}

    def put(self, key: str, value: bytes) -> None:
        with self._lock:
            self._blocks[key] = bytes(value)

    def try_get(self, key: str) -> Optional[bytes]:
        with self._lock:
            return self._blocks.get(key)

    def delete(self, key: str) -> None:
        with self._lock:
            self._blocks.pop(key, None)

    def contains(self, key: str) -> bool:
        with self._lock:
            return key in self._blocks


class FsBlockStore(BlockStore):
    """Shared-directory backend; atomic via write-temp + os.rename."""

    def __init__(self, root: str) -> None:
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key.replace("/", "__"))

    def put(self, key: str, value: bytes) -> None:
        path = self._path(key)
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "wb") as f:
            f.write(value)
        os.rename(tmp, path)

    def try_get(self, key: str) -> Optional[bytes]:
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def delete(self, key: str) -> None:
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass

    def contains(self, key: str) -> bool:
        return os.path.exists(self._path(key))
