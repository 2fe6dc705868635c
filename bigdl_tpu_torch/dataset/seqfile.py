"""Sharded record files (``bigdl_tpu/dataset/seqfile.py``): the
ImageNet-at-scale input path of the reference's ``DataSet.SeqFileFolder``
as a directory of RECS shards: the 4-byte ``RECS`` magic, then per record
a varint label, a varint payload length and the payload bytes.

* :func:`write_shards` packs ``(label, payload)`` records round-robin
  into ``n_shards`` files; :func:`read_shard` yields them back, indexed in
  one pass by the native ``recs_index`` (``bigdl_tpu_torch.native``; no
  Python fallback, a host without g++ raises ``OSError``);
* :func:`encode_array` / the default decoder carry a float32 array with a
  shape header (ndim u8, dims u32le);
* :class:`SeqFileDataSet` assigns shards round-robin to processes
  (``shard_index`` / ``num_shards``), shuffles the shard order and the
  records of each shard per epoch when training (numpy
  ``default_rng(seed + epoch)``, JAX's draws) and reads sequentially for
  evaluation.

The files are byte-identical to the JAX package's.
"""

from __future__ import annotations

import os
import struct
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from bigdl_tpu_torch.dataset.dataset import LocalDataSet
from bigdl_tpu_torch.dataset.sample import Sample

MAGIC = b"RECS"


def _write_varint(f, x: int) -> None:
    if x < 0:
        raise ValueError(f"varint fields must be non-negative, got {x}")
    while True:
        b = x & 0x7F
        x >>= 7
        f.write(bytes([b | 0x80] if x else [b]))
        if not x:
            return


def write_shards(records: Sequence[Tuple[int, bytes]], out_dir: str,
                 n_shards: int = 8, prefix: str = "part") -> List[str]:
    """Pack ``(label, payload)`` records into ``n_shards`` shard files
    (round-robin, like the reference's SequenceFile packing job)."""
    os.makedirs(out_dir, exist_ok=True)
    paths = [os.path.join(out_dir, f"{prefix}-{i:05d}.recs")
             for i in range(n_shards)]
    files = [open(p, "wb") for p in paths]
    try:
        for f in files:
            f.write(MAGIC)
        for i, (label, payload) in enumerate(records):
            f = files[i % n_shards]
            _write_varint(f, int(label))
            _write_varint(f, len(payload))
            f.write(payload)
    finally:
        for f in files:
            f.close()
    return paths


def read_shard(path: str) -> Iterator[Tuple[int, bytes]]:
    """Yield a shard's ``(label, payload)`` records: the file is read once
    and indexed by the native ``recs_index``; each payload is a copy of
    its slice."""
    from bigdl_tpu_torch import native

    buf = np.fromfile(path, np.uint8)
    if buf[:4].tobytes() != MAGIC:
        raise ValueError(f"{path}: not a RECS shard")
    try:
        labels, offsets, lengths = native.recs_index(buf)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
    for lab, off, ln in zip(labels, offsets, lengths):
        yield int(lab), buf[off:off + ln].tobytes()


def _default_decoder(label: int, payload: bytes) -> Sample:
    """Payload = raw float32 tensor bytes prefixed with a shape header
    (ndim u8, dims u32le each). Use ``decoder=`` for JPEG etc."""
    nd = payload[0]
    dims = struct.unpack_from(f"<{nd}I", payload, 1)
    arr = np.frombuffer(payload, np.float32, offset=1 + 4 * nd).reshape(dims)
    return Sample(arr.copy(), np.int32(label))


def encode_array(arr: np.ndarray) -> bytes:
    """Inverse of the default decoder's payload format."""
    arr = np.ascontiguousarray(arr, np.float32)
    header = bytes([arr.ndim]) + struct.pack(f"<{arr.ndim}I", *arr.shape)
    return header + arr.tobytes()


class SeqFileDataSet(LocalDataSet):
    """Shard-backed dataset with per-process shard assignment. Follows the
    LocalDataSet transformer-chain contract (``ds >> transformer``)."""

    def __init__(self, folder: str,
                 decoder: Optional[Callable[[int, bytes], Sample]] = None,
                 shard_index: int = 0, num_shards: int = 1,
                 seed: int = 0, transformers=None) -> None:
        self._folder = folder
        all_paths = sorted(
            os.path.join(folder, f) for f in os.listdir(folder)
            if f.endswith(".recs")
        )
        if not all_paths:
            raise ValueError(f"no .recs shards under {folder}")
        # round-robin shard → process assignment (one Spark partition per
        # executor: one shard subset per process)
        self.paths = all_paths[shard_index::num_shards]
        if not self.paths:
            raise ValueError(
                f"process {shard_index}/{num_shards} gets no shards — "
                f"{folder} holds only {len(all_paths)} .recs files; write at "
                "least one shard per process")
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.decoder = decoder or _default_decoder
        self._seed = seed
        self._transformers = list(transformers or [])
        self._epoch = 0
        self._size: Optional[int] = None

    def size(self) -> int:
        if self._size is None:
            self._size = sum(sum(1 for _ in read_shard(p))
                             for p in self.paths)
        return self._size

    def transform(self, transformer) -> "SeqFileDataSet":
        return SeqFileDataSet(self._folder, self.decoder, self.shard_index,
                              self.num_shards, self._seed,
                              self._transformers + [transformer])

    __rshift__ = transform

    def _iter_once(self, shuffle: bool) -> Iterator[Sample]:
        rng = np.random.default_rng(self._seed + self._epoch)
        order = list(self.paths)
        if shuffle:
            rng.shuffle(order)
        for path in order:
            records = list(read_shard(path))
            if shuffle:
                rng.shuffle(records)
            for label, payload in records:
                yield self.decoder(label, payload)

    def _base_iter(self, train: bool) -> Iterator[Sample]:
        if not train:
            yield from self._iter_once(shuffle=False)
            return
        while True:
            yield from self._iter_once(shuffle=True)
            self._epoch += 1
