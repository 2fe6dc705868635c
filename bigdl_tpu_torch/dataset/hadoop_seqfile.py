"""Hadoop SequenceFiles (``bigdl_tpu/dataset/hadoop_seqfile.py``): the
read path for a reference user's existing ``DataSet.SeqFileFolder``
corpus (ImageNet packed as ``Text`` label keys and ``BytesWritable``
image values, one file per shard).

* Hadoop's ``WritableUtils`` vint codec (:func:`write_vlong`,
  :func:`read_vlong`), bit-exact, and the ``Text``, ``BytesWritable``,
  ``IntWritable`` and ``LongWritable`` payload codecs;
* :class:`SequenceFileWriter` (uncompressed record layout, version 6,
  with a sync marker about every ``sync_interval`` bytes) and
  :class:`SequenceFileReader` (versions 4-6; a record- or
  block-compressed file raises ``NotImplementedError`` naming its codec);
* :func:`convert_to_recs`, one pass from a SequenceFile folder to RECS
  shards (``dataset/seqfile.py``, read by the native indexer), and
  :class:`HadoopSeqFileDataSet`, direct streaming with the same
  shard-per-process and shuffle contract as ``SeqFileDataSet``.

Files written here are byte-identical to the JAX package's.
"""

from __future__ import annotations

import io
import os
import struct
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from bigdl_tpu_torch.dataset.dataset import LocalDataSet

_MAGIC = b"SEQ"
TEXT = "org.apache.hadoop.io.Text"
BYTES_WRITABLE = "org.apache.hadoop.io.BytesWritable"
INT_WRITABLE = "org.apache.hadoop.io.IntWritable"
LONG_WRITABLE = "org.apache.hadoop.io.LongWritable"


# -- Hadoop WritableUtils vint codec (bit-exact) ---------------------------

def write_vlong(f, v: int) -> None:
    if -112 <= v <= 127:
        f.write(struct.pack("b", v))
        return
    neg = v < 0
    if neg:
        v = ~v
    length, tmp = 0, v
    while tmp:
        length += 1
        tmp >>= 8
    f.write(struct.pack("b", (-120 - length) if neg else (-112 - length)))
    for i in range(length - 1, -1, -1):
        f.write(bytes([(v >> (8 * i)) & 0xFF]))


def read_vlong(f) -> int:
    raw = f.read(1)
    if not raw:
        raise EOFError("vint at EOF")
    (b,) = struct.unpack("b", raw)
    if b >= -112:
        return b
    neg = b < -120
    # Hadoop's decodeVIntSize counts the marker byte itself
    n_data = ((-119 - b) if neg else (-111 - b)) - 1
    v = 0
    for _ in range(n_data):
        v = (v << 8) | f.read(1)[0]
    return ~v if neg else v


def _write_hadoop_string(f, s: str) -> None:
    data = s.encode("utf-8")
    write_vlong(f, len(data))
    f.write(data)


def _read_hadoop_string(f) -> str:
    n = read_vlong(f)
    return f.read(n).decode("utf-8")


# -- Writable payload codecs ----------------------------------------------

def encode_text(s: str) -> bytes:
    buf = io.BytesIO()
    data = s.encode("utf-8")
    write_vlong(buf, len(data))
    buf.write(data)
    return buf.getvalue()


def decode_text(payload: bytes) -> str:
    buf = io.BytesIO(payload)
    n = read_vlong(buf)
    return buf.read(n).decode("utf-8")


def encode_bytes_writable(data: bytes) -> bytes:
    return struct.pack(">i", len(data)) + data


def decode_bytes_writable(payload: bytes) -> bytes:
    (n,) = struct.unpack_from(">i", payload, 0)
    return payload[4:4 + n]


def encode_int_writable(v: int) -> bytes:
    return struct.pack(">i", v)


def decode_int_writable(payload: bytes) -> int:
    return struct.unpack_from(">i", payload, 0)[0]


# -- file reader / writer --------------------------------------------------

class SequenceFileWriter:
    """Uncompressed record-layout SequenceFile (version 6). A sync marker
    is emitted roughly every ``sync_interval`` bytes like Hadoop's writer,
    so readers (including this module's) exercise the escape path."""

    def __init__(self, path: str, key_class: str = TEXT,
                 value_class: str = BYTES_WRITABLE,
                 sync_interval: int = 2000, seed: int = 0) -> None:
        self._f = open(path, "wb")
        self.key_class = key_class
        self.value_class = value_class
        self._sync_interval = sync_interval
        self._last_sync = 0
        self._sync = np.random.RandomState(seed).bytes(16)
        f = self._f
        f.write(_MAGIC + bytes([6]))
        _write_hadoop_string(f, key_class)
        _write_hadoop_string(f, value_class)
        f.write(b"\x00\x00")                    # compressed, blockCompressed
        f.write(struct.pack(">i", 0))           # metadata entries
        f.write(self._sync)

    def append_raw(self, key: bytes, value: bytes) -> None:
        f = self._f
        if f.tell() - self._last_sync >= self._sync_interval:
            f.write(struct.pack(">i", -1))
            f.write(self._sync)
            self._last_sync = f.tell()
        f.write(struct.pack(">i", len(key) + len(value)))
        f.write(struct.pack(">i", len(key)))
        f.write(key)
        f.write(value)

    def append(self, key, value) -> None:
        """Encode by declared class: Text accepts str, BytesWritable
        bytes, IntWritable/LongWritable int."""
        self.append_raw(_encode_for(self.key_class, key),
                        _encode_for(self.value_class, value))

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _encode_for(cls: str, v) -> bytes:
    if cls == TEXT:
        return encode_text(v)
    if cls == BYTES_WRITABLE:
        return encode_bytes_writable(v)
    if cls == INT_WRITABLE:
        return encode_int_writable(v)
    if cls == LONG_WRITABLE:
        return struct.pack(">q", v)
    raise NotImplementedError(f"no encoder for writable class {cls!r}")


class SequenceFileReader:
    """Iterate ``(key_payload, value_payload)`` raw writable bytes; the
    header's class names are exposed so callers pick decoders."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._f = f = open(path, "rb")
        magic = f.read(3)
        if magic != _MAGIC:
            raise ValueError(f"{path}: not a SequenceFile (no SEQ magic)")
        self.version = f.read(1)[0]
        if not 4 <= self.version <= 6:
            raise ValueError(
                f"{path}: SequenceFile version {self.version} unsupported "
                "(record layout with leading class names is v4-v6)")
        self.key_class = _read_hadoop_string(f)
        self.value_class = _read_hadoop_string(f)
        compressed = f.read(1)[0] != 0
        # Hadoop's BLOCK_COMPRESS_VERSION is 4, so every supported version
        # (4-6, enforced above) carries the blockCompressed flag byte; only
        # the codec class string (CUSTOM_COMPRESS_VERSION) waits for v5.
        block_compressed = f.read(1)[0] != 0
        codec = None
        if compressed or block_compressed:
            if self.version >= 5:
                codec = _read_hadoop_string(f)
            raise NotImplementedError(
                f"{path}: compressed SequenceFile (codec {codec!r}) — "
                "decompress with Hadoop tooling or repack; this reader "
                "handles the uncompressed record layout")
        if self.version >= 6:
            n_meta = struct.unpack(">i", f.read(4))[0]
            for _ in range(n_meta):
                _read_hadoop_string(f)
                _read_hadoop_string(f)
        self._sync = f.read(16)

    def __iter__(self) -> Iterator[Tuple[bytes, bytes]]:
        f = self._f
        while True:
            head = f.read(4)
            if len(head) < 4:
                return
            (rec_len,) = struct.unpack(">i", head)
            if rec_len == -1:                       # sync escape
                marker = f.read(16)
                if marker != self._sync:
                    raise ValueError(
                        f"{self.path}: corrupt sync marker mid-file")
                continue
            (key_len,) = struct.unpack(">i", f.read(4))
            if not 0 <= key_len <= rec_len:
                raise ValueError(
                    f"{self.path}: corrupt record (key {key_len} of "
                    f"{rec_len} bytes)")
            key = f.read(key_len)
            value = f.read(rec_len - key_len)
            if len(key) != key_len or len(value) != rec_len - key_len:
                raise ValueError(f"{self.path}: truncated record")
            yield key, value

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _seq_paths(folder: str) -> List[str]:
    paths = sorted(
        os.path.join(folder, f) for f in os.listdir(folder)
        if f.endswith(".seq") or f.startswith("part-"))
    if not paths:
        raise ValueError(f"no SequenceFiles (*.seq or part-*) under {folder}")
    return paths


def _default_label_of(key: bytes, value: bytes, key_class: str) -> int:
    """The reference packing job wrote the readable label as the Text key
    (possibly 'path<space>label'); IntWritable keys pass through."""
    if key_class == TEXT:
        return int(decode_text(key).split()[-1])
    if key_class == INT_WRITABLE:
        return decode_int_writable(key)
    if key_class == LONG_WRITABLE:
        return struct.unpack(">q", key[:8])[0]
    raise NotImplementedError(
        f"cannot derive a label from key class {key_class!r} — pass "
        "label_of=")


def convert_to_recs(src_folder: str, out_dir: str, n_shards: int = 8,
                    label_of: Optional[Callable] = None,
                    payload_of: Optional[Callable] = None) -> List[str]:
    """Repack a SequenceFile folder into RECS shards (the native format
    the C++ indexer and the measured host pipeline consume). Default
    mapping is the reference ImageNet convention: label from the Text/Int
    key, payload from the BytesWritable value."""
    from bigdl_tpu_torch.dataset.seqfile import write_shards

    def records() -> Iterator[Tuple[int, bytes]]:
        for path in _seq_paths(src_folder):
            with SequenceFileReader(path) as r:
                for key, value in r:
                    if label_of is not None:
                        label = label_of(key, value)
                    else:
                        label = _default_label_of(key, value, r.key_class)
                    if payload_of is not None:
                        payload = payload_of(key, value)
                    elif r.value_class == BYTES_WRITABLE:
                        payload = decode_bytes_writable(value)
                    else:
                        payload = value
                    yield int(label), payload

    return write_shards(list(records()), out_dir, n_shards=n_shards)


def _np_label(label: int) -> np.ndarray:
    """int64 when the value needs it (LongWritable keys can exceed int32 —
    the RECS side preserves those too), int32 otherwise."""
    label = int(label)
    if not -2 ** 31 <= label < 2 ** 31:
        return np.int64(label)
    return np.int32(label)


class HadoopSeqFileDataSet(LocalDataSet):
    """Direct streaming ingestion of a SequenceFile folder with the same
    shard-per-process round-robin AND the same dataset contract as
    ``SeqFileDataSet`` (``Optimizer``-consumable, ``ds >> transformer``
    chains). For repeated epochs over big corpora prefer
    :func:`convert_to_recs` once — RECS rides the native indexer; this
    class re-parses Java framing every epoch.

    ``decoder(label, payload)`` has the SAME signature as the RECS
    dataset's (label from the Text/Int/Long key, payload unwrapped from
    BytesWritable) so one decoder serves both formats across a
    ``convert_to_recs`` migration; pass ``label_of(key_bytes,
    value_bytes)`` for exotic key schemes. Raw key/value access =
    :class:`SequenceFileReader` directly."""

    def __init__(self, folder: str,
                 decoder: Optional[Callable] = None,
                 shard_index: int = 0, num_shards: int = 1,
                 seed: int = 0, transformers=None,
                 label_of: Optional[Callable] = None) -> None:
        self._folder = folder
        all_paths = _seq_paths(folder)
        self.paths = all_paths[shard_index::num_shards]
        if not self.paths:
            raise ValueError(
                f"process {shard_index}/{num_shards} gets no files — "
                f"{folder} holds only {len(all_paths)}")
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.decoder = decoder
        self.label_of = label_of
        self._seed = seed
        self._transformers = list(transformers or [])
        self._epoch = 0
        self._size: Optional[int] = None

    def _decode(self, reader, key, value):
        label = (self.label_of(key, value) if self.label_of is not None
                 else _default_label_of(key, value, reader.key_class))
        payload = (decode_bytes_writable(value)
                   if reader.value_class == BYTES_WRITABLE else value)
        if self.decoder is not None:
            return self.decoder(int(label), payload)
        from bigdl_tpu_torch.dataset.sample import Sample

        return Sample(np.frombuffer(payload, np.uint8).copy(),
                      _np_label(label))

    def size(self) -> int:
        if self._size is None:
            n = 0
            for p in self.paths:
                with SequenceFileReader(p) as r:
                    for _ in r:
                        n += 1
            self._size = n
        return self._size

    def transform(self, transformer) -> "HadoopSeqFileDataSet":
        return HadoopSeqFileDataSet(
            self._folder, self.decoder, self.shard_index, self.num_shards,
            self._seed, self._transformers + [transformer], self.label_of)

    __rshift__ = transform

    def _iter_once(self, shuffle: bool):
        rng = np.random.default_rng(self._seed + self._epoch)
        order = list(self.paths)
        if shuffle:
            rng.shuffle(order)
        for path in order:
            with SequenceFileReader(path) as r:
                records = list(r)
                if shuffle:
                    rng.shuffle(records)
                for key, value in records:
                    yield self._decode(r, key, value)

    def _base_iter(self, train: bool):
        if not train:
            yield from self._iter_once(shuffle=False)
            return
        while True:
            yield from self._iter_once(shuffle=True)
            self._epoch += 1
