"""The port's record shards (``bigdl_tpu_torch/dataset/seqfile.py``) and
Hadoop SequenceFiles (``hadoop_seqfile.py``) against the JAX package's,
on the CPU: the files each writes are byte-identical, each reads the
other's, and both datasets yield the same samples in the same order.

Tolerance: bitwise everywhere (byte formats, and the same numpy
``default_rng(seed + epoch)`` shuffles).
"""

import io
import os
import struct

import numpy as np
import pytest
from tests.torch_parity import one_torch_thread  # noqa: F401

import bigdl_tpu.dataset.hadoop_seqfile as jh
import bigdl_tpu.dataset.seqfile as js
from bigdl_tpu.dataset.dataset import DataSet as JDataSet
import bigdl_tpu_torch.dataset.hadoop_seqfile as th
import bigdl_tpu_torch.dataset.seqfile as ts
from bigdl_tpu_torch.dataset import DataSet as TDataSet


def _records(n=37, seed=0):
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(0, 10 ** 6)) if i % 7 else 2 ** 40 + i,
             rng.bytes(int(rng.integers(0, 300)))) for i in range(n)]


def _tree_bytes(folder):
    return {f: open(os.path.join(folder, f), "rb").read()
            for f in sorted(os.listdir(folder))}


def _same_samples(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.feature(), b.feature())
        assert a.feature().dtype == b.feature().dtype
        np.testing.assert_array_equal(a.label(), b.label())
        assert a.label().dtype == b.label().dtype


@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_shards_are_byte_identical_and_read_both_ways(tmp_path, n_shards):
    recs = _records()
    jp = js.write_shards(recs, str(tmp_path / "jax"), n_shards=n_shards)
    tp = ts.write_shards(recs, str(tmp_path / "port"), n_shards=n_shards)
    assert [os.path.basename(p) for p in tp] == \
        [os.path.basename(p) for p in jp]
    assert _tree_bytes(tmp_path / "port") == _tree_bytes(tmp_path / "jax")
    for j, t in zip(jp, tp):
        assert list(ts.read_shard(j)) == list(js.read_shard(t))
    got = sorted(r for p in tp for r in ts.read_shard(p))
    assert got == sorted(recs)


def test_bad_shards_raise_with_their_path(tmp_path):
    (p,) = ts.write_shards(_records(4), str(tmp_path), n_shards=1)
    data = open(p, "rb").read()
    open(p, "wb").write(data[:-3])
    with pytest.raises(ValueError, match="malformed"):
        list(ts.read_shard(p))
    bad = tmp_path / "x.recs"
    bad.write_bytes(b"NOPE" + data[4:])
    with pytest.raises(ValueError, match="x.recs: not a RECS shard"):
        list(ts.read_shard(str(bad)))
    with pytest.raises(ValueError, match="non-negative"):
        ts.write_shards([(-1, b"")], str(tmp_path / "neg"))


@pytest.mark.parametrize("shape", [(3, 4, 5), (7,), ()])
def test_encode_array_and_default_decoder_match_jax(shape):
    arr = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    assert ts.encode_array(arr) == js.encode_array(arr)
    got = ts._default_decoder(5, ts.encode_array(arr))
    want = js._default_decoder(5, js.encode_array(arr))
    _same_samples([got], [want])


def _array_records(n=30):
    rng = np.random.default_rng(2)
    return [(i % 4 + 1, js.encode_array(rng.standard_normal((2, 3))))
            for i in range(n)]


@pytest.mark.parametrize("shard_index,num_shards", [(0, 1), (1, 3)])
def test_seqfile_dataset_yields_jax_samples(tmp_path, shard_index,
                                            num_shards):
    js.write_shards(_array_records(), str(tmp_path), n_shards=6)
    jd = js.SeqFileDataSet(str(tmp_path), shard_index=shard_index,
                           num_shards=num_shards, seed=4)
    td = ts.SeqFileDataSet(str(tmp_path), shard_index=shard_index,
                           num_shards=num_shards, seed=4)
    assert td.paths == jd.paths and td.size() == jd.size()
    _same_samples(td.data(train=False), jd.data(train=False))
    jt, tt = jd.data(train=True), td.data(train=True)
    n = 3 * jd.size()                         # three shuffled epochs
    _same_samples([next(tt) for _ in range(n)], [next(jt) for _ in range(n)])
    with pytest.raises(ValueError, match="gets no shards"):
        ts.SeqFileDataSet(str(tmp_path), shard_index=7, num_shards=8)


# ------------------------------------------------------------ Hadoop


@pytest.mark.parametrize("v", [0, 1, -1, 127, -112, 128, -113, 255, 256,
                               -129, 2 ** 31 - 1, -2 ** 31, 2 ** 40 + 3,
                               -2 ** 63, 2 ** 63 - 1])
def test_vlong_codec_is_hadoops(v):
    a, b = io.BytesIO(), io.BytesIO()
    jh.write_vlong(a, v)
    th.write_vlong(b, v)
    assert a.getvalue() == b.getvalue()
    assert th.read_vlong(io.BytesIO(b.getvalue())) == v


def test_writable_codecs_match_jax():
    for s in ["", "n01440764 7", "ünïcode"]:
        assert th.encode_text(s) == jh.encode_text(s)
        assert th.decode_text(th.encode_text(s)) == s
    for data in [b"", b"\x00\xff" * 70]:
        assert th.encode_bytes_writable(data) == jh.encode_bytes_writable(
            data)
        assert th.decode_bytes_writable(th.encode_bytes_writable(data)) == \
            data
    assert th.encode_int_writable(-5) == jh.encode_int_writable(-5)
    assert th.decode_int_writable(th.encode_int_writable(-5)) == -5


KEYS = [(th.TEXT, lambda i: f"path/{i}.jpg {i % 5 + 1}"),
        (th.INT_WRITABLE, lambda i: i % 5 + 1),
        (th.LONG_WRITABLE, lambda i: 2 ** 40 + i)]


def _write_seq(mod, folder, key_class, key_of, n_files=3, per=25):
    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(6)
    for f in range(n_files):
        with mod.SequenceFileWriter(os.path.join(folder, f"part-{f:05d}"),
                                    key_class=key_class,
                                    sync_interval=300, seed=f) as w:
            for i in range(per):
                w.append(key_of(f * per + i),
                         rng.bytes(int(rng.integers(1, 90))))


@pytest.mark.parametrize("key_class,key_of", KEYS,
                         ids=["text", "int", "long"])
def test_sequence_files_are_byte_identical_and_convert_to_recs(
        tmp_path, key_class, key_of):
    _write_seq(jh, tmp_path / "jax", key_class, key_of)
    _write_seq(th, tmp_path / "port", key_class, key_of)
    assert _tree_bytes(tmp_path / "port") == _tree_bytes(tmp_path / "jax")
    path = str(tmp_path / "port" / "part-00001")
    with th.SequenceFileReader(path) as r, jh.SequenceFileReader(path) as j:
        assert (r.version, r.key_class, r.value_class) == (
            j.version, j.key_class, j.value_class)
        assert list(r) == list(j)
    jp = jh.convert_to_recs(str(tmp_path / "jax"), str(tmp_path / "jr"),
                            n_shards=4)
    tp = th.convert_to_recs(str(tmp_path / "port"), str(tmp_path / "tr"),
                            n_shards=4)
    assert len(tp) == len(jp) == 4
    assert _tree_bytes(tmp_path / "tr") == _tree_bytes(tmp_path / "jr")


def test_compressed_and_foreign_files_are_refused(tmp_path):
    good = tmp_path / "part-00000"
    th.SequenceFileWriter(str(good)).close()
    data = bytearray(good.read_bytes())
    i = 4 + 1 + len(th.TEXT) + 1 + len(th.BYTES_WRITABLE)
    data[i] = 1                                  # "compressed"
    codec = b"org.apache.hadoop.io.compress.DefaultCodec"
    comp = bytes(data[:i + 2]) + bytes([len(codec)]) + codec + bytes(
        data[i + 2:])
    (tmp_path / "c.seq").write_bytes(comp)
    with pytest.raises(NotImplementedError, match="DefaultCodec"):
        th.SequenceFileReader(str(tmp_path / "c.seq"))
    (tmp_path / "x.seq").write_bytes(b"RECS....")
    with pytest.raises(ValueError, match="not a SequenceFile"):
        th.SequenceFileReader(str(tmp_path / "x.seq"))
    (tmp_path / "v.seq").write_bytes(b"SEQ\x03" + bytes(40))
    with pytest.raises(ValueError, match="version 3"):
        th.SequenceFileReader(str(tmp_path / "v.seq"))


@pytest.mark.parametrize("key_class,key_of", KEYS,
                         ids=["text", "int", "long"])
def test_hadoop_dataset_and_factory_yield_jax_samples(tmp_path, key_class,
                                                      key_of):
    _write_seq(jh, tmp_path / "seq", key_class, key_of)
    folder = str(tmp_path / "seq")
    jd = jh.HadoopSeqFileDataSet(folder, seed=2)
    td = th.HadoopSeqFileDataSet(folder, seed=2)
    assert td.size() == jd.size() == 75
    _same_samples(td.data(train=False), jd.data(train=False))
    jt, tt = jd.data(train=True), td.data(train=True)
    _same_samples([next(tt) for _ in range(160)],
                  [next(jt) for _ in range(160)])
    fd = TDataSet.seq_file_folder(folder, seed=2, format="hadoop")
    assert isinstance(fd, th.HadoopSeqFileDataSet)
    assert (fd.shard_index, fd.num_shards) == (0, 1)
    _same_samples(fd.data(train=False), jd.data(train=False))
    # the same decoder through a RECS migration
    th.convert_to_recs(folder, str(tmp_path / "recs"), n_shards=2)

    def decoder(label, payload):
        return ts.Sample(np.frombuffer(payload, np.uint8).astype(np.float32),
                         np.int64(label))

    got = TDataSet.seq_file_folder(str(tmp_path / "recs"), decoder=decoder,
                                   seed=1)
    want = JDataSet.seq_file_folder(str(tmp_path / "recs"), decoder=decoder,
                                    seed=1)
    _same_samples(got.data(train=False), want.data(train=False))
    with pytest.raises(ValueError, match="unknown seq_file_folder format"):
        TDataSet.seq_file_folder(folder, format="tfrecord")
