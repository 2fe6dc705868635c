"""DataSet — local dataset (``bigdl_tpu/dataset/dataset.py``):
``DataSet.array`` → ``LocalDataSet`` with ``data(train=)`` iterators,
infinite and shuffled for training, one pass for evaluation. The
training shuffle is ``np.random.RandomState(seed).permutation``, one
draw per epoch, exactly as the JAX package draws it, so both packages
see the same batches in the same order.

``DataSet.distributed`` (alias ``DataSet.rdd``) holds this process's
shard of the global data, ``data[rank::world]`` over the
``torch.distributed`` group (the JAX package's ``[process_index ::
process_count]``), as a :class:`DistributedDataSet`; the ``Optimizer``
factory returns a ``DistriOptimizer`` for that type.

``DataSet.image_folder`` loads a class-per-subdirectory image folder
(``dataset/image.py``); ``DataSet.seq_file_folder`` reads record shards,
RECS (``dataset/seqfile.py``) or Hadoop SequenceFiles
(``dataset/hadoop_seqfile.py``), each rank taking its round-robin share
of the files."""

from __future__ import annotations

from typing import Any, Iterator, List, Optional, Sequence

import numpy as np

from bigdl_tpu_torch.dataset.transformer import Transformer


class AbstractDataSet:
    def data(self, train: bool) -> Iterator[Any]:
        raise NotImplementedError

    def size(self) -> int:
        raise NotImplementedError

    def shuffle(self) -> None:
        """The reference hook; the port's datasets shuffle inside
        ``data(train=True)``, so it does nothing (as in JAX)."""

    def transform(self, transformer: Transformer) -> "AbstractDataSet":
        raise NotImplementedError


class LocalDataSet(AbstractDataSet):
    def __init__(self, data: Sequence[Any],
                 transformers: Optional[List[Transformer]] = None,
                 seed: int = 0) -> None:
        self._data = list(data)
        self._transformers = transformers or []
        self._seed = seed

    def size(self) -> int:
        return len(self._data)

    def transform(self, transformer: Transformer) -> "LocalDataSet":
        return type(self)(self._data, self._transformers + [transformer],
                          self._seed)

    __rshift__ = transform  # dataset >> transformer, mirroring `->`

    def _base_iter(self, train: bool) -> Iterator[Any]:
        if train:
            rng = np.random.RandomState(self._seed)
            n = len(self._data)
            while True:
                for i in rng.permutation(n):
                    yield self._data[i]
        else:
            yield from self._data

    def data(self, train: bool) -> Iterator[Any]:
        it: Iterator[Any] = self._base_iter(train)
        for t in self._transformers:
            it = t(it)
        return it


class DistributedDataSet(LocalDataSet):
    """This process's shard of the global data. ``partition_num`` is the
    reference's RDD partition count, here the number of processes, and
    ``partition_index`` this process's rank."""

    def __init__(self, data: Sequence[Any], transformers=None, seed: int = 0,
                 partition_num: int = 1, partition_index: int = 0) -> None:
        super().__init__(data, transformers, seed)
        self.partition_num = partition_num
        self.partition_index = partition_index

    def transform(self, transformer: Transformer) -> "DistributedDataSet":
        return DistributedDataSet(
            self._data, self._transformers + [transformer], self._seed,
            self.partition_num, self.partition_index)

    __rshift__ = transform


class _DataSetFactory:
    """``DataSet.array`` / ``DataSet.distributed`` (reference ``object
    DataSet``)."""

    @staticmethod
    def array(data: Sequence[Any], seed: int = 0) -> LocalDataSet:
        return LocalDataSet(data, seed=seed)

    @staticmethod
    def distributed(data: Sequence[Any], seed: int = 0) -> DistributedDataSet:
        """The global data → this rank's shard, ``data[rank::world]``."""
        from bigdl_tpu_torch.utils.engine import world_and_rank

        n, idx = world_and_rank()
        return DistributedDataSet(list(data)[idx::n], seed=seed,
                                  partition_num=n, partition_index=idx)

    rdd = distributed       # reference name: DataSet.rdd(...)

    @staticmethod
    def image_folder(path: str, **kwargs) -> LocalDataSet:
        """``image_folder_samples(path, **kwargs)`` as a local dataset."""
        from bigdl_tpu_torch.dataset.image import image_folder_samples

        return _DataSetFactory.array(image_folder_samples(path, **kwargs))

    @staticmethod
    def seq_file_folder(path: str, decoder=None, seed: int = 0,
                        format: str = "recs"):
        """Record-shard ingestion (reference ``DataSet.SeqFileFolder``):
        ``format="recs"`` reads RECS shards, ``"hadoop"`` Hadoop
        SequenceFiles (convert once with ``hadoop_seqfile.convert_to_recs``
        for the native indexer). ``decoder(label, payload)`` has the same
        signature for both (Hadoop's label comes from its Text, Int or
        Long key, its payload out of the BytesWritable). The files are
        split round-robin across the ``torch.distributed`` ranks."""
        from bigdl_tpu_torch.utils.engine import world_and_rank

        if format not in ("recs", "hadoop"):
            raise ValueError(
                f"unknown seq_file_folder format {format!r} — expected "
                "'recs' (native shards) or 'hadoop' (SequenceFiles)")
        world, rank = world_and_rank()
        if format == "hadoop":
            from bigdl_tpu_torch.dataset.hadoop_seqfile import (
                HadoopSeqFileDataSet,
            )

            return HadoopSeqFileDataSet(path, decoder=decoder, seed=seed,
                                        shard_index=rank, num_shards=world)
        from bigdl_tpu_torch.dataset.seqfile import SeqFileDataSet

        return SeqFileDataSet(path, decoder=decoder, seed=seed,
                              shard_index=rank, num_shards=world)


DataSet = _DataSetFactory()
