"""DataSet — local dataset (``bigdl_tpu/dataset/dataset.py``):
``DataSet.array`` → ``LocalDataSet`` with ``data(train=)`` iterators,
infinite and shuffled for training, one pass for evaluation. The
training shuffle is ``np.random.RandomState(seed).permutation``, one
draw per epoch, exactly as the JAX package draws it, so both packages
see the same batches in the same order. Distributed datasets come with
the data-parallel slice."""

from __future__ import annotations

from typing import Any, Iterator, List, Optional, Sequence

import numpy as np

from bigdl_tpu_torch.dataset.transformer import Transformer


class AbstractDataSet:
    def data(self, train: bool) -> Iterator[Any]:
        raise NotImplementedError

    def size(self) -> int:
        raise NotImplementedError

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


class _DataSetFactory:
    """``DataSet.array`` (reference ``object DataSet``)."""

    @staticmethod
    def array(data: Sequence[Any], seed: int = 0) -> LocalDataSet:
        return LocalDataSet(data, seed=seed)


DataSet = _DataSetFactory()
