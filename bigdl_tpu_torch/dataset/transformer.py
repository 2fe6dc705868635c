"""Transformer — composable iterator → iterator stages
(``bigdl_tpu/dataset/transformer.py``); ``SampleToMiniBatch`` is the
batching stage."""

from __future__ import annotations

from typing import Any, Iterable, Iterator

from bigdl_tpu_torch.dataset.sample import MiniBatch, Sample, stack_samples


class Transformer:
    def apply(self, it: Iterator[Any]) -> Iterator[Any]:
        raise NotImplementedError

    def __call__(self, it: Iterable[Any]) -> Iterator[Any]:
        return self.apply(iter(it))


class SampleToMiniBatch(Transformer):
    """Group a sample stream into MiniBatches of ``batch_size`` (reference
    ``SampleToMiniBatch``), dropping the trailing partial batch when
    ``drop_remainder`` (fixed shapes, as the JAX pipeline keeps them)."""

    def __init__(self, batch_size: int, drop_remainder: bool = True) -> None:
        self.batch_size = batch_size
        self.drop_remainder = drop_remainder

    def apply(self, it: Iterator[Sample]) -> Iterator[MiniBatch]:
        buf = []
        for s in it:
            buf.append(s)
            if len(buf) == self.batch_size:
                yield stack_samples(buf)
                buf = []
        if buf and not self.drop_remainder:
            yield stack_samples(buf)
