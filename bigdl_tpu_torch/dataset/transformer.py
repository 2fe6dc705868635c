"""Transformer — composable iterator → iterator stages
(``bigdl_tpu/dataset/transformer.py``): compose with ``>>`` (or
``and_then``, the reference's ``->``) into a ``ChainedTransformer``;
``FnTransformer`` lifts a per-record function, ``Identity`` passes
records through, and ``SampleToMiniBatch`` is the batching stage."""

from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator

from bigdl_tpu_torch.dataset.sample import MiniBatch, Sample, stack_samples


class Transformer:
    def apply(self, it: Iterator[Any]) -> Iterator[Any]:
        raise NotImplementedError

    def __call__(self, it: Iterable[Any]) -> Iterator[Any]:
        return self.apply(iter(it))

    def and_then(self, other: "Transformer") -> "ChainedTransformer":
        return ChainedTransformer(self, other)

    __rshift__ = and_then  # `a >> b` mirrors the reference's `a -> b`


class ChainedTransformer(Transformer):
    def __init__(self, first: Transformer, second: Transformer) -> None:
        self.first = first
        self.second = second

    def apply(self, it: Iterator[Any]) -> Iterator[Any]:
        return self.second(self.first(it))


class FnTransformer(Transformer):
    """Lift a per-record function into a Transformer."""

    def __init__(self, fn: Callable[[Any], Any]) -> None:
        self.fn = fn

    def apply(self, it: Iterator[Any]) -> Iterator[Any]:
        for x in it:
            yield self.fn(x)


class Identity(Transformer):
    def apply(self, it: Iterator[Any]) -> Iterator[Any]:
        return it


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


SampleToBatch = SampleToMiniBatch  # early-reference alias
