"""Image transformers (``bigdl_tpu/dataset/image.py``): the port has
``GreyImgNormalizer`` (``:23``), the MNIST pipeline's. Host-side numpy on
``Sample(feature=(C, H, W) float32, label)``; the other transformers come
with the host data plane."""

from __future__ import annotations

from typing import Iterator

from bigdl_tpu_torch.dataset.sample import Sample
from bigdl_tpu_torch.dataset.transformer import Transformer


class GreyImgNormalizer(Transformer):
    """(x - mean) / std on single-channel images (reference MNIST pipeline)."""

    def __init__(self, mean: float, std: float) -> None:
        self.mean = mean
        self.std = std

    def apply(self, it: Iterator[Sample]) -> Iterator[Sample]:
        for s in it:
            yield Sample((s.feature() - self.mean) / self.std, s.labels[0])
