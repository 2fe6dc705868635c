"""Image transformers (``bigdl_tpu/dataset/image.py``): the port has
``GreyImgNormalizer`` (``:23``), the MNIST pipeline's, and
``BGRImgNormalizer`` (``:35``), the CIFAR one's. Host-side numpy on
``Sample(feature=(C, H, W) float32, label)``; the other transformers come
with the host data plane."""

from __future__ import annotations

from typing import Iterator

import numpy as np

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


class BGRImgNormalizer(Transformer):
    """Per-channel (x - mean) / std on channels-first images (reference
    CIFAR/ImageNet pipelines)."""

    def __init__(self, means, stds) -> None:
        self.means = np.asarray(means, np.float32).reshape(-1, 1, 1)
        self.stds = np.asarray(stds, np.float32).reshape(-1, 1, 1)

    def apply(self, it: Iterator[Sample]) -> Iterator[Sample]:
        for s in it:
            yield Sample((s.feature() - self.means) / self.stds, s.labels[0])
