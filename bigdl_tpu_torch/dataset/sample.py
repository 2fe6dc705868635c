"""Sample / MiniBatch (``bigdl_tpu/dataset/sample.py``): the unit records
of the input pipeline, numpy on the host. The optimizer moves each
``MiniBatch`` to the card."""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np


def _to_np(x) -> np.ndarray:
    if isinstance(x, np.ndarray):
        return x
    if hasattr(x, "detach"):               # a torch tensor
        return x.detach().cpu().numpy()
    return np.asarray(x)


class Sample:
    """One training record: feature array(s) + label array(s)."""

    def __init__(self, features: Any, labels: Any) -> None:
        self._multi_feature = isinstance(features, (list, tuple))
        self.features = ([_to_np(f) for f in features]
                         if self._multi_feature else [_to_np(features)])
        self.labels = ([_to_np(lb) for lb in labels]
                       if isinstance(labels, (list, tuple))
                       else [_to_np(labels)])

    def feature(self, i: int = 0) -> np.ndarray:
        return self.features[i]

    def label(self, i: int = 0) -> np.ndarray:
        return self.labels[i]

    def __repr__(self) -> str:
        fs = ",".join(str(f.shape) for f in self.features)
        ls = ",".join(str(lb.shape) for lb in self.labels)
        return f"Sample(features=[{fs}], labels=[{ls}])"


class MiniBatch:
    """A batched group of samples: stacked input + target arrays."""

    def __init__(self, input: Any, target: Any = None) -> None:
        self.input = input
        self.target = target

    def size(self) -> int:
        x = self.input[0] if isinstance(self.input, (list, tuple)) else self.input
        return x.shape[0]

    def get_input(self):
        return self.input

    def get_target(self):
        return self.target

    def __repr__(self) -> str:
        return f"MiniBatch(size={self.size()})"


def stack_samples(samples: Sequence[Sample]) -> MiniBatch:
    """Stack samples into one MiniBatch (the SampleToMiniBatch kernel)."""
    n_feat = len(samples[0].features)
    n_lab = len(samples[0].labels)
    feats = [np.stack([s.features[i] for s in samples]) for i in range(n_feat)]
    labs = [np.stack([s.labels[i] for s in samples]) for i in range(n_lab)]
    return MiniBatch(feats[0] if n_feat == 1 else feats,
                     labs[0] if n_lab == 1 else labs)
