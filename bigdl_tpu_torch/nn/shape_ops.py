"""Shape and table layers (``bigdl_tpu/nn/shape_ops.py``): ``Reshape``
(``:32``) and ``CAddTable`` (``:177``)."""

from __future__ import annotations

from typing import Sequence

import numpy as np

from bigdl_tpu_torch.nn.module import TensorModule


class Reshape(TensorModule):
    """Reshape the non-batch dims to ``size``; ``batch_mode=None`` keeps a
    leading batch dim when the element count differs from ``size``'s."""

    def __init__(self, size: Sequence[int], batch_mode: bool = None) -> None:
        super().__init__()
        self.size = tuple(int(s) for s in size)
        self.batch_mode = batch_mode
        self._n_element = int(np.prod(self.size))

    def forward(self, x):
        batch = self.batch_mode
        if batch is None:
            batch = x.numel() != self._n_element
        if batch:
            return x.reshape((x.shape[0],) + self.size)
        return x.reshape(self.size)


class CAddTable(TensorModule):
    """Sum a list of tensors (the residual join of ResNet graphs)."""

    def __init__(self, inplace: bool = False) -> None:
        super().__init__()

    def forward(self, xs):
        out = xs[0]
        for x in xs[1:]:
            out = out + x
        return out
