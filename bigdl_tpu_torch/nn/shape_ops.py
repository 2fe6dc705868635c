"""Shape and table layers (``bigdl_tpu/nn/shape_ops.py``): ``Reshape``
(``:32``), ``Select`` (``:69``), ``CAddTable`` (``:177``) and
``FlattenTable`` (``:263``)."""

from __future__ import annotations

from typing import Sequence

import numpy as np

from bigdl_tpu_torch.nn.module import AbstractModule, TensorModule


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


class Select(TensorModule):
    """Index ``index`` of dimension ``dim``, both 1-based, the dimension
    dropped; a negative ``index`` counts from the end (-1 the last), a
    negative ``dim`` from the last dimension (JAX's ``_axis``)."""

    def __init__(self, dim: int, index: int) -> None:
        super().__init__()
        self.dim = dim
        self.index = index

    def forward(self, x):
        ax = x.dim() + self.dim if self.dim < 0 else self.dim - 1
        idx = self.index - 1 if self.index > 0 else x.shape[ax] + self.index
        return x.select(ax, idx)


class CAddTable(TensorModule):
    """Sum a list of tensors (the residual join of ResNet graphs)."""

    def __init__(self, inplace: bool = False) -> None:
        super().__init__()

    def forward(self, xs):
        out = xs[0]
        for x in xs[1:]:
            out = out + x
        return out


class FlattenTable(AbstractModule):
    """A nested table (lists of lists of tensors) as one flat list, depth
    first (``Inception_v1``'s ``[[main, aux2], aux1]`` → three heads)."""

    def forward(self, xs):
        flat = []

        def rec(v):
            if isinstance(v, (list, tuple)):
                for u in v:
                    rec(u)
            else:
                flat.append(v)

        rec(xs)
        return flat
