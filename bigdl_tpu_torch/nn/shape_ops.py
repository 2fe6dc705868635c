"""Shape and table layers (``bigdl_tpu/nn/shape_ops.py``): ``Reshape``,
``View``, ``Select``, ``Narrow``, ``Squeeze``, ``Unsqueeze``,
``Transpose``, ``Contiguous``, ``Padding``, the element-wise table ops
(``CAddTable``, ``CMulTable``, ``CSubTable``, ``CDivTable``,
``CMaxTable``, ``CMinTable``, ``CAveTable``), ``JoinTable``,
``SplitTable`` and ``FlattenTable``.

Dims and indices are 1-based like the reference, negative dims count
from the end, and a layer given ``n_input_dims`` treats a tensor with
more dims than that as batched: dim 1 is then its first non-batch axis
(:func:`_axis`, JAX's ``_axis``, ``:20``).
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.module import AbstractModule, TensorModule


def _axis(dim: int, ndim: int, n_input_dims: int = -1) -> int:
    """1-based reference dim → 0-based axis; with ``0 < n_input_dims <
    ndim`` the leading extra axes are batch axes, so dim 1 is the first
    axis after them."""
    if dim < 0:
        return ndim + dim
    ax = dim - 1
    if 0 < n_input_dims < ndim:
        ax += ndim - n_input_dims
    return ax


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


class View(TensorModule):
    """Reshape to ``sizes``, keeping a leading batch dim when the element
    count differs (``num_input_dims`` is kept and, as in JAX, unused)."""

    def __init__(self, *sizes: int) -> None:
        super().__init__()
        self.sizes = tuple(int(s) for s in sizes)
        self.num_input_dims = 0

    def set_num_input_dims(self, n: int) -> "View":
        self.num_input_dims = n
        return self

    def forward(self, x):
        if x.numel() != int(np.prod(self.sizes)):
            return x.reshape((x.shape[0],) + self.sizes)
        return x.reshape(self.sizes)


class Select(TensorModule):
    """Index ``index`` of dimension ``dim``, both 1-based, the dimension
    dropped; a negative ``index`` counts from the end (-1 the last), a
    negative ``dim`` from the last dimension (JAX's ``_axis``)."""

    def __init__(self, dim: int, index: int) -> None:
        super().__init__()
        self.dim = dim
        self.index = index

    def forward(self, x):
        ax = _axis(self.dim, x.dim())
        idx = self.index - 1 if self.index > 0 else x.shape[ax] + self.index
        return x.select(ax, idx)


class Narrow(TensorModule):
    """``length`` entries of ``dim`` from the 1-based ``offset`` (a
    negative offset counts from the end; a negative length ends that many
    entries before the end, -1 at the last)."""

    def __init__(self, dim: int, offset: int, length: int = 1) -> None:
        super().__init__()
        self.dim = dim
        self.offset = offset
        self.length = length

    def forward(self, x):
        ax = _axis(self.dim, x.dim())
        start = (self.offset - 1 if self.offset > 0
                 else x.shape[ax] + self.offset)
        length = self.length
        if length < 0:
            length = x.shape[ax] - start + 1 + length
        return x.narrow(ax, start, length)


class Squeeze(TensorModule):
    """Drop dim ``dim`` (1-based; every size-1 dim when ``None``)."""

    def __init__(self, dim: int = None, num_input_dims: int = -1) -> None:
        super().__init__()
        self.dim = dim
        self.num_input_dims = num_input_dims

    def forward(self, x):
        if self.dim is None:
            return torch.squeeze(x)
        return torch.squeeze(x, _axis(self.dim, x.dim(), self.num_input_dims))


class Unsqueeze(TensorModule):
    """Insert a size-1 dim at the 1-based position ``pos``."""

    def __init__(self, pos: int, num_input_dims: int = -1) -> None:
        super().__init__()
        self.pos = pos
        self.num_input_dims = num_input_dims

    def forward(self, x):
        ax = _axis(self.pos, x.dim() + 1,
                   self.num_input_dims + 1 if self.num_input_dims > 0 else -1)
        return torch.unsqueeze(x, ax)


class Transpose(TensorModule):
    """Swap the listed (1-based) dim pairs, in order."""

    def __init__(self, permutations: Sequence[Sequence[int]]) -> None:
        super().__init__()
        self.permutations = [tuple(p) for p in permutations]

    def forward(self, x):
        for d1, d2 in self.permutations:
            x = torch.transpose(x, _axis(d1, x.dim()), _axis(d2, x.dim()))
        return x


class Contiguous(TensorModule):
    """The identity on values (the reference's memory-layout op); returns
    a contiguous tensor."""

    def forward(self, x):
        return x.contiguous()


class Padding(TensorModule):
    """``|pad|`` entries of ``value`` along ``dim``: before the data for a
    negative ``pad``, after it for a positive one (``n_index`` is
    accepted and, as in JAX, unused)."""

    def __init__(self, dim: int, pad: int, n_input_dim: int,
                 value: float = 0.0, n_index: int = 1) -> None:
        super().__init__()
        self.dim = dim
        self.pad = pad
        self.n_input_dim = n_input_dim
        self.value = value

    def forward(self, x):
        ax = _axis(self.dim, x.dim(), self.n_input_dim)
        # F.pad lists (before, after) pairs from the last dim backwards
        pads = [0, 0] * (x.dim() - ax)
        pads[-2:] = [-self.pad, 0] if self.pad < 0 else [0, self.pad]
        return F.pad(x, pads, value=self.value)


# -- table (multi-input) arithmetic -----------------------------------------


class CAddTable(TensorModule):
    """Sum a list of tensors (the residual join of ResNet graphs)."""

    def __init__(self, inplace: bool = False) -> None:
        super().__init__()

    def forward(self, xs):
        out = xs[0]
        for x in xs[1:]:
            out = out + x
        return out


class CMulTable(TensorModule):
    def forward(self, xs):
        out = xs[0]
        for x in xs[1:]:
            out = out * x
        return out


class CSubTable(TensorModule):
    def forward(self, xs):
        return xs[0] - xs[1]


class CDivTable(TensorModule):
    def forward(self, xs):
        return xs[0] / xs[1]


class CMaxTable(TensorModule):
    """Element-wise max over a table (``torch.maximum``: ties split the
    gradient, as ``jnp.maximum``)."""

    def forward(self, xs):
        return functools.reduce(torch.maximum, xs)


class CMinTable(TensorModule):
    def forward(self, xs):
        return functools.reduce(torch.minimum, xs)


class CAveTable(TensorModule):
    """Element-wise mean over a table."""

    def forward(self, xs):
        return functools.reduce(lambda a, b: a + b, xs) / len(xs)


class JoinTable(TensorModule):
    """Concatenate a list along ``dimension`` (1-based, ``n_input_dims``
    batch rule)."""

    def __init__(self, dimension: int, n_input_dims: int = -1) -> None:
        super().__init__()
        self.dimension = dimension
        self.n_input_dims = n_input_dims

    def forward(self, xs):
        return torch.cat(list(xs), dim=_axis(self.dimension, xs[0].dim(),
                                             self.n_input_dims))


class SplitTable(TensorModule):
    """Split along ``dimension`` into a list, the dimension dropped."""

    def __init__(self, dimension: int, n_input_dims: int = -1) -> None:
        super().__init__()
        self.dimension = dimension
        self.n_input_dims = n_input_dims

    def forward(self, x):
        return list(torch.unbind(
            x, _axis(self.dimension, x.dim(), self.n_input_dims)))


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
