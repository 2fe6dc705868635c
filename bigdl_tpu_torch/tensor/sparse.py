"""SparseTensor — the fixed-capacity COO tensor of the sparse layers
(``bigdl_tpu/tensor/sparse.py``).

A ``SparseTensor`` is ``(indices (ndim, capacity), values (capacity,),
shape)``: every stored element is one column of ``indices`` and its
value, and unused slots are padding, with value 0 and index 0 on every
dim. Padding adds exactly zero to every product below (``0 * dense[0]``),
so a batch of rows with different nonzero counts shares one capacity.
``indices`` are ``int64`` (torch's index type; JAX keeps ``int32``) on
the values' device.

Every product is a gather and an ``index_add`` over the rows, where JAX
uses ``segment_sum``: ``sparse_dense_matmul`` gathers ``dense[cols]``,
scales each row by its value and adds it into its output row. Autograd
differentiates through ``values`` and the dense operand, as JAX's
autodiff does. On the card ``index_add`` accumulates with atomics, so
its summation order (and the last bits of a row with several entries)
may differ from run to run; duplicate indices accumulate.

``from_dense`` and ``nnz`` count the nonzeros, which is one host read
on the card (JAX's ``from_dense`` is host-side numpy); every other
method keeps the capacity and needs no host read. ``to(device)`` moves
the tensor, as ``jax.device_put`` moves JAX's registered pytree.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch


def _two_d(sp, what: str) -> None:
    if sp.dim() != 2:
        raise ValueError(f"{what} wants a 2-D SparseTensor, not {sp.shape}")


def _tensor(x, dtype=None, device=None) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
    return t.to(device=device, dtype=dtype or t.dtype)


class SparseTensor:
    """Fixed-capacity COO sparse tensor."""

    __slots__ = ("indices", "values", "shape")

    def __init__(self, indices, values, shape: Sequence[int]) -> None:
        self.values = _tensor(values)                           # (cap,)
        self.indices = _tensor(indices, torch.int64,
                               self.values.device)              # (ndim, cap)
        self.shape = tuple(int(s) for s in shape)
        if self.indices.dim() != 2 or self.indices.shape[0] != len(self.shape):
            raise ValueError(f"indices {tuple(self.indices.shape)} are not "
                             f"(ndim, capacity) for shape {self.shape}")

    # -- constructors ------------------------------------------------------

    @staticmethod
    def from_dense(dense, capacity: Optional[int] = None) -> "SparseTensor":
        """Keep the nonzeros of ``dense`` (a tensor, on any device, or an
        array), padded to ``capacity`` slots; counting them is one host
        read on the card."""
        arr = _tensor(dense)
        idx = torch.nonzero(arr).T                              # (ndim, nnz)
        nnz = int(idx.shape[1])
        cap = capacity if capacity is not None else max(nnz, 1)
        if cap < nnz:
            raise ValueError(f"capacity {cap} < nnz {nnz}")
        indices = torch.zeros((arr.dim(), cap), dtype=torch.int64,
                              device=arr.device)
        values = torch.zeros((cap,), dtype=arr.dtype, device=arr.device)
        indices[:, :nnz] = idx
        values[:nnz] = arr[tuple(idx)]
        return SparseTensor(indices, values, arr.shape)

    @staticmethod
    def coo(indices, values, shape) -> "SparseTensor":
        """From ``(nnz, ndim)`` coordinates, the transpose of ``indices``."""
        return SparseTensor(_tensor(indices).T, values, shape)

    # -- meta --------------------------------------------------------------

    def nnz(self) -> int:
        """Number of stored nonzeros (padding slots hold value 0)."""
        return int(torch.count_nonzero(self.values))

    def capacity(self) -> int:
        return int(self.values.shape[0])

    def dim(self) -> int:
        return len(self.shape)

    def size(self, d: Optional[int] = None):
        return self.shape if d is None else self.shape[d - 1]  # 1-based

    @property
    def device(self) -> torch.device:
        return self.values.device

    def to(self, device) -> "SparseTensor":
        return SparseTensor(self.indices.to(device), self.values.to(device),
                            self.shape)

    # -- conversions -------------------------------------------------------

    def to_dense(self) -> torch.Tensor:
        """Scatter-add into a dense tensor."""
        out = torch.zeros(self.shape, dtype=self.values.dtype,
                          device=self.values.device)
        return out.index_put(tuple(self.indices), self.values,
                             accumulate=True)

    def astype(self, dtype) -> "SparseTensor":
        return SparseTensor(self.indices, self.values.to(dtype), self.shape)

    # -- math (reference SparseTensorMath surface: fixed capacity in,
    # fixed capacity or dense out) -----------------------------------------

    def t(self) -> "SparseTensor":
        """2-D transpose: swap index rows (no data movement)."""
        _two_d(self, "t")
        return SparseTensor(torch.flip(self.indices, (0,)), self.values,
                            self.shape[::-1])

    def mul(self, scalar) -> "SparseTensor":
        return SparseTensor(self.indices, self.values * scalar, self.shape)

    def div(self, scalar) -> "SparseTensor":
        return SparseTensor(self.indices, self.values / scalar, self.shape)

    def sum(self, dim: Optional[int] = None):
        """Scalar total, or reduce OVER the 1-based ``dim`` (the dense
        ``Tensor.sum``'s dim): the 2-D result is the dense vector indexed
        by the OTHER axis."""
        if dim is None:
            return torch.sum(self.values)
        _two_d(self, "sum(dim)")
        if dim not in (1, 2):
            raise ValueError(f"invalid 1-based dim {dim} for 2-D sparse")
        kept = 1 - (dim - 1)
        out = self.values.new_zeros((self.shape[kept],))
        return out.index_add(0, self.indices[kept], self.values)

    def narrow(self, dim: int, start: int, length: int) -> "SparseTensor":
        """1-based narrow along ``dim`` (reference mini-batch slicing):
        out-of-range slots become padding (capacity kept)."""
        d = dim - 1
        s0 = start - 1
        keep = (self.indices[d] >= s0) & (self.indices[d] < s0 + length)
        values = torch.where(keep, self.values, self.values.new_zeros(()))
        # dropped slots reset to index 0 on EVERY dim (the padding
        # invariant), live slots shift by the narrow offset on dim d only
        idx = torch.where(keep[None, :], self.indices,
                          self.indices.new_zeros(()))
        idx[d] -= keep.to(idx.dtype) * s0
        shape = list(self.shape)
        shape[d] = length
        return SparseTensor(idx, values, shape)

    def cmul_dense(self, dense) -> "SparseTensor":
        """Elementwise multiply by a dense tensor (stays sparse)."""
        dense = _tensor(dense, device=self.device)
        return SparseTensor(self.indices,
                            self.values * dense[tuple(self.indices)],
                            self.shape)

    def vdot(self, dense) -> Any:
        """⟨self, dense⟩: sum of values times gathered dense entries."""
        dense = _tensor(dense, device=self.device)
        return torch.sum(self.values * dense[tuple(self.indices)])

    def mm(self, dense) -> torch.Tensor:
        """``self (B, D) @ dense (D, O)`` → dense (B, O)."""
        return sparse_dense_matmul(self, dense)

    def mv(self, vec) -> torch.Tensor:
        """``self (B, D) @ vec (D,)`` → dense (B,)."""
        vec = _tensor(vec, device=self.device)
        return sparse_dense_matmul(self, vec[:, None])[:, 0]

    def add_to_dense(self, dense) -> torch.Tensor:
        """``dense + self`` as a dense tensor (scatter-add)."""
        dense = _tensor(dense, device=self.device)
        return dense.index_put(tuple(self.indices), self.values,
                               accumulate=True)

    def __repr__(self) -> str:
        return (f"SparseTensor(shape={self.shape}, capacity="
                f"{int(self.values.shape[0])})")


def sparse_dense_matmul(sp: SparseTensor, dense) -> torch.Tensor:
    """``sp (B, D) @ dense (D, O) -> (B, O)``: each stored element (b, d,
    v) adds ``v * dense[d]`` to row b (a gather and an ``index_add``,
    JAX's gather and ``segment_sum``); padding slots add zero rows."""
    _two_d(sp, "sparse_dense_matmul")
    dense = _tensor(dense, device=sp.device)
    rows, cols = sp.indices[0], sp.indices[1]
    contrib = sp.values[:, None] * dense[cols]          # (cap, O)
    out = contrib.new_zeros((sp.shape[0], contrib.shape[1]))
    return out.index_add(0, rows, contrib)


def sparse_addmm(beta, c, alpha, sp: SparseTensor, dense) -> torch.Tensor:
    """``beta * c + alpha * (sp @ dense)`` (reference
    ``SparseTensorMath.addmm``)."""
    return beta * _tensor(c, device=sp.device) + alpha * sparse_dense_matmul(
        sp, dense)


def sparse_addmv(beta, y, alpha, sp: SparseTensor, x) -> torch.Tensor:
    """``beta * y + alpha * (sp @ x)`` (reference
    ``SparseTensorMath.addmv``)."""
    return beta * _tensor(y, device=sp.device) + alpha * sp.mv(x)


def dense_sparse_matmul(dense, sp: SparseTensor) -> torch.Tensor:
    """``dense (N, B) @ sp (B, D)`` → dense (N, D), as ``(spᵀ @
    denseᵀ)ᵀ`` so one product serves both orientations (reference
    SparseTensorBLAS dense×sparse path)."""
    dense = _tensor(dense, device=sp.device)
    return sparse_dense_matmul(sp.t(), dense.T).T


def sparse_join(tensors: Sequence[SparseTensor], dim: int = 2
                ) -> SparseTensor:
    """Concatenate 2-D sparse tensors along the feature dim (1-based
    ``dim=2``, the reference SparseJoinTable's case) or the batch dim
    (``dim=1``); padding slots stay at index 0."""
    for t in tensors:
        _two_d(t, "sparse_join")
    axis = dim - 1
    offs, off = [], 0
    for t in tensors:
        offs.append(off)
        off += t.shape[axis]
    fixed = 1 - axis
    base = tensors[0].shape[fixed]
    if any(t.shape[fixed] != base for t in tensors):
        raise ValueError(f"sparse_join along dim {dim}: shapes "
                         f"{[t.shape for t in tensors]} differ on the other")
    idx_parts, val_parts = [], []
    for t, o in zip(tensors, offs):
        shifted = t.indices.clone()
        shifted[axis] += (t.values != 0).to(shifted.dtype) * o
        idx_parts.append(shifted)
        val_parts.append(t.values)
    shape = list(tensors[0].shape)
    shape[axis] = off
    return SparseTensor(torch.cat(idx_parts, 1), torch.cat(val_parts), shape)
