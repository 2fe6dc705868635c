"""Sparse-input layers (``bigdl_tpu/nn/sparse.py``): ``SparseLinear``
(``:21``), ``SparseJoinTable`` (``:57``) and ``LookupTableSparse``
(``:75``), the wide half of a wide-and-deep model.

Inputs are fixed-capacity COO :class:`~bigdl_tpu_torch.tensor.sparse.
SparseTensor`s. ``SparseLinear`` is ``sparse_dense_matmul(x, W.T) + b``
(a gather of the weight's columns and an ``index_add`` over the batch
rows); ``LookupTableSparse`` is an embedding bag: the rows of its table
picked by 1-based ids (id 0, a padding slot, adds nothing), optionally
weighted by a second ``SparseTensor``'s values, summed per batch row and
divided by the weights' sum (``"mean"``) or the root of their squares'
sum (``"sqrtn"``), TF's ``embedding_lookup_sparse``. Autograd gives the
dense weight gradient, as JAX's autodiff does (for a table of
``n_index`` rows, a gradient tensor of the table's size). Weights are
f32 on ``device`` (default the CPU, as every layer; the model functions
resolve it) from ``generator``; the params trees are JAX's.
"""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch.nn.init_methods import InitializationMethod, RandomUniform
from bigdl_tpu_torch.nn.module import AbstractModule, new_param
from bigdl_tpu_torch.tensor.sparse import (
    SparseTensor, sparse_dense_matmul, sparse_join,
)


class SparseLinear(AbstractModule):
    """Linear over a sparse (B, in) activation; weight is dense (out, in)."""

    def __init__(self, input_size: int, output_size: int,
                 with_bias: bool = True,
                 init_weight: Optional[InitializationMethod] = None,
                 init_bias: Optional[InitializationMethod] = None,
                 device=None, generator: torch.Generator = None) -> None:
        super().__init__()
        self.input_size = input_size
        self.output_size = output_size
        self.with_bias = with_bias
        self.weight_init = init_weight or RandomUniform()
        self.bias_init = init_bias or RandomUniform()
        self.weight = new_param((output_size, input_size), device,
                                lambda t: self.weight_init.fill(t, generator))
        if with_bias:
            self.bias = new_param((output_size,), device,
                                  lambda t: self.bias_init.fill(t, generator))
        else:
            self.register_parameter("bias", None)

    def forward(self, x):
        if not isinstance(x, SparseTensor):
            raise TypeError("SparseLinear wants a SparseTensor input")
        out = sparse_dense_matmul(x, self.weight.T)
        return out + self.bias if self.with_bias else out

    def extra_repr(self) -> str:
        return f"{self.input_size} -> {self.output_size}"


class SparseJoinTable(AbstractModule):
    """Concatenate sparse inputs along ``dimension`` (1-based; 2 is the
    feature dim)."""

    def __init__(self, dimension: int = 2) -> None:
        super().__init__()
        self.dimension = dimension

    def forward(self, x):
        if not (isinstance(x, (list, tuple))
                and all(isinstance(t, SparseTensor) for t in x)):
            raise TypeError("SparseJoinTable wants a Table of SparseTensors")
        return sparse_join(list(x), self.dimension)

    def extra_repr(self) -> str:
        return f"dim={self.dimension}"


class LookupTableSparse(AbstractModule):
    """Embedding bag over a ``SparseTensor`` of 1-based ids shaped
    (batch, max_ids), or a table ``[ids, weights]`` of two such tensors
    laid out alike, reduced per row by ``combiner`` (``"sum"``,
    ``"mean"`` or ``"sqrtn"``)."""

    def __init__(self, n_index: int, n_output: int, combiner: str = "sum",
                 init_weight: Optional[InitializationMethod] = None,
                 device=None, generator: torch.Generator = None) -> None:
        super().__init__()
        if combiner not in ("sum", "mean", "sqrtn"):
            raise ValueError(f"combiner {combiner!r} is not sum, mean or "
                             "sqrtn")
        self.n_index = n_index
        self.n_output = n_output
        self.combiner = combiner
        self.weight_init = init_weight or RandomUniform()
        self.weight = new_param((n_index, n_output), device,
                                lambda t: self.weight_init.fill(t, generator))

    def forward(self, x):
        if isinstance(x, (list, tuple)):
            ids_sp, weights = x[0], x[1].values
        else:
            ids_sp, weights = x, None
        if not isinstance(ids_sp, SparseTensor):
            raise TypeError("LookupTableSparse wants a SparseTensor of ids")
        rows = ids_sp.indices[0]
        # float ids truncate, as JAX's astype(int32)
        ids = ids_sp.values.to(torch.int32).long()
        valid = (ids > 0).to(self.weight.dtype)
        w = valid if weights is None else weights * valid
        emb = self.weight[torch.clamp(ids - 1, min=0)]      # (cap, dim)
        batch = ids_sp.shape[0]
        out = emb.new_zeros((batch, self.n_output)).index_add(
            0, rows, emb * w[:, None])
        if self.combiner == "sum":
            return out
        if self.combiner == "mean":
            denom = w.new_zeros((batch,)).index_add(0, rows, w)
        else:
            denom = torch.sqrt(w.new_zeros((batch,)).index_add(0, rows,
                                                                w * w))
        return out / torch.maximum(denom, denom.new_tensor(1e-12))[:, None]

    def extra_repr(self) -> str:
        return f"{self.n_index} x {self.n_output}, {self.combiner}"
