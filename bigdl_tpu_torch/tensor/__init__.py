"""Tensors of the port (``bigdl_tpu.tensor`` counterparts): the
fixed-capacity COO :class:`SparseTensor` and its products. The dense
``Tensor`` facade (``bigdl_tpu/tensor/tensor.py``) is not ported yet."""

from bigdl_tpu_torch.tensor.sparse import (
    SparseTensor, sparse_dense_matmul, sparse_join,
)

__all__ = ["SparseTensor", "sparse_dense_matmul", "sparse_join"]
