"""Activations the slices need (``bigdl_tpu/nn/activations.py``)."""

from __future__ import annotations

import torch

from bigdl_tpu_torch.nn.module import AbstractModule, TensorModule


class ReLU(TensorModule):
    """``max(x, 0)``, with the JAX package's gradient (``jnp.maximum``):
    half the incoming gradient where x is exactly 0, a tie, where
    ``torch.relu`` passes none. Exact zeros are common in ResNets: the
    zero-padded channels of a type-A shortcut, and a zero-initialized
    BN's output added to a ReLU'd identity. ``ip`` (in place) is accepted
    and ignored, as in the JAX package: an in-place ReLU on a tensor
    autograd saved for the backward would corrupt it."""

    def __init__(self, ip: bool = False) -> None:
        super().__init__()
        self.inplace = ip

    def forward(self, x):
        return torch.maximum(x, x.new_zeros(()))


class Tanh(TensorModule):
    """``tanh(x)`` (``bigdl_tpu/nn/activations.py:36``)."""

    def forward(self, x):
        return torch.tanh(x)


class LogSoftMax(AbstractModule):
    def forward(self, x):
        return torch.log_softmax(x, dim=-1)
