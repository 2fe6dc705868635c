"""Activations the slices need (``bigdl_tpu/nn/activations.py``)."""

from __future__ import annotations

import torch

from bigdl_tpu_torch.nn.module import AbstractModule, TensorModule


class ReLU(TensorModule):
    """``max(x, 0)``. ``ip`` (in place) is accepted and ignored, as in the
    JAX package: an in-place ReLU on a tensor autograd saved for the
    backward would corrupt it."""

    def __init__(self, ip: bool = False) -> None:
        super().__init__()
        self.inplace = ip

    def forward(self, x):
        return torch.relu(x)


class LogSoftMax(AbstractModule):
    def forward(self, x):
        return torch.log_softmax(x, dim=-1)
