"""Activations the slice needs (``bigdl_tpu/nn/activations.py``)."""

from __future__ import annotations

import torch

from bigdl_tpu_torch.nn.module import AbstractModule


class LogSoftMax(AbstractModule):
    def forward(self, x):
        return torch.log_softmax(x, dim=-1)
