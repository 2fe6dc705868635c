"""Layers of the port (``bigdl_tpu.nn`` counterparts), as ``nn.Module``s."""

from bigdl_tpu_torch.nn.activations import LogSoftMax
from bigdl_tpu_torch.nn.attention import MultiHeadAttention
from bigdl_tpu_torch.nn.containers import Container, Sequential
from bigdl_tpu_torch.nn.criterion import (
    AbstractCriterion, ClassNLLCriterion, CrossEntropyCriterion,
    TimeDistributedCriterion,
)
from bigdl_tpu_torch.nn.criterion_more import (
    MaskedSoftmaxCECriterion, TimeDistributedMaskCriterion,
)
from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.misc import LookupTable
from bigdl_tpu_torch.nn.module import AbstractModule

__all__ = ["AbstractModule", "Container", "Sequential", "Linear",
           "LookupTable", "LogSoftMax", "MultiHeadAttention",
           "AbstractCriterion", "ClassNLLCriterion", "CrossEntropyCriterion",
           "TimeDistributedCriterion", "TimeDistributedMaskCriterion",
           "MaskedSoftmaxCECriterion"]
