"""Layers of the port (``bigdl_tpu.nn`` counterparts), as ``nn.Module``s."""

from bigdl_tpu_torch.nn.activations import LogSoftMax, ReLU
from bigdl_tpu_torch.nn.attention import MultiHeadAttention
from bigdl_tpu_torch.nn.containers import Container, Sequential
from bigdl_tpu_torch.nn.conv import SpatialConvolution
from bigdl_tpu_torch.nn.criterion import (
    AbstractCriterion, ClassNLLCriterion, CrossEntropyCriterion,
    TimeDistributedCriterion,
)
from bigdl_tpu_torch.nn.criterion_more import (
    MaskedSoftmaxCECriterion, TimeDistributedMaskCriterion,
)
from bigdl_tpu_torch.nn.graph import Graph, Input, ModuleNode
from bigdl_tpu_torch.nn.init_methods import (
    ConstInitMethod, InitializationMethod, MsraFiller, Ones, RandomNormal,
    RandomUniform, Xavier, Zeros,
)
from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.misc import LookupTable
from bigdl_tpu_torch.nn.module import AbstractModule, Identity, TensorModule
from bigdl_tpu_torch.nn.normalization import (
    BatchNormalization, SpatialBatchNormalization,
)
from bigdl_tpu_torch.nn.pooling import SpatialAveragePooling, SpatialMaxPooling
from bigdl_tpu_torch.nn.shape_ops import CAddTable, Reshape

__all__ = ["AbstractModule", "TensorModule", "Identity", "Container",
           "Sequential", "Graph", "Input", "ModuleNode", "Linear",
           "LookupTable", "LogSoftMax", "ReLU", "MultiHeadAttention",
           "SpatialConvolution", "BatchNormalization",
           "SpatialBatchNormalization", "SpatialMaxPooling",
           "SpatialAveragePooling", "Reshape", "CAddTable",
           "InitializationMethod", "Zeros", "Ones", "ConstInitMethod",
           "RandomUniform", "RandomNormal", "Xavier", "MsraFiller",
           "AbstractCriterion", "ClassNLLCriterion", "CrossEntropyCriterion",
           "TimeDistributedCriterion", "TimeDistributedMaskCriterion",
           "MaskedSoftmaxCECriterion"]
