"""Layers of the port (``bigdl_tpu.nn`` counterparts), as ``nn.Module``s."""

from bigdl_tpu_torch.nn.activations import LogSoftMax, ReLU, Tanh
from bigdl_tpu_torch.nn.attention import MultiHeadAttention
from bigdl_tpu_torch.nn.beam_search import SequenceBeamSearch, beam_search
from bigdl_tpu_torch.nn.containers import (
    Concat, ConcatTable, Container, Remat, Sequential,
)
from bigdl_tpu_torch.nn.conv import SpatialConvolution
from bigdl_tpu_torch.nn.criterion import (
    AbstractCriterion, ClassNLLCriterion, CrossEntropyCriterion,
    ParallelCriterion, TimeDistributedCriterion,
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
from bigdl_tpu_torch.nn.misc import Dropout, LookupTable
from bigdl_tpu_torch.nn.module import AbstractModule, Identity, TensorModule
from bigdl_tpu_torch.nn.normalization import (
    BatchNormalization, SpatialBatchNormalization, SpatialCrossMapLRN,
)
from bigdl_tpu_torch.nn.pooling import SpatialAveragePooling, SpatialMaxPooling
from bigdl_tpu_torch.nn.quantized import (
    QuantizedLinear, QuantizedSpatialConvolution, Quantizer,
    quantize_symmetric,
)
from bigdl_tpu_torch.nn.recurrent import LSTM, BiRecurrent, Cell, Recurrent
from bigdl_tpu_torch.nn.shape_ops import (
    CAddTable, FlattenTable, Reshape, Select,
)

__all__ = ["AbstractModule", "TensorModule", "Identity", "Container",
           "Sequential", "Concat", "ConcatTable", "Remat", "Graph", "Input",
           "ModuleNode", "Linear", "LookupTable", "Dropout", "LogSoftMax",
           "ReLU", "Tanh", "MultiHeadAttention", "SpatialConvolution",
           "BatchNormalization", "SpatialBatchNormalization",
           "SpatialCrossMapLRN", "SpatialMaxPooling",
           "SpatialAveragePooling", "Reshape", "Select", "CAddTable",
           "FlattenTable", "Cell", "LSTM", "Recurrent", "BiRecurrent",
           "InitializationMethod", "Zeros", "Ones", "ConstInitMethod",
           "RandomUniform", "RandomNormal", "Xavier", "MsraFiller",
           "AbstractCriterion", "ClassNLLCriterion", "CrossEntropyCriterion",
           "ParallelCriterion", "TimeDistributedCriterion",
           "TimeDistributedMaskCriterion", "MaskedSoftmaxCECriterion",
           "SequenceBeamSearch", "beam_search", "QuantizedLinear",
           "QuantizedSpatialConvolution", "Quantizer", "quantize_symmetric"]
