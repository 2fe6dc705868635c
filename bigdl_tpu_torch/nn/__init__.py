"""Layers of the port (``bigdl_tpu.nn`` counterparts), as ``nn.Module``s."""

from bigdl_tpu_torch.nn.activations import (
    ELU, GELU, HardTanh, LeakyReLU, LogSoftMax, PReLU, ReLU, ReLU6, Sigmoid,
    SoftMax, SoftPlus, SoftSign, Tanh,
)
from bigdl_tpu_torch.nn.attention import MultiHeadAttention
from bigdl_tpu_torch.nn.beam_search import SequenceBeamSearch, beam_search
from bigdl_tpu_torch.nn.containers import (
    Bottle, Concat, ConcatTable, Container, MapTable, ParallelTable, Remat,
    Sequential,
)
from bigdl_tpu_torch.nn.conv import SpatialConvolution, SpatialFullConvolution
from bigdl_tpu_torch.nn.criterion import (
    AbsCriterion, AbstractCriterion, BCECriterion, ClassNLLCriterion,
    CrossEntropyCriterion, DistKLDivCriterion, MarginCriterion, MSECriterion,
    MultiLabelSoftMarginCriterion, ParallelCriterion, SmoothL1Criterion,
    TimeDistributedCriterion,
)
from bigdl_tpu_torch.nn.criterion_more import (
    CategoricalCrossEntropy, KullbackLeiblerDivergenceCriterion,
    L1HingeEmbeddingCriterion, MaskedSoftmaxCECriterion,
    MeanAbsolutePercentageCriterion, MeanSquaredLogarithmicCriterion,
    PoissonCriterion, TimeDistributedMaskCriterion,
)
from bigdl_tpu_torch.nn.graph import Graph, Input, ModuleNode
from bigdl_tpu_torch.nn.init_methods import (
    BilinearFiller, ConstInitMethod, InitializationMethod, MsraFiller, Ones,
    RandomNormal, RandomUniform, Xavier, Zeros,
)
from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.misc import (
    MM, MV, Abs, Add, AddConstant, CAdd, Clamp, CMul, Dropout, Exp, Log,
    LookupTable, Max, Mean, Min, Mul, MulConstant, Power, Sqrt, Square, Sum,
)
from bigdl_tpu_torch.nn.module import (
    AbstractModule, Echo, Identity, TensorModule,
)
from bigdl_tpu_torch.nn.normalization import (
    BatchNormalization, Normalize, SpatialBatchNormalization,
    SpatialCrossMapLRN,
)
from bigdl_tpu_torch.nn.pooling import SpatialAveragePooling, SpatialMaxPooling
from bigdl_tpu_torch.nn.quantized import (
    QuantizedLinear, QuantizedSpatialConvolution, Quantizer,
    quantize_symmetric,
)
from bigdl_tpu_torch.nn.recurrent import LSTM, BiRecurrent, Cell, Recurrent
from bigdl_tpu_torch.nn.shape_ops import (
    CAddTable, CAveTable, CDivTable, CMaxTable, CMinTable, CMulTable,
    Contiguous, CSubTable, FlattenTable, JoinTable, Narrow, Padding, Reshape,
    Select, SplitTable, Squeeze, Transpose, Unsqueeze, View,
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
           "QuantizedSpatialConvolution", "Quantizer", "quantize_symmetric",
           # activations, misc, shape/table ops, containers, criteria
           "ELU", "GELU", "HardTanh", "LeakyReLU", "PReLU", "ReLU6",
           "Sigmoid", "SoftMax", "SoftPlus", "SoftSign", "MM", "MV", "Abs",
           "Add", "AddConstant", "CAdd", "Clamp", "CMul", "Exp", "Log",
           "Max", "Mean", "Min", "Mul", "MulConstant", "Power", "Sqrt",
           "Square", "Sum", "CAveTable", "CDivTable", "CMaxTable",
           "CMinTable", "CMulTable", "Contiguous", "CSubTable", "JoinTable",
           "Narrow", "Padding", "SplitTable", "Squeeze", "Transpose",
           "Unsqueeze", "View", "Bottle", "MapTable", "ParallelTable",
           "SpatialFullConvolution", "Normalize", "BilinearFiller", "Echo",
           "AbsCriterion", "BCECriterion", "DistKLDivCriterion",
           "MarginCriterion", "MSECriterion", "MultiLabelSoftMarginCriterion",
           "SmoothL1Criterion", "CategoricalCrossEntropy",
           "KullbackLeiblerDivergenceCriterion", "L1HingeEmbeddingCriterion",
           "MeanAbsolutePercentageCriterion",
           "MeanSquaredLogarithmicCriterion", "PoissonCriterion"]
