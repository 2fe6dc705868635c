"""Host-side input pipeline of the port (``bigdl_tpu.dataset``
counterparts): samples, minibatches, local and distributed (per-rank)
datasets with the image-folder and record-shard factories, the
transformers and their chaining, the MNIST and CIFAR-10 loaders
(``mnist``, ``cifar``), the image transformers (``image``), the
image pipeline with the native f32 feed and the uint8 feed's on-device
normalizer (``native_pipeline``), RECS and Hadoop record shards
(``seqfile``, ``hadoop_seqfile``), and the text pipeline (``text``,
``news20``). The names exported here are the JAX package's, plus the
port's image pieces."""

from bigdl_tpu_torch.dataset.dataset import (
    AbstractDataSet, DataSet, DistributedDataSet, LocalDataSet,
)
from bigdl_tpu_torch.dataset.image import BGRImgNormalizer, GreyImgNormalizer
from bigdl_tpu_torch.dataset.native_pipeline import (
    DeviceImageNormalizer, NativeImagePipeline,
)
from bigdl_tpu_torch.dataset.sample import MiniBatch, Sample, stack_samples
from bigdl_tpu_torch.dataset.text import (
    Dictionary, LabeledSentence, LabeledSentenceToSample,
    SentenceToWordIndices, SequenceWindower, TextToLabeledSentence,
    simple_tokenize,
)
from bigdl_tpu_torch.dataset.transformer import (
    ChainedTransformer, FnTransformer, SampleToBatch, SampleToMiniBatch,
    Transformer,
)

__all__ = [
    "AbstractDataSet", "DataSet", "DistributedDataSet", "LocalDataSet",
    "MiniBatch", "Sample", "stack_samples", "ChainedTransformer",
    "FnTransformer", "SampleToBatch", "SampleToMiniBatch", "Transformer",
    "Dictionary", "LabeledSentence", "LabeledSentenceToSample",
    "SentenceToWordIndices", "SequenceWindower", "TextToLabeledSentence",
    "simple_tokenize", "BGRImgNormalizer", "DeviceImageNormalizer",
    "GreyImgNormalizer", "NativeImagePipeline",
]
