"""Host-side input pipeline of the port (``bigdl_tpu.dataset``
counterparts): samples, minibatches, local datasets, the batching
transformer, distributed (per-rank) datasets, the MNIST and CIFAR-10 loaders (``mnist``, ``cifar``), the
grey and BGR normalizers, the uint8-NHWC image pipeline with its
on-device normalizer (``native_pipeline``), and the text classifier's
tokenizer and ``Dictionary`` (``text``)."""

from bigdl_tpu_torch.dataset.dataset import (
    DataSet, DistributedDataSet, LocalDataSet,
)
from bigdl_tpu_torch.dataset.image import BGRImgNormalizer, GreyImgNormalizer
from bigdl_tpu_torch.dataset.native_pipeline import (
    DeviceImageNormalizer, NativeImagePipeline,
)
from bigdl_tpu_torch.dataset.sample import MiniBatch, Sample
from bigdl_tpu_torch.dataset.text import Dictionary, simple_tokenize
from bigdl_tpu_torch.dataset.transformer import SampleToMiniBatch

__all__ = ["BGRImgNormalizer", "DataSet", "DeviceImageNormalizer",
           "Dictionary", "DistributedDataSet", "simple_tokenize",
           "GreyImgNormalizer", "LocalDataSet", "MiniBatch",
           "NativeImagePipeline", "Sample", "SampleToMiniBatch"]
