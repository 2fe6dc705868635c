"""Host-side input pipeline of the port (``bigdl_tpu.dataset``
counterparts): samples, minibatches, local datasets, the batching
transformer, the MNIST loader (``mnist``) and ``GreyImgNormalizer``."""

from bigdl_tpu_torch.dataset.dataset import DataSet, LocalDataSet
from bigdl_tpu_torch.dataset.image import GreyImgNormalizer
from bigdl_tpu_torch.dataset.sample import MiniBatch, Sample
from bigdl_tpu_torch.dataset.transformer import SampleToMiniBatch

__all__ = ["DataSet", "GreyImgNormalizer", "LocalDataSet", "MiniBatch",
           "Sample", "SampleToMiniBatch"]
