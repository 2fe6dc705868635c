"""TensorBoard summaries of the port (``bigdl_tpu.visualization``
counterparts): a hand-rolled TF event-file writer and reader (no
TensorFlow dependency), ``TrainSummary`` and ``ValidationSummary``."""

from bigdl_tpu_torch.visualization.summary import (
    Summary, TrainSummary, ValidationSummary,
)
from bigdl_tpu_torch.visualization.tensorboard import FileWriter, read_scalars

__all__ = ["FileWriter", "read_scalars", "Summary", "TrainSummary",
           "ValidationSummary"]
