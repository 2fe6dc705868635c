"""Optimization side of the port (``bigdl_tpu.optim`` counterparts): the
optim methods and SGD's schedules, the train step, triggers, the local
optimizer (with ``TrainingPreempted``), the pinned batch upload,
validation methods, the evaluator and the regularizers."""

from bigdl_tpu_torch.optim.evaluator import (
    Evaluator, LocalPredictor, Predictor, Validator,
)
from bigdl_tpu_torch.optim.metrics import Metrics
from bigdl_tpu_torch.optim.optim_method import (
    SGD, Adagrad, Adam, Default, Exponential, LearningRateSchedule, MultiStep,
    OptimMethod, Plateau, Poly, SequentialSchedule, Step, Warmup,
)
from bigdl_tpu_torch.optim.optimizer import (
    LocalOptimizer, Optimizer, TrainingPreempted,
)
from bigdl_tpu_torch.optim.regularizer import (
    L1L2Regularizer, L1Regularizer, L2Regularizer,
)
from bigdl_tpu_torch.optim.trigger import Trigger
from bigdl_tpu_torch.optim.validation import (
    MAE, AccuracyResult, Loss, LossResult, Top1Accuracy, Top5Accuracy,
    ValidationMethod, ValidationResult,
)

__all__ = ["Adagrad", "Adam", "Default", "Exponential", "LearningRateSchedule",
           "MultiStep", "OptimMethod", "Plateau", "Poly",
           "SequentialSchedule", "SGD", "Step", "Warmup", "LocalOptimizer",
           "Optimizer", "TrainingPreempted", "Trigger", "Evaluator",
           "LocalPredictor",
           "Predictor", "Validator", "AccuracyResult", "Loss", "LossResult",
           "MAE", "Top1Accuracy", "Top5Accuracy", "ValidationMethod",
           "ValidationResult", "Metrics", "L1L2Regularizer", "L1Regularizer",
           "L2Regularizer"]
