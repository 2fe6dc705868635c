"""Optimization side of the port (``bigdl_tpu.optim`` counterparts): the
optim methods, the train step, triggers and the local optimizer."""

from bigdl_tpu_torch.optim.optim_method import SGD, Adam, OptimMethod
from bigdl_tpu_torch.optim.optimizer import LocalOptimizer, Optimizer
from bigdl_tpu_torch.optim.trigger import Trigger

__all__ = ["Adam", "LocalOptimizer", "OptimMethod", "Optimizer", "SGD",
           "Trigger"]
