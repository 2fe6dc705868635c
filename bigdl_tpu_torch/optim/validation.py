"""ValidationMethods and their results (``bigdl_tpu/optim/validation.py``):
``Top1Accuracy``, ``Top5Accuracy``, ``Loss`` and ``MAE``;
``AccuracyResult``/``LossResult`` merge with ``+``. Labels are 1-based,
as the criteria take them.

A method takes the model's output as a tensor (on the card or the CPU)
and the batch's target as the host array the data pipeline made. The
accuracies rank on the host with numpy, as the JAX methods do, so ties
break the same way; ``Loss`` runs its criterion where the output lies.
One process drives the card, so ``merge_across_processes`` returns the
result unchanged (the pod merge comes with the data-parallel slice).
"""

from __future__ import annotations

import numpy as np
import torch


def to_host(x) -> np.ndarray:
    """A tensor (reduced floats as f32) or array-like as a host array."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.is_floating_point() and x.dtype != torch.float64:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


class ValidationResult:
    def result(self):
        raise NotImplementedError

    def __add__(self, other):
        raise NotImplementedError

    def merge_across_processes(self) -> "ValidationResult":
        """The sum over every process of a pod; one process here."""
        return self


class AccuracyResult(ValidationResult):
    def __init__(self, correct: int, count: int) -> None:
        self.correct = int(correct)
        self.count = int(count)

    def result(self):
        acc = self.correct / self.count if self.count else 0.0
        return acc, self.count

    def __add__(self, other: "AccuracyResult") -> "AccuracyResult":
        return AccuracyResult(self.correct + other.correct,
                              self.count + other.count)

    def __repr__(self) -> str:
        acc, n = self.result()
        return (f"Accuracy(correct={self.correct}, count={n}, "
                f"accuracy={acc:.4f})")


class LossResult(ValidationResult):
    def __init__(self, loss: float, count: int) -> None:
        self.loss = float(loss)
        self.count = int(count)

    def result(self):
        mean = self.loss / self.count if self.count else 0.0
        return mean, self.count

    def __add__(self, other: "LossResult") -> "LossResult":
        return LossResult(self.loss + other.loss, self.count + other.count)

    def __repr__(self) -> str:
        mean, n = self.result()
        return f"Loss(mean={mean:.4f}, count={n})"


class ValidationMethod:
    name = "ValidationMethod"

    def apply(self, output, target) -> ValidationResult:
        raise NotImplementedError

    __call__ = apply

    def __repr__(self) -> str:
        return self.name


class Top1Accuracy(ValidationMethod):
    name = "Top1Accuracy"

    def apply(self, output, target) -> AccuracyResult:
        out = to_host(output)
        t = to_host(target).reshape(-1).astype(np.int64) - 1
        if out.ndim == 1:
            out = out[None]
        pred = out.argmax(axis=-1)
        return AccuracyResult(int((pred == t).sum()), len(t))


class Top5Accuracy(ValidationMethod):
    name = "Top5Accuracy"

    def apply(self, output, target) -> AccuracyResult:
        out = to_host(output)
        t = to_host(target).reshape(-1).astype(np.int64) - 1
        if out.ndim == 1:
            out = out[None]
        top5 = np.argsort(-out, axis=-1)[:, :5]
        correct = int(sum(t[i] in top5[i] for i in range(len(t))))
        return AccuracyResult(correct, len(t))


class Loss(ValidationMethod):
    name = "Loss"

    def __init__(self, criterion=None) -> None:
        if criterion is None:
            from bigdl_tpu_torch.nn.criterion import ClassNLLCriterion

            criterion = ClassNLLCriterion()
        self.criterion = criterion

    def apply(self, output, target) -> LossResult:
        n = output.shape[0]
        return LossResult(self.criterion.forward(output, target) * n, n)


class MAE(ValidationMethod):
    name = "MAE"

    def apply(self, output, target) -> LossResult:
        out = to_host(output)
        t = to_host(target)
        n = out.shape[0]
        return LossResult(float(np.abs(out - t).mean()) * n, n)
