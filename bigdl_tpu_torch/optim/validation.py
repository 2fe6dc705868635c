"""ValidationMethods and their results (``bigdl_tpu/optim/validation.py``):
``Top1Accuracy``, ``Top5Accuracy``, ``TreeNNAccuracy`` (``:128``),
``Loss`` and ``MAE``; ``AccuracyResult``/``LossResult`` merge with
``+``. Labels are 1-based, as the criteria take them.

A method takes the model's output as a tensor (on the card or the CPU)
and the batch's target as the host array the data pipeline made. The
accuracies rank on the host with numpy, as the JAX methods do, so ties
break the same way; ``Loss`` runs its criterion where the output lies.
``merge_across_processes`` sums a result's accumulators over every rank
of the ``torch.distributed`` group in float64, one ``all_reduce`` (the
reduce of the reference's ``ValidationResult.merge``;
JAX's ``process_allgather`` and sum); with one rank, or no group, it
returns the result unchanged. A rank whose validation shard gave no batch
joins the merge with its method's ``empty_result()``.
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
    #: the numeric accumulators, in constructor order: the fields the
    #: cross-process merge sums
    _fields = ()

    def result(self):
        raise NotImplementedError

    def __add__(self, other):
        raise NotImplementedError

    def merge_across_processes(self) -> "ValidationResult":
        """The sum of this result over every rank of the process group."""
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()) or \
                dist.get_world_size() == 1 or not self._fields:
            return self
        from bigdl_tpu_torch.parallel.all_reduce import all_reduce_sum

        dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
        acc = torch.tensor([float(getattr(self, f)) for f in self._fields],
                           dtype=torch.float64, device=dev)
        return type(self)(*all_reduce_sum(acc).tolist())


class AccuracyResult(ValidationResult):
    _fields = ("correct", "count")

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
    _fields = ("loss", "count")

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
    #: the result type, whose (0, 0) is the zero a rank with no batch
    #: brings to the cross-process merge
    _result_cls = None

    def empty_result(self) -> ValidationResult:
        if self._result_cls is None:
            raise NotImplementedError(
                f"{type(self).__name__} needs _result_cls for pod merges")
        return self._result_cls(0, 0)

    def apply(self, output, target) -> ValidationResult:
        raise NotImplementedError

    __call__ = apply

    def __repr__(self) -> str:
        return self.name


class Top1Accuracy(ValidationMethod):
    name = "Top1Accuracy"
    _result_cls = AccuracyResult

    def apply(self, output, target) -> AccuracyResult:
        out = to_host(output)
        t = to_host(target).reshape(-1).astype(np.int64) - 1
        if out.ndim == 1:
            out = out[None]
        pred = out.argmax(axis=-1)
        return AccuracyResult(int((pred == t).sum()), len(t))


class Top5Accuracy(ValidationMethod):
    name = "Top5Accuracy"
    _result_cls = AccuracyResult

    def apply(self, output, target) -> AccuracyResult:
        out = to_host(output)
        t = to_host(target).reshape(-1).astype(np.int64) - 1
        if out.ndim == 1:
            out = out[None]
        top5 = np.argsort(-out, axis=-1)[:, :5]
        correct = int(sum(t[i] in top5[i] for i in range(len(t))))
        return AccuracyResult(correct, len(t))


class TreeNNAccuracy(ValidationMethod):
    """Accuracy over a tree model's per-node outputs (reference
    ``TreeNNAccuracy``, used by treeLSTMSentiment): ``output`` (B, N, C)
    class scores in children-before-parent node order, ``target`` (B, N)
    1-based labels with 0 for padding (trailing singleton dims
    tolerated). The root is each tree's last labelled node;
    ``all_nodes=True`` scores every labelled node."""

    _result_cls = AccuracyResult

    def __init__(self, all_nodes: bool = False) -> None:
        self.all_nodes = all_nodes
        self.name = f"TreeNNAccuracy(all={all_nodes})"

    def apply(self, output, target) -> AccuracyResult:
        out = to_host(output)
        t = to_host(target).astype(np.int64)
        if out.ndim == 2:
            out, t = out[None], np.atleast_2d(t)
        while t.ndim > out.ndim - 1 and t.shape[-1] == 1:
            t = t[..., 0]
        if t.shape != out.shape[:-1]:
            raise ValueError(
                f"TreeNNAccuracy: target shape {t.shape} does not match "
                f"output node grid {out.shape[:-1]}")
        pred = out.argmax(axis=-1) + 1          # 1-based
        valid = t > 0
        if self.all_nodes:
            return AccuracyResult(int(((pred == t) & valid).sum()),
                                  int(valid.sum()))
        correct = total = 0
        for b in range(t.shape[0]):
            idx = np.nonzero(valid[b])[0]
            if len(idx):
                total += 1
                correct += int(pred[b, idx[-1]] == t[b, idx[-1]])
        return AccuracyResult(correct, total)


class Loss(ValidationMethod):
    name = "Loss"
    _result_cls = LossResult

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
    _result_cls = LossResult

    def apply(self, output, target) -> LossResult:
        out = to_host(output)
        t = to_host(target)
        n = out.shape[0]
        return LossResult(float(np.abs(out - t).mean()) * n, n)
