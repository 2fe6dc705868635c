"""Criteria (``bigdl_tpu/nn/criterion.py``): ``AbstractCriterion``,
``ClassNLLCriterion``, ``CrossEntropyCriterion``, ``MSECriterion``,
``AbsCriterion``, ``BCECriterion``, ``SmoothL1Criterion``,
``MultiLabelSoftMarginCriterion``, ``ParallelCriterion``,
``TimeDistributedCriterion``, ``MarginCriterion`` and
``DistKLDivCriterion``.

Conventions kept for parity: **class labels are 1-based** (the Torch
heritage of the reference), and ``size_average=True`` divides by the
batch size. A criterion is one scalar function ``apply(input, target)``
of tensors that the train step differentiates; ``forward`` returns it as
a float and ``backward`` returns its gradient with respect to the input
(autograd in place of ``jax.grad``). A table input (a list, as
``L1HingeEmbeddingCriterion`` takes) stays a list of tensors, and its
gradient is a list. The element-wise losses divide by the element count
with ``size_average``; their clips and hinges are JAX's (``jnp.clip``,
``jnp.maximum``: half the gradient at an exact bound).
"""

from __future__ import annotations

from typing import Any, List

import numpy as np
import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.activations import clip


def _as_tensor(x, like: torch.Tensor = None) -> torch.Tensor:
    """numpy/scalars → tensor (on ``like``'s device when given); ``None``
    stays ``None`` (a criterion that ignores its target)."""
    if x is None:
        return None
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return t if like is None else t.to(like.device)


def _activity(x):
    """A tensor, or a list of tensors for a table input."""
    if isinstance(x, (list, tuple)):
        return [_as_tensor(v) for v in x]
    return _as_tensor(x)


def _first(x):
    return x[0] if isinstance(x, list) else x


class AbstractCriterion:
    def __init__(self) -> None:
        self.output: float = 0.0
        self.grad_input: Any = None

    def apply(self, input, target):
        """The scalar loss, a differentiable function of ``input``."""
        raise NotImplementedError

    def forward(self, input, target) -> float:
        x = _activity(input)
        self.output = float(self.apply(x, _as_tensor(target, _first(x))))
        return self.output

    __call__ = forward

    def backward(self, input, target):
        x = _activity(input)
        xs = [v.detach().requires_grad_() for v in
              (x if isinstance(x, list) else [x])]
        with torch.enable_grad():
            loss = self.apply(xs if isinstance(x, list) else xs[0],
                              _as_tensor(target, xs[0]))
            grads = list(torch.autograd.grad(loss, xs))
        self.grad_input = grads if isinstance(x, list) else grads[0]
        return self.grad_input


class ClassNLLCriterion(AbstractCriterion):
    """Negative log-likelihood over log-probability input (N, C) with
    1-based class targets (N,). ``log_prob_as_input=False`` takes the log
    first."""

    def __init__(self, weights=None, size_average: bool = True,
                 log_prob_as_input: bool = True) -> None:
        super().__init__()
        self.weights = weights
        self.size_average = size_average
        self.log_prob_as_input = log_prob_as_input

    def apply(self, input, target):
        logp = input if self.log_prob_as_input else torch.log(input + 1e-8)
        target = _as_tensor(target, logp)
        if logp.dim() == 1:
            logp = logp[None]
            target = target.reshape(1)
        # float labels truncate toward zero, as JAX's astype(int32); a
        # padding label 0 picks the last class, as JAX's take_along_axis
        # wraps index -1 (masking criteria then zero that step)
        idx = target.to(torch.int32).reshape(-1).long() - 1
        idx = torch.where(idx < 0, idx + logp.shape[1], idx)
        picked = logp.gather(1, idx[:, None])[:, 0]
        if self.weights is not None:
            w = _as_tensor(self.weights, logp).to(logp.dtype)[idx]
            loss = -(picked * w).sum()
            return loss / w.sum() if self.size_average else loss
        loss = -picked.sum()
        return loss / picked.shape[0] if self.size_average else loss


class CrossEntropyCriterion(AbstractCriterion):
    """LogSoftMax + ClassNLL fused (reference ``CrossEntropyCriterion``)."""

    def __init__(self, weights=None, size_average: bool = True) -> None:
        super().__init__()
        self.weights = weights
        self.size_average = size_average

    def apply(self, input, target):
        logp = torch.log_softmax(input, dim=-1)
        return ClassNLLCriterion(self.weights, self.size_average).apply(
            logp, target)


def _mean_or_sum(loss, input, size_average: bool):
    return loss / input.numel() if size_average else loss


class MSECriterion(AbstractCriterion):
    def __init__(self, size_average: bool = True) -> None:
        super().__init__()
        self.size_average = size_average

    def apply(self, input, target):
        target = _as_tensor(target, input)
        return _mean_or_sum(((input - target) ** 2).sum(), input,
                            self.size_average)


class AbsCriterion(AbstractCriterion):
    def __init__(self, size_average: bool = True) -> None:
        super().__init__()
        self.size_average = size_average

    def apply(self, input, target):
        target = _as_tensor(target, input)
        return _mean_or_sum(torch.abs(input - target).sum(), input,
                            self.size_average)


class BCECriterion(AbstractCriterion):
    """Binary cross entropy of probabilities, clipped to [1e-12, 1 -
    1e-12], each element weighted by ``weights`` (broadcast) when
    given."""

    def __init__(self, weights=None, size_average: bool = True) -> None:
        super().__init__()
        self.weights = weights
        self.size_average = size_average

    def apply(self, input, target):
        target = _as_tensor(target, input)
        eps = 1e-12
        x = clip(input, eps, 1.0 - eps)
        ll = target * torch.log(x) + (1.0 - target) * torch.log(1.0 - x)
        if self.weights is not None:
            ll = ll * _as_tensor(self.weights, input).to(input.dtype)
        return _mean_or_sum(-ll.sum(), input, self.size_average)


class SmoothL1Criterion(AbstractCriterion):
    def __init__(self, size_average: bool = True) -> None:
        super().__init__()
        self.size_average = size_average

    def apply(self, input, target):
        d = torch.abs(input - _as_tensor(target, input))
        loss = torch.where(d < 1.0, 0.5 * d * d, d - 0.5).sum()
        return _mean_or_sum(loss, input, self.size_average)


class MultiLabelSoftMarginCriterion(AbstractCriterion):
    """``-Σ (t·log σ(x) + (1 - t)·log σ(-x)) / C``, divided by the batch
    size with ``size_average`` (C the last dim)."""

    def __init__(self, weights=None, size_average: bool = True) -> None:
        super().__init__()
        self.weights = weights
        self.size_average = size_average

    def apply(self, input, target):
        target = _as_tensor(target, input)
        ll = (target * F.logsigmoid(input)
              + (1.0 - target) * F.logsigmoid(-input))
        if self.weights is not None:
            ll = ll * _as_tensor(self.weights, input).to(input.dtype)
        n = input.shape[0] if input.dim() > 1 else 1
        loss = -ll.sum() / input.shape[-1]
        return loss / n if self.size_average else loss


class ParallelCriterion(AbstractCriterion):
    """The weighted sum of criteria over a table input: criterion i takes
    ``input[i]`` and ``target[i]``, or the one shared ``target`` with
    ``repeat_target`` (``Inception_v1``'s three heads, reference
    ``ParallelCriterion.scala``)."""

    def __init__(self, repeat_target: bool = False) -> None:
        super().__init__()
        self.criterions: List[AbstractCriterion] = []
        self.crit_weights: List[float] = []
        self.repeat_target = repeat_target

    def add(self, criterion: AbstractCriterion,
            weight: float = 1.0) -> "ParallelCriterion":
        self.criterions.append(criterion)
        self.crit_weights.append(weight)
        return self

    def apply(self, input, target):
        total = 0.0
        for i, (c, w) in enumerate(zip(self.criterions, self.crit_weights)):
            t = target if self.repeat_target else target[i]
            total = total + w * c.apply(input[i], t)
        return total

    def forward(self, input, target) -> float:
        xs = [_as_tensor(x) for x in input]
        t = (_as_tensor(target, xs[0]) if self.repeat_target
             else [_as_tensor(v, x) for v, x in zip(target, xs)])
        self.output = float(self.apply(xs, t))
        return self.output

    __call__ = forward

    def backward(self, input, target):
        xs = [_as_tensor(x).detach().requires_grad_() for x in input]
        t = (_as_tensor(target, xs[0]) if self.repeat_target
             else [_as_tensor(v, x) for v, x in zip(target, xs)])
        with torch.enable_grad():
            self.grad_input = list(torch.autograd.grad(self.apply(xs, t), xs))
        return self.grad_input


class TimeDistributedCriterion(AbstractCriterion):
    """Apply a criterion at every time step of (N, T, ...) input
    (reference ``TimeDistributedCriterion``); the wrapped criterion is
    vmapped over the time axis, as the JAX version vmaps it."""

    def __init__(self, critrn: AbstractCriterion, size_average: bool = False,
                 dimension: int = 2) -> None:
        super().__init__()
        self.critrn = critrn
        self.size_average = size_average
        self.dimension = dimension

    def apply(self, input, target):
        ax = self.dimension - 1
        steps = input.shape[ax]
        target = _as_tensor(target, input)
        # the target is per-step when it carries the time axis; otherwise
        # one shared target for every step
        if target.dim() > ax and target.shape[ax] == steps:
            per = torch.func.vmap(self.critrn.apply, in_dims=(ax, ax))(
                input, target)
        else:
            per = torch.func.vmap(lambda x: self.critrn.apply(x, target),
                                  in_dims=ax)(input)
        total = per.sum()
        return total / steps if self.size_average else total


class MarginCriterion(AbstractCriterion):
    """The hinge ``Σ max(0, margin - x·t)`` for targets ±1."""

    def __init__(self, margin: float = 1.0, size_average: bool = True) -> None:
        super().__init__()
        self.margin = margin
        self.size_average = size_average

    def apply(self, input, target):
        h = self.margin - input * _as_tensor(target, input)
        loss = torch.maximum(h, h.new_zeros(())).sum()
        return _mean_or_sum(loss, input, self.size_average)


class DistKLDivCriterion(AbstractCriterion):
    """KL divergence ``Σ t·(log t - x)`` of log-probability input, over
    the targets above 0."""

    def __init__(self, size_average: bool = True) -> None:
        super().__init__()
        self.size_average = size_average

    def apply(self, input, target):
        t = _as_tensor(target, input)
        pos = t > 0
        contrib = torch.where(
            pos, t * (torch.log(torch.where(pos, t, 1.0)) - input), 0.0)
        return _mean_or_sum(contrib.sum(), input, self.size_average)
