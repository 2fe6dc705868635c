"""Criteria (``bigdl_tpu/nn/criterion.py``): ``AbstractCriterion``,
``ClassNLLCriterion``, ``CrossEntropyCriterion``, ``ParallelCriterion``
and ``TimeDistributedCriterion``.

Conventions kept for parity: **class labels are 1-based** (the Torch
heritage of the reference), and ``size_average=True`` divides by the
batch size. A criterion is one scalar function ``apply(input, target)``
of tensors that the train step differentiates; ``forward`` returns it as
a float and ``backward`` returns its gradient with respect to the input
(autograd in place of ``jax.grad``).
"""

from __future__ import annotations

from typing import Any, List

import numpy as np
import torch


def _as_tensor(x, like: torch.Tensor = None) -> torch.Tensor:
    """numpy/scalars → tensor (on ``like``'s device when given)."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return t if like is None else t.to(like.device)


class AbstractCriterion:
    def __init__(self) -> None:
        self.output: float = 0.0
        self.grad_input: Any = None

    def apply(self, input, target):
        """The scalar loss, a differentiable function of ``input``."""
        raise NotImplementedError

    def forward(self, input, target) -> float:
        x = _as_tensor(input)
        self.output = float(self.apply(x, _as_tensor(target, x)))
        return self.output

    __call__ = forward

    def backward(self, input, target):
        x = _as_tensor(input).detach().requires_grad_()
        with torch.enable_grad():
            loss = self.apply(x, _as_tensor(target, x))
            self.grad_input, = torch.autograd.grad(loss, x)
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
