"""The extended criteria (``bigdl_tpu/nn/criterion_extra.py``):
``CosineEmbeddingCriterion``, ``HingeEmbeddingCriterion``,
``MarginRankingCriterion``, ``MultiMarginCriterion`` (``:87``),
``MultiLabelMarginCriterion`` (``:118``), ``L1Cost``,
``SoftmaxWithCriterion`` (``:160``), ``DiceCoefficientCriterion``,
``MultiCriterion``, ``KLDCriterion``, ``GaussianCriterion``,
``CosineDistanceCriterion``, ``SoftMarginCriterion``,
``CosineProximityCriterion`` and ``ClassSimplexCriterion`` (``:314``).

Torch conventions, as in JAX: class labels are 1-based;
``MultiLabelMarginCriterion``'s targets are 1-based class indices whose
first 0 ends the row's list; similarity labels are ±1; ``size_average``
divides by the batch (``_mean_or_sum``). A pair input is a table (a list
of two tensors). Each criterion is one scalar ``apply(input, target)``
with the port's ``forward``/``backward`` API
(:class:`~bigdl_tpu_torch.nn.criterion.AbstractCriterion`); ``L1Cost``
and ``KLDCriterion`` ignore the target, which may be ``None``.
``SoftmaxWithCriterion`` (Caffe's SoftmaxWithLoss) drops
``ignore_label``'s rows and normalizes by the kept rows (``"VALID"``),
the batch (``"FULL"``, ``"BATCH_SIZE"``) or not at all (``"NONE"``).
``ClassSimplexCriterion`` builds its simplex with numpy, as JAX does.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.criterion import AbstractCriterion, _as_tensor
from bigdl_tpu_torch.nn.layers_extra import cosine_similarity


def _mean_or_sum(x, size_average: bool, n):
    return x / n if size_average else x


def _zero_max(x):
    """``jnp.maximum(0, x)`` (half the gradient at an exact 0)."""
    return torch.maximum(x, x.new_zeros(()))


def _labels(target, like) -> torch.Tensor:
    """1-based labels → 0-based int64 indices, truncating floats as JAX's
    ``astype(int32)``."""
    return _as_tensor(target, like).reshape(-1).to(torch.int32).long() - 1


class CosineEmbeddingCriterion(AbstractCriterion):
    """Input ``[x1, x2]`` (N, D), target y ∈ {1, -1} per row: ``1 - cos``
    for similar pairs, ``max(0, cos - margin)`` for dissimilar ones."""

    def __init__(self, margin: float = 0.0, size_average: bool = True) -> None:
        super().__init__()
        self.margin = margin
        self.size_average = size_average

    def apply(self, input, target):
        x1, x2 = input
        y = _as_tensor(target, x1).reshape(-1)
        cos = cosine_similarity(x1, x2)
        per = torch.where(y > 0, 1.0 - cos, _zero_max(cos - self.margin))
        return _mean_or_sum(torch.sum(per), self.size_average, per.shape[0])


class HingeEmbeddingCriterion(AbstractCriterion):
    """Distances x with y ∈ {1, -1}: ``x`` when similar, ``max(0, margin
    - x)`` when dissimilar."""

    def __init__(self, margin: float = 1.0, size_average: bool = True) -> None:
        super().__init__()
        self.margin = margin
        self.size_average = size_average

    def apply(self, input, target):
        x = input.reshape(-1)
        y = _as_tensor(target, x).reshape(-1)
        per = torch.where(y > 0, x, _zero_max(self.margin - x))
        return _mean_or_sum(torch.sum(per), self.size_average, per.shape[0])


class MarginRankingCriterion(AbstractCriterion):
    """Input ``[x1, x2]`` scores; y = 1 means x1 should rank higher:
    ``max(0, -y (x1 - x2) + margin)``."""

    def __init__(self, margin: float = 0.0, size_average: bool = True) -> None:
        super().__init__()
        self.margin = margin
        self.size_average = size_average

    def apply(self, input, target):
        x1, x2 = input[0].reshape(-1), input[1].reshape(-1)
        y = _as_tensor(target, x1).reshape(-1)
        per = _zero_max(-y * (x1 - x2) + self.margin)
        return _mean_or_sum(torch.sum(per), self.size_average, per.shape[0])


class MultiMarginCriterion(AbstractCriterion):
    """Multi-class hinge on (N, C) scores with 1-based targets: the mean
    over the other classes of ``max(0, margin - x[y] + x[i])^p``."""

    def __init__(self, p: int = 1, weights=None, margin: float = 1.0,
                 size_average: bool = True) -> None:
        super().__init__()
        if p not in (1, 2):
            raise ValueError(f"MultiMarginCriterion p is 1 or 2, not {p}")
        self.p = p
        self.weights = weights
        self.margin = margin
        self.size_average = size_average

    def apply(self, input, target):
        x = input if input.dim() == 2 else input[None]
        t = _labels(target, x)
        n, c = x.shape
        xy = torch.gather(x, 1, t[:, None])                 # (N, 1)
        m = _zero_max(self.margin - xy + x)                 # (N, C)
        if self.p == 2:
            m = m * m
        if self.weights is not None:
            w = _as_tensor(self.weights, x).to(x.dtype)
            m = m * w[t][:, None]
        # the y-th column would contribute margin^p: zero it
        mask = torch.arange(c, device=x.device)[None, :] != t[:, None]
        per = torch.sum(m * mask, -1) / c
        return _mean_or_sum(torch.sum(per), self.size_average, n)


class MultiLabelMarginCriterion(AbstractCriterion):
    """(N, C) scores and (N, C) targets of 1-based class indices, the
    list ending at the first 0: the hinge between every target class and
    every other class, over C."""

    def __init__(self, size_average: bool = True) -> None:
        super().__init__()
        self.size_average = size_average

    def apply(self, input, target):
        x = input if input.dim() == 2 else input[None]
        t = _as_tensor(target, x).to(torch.int32).long()
        t = t if t.dim() == 2 else t[None]
        n, c = x.shape
        # only the indices BEFORE the first 0 are targets
        seen_zero = torch.cumsum((t == 0).long(), dim=1) > 0
        valid = (t > 0) & ~seen_zero                        # (N, K)
        tclamped = torch.clamp(t - 1, min=0)
        is_target = torch.any(
            (torch.arange(c, device=x.device)[None, None, :]
             == tclamped[:, :, None]) & valid[:, :, None], dim=1)
        xt = torch.gather(x, 1, tclamped)                   # (N, K)
        h = _zero_max(1.0 - (xt[:, :, None] - x[:, None, :]))  # (N, K, C)
        contrib = h * valid[:, :, None] * (~is_target)[:, None, :]
        per = torch.sum(contrib, (1, 2)) / c
        return _mean_or_sum(torch.sum(per), self.size_average, n)


class L1Cost(AbstractCriterion):
    """``sum |input|``; the target is ignored."""

    def apply(self, input, target=None):
        return torch.sum(torch.abs(input))


class SoftmaxWithCriterion(AbstractCriterion):
    """Caffe's SoftmaxWithLoss: raw logits (N, C) and 1-based targets,
    log-softmax and NLL in one."""

    _MODES = ("VALID", "FULL", "BATCH_SIZE", "NONE")

    def __init__(self, ignore_label: Optional[int] = None,
                 normalize_mode: str = "VALID") -> None:
        super().__init__()
        if normalize_mode not in self._MODES:
            raise ValueError(
                f"normalize_mode must be one of {self._MODES}, "
                f"got {normalize_mode!r}")
        self.ignore_label = ignore_label
        self.normalize_mode = normalize_mode

    def apply(self, input, target):
        x = input if input.dim() == 2 else input[None]
        t = _labels(target, x)
        logp = torch.log_softmax(x, dim=-1)
        picked = torch.gather(logp, 1, torch.clamp(t, min=0)[:, None])[:, 0]
        n_valid = picked.shape[0]
        if self.ignore_label is not None:
            keep = t != (self.ignore_label - 1)
            picked = picked * keep
            n_valid = torch.clamp(torch.sum(keep), min=1)
        if self.normalize_mode == "NONE":
            return -torch.sum(picked)
        if self.normalize_mode in ("FULL", "BATCH_SIZE"):
            return -torch.sum(picked) / picked.shape[0]
        return -torch.sum(picked) / n_valid                 # VALID


class DiceCoefficientCriterion(AbstractCriterion):
    """1 - Dice overlap: ``1 - (2 Σ x t + ε) / (Σ x + Σ t + ε)`` per
    sample."""

    def __init__(self, size_average: bool = True,
                 epsilon: float = 1.0) -> None:
        super().__init__()
        self.size_average = size_average
        self.epsilon = epsilon

    def apply(self, input, target):
        x = input.reshape(input.shape[0], -1)
        t = _as_tensor(target, x).reshape(x.shape)
        inter = torch.sum(x * t, -1)
        per = 1.0 - (2.0 * inter + self.epsilon) / (
            torch.sum(x, -1) + torch.sum(t, -1) + self.epsilon)
        return _mean_or_sum(torch.sum(per), self.size_average, per.shape[0])


class MultiCriterion(AbstractCriterion):
    """Weighted sum of criteria over the SAME (input, target)."""

    def __init__(self) -> None:
        super().__init__()
        self.criterions: List[AbstractCriterion] = []
        self.weights: List[float] = []

    def add(self, criterion: AbstractCriterion,
            weight: float = 1.0) -> "MultiCriterion":
        self.criterions.append(criterion)
        self.weights.append(weight)
        return self

    def apply(self, input, target):
        total = 0.0
        for c, w in zip(self.criterions, self.weights):
            total = total + w * c.apply(input, target)
        return total


class KLDCriterion(AbstractCriterion):
    """A VAE posterior's KL divergence from N(0, I): input ``[mean,
    log_var]``, ``-½ Σ (1 + log σ² - μ² - σ²)`` over the batch; the
    target is ignored."""

    def __init__(self, size_average: bool = True) -> None:
        super().__init__()
        self.size_average = size_average

    def apply(self, input, target=None):
        mean, log_var = input
        kl = -0.5 * torch.sum(1.0 + log_var - mean * mean - torch.exp(log_var))
        return _mean_or_sum(kl, self.size_average, mean.shape[0])


class GaussianCriterion(AbstractCriterion):
    """The target's negative log-likelihood under N(mean, σ²), input
    ``[mean, log_var]``: ``½ Σ (log 2π + log σ² + (t - μ)² / σ²)``."""

    def apply(self, input, target):
        mean, log_var = input
        t = _as_tensor(target, mean)
        return 0.5 * torch.sum(math.log(2.0 * math.pi) + log_var
                               + (t - mean) ** 2 / torch.exp(log_var))


class CosineDistanceCriterion(AbstractCriterion):
    """``1 - cos(input, target)`` per row."""

    def __init__(self, size_average: bool = True) -> None:
        super().__init__()
        self.size_average = size_average

    def apply(self, input, target):
        per = 1.0 - cosine_similarity(input, _as_tensor(target, input))
        return _mean_or_sum(torch.sum(per), self.size_average, per.shape[0])


class SoftMarginCriterion(AbstractCriterion):
    """Two-class logistic loss over ±1 targets: ``mean(log(1 +
    exp(-y x)))``, as ``-log_sigmoid(y x)``."""

    def __init__(self, size_average: bool = True) -> None:
        super().__init__()
        self.size_average = size_average

    def apply(self, input, target):
        per = -F.logsigmoid(_as_tensor(target, input) * input)
        return _mean_or_sum(torch.sum(per), self.size_average, per.numel())


class CosineProximityCriterion(AbstractCriterion):
    """``-mean(cos(input, target))``."""

    def apply(self, input, target):
        return -torch.mean(cosine_similarity(input,
                                             _as_tensor(target, input)))


class ClassSimplexCriterion(AbstractCriterion):
    """MSE against simplex-embedded class targets: class k is vertex k of
    a regular simplex (the rows of identity minus centroid, normalized),
    the loss the squared distance to the target's vertex."""

    def __init__(self, n_classes: int, size_average: bool = True) -> None:
        super().__init__()
        if n_classes < 2:
            raise ValueError("ClassSimplexCriterion needs 2 or more "
                             f"classes, not {n_classes}")
        self.n_classes = n_classes
        self.size_average = size_average
        self._simplex = self._build_simplex(n_classes)

    @staticmethod
    def _build_simplex(n: int) -> np.ndarray:
        eye = np.eye(n, dtype=np.float32)
        v = eye - eye.mean(axis=0, keepdims=True)
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        return v

    def apply(self, input, target):
        t = _labels(target, input)
        tv = torch.as_tensor(self._simplex, device=input.device)[t]
        diff = input - tv
        loss = torch.sum(diff * diff)
        return _mean_or_sum(loss, self.size_average, input.numel())
