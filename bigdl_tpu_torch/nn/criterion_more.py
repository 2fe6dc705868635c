"""More criteria (``bigdl_tpu/nn/criterion_more.py``):
``L1HingeEmbeddingCriterion``, ``PoissonCriterion``, the keras-heritage
regression losses (``MeanAbsolutePercentageCriterion``,
``MeanSquaredLogarithmicCriterion``,
``KullbackLeiblerDivergenceCriterion``, ``CategoricalCrossEntropy``;
``:20-98``), and the sequence criteria ``TimeDistributedMaskCriterion``
and ``MaskedSoftmaxCECriterion``. Their clamps at ``_EPS`` are JAX's
``jnp.maximum``/``jnp.clip`` (half the gradient at an exact bound)."""

from __future__ import annotations

import torch

from bigdl_tpu_torch.nn.activations import clip
from bigdl_tpu_torch.nn.criterion import AbstractCriterion, _as_tensor

_EPS = 1e-7


def _at_least(x, lo: float):
    return torch.maximum(x, x.new_tensor(lo))


class L1HingeEmbeddingCriterion(AbstractCriterion):
    """Table input ``[x1, x2]`` with target ±1: the L1 distance ``d``
    between the pair for a similar pair (y = 1), ``max(0, margin - d)``
    for a dissimilar one (y = -1)."""

    def __init__(self, margin: float = 1.0) -> None:
        super().__init__()
        self.margin = margin

    def apply(self, input, target):
        x1, x2 = input
        d = torch.abs(x1 - x2).sum()
        y = _as_tensor(target, x1).reshape(())
        hinge = self.margin - d
        return torch.where(y > 0, d, torch.maximum(hinge, hinge.new_zeros(())))


class PoissonCriterion(AbstractCriterion):
    """``mean(p - t·log(max(p, eps)))``."""

    def apply(self, input, target):
        t = _as_tensor(target, input)
        return (input - t * torch.log(_at_least(input, _EPS))).mean()


class MeanAbsolutePercentageCriterion(AbstractCriterion):
    """``100 · mean(|t - p| / max(|t|, eps))``."""

    def apply(self, input, target):
        t = _as_tensor(target, input)
        return 100.0 * (torch.abs(t - input)
                        / _at_least(torch.abs(t), _EPS)).mean()


class MeanSquaredLogarithmicCriterion(AbstractCriterion):
    """``mean((log(t + 1) - log(p + 1))²)``, both sides clamped to at
    least eps."""

    def apply(self, input, target):
        t = _as_tensor(target, input)
        lp = torch.log(_at_least(input, _EPS) + 1.0)
        lt = torch.log(_at_least(t, _EPS) + 1.0)
        return ((lt - lp) ** 2).mean()


class KullbackLeiblerDivergenceCriterion(AbstractCriterion):
    """Keras-style ``mean over rows of Σ t·log(t / p)``, both sides
    clipped to [eps, 1] (distinct from ``DistKLDivCriterion``, which
    takes log-probabilities)."""

    def apply(self, input, target):
        p = clip(input, _EPS, 1.0)
        t = clip(_as_tensor(target, input), _EPS, 1.0)
        return (t * torch.log(t / p)).sum(-1).mean()


class CategoricalCrossEntropy(AbstractCriterion):
    """Cross entropy of PROBABILITY input (clipped to [eps, 1 - eps] and
    renormalized per row) against one-hot targets."""

    def apply(self, input, target):
        p = clip(input, _EPS, 1.0 - _EPS)
        p = p / p.sum(-1, keepdim=True)
        t = _as_tensor(target, input)
        return (-(t * torch.log(p)).sum(-1)).mean()


class TimeDistributedMaskCriterion(AbstractCriterion):
    """Per-timestep criterion that MASKS padded steps: steps whose target
    equals ``padding_value`` contribute nothing, and the mean divides by
    the number of real steps (reference ``TimeDistributedMaskCriterion``).
    The wrapped criterion is vmapped over (batch·time) and multiplied by
    the mask."""

    def __init__(self, critrn: AbstractCriterion,
                 padding_value: int = 0) -> None:
        super().__init__()
        self.critrn = critrn
        self.padding_value = padding_value

    def apply(self, input, target):
        target = _as_tensor(target, input)
        b, t = input.shape[0], input.shape[1]
        flat_in = input.reshape((b * t,) + tuple(input.shape[2:]))
        flat_tg = target.reshape((b * t,) + tuple(target.shape[2:]))
        per = torch.func.vmap(
            lambda i, g: self.critrn.apply(i[None], g[None]))(flat_in, flat_tg)
        mask = flat_tg != self.padding_value
        if mask.dim() > 1:
            mask = mask.reshape(b * t, -1).any(dim=-1)
        mask = mask.to(per.dtype)
        return (per * mask).sum() / mask.sum().clamp_min(1.0)


class MaskedSoftmaxCECriterion(AbstractCriterion):
    """Sequence cross-entropy straight from LOGITS ``(B, T, V)`` against
    1-based targets ``(B, T)``, masking ``padding_value`` steps — the
    fused form of ``TimeDistributedMaskCriterion(CrossEntropyCriterion)``
    over a ``TransformerLM(output="logits")``: ``logsumexp(logits) -
    logits[target]`` in f32, with no log-prob tensor."""

    def __init__(self, padding_value: int = 0) -> None:
        super().__init__()
        self.padding_value = int(padding_value)

    def apply(self, input, target):
        b, t, v = input.shape
        logits = input.reshape(b * t, v)
        tg = _as_tensor(target, input).reshape(b * t).to(torch.int32)
        idx = (tg - 1).clamp(0, v - 1).long()    # 1-based reference ids
        lse = torch.logsumexp(logits.float(), dim=-1)
        picked = logits.gather(1, idx[:, None])[:, 0].float()
        per = lse - picked
        mask = (tg != self.padding_value).to(per.dtype)
        return (per * mask).sum() / mask.sum().clamp_min(1.0)
