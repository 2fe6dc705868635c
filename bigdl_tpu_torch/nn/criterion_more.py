"""Sequence criteria (``bigdl_tpu/nn/criterion_more.py``):
``TimeDistributedMaskCriterion`` and ``MaskedSoftmaxCECriterion``."""

from __future__ import annotations

import torch

from bigdl_tpu_torch.nn.criterion import AbstractCriterion, _as_tensor


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
