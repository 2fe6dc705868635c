"""Regularizers (``bigdl_tpu/optim/regularizer.py``): ``L1Regularizer``,
``L2Regularizer`` and ``L1L2Regularizer``.

A layer given ``w_regularizer``/``b_regularizer`` (``Linear``,
``SpatialConvolution``) has its gradients changed in the train step by
``grad_update(param, grad) -> grad`` (+ l1·sign(w), + l2·w), right after
the backward pass, as the reference does inside ``accGradParameters``;
``loss_term`` is the same penalty as a loss.
"""

from __future__ import annotations

import torch


class Regularizer:
    def grad_update(self, param: torch.Tensor,
                    grad: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def loss_term(self, param: torch.Tensor):
        """The penalty whose gradient :meth:`grad_update` adds."""
        raise NotImplementedError


class L1L2Regularizer(Regularizer):
    def __init__(self, l1: float = 0.0, l2: float = 0.0) -> None:
        self.l1 = l1
        self.l2 = l2

    def grad_update(self, param, grad):
        out = grad
        if self.l1 != 0.0:
            out = out + self.l1 * torch.sign(param)
        if self.l2 != 0.0:
            out = out + self.l2 * param
        return out

    def loss_term(self, param):
        loss = 0.0
        if self.l1 != 0.0:
            loss = loss + self.l1 * param.abs().sum()
        if self.l2 != 0.0:
            loss = loss + 0.5 * self.l2 * (param * param).sum()
        return loss


class L1Regularizer(L1L2Regularizer):
    def __init__(self, l1: float) -> None:
        super().__init__(l1=l1, l2=0.0)


class L2Regularizer(L1L2Regularizer):
    def __init__(self, l2: float) -> None:
        super().__init__(l1=0.0, l2=l2)
