"""Dropout (``bigdl_tpu/nn/misc.py:18``) and LookupTable (``:49``).

``Dropout`` is inverted dropout: in training mode each element is kept
with probability ``1 - p`` and, with ``scale``, divided by it. It is the
identity in eval mode, at ``p = 0``, and with no generator current (the
JAX layer with ``rng=None``); the mask comes from the generator that
:func:`bigdl_tpu_torch.nn.module.use_rng` made current, the train step's.

``LookupTable`` indices are 1-based like the reference; ids below 1 (the
text pipeline's padding id 0) embed to the zero vector, and ids past the
table clamp to its last row, as the JAX gather does. With
``grad_via_matmul=True`` the weight's gradient is the one-hot product
``onehot(idx)^T @ dY`` accumulated in f32 (JAX's
``_take_with_matmul_grad``, ``:111``) instead of the gather's
scatter-add.
"""

from __future__ import annotations

import torch

from bigdl_tpu_torch.nn.module import (
    AbstractModule, TensorModule, current_rng, new_param,
)


def keep_mask(shape, keep: float, like: torch.Tensor,
              generator: torch.Generator) -> torch.Tensor:
    """A {0, 1} tensor of ``shape`` in ``like``'s dtype and device, each
    element 1 with probability ``keep``, drawn from ``generator``."""
    u = torch.rand(shape, device=like.device, generator=generator)
    return (u < keep).to(like.dtype)


class Dropout(TensorModule):
    def __init__(self, init_p: float = 0.5, inplace: bool = False,
                 scale: bool = True) -> None:
        super().__init__()
        # ``inplace`` is taken and ignored, as in JAX
        self.p = init_p
        self.scale = scale

    def set_p(self, p: float) -> "Dropout":
        self.p = p
        return self

    def forward(self, x):
        gen = current_rng()
        if not self.training or self.p <= 0.0 or gen is None:
            return x
        keep = 1.0 - self.p
        out = x * keep_mask(x.shape, keep, x, gen)
        return out / keep if self.scale else out

    def extra_repr(self) -> str:
        return f"p={self.p}"


class _TakeWithMatmulGrad(torch.autograd.Function):
    """``weight[idx]`` whose backward is ``dW = onehot(idx)^T @ dY`` with
    f32 accumulation, written back in dY's dtype (``misc.py:111``)."""

    @staticmethod
    def forward(ctx, weight, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows = weight.shape[0]
        return weight[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        gf = g.reshape(-1, g.shape[-1]).float()
        flat = idx.reshape(-1)
        # onehot(idx)^T, built transposed: (n_rows, tokens) in f32
        onehot_t = torch.zeros((ctx.n_rows, flat.numel()),
                               dtype=torch.float32, device=g.device)
        onehot_t[flat, torch.arange(flat.numel(), device=g.device)] = 1.0
        return torch.matmul(onehot_t, gf).to(g.dtype), None


class LookupTable(AbstractModule):
    def __init__(self, n_index: int, n_output: int, device=None,
                 generator: torch.Generator = None,
                 grad_via_matmul: bool = False) -> None:
        super().__init__()
        self.n_index = n_index
        self.n_output = n_output
        self.grad_via_matmul = grad_via_matmul
        # the reference's default RandomNormal(0, 1)
        self.weight = new_param((n_index, n_output), device,
                                lambda t: t.normal_(generator=generator))

    def forward(self, ids):
        idx = ids.long() - 1
        rows = idx.clamp(0, self.n_index - 1)
        out = (_TakeWithMatmulGrad.apply(self.weight, rows)
               if self.grad_via_matmul else self.weight[rows])
        return torch.where((idx < 0)[..., None], 0.0, out)
