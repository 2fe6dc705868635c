"""Misc layers (``bigdl_tpu/nn/misc.py``): ``Dropout`` (``:18``),
``LookupTable`` (``:49``), the constant and element-wise ops
(``MulConstant`` … ``Clamp``, ``:136-210``), the reductions ``Mean``,
``Sum``, ``Max`` and ``Min`` (``:212-250``), ``MM``/``MV`` and the
learnable ``Mul``/``Add``/``CMul``/``CAdd`` (``:252-344``).

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
scatter-add. ``max_norm`` rescales every row to at most that
``norm_type``-norm before the lookup (differentiably, as JAX's, not in
place as ``F.embedding``'s); ids equal to a non-zero ``padding_value``
embed to zeros; ``should_scale_grad_by_freq`` is accepted and, as in
JAX, unused.

The reductions take a 1-based ``dimension`` with the ``n_input_dims``
batch rule of :func:`bigdl_tpu_torch.nn.shape_ops._axis` and drop it
unless ``squeeze=False``; ``Max``/``Min`` split the gradient between
tied maxima (``amax``/``amin``, as ``jnp.max``). ``Clamp`` is
:func:`~bigdl_tpu_torch.nn.activations.clip` (JAX's gradient at the
bounds).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from bigdl_tpu_torch.nn.activations import clip
from bigdl_tpu_torch.nn.init_methods import InitializationMethod, RandomNormal
from bigdl_tpu_torch.nn.module import (
    AbstractModule, TensorModule, current_rng, new_param,
)
from bigdl_tpu_torch.nn.shape_ops import _axis


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
    def __init__(self, n_index: int, n_output: int, padding_value: float = 0,
                 max_norm: float = float("inf"), norm_type: float = 2.0,
                 should_scale_grad_by_freq: bool = False,
                 init_weight: Optional[InitializationMethod] = None,
                 grad_via_matmul: bool = False, device=None,
                 generator: torch.Generator = None) -> None:
        super().__init__()
        self.n_index = n_index
        self.n_output = n_output
        self.padding_value = int(padding_value)
        self.max_norm = max_norm
        self.norm_type = norm_type
        self.grad_via_matmul = grad_via_matmul
        # the reference's default RandomNormal(0, 1)
        self.weight_init = init_weight or RandomNormal(0.0, 1.0)
        self.weight = new_param((n_index, n_output), device,
                                lambda t: self.weight_init.fill(t, generator))

    def forward(self, ids):
        w = self.weight
        if self.max_norm != float("inf"):
            norms = (w.abs() ** self.norm_type).sum(
                1, keepdim=True) ** (1.0 / self.norm_type)
            w = w * torch.minimum(self.max_norm / (norms + 1e-7),
                              norms.new_ones(()))
        idx = ids.long() - 1
        rows = idx.clamp(0, self.n_index - 1)
        out = (_TakeWithMatmulGrad.apply(w, rows)
               if self.grad_via_matmul else w[rows])
        out = torch.where((idx < 0)[..., None], 0.0, out)
        if self.padding_value != 0:
            out = torch.where((ids.long() == self.padding_value)[..., None],
                              0.0, out)
        return out


class MulConstant(TensorModule):
    def __init__(self, scalar: float, inplace: bool = False) -> None:
        super().__init__()
        self.scalar = scalar

    def forward(self, x):
        return x * self.scalar


class AddConstant(TensorModule):
    def __init__(self, constant_scalar: float, inplace: bool = False) -> None:
        super().__init__()
        self.constant_scalar = constant_scalar

    def forward(self, x):
        return x + self.constant_scalar


class Power(TensorModule):
    """``(shift + scale * x) ** power``."""

    def __init__(self, power: float, scale: float = 1.0,
                 shift: float = 0.0) -> None:
        super().__init__()
        self.power = power
        self.scale = scale
        self.shift = shift

    def forward(self, x):
        return (self.shift + self.scale * x) ** self.power


class Square(TensorModule):
    def forward(self, x):
        return x * x


class Sqrt(TensorModule):
    def forward(self, x):
        return torch.sqrt(x)


class Abs(TensorModule):
    def forward(self, x):
        return torch.abs(x)


class Log(TensorModule):
    def forward(self, x):
        return torch.log(x)


class Exp(TensorModule):
    def forward(self, x):
        return torch.exp(x)


class Clamp(TensorModule):
    def __init__(self, min_v: float, max_v: float) -> None:
        super().__init__()
        self.min_v = min_v
        self.max_v = max_v

    def forward(self, x):
        return clip(x, self.min_v, self.max_v)


class _Reduction(TensorModule):
    def __init__(self, dimension: int = 1, n_input_dims: int = -1,
                 squeeze: bool = True) -> None:
        super().__init__()
        self.dimension = dimension
        self.n_input_dims = n_input_dims
        self.squeeze = squeeze

    def _ax(self, x) -> int:
        return _axis(self.dimension, x.dim(), self.n_input_dims)


class Mean(_Reduction):
    def forward(self, x):
        return x.mean(self._ax(x), keepdim=not self.squeeze)


class Sum(_Reduction):
    def forward(self, x):
        return x.sum(self._ax(x), keepdim=not self.squeeze)


class Max(_Reduction):
    def forward(self, x):
        return torch.amax(x, self._ax(x), keepdim=not self.squeeze)


class Min(_Reduction):
    def forward(self, x):
        return torch.amin(x, self._ax(x), keepdim=not self.squeeze)


class MM(TensorModule):
    """The (batched) product of a two-tensor table, either operand
    transposed on its last two dims."""

    def __init__(self, trans_a: bool = False, trans_b: bool = False) -> None:
        super().__init__()
        self.trans_a = trans_a
        self.trans_b = trans_b

    def forward(self, xs):
        a, b = xs
        if self.trans_a:
            a = a.transpose(-1, -2)
        if self.trans_b:
            b = b.transpose(-1, -2)
        return torch.matmul(a, b)


class MV(TensorModule):
    """The (batched) matrix-vector product of a ``[matrix, vector]``
    table."""

    def __init__(self, trans: bool = False) -> None:
        super().__init__()
        self.trans = trans

    def forward(self, xs):
        m, v = xs
        if self.trans:
            m = m.transpose(-1, -2)
        return torch.einsum("...ij,...j->...i", m, v)


class Mul(TensorModule):
    """A learnable scalar gain ``weight`` (shape ``()``, uniform in
    [-1, 1))."""

    def __init__(self, device=None, generator: torch.Generator = None) -> None:
        super().__init__()
        self.weight = new_param((), device, lambda t: t.uniform_(
            -1.0, 1.0, generator=generator))

    def forward(self, x):
        return x * self.weight


class Add(TensorModule):
    """A learnable bias vector of ``input_size`` (zeros at init)."""

    def __init__(self, input_size: int, device=None) -> None:
        super().__init__()
        self.input_size = input_size
        self.bias = new_param((input_size,), device, lambda t: t.zero_())

    def forward(self, x):
        return x + self.bias


class CMul(TensorModule):
    """A learnable per-element gain of shape ``size``, broadcast against
    the input (uniform in ±1/sqrt(its element count))."""

    def __init__(self, size, device=None,
                 generator: torch.Generator = None) -> None:
        super().__init__()
        self.size = tuple(size)
        bound = 1.0 / np.sqrt(max(int(np.prod(self.size)), 1))
        self.weight = new_param(self.size, device, lambda t: t.uniform_(
            -bound, bound, generator=generator))

    def forward(self, x):
        return x * self.weight


class CAdd(TensorModule):
    """A learnable bias of shape ``size`` (zeros at init), broadcast
    against the input."""

    def __init__(self, size, device=None) -> None:
        super().__init__()
        self.size = tuple(size)
        self.bias = new_param(self.size, device, lambda t: t.zero_())

    def forward(self, x):
        return x + self.bias
