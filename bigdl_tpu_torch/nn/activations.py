"""Activation layers (``bigdl_tpu/nn/activations.py``): ``ReLU``,
``ReLU6``, ``Tanh``, ``Sigmoid``, ``SoftMax``, ``LogSoftMax``, ``PReLU``,
``ELU``, ``LeakyReLU``, ``HardTanh``, ``SoftPlus``, ``SoftSign`` and
``GELU``.

Each follows the JAX layer's formula, gradient included: a clip is
``minimum(max, maximum(min, x))`` (:func:`clip`, ``jnp.clip``), which
passes half the gradient at an exact bound, where ``torch.clamp`` passes
all of it; ``jnp.where`` forms stay ``torch.where``; ``SoftPlus`` is
``logaddexp(βx, 0) / β`` (``jax.nn.softplus``, no linear threshold) and
``GELU`` is the tanh form (``jax.nn.gelu``'s default). The ``inplace``
flags are accepted and ignored, as in the JAX package.
"""

from __future__ import annotations

import torch

from bigdl_tpu_torch.nn.init_methods import ConstInitMethod
from bigdl_tpu_torch.nn.module import AbstractModule, TensorModule, new_param


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)``: ``minimum(hi, maximum(lo, x))``, whose
    gradient at an exact bound is half the incoming one (a tie of the
    max or min), as JAX's."""
    x = torch.maximum(x, x.new_tensor(lo))
    return torch.minimum(x, x.new_tensor(hi))


class ReLU(TensorModule):
    """``max(x, 0)``, with the JAX package's gradient (``jnp.maximum``):
    half the incoming gradient where x is exactly 0, a tie, where
    ``torch.relu`` passes none. Exact zeros are common in ResNets: the
    zero-padded channels of a type-A shortcut, and a zero-initialized
    BN's output added to a ReLU'd identity. ``ip`` (in place) is accepted
    and ignored, as in the JAX package: an in-place ReLU on a tensor
    autograd saved for the backward would corrupt it."""

    def __init__(self, ip: bool = False) -> None:
        super().__init__()
        self.inplace = ip

    def forward(self, x):
        return torch.maximum(x, x.new_zeros(()))


class ReLU6(TensorModule):
    """``clip(x, 0, 6)`` (``activations.py:29``)."""

    def forward(self, x):
        return clip(x, 0.0, 6.0)


class Tanh(TensorModule):
    """``tanh(x)`` (``bigdl_tpu/nn/activations.py:36``)."""

    def forward(self, x):
        return torch.tanh(x)


class Sigmoid(TensorModule):
    def forward(self, x):
        return torch.sigmoid(x)


class SoftMax(TensorModule):
    """Softmax over the feature dim: the last for 1-D and 2-D input, the
    channel (dim 1) for 3-D and 4-D, JAX's axis rule (``:50``)."""

    def forward(self, x):
        return torch.softmax(x, dim=-1 if x.dim() <= 2 else 1)


class LogSoftMax(AbstractModule):
    def forward(self, x):
        return torch.log_softmax(x, dim=-1)


class PReLU(TensorModule):
    """``where(x > 0, x, a·x)`` with a learnable slope ``weight`` (0.25 at
    init): one per channel (dim 1 of 2-D and 4-D input, dim 0 of 3-D
    input) with ``n_output_plane > 0``, else one shared slope."""

    def __init__(self, n_output_plane: int = 0, device=None) -> None:
        super().__init__()
        self.n_output_plane = n_output_plane
        n = n_output_plane if n_output_plane > 0 else 1
        self.weight_init = ConstInitMethod(0.25)
        self.weight = new_param((n,), device, self.weight_init)

    def forward(self, x):
        w = self.weight
        if self.n_output_plane > 0 and x.dim() >= 3:
            w = w[None, :, None, None] if x.dim() == 4 else w[:, None, None]
        elif self.n_output_plane > 0 and x.dim() == 2:
            w = w[None, :]
        return torch.where(x > 0, x, w * x)


class ELU(TensorModule):
    def __init__(self, alpha: float = 1.0, inplace: bool = False) -> None:
        super().__init__()
        self.alpha = alpha

    def forward(self, x):
        return torch.where(x > 0, x, self.alpha * (torch.exp(x) - 1.0))


class LeakyReLU(TensorModule):
    def __init__(self, negval: float = 0.01, inplace: bool = False) -> None:
        super().__init__()
        self.negval = negval

    def forward(self, x):
        return torch.where(x > 0, x, self.negval * x)


class HardTanh(TensorModule):
    def __init__(self, min_value: float = -1.0, max_value: float = 1.0,
                 inplace: bool = False) -> None:
        super().__init__()
        self.min_value = min_value
        self.max_value = max_value

    def forward(self, x):
        return clip(x, self.min_value, self.max_value)


class SoftPlus(TensorModule):
    """``log(1 + exp(βx)) / β`` as ``logaddexp(βx, 0) / β``."""

    def __init__(self, beta: float = 1.0) -> None:
        super().__init__()
        self.beta = beta

    def forward(self, x):
        return torch.logaddexp(self.beta * x, x.new_zeros(())) / self.beta


class SoftSign(TensorModule):
    def forward(self, x):
        return x / (1.0 + torch.abs(x))


class GELU(TensorModule):
    """The tanh approximation, ``jax.nn.gelu``'s default form."""

    def forward(self, x):
        return torch.nn.functional.gelu(x, approximate="tanh")
