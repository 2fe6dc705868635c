"""Linear — fully-connected layer (``bigdl_tpu/nn/linear.py``).

Weight ``(out, in)`` and ``y = x @ W.T + b``, the JAX layout, so a JAX
params leaf copies in unchanged. Default init is uniform ±1/sqrt(fan_in)
for weight and bias (JAX's ``RandomUniform`` takes the bias's own length
as its fan: ROADMAP C.1); ``init_weight``/``init_bias`` take an
:class:`~bigdl_tpu_torch.nn.init_methods.InitializationMethod` (as
``ResNet`` passes ``Xavier()``/``Zeros()``), kept as ``weight_init``/
``bias_init`` for ``reset``, and ``set_init_method`` swaps them and
refills. ``w_regularizer``/``b_regularizer``
(:mod:`bigdl_tpu_torch.optim.regularizer`) add their gradient terms in
the train step.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.init_methods import RandomUniform
from bigdl_tpu_torch.nn.module import AbstractModule, new_param


class Linear(AbstractModule):
    def __init__(self, input_size: int, output_size: int,
                 with_bias: bool = True, w_regularizer=None,
                 b_regularizer=None, device=None,
                 generator: torch.Generator = None,
                 init_weight=None, init_bias=None) -> None:
        super().__init__()
        self.input_size = input_size
        self.output_size = output_size
        self.with_bias = with_bias
        self.w_regularizer = w_regularizer
        self.b_regularizer = b_regularizer
        self._generator = generator
        bound = 1.0 / max(input_size, 1) ** 0.5
        self.weight_init = init_weight or RandomUniform()
        self.bias_init = init_bias or RandomUniform(-bound, bound)
        self.weight = new_param((output_size, input_size), device,
                                self.weight_init, generator)
        self.bias = (new_param((output_size,), device, self.bias_init,
                               generator) if with_bias else None)

    def set_init_method(self, weight_init=None, bias_init=None):
        """Set the init methods and refill the parameters with them."""
        if weight_init is not None:
            self.weight_init = weight_init
            weight_init.fill(self.weight.data, self._generator)
        if bias_init is not None:
            self.bias_init = bias_init
            if self.bias is not None:
                bias_init.fill(self.bias.data, self._generator)
        return self

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)
