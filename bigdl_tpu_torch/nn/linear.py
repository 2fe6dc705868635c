"""Linear — fully-connected layer (``bigdl_tpu/nn/linear.py``).

Weight ``(out, in)`` and ``y = x @ W.T + b``, the JAX layout, so a JAX
params leaf copies in unchanged. Default init is the reference's
``RandomUniform`` (±1/sqrt(fan_in)) for weight and bias;
``init_weight``/``init_bias`` take an
:class:`~bigdl_tpu_torch.nn.init_methods.InitializationMethod` (as
``ResNet`` passes ``Xavier()``/``Zeros()``), ``weight_init``/``bias_init``
a callable that fills the tensor. ``w_regularizer``/``b_regularizer``
(:mod:`bigdl_tpu_torch.optim.regularizer`) add their gradient terms in
the train step.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.module import AbstractModule, new_param


class Linear(AbstractModule):
    def __init__(self, input_size: int, output_size: int,
                 with_bias: bool = True, w_regularizer=None,
                 b_regularizer=None, device=None,
                 generator: torch.Generator = None,
                 weight_init=None, bias_init=None,
                 init_weight=None, init_bias=None) -> None:
        super().__init__()
        self.input_size = input_size
        self.output_size = output_size
        self.with_bias = with_bias
        self.w_regularizer = w_regularizer
        self.b_regularizer = b_regularizer
        bound = 1.0 / max(input_size, 1) ** 0.5

        def uniform(t):
            t.uniform_(-bound, bound, generator=generator)

        if init_weight is not None:
            def weight_init(t):
                init_weight.fill(t, generator)
        if init_bias is not None:
            def bias_init(t):
                init_bias.fill(t, generator)

        self.weight = new_param((output_size, input_size), device,
                                weight_init or uniform)
        self.bias = (new_param((output_size,), device, bias_init or uniform)
                     if with_bias else None)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)
