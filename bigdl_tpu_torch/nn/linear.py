"""Linear — fully-connected layer (``bigdl_tpu/nn/linear.py``).

Weight ``(out, in)`` and ``y = x @ W.T + b``, the JAX layout, so a JAX
params leaf copies in unchanged. Default init is the reference's
``RandomUniform`` (±1/sqrt(fan_in)) for weight and bias.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.module import AbstractModule, new_param


class Linear(AbstractModule):
    def __init__(self, input_size: int, output_size: int,
                 with_bias: bool = True, device=None,
                 generator: torch.Generator = None,
                 weight_init=None, bias_init=None) -> None:
        super().__init__()
        self.input_size = input_size
        self.output_size = output_size
        self.with_bias = with_bias
        bound = 1.0 / max(input_size, 1) ** 0.5

        def uniform(t):
            t.uniform_(-bound, bound, generator=generator)

        self.weight = new_param((output_size, input_size), device,
                                weight_init or uniform)
        self.bias = (new_param((output_size,), device, bias_init or uniform)
                     if with_bias else None)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)
