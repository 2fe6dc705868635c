"""SpatialConvolution (``bigdl_tpu/nn/conv.py:28``) and
SpatialFullConvolution (``:120``), the transposed convolution.

Torch argument order ``(nInputPlane, nOutputPlane, kW, kH, dW, dH, padW,
padH, nGroup)``, weight OIHW (groups folded into O), NCHW activations,
``padW = padH = -1`` for TF-style SAME padding. The convolution itself is
``F.conv2d`` (cuDNN on the card), as the JAX package leaves it to
``lax.conv_general_dilated`` outside Pallas.

``SpatialFullConvolution`` keeps the JAX weight layout ``(nInputPlane,
nOutputPlane / nGroup, kH, kW)``, which is ``F.conv_transpose2d``'s, and
its output size ``(in - 1)·stride - 2·pad + k + adj``: JAX's
lhs-dilated convolution with the flipped kernel and padding ``(k - 1 -
pad, k - 1 - pad + adj)`` is the transposed convolution with padding
``pad`` and output padding ``adj``.
"""

from __future__ import annotations

from typing import Optional

import torch.nn.functional as F

from bigdl_tpu_torch.nn.init_methods import InitializationMethod, RandomUniform
from bigdl_tpu_torch.nn.module import TensorModule, new_param


def same_pads(size: int, k: int, stride: int):
    """(low, high) padding of TF-style SAME along one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class SpatialConvolution(TensorModule):
    def __init__(self, n_input_plane: int, n_output_plane: int,
                 kernel_w: int, kernel_h: int, stride_w: int = 1,
                 stride_h: int = 1, pad_w: int = 0, pad_h: int = 0,
                 n_group: int = 1, propagate_back: bool = True,
                 with_bias: bool = True, w_regularizer=None,
                 b_regularizer=None,
                 init_weight: Optional[InitializationMethod] = None,
                 init_bias: Optional[InitializationMethod] = None,
                 device=None, generator=None) -> None:
        super().__init__()
        if n_input_plane % n_group or n_output_plane % n_group:
            raise ValueError("n_group must divide both plane counts")
        self.n_input_plane = n_input_plane
        self.n_output_plane = n_output_plane
        self.kernel_w, self.kernel_h = kernel_w, kernel_h
        self.stride_w, self.stride_h = stride_w, stride_h
        self.pad_w, self.pad_h = pad_w, pad_h
        self.n_group = n_group
        self.propagate_back = propagate_back
        self.with_bias = with_bias
        self.w_regularizer = w_regularizer
        self.b_regularizer = b_regularizer
        self._generator = generator
        self.weight_init = init_weight or RandomUniform()
        self.bias_init = init_bias or RandomUniform()
        shape = (n_output_plane, n_input_plane // n_group, kernel_h, kernel_w)
        self.weight = new_param(shape, device,
                                self.weight_init, generator)
        if with_bias:
            self.bias = new_param((n_output_plane,), device,
                                  self.bias_init, generator)
        else:
            self.register_parameter("bias", None)

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

    def _padding(self, h: int, w: int):
        """((low, high) along H, (low, high) along W)."""
        if self.pad_w == -1 or self.pad_h == -1:
            return (same_pads(h, self.kernel_h, self.stride_h),
                    same_pads(w, self.kernel_w, self.stride_w))
        return (self.pad_h, self.pad_h), (self.pad_w, self.pad_w)

    def conv(self, x, weight, bias):
        """The convolution of NCHW ``x`` with the given weight and bias."""
        (ph0, ph1), (pw0, pw1) = self._padding(x.shape[-2], x.shape[-1])
        if ph0 != ph1 or pw0 != pw1:
            x = F.pad(x, (pw0, pw1, ph0, ph1))
            ph0 = pw0 = 0
        return F.conv2d(x, weight, bias, (self.stride_h, self.stride_w),
                        (ph0, pw0), 1, self.n_group)

    def forward(self, x):
        squeeze = x.dim() == 3
        out = self.conv(x[None] if squeeze else x, self.weight, self.bias)
        return out[0] if squeeze else out

    def extra_repr(self) -> str:
        return (f"{self.n_input_plane} -> {self.n_output_plane}, "
                f"{self.kernel_w}x{self.kernel_h}, "
                f"{self.stride_w}x{self.stride_h}, {self.pad_w},{self.pad_h}")


class SpatialFullConvolution(TensorModule):
    def __init__(self, n_input_plane: int, n_output_plane: int,
                 kernel_w: int, kernel_h: int, stride_w: int = 1,
                 stride_h: int = 1, pad_w: int = 0, pad_h: int = 0,
                 adj_w: int = 0, adj_h: int = 0, n_group: int = 1,
                 no_bias: bool = False,
                 init_weight: Optional[InitializationMethod] = None,
                 init_bias: Optional[InitializationMethod] = None,
                 device=None, generator=None) -> None:
        super().__init__()
        if n_input_plane % n_group or n_output_plane % n_group:
            raise ValueError("n_group must divide both plane counts")
        self.n_input_plane = n_input_plane
        self.n_output_plane = n_output_plane
        self.kernel_w, self.kernel_h = kernel_w, kernel_h
        self.stride_w, self.stride_h = stride_w, stride_h
        self.pad_w, self.pad_h = pad_w, pad_h
        self.adj_w, self.adj_h = adj_w, adj_h
        self.n_group = n_group
        self.with_bias = not no_bias
        self.weight_init = init_weight or RandomUniform()
        self.bias_init = init_bias or RandomUniform()
        shape = (n_input_plane, n_output_plane // n_group, kernel_h, kernel_w)
        self.weight = new_param(shape, device,
                                self.weight_init, generator)
        if self.with_bias:
            self.bias = new_param((n_output_plane,), device,
                                  self.bias_init, generator)
        else:
            self.register_parameter("bias", None)

    def forward(self, x):
        squeeze = x.dim() == 3
        out = F.conv_transpose2d(
            x[None] if squeeze else x, self.weight, self.bias,
            (self.stride_h, self.stride_w), (self.pad_h, self.pad_w),
            (self.adj_h, self.adj_w), self.n_group)
        return out[0] if squeeze else out

    def extra_repr(self) -> str:
        return (f"{self.n_input_plane} -> {self.n_output_plane}, "
                f"{self.kernel_w}x{self.kernel_h}, "
                f"{self.stride_w}x{self.stride_h}, {self.pad_w},{self.pad_h}, "
                f"adj {self.adj_w},{self.adj_h}")
