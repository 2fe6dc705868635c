"""Batch normalization (``bigdl_tpu/nn/normalization.py``):
``BatchNormalization`` (``:24``) over (N, D) and
``SpatialBatchNormalization`` (``:128``) per channel over (N, C, H, W);
``SpatialCrossMapLRN`` (``:132``), the local response normalization
across channels; and ``Normalize`` (``:165``), the Lp normalization of
dim 1.

The semantics of the JAX ``apply`` (``:78-125``), kept exactly (which is
why ``F.batch_norm``, with its own variance and momentum conventions, is
not used):

* batch statistics accumulate in at least f32; for inputs narrower than
  the accumulator the variance is the fused ``E[x²] − E[x]²`` (clamped at
  0), for f32 inputs the two-pass form;
* the output normalizes with the biased batch variance, and the running
  buffer stores the unbiased one: ``r = (1 − m)·r + m·batch``;
* only the per-channel factors are cast to the input dtype; the
  elementwise math runs in the input dtype (bf16 under bf16 compute).

``running_mean``/``running_var`` are f32 buffers, updated IN PLACE under
``torch.no_grad()``, so a step run through ``torch.func.functional_call``
updates the buffer tensors it was handed (the train step's
``model_state``), as the JAX ``apply`` returns its new state.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.init_methods import InitializationMethod, Ones, Zeros
from bigdl_tpu_torch.nn.module import TensorModule, new_param


def batch_moments(x, axes, fused: bool):
    """(mean, biased var) over ``axes`` in at least f32. ``fused`` takes
    ``max(E[x²] − E[x]², 0)``, else the two-pass variance."""
    acc = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(acc)
    mean = xf.mean(dim=axes)
    if fused:
        var = torch.clamp_min((xf * xf).mean(dim=axes) - mean * mean, 0.0)
    else:
        var = xf.var(dim=axes, correction=0)
    return mean, var


def update_running(module, mean, var, n: int) -> None:
    """``r = (1 − m)·r + m·batch`` for both buffers, the variance made
    unbiased first; in place, outside autograd."""
    m = module.momentum
    with torch.no_grad():
        unbiased = var.detach() * (n / max(n - 1, 1))
        module.running_mean.copy_((1 - m) * module.running_mean
                                  + m * mean.detach())
        module.running_var.copy_((1 - m) * module.running_var + m * unbiased)


class BatchNormalization(TensorModule):
    """Batch norm over (N, D) (and, as the spatial subclass, (N, C, H, W))
    input, channel axis 1."""

    def __init__(self, n_output: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True,
                 init_weight: Optional[InitializationMethod] = None,
                 init_bias: Optional[InitializationMethod] = None,
                 device=None, generator=None) -> None:
        super().__init__()
        self.n_output = n_output
        self.eps = eps
        self.momentum = momentum
        self.affine = affine
        self._generator = generator
        self.weight_init = init_weight or Ones()
        self.bias_init = init_bias or Zeros()
        if affine:
            self.weight = new_param(
                (n_output,), device,
                lambda t: self.weight_init.fill(t, generator))
            self.bias = new_param(
                (n_output,), device,
                lambda t: self.bias_init.fill(t, generator))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)
        self.register_buffer("running_mean", torch.zeros(
            n_output, dtype=torch.float32, device=device))
        self.register_buffer("running_var", torch.ones(
            n_output, dtype=torch.float32, device=device))

    def set_init_method(self, weight_init=None, bias_init=None):
        """Set the init methods and refill the parameters with them."""
        if weight_init is not None:
            self.weight_init = weight_init
            if self.affine:
                weight_init.fill(self.weight.data, self._generator)
        if bias_init is not None:
            self.bias_init = bias_init
            if self.affine:
                bias_init.fill(self.bias.data, self._generator)
        return self

    def forward(self, x):
        axes = tuple(i for i in range(x.dim()) if i != 1)
        shape = [1] * x.dim()
        shape[1] = -1
        if self.training:
            acc = torch.promote_types(x.dtype, torch.float32)
            narrow = torch.finfo(x.dtype).bits < torch.finfo(acc).bits
            mean, var = batch_moments(x, axes, fused=narrow)
            n = x.numel() // x.shape[1]
            update_running(self, mean, var, n)
        else:
            mean, var = self.running_mean, self.running_var
        inv = 1.0 / torch.sqrt(var + self.eps)
        out = ((x - mean.to(x.dtype).reshape(shape))
               * inv.to(x.dtype).reshape(shape))
        if self.affine:
            out = out * self.weight.reshape(shape) + self.bias.reshape(shape)
        return out


class SpatialBatchNormalization(BatchNormalization):
    """Per-channel BN over (N, C, H, W): the same math, channel axis 1."""


class SpatialCrossMapLRN(TensorModule):
    """``out = x / (k + alpha/size * window_sum(x²))^beta``, the window
    ``size`` channels wide, padded (half, size - 1 - half) with half =
    (size - 1) // 2 as JAX pads it. ``F.local_response_norm`` pads
    (size // 2, (size - 1) // 2), which differs for an even ``size``, so
    the window sum is written out: a zero pad and a box sum over the
    channel axis."""

    def __init__(self, size: int = 5, alpha: float = 1.0, beta: float = 0.75,
                 k: float = 1.0) -> None:
        super().__init__()
        self.size = size
        self.alpha = alpha
        self.beta = beta
        self.k = k

    def forward(self, x):
        squeeze = x.dim() == 3
        if squeeze:
            x = x[None]
        half = (self.size - 1) // 2
        sq = F.pad(x * x, (0, 0, 0, 0, half, self.size - 1 - half))
        # (N, C + size - 1, H, W) → sum of `size` consecutive channels
        window_sum = sq.unfold(1, self.size, 1).sum(dim=-1)
        out = x / (self.k + (self.alpha / self.size) * window_sum) ** self.beta
        return out[0] if squeeze else out


class Normalize(TensorModule):
    """Lp-normalize along dim 1: ``x / (‖x‖_p + eps)`` with the norm
    ``sum(|x|^p, dim 1) ** (1/p)`` (``normalization.py:165``)."""

    def __init__(self, p: float = 2.0, eps: float = 1e-10) -> None:
        super().__init__()
        self.p = p
        self.eps = eps

    def forward(self, x):
        norm = (torch.abs(x) ** self.p).sum(1, keepdim=True) ** (1.0 / self.p)
        return x / (norm + self.eps)
