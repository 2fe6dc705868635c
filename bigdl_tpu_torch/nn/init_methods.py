"""Initialization methods (``bigdl_tpu/nn/init_methods.py``): ``Zeros``,
``Ones``, ``ConstInitMethod``, ``RandomUniform``, ``RandomNormal``,
``Xavier``, ``MsraFiller`` and ``BilinearFiller``.

Each method fills a tensor IN PLACE from an explicit ``torch.Generator``
(``fill(tensor, generator)``), the PyTorch counterpart of the JAX
``init(rng, shape)``. The distributions and the fan rule are the JAX
package's (Torch convention): a conv weight ``(out, in, kH, kW)`` has
fan_in = in·kH·kW and fan_out = out·kH·kW, a linear weight ``(out, in)``
fan_in = in and fan_out = out. The numbers differ from JAX's for the same
seed (another generator); the parity tests copy weights across instead.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def _fans(shape: Tuple[int, ...]) -> Tuple[int, int]:
    if len(shape) == 2:
        fan_out, fan_in = shape
    elif len(shape) >= 3:
        receptive = int(np.prod(shape[2:]))
        fan_out = shape[0] * receptive
        fan_in = shape[1] * receptive
    elif len(shape) == 1:
        fan_in = fan_out = shape[0]
    else:
        fan_in = fan_out = 1
    return int(fan_in), int(fan_out)


class InitializationMethod:
    def fill(self, t: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Fill ``t`` in place (under ``torch.no_grad()``); returns it."""
        raise NotImplementedError


class Zeros(InitializationMethod):
    def fill(self, t, generator=None):
        with torch.no_grad():
            return t.zero_()


class Ones(InitializationMethod):
    def fill(self, t, generator=None):
        with torch.no_grad():
            return t.fill_(1.0)


class ConstInitMethod(InitializationMethod):
    def __init__(self, value: float) -> None:
        self.value = value

    def fill(self, t, generator=None):
        with torch.no_grad():
            return t.fill_(self.value)


class RandomUniform(InitializationMethod):
    """Uniform(lower, upper); the no-argument form is the Torch default
    ±1/sqrt(fan_in)."""

    def __init__(self, lower: float = None, upper: float = None) -> None:
        self.lower = lower
        self.upper = upper

    def fill(self, t, generator=None):
        if self.lower is None:
            bound = 1.0 / np.sqrt(max(_fans(tuple(t.shape))[0], 1))
            lo, hi = -bound, bound
        else:
            lo, hi = self.lower, self.upper
        with torch.no_grad():
            return t.uniform_(lo, hi, generator=generator)


class RandomNormal(InitializationMethod):
    def __init__(self, mean: float = 0.0, stdv: float = 1.0) -> None:
        self.mean = mean
        self.stdv = stdv

    def fill(self, t, generator=None):
        with torch.no_grad():
            return t.normal_(self.mean, self.stdv, generator=generator)


class Xavier(InitializationMethod):
    """Glorot uniform: ±sqrt(6/(fan_in+fan_out))."""

    def fill(self, t, generator=None):
        fan_in, fan_out = _fans(tuple(t.shape))
        bound = float(np.sqrt(6.0 / (fan_in + fan_out)))
        with torch.no_grad():
            return t.uniform_(-bound, bound, generator=generator)


class MsraFiller(InitializationMethod):
    """He init, N(0, sqrt(2/n)) with n = fan_in, or the fans' mean when
    ``variance_norm_average``."""

    def __init__(self, variance_norm_average: bool = True) -> None:
        self.variance_norm_average = variance_norm_average

    def fill(self, t, generator=None):
        fan_in, fan_out = _fans(tuple(t.shape))
        n = (fan_in + fan_out) / 2.0 if self.variance_norm_average else fan_in
        std = float(np.sqrt(2.0 / max(n, 1.0)))
        with torch.no_grad():
            return t.normal_(0.0, std, generator=generator)


class BilinearFiller(InitializationMethod):
    """The bilinear-upsampling kernel for a deconvolution weight (4-D or
    more): every ``(..., kH, kW)`` slice holds the same filter, drawn
    from no generator (``init_methods.py:119``)."""

    def fill(self, t, generator=None):
        shape = tuple(t.shape)
        if len(shape) < 4:
            raise ValueError("BilinearFiller needs a 4D+ weight")
        kh, kw = shape[-2], shape[-1]
        f_h, f_w = np.ceil(kh / 2.0), np.ceil(kw / 2.0)
        c_h = (2 * f_h - 1 - f_h % 2) / (2.0 * f_h)
        c_w = (2 * f_w - 1 - f_w % 2) / (2.0 * f_w)
        yy, xx = np.meshgrid(np.arange(kh), np.arange(kw), indexing="ij")
        filt = (1 - np.abs(yy / f_h - c_h)) * (1 - np.abs(xx / f_w - c_w))
        w = np.broadcast_to(filt.astype(np.float32), shape)
        with torch.no_grad():
            return t.copy_(torch.from_numpy(np.ascontiguousarray(w)))
