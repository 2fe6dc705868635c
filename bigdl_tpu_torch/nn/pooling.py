"""Spatial pooling (``bigdl_tpu/nn/pooling.py``): ``SpatialMaxPooling``
(``:65``) and ``SpatialAveragePooling`` (``:86``).

Torch argument order ``(kW, kH, dW, dH, padW, padH)``; ``pad = -1`` is
TF-style SAME; ``ceil()`` switches the output size to ceil mode, which
becomes explicit extra bottom/right padding with the reduction's identity
(−inf for max, 0 for the average's sums), as in JAX (``_pads`` ``:50``).
The pooling functions take NCHW input; ``FusedGraph`` hands them its NHWC
values as permuted (channels-last) views.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.module import TensorModule


class _SpatialPooling(TensorModule):
    def __init__(self, kw, kh, dw=None, dh=None, pad_w=0, pad_h=0) -> None:
        super().__init__()
        self.kw, self.kh = kw, kh
        self.dw = dw if dw is not None else kw
        self.dh = dh if dh is not None else kh
        self.pad_w, self.pad_h = pad_w, pad_h
        self.ceil_mode = False

    def ceil(self):
        self.ceil_mode = True
        return self

    def floor(self):
        self.ceil_mode = False
        return self

    def _out_size(self, in_size: int, k: int, d: int, p: int) -> int:
        if p == -1:
            return -(-in_size // d)
        rnd = math.ceil if self.ceil_mode else math.floor
        out = int(rnd((in_size + 2 * p - k) / d)) + 1
        if p > 0 and (out - 1) * d >= in_size + p:
            out -= 1  # the last window must start inside the padded input
        return out

    def _pads(self, h: int, w: int, kh: int = None, kw: int = None):
        """(low, high) padding per spatial dim, ceil-mode extra included,
        for a ``kh`` x ``kw`` window (default: the module's)."""
        kh = self.kh if kh is None else kh
        kw = self.kw if kw is None else kw
        if self.pad_h == -1 or self.pad_w == -1:
            oh, ow = -(-h // self.dh), -(-w // self.dw)
            th = max((oh - 1) * self.dh + kh - h, 0)
            tw = max((ow - 1) * self.dw + kw - w, 0)
            return (th // 2, th - th // 2), (tw // 2, tw - tw // 2)
        oh = self._out_size(h, kh, self.dh, self.pad_h)
        ow = self._out_size(w, kw, self.dw, self.pad_w)
        extra_h = max((oh - 1) * self.dh + kh - h - 2 * self.pad_h, 0)
        extra_w = max((ow - 1) * self.dw + kw - w - 2 * self.pad_w, 0)
        return ((self.pad_h, self.pad_h + extra_h),
                (self.pad_w, self.pad_w + extra_w))

    def forward(self, x):
        squeeze = x.dim() == 3
        out = self.pool(x[None] if squeeze else x)
        return out[0] if squeeze else out


class SpatialMaxPooling(_SpatialPooling):
    def pool(self, x):
        (h0, h1), (w0, w1) = self._pads(x.shape[2], x.shape[3])
        x = F.pad(x, (w0, w1, h0, h1), value=float("-inf"))
        return F.max_pool2d(x, (self.kh, self.kw), (self.dh, self.dw))


class SpatialAveragePooling(_SpatialPooling):
    def __init__(self, kw, kh, dw=None, dh=None, pad_w=0, pad_h=0,
                 global_pooling: bool = False, ceil_mode: bool = False,
                 count_include_pad: bool = True, divide: bool = True) -> None:
        super().__init__(kw, kh, dw, dh, pad_w, pad_h)
        self.global_pooling = global_pooling
        self.ceil_mode = ceil_mode
        self.count_include_pad = count_include_pad
        self.divide = divide

    def pool(self, x):
        kh, kw = ((x.shape[2], x.shape[3]) if self.global_pooling
                  else (self.kh, self.kw))
        (h0, h1), (w0, w1) = self._pads(x.shape[2], x.shape[3], kh, kw)

        def window_sums(v):
            v = F.pad(v, (w0, w1, h0, h1))
            return F.avg_pool2d(v, (kh, kw), (self.dh, self.dw),
                                divisor_override=1)

        sums = window_sums(x)
        if not self.divide:
            return sums
        if self.count_include_pad:
            return sums / float(kh * kw)
        return sums / window_sums(torch.ones_like(x))
