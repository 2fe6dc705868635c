"""The extended layer set (``bigdl_tpu/nn/layers_extra.py``): the
similarity layers (``Cosine``, ``Euclidean``, ``DotProduct``,
``PairwiseDistance``, ``CosineDistance``, ``:48-129``) with
:func:`l2_normalize` and :func:`cosine_similarity` (``:30``, ``:37``);
the activations ``SoftMin``, ``LogSigmoid``, ``Threshold``, ``RReLU``,
``HardSigmoid``, ``TanhShrink``, ``SoftShrink``, ``HardShrink``; the
table and shape ops ``Replicate``, ``Index``, ``Masking``,
``SelectTable``, ``NarrowTable``, ``SpatialZeroPadding``, ``Scale``,
``Negative``; the gradient and noise layers ``GradientReversal``,
``L1Penalty``, ``GaussianSampler``, ``GaussianNoise``,
``GaussianDropout``; and the temporal, volumetric and dilated
convolutions, volumetric pooling, up-sampling and ``Bilinear``.

Formulas, gradients included, are the JAX layers': ``jnp.maximum`` is
``torch.maximum`` and ``jnp.clip`` is :func:`~bigdl_tpu_torch.nn.
activations.clip` (half the gradient at an exact tie); the convolutions
add their bias after the product, as JAX does, on ``F.conv1d`` /
``F.conv2d`` / ``F.conv3d`` (cuDNN on the card; XLA lowered them without
Pallas). ``GradientReversal`` and ``L1Penalty`` are identity forwards
with a hand-written backward (``torch.autograd.Function`` where JAX has
``jax.custom_vjp``). Volumetric max pooling pads with -inf and average
pooling divides the zero-padded window sum by the window's volume, as
JAX's ``reduce_window`` does. ``SpatialUpSamplingBilinear`` is JAX's own
align-corners formula, written out.

Dims and indices are 1-based (``Index``, ``SelectTable``,
``NarrowTable``; :func:`~bigdl_tpu_torch.nn.shape_ops._axis`).
``RReLU`` (training), ``GaussianSampler``, ``GaussianNoise`` and
``GaussianDropout`` (training) draw from the generator that
:func:`~bigdl_tpu_torch.nn.module.use_rng` made current (the train
step's) and are deterministic with none, as the JAX layers are with
``rng=None``: ``RReLU`` takes the slopes' midpoint, ``GaussianSampler``
returns the mean, the noise layers the input. Layers with weights make
them f32 on ``device`` from ``generator``; the params trees are JAX's.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.activations import clip
from bigdl_tpu_torch.nn.init_methods import (
    InitializationMethod, Ones, RandomUniform, Zeros)
from bigdl_tpu_torch.nn.module import (
    AbstractModule, TensorModule, current_rng, new_param,
)
from bigdl_tpu_torch.nn.shape_ops import _axis


def _batched(x: torch.Tensor, ndim: int):
    """(x with a batch dim, whether one was added) for a layer whose
    unbatched input has ``ndim - 1`` dims."""
    return (x[None], True) if x.dim() == ndim - 1 else (x, False)


# ---------------------------------------------------------------------------
# similarity / distance layers
# ---------------------------------------------------------------------------

def l2_normalize(x, axis: int = -1, eps: float = 1e-12):
    """x / max(||x||, eps) along ``axis``: the shared clamped normalizer."""
    norm = torch.linalg.vector_norm(x, dim=axis, keepdim=True)
    return x / torch.maximum(norm, norm.new_tensor(eps))


def cosine_similarity(x, y, axis: int = -1, eps: float = 1e-12):
    """Row-wise clamped cosine similarity (shared by the similarity
    layers and criteria, so the epsilon cannot drift)."""
    num = torch.sum(x * y, axis)
    den = (torch.linalg.vector_norm(x, dim=axis)
           * torch.linalg.vector_norm(y, dim=axis))
    return num / torch.maximum(den, den.new_tensor(eps))


class Cosine(TensorModule):
    """(N, in) → (N, out): cosine similarity of x to each weight row."""

    def __init__(self, input_size: int, output_size: int,
                 init_weight: Optional[InitializationMethod] = None,
                 device=None, generator: torch.Generator = None) -> None:
        super().__init__()
        self.input_size = input_size
        self.output_size = output_size
        self._generator = generator
        self.weight_init = init_weight or RandomUniform()
        self.weight = new_param((output_size, input_size), device,
                                self.weight_init, generator)

    def forward(self, x):
        return torch.matmul(l2_normalize(x), l2_normalize(self.weight).T)


class Euclidean(TensorModule):
    """(N, in) → (N, out): L2 distance of x to each weight row."""

    def __init__(self, input_size: int, output_size: int,
                 init_weight: Optional[InitializationMethod] = None,
                 device=None, generator: torch.Generator = None) -> None:
        super().__init__()
        self.input_size = input_size
        self.output_size = output_size
        self._generator = generator
        self.weight_init = init_weight or RandomUniform()
        self.weight = new_param((output_size, input_size), device,
                                self.weight_init, generator)

    def forward(self, x):
        diff = x[..., None, :] - self.weight                # (N, out, in)
        sq = torch.sum(diff * diff, -1)
        return torch.sqrt(torch.maximum(sq, sq.new_tensor(1e-24)))


class DotProduct(AbstractModule):
    """Table [x, y] → per-row dot product."""

    def forward(self, x):
        a, b = x
        return torch.sum(a * b, -1)


class PairwiseDistance(AbstractModule):
    """Table [x, y] → per-row Lp distance."""

    def __init__(self, norm: int = 2) -> None:
        super().__init__()
        self.norm = norm

    def forward(self, x):
        a, b = x
        d = torch.abs(a - b) ** self.norm
        return torch.sum(d, -1) ** (1.0 / self.norm)


class CosineDistance(AbstractModule):
    """Table [x, y] → per-row cosine SIMILARITY (the reference's name;
    not 1 - cos)."""

    def forward(self, x):
        a, b = x
        return cosine_similarity(a, b)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

class SoftMin(TensorModule):
    def forward(self, x):
        return torch.softmax(-x, dim=-1)


class LogSigmoid(TensorModule):
    def forward(self, x):
        return F.logsigmoid(x)


class Threshold(TensorModule):
    """x if x > th else v."""

    def __init__(self, th: float = 1e-6, v: float = 0.0) -> None:
        super().__init__()
        self.th = th
        self.v = v

    def forward(self, x):
        return torch.where(x > self.th, x, x.new_tensor(self.v))


class RReLU(TensorModule):
    """Randomized leaky ReLU: slope ~ U(lower, upper) per element in
    training (with a generator current), the midpoint otherwise."""

    def __init__(self, lower: float = 1.0 / 8, upper: float = 1.0 / 3) -> None:
        super().__init__()
        self.lower = lower
        self.upper = upper

    def forward(self, x):
        gen = current_rng()
        if self.training and gen is not None:
            a = torch.empty_like(x).uniform_(self.lower, self.upper,
                                             generator=gen)
        else:
            a = (self.lower + self.upper) / 2.0
        return torch.where(x >= 0, x, a * x)


class HardSigmoid(TensorModule):
    """clip(0.2x + 0.5, 0, 1)."""

    def forward(self, x):
        return clip(0.2 * x + 0.5, 0.0, 1.0)


class TanhShrink(TensorModule):
    """x - tanh(x)."""

    def forward(self, x):
        return x - torch.tanh(x)


class SoftShrink(TensorModule):
    def __init__(self, the_lambda: float = 0.5) -> None:
        super().__init__()
        self.the_lambda = the_lambda

    def forward(self, x):
        lam = self.the_lambda
        zero = x.new_zeros(())
        return torch.where(x > lam, x - lam,
                           torch.where(x < -lam, x + lam, zero))


class HardShrink(TensorModule):
    def __init__(self, the_lambda: float = 0.5) -> None:
        super().__init__()
        self.the_lambda = the_lambda

    def forward(self, x):
        return torch.where(torch.abs(x) > self.the_lambda, x,
                           x.new_zeros(()))


# ---------------------------------------------------------------------------
# shape / table utilities
# ---------------------------------------------------------------------------

class Replicate(TensorModule):
    """Insert a new axis of size ``n_features`` at 0-based axis ``dim``
    (after the batch axis for the default 1, as JAX does)."""

    def __init__(self, n_features: int, dim: int = 1) -> None:
        super().__init__()
        self.n_features = n_features
        self.dim = dim

    def forward(self, x):
        return torch.repeat_interleave(x.unsqueeze(self.dim),
                                       self.n_features, dim=self.dim)


class Index(AbstractModule):
    """Table [tensor, 1-based indices] → the slices at those indices
    along ``dimension``."""

    def __init__(self, dimension: int = 1) -> None:
        super().__init__()
        self.dimension = dimension

    def forward(self, x):
        t, idx = x
        idx = torch.as_tensor(idx, device=t.device).to(torch.int32).long()
        return torch.index_select(t, _axis(self.dimension, t.dim()),
                                  idx.reshape(-1) - 1)


class Masking(TensorModule):
    """Zero the time steps whose every feature equals ``mask_value``."""

    def __init__(self, mask_value: float = 0.0) -> None:
        super().__init__()
        self.mask_value = mask_value

    def forward(self, x):
        keep = torch.any(x != self.mask_value, dim=-1, keepdim=True)
        return x * keep


class SelectTable(AbstractModule):
    """Element ``index`` (1-based; negative counts from the end) of a
    table."""

    def __init__(self, index: int) -> None:
        super().__init__()
        self.index = index

    def forward(self, x):
        i = self.index - 1 if self.index > 0 else len(x) + self.index
        return x[i]


class NarrowTable(AbstractModule):
    """``length`` elements of a table from 1-based ``offset``."""

    def __init__(self, offset: int, length: int = 1) -> None:
        super().__init__()
        self.offset = offset
        self.length = length

    def forward(self, x):
        return list(x)[self.offset - 1: self.offset - 1 + self.length]


class SpatialZeroPadding(TensorModule):
    """Zero-pad H/W of an NCHW (or CHW) input; negative pads crop."""

    def __init__(self, pad_left: int, pad_right: int = None,
                 pad_top: int = None, pad_bottom: int = None) -> None:
        super().__init__()
        self.pl = pad_left
        self.pr = pad_right if pad_right is not None else pad_left
        self.pt = pad_top if pad_top is not None else pad_left
        self.pb = pad_bottom if pad_bottom is not None else pad_left

    def forward(self, x):
        h, w = x.shape[-2], x.shape[-1]
        # crops first (negative pads)
        x = x[..., max(0, -self.pt): h - max(0, -self.pb),
              max(0, -self.pl): w - max(0, -self.pr)]
        return F.pad(x, (max(0, self.pl), max(0, self.pr),
                         max(0, self.pt), max(0, self.pb)))


class Scale(TensorModule):
    """Learnable per-channel ``x * w + b`` (CMul + CAdd), broadcast over
    an NCHW or feature layout; ``w`` ones and ``b`` zeros at init."""

    def __init__(self, size: Sequence[int], device=None) -> None:
        super().__init__()
        self.size = tuple(size)
        self.weight_init, self.bias_init = Ones(), Zeros()
        self.weight = new_param(self.size, device, self.weight_init)
        self.bias = new_param(self.size, device, self.bias_init)

    def _broadcast(self, p, ndim):
        return p.reshape((1,) + self.size + (1,) * (ndim - 1 - len(self.size)))

    def forward(self, x):
        return (x * self._broadcast(self.weight, x.dim())
                + self._broadcast(self.bias, x.dim()))


class _Reverse(torch.autograd.Function):
    """Identity forward, ``-lambda`` times the gradient backward."""

    @staticmethod
    def forward(ctx, x, lam):
        ctx.lam = lam
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -ctx.lam * g, None


class GradientReversal(TensorModule):
    """Identity forward, ``-λ`` backward (domain-adversarial training)."""

    def __init__(self, the_lambda: float = 1.0) -> None:
        super().__init__()
        self.the_lambda = the_lambda

    def forward(self, x):
        return _Reverse.apply(x, self.the_lambda)


class _L1Penalty(torch.autograd.Function):
    """Identity forward; backward adds ``w · sign(x)`` (``w / x.numel()``
    with ``size_average``)."""

    @staticmethod
    def forward(ctx, x, w, avg):
        ctx.save_for_backward(x)
        ctx.scale = w / x.numel() if avg else w
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g + ctx.scale * torch.sign(x), None, None


class L1Penalty(TensorModule):
    """Identity forward that ADDS an L1 subgradient on the backward
    pass."""

    def __init__(self, l1_weight: float, size_average: bool = False) -> None:
        super().__init__()
        self.l1_weight = l1_weight
        self.size_average = size_average

    def forward(self, x):
        return _L1Penalty.apply(x, self.l1_weight, self.size_average)


class GaussianSampler(AbstractModule):
    """VAE reparameterization: ``[mean, log_var]`` → ``mean +
    exp(log_var / 2) · ε`` with ε drawn from the current generator; the
    mean with none (JAX's ``rng=None``)."""

    def forward(self, x):
        mean, log_var = x
        gen = current_rng()
        if gen is None:
            return mean
        eps = torch.randn(mean.shape, generator=gen, dtype=mean.dtype,
                          device=mean.device)
        return mean + torch.exp(log_var * 0.5) * eps


class Negative(TensorModule):
    def forward(self, x):
        return -x


# ---------------------------------------------------------------------------
# temporal / volumetric / dilated convolution + pooling
# ---------------------------------------------------------------------------

class TemporalConvolution(TensorModule):
    """1-D convolution over (N, T, in) → (N, T', out), VALID, stride
    ``stride_w``; weight (out, in, kW)."""

    def __init__(self, input_frame_size: int, output_frame_size: int,
                 kernel_w: int, stride_w: int = 1,
                 init_weight: Optional[InitializationMethod] = None,
                 init_bias: Optional[InitializationMethod] = None,
                 device=None, generator: torch.Generator = None) -> None:
        super().__init__()
        self.input_frame_size = input_frame_size
        self.output_frame_size = output_frame_size
        self.kernel_w = kernel_w
        self.stride_w = stride_w
        self._generator = generator
        self.weight_init = init_weight or RandomUniform()
        self.bias_init = init_bias or RandomUniform()
        self.weight = new_param(
            (output_frame_size, input_frame_size, kernel_w), device,
            self.weight_init, generator)
        self.bias = new_param((output_frame_size,), device,
                              self.bias_init, generator)

    def forward(self, x):
        x, squeeze = _batched(x, 3)
        out = F.conv1d(x.transpose(1, 2), self.weight, None, self.stride_w)
        out = out.transpose(1, 2) + self.bias
        return out[0] if squeeze else out


class VolumetricConvolution(TensorModule):
    """3-D convolution over (N, C, D, H, W); weight (out, in, kT, kH,
    kW)."""

    def __init__(self, n_input_plane: int, n_output_plane: int,
                 k_t: int, k_w: int, k_h: int,
                 d_t: int = 1, d_w: int = 1, d_h: int = 1,
                 pad_t: int = 0, pad_w: int = 0, pad_h: int = 0,
                 with_bias: bool = True,
                 init_weight: Optional[InitializationMethod] = None,
                 init_bias: Optional[InitializationMethod] = None,
                 device=None, generator: torch.Generator = None) -> None:
        super().__init__()
        self.n_input_plane = n_input_plane
        self.n_output_plane = n_output_plane
        self.k = (k_t, k_h, k_w)
        self.d = (d_t, d_h, d_w)
        self.pad = (pad_t, pad_h, pad_w)
        self.with_bias = with_bias
        self._generator = generator
        self.weight_init = init_weight or RandomUniform()
        self.bias_init = init_bias or RandomUniform()
        self.weight = new_param((n_output_plane, n_input_plane) + self.k,
                                device, self.weight_init, generator)
        if with_bias:
            self.bias = new_param((n_output_plane,), device,
                                  self.bias_init, generator)
        else:
            self.register_parameter("bias", None)

    def forward(self, x):
        x, squeeze = _batched(x, 5)
        out = F.conv3d(x, self.weight, None, self.d, self.pad)
        if self.with_bias:
            out = out + self.bias[None, :, None, None, None]
        return out[0] if squeeze else out


class _VolumetricPooling(TensorModule):
    def __init__(self, k_t: int, k_w: int, k_h: int,
                 d_t: int = None, d_w: int = None, d_h: int = None,
                 pad_t: int = 0, pad_w: int = 0, pad_h: int = 0) -> None:
        super().__init__()
        self.k = (k_t, k_h, k_w)
        self.d = (d_t or k_t, d_h or k_h, d_w or k_w)
        self.pad = (pad_t, pad_h, pad_w)

    def _padded(self, x, value):
        """x with its (T, H, W) padding written in, as ``reduce_window``
        pads."""
        pt, ph, pw = self.pad
        if not any(self.pad):
            return x
        return F.pad(x, (pw, pw, ph, ph, pt, pt), value=value)


class VolumetricMaxPooling(_VolumetricPooling):
    def forward(self, x):
        x, squeeze = _batched(x, 5)
        out = F.max_pool3d(self._padded(x, float("-inf")), self.k, self.d)
        return out[0] if squeeze else out


class VolumetricAveragePooling(_VolumetricPooling):
    def forward(self, x):
        x, squeeze = _batched(x, 5)
        sums = F.avg_pool3d(self._padded(x, 0.0), self.k, self.d,
                            divisor_override=1)
        out = sums / float(np.prod(self.k))
        return out[0] if squeeze else out


class SpatialDilatedConvolution(TensorModule):
    """2-D convolution with dilation; weight (out, in, kH, kW)."""

    def __init__(self, n_input_plane: int, n_output_plane: int,
                 kw: int, kh: int, dw: int = 1, dh: int = 1,
                 pad_w: int = 0, pad_h: int = 0,
                 dilation_w: int = 1, dilation_h: int = 1,
                 with_bias: bool = True,
                 init_weight: Optional[InitializationMethod] = None,
                 init_bias: Optional[InitializationMethod] = None,
                 device=None, generator: torch.Generator = None) -> None:
        super().__init__()
        self.n_input_plane = n_input_plane
        self.n_output_plane = n_output_plane
        self.kw, self.kh = kw, kh
        self.dw, self.dh = dw, dh
        self.pad_w, self.pad_h = pad_w, pad_h
        self.dilation_w, self.dilation_h = dilation_w, dilation_h
        self.with_bias = with_bias
        self._generator = generator
        self.weight_init = init_weight or RandomUniform()
        self.bias_init = init_bias or RandomUniform()
        self.weight = new_param((n_output_plane, n_input_plane, kh, kw),
                                device, self.weight_init, generator)
        if with_bias:
            self.bias = new_param((n_output_plane,), device,
                                  self.bias_init, generator)
        else:
            self.register_parameter("bias", None)

    def forward(self, x):
        x, squeeze = _batched(x, 4)
        out = F.conv2d(x, self.weight, None, (self.dh, self.dw),
                       (self.pad_h, self.pad_w),
                       (self.dilation_h, self.dilation_w))
        if self.with_bias:
            out = out + self.bias[None, :, None, None]
        return out[0] if squeeze else out


class SpatialUpSamplingNearest(TensorModule):
    """Nearest-neighbour ×scale up-sampling of the last two axes."""

    def __init__(self, scale: int) -> None:
        super().__init__()
        self.scale = scale

    def forward(self, x):
        x = torch.repeat_interleave(x, self.scale, dim=x.dim() - 2)
        return torch.repeat_interleave(x, self.scale, dim=x.dim() - 1)


class SpatialUpSamplingBilinear(TensorModule):
    """Bilinear ×scale up-sampling of NCHW (align-corners, the
    reference's), JAX's formula: four gathers weighted by the grid's
    fractional parts, in JAX's order of terms."""

    def __init__(self, scale: int) -> None:
        super().__init__()
        self.scale = scale

    def forward(self, x):
        x, squeeze = _batched(x, 4)
        _, _, h, w = x.shape
        oh, ow = h * self.scale, w * self.scale
        dev = x.device

        def grid(o, i):
            if o == 1 or i == 1:
                return torch.zeros((o,), device=dev)
            return torch.arange(o, device=dev) * (i - 1) / (o - 1)

        ys, xs = grid(oh, h), grid(ow, w)
        y0 = torch.clamp(torch.floor(ys).long(), 0, h - 1)
        x0 = torch.clamp(torch.floor(xs).long(), 0, w - 1)
        y1 = torch.clamp(y0 + 1, max=h - 1)
        x1 = torch.clamp(x0 + 1, max=w - 1)
        wy = (ys - y0)[None, None, :, None]
        wx = (xs - x0)[None, None, None, :]

        def g(yy, xx):
            return x[:, :, yy][:, :, :, xx]

        out = ((1 - wy) * (1 - wx) * g(y0, x0) + (1 - wy) * wx * g(y0, x1)
               + wy * (1 - wx) * g(y1, x0) + wy * wx * g(y1, x1))
        return out[0] if squeeze else out


class GaussianNoise(TensorModule):
    """Additive N(0, stddev²) noise in training (with a generator
    current); the identity otherwise."""

    def __init__(self, stddev: float) -> None:
        super().__init__()
        self.stddev = stddev

    def forward(self, x):
        gen = current_rng()
        if not self.training or gen is None:
            return x
        return x + self.stddev * torch.randn(
            x.shape, generator=gen, dtype=x.dtype, device=x.device)


class GaussianDropout(TensorModule):
    """Multiplicative 1 + N(0, rate / (1 - rate)) noise in training (with
    a generator current); the identity otherwise."""

    def __init__(self, rate: float) -> None:
        super().__init__()
        if not 0.0 <= rate < 1.0:
            raise ValueError(f"GaussianDropout rate {rate} not in [0, 1)")
        self.rate = rate

    def forward(self, x):
        gen = current_rng()
        if not self.training or gen is None or self.rate == 0.0:
            return x
        stddev = (self.rate / (1.0 - self.rate)) ** 0.5
        noise = 1.0 + stddev * torch.randn(x.shape, generator=gen,
                                           dtype=x.dtype, device=x.device)
        return x * noise


class Bilinear(AbstractModule):
    """``out_k = x1ᵀ W_k x2 + b_k`` over a table ``[x1 (N, d1), x2 (N,
    d2)]``; weight (out, d1, d2), the bias drawn by ``init_weight`` too
    (JAX's)."""

    def __init__(self, input_size1: int, input_size2: int, output_size: int,
                 bias_res: bool = True,
                 init_weight: Optional[InitializationMethod] = None,
                 device=None, generator: torch.Generator = None) -> None:
        super().__init__()
        self.input_size1 = input_size1
        self.input_size2 = input_size2
        self.output_size = output_size
        self.bias_res = bias_res
        self._generator = generator
        # the bias is drawn by the weight's law, as JAX's is
        self.weight_init = self.bias_init = init_weight or RandomUniform()
        self.weight = new_param((output_size, input_size1, input_size2),
                                device, self.weight_init, generator)
        if bias_res:
            self.bias = new_param((output_size,), device,
                                  self.bias_init, generator)
        else:
            self.register_parameter("bias", None)

    def forward(self, x):
        x1, x2 = x
        out = torch.einsum("ni,oij,nj->no", x1, self.weight, x2)
        return out + self.bias if self.bias_res else out
