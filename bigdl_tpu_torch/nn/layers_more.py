"""The third layer batch (``bigdl_tpu/nn/layers_more.py``): the table
and shape ops ``Pack``, ``Tile``, ``Reverse``, ``InferReshape``,
``BifurcateSplitTable``, ``MixtureTable``, ``MaskedSelect`` and
``DenseToSparse``; ``SReLU`` (``:187``) and ``Maxout`` (``:228``); the
temporal pooling, volumetric padding, up-sampling and cropping layers;
the convolutions ``VolumetricFullConvolution`` (``:437``),
``LocallyConnected2D``/``1D`` (``:502``, ``:568``),
``SpatialShareConvolution``, ``SpatialSeparableConvolution`` (``:645``)
and ``SpatialConvolutionMap`` (``:939``); ``SpatialDropout1D/2D/3D``
(``:709-772``); the local normalizations (``SpatialWithinChannelLRN``,
``SpatialSubtractive/Divisive/ContrastiveNormalization`` over
:func:`_local_mean_conv`, ``:774-905``) and ``NegativeEntropyPenalty``
(``:906``).

Formulas and gradients are the JAX layers' (``jnp.maximum`` is
``torch.maximum``, ``jnp.max`` over a pool is ``amax``, which splits the
gradient between tied maxima). Notes on the port:

* ``MaskedSelect`` and ``DenseToSparse`` have data-dependent output
  shapes: JAX runs them on the host outside ``jit``; on the card each
  reads one count back to the host (``masked_select``'s, the nonzero
  count), so no step that claims to be free of host reads may hold them.
* The temporal poolings' ``"SAME"`` mode pads as ``reduce_window``'s
  SAME does (low ``total // 2``), max with -inf and average with zeros,
  dividing by the count of real elements in each window.
* ``LocallyConnected2D``/``1D`` hold one weight per output position,
  ``(positions, out, in · kernel)`` in JAX's layout: the patches come
  from ``F.unfold`` (channel-major, as ``conv_general_dilated_patches``)
  and one ``einsum`` contracts them.
* ``VolumetricFullConvolution`` keeps JAX's weight layout ``(in, out /
  groups, kT, kH, kW)``, which is ``F.conv_transpose3d``'s, with ``adj``
  as its output padding (``adj`` below the stride, as PyTorch requires).
* ``SpatialSeparableConvolution`` is a depthwise convolution with
  ``depth_multiplier`` maps per input plane, then a 1×1 pointwise one;
  ``SpatialShareConvolution`` is ``SpatialConvolution``;
  ``SpatialConvolutionMap`` scatters its per-connection kernels into a
  dense ``(out, in, kH, kW)`` weight (zeros where the 1-based connection
  table has no row) and runs one convolution.
* ``_local_mean_conv`` divides by the coefficient map, the share of the
  kernel's mass inside the image, so the borders are Torch7's;
  ``SpatialContrastiveNormalization`` is the subtractive form then the
  divisive one, whose local deviation below ``threshold`` is replaced by
  ``thresval`` and then raised to at least its per-image mean.
* ``SpatialDropout1D/2D/3D`` drop whole channels with one keep mask per
  (sample, channel), drawn from the current generator in training (the
  identity with none, in eval mode or at p = 0), scaled by 1 / keep.
* ``NegativeEntropyPenalty`` is an identity forward whose backward adds
  ``beta · (log max(x, 1e-12) + 1)`` (a ``torch.autograd.Function``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.conv import SpatialConvolution
from bigdl_tpu_torch.nn.init_methods import (
    InitializationMethod, Ones, RandomUniform, Xavier, Zeros,
)
from bigdl_tpu_torch.nn.layers_extra import _batched
from bigdl_tpu_torch.nn.misc import keep_mask
from bigdl_tpu_torch.nn.module import (
    AbstractModule, TensorModule, current_rng, new_param,
)
from bigdl_tpu_torch.nn.shape_ops import _axis
from bigdl_tpu_torch.tensor.sparse import SparseTensor


def _format(data_format: str, allowed) -> None:
    if data_format not in allowed:
        raise ValueError(f"data_format {data_format!r} not in {allowed}")


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """(low, high) padding of ``reduce_window``'s SAME along one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


# ---------------------------------------------------------------------------
# table / shape utilities
# ---------------------------------------------------------------------------

class Pack(AbstractModule):
    """Stack a table of same-shaped tensors along a new 1-based ``dim``."""

    def __init__(self, dim: int = 1) -> None:
        super().__init__()
        self.dim = dim

    def forward(self, x):
        seq = x if isinstance(x, (list, tuple)) else [x]
        return torch.stack(list(seq), dim=self.dim - 1)


class Tile(AbstractModule):
    """Concatenate ``copies`` copies of the input along 1-based ``dim``."""

    def __init__(self, dim: int = 1, copies: int = 2) -> None:
        super().__init__()
        self.dim = dim
        self.copies = copies

    def forward(self, x):
        return torch.cat([x] * self.copies, dim=_axis(self.dim, x.dim()))


class Reverse(AbstractModule):
    """Flip the input along 1-based ``dim``."""

    def __init__(self, dim: int = 1) -> None:
        super().__init__()
        self.dim = dim

    def forward(self, x):
        return torch.flip(x, (_axis(self.dim, x.dim()),))


class InferReshape(AbstractModule):
    """Reshape with inference: ``-1`` infers one dim, ``0`` copies the
    input's dim at the same position; ``batch_mode`` keeps the leading
    batch dim."""

    def __init__(self, size: Sequence[int], batch_mode: bool = False) -> None:
        super().__init__()
        self.size = tuple(int(s) for s in size)
        self.batch_mode = batch_mode

    def _target(self, in_shape: Tuple[int, ...]) -> Tuple[int, ...]:
        body = in_shape[1:] if self.batch_mode else in_shape
        out = tuple(body[i] if s == 0 else s for i, s in enumerate(self.size))
        return (in_shape[0],) + out if self.batch_mode else out

    def forward(self, x):
        return torch.reshape(x, self._target(tuple(x.shape)))


class BifurcateSplitTable(AbstractModule):
    """Split a tensor into two halves along 1-based ``dim``: a table of
    two."""

    def __init__(self, dim: int = 1) -> None:
        super().__init__()
        self.dim = dim

    def forward(self, x):
        ax = _axis(self.dim, x.dim())
        if x.shape[ax] % 2:
            raise ValueError("BifurcateSplitTable needs an even dim, not "
                             f"{x.shape[ax]}")
        return list(torch.chunk(x, 2, dim=ax))


class MixtureTable(AbstractModule):
    """Mixture-of-experts combine: ``[gater (B, E), experts]`` where
    experts is a table of E tensors ``(B, ...)`` or one ``(B, E, ...)``
    tensor; the gate-weighted sum over experts."""

    def forward(self, x):
        gater, experts = x[0], x[1]
        if isinstance(experts, (list, tuple)):
            experts = torch.stack(list(experts), dim=1)     # (B, E, ...)
        g = gater.reshape(tuple(gater.shape) + (1,) * (experts.dim() - 2))
        return torch.sum(g * experts, dim=1)


class MaskedSelect(AbstractModule):
    """Table ``[x, mask]`` → the 1-D tensor of x's elements where mask is
    nonzero (one host read on the card: the output's length)."""

    def forward(self, x):
        t, mask = x
        mask = torch.as_tensor(mask, device=t.device)
        return torch.masked_select(t, mask != 0)


class DenseToSparse(AbstractModule):
    """A dense tensor as a fixed-capacity COO :class:`SparseTensor` (one
    host read on the card: the nonzero count); ``capacity`` pre-pads it
    for a downstream sparse layer."""

    def __init__(self, capacity: Optional[int] = None) -> None:
        super().__init__()
        self.capacity = capacity

    def forward(self, x):
        return SparseTensor.from_dense(x, self.capacity)


# ---------------------------------------------------------------------------
# parameterized activations
# ---------------------------------------------------------------------------

class SReLU(TensorModule):
    """S-shaped ReLU: ``t_r + a_r (x - t_r)`` for x ≥ t_r, x in the
    band, ``t_l + a_l (x - t_l)`` for x ≤ t_l, with the four learned per
    feature (``shared_axes``, 1-based, collapse to 1). Init: t_left 0,
    a_left 0, t_right Xavier, a_right 1."""

    def __init__(self, shape: Sequence[int],
                 shared_axes: Optional[Sequence[int]] = None, device=None,
                 generator: torch.Generator = None) -> None:
        super().__init__()
        self.shape = tuple(int(s) for s in shape)
        self.shared_axes = tuple(shared_axes or ())
        shp = self._param_shape()
        self._generator = generator
        self.t_left_init, self.a_left_init = Zeros(), Zeros()
        self.t_right_init, self.a_right_init = Xavier(), Ones()
        for name in ("t_left", "a_left", "t_right", "a_right"):
            setattr(self, name, new_param(shp, device,
                                          getattr(self, name + "_init"),
                                          generator))

    def _param_shape(self) -> Tuple[int, ...]:
        return tuple(1 if (i + 1) in self.shared_axes else s
                     for i, s in enumerate(self.shape))

    def forward(self, x):
        tl, al, tr, ar = self.t_left, self.a_left, self.t_right, self.a_right
        out = torch.where(x >= tr, tr + ar * (x - tr), x)
        return torch.where(x <= tl, tl + al * (x - tl), out)


class Maxout(TensorModule):
    """A linear map to ``output_size * maxout_number`` units, then the max
    of each pool of ``maxout_number``."""

    def __init__(self, input_size: int, output_size: int, maxout_number: int,
                 with_bias: bool = True,
                 init_weight: Optional[InitializationMethod] = None,
                 init_bias: Optional[InitializationMethod] = None,
                 device=None, generator: torch.Generator = None) -> None:
        super().__init__()
        self.input_size = input_size
        self.output_size = output_size
        self.maxout_number = maxout_number
        self.with_bias = with_bias
        self._generator = generator
        self.weight_init = init_weight or Xavier()
        self.bias_init = init_bias or Zeros()
        n = output_size * maxout_number
        self.weight = new_param((n, input_size), device,
                                self.weight_init, generator)
        if with_bias:
            self.bias = new_param((n,), device,
                                  self.bias_init, generator)
        else:
            self.register_parameter("bias", None)

    def forward(self, x):
        h = torch.matmul(x, self.weight.T)
        if self.with_bias:
            h = h + self.bias
        h = h.reshape(tuple(h.shape[:-1])
                      + (self.output_size, self.maxout_number))
        return torch.amax(h, dim=-1)


# ---------------------------------------------------------------------------
# temporal pooling / up-sampling / cropping
# ---------------------------------------------------------------------------

class _TemporalPooling(TensorModule):
    def __init__(self, k_w: int, d_w: Optional[int] = None,
                 pad_mode: str = "VALID") -> None:
        super().__init__()
        self.k_w = k_w
        self.d_w = d_w or k_w
        self.pad_mode = pad_mode

    def _pads(self, t: int) -> Tuple[int, int]:
        if self.pad_mode == "SAME":
            return _same_pads(t, self.k_w, self.d_w)
        return 0, 0


class TemporalMaxPooling(_TemporalPooling):
    """Max pooling over the time axis of (B, T, F) or (T, F) input;
    ``pad_mode="SAME"`` pads with -inf."""

    def forward(self, x):
        x, squeeze = _batched(x, 3)
        lo, hi = self._pads(x.shape[1])
        xt = x.transpose(1, 2)                              # (B, F, T)
        if lo or hi:
            xt = F.pad(xt, (lo, hi), value=float("-inf"))
        out = F.max_pool1d(xt, self.k_w, self.d_w).transpose(1, 2)
        return out[0] if squeeze else out


class TemporalAveragePooling(_TemporalPooling):
    """Average pooling over the time axis of (B, T, F) or (T, F) input;
    ``pad_mode="SAME"`` leaves the padding out of each window's
    divisor (Keras 1.2 / TF)."""

    def forward(self, x):
        x, squeeze = _batched(x, 3)
        lo, hi = self._pads(x.shape[1])
        xp = F.pad(x, (0, 0, lo, hi)) if lo or hi else x
        sums = xp.unfold(1, self.k_w, self.d_w).sum(-1)     # (B, T', F)
        if self.pad_mode == "SAME":
            ones = F.pad(x.new_ones((x.shape[1],)), (lo, hi))
            counts = ones.unfold(0, self.k_w, self.d_w).sum(-1)
            out = sums / counts[None, :, None]
        else:
            out = sums / float(self.k_w)
        return out[0] if squeeze else out


class VolumetricZeroPadding(TensorModule):
    """Zero-pad the three spatial dims of (N, C, D, H, W) input
    symmetrically by ``(pad_t, pad_h, pad_w)``."""

    def __init__(self, pad_t: int = 1, pad_h: int = 1, pad_w: int = 1) -> None:
        super().__init__()
        self.pads = (pad_t, pad_h, pad_w)

    def forward(self, x):
        t, h, w = self.pads
        return F.pad(x, (w, w, h, h, t, t))


class UpSampling1D(TensorModule):
    """Repeat each time step ``length`` times: (B, T, F) → (B, T·length,
    F)."""

    def __init__(self, length: int = 2) -> None:
        super().__init__()
        self.length = length

    def forward(self, x):
        return torch.repeat_interleave(x, self.length, dim=x.dim() - 2)


class UpSampling3D(TensorModule):
    """Nearest-neighbour volumetric up-sampling of NCDHW input by integer
    factors."""

    def __init__(self, size: Sequence[int] = (2, 2, 2)) -> None:
        super().__init__()
        self.size = tuple(int(s) for s in size)

    def forward(self, x):
        for i, f in enumerate(self.size):
            x = torch.repeat_interleave(x, f, dim=x.dim() - 3 + i)
        return x


class Cropping2D(TensorModule):
    """Crop rows and columns: ``height_crop=(top, bottom)``,
    ``width_crop=(left, right)``, NCHW or NHWC."""

    def __init__(self, height_crop: Sequence[int] = (0, 0),
                 width_crop: Sequence[int] = (0, 0),
                 data_format: str = "NCHW") -> None:
        super().__init__()
        self.hc = tuple(height_crop)
        self.wc = tuple(width_crop)
        _format(data_format, ("NCHW", "NHWC"))
        self.data_format = data_format

    def forward(self, x):
        (t, b), (l, r) = self.hc, self.wc
        h_ax = -3 if self.data_format == "NHWC" else -2
        w_ax = -2 if self.data_format == "NHWC" else -1
        idx = [slice(None)] * x.dim()
        idx[h_ax] = slice(t, x.shape[h_ax] - b)
        idx[w_ax] = slice(l, x.shape[w_ax] - r)
        return x[tuple(idx)]


class Cropping3D(TensorModule):
    """Crop the three spatial dims of NCDHW input."""

    def __init__(self, dim1_crop: Sequence[int] = (0, 0),
                 dim2_crop: Sequence[int] = (0, 0),
                 dim3_crop: Sequence[int] = (0, 0)) -> None:
        super().__init__()
        self.crops = (tuple(dim1_crop), tuple(dim2_crop), tuple(dim3_crop))

    def forward(self, x):
        idx = [slice(None)] * x.dim()
        for i, (lo, hi) in enumerate(self.crops):
            ax = x.dim() - 3 + i
            idx[ax] = slice(lo, x.shape[ax] - hi)
        return x[tuple(idx)]


# ---------------------------------------------------------------------------
# convolution variants
# ---------------------------------------------------------------------------

class VolumetricFullConvolution(TensorModule):
    """3-D transposed convolution over NCDHW input; output size per axis
    ``(in - 1)·stride - 2·pad + k + adj``."""

    def __init__(self, n_input_plane: int, n_output_plane: int,
                 k_t: int, k_w: int, k_h: int,
                 d_t: int = 1, d_w: int = 1, d_h: int = 1,
                 pad_t: int = 0, pad_w: int = 0, pad_h: int = 0,
                 adj_t: int = 0, adj_w: int = 0, adj_h: int = 0,
                 n_group: int = 1, no_bias: bool = False,
                 init_weight: Optional[InitializationMethod] = None,
                 init_bias: Optional[InitializationMethod] = None,
                 device=None, generator: torch.Generator = None) -> None:
        super().__init__()
        if n_input_plane % n_group or n_output_plane % n_group:
            raise ValueError("n_group must divide both plane counts")
        self.n_input_plane = n_input_plane
        self.n_output_plane = n_output_plane
        self.k = (k_t, k_h, k_w)
        self.d = (d_t, d_h, d_w)
        self.pad = (pad_t, pad_h, pad_w)
        self.adj = (adj_t, adj_h, adj_w)
        self.n_group = n_group
        self.with_bias = not no_bias
        self._generator = generator
        self.weight_init = init_weight or RandomUniform()
        self.bias_init = init_bias or RandomUniform()
        self.weight = new_param(
            (n_input_plane, n_output_plane // n_group) + self.k, device,
            self.weight_init, generator)
        if self.with_bias:
            self.bias = new_param((n_output_plane,), device,
                                  self.bias_init, generator)
        else:
            self.register_parameter("bias", None)

    def forward(self, x):
        x, squeeze = _batched(x, 5)
        out = F.conv_transpose3d(x, self.weight, None, self.d, self.pad,
                                 self.adj, self.n_group)
        if self.with_bias:
            out = out + self.bias[None, :, None, None, None]
        return out[0] if squeeze else out


class LocallyConnected2D(TensorModule):
    """Unshared convolution: a distinct kernel per output position; weight
    ``(oH·oW, out, in·kH·kW)``, bias ``(out, oH, oW)``."""

    def __init__(self, n_input_plane: int, input_width: int, input_height: int,
                 n_output_plane: int, kernel_w: int, kernel_h: int,
                 stride_w: int = 1, stride_h: int = 1,
                 pad_w: int = 0, pad_h: int = 0, with_bias: bool = True,
                 init_weight: Optional[InitializationMethod] = None,
                 init_bias: Optional[InitializationMethod] = None,
                 device=None, generator: torch.Generator = None) -> None:
        super().__init__()
        self.n_input_plane = n_input_plane
        self.input_width = input_width
        self.input_height = input_height
        self.n_output_plane = n_output_plane
        self.kernel_w = kernel_w
        self.kernel_h = kernel_h
        self.stride_w = stride_w
        self.stride_h = stride_h
        self.pad_w = pad_w
        self.pad_h = pad_h
        self.with_bias = with_bias
        self._generator = generator
        self.weight_init = init_weight or Xavier()
        self.bias_init = init_bias or Zeros()
        self.out_h = (input_height + 2 * pad_h - kernel_h) // stride_h + 1
        self.out_w = (input_width + 2 * pad_w - kernel_w) // stride_w + 1
        kdim = n_input_plane * kernel_h * kernel_w
        self.weight = new_param(
            (self.out_h * self.out_w, n_output_plane, kdim), device,
            self.weight_init, generator)
        if with_bias:
            self.bias = new_param((n_output_plane, self.out_h, self.out_w),
                                  device, self.bias_init, generator)
        else:
            self.register_parameter("bias", None)

    def forward(self, x):
        x, squeeze = _batched(x, 4)
        patches = F.unfold(x, (self.kernel_h, self.kernel_w),
                           padding=(self.pad_h, self.pad_w),
                           stride=(self.stride_h, self.stride_w))  # (N, K, P)
        out = torch.einsum("nkp,pok->nop", patches, self.weight)
        out = out.reshape(x.shape[0], self.n_output_plane, self.out_h,
                          self.out_w)
        if self.with_bias:
            out = out + self.bias[None]
        return out[0] if squeeze else out


class LocallyConnected1D(TensorModule):
    """Unshared temporal convolution over (B, T, F) input; weight
    ``(oT, out, F·kW)`` (feature-major patches), bias ``(oT, out)``."""

    def __init__(self, n_input_frame: int, input_frame_size: int,
                 output_frame_size: int, kernel_w: int, stride_w: int = 1,
                 with_bias: bool = True,
                 init_weight: Optional[InitializationMethod] = None,
                 init_bias: Optional[InitializationMethod] = None,
                 device=None, generator: torch.Generator = None) -> None:
        super().__init__()
        self.n_input_frame = n_input_frame
        self.input_frame_size = input_frame_size
        self.output_frame_size = output_frame_size
        self.kernel_w = kernel_w
        self.stride_w = stride_w
        self.with_bias = with_bias
        self._generator = generator
        self.weight_init = init_weight or Xavier()
        self.bias_init = init_bias or Zeros()
        self.out_t = (n_input_frame - kernel_w) // stride_w + 1
        self.weight = new_param(
            (self.out_t, output_frame_size, input_frame_size * kernel_w),
            device, self.weight_init, generator)
        if with_bias:
            self.bias = new_param((self.out_t, output_frame_size), device,
                                  self.bias_init, generator)
        else:
            self.register_parameter("bias", None)

    def forward(self, x):
        x, squeeze = _batched(x, 3)                         # (B, T, F)
        b = x.shape[0]
        patches = x.transpose(1, 2).unfold(2, self.kernel_w, self.stride_w)
        patches = patches.permute(0, 2, 1, 3).reshape(b, self.out_t, -1)
        out = torch.einsum("bpk,pok->bpo", patches, self.weight)
        if self.with_bias:
            out = out + self.bias[None]
        return out[0] if squeeze else out


class SpatialShareConvolution(SpatialConvolution):
    """``SpatialConvolution`` under the reference's name (its variant only
    shared im2col buffers between clones); the same arguments, params and
    result."""


class SpatialSeparableConvolution(TensorModule):
    """Depthwise-separable convolution: a depthwise convolution with
    ``depth_multiplier`` maps per input plane, then a 1×1 pointwise one;
    ``depth_weight (in·dm, 1, kH, kW)``, ``point_weight (out, in·dm, 1,
    1)``."""

    def __init__(self, n_input_channel: int, n_output_channel: int,
                 depth_multiplier: int, k_w: int, k_h: int,
                 s_w: int = 1, s_h: int = 1, p_w: int = 0, p_h: int = 0,
                 with_bias: bool = True,
                 init_weight: Optional[InitializationMethod] = None,
                 init_bias: Optional[InitializationMethod] = None,
                 device=None, generator: torch.Generator = None) -> None:
        super().__init__()
        self.n_input_channel = n_input_channel
        self.n_output_channel = n_output_channel
        self.depth_multiplier = depth_multiplier
        self.k = (k_h, k_w)
        self.s = (s_h, s_w)
        self.p = (p_h, p_w)
        self.with_bias = with_bias
        self._generator = generator
        self.weight_init = init_weight or Xavier()
        self.bias_init = init_bias or Zeros()
        mid = n_input_channel * depth_multiplier
        self.depth_weight = new_param((mid, 1, k_h, k_w), device,
                                      self.weight_init, generator)
        self.point_weight = new_param((n_output_channel, mid, 1, 1), device,
                                      self.weight_init, generator)
        if with_bias:
            self.bias = new_param((n_output_channel,), device,
                                  self.bias_init, generator)
        else:
            self.register_parameter("bias", None)

    def reset_parameters(self, generator=None):
        """Both weights by ``weight_init``, the bias by ``bias_init``."""
        g = self._draws(generator)
        for w in (self.depth_weight, self.point_weight):
            self.weight_init.fill(w.data, g)
        if self.bias is not None:
            self.bias_init.fill(self.bias.data, g)
        return self

    def forward(self, x):
        x, squeeze = _batched(x, 4)
        out = F.conv2d(x, self.depth_weight, None, self.s, self.p, 1,
                       self.n_input_channel)
        out = F.conv2d(out, self.point_weight)
        if self.with_bias:
            out = out + self.bias[None, :, None, None]
        return out[0] if squeeze else out


# ---------------------------------------------------------------------------
# channel-wise dropout
# ---------------------------------------------------------------------------

class _SpatialDropoutNd(TensorModule):
    """Drop whole feature maps: one keep mask per (sample, channel),
    broadcast over the spatial axes."""

    def __init__(self, init_p: float = 0.5) -> None:
        super().__init__()
        self.p = init_p

    def _noise_shape(self, shape):
        raise NotImplementedError

    def forward(self, x):
        gen = current_rng()
        if not self.training or self.p <= 0.0 or gen is None:
            return x
        keep = 1.0 - self.p
        mask = keep_mask(self._noise_shape(tuple(x.shape)), keep, x, gen)
        return x * mask / keep


class SpatialDropout1D(_SpatialDropoutNd):
    """Drop whole channels of (B, T, C) input (channels last)."""

    def _noise_shape(self, shape):
        return shape[:-2] + (1, shape[-1])


class SpatialDropout2D(_SpatialDropoutNd):
    """Drop whole feature maps of NCHW (or NHWC) input."""

    def __init__(self, init_p: float = 0.5, data_format: str = "NCHW") -> None:
        super().__init__(init_p)
        _format(data_format, ("NCHW", "NHWC"))
        self.data_format = data_format

    def _noise_shape(self, shape):
        if self.data_format == "NCHW":
            return shape[:-2] + (1, 1)
        return shape[:-3] + (1, 1, shape[-1])


class SpatialDropout3D(_SpatialDropoutNd):
    """Drop whole feature volumes of NCDHW (or NDHWC) input."""

    def __init__(self, init_p: float = 0.5,
                 data_format: str = "NCDHW") -> None:
        super().__init__(init_p)
        _format(data_format, ("NCDHW", "NDHWC"))
        self.data_format = data_format

    def _noise_shape(self, shape):
        if self.data_format == "NCDHW":
            return shape[:-3] + (1, 1, 1)
        return shape[:-4] + (1, 1, 1, shape[-1])


# ---------------------------------------------------------------------------
# local normalization family
# ---------------------------------------------------------------------------

def _local_mean_conv(x, kernel2d, n_channels):
    """Kernel-weighted local mean over ALL channels with the border
    correction: ``(mean map (N, 1, H, W), coef (1, 1, H, W))``, coef the
    share of the kernel's mass inside the image at each position (divide
    by it for Torch7's edges)."""
    kernel2d = torch.as_tensor(kernel2d, dtype=torch.float32,
                               device=x.device)
    kh, kw = kernel2d.shape
    # normalized so that a full-coverage response is the mean over c, h, w
    k = kernel2d / (torch.sum(kernel2d) * n_channels)
    w = torch.broadcast_to(k, (1, n_channels, kh, kw)).to(x.dtype)
    pad = (kw // 2, (kw - 1) // 2, kh // 2, (kh - 1) // 2)
    mean = F.conv2d(F.pad(x, pad), w)
    ones = x.new_ones((1, n_channels) + tuple(x.shape[-2:]))
    coef = F.conv2d(F.pad(ones, pad), w)
    return mean, coef


def _kernel(kernel) -> np.ndarray:
    k = np.asarray(kernel if kernel is not None else np.ones((9, 9)),
                   np.float32)
    return np.outer(k, k) if k.ndim == 1 else k  # separable 1-D → outer


class SpatialWithinChannelLRN(TensorModule):
    """Within-channel local response normalization (caffe
    ``WITHIN_CHANNEL``): ``x / (1 + alpha / size² · Σ_window x²)^beta``
    per channel, the window zero-padded (size // 2, (size - 1) // 2)."""

    def __init__(self, size: int = 5, alpha: float = 1.0,
                 beta: float = 0.75) -> None:
        super().__init__()
        self.size = size
        self.alpha = alpha
        self.beta = beta

    def forward(self, x):
        x, squeeze = _batched(x, 4)
        s = self.size
        lo, hi = s // 2, (s - 1) // 2
        sq_sum = F.avg_pool2d(F.pad(x * x, (lo, hi, lo, hi)), s, 1,
                              divisor_override=1)
        out = x / (1.0 + (self.alpha / (s * s)) * sq_sum) ** self.beta
        return out[0] if squeeze else out


class SpatialSubtractiveNormalization(TensorModule):
    """Subtract the kernel-weighted local mean over all channels, with
    the border correction."""

    def __init__(self, n_input_plane: int = 1, kernel=None) -> None:
        super().__init__()
        self.n_input_plane = n_input_plane
        self.kernel = _kernel(kernel)

    def forward(self, x):
        x, squeeze = _batched(x, 4)
        mean, coef = _local_mean_conv(x, self.kernel, self.n_input_plane)
        out = x - mean / coef
        return out[0] if squeeze else out


class SpatialDivisiveNormalization(TensorModule):
    """Divide by the kernel-weighted local standard deviation (values
    below ``threshold`` replaced by ``thresval``), raised to at least its
    per-image mean (Jarrett et al.'s ``x / max(mean σ, σ_local)``)."""

    def __init__(self, n_input_plane: int = 1, kernel=None,
                 threshold: float = 1e-4, thresval: float = 1e-4) -> None:
        super().__init__()
        self.n_input_plane = n_input_plane
        self.kernel = _kernel(kernel)
        self.threshold = threshold
        self.thresval = thresval

    def forward(self, x):
        x, squeeze = _batched(x, 4)
        var, coef = _local_mean_conv(x * x, self.kernel, self.n_input_plane)
        ratio = var / coef
        local_std = torch.sqrt(torch.maximum(ratio, ratio.new_zeros(())))
        local_std = torch.where(local_std > self.threshold, local_std,
                                local_std.new_tensor(self.thresval))
        mean_std = torch.mean(local_std, dim=(1, 2, 3), keepdim=True)
        out = x / torch.maximum(local_std, mean_std)
        return out[0] if squeeze else out


class SpatialContrastiveNormalization(TensorModule):
    """Subtractive then divisive normalization with one kernel. The two
    stages hold no parameters and are not child modules (JAX's params
    tree has no keys for them)."""

    def __init__(self, n_input_plane: int = 1, kernel=None,
                 threshold: float = 1e-4, thresval: float = 1e-4) -> None:
        super().__init__()
        self.__dict__["sub"] = SpatialSubtractiveNormalization(
            n_input_plane, kernel)
        self.__dict__["div"] = SpatialDivisiveNormalization(
            n_input_plane, kernel, threshold, thresval)

    def forward(self, x):
        return self.div(self.sub(x))


# ---------------------------------------------------------------------------
# penalty layers
# ---------------------------------------------------------------------------

class _NegativeEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, beta):
        ctx.save_for_backward(x)
        ctx.beta = beta
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g + ctx.beta * (torch.log(
            torch.maximum(x, x.new_tensor(1e-12))) + 1.0), None


class NegativeEntropyPenalty(TensorModule):
    """Identity forward; the backward adds the gradient of ``beta · Σ p
    log p`` (negative entropy), pushing probabilities toward high
    entropy."""

    def __init__(self, beta: float = 0.01) -> None:
        super().__init__()
        self.beta = beta

    def forward(self, x):
        return _NegativeEntropy.apply(x, self.beta)


# ---------------------------------------------------------------------------
# connection-table convolution
# ---------------------------------------------------------------------------

class SpatialConvolutionMap(TensorModule):
    """Convolution over an explicit input → output plane connection table
    (``(K, 2)`` rows of 1-based ``(in_plane, out_plane)``): one ``(kH,
    kW)`` kernel per row; output plane o sums the kernels of its rows.
    Weight ``(K, kH, kW)`` (Xavier), bias ``(out,)`` (zeros)."""

    def __init__(self, conn_table, kernel_w: int, kernel_h: int,
                 stride_w: int = 1, stride_h: int = 1,
                 pad_w: int = 0, pad_h: int = 0,
                 init_weight: Optional[InitializationMethod] = None,
                 init_bias: Optional[InitializationMethod] = None,
                 device=None, generator: torch.Generator = None) -> None:
        super().__init__()
        table = np.asarray(conn_table, np.int32)
        if table.ndim != 2 or table.shape[1] != 2:
            raise ValueError(f"conn_table is (K, 2), not {table.shape}")
        self.conn_table = table
        self.n_input_plane = int(table[:, 0].max())
        self.n_output_plane = int(table[:, 1].max())
        self.kernel_w = kernel_w
        self.kernel_h = kernel_h
        self.stride_w = stride_w
        self.stride_h = stride_h
        self.pad_w = pad_w
        self.pad_h = pad_h
        self._generator = generator
        self.weight_init = init_weight or Xavier()
        self.bias_init = init_bias or Zeros()
        self.weight = new_param((table.shape[0], kernel_h, kernel_w), device,
                                self.weight_init, generator)
        self.bias = new_param((self.n_output_plane,), device,
                              self.bias_init, generator)

    # the reference's connection tables
    @staticmethod
    def full(n_in: int, n_out: int) -> np.ndarray:
        return np.array([(i + 1, o + 1) for o in range(n_out)
                         for i in range(n_in)], np.int32)

    @staticmethod
    def one_to_one(n: int) -> np.ndarray:
        return np.array([(i + 1, i + 1) for i in range(n)], np.int32)

    @staticmethod
    def random(n_in: int, n_out: int, fan_in: int,
               seed: int = 0) -> np.ndarray:
        rng = np.random.RandomState(seed)
        rows = []
        for o in range(n_out):
            for i in rng.choice(n_in, size=fan_in, replace=False):
                rows.append((i + 1, o + 1))
        return np.array(rows, np.int32)

    def forward(self, x):
        x, squeeze = _batched(x, 4)
        dev = self.weight.device
        o_idx = torch.as_tensor(self.conn_table[:, 1] - 1, device=dev).long()
        i_idx = torch.as_tensor(self.conn_table[:, 0] - 1, device=dev).long()
        dense = self.weight.new_zeros(
            (self.n_output_plane, self.n_input_plane, self.kernel_h,
             self.kernel_w)).index_put((o_idx, i_idx), self.weight,
                                       accumulate=True)
        out = F.conv2d(x, dense, None, (self.stride_h, self.stride_w),
                       (self.pad_h, self.pad_w))
        out = out + self.bias[None, :, None, None]
        return out[0] if squeeze else out
