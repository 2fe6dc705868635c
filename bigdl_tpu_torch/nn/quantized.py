"""int8 inference: ``quantize_symmetric``, ``QuantizedLinear``,
``QuantizedSpatialConvolution`` and ``Quantizer``
(``bigdl_tpu/nn/quantized.py``).

A trained float model becomes an int8 inference model through
``Quantizer.quantize(model, scheme)`` (``model.quantize(scheme)``): every
``Linear`` and ``SpatialConvolution`` is swapped for its twin holding
symmetric per-output-channel int8 codes ``weight_q`` and f32 scales
``w_scale`` (``scale = max(amax, 1e-8) / 127``, codes
``clip(round(w / scale), -127, 127)``, rounding half to even). The twins
keep the float module's name and container key and hold ``weight_q``,
``w_scale`` and ``bias`` as ``nn.Parameter``s without gradients, so the
params tree has JAX's keys, leaf names, shapes and dtypes
(:func:`bigdl_tpu_torch.utils.params_tree.load_jax_tree` loads a JAX
quantized tree; ``Module.save``/``load`` round-trip it bitwise).

Two schemes, as in JAX:

* ``dynamic`` — activations quantized at run time (one scale per row for
  a Linear, per image for a convolution), an exact int8 × int8 → int32
  product, then ``acc · x_scale · w_scale`` in that order. On the card the
  product is ``torch._int_mm`` (cuBLASLt) over zero-padded operands (it
  takes more than 16 rows and K and N multiples of 8; zeros add nothing);
  a convolution is an im2col (unfolded in bf16, exact for int8 codes, as
  ``F.unfold`` has no int8 kernel there) in chunks of images, then the
  same product. On the CPU the product is an int32 ``matmul``. JAX lowers
  this scheme with XLA, not Pallas, so the port keeps it in PyTorch;
* ``weight_only`` — bf16 activations and bf16(int8) weights, f32
  accumulation, an f32 output times ``w_scale``, plus the f32 bias. A
  Linear goes through :func:`bigdl_tpu_torch.ops.w8a16.w8a16` (the
  hand-written W8A16 kernel on the card); a convolution is ``F.conv2d``
  in f32 over the bf16-rounded activation and the codes as f32 (every
  product exact) with TF32 off inside the call, as a bf16 cuDNN call would
  round its output to bf16.

The walk leaves ``MultiHeadAttention``'s four projections float: JAX
holds them as raw params, not ``Linear`` modules, so its ``Quantizer``
never sees them. Two faults of JAX's ``Quantizer`` are not copied
(ROADMAP C.1). A ``ScanBlocks`` template's stacked weights are quantized
per layer and per output channel (``w_scale`` (n_layers, out, 1)), the
unrolled model's scales stacked; JAX reduces the stacked weight over its
output axis, scales every output by one input column's scale, and its
tree does not load. A ``FusedGraph`` is refused: its plan runs the float
1×1 convolutions through the fused kernels (JAX's ``Quantizer`` returns
one whose forward raises ``KeyError``); quantize the ``Graph`` before
fusing, or not at all. Inference only, like the reference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch.nn.module import AbstractModule, TensorModule
from bigdl_tpu_torch.ops.w8a16 import w8a16

SCHEMES = ("dynamic", "weight_only")
#: images per im2col chunk of the dynamic convolution: at most this many
#: elements of unfolded columns at once (ResNet-50's stem at batch 256
#: unfolds 472 M; a chunk of 2**26 holds 36 of its images)
IM2COL_CHUNK = 1 << 26


def _check_scheme(scheme: str) -> None:
    if scheme not in SCHEMES:
        raise ValueError(f"unknown quantization scheme {scheme!r}")


def _div127(t):
    """``t / 127`` as a true division on every device (PyTorch's CUDA
    division by a Python scalar multiplies by its reciprocal)."""
    return t / torch.full((), 127.0, dtype=t.dtype, device=t.device)


def quantize_symmetric(w, axis):
    """Symmetric int8 quantization (``quantized.py:28-36``). ``axis``: the
    dim or dims reduced for the scale (all but the output channel), as in
    JAX. Returns ``(int8 codes, f32 scale)``, the scale keeping the
    reduced dims."""
    amax = w.abs().amax(dim=axis, keepdim=True)
    scale = _div127(torch.clamp_min(amax, 1e-8))
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale


def _frozen(t):
    return None if t is None else nn.Parameter(t.detach().clone(),
                                               requires_grad=False)


def _pad_to(t, rows: int, cols: int):
    """Zero-pad a 2-D tensor at its end to ``(rows, cols)``."""
    return F.pad(t, (0, cols - t.shape[1], 0, rows - t.shape[0]))


def int8_matmul(a, b):
    """``a @ b.T`` of int8 ``a`` (M, K) and ``b`` (N, K), exact, as (M, N)
    int32. On the card ``torch._int_mm`` over operands zero-padded to its
    shape rules (more than 16 rows; K and N multiples of 8; the rows too,
    for cuBLASLt's int8 layouts); on the CPU an int32 ``matmul``."""
    m, k = a.shape
    n = b.shape[0]
    if a.device.type != "cuda":
        return a.to(torch.int32) @ b.to(torch.int32).t()
    mp, kp, np_ = max(-(-m // 8) * 8, 24), -(-k // 8) * 8, -(-n // 8) * 8
    if (mp, kp) != (m, k):
        a = _pad_to(a, mp, kp)
    if (np_, kp) != (n, k):
        b = _pad_to(b, np_, kp)
    out = torch._int_mm(a.contiguous(), b.t())
    return out[:m, :n] if (mp, np_) != (m, n) else out


def _quantize_rows(x, dims):
    """Dynamic activation codes and their scale over ``dims``
    (``quantized.py:96-98``, ``:167-169``), in ``x``'s dtype."""
    x_scale = _div127(torch.clamp_min(x.abs().amax(dim=dims, keepdim=True),
                                      1e-8))
    return (torch.clamp(torch.round(x / x_scale), -127, 127)
            .to(torch.int8), x_scale)


class QuantizedLinear(TensorModule):
    """int8 Linear built from a trained float ``Linear``
    (``quantized.py:39``): ``weight_q`` (out, in) int8, ``w_scale`` (out,
    1) f32, an optional f32 ``bias``; the ``scheme`` picks the product
    (module docstring)."""

    def __init__(self, weight_q, w_scale, bias=None,
                 scheme: str = "dynamic") -> None:
        super().__init__()
        _check_scheme(scheme)
        self.weight_q = _frozen(weight_q)
        self.w_scale = _frozen(w_scale)
        self.bias = _frozen(bias)
        self.scheme = scheme

    @staticmethod
    def from_linear(lin, scheme: str = "dynamic") -> "QuantizedLinear":
        """The twin of ``lin`` (its weight may carry a leading stacked
        layer axis, as in a ``ScanBlocks`` template)."""
        wq, scale = quantize_symmetric(lin.weight.detach(), -1)
        q = QuantizedLinear(wq, scale, lin.bias, scheme)
        q.name = lin.name
        return q

    def forward(self, x):
        bias = None if self.bias is None else self.bias.float()
        if self.scheme == "weight_only":
            return w8a16(x, self.weight_q, self.w_scale, bias)
        xq, x_scale = _quantize_rows(x, -1)
        k = xq.shape[-1]
        acc = int8_matmul(xq.reshape(-1, k), self.weight_q)
        acc = acc.reshape(*xq.shape[:-1], -1)
        out = acc.float() * x_scale * self.w_scale[:, 0]
        return out if bias is None else out + bias

    def extra_repr(self) -> str:
        o, i = self.weight_q.shape[-2:]
        return f"{i} -> {o}, {self.scheme}"


class QuantizedSpatialConvolution(TensorModule):
    """int8 SpatialConvolution built from a trained float conv
    (``quantized.py:113``): ``weight_q`` (O, I/g, kH, kW) int8,
    ``w_scale`` (O, 1, 1, 1) f32, the float conv's stride, padding
    (TF-style SAME included) and ``n_group``; a 3-D input is one image."""

    def __init__(self, conv, weight_q, w_scale, bias=None,
                 scheme: str = "dynamic") -> None:
        super().__init__()
        _check_scheme(scheme)
        for attr in ("kernel_w", "kernel_h", "stride_w", "stride_h",
                     "pad_w", "pad_h", "n_group"):
            setattr(self, attr, getattr(conv, attr))
        self.weight_q = _frozen(weight_q)
        self.w_scale = _frozen(w_scale)
        self.bias = _frozen(bias)
        self.scheme = scheme

    @staticmethod
    def from_conv(conv, scheme: str = "dynamic"
                  ) -> "QuantizedSpatialConvolution":
        wq, scale = quantize_symmetric(conv.weight.detach(), (-3, -2, -1))
        q = QuantizedSpatialConvolution(conv, wq, scale, conv.bias, scheme)
        q.name = conv.name
        return q

    def _padded(self, x):
        """``x`` with its (possibly asymmetric) padding applied."""
        from bigdl_tpu_torch.nn.conv import SpatialConvolution

        (ph0, ph1), (pw0, pw1) = SpatialConvolution._padding(
            self, x.shape[-2], x.shape[-1])
        return F.pad(x, (pw0, pw1, ph0, ph1))

    def _weight_only(self, x):
        xb = self._padded(x.to(torch.bfloat16).float())
        cudnn = torch.backends.cudnn
        before = cudnn.allow_tf32
        cudnn.allow_tf32 = False
        try:
            return F.conv2d(xb, self.weight_q.float(), None,
                            (self.stride_h, self.stride_w), 0, 1,
                            self.n_group)
        finally:
            cudnn.allow_tf32 = before

    def _int8_conv(self, xq):
        """The exact int32 convolution of int8 ``xq`` (N, C, H, W) with
        ``weight_q``: im2col in chunks of images, one product per group."""
        o, cg, kh, kw = self.weight_q.shape
        g = self.n_group
        code = torch.bfloat16 if xq.device.type == "cuda" else torch.float32
        xp = self._padded(xq.to(code))
        n = xp.shape[0]
        ho = (xp.shape[2] - kh) // self.stride_h + 1
        wo = (xp.shape[3] - kw) // self.stride_w + 1
        per_image = cg * g * kh * kw * ho * wo
        step = max(1, IM2COL_CHUNK // max(per_image, 1))
        wq = self.weight_q.reshape(g, o // g, cg * kh * kw)
        outs = []
        for i in range(0, n, step):
            cols = F.unfold(xp[i:i + step], (kh, kw),
                            stride=(self.stride_h, self.stride_w))
            b = cols.shape[0]
            cols = cols.to(torch.int8).reshape(b, g, cg * kh * kw, ho * wo)
            per_group = [
                int8_matmul(cols[:, j].transpose(1, 2).reshape(
                    b * ho * wo, -1), wq[j]).reshape(b, ho * wo, o // g)
                for j in range(g)]
            outs.append(torch.cat(per_group, dim=2).transpose(1, 2)
                        .reshape(b, o, ho, wo))
        return torch.cat(outs) if len(outs) > 1 else outs[0]

    def forward(self, x):
        squeeze = x.dim() == 3
        x = x[None] if squeeze else x
        w_scale = self.w_scale.reshape(1, -1, 1, 1)
        if self.scheme == "weight_only":
            out = self._weight_only(x) * w_scale
        else:
            xq, x_scale = _quantize_rows(x, (1, 2, 3))
            out = self._int8_conv(xq).float() * x_scale * w_scale
        if self.bias is not None:
            out = out + self.bias[None, :, None, None]
        return out[0] if squeeze else out

    def extra_repr(self) -> str:
        return (f"-> {self.weight_q.shape[0]}, "
                f"{self.kernel_w}x{self.kernel_h}, {self.scheme}")


class Quantizer:
    """``Quantizer.quantize(model, scheme)`` — swap every float ``Linear``
    and ``SpatialConvolution`` of the tree for its int8 twin, in place and
    under the same child keys, and return the model in eval mode
    (``quantized.py:191``; the module docstring says what stays float and
    what is refused)."""

    @staticmethod
    def quantize(module: AbstractModule,
                 scheme: str = "dynamic") -> AbstractModule:
        _check_scheme(scheme)   # also when nothing could be quantized
        from bigdl_tpu_torch.nn.tpu_fusion import FusedGraph

        if any(isinstance(m, FusedGraph) for m in module.modules()):
            raise NotImplementedError(
                "Quantizer.quantize on a FusedGraph: its fused edges run "
                "the float 1x1 convolutions through the fused kernels — "
                "quantize the Graph before fusing it (or leave it float)")
        new = Quantizer._convert(module, scheme)
        if new is not None:
            return new.evaluate()
        Quantizer._rewrite(module, scheme)
        return module.evaluate()

    @staticmethod
    def _convert(m, scheme):
        from bigdl_tpu_torch.nn.conv import SpatialConvolution
        from bigdl_tpu_torch.nn.linear import Linear

        if isinstance(m, Linear):
            new = QuantizedLinear.from_linear(m, scheme)
        elif isinstance(m, SpatialConvolution):
            new = QuantizedSpatialConvolution.from_conv(m, scheme)
        else:
            return None
        new._container_key = m._container_key
        return new

    @staticmethod
    def _rewrite(module, scheme) -> None:
        from bigdl_tpu_torch.nn.attention import MultiHeadAttention
        from bigdl_tpu_torch.nn.graph import Graph

        if isinstance(module, MultiHeadAttention):
            return   # JAX's attention holds raw params: they stay float
        for key, child in list(module._modules.items()):
            if child is None:
                continue
            new = Quantizer._convert(child, scheme)
            if new is None:
                Quantizer._rewrite(child, scheme)
                continue
            module._modules[key] = new
            if isinstance(module, Graph):
                for node in module.topo:
                    if node.module is child:
                        node.module = new
