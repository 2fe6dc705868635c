"""Fused BN-apply → ReLU → 1×1-conv: three CUDA kernels for Hopper and
their plain versions (``bigdl_tpu/ops/fused_conv.py``).

A ResNet bottleneck edge ``BN(train) → ReLU → 1×1 conv`` (optionally
through the residual join ``CAddTable``) is one matrix product over the
M = N·H·W rows of a channels-last activation, with an elementwise
prologue: with x̂ = (x − μ)/σ, p = x̂·γ + β (+ r), y = relu(p), z = y·W,

* forward (:func:`fused_scale_relu_matmul`, TPU ``_fwd_kernel`` ``:141``):
  ``z = relu(x·scale + shift (+ r)) @ W`` with the per-output-channel
  ``zstats = [Σz, Σz²]`` over all M rows, taken from the f32 accumulator
  before z is rounded (the next BN's batch statistics, so no pass re-reads
  z), and the post-ReLU ``y`` when ``want_y`` (a second consumer needs it);
* dgrad (:func:`fused_dgrad`, ``_dgrad_kernel`` ``:281``):
  ``dp = (dz @ Wᵀ (+ dy)) ⊙ 1[p > 0]`` with ``q = [Σdp, Σdp·x̂]`` per input
  channel (dβ and dγ); in bf16 with C and K multiples of 8 on Hopper's
  ``wgmma`` with TMA-streamed x, r, dy and dp tiles (``dgrad_wgmma``);
* wgrad (:func:`fused_wgrad`, ``_wgrad_kernel`` ``:405``):
  ``dW = relu(x·scale + shift (+ r))ᵀ @ dz``, y recomputed, never stored.

:func:`bn_relu_conv1x1` is the differentiable edge (one
``torch.autograd.Function``, the JAX ``custom_vjp``): its backward is
dgrad, then the BN-train ``dx = (γ/σ)(dp − dβ/M − x̂·dγ/M)`` as plain
elementwise torch in the data dtype, then wgrad. ``zstats`` is not
differentiable and ``mean``/``var`` get zero gradients: their chain-rule
share is the correction inside dx, so callers pass statistics of this
same ``x``.

Operands are rows: x, r, y, dp ``(..., C)``, dz and z ``(..., K)``,
W ``(C, K)``, ``scale``/``shift``/``mean``/``inv_std`` ``(C,)`` f32. Any
leading shape is flattened to ``(M, C)`` (an NHWC activation is a free
view), and results keep x's leading shape. The JAX lane packing and VMEM
tiling (``_pack_factor``, ``_block_diag_w``, ``_as_grc``) are TPU layout
devices with no counterpart here.

Dispatch: a CUDA tensor launches the hand-written kernels of
``bigdl_tpu_torch/csrc/fused_conv.cu`` (built with nvcc at first use,
bound through ctypes) or raises; a CPU tensor takes the plain version.
There is no fallback between the two. :data:`fwd_launches`,
:data:`dgrad_launches` and :data:`wgrad_launches` count kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

# the comparison the kernels are held to (a row over the last dim against
# the same row of the plain version), shared with the flash kernels
from bigdl_tpu_torch.ops.flash_attention import max_row_rel_err  # noqa: F401

#: kernel launches since the counts were last reset (callers set them to 0
#: and read them after a run to show which path the run took)
fwd_launches = 0
dgrad_launches = 0
wgrad_launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: per-row relative tolerance of a kernel against its plain version (see
#: ``max_row_rel_err``): f32 — the same f32 math with the sums in another
#: order; bf16 — the outputs z, y, dp and dW are bf16 (one rounding, 2^-8
#: relative: at most a bf16 ulp apart when the f32 sums round on opposite
#: sides), and y is rounded to bf16 before the products in both
ROW_RTOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def _rows(t, c):
    return None if t is None else t.reshape(-1, c)


def _prologue(x, scale, shift, residual):
    """``p = x·scale + shift (+ r)`` in f32 over (M, C) rows."""
    p = x.float() * scale.float() + shift.float()
    if residual is not None:
        p = p + residual.float()
    return p


# ------------------------------------------------------------ plain versions


def fused_fwd_reference(x, scale, shift, w, residual=None,
                        want_y: bool = False):
    """Plain forward over (M, C) rows: ``(z, zstats[, y])``. y is rounded
    to x's dtype before the product (the kernels' A operand), the product
    accumulates in f32, and zstats come from the f32 product."""
    y = torch.relu(_prologue(x, scale, shift, residual)).to(x.dtype)
    z32 = y.float() @ w.float()
    zstats = torch.stack([z32.sum(0), (z32 * z32).sum(0)])
    z = z32.to(x.dtype)
    return (z, zstats, y) if want_y else (z, zstats)


def fused_dgrad_reference(dz, w, x, scale, shift, mean, inv_std,
                          residual=None, extra_dy=None):
    """Plain dgrad over rows: ``(dp in x's dtype, q (2, C) f32)``, q from
    the f32 dp."""
    dy = dz.float() @ w.float().t()
    if extra_dy is not None:
        dy = dy + extra_dy.float()
    p = _prologue(x, scale, shift, residual)
    dp = torch.where(p > 0.0, dy, 0.0)
    xhat = (x.float() - mean.float()) * inv_std.float()
    q = torch.stack([dp.sum(0), (dp * xhat).sum(0)])
    return dp.to(x.dtype), q


def fused_wgrad_reference(x, scale, shift, dz, residual=None,
                          out_dtype=torch.float32):
    """Plain wgrad: ``dW (C, K)`` in ``out_dtype``, y recomputed and
    rounded to dz's dtype, the product accumulated in f32."""
    y = torch.relu(_prologue(x, scale, shift, residual)).to(dz.dtype)
    return (y.float().t() @ dz.float()).to(out_dtype)


# ------------------------------------------------------------ CUDA wrappers


def _card(*tensors):
    """Device, dtype, alignment checks shared by the wrappers; returns the
    operands contiguous and 16-byte aligned (None passes through)."""
    real = [t for t in tensors if t is not None]
    dev = real[0].device
    if dev.type != "cuda" or any(t.device != dev for t in real):
        raise ValueError("the fused-conv kernels run on the card: every "
                         f"operand must be a CUDA tensor on one device "
                         f"(x is on {dev})")
    out = []
    for t in tensors:
        if t is not None:
            t = t.contiguous()
            if t.data_ptr() % 16:
                t = t.clone()
        out.append(t)
    return out


def _f32_vec(v, c, dev):
    v = v.to(device=dev, dtype=torch.float32).reshape(-1).contiguous()
    if v.numel() != c:
        raise ValueError(f"per-channel vector of {v.numel()} for C={c}")
    return v


def _dtype_code(x, *others):
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"fused-conv kernels take float32 or bfloat16 rows, "
                         f"got {x.dtype}")
    for t in others:
        if t is not None and t.dtype != x.dtype:
            raise ValueError(f"operand dtype {t.dtype} differs from x's "
                             f"{x.dtype}; the kernels take one dtype")
    return _DTYPE_CODES[x.dtype]


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check(err, what):
    if err != 0:
        raise RuntimeError(
            f"fused-conv {what} kernel launch failed: cudaError {err}")


def _scratch(which: int, m: int, c: int, k: int, dev):
    n = _library().bigdl_fused_conv_scratch(which, m, c, k)
    return torch.empty(max(n, 1), dtype=torch.float32, device=dev)


def fused_fwd_cuda(x, scale, shift, w, residual=None, want_y: bool = False):
    """The forward kernel: :func:`fused_fwd_reference`'s contract on card
    tensors (2-D rows)."""
    global fwd_launches
    x, w, residual = _card(x, w, residual)
    code = _dtype_code(x, w, residual)
    m, c = x.shape
    k = w.shape[1]
    if w.shape[0] != c or (residual is not None
                           and residual.shape != x.shape):
        raise ValueError(f"forward shapes: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}")
    scale, shift = _f32_vec(scale, c, x.device), _f32_vec(shift, c, x.device)
    z = torch.empty((m, k), dtype=x.dtype, device=x.device)
    zstats = torch.zeros((2, k), dtype=torch.float32, device=x.device)
    y = torch.empty_like(x) if want_y else None
    if m == 0:
        return (z, zstats, y) if want_y else (z, zstats)
    scratch = _scratch(0, m, c, k, x.device)
    with torch.cuda.device(x.device):
        err = _library().bigdl_fused_fwd(
            x.data_ptr(), _ptr(residual), scale.data_ptr(), shift.data_ptr(),
            w.data_ptr(), z.data_ptr(), _ptr(y), zstats.data_ptr(),
            scratch.data_ptr(), m, c, k, code,
            torch.cuda.current_stream(x.device).cuda_stream)
    _check(err, "forward")
    fwd_launches += 1
    return (z, zstats, y) if want_y else (z, zstats)


def fused_dgrad_cuda(dz, w, x, scale, shift, mean, inv_std, residual=None,
                     extra_dy=None):
    """The dgrad kernel: :func:`fused_dgrad_reference`'s contract on card
    tensors (2-D rows)."""
    global dgrad_launches
    dz, w, x, residual, extra_dy = _card(dz, w, x, residual, extra_dy)
    code = _dtype_code(x, dz, w, residual, extra_dy)
    m, c = x.shape
    k = w.shape[1]
    if dz.shape != (m, k) or w.shape[0] != c or any(
            t is not None and t.shape != x.shape
            for t in (residual, extra_dy)):
        raise ValueError(f"dgrad shapes: dz {tuple(dz.shape)}, w "
                         f"{tuple(w.shape)}, x {tuple(x.shape)}")
    vecs = [_f32_vec(v, c, x.device) for v in (scale, shift, mean, inv_std)]
    dp = torch.empty_like(x)
    q = torch.zeros((2, c), dtype=torch.float32, device=x.device)
    if m == 0:
        return dp, q
    with torch.cuda.device(x.device):  # the scratch depends on its SMs
        scratch = _scratch(1, m, c, k, x.device)
        err = _library().bigdl_fused_dgrad(
            dz.data_ptr(), w.data_ptr(), x.data_ptr(), _ptr(residual),
            _ptr(extra_dy), *(v.data_ptr() for v in vecs), dp.data_ptr(),
            q.data_ptr(), scratch.data_ptr(), m, c, k, code,
            torch.cuda.current_stream(x.device).cuda_stream)
    _check(err, "dgrad")
    dgrad_launches += 1
    return dp, q


def fused_wgrad_cuda(x, scale, shift, dz, residual=None,
                     out_dtype=torch.float32):
    """The wgrad kernel: :func:`fused_wgrad_reference`'s contract on card
    tensors (2-D rows)."""
    global wgrad_launches
    x, dz, residual = _card(x, dz, residual)
    code = _dtype_code(x, dz, residual)
    if out_dtype not in _DTYPE_CODES:
        raise ValueError(f"dW dtype {out_dtype} unsupported")
    m, c = x.shape
    k = dz.shape[1]
    if dz.shape[0] != m or (residual is not None
                            and residual.shape != x.shape):
        raise ValueError(f"wgrad shapes: x {tuple(x.shape)}, dz "
                         f"{tuple(dz.shape)}")
    scale, shift = _f32_vec(scale, c, x.device), _f32_vec(shift, c, x.device)
    dw = torch.empty((c, k), dtype=out_dtype, device=x.device)
    if m == 0:
        return dw.zero_()
    scratch = _scratch(2, m, c, k, x.device)
    with torch.cuda.device(x.device):
        err = _library().bigdl_fused_wgrad(
            x.data_ptr(), _ptr(residual), scale.data_ptr(), shift.data_ptr(),
            dz.data_ptr(), dw.data_ptr(), scratch.data_ptr(), m, c, k, code,
            _DTYPE_CODES[out_dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    _check(err, "wgrad")
    wgrad_launches += 1
    return dw


# ------------------------------------------------------------ public ops


def fused_scale_relu_matmul(x, scale, shift, w, residual=None,
                            want_y: bool = False):
    """``z = relu(x·scale + shift (+ residual)) @ w`` in one pass over x.
    Returns ``(z, zstats[, y])``: z ``(..., K)`` and y shaped like x in x's
    dtype, zstats ``(2, K)`` f32 = ``[Σz, Σz²]`` over all rows."""
    c, k = x.shape[-1], w.shape[1]
    fn = fused_fwd_cuda if x.device.type == "cuda" else fused_fwd_reference
    out = fn(x.reshape(-1, c), scale, shift, w, _rows(residual, c), want_y)
    z = out[0].reshape(*x.shape[:-1], k)
    if want_y:
        return z, out[1], out[2].reshape(x.shape)
    return z, out[1]


def fused_dgrad(dz, w, x, scale, shift, mean, inv_std, residual=None,
                extra_dy=None):
    """``dp = (dz @ wᵀ (+ extra_dy)) ⊙ 1[p > 0]`` and ``q = (Σdp, Σdp·x̂)``;
    dp is shaped like x, q is ``(2, C)`` f32."""
    c = x.shape[-1]
    fn = fused_dgrad_cuda if x.device.type == "cuda" else fused_dgrad_reference
    dp, q = fn(dz.reshape(-1, w.shape[1]), w, x.reshape(-1, c), scale, shift,
               mean, inv_std, _rows(residual, c), _rows(extra_dy, c))
    return dp.reshape(x.shape), q


def fused_wgrad(x, scale, shift, dz, residual=None, out_dtype=torch.float32):
    """``dW = relu(x·scale + shift (+ r))ᵀ @ dz``, ``(C, K)`` in
    ``out_dtype``; the activation is recomputed from x."""
    c = x.shape[-1]
    fn = fused_wgrad_cuda if x.device.type == "cuda" else fused_wgrad_reference
    return fn(x.reshape(-1, c), scale, shift, dz.reshape(-1, dz.shape[-1]),
              _rows(residual, c), out_dtype)


def _fold(gamma, beta, mean, var, eps):
    """(scale, shift, inv_std) f32: the BN folded into one affine map."""
    inv_std = torch.rsqrt(var.float() + eps)
    scale = gamma.float() * inv_std
    shift = beta.float() - mean.float() * scale
    return scale, shift, inv_std


class _BnReluConv1x1(torch.autograd.Function):
    """``bn_relu_conv1x1`` with its custom VJP (``fused_conv.py:520-575``)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, mean, var, w, residual, eps, want_y):
        scale, shift, _ = _fold(gamma, beta, mean, var, eps)
        out = fused_scale_relu_matmul(x, scale, shift, w, residual, want_y)
        ctx.mark_non_differentiable(out[1])
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, gamma, beta, mean, var, w, residual)
        ctx.eps = eps
        return out

    @staticmethod
    def backward(ctx, dz, _dzstats, dy_extra=None):
        x, gamma, beta, mean, var, w, residual = ctx.saved_tensors
        scale, shift, inv_std = _fold(gamma, beta, mean, var, ctx.eps)
        c = x.shape[-1]
        m = x.numel() // c
        if dz is None:
            dz = torch.zeros(*x.shape[:-1], w.shape[1], dtype=x.dtype,
                             device=x.device)
        dz = dz.to(x.dtype)
        dp, q = fused_dgrad(dz, w, x, scale, shift, mean, inv_std,
                            residual=residual, extra_dy=dy_extra)
        dbeta, dgamma = q[0], q[1]
        # BN-train dx in the data dtype: only the per-channel factors are
        # cast down (f32 intermediates would double this pass's bytes)
        xhat = (x - mean.to(x.dtype)) * inv_std.to(x.dtype)
        dx = scale.to(x.dtype) * (dp - (dbeta / m).to(x.dtype)
                                  - xhat * (dgamma / m).to(x.dtype))
        dw = fused_wgrad(x, scale, shift, dz, residual=residual,
                         out_dtype=w.dtype)
        return (dx, dgamma.to(gamma.dtype), dbeta.to(beta.dtype),
                torch.zeros_like(mean), torch.zeros_like(var), dw,
                dp if residual is not None else None, None, None)


def bn_relu_conv1x1(x, gamma, beta, mean, var, w, residual=None,
                    eps: float = 1e-5, want_y: bool = False):
    """The differentiable fused edge over channels-last rows.

    x: ``(..., C)`` pre-BN activations; mean/var: the batch statistics of
    x over all rows (running statistics at inference); w: ``(C, K)``;
    residual: shaped like x or None. Returns ``(z, zstats)`` or ``(z,
    zstats, y)`` as :func:`fused_scale_relu_matmul`. The backward is the
    full BN-train backward; ``zstats`` carries no gradient (the next fused
    edge that reads it owns its chain-rule share) and mean/var receive
    zeros."""
    return _BnReluConv1x1.apply(x, gamma, beta, mean, var, w, residual,
                                float(eps), bool(want_y))


_LIB: list = []


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of a library built from
    ``csrc/fused_conv.cu``."""
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.bigdl_fused_conv_scratch.argtypes = [i] * 4
    lib.bigdl_fused_conv_scratch.restype = ctypes.c_longlong
    lib.bigdl_fused_fwd.argtypes = [vp] * 9 + [i] * 4 + [vp]
    lib.bigdl_fused_dgrad.argtypes = [vp] * 12 + [i] * 4 + [vp]
    lib.bigdl_fused_wgrad.argtypes = [vp] * 7 + [i] * 5 + [vp]
    for fn in (lib.bigdl_fused_fwd, lib.bigdl_fused_dgrad,
               lib.bigdl_fused_wgrad):
        fn.restype = ctypes.c_int
    return lib


def _library():
    if not _LIB:
        from bigdl_tpu_torch.utils import cuda_build

        _LIB.append(bind(cuda_build.load("fused_conv")))
    return _LIB[0]
