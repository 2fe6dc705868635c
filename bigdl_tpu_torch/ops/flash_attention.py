"""Flash attention: three CUDA kernels for Hopper + their plain versions
(``bigdl_tpu/ops/flash_attention.py``).

The public functions take the attention layers' ``(B, T, H, D)`` layout:

* :func:`flash_attention` — differentiable fused attention (one
  ``torch.autograd.Function``, as the JAX function is one
  ``custom_vjp``: the forward saves ``(q, k, v, o, lse)`` and the backward
  is the FlashAttention-2 split into dq and dk/dv);
* :func:`flash_attention_with_lse` — forward only, ``(out, lse)`` with
  ``lse`` ``(B, H, Tq)`` f32, and an optional ``causal_offset`` diagonal
  shift (-1 = strict causal);
* :func:`flash_attention_block_grads` — the backward against a given
  ``lse`` (ring attention's building block).

Dispatch follows :mod:`bigdl_tpu_torch.ops.decode_attention`: a CUDA
tensor launches the hand-written kernels of
``bigdl_tpu_torch/csrc/flash_attention.cu`` (built with nvcc at first use,
bound through ctypes) or raises; a CPU tensor takes the plain version.
There is no fallback between the two. Each wrapper counts its launches in
:data:`fwd_launches`, :data:`dq_launches` and :data:`dkv_launches`.

``block`` is the TPU kernels' VMEM tile length; it is accepted for API
parity and has no effect: the CUDA kernels choose their own tiles (the
forward 128 query rows by 64 keys; dq 192 query rows, 128 at head dim
128, by 64 keys; dk/dv 128 keys by 64 queries, 32 at head dim 128), and
the plain version does not tile. The one numerical trace of
the JAX tiling is the online softmax's rounding of ``p`` to V's dtype
relative to the running max, which the tolerances of the tests state.

A fully masked row (``row + causal_offset < 0``) gets ``p = 1`` on every
real key, so its output is the mean of V and its LSE is ``-1e30`` (the
finite sentinel); the JAX kernels in interpret mode give the same when T
is a multiple of their block (otherwise they also count the zero-padded
keys).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

_NEG_INF = -1e30  # finite mask sentinel, as in the JAX kernels

#: kernel launches since the counts were last reset (callers set them to 0
#: and read them after a run to show which path the run took)
fwd_launches = 0
dq_launches = 0
dkv_launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check_causal_offset(causal, causal_offset):
    if causal_offset is not None and not causal:
        raise ValueError(
            "causal_offset requires causal=True — the non-causal path applies "
            "no mask, so the offset would be silently ignored")


def _check_shapes(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(
            f"expected (B, T, H, D) q/k/v, got {tuple(q.shape)} / "
            f"{tuple(k.shape)} / {tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or tuple(k.shape[2:]) != (h, d):
        raise ValueError(f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not match "
                         f"q {tuple(q.shape)}")


def _scores(q, k, scale, causal, off):
    """f32 masked scores (B, H, Tq, Tk): the dots take the inputs in their
    own dtype with f32 accumulation, as the kernels do."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        rows = torch.arange(q.shape[1], device=q.device)[:, None]
        cols = torch.arange(k.shape[1], device=q.device)[None, :]
        s = torch.where(cols <= rows + off, s, _NEG_INF)
    return s


def flash_forward_reference(q, k, v, scale: float, causal: bool = False,
                            causal_offset: int = 0):
    """Plain PyTorch forward: ``(o, lse)`` with ``o`` (B, Tq, H, D) in q's
    dtype and ``lse`` (B, H, Tq) f32. ``p`` is rounded to V's dtype before
    ``p.v``, as the kernels do."""
    s = _scores(q, k, scale, causal, causal_offset)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l_safe = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    o = o / l_safe.permute(0, 2, 1, 3)
    lse = (m + torch.log(l_safe))[..., 0]
    return o.to(q.dtype), lse


#: per-row relative tolerance of a kernel against its plain version (see
#: :func:`max_row_rel_err`): bf16 — p and ds are rounded to bf16 relative
#: to the running max in the kernels and to the final max in the plain
#: version, and both write bf16 (a few bf16 ulps of the row's largest
#: value); f32 — the same math with the sums in another order
ROW_RTOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def max_row_rel_err(got, want, floor: float = 1e-3) -> float:
    """The comparison the kernels are held to: the largest error of any
    row of ``got`` (one vector over the last dim: a query row of O or dq,
    a key row of dk or dv) relative to the largest magnitude of the same
    row of ``want``; a row smaller than ``floor`` x the tensor's largest
    magnitude is measured against that floor instead. Under causal masking
    row magnitudes span orders (row 0 of O is v[0], a late row averages
    thousands of keys), so an error scaled by the whole tensor's maximum
    would let a fault confined to the late rows through."""
    g = got.float().reshape(-1, got.shape[-1])
    w = want.float().reshape(-1, want.shape[-1])
    row_max = w.abs().amax(dim=1)
    scale = row_max.clamp_min(max(floor * float(row_max.max()), 1e-30))
    return float(((g - w).abs().amax(dim=1) / scale).max())


def _delta(o, do):
    """``delta = sum_d dO * O`` in f32, (B, H, Tq): the plain version's, as
    the JAX wrapper computes it outside its kernels. On the card the bf16
    dq kernel computes it for its own rows and writes it for dk/dv."""
    return (do.float() * o.float()).sum(dim=-1).transpose(1, 2)


def flash_backward_reference(q, k, v, o, lse, do, scale: float,
                             causal: bool = False, causal_offset: int = 0):
    """Plain PyTorch block backward against a given ``lse`` (B, H, Tq):
    ``(dq, dk, dv)`` shaped and typed like q/k/v. ``ds`` is rounded to k's
    (for dq) and q's (for dk) dtype, ``p`` to dO's (for dv)."""
    s = _scores(q, k, scale, causal, causal_offset)
    p = torch.exp(s - lse.float()[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = p * (dp - _delta(o, do)[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(),
                      k.float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(),
                      q.float()) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ------------------------------------------------------------ CUDA wrappers


def _card_operands(*tensors):
    """Checks shared by the three wrappers; returns the operands as
    contiguous 16-byte aligned tensors."""
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(
            "the flash kernels run on the card: every operand must be a CUDA "
            f"tensor on one device (q is on {dev})")
    dtype = tensors[0].dtype
    if dtype not in _DTYPE_CODES or any(t.dtype != dtype for t in tensors):
        raise ValueError(
            f"flash kernels take q/k/v/o/dO all float32 or all bfloat16, got "
            f"{sorted({str(t.dtype) for t in tensors})}")
    d = tensors[0].shape[-1]
    if not 1 <= d <= 128:
        raise ValueError(f"head dim {d} unsupported (1..128)")
    if dtype == torch.bfloat16 and d % 8:
        raise ValueError(f"bf16 head dim {d} must be a multiple of 8")
    out = []
    for t in tensors:
        t = t.contiguous()
        if t.data_ptr() % 16:
            t = t.clone()
        out.append(t)
    return out


def _check_err(err, what):
    if err != 0:
        raise RuntimeError(f"flash {what} kernel launch failed: cudaError {err}")


def flash_fwd_cuda(q, k, v, scale: float, causal: bool = False,
                   causal_offset: int = 0):
    """The forward kernel: same contract as :func:`flash_forward_reference`
    on card tensors."""
    global fwd_launches
    _check_shapes(q, k, v)
    q, k, v = _card_operands(q, k, v)
    b, tq, h, d = q.shape
    tk = k.shape[1]
    if tk == 0:
        raise ValueError("flash attention needs at least one key")
    o = torch.empty_like(q)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    if b * h * tq == 0:
        return o, lse
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _library().bigdl_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, h, tq, tk, d, int(causal), int(causal_offset),
            float(scale), _DTYPE_CODES[q.dtype], stream)
    _check_err(err, "forward")
    fwd_launches += 1
    return o, lse


def flash_bwd_cuda(q, k, v, o, lse, do, scale: float, causal: bool = False,
                   causal_offset: int = 0):
    """The dq and dk/dv kernels: same contract as
    :func:`flash_backward_reference` on card tensors. In bf16 the dq kernel
    also computes delta (``sum_d dO * O``) and writes it to a scratch buffer
    that the dk/dv kernel, launched after it on the same stream, reads; the
    f32 kernels take the plain version's delta, so that their checks against
    it compare the same sums (a row whose true gradient is 0 keeps only
    their rounding)."""
    global dq_launches, dkv_launches
    _check_shapes(q, k, v)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o/dO {tuple(o.shape)}/{tuple(do.shape)} must be "
                         f"shaped like q {tuple(q.shape)}")
    q, k, v, o, do = _card_operands(q, k, v, o, do)
    b, tq, h, d = q.shape
    tk = k.shape[1]
    if tuple(lse.shape) != (b, h, tq):
        raise ValueError(f"lse must be ({b}, {h}, {tq}), got "
                         f"{tuple(lse.shape)}")
    if tk == 0:
        raise ValueError("flash attention needs at least one key")
    lse = lse.to(device=q.device, dtype=torch.float32).contiguous()
    # bf16: the dq kernel writes delta; f32: the plain version's delta
    delta = (torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
             if q.dtype == torch.bfloat16 else _delta(o, do).contiguous())
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if b * h * tq == 0:
        return dq, dk.zero_(), dv.zero_()
    geo = (b, h, tq, tk, d, int(causal), int(causal_offset), float(scale),
           _DTYPE_CODES[q.dtype])
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.bigdl_flash_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            *geo, stream)
        _check_err(err, "dq")
        dq_launches += 1
        err = lib.bigdl_flash_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *geo, stream)
        _check_err(err, "dk/dv")
        dkv_launches += 1
    return dq, dk, dv


def _forward(q, k, v, scale, causal, off):
    fn = flash_fwd_cuda if q.device.type == "cuda" else flash_forward_reference
    return fn(q, k, v, scale, causal, off)


def _backward(q, k, v, o, lse, do, scale, causal, off):
    fn = (flash_bwd_cuda if q.device.type == "cuda"
          else flash_backward_reference)
    return fn(q, k, v, o, lse, do, scale, causal, off)


class _Flash(torch.autograd.Function):
    """``_flash`` with its custom VJP (``flash_attention.py:406-423``)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        o, lse = _forward(q, k, v, scale, causal, 0)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.causal = scale, causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, o, lse, do, ctx.scale, ctx.causal, 0)
        return dq, dk, dv, None, None


def _scale(q, scale):
    return float(q.shape[-1] ** -0.5 if scale is None else scale)


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None,
                    block: Optional[int] = None):
    """Fused attention over (B, T, H, D) tensors; differentiable.
    ``block`` is accepted for API parity and ignored (module docstring)."""
    _check_shapes(q, k, v)
    return _Flash.apply(q, k, v, _scale(q, scale), bool(causal))


def flash_attention_with_lse(q, k, v, scale: Optional[float] = None,
                             block: Optional[int] = None,
                             causal: bool = False, causal_offset=None):
    """Forward only: ``(out (B, Tq, H, D), lse (B, H, Tq) f32)``.
    ``causal_offset`` shifts the diagonal (-1 = strict: ``col < row``)."""
    _check_causal_offset(causal, causal_offset)
    _check_shapes(q, k, v)
    return _forward(q, k, v, _scale(q, scale), bool(causal),
                    int(causal_offset or 0))


def flash_attention_block_grads(q, k, v, o, lse, do,
                                scale: Optional[float] = None,
                                block: Optional[int] = None,
                                causal: bool = False, causal_offset=None):
    """Per-block backward against GLOBAL softmax statistics: ``lse`` is the
    (B, H, Tq) log-sum-exp of the full softmax, so the block's
    ``exp(s - lse)`` are the true probabilities. Returns ``(dq, dk, dv)``
    shaped like q/k/v."""
    _check_causal_offset(causal, causal_offset)
    _check_shapes(q, k, v)
    return _backward(q, k, v, o, lse, do, _scale(q, scale), bool(causal),
                     int(causal_offset or 0))


_LIB: list = []


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of a library built from
    ``csrc/flash_attention.cu``."""
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    geo = [i] * 7 + [f, i, vp]  # B H Tq Tk D causal off, scale, dtype, stream
    lib.bigdl_flash_fwd.argtypes = [vp] * 5 + geo
    lib.bigdl_flash_dq.argtypes = [vp] * 8 + geo  # ... o, dO, lse, delta, dq
    lib.bigdl_flash_dkv.argtypes = [vp] * 8 + geo
    for fn in (lib.bigdl_flash_fwd, lib.bigdl_flash_dq, lib.bigdl_flash_dkv):
        fn.restype = ctypes.c_int
    return lib


def _library():
    if not _LIB:
        from bigdl_tpu_torch.utils import cuda_build

        _LIB.append(bind(cuda_build.load("flash_attention")))
    return _LIB[0]
