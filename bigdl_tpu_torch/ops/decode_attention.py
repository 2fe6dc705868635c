"""Pooled decode attention: a CUDA kernel for Hopper + its plain version.

The serving engine's decode step scores ONE query per pooled row against
that row's own KV cache ``(N, L, H, D)``, masked to columns ``0..pos[r]``
inclusive. This module owns that inner loop, as ``bigdl_tpu.ops.
decode_attention`` does for the TPU:

* :func:`decode_attention_reference` — plain PyTorch, the exact math of
  the JAX reference (f32 scores and softmax; the int8 path contracts the
  RAW int8 values and applies the per-(row, head) scales as factored
  scalars). The CPU path and the yardstick the kernel is held to;
* :func:`pooled_decode_attention` — the wrapper of the hand-written
  kernel ``bigdl_tpu_torch/csrc/decode_attention.cu`` (built with nvcc at
  first use, bound through ctypes). It checks device, dtype, shape and
  contiguity, launches on the current stream, raises on a non-zero
  ``cudaGetLastError()``, and counts its launches in :data:`launches`;
* :func:`decode_attention` — the serving step's dispatch point: a CUDA
  tensor launches the kernel (or raises), a CPU tensor takes the plain
  version. There is no fallback between the two.

Quantized KV: K/V arrive int8 with one f32 scale per (row, head)
(``k_scale``/``v_scale``, shape ``(N, H)``); both scales factor out of
their contraction exactly, so int8 bytes are what the kernel reads.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

_NEG_INF = -1e30  # finite mask sentinel, as in the JAX steps

#: kernel launches since the count was last reset (callers reset it to 0
#: and read it after a run to show which path the run took)
launches = 0

_KV_CODES = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)


def _check_qkv(q, k, v, pos, k_scale, v_scale):
    if q.dim() != 3 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(
            f"expected q (N, H, D) and k/v (N, L, H, D), got "
            f"{tuple(q.shape)} / {tuple(k.shape)} / {tuple(v.shape)}")
    n, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != n or tuple(k.shape[2:]) != (h, d):
        raise ValueError(
            f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not match q "
            f"{tuple(q.shape)}")
    if tuple(pos.shape) != (n,):
        raise ValueError(f"pos must be ({n},), got {tuple(pos.shape)}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError(
            "quantized KV needs BOTH k_scale and v_scale (or neither)")
    if k_scale is not None:
        if tuple(k_scale.shape) != (n, h) or tuple(v_scale.shape) != (n, h):
            raise ValueError(
                f"per-(row, head) scales must be ({n}, {h}), got "
                f"{tuple(k_scale.shape)} / {tuple(v_scale.shape)}")
        if k.dtype != torch.int8 or v.dtype != torch.int8:
            raise ValueError(
                f"scaled K/V must be int8, got {k.dtype}/{v.dtype}")


def decode_attention_reference(q, k, v, pos, k_scale=None, v_scale=None,
                               scale: Optional[float] = None,
                               out_dtype=None):
    """Masked single-query pooled attention in plain PyTorch — the
    numerics contract the kernel is held to and the CPU serving path.

    ``q``: (N, H, D); ``k``/``v``: (N, L, H, D) float, or int8 with
    (N, H) f32 ``k_scale``/``v_scale``; ``pos``: (N,) int — row ``r``
    attends over its cache columns ``0..pos[r]`` INCLUSIVE. Scores and
    softmax are f32 whatever the input dtype. Returns (N, H, D) in
    ``out_dtype`` (default: q's dtype)."""
    _check_qkv(q, k, v, pos, k_scale, v_scale)
    d = q.shape[2]
    L = k.shape[1]
    if scale is None:
        scale = d ** -0.5
    if out_dtype is None:
        out_dtype = q.dtype
    valid = (torch.arange(L, device=k.device)[None, None, :]
             <= pos.to(torch.int32)[:, None, None])
    if k_scale is not None:
        s = torch.einsum("nhd,nlhd->nhl", q.float(), k.float())
        s = s * (scale * k_scale.float())[:, :, None]
        p = torch.softmax(torch.where(valid, s, _NEG_INF), dim=-1)
        ctx = torch.einsum("nhl,nlhd->nhd", p, v.float())
        ctx = ctx * v_scale.float()[:, :, None]
    else:
        # the dots take q in the cache dtype with f32 accumulation (the
        # JAX reference's preferred_element_type convention)
        s = torch.einsum("nhd,nlhd->nhl", q.to(k.dtype).float(),
                         k.float()) * scale
        p = torch.softmax(torch.where(valid, s, _NEG_INF), dim=-1)
        ctx = torch.einsum("nhl,nlhd->nhd", p.to(v.dtype).float(),
                           v.float())
    return ctx.to(out_dtype)


def pooled_decode_attention(q, k, v, pos, k_scale=None, v_scale=None,
                            scale: Optional[float] = None, out_dtype=None):
    """The CUDA kernel: same contract as :func:`decode_attention_reference`
    on tensors that lie on the card. Raises for CPU tensors, a head dim
    outside 32/64/128, a K/V dtype outside int8/bf16/f32, an output
    dtype outside f32/bf16, non-contiguous or misaligned operands, and a
    launch that ``cudaGetLastError()`` reports."""
    global launches
    _check_qkv(q, k, v, pos, k_scale, v_scale)
    n, h, d = q.shape
    L = k.shape[1]
    if scale is None:
        scale = d ** -0.5
    if out_dtype is None:
        out_dtype = q.dtype
    tensors = [q, k, v, pos] + ([k_scale, v_scale] if k_scale is not None
                                else [])
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(
            "pooled_decode_attention runs on the card: every operand must "
            f"be a CUDA tensor on one device (q is on {dev})")
    if d not in _HEAD_DIMS:
        raise ValueError(f"head dim {d} unsupported (one of {_HEAD_DIMS})")
    if k.dtype not in _KV_CODES:
        raise ValueError(f"K/V dtype {k.dtype} unsupported (int8/bf16/f32)")
    if out_dtype not in _OUT_CODES:
        raise ValueError(f"out_dtype {out_dtype} unsupported (f32/bf16)")
    if not q.dtype.is_floating_point:
        raise ValueError(f"q must be floating, got {q.dtype}")
    if not (k.is_contiguous() and v.is_contiguous()):
        raise ValueError("k/v must be contiguous (N, L, H, D)")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("k/v must be 16-byte aligned")
    # q enters as f32: the int8 path widens it (as the TPU kernel does);
    # the float path first rounds it to the cache dtype
    qf = (q if k_scale is not None else q.to(k.dtype)).float().contiguous()
    pos32 = pos.to(torch.int32).contiguous()
    scales = ([k_scale.float().contiguous(), v_scale.float().contiguous()]
              if k_scale is not None else [None, None])
    out = torch.empty((n, h, d), dtype=out_dtype, device=dev)
    if n == 0:
        return out
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.bigdl_decode_attention(
            qf.data_ptr(), k.data_ptr(), v.data_ptr(), pos32.data_ptr(),
            None if scales[0] is None else scales[0].data_ptr(),
            None if scales[1] is None else scales[1].data_ptr(),
            out.data_ptr(), n, L, h, d, _KV_CODES[k.dtype],
            _OUT_CODES[out_dtype], float(scale), stream)
    if err != 0:
        raise RuntimeError(
            f"decode_attention kernel launch failed: cudaError {err}")
    launches += 1
    return out


def decode_attention(q, k, v, pos, k_scale=None, v_scale=None,
                     scale: Optional[float] = None, out_dtype=None):
    """Dispatch by device: CUDA tensors launch the kernel (which raises
    on anything it does not support), CPU tensors take the plain
    version."""
    fn = (pooled_decode_attention if q.device.type == "cuda"
          else decode_attention_reference)
    return fn(q, k, v, pos, k_scale=k_scale, v_scale=v_scale, scale=scale,
              out_dtype=out_dtype)


_LIB: list = []


def _library():
    if not _LIB:
        from bigdl_tpu_torch.utils import cuda_build

        lib = cuda_build.load("decode_attention")
        fn = lib.bigdl_decode_attention
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _LIB.append(lib)
    return _LIB[0]
