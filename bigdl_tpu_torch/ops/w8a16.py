"""The weight-only int8 projection (W8A16): a CUDA kernel for Hopper + its
plain version.

``w_scale[n] * sum_k bf16(x[m, k]) * bf16(weight_q[n, k])``, accumulated
in f32, then the caller's epilogue (below): the ``weight_q`` branch of the JAX serving
projection (``bigdl_tpu/models/transformer.py:674-681``) and the
``weight_only`` branch of ``QuantizedLinear``
(``bigdl_tpu/nn/quantized.py:83-92``), both a ``dot_general`` of
``bf16(x)`` and ``bf16(weight_q)`` with ``preferred_element_type=f32``.
JAX has no Pallas kernel there (XLA fuses the int8 → bf16 convert into
the dot); the port writes that fusion by hand, because no single PyTorch
call computes the function (``F.linear`` over ``weight_q.to(bf16)`` writes
and reads a bf16 copy of every weight and rounds its output to bf16):

* :func:`w8a16_plain` — plain PyTorch,
  ``(x.bfloat16().float() @ weight_q.float().t()) * w_scale[:, 0]``, then
  the epilogue; a product of two bf16 values is exact in f32, so this is
  JAX's function up to the order of the sums. The tests hold the JAX
  function to it;
* :func:`w8a16_cuda` — the wrapper of ``bigdl_tpu_torch/csrc/w8a16.cu``
  (built with nvcc at first use, bound through ctypes): it checks device,
  dtype, shape and contiguity, splits K over several blocks when the
  output tiles are too few to fill the card (decode's rows), launches on
  the current stream, raises on a non-zero ``cudaGetLastError()``, and
  counts its launches in :data:`launches`;
* :func:`w8a16` — the dispatch point: CUDA tensors launch the kernel (or
  raise), CPU tensors take the plain version. There is no fallback
  between the two.

The epilogue is each caller's, computed inside the kernel so a
projection is one launch: ``out_dtype`` f32 adds an optional f32 bias
(``QuantizedLinear``); ``out_dtype`` bf16 rounds to bf16 and then adds an
optional bf16 bias in bf16 (the serving projection casts to the
activation's dtype and adds the bias in it), each step rounded once, as
PyTorch rounds the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

#: kernel launches since the count was last reset (callers reset it to 0
#: and read it after a run to show which path the run took)
launches = 0

_DEPTH = 64           # the kernel's K per stage (csrc/w8a16.cu kDepth)
_COLS = 64            # output columns per block
_MAX_TILES = 1024     # per-tile counters kept per (device, stream)


def w8a16_plain(x, weight_q, w_scale, bias=None,
                out_dtype=torch.float32):
    """The plain version: ``(x.bfloat16().float() @ weight_q.float().t())
    * w_scale[:, 0]`` over the last axis of ``x`` in f32, cast to
    ``out_dtype``, plus ``bias`` (of ``out_dtype``) added in it."""
    out = (x.to(torch.bfloat16).float() @ weight_q.float().t()) \
        * w_scale.reshape(-1)
    out = out.to(out_dtype)
    return out if bias is None else out + bias


def _check(x, weight_q, w_scale, bias, out_dtype):
    if weight_q.dim() != 2 or weight_q.dtype != torch.int8:
        raise ValueError(f"weight_q must be (N, K) int8, got "
                         f"{tuple(weight_q.shape)} {weight_q.dtype}")
    n, k = weight_q.shape
    if x.shape[-1] != k:
        raise ValueError(f"x's last axis {x.shape[-1]} != weight_q's K {k}")
    if w_scale.numel() != n or w_scale.dtype != torch.float32:
        raise ValueError(f"w_scale must hold {n} f32 values, got "
                         f"{tuple(w_scale.shape)} {w_scale.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype must be f32 or bf16, got {out_dtype}")
    if bias is not None and (bias.shape != (n,) or bias.dtype != out_dtype):
        raise ValueError(f"bias must be ({n},) {out_dtype}, got "
                         f"{tuple(bias.shape)} {bias.dtype}")


def split_plan(m: int, n: int, k: int, n_sm: int) -> Tuple[int, int]:
    """``(splits, k_split)``: how many blocks share one output tile's K.
    When the tiles fill the card (at least one per SM) none do; otherwise
    enough splits for about four blocks per SM, each at least two stages
    deep."""
    bm = 16 if m <= 16 else 64
    tiles = -(-n // _COLS) * -(-m // bm)
    stages = -(-k // _DEPTH)
    splits = 1
    if tiles < n_sm:
        splits = max(1, min(-(-4 * n_sm // tiles), stages // 2))
    per = -(-stages // splits)
    return -(-stages // per), per * _DEPTH


_COUNTERS: Dict[Tuple[int, int], torch.Tensor] = {}


def _counters(dev: torch.device, stream: int) -> torch.Tensor:
    """Zeroed per-tile arrival counters for split launches on ``stream``
    (the kernel leaves them zeroed)."""
    key = (dev.index, stream)
    c = _COUNTERS.get(key)
    if c is None:
        c = _COUNTERS[key] = torch.zeros(_MAX_TILES, dtype=torch.int32,
                                         device=dev)
    return c


def w8a16_cuda(x, weight_q, w_scale, bias=None, out_dtype=torch.float32):
    """The CUDA kernel. ``x`` (..., K) f32 or bf16, ``weight_q`` (N, K)
    int8, ``w_scale`` N f32 values ((N, 1) or (N,)), ``bias`` None or (N,)
    of ``out_dtype`` (f32 or bf16); returns (..., N) of ``out_dtype``.
    Raises for CPU tensors, operands on different devices, a
    non-contiguous ``weight_q``, ``w_scale`` or ``bias``, another dtype,
    and a launch that ``cudaGetLastError()`` reports."""
    global launches
    _check(x, weight_q, w_scale, bias, out_dtype)
    dev = x.device
    ops = (weight_q, w_scale) + (() if bias is None else (bias,))
    if dev.type != "cuda" or any(t.device != dev for t in ops):
        raise ValueError("w8a16_cuda runs on the card: x, weight_q, w_scale "
                         f"and bias must be CUDA tensors on one device (x is "
                         f"on {dev})")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be f32 or bf16, got {x.dtype}")
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("weight_q, w_scale and bias must be contiguous")
    n, k = weight_q.shape
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k).contiguous()
    m = x2.shape[0]
    if k == 0:
        raise ValueError("w8a16_cuda needs K > 0: there is nothing to reduce")
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    if m == 0 or n == 0:
        return out.reshape(*lead, n)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    splits, k_split = split_plan(m, n, k, n_sm)
    vec = int(k % 16 == 0 and x2.data_ptr() % 16 == 0
              and weight_q.data_ptr() % 16 == 0)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ws = counters = None
        if splits > 1:
            ws = torch.empty((splits, m, n), dtype=torch.float32, device=dev)
            counters = _counters(dev, stream)
        err = lib.bigdl_w8a16(
            x2.data_ptr(), weight_q.data_ptr(), w_scale.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(),
            None if counters is None else counters.data_ptr(), m, n, k,
            splits, k_split, int(x2.dtype == torch.bfloat16),
            int(out_dtype == torch.bfloat16), vec, stream)
    if err != 0:
        raise RuntimeError(f"w8a16 kernel launch failed: cudaError {err}")
    launches += 1
    return out.reshape(*lead, n)


def w8a16(x, weight_q, w_scale, bias=None, out_dtype=torch.float32):
    """``w_scale * (bf16(x) @ bf16(weight_q).T)`` in f32, cast to
    ``out_dtype``, plus ``bias``: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if x.device.type == "cuda":
        return w8a16_cuda(x, weight_q, w_scale, bias, out_dtype)
    _check(x, weight_q, w_scale, bias, out_dtype)
    return w8a16_plain(x, weight_q, w_scale, bias, out_dtype)


_LIB: list = []


def _library():
    if not _LIB:
        from bigdl_tpu_torch.utils import cuda_build

        lib = cuda_build.load("w8a16")
        fn = lib.bigdl_w8a16
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LIB.append(lib)
    return _LIB[0]
