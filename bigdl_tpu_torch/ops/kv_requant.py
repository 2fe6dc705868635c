"""The int8 KV cache's grow-only scale merge: a CUDA kernel for Hopper +
its plain version.

The decode step's int8 cache keeps one f32 scale per (row, head). When a
new K/V value outgrows a scale, the scale jumps and every stored value of
that (row, head) is requantized to it: ``q' = round(q * s_old / s_new)``.
The JAX step skips that pass on the device under ``lax.cond`` when no scale
grew (``bigdl_tpu/models/transformer.py:628-657``). This module is the
port's counterpart:

* :func:`kv_scale_merge` — the grow-only scale rule in plain PyTorch:
  ``(s_new, s_safe, ratio)`` from the old scales and the new values'
  maxima;
* :func:`kv_requant_reference` — plain PyTorch, ``round(q * ratio)`` as a
  new int8 tensor;
* :func:`kv_merge_reference` — the two together for both caches: the
  unconditional merge, the CPU path and the yardstick the kernel is held
  to;
* :func:`kv_requant_cuda` — the wrapper of the hand-written kernel
  ``bigdl_tpu_torch/csrc/kv_requant.cu`` (built with nvcc at first use,
  bound through ctypes): the scale rule and both caches in one launch,
  the caches in place, every (cache, row, head) pair whose ratio is
  exactly 1.0 skipped on the card, a row's positions spread over the
  blocks :func:`chunk_plan` gives it. It checks device, dtype, shape and
  contiguity, launches on the current stream, raises on a non-zero
  ``cudaGetLastError()``, and counts its launches in :data:`launches`;
* :func:`kv_requant` — the decode step's dispatch point: CUDA tensors
  launch the kernel (or raise), CPU tensors take the plain version. There
  is no fallback between the two.

A ratio of exactly 1.0 requantizes a value to itself, so the kernel's skip
and the plain version's unconditional pass agree bit for bit, and neither
reads anything back to the host.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from bigdl_tpu_torch.utils import cuda_build

#: kernel launches since the count was last reset (callers reset it to 0
#: and read it after a run to show which path the run took)
launches = 0

# Over-provision a growing scale by this factor
# (``bigdl_tpu/models/transformer.py:594``): one growth jumps past the
# running max, so requantizations stay rare.
_KV_SCALE_HEADROOM = 1.25

# ``amax / 127`` spelled as a multiply by the f32 reciprocal, which the
# kernel, PyTorch on the card and PyTorch on the CPU all round alike
# (PyTorch's CUDA division by a scalar multiplies by its reciprocal, its CPU
# division divides)
_INV_127 = float(np.float32(1.0) / np.float32(127.0))


#: cache bytes of one block's chunk: two rounds of 256 threads x 8 16-byte
#: vectors, each thread's loaded before its first store
CHUNK_BYTES = 2 * 256 * 8 * 16


def chunk_plan(L: int, h: int, d: int):
    """``(chunk, chunks)``: positions per block and blocks per (cache,
    row). A block takes ``chunk`` consecutive positions of one row, every
    head of them (``chunk * h * d`` contiguous bytes, at most
    ``CHUNK_BYTES`` unless one position is larger), so ``chunk =
    max(1, CHUNK_BYTES // (h * d))`` and ``chunks = ceil(L / chunk)``;
    chunk ``c`` holds positions ``c * chunk`` up to ``min(L, (c + 1) *
    chunk)``. (64 KB measured fastest on an H100 at the serving shape
    among 32, 64 and 128 KB with no pair grown.)"""
    chunk = min(L, max(1, CHUNK_BYTES // (h * d)))
    return chunk, -(-L // chunk)


def kv_scale_merge(s_old, amax_new):
    """The grow-only per-(row, head) scale rule (``transformer.py:597``):
    ``(s_new, s_safe, ratio)``, all (R, H) f32 on the device. A scale
    grows to ``_KV_SCALE_HEADROOM`` times ``amax_new / 127`` when that
    exceeds it; ``ratio = s_old / s_new`` requantizes the stored values
    (exactly 1.0 where the scale did not grow); ``s_safe`` substitutes 1.0
    for a still-zero scale so dividing by it is always defined."""
    s_cand = amax_new * _INV_127
    s_new = torch.where(s_cand > s_old, s_cand * _KV_SCALE_HEADROOM, s_old)
    live = s_new > 0
    s_safe = torch.where(live, s_new, 1.0)
    ratio = torch.where(live, s_old / s_safe, 1.0)
    return s_new, s_safe, ratio


def kv_requant_reference(qc, ratio):
    """``round(qc * ratio)`` as a NEW int8 tensor: ``qc`` (R, L, H, D) int8,
    ``ratio`` (R, H) f32, rounding half to even in f32."""
    return torch.round(qc.float() * ratio[:, None, :, None]).to(torch.int8)


def kv_merge_reference(kc, vc, ks_old, vs_old, k_amax, v_amax):
    """The plain version of the kernel: the scale rule and the
    unconditional requantize of both caches. Returns NEW ``(kc, vc, ks,
    vs, ks_safe, vs_safe)``."""
    ks, ks_safe, k_ratio = kv_scale_merge(ks_old, k_amax)
    vs, vs_safe, v_ratio = kv_scale_merge(vs_old, v_amax)
    return (kv_requant_reference(kc, k_ratio),
            kv_requant_reference(vc, v_ratio), ks, vs, ks_safe, vs_safe)


def _check(kc, vc, scales):
    if kc.dim() != 4 or kc.shape != vc.shape:
        raise ValueError(
            f"expected k/v caches (N, L, H, D) of one shape, got "
            f"{tuple(kc.shape)} / {tuple(vc.shape)}")
    n, _, h, _ = kc.shape
    if any(tuple(s.shape) != (n, h) for s in scales):
        raise ValueError(
            f"scales and maxima must be ({n}, {h}), got "
            f"{[tuple(s.shape) for s in scales]}")
    if kc.dtype != torch.int8 or vc.dtype != torch.int8:
        raise ValueError(f"caches must be int8, got {kc.dtype}/{vc.dtype}")
    if any(s.dtype != torch.float32 for s in scales):
        raise ValueError(
            f"scales and maxima must be f32, got "
            f"{[s.dtype for s in scales]}")


def kv_requant_cuda(kc, vc, ks_old, vs_old, k_amax, v_amax):
    """The CUDA kernel: the scale rule for every (cache, row, head) pair,
    and ``kc``/``vc`` rewritten in place, every pair whose ratio is not
    1.0 as ``round(q * ratio)``. Returns ``(kc, vc, ks, vs, ks_safe,
    vs_safe)``, the scales as views of one new (4, N, H) tensor. Raises
    for CPU tensors, operands on different devices, non-contiguous
    operands, a dtype other than int8 caches and f32 scales, and a launch
    that ``cudaGetLastError()`` reports."""
    global launches
    small = (ks_old, vs_old, k_amax, v_amax)
    _check(kc, vc, small)
    idx = kc.get_device()     # -1 on the CPU
    ops = (kc, vc) + small
    if idx < 0 or any(t.get_device() != idx for t in small + (vc,)):
        raise ValueError(
            "kv_requant_cuda runs on the card: every operand must be a "
            f"CUDA tensor on one device (kc is on {kc.device})")
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("caches, scales and maxima must be contiguous")
    n, L, h, d = kc.shape
    out = ks_old.new_empty((4, n, h))
    if n * L * h * d == 0:
        return (kc, vc) + out.unbind(0)
    vec16 = int(d % 16 == 0 and kc.data_ptr() % 16 == 0
                and vc.data_ptr() % 16 == 0)
    chunk, chunks = chunk_plan(L, h, d)
    lib = _library()
    args = (kc.data_ptr(), vc.data_ptr(), ks_old.data_ptr(),
            vs_old.data_ptr(), k_amax.data_ptr(), v_amax.data_ptr(),
            out.data_ptr(), n, L, h, d, vec16, chunk, chunks)
    if idx == torch.cuda.current_device():
        err = lib.bigdl_kv_requant(*args, cuda_build.raw_stream(idx))
    else:
        with torch.cuda.device(idx):
            err = lib.bigdl_kv_requant(*args, cuda_build.raw_stream(idx))
    if err != 0:
        raise RuntimeError(f"kv_requant kernel launch failed: cudaError {err}")
    launches += 1
    return (kc, vc) + out.unbind(0)


def kv_requant(kc, vc, ks_old, vs_old, k_amax, v_amax):
    """Merge the new values' maxima into both pooled caches' scales and
    requantize the caches in place; returns ``(kc, vc, ks, vs, ks_safe,
    vs_safe)``: the kernel for CUDA tensors, the plain version (copied
    back into the caches) for CPU tensors."""
    if kc.device.type == "cuda":
        return kv_requant_cuda(kc, vc, ks_old.contiguous(),
                               vs_old.contiguous(), k_amax.contiguous(),
                               v_amax.contiguous())
    _check(kc, vc, (ks_old, vs_old, k_amax, v_amax))
    kc2, vc2, *scales = kv_merge_reference(kc, vc, ks_old, vs_old, k_amax,
                                           v_amax)
    kc.copy_(kc2)
    vc.copy_(vc2)
    return (kc, vc, *scales)


_LIB: list = []


def _library():
    if not _LIB:
        lib = cuda_build.load("kv_requant")
        fn = lib.bigdl_kv_requant
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LIB.append(lib)
    return _LIB[0]
