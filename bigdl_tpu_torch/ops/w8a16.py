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
* :func:`w8a16_split_reference` — the kernel's split-K arithmetic in
  plain PyTorch: one f32 partial product per split of K, summed in split
  order (the order the kernel's cluster sums them), then the epilogue;
* :func:`launch_plan` — the plain-Python planner of the kernel's launch:
  which kernel (by M), the column tile, how many blocks of one cluster
  split K, and the shared-memory ring of a block;
* :func:`w8a16_cuda` — the wrapper of ``bigdl_tpu_torch/csrc/w8a16.cu``
  (built with nvcc at first use, bound through ctypes): it checks device,
  dtype, shape and contiguity, takes the plan cached for (device, M, N, K,
  dtype, alignment), launches once on the current stream with nothing
  allocated but the output, raises on a non-zero ``cudaGetLastError()``,
  and counts its launches in :data:`launches`;
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
from typing import Dict, NamedTuple

import torch

from bigdl_tpu_torch.utils import cuda_build

#: kernel launches since the count was last reset (callers reset it to 0
#: and read it after a run to show which path the run took)
launches = 0

_DEPTH = 64           # the kernels' K per stage (csrc/w8a16.cu kDepth)
MAX_SPLITS = 8        # blocks of one cluster (a portable cluster's limit)
#: M up to which a call is a decode call: 16-row tiles on ``mma.sync``
DECODE_ROWS = 16
DECODE_STAGE_K = 256  # K per ring stage of a decode block
DECODE_RING = 2       # ring stages of a decode block
PREFILL_TILE = 128    # weight rows and x rows of a prefill (wgmma) tile
RING_BYTES = 64 << 10  # a 64-row block's ring: three blocks fit on an SM

#: the kernels, by ``Plan.regime`` (``bigdl_w8a16``'s ``regime`` argument)
REGIMES = {"decode": 0, "rows": 1, "prefill": 2}


class Plan(NamedTuple):
    """One launch: ``regime`` (``"decode"``, ``"rows"`` or
    ``"prefill"``), its output tile of ``bm`` x rows and ``bn`` weight
    rows, ``splits`` blocks of one cluster over K, each ``k_split`` deep,
    in stages of ``stage_k``, and ``ring`` shared-memory stages per
    ``mma.sync`` block."""
    regime: str
    bm: int
    bn: int
    splits: int
    k_split: int
    stage_k: int
    ring: int


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


def _stage_bytes(bm: int, bn: int, stage_k: int, x_bytes: int) -> int:
    """One ring stage of a rows block (``RowsSmem::kStage``): x's
    ``stage_k`` values of ``bm`` rows, then the weight tile's ``bn`` rows
    of ``stage_k`` codes, rounded up to 1 KB."""
    return -(-stage_k * (bm * x_bytes + bn) // 1024) * 1024


def launch_plan(m: int, n: int, k: int, sms: int, x_bf16: bool = True,
                tma: bool = True, out_bf16: bool = True) -> Plan:
    """The launch of one call, from M, N, K and the card's SM count.

    The regime is picked by M. ``m <= DECODE_ROWS`` (16) is ``"decode"``:
    16-row tiles on ``mma.sync`` in stages of ``DECODE_STAGE_K`` (256) K
    and a ring of ``DECODE_RING`` (2) stages. A larger M is ``"prefill"``
    when x is bf16 and TMA can read both operands (``tma``: K % 16 == 0
    and 16-byte aligned x and weight_q): tiles of 128 x rows (``bm``) and
    128 weight rows (``bn``) on wgmma, or 256 weight rows when the output
    is bf16 and there are at least two such tiles per SM (twice the
    products per byte of x read). Otherwise it is ``"rows"``: 64 x 64
    tiles on ``mma.sync`` in stages of 64 K and a ring that holds the
    block's share of K when it fits in ``RING_BYTES``. A decode tile is
    128 columns wide when there are at least two such tiles per SM, else
    64 on the same condition, else 32. When the tiles are fewer than
    ``want`` blocks (decode: 7/10 of the SMs, enough to hide the latency
    of one load; rows: the SMs), K is split over ``min(8, stages,
    ceil(want / tiles))`` blocks of one cluster, each a whole number of
    stages, and no split is left empty. (The constants are those that
    measured fastest on an H100 at the 137m LM's shapes.)"""
    if m > DECODE_ROWS and x_bf16 and tma:
        rows = PREFILL_TILE
        if out_bf16 and -(-n // 256) * -(-m // PREFILL_TILE) >= 2 * sms:
            rows = 256
        return Plan("prefill", PREFILL_TILE, rows, 1,
                    -(-k // _DEPTH) * _DEPTH, _DEPTH, 1)
    decode = m <= DECODE_ROWS
    bm = 16 if decode else 64
    stage_k = DECODE_STAGE_K if decode else _DEPTH
    stages = -(-k // stage_k)
    m_tiles = -(-m // bm)

    def tiles(bn):
        return -(-n // bn) * m_tiles

    if decode:
        bn = next((b for b in (128, 64) if tiles(b) >= 2 * sms), 32)
        want = -(-7 * sms // 10)      # blocks enough to hide the latency
    else:
        bn, want = 64, sms
    t = tiles(bn)
    splits = 1 if t >= want else min(MAX_SPLITS, stages, -(-want // t))
    per = -(-stages // splits)
    splits = -(-stages // per)
    if decode:
        ring = min(per, DECODE_RING)
    else:
        stage = _stage_bytes(bm, bn, stage_k, 2 if x_bf16 else 4)
        ring = max(1, min(per, RING_BYTES // stage))
    return Plan("decode" if decode else "rows", bm, bn, splits,
                per * stage_k, stage_k, ring)


def w8a16_split_reference(x, weight_q, w_scale, bias=None,
                          out_dtype=torch.float32, splits: int = 1,
                          k_split: int = None):
    """The kernel's split-K arithmetic in plain PyTorch: K cut into
    ``splits`` ranges of ``k_split`` (default: K split evenly, rounded up to
    64), each range's ``bf16(x) @ bf16(weight_q)ᵀ`` an f32 partial, the
    partials summed in split order from zero (a range wholly past K adds
    zeros), then ``w_scale``, the cast and ``bias`` as in
    :func:`w8a16_plain`."""
    k = weight_q.shape[1]
    if k_split is None:
        k_split = -(-k // (splits * _DEPTH)) * _DEPTH
    if splits * k_split < k:
        raise ValueError(f"{splits} splits of {k_split} do not cover K {k}")
    xb = x.to(torch.bfloat16).float()
    wf = weight_q.float()
    acc = torch.zeros(*x.shape[:-1], weight_q.shape[0], dtype=torch.float32,
                      device=x.device)
    for s in range(splits):
        lo, hi = min(k, s * k_split), min(k, (s + 1) * k_split)
        acc = acc + xb[..., lo:hi] @ wf[:, lo:hi].t()
    out = (acc * w_scale.reshape(-1)).to(out_dtype)
    return out if bias is None else out + bias


_PLANS: Dict[tuple, Plan] = {}
_SMS: Dict[int, int] = {}


def _plan(dev: torch.device, m: int, n: int, k: int, x_bf16: bool,
          tma: bool, out_bf16: bool) -> Plan:
    """:func:`launch_plan`, cached per (device, M, N, K, dtypes,
    alignment); the SM count read once per device."""
    key = (dev, m, n, k, x_bf16, tma, out_bf16)
    plan = _PLANS.get(key)
    if plan is None:
        sms = _SMS.get(dev.index)
        if sms is None:
            sms = _SMS[dev.index] = torch.cuda.get_device_properties(
                dev).multi_processor_count
        plan = _PLANS[key] = launch_plan(m, n, k, sms, x_bf16, tma,
                                         out_bf16)
    return plan


def w8a16_cuda(x, weight_q, w_scale, bias=None, out_dtype=torch.float32):
    """The CUDA kernel. ``x`` (..., K) f32 or bf16, ``weight_q`` (N, K)
    int8, ``w_scale`` N f32 values ((N, 1) or (N,)), ``bias`` None or (N,)
    of ``out_dtype`` (f32 or bf16); returns (..., N) of ``out_dtype``.
    Raises for CPU tensors, operands on different devices, a
    non-contiguous ``weight_q``, ``w_scale`` or ``bias``, another dtype,
    and a launch that ``cudaGetLastError()`` reports."""
    global launches
    _check(x, weight_q, w_scale, bias, out_dtype)
    idx = x.get_device()     # -1 on the CPU
    if idx < 0 or weight_q.get_device() != idx or \
            w_scale.get_device() != idx or \
            (bias is not None and bias.get_device() != idx):
        raise ValueError("w8a16_cuda runs on the card: x, weight_q, w_scale "
                         f"and bias must be CUDA tensors on one device (x is "
                         f"on {x.device})")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be f32 or bf16, got {x.dtype}")
    if not (weight_q.is_contiguous() and w_scale.is_contiguous()
            and (bias is None or bias.is_contiguous())):
        raise ValueError("weight_q, w_scale and bias must be contiguous")
    n, k = weight_q.shape
    if k == 0:
        raise ValueError("w8a16_cuda needs K > 0: there is nothing to reduce")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k)
    if not x2.is_contiguous():
        x2 = x2.contiguous()
    m = x2.shape[0]
    out = x2.new_empty((m, n), dtype=out_dtype)
    if m == 0 or n == 0:
        return out.reshape(*lead, n)
    x_bf16 = x2.dtype == torch.bfloat16
    xp, wp = x2.data_ptr(), weight_q.data_ptr()
    tma = k % 16 == 0 and xp % 16 == 0 and wp % 16 == 0
    out_bf16 = out_dtype == torch.bfloat16
    plan = _plan(x.device, m, n, k, x_bf16, tma, out_bf16)
    lib = _library()
    args = (xp, wp, w_scale.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(), m, n,
            k, REGIMES[plan.regime], plan.bn, plan.splits, plan.k_split,
            plan.stage_k, plan.ring, int(x_bf16), int(out_bf16))
    if idx == torch.cuda.current_device():
        err = lib.bigdl_w8a16(*args, cuda_build.raw_stream(idx))
    else:
        with torch.cuda.device(idx):
            err = lib.bigdl_w8a16(*args, cuda_build.raw_stream(idx))
    if err != 0:
        raise RuntimeError(f"w8a16 kernel launch failed: cudaError {err}")
    launches += 1
    return out if len(lead) == 1 else out.reshape(*lead, n)


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
        lib = cuda_build.load("w8a16")
        fn = lib.bigdl_w8a16
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 11 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LIB.append(lib)
    return _LIB[0]
