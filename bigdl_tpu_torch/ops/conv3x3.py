"""3×3 stride-1 SAME convolution over NHWC tensors: a CUDA kernel for
Hopper and its plain version (``pallas_conv3x3`` of
``benchmarks/pallas_conv3x3_experiment.py:72``, kernel ``_kernel`` ``:49``).

``conv3x3(x, w9)`` takes x ``(N, H, W, C)`` and the tap-major weight
planes w9 ``(9, C, K)`` (the HWIO weight ``(3, 3, C, K)`` with its two
spatial axes flattened, tap ``t = 3·dy + dx``) and returns ``(N, H, W, K)``
in x's dtype: the cross-correlation every framework calls a convolution,
with one zero pixel of padding on each side, summed in f32.

The tap-shift form, as the TPU kernel computes it: the input is padded
with 1 zero row on top, 2 at the bottom (the largest tap's slab stays in
bounds) and 1 zero column on each side, and each image is flattened to
``((H+3)·(W+2), C)`` rows. An output row ``r = y·(W+2) + x`` lives in
padded-width space, and tap t is the contiguous slab of rows that starts
at ``dy·(W+2) + dx``; the 9 slab products accumulate in f32, and columns
``W`` and ``W+1`` of each padded-width row are dropped. The JAX function's
images-per-block choice (``bn``) sizes TPU VMEM blocks and has no
counterpart. The JAX function has no gradient, so neither has this one.

Dispatch: a CUDA tensor launches the hand-written kernel of
``bigdl_tpu_torch/csrc/conv3x3.cu`` (built with nvcc at first use, bound
through ctypes) once, on the unpadded input: the kernel reads each tap's
shifted pixels in place and zero-fills the ones outside the image, so
the entry point makes no padded copy (the JAX function pads with
``jnp.pad`` outside its kernel; the plain version keeps that form). It
raises rather than fall back; a CPU tensor takes the plain version.
:data:`launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

# the comparison the kernel is held to (an output pixel's K channels
# against the same pixel of the plain version), shared with the other ops
from bigdl_tpu_torch.ops.flash_attention import max_row_rel_err  # noqa: F401

#: kernel launches since the count was last reset
launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: per-row relative tolerance of the kernel against its plain version (see
#: ``max_row_rel_err``; a row is one output pixel's K channels): f32 — the
#: same f32 products summed in another order; bf16 — products of bf16
#: values are exact in f32, so the two f32 sums differ by order alone, and
#: the bf16 outputs round once: at most one bf16 ulp apart, which is 2^-8
#: to 2^-7 of the value
ROW_RTOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def w9_from_oihw(w):
    """A ``SpatialConvolution``-style weight ``(K, C, 3, 3)`` as the
    tap-major planes ``(9, C, K)``."""
    if w.dim() != 4 or tuple(w.shape[2:]) != (3, 3):
        raise ValueError(f"expected an OIHW weight (K, C, 3, 3), got "
                         f"{tuple(w.shape)}")
    k, c = w.shape[:2]
    return w.permute(2, 3, 1, 0).reshape(9, c, k).contiguous()


def oihw_from_w9(w9):
    """The tap-major planes ``(9, C, K)`` as an OIHW weight ``(K, C, 3,
    3)``, the experiment's ``w4.transpose(3, 2, 0, 1)``."""
    if w9.dim() != 3 or w9.shape[0] != 9:
        raise ValueError(f"expected tap-major planes (9, C, K), got "
                         f"{tuple(w9.shape)}")
    c, k = w9.shape[1:]
    return w9.reshape(3, 3, c, k).permute(3, 2, 0, 1).contiguous()


def pad_rows(x):
    """x ``(N, H, W, C)`` zero-padded to ``(N, H+3, W+2, C)``: 1 row on
    top, 2 at the bottom, 1 column on each side (``:82-84``). The plain
    version's form; the kernel reads x unpadded."""
    return F.pad(x, (0, 0, 1, 1, 1, 2))


def _check(x, w9):
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC (N, H, W, C), got shape "
                         f"{tuple(x.shape)}")
    c = x.shape[3]
    if w9.dim() != 3 or w9.shape[0] != 9 or w9.shape[1] != c:
        raise ValueError(f"w9 must be (9, C={c}, K), got "
                         f"{tuple(w9.shape)}")
    if x.dtype not in _DTYPE_CODES or w9.dtype != x.dtype:
        raise ValueError(f"x and w9 must both be float32 or both bfloat16, "
                         f"got {x.dtype} and {w9.dtype}")
    if not (x.is_contiguous() and w9.is_contiguous()):
        raise ValueError("x and w9 must be contiguous (x NHWC in memory)")


# ------------------------------------------------------------ plain version


def conv3x3_reference(x, w9):
    """The plain version: 9 shifted slab products over the padded-width
    rows in f32 (``:55-68``), cast to x's dtype."""
    _check(x, w9)
    n, h, w, c = x.shape
    k = w9.shape[2]
    wp2 = w + 2
    rows = h * wp2
    xf = pad_rows(x.float()).reshape(n, (h + 3) * wp2, c)
    w32 = w9.float()
    acc = torch.zeros(n, rows, k, dtype=torch.float32, device=x.device)
    for t in range(9):
        start = (t // 3) * wp2 + t % 3
        acc += xf[:, start:start + rows] @ w32[t]
    return acc.reshape(n, h, wp2, k)[:, :, :w].to(x.dtype)


# ------------------------------------------------------------ CUDA wrapper


def check_kernel_shape(n, h, w, c, k):
    """Raise ``ValueError`` for a shape the kernel's 32-bit indices cannot
    reach: it numbers the N·H·W output pixels (and, in f32, the 64-wide
    channel tiles of its grid) with 32-bit ints."""
    if n * h * w >= 2 ** 31 or -(-k // 64) >= 2 ** 16:
        raise ValueError(f"conv3x3: x {(n, h, w, c)} with K={k} exceeds "
                         f"the kernel's 32-bit pixel and grid indices")


def conv3x3_cuda(x, w9):
    """The kernel: :func:`conv3x3_reference`'s contract on card tensors
    (one launch on x as it lies)."""
    global launches
    _check(x, w9)
    if x.device.type != "cuda" or w9.device != x.device:
        raise ValueError(f"the conv3x3 kernel runs on the card: x and w9 "
                         f"must be CUDA tensors on one device (x is on "
                         f"{x.device}, w9 on {w9.device})")
    n, h, w, c = x.shape
    k = w9.shape[2]
    out = torch.empty((n, h, w, k), dtype=x.dtype, device=x.device)
    if out.numel() == 0 or c == 0:
        return out.zero_()
    check_kernel_shape(n, h, w, c, k)
    if x.data_ptr() % 16:
        x = x.clone()
    if w9.data_ptr() % 16:
        w9 = w9.clone()
    with torch.cuda.device(x.device):
        err = _library().bigdl_conv3x3(
            x.data_ptr(), w9.data_ptr(), out.data_ptr(), n, h, w, c, k,
            _DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv3x3 kernel launch failed: cudaError {err}")
    launches += 1
    return out


# ------------------------------------------------------------ public op


def conv3x3(x, w9):
    """3×3 stride-1 SAME convolution of NHWC ``x`` ``(N, H, W, C)`` with
    tap-major planes ``w9`` ``(9, C, K)``; returns ``(N, H, W, K)`` in x's
    dtype (float32 or bfloat16). The port of ``pallas_conv3x3``
    (``benchmarks/pallas_conv3x3_experiment.py:72``): the kernel for a
    CUDA tensor, the plain version for a CPU tensor."""
    fn = conv3x3_cuda if x.device.type == "cuda" else conv3x3_reference
    return fn(x, w9)


_LIB: list = []


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signature of a library built from
    ``csrc/conv3x3.cu``."""
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.bigdl_conv3x3.argtypes = [vp] * 3 + [i] * 6 + [vp]
    lib.bigdl_conv3x3.restype = ctypes.c_int
    return lib


def _library():
    if not _LIB:
        from bigdl_tpu_torch.utils import cuda_build

        _LIB.append(bind(cuda_build.load("conv3x3")))
    return _LIB[0]
