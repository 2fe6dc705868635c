"""The port's 3×3 stride-1 conv (``bigdl_tpu_torch.ops.conv3x3``) against
the JAX experiment's Pallas kernel (``pallas_conv3x3`` of
``benchmarks/pallas_conv3x3_experiment.py``, run in interpret mode on the
CPU) and against ``lax.conv_general_dilated`` with the experiment's OIHW
weight; the same numpy-seeded inputs on every side.

Tolerances, per output pixel (its K channels) relative to that pixel's
largest magnitude (``max_row_rel_err``): f32 2e-5 — the same f32 products
summed in other orders (tap by tap here, one fused sum in XLA's conv);
bf16 1e-2 — products of bf16 values are exact in f32 and every side rounds
its output to bf16 once (one bf16 ulp is 2^-8 to 2^-7 of the value). The
plain version is also the kernel's oracle on the card
(``tests/test_torch_cuda.py``).
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from bigdl_tpu_torch.ops import conv3x3 as tcv

ROOT = pathlib.Path(__file__).resolve().parent.parent
RTOL = {"f32": 2e-5, "bf16": 1e-2}


@pytest.fixture(scope="module")
def experiment():
    """The experiment script as a module (``benchmarks/`` is no package)."""
    path = ROOT / "benchmarks" / "pallas_conv3x3_experiment.py"
    spec = importlib.util.spec_from_file_location("pallas_conv3x3_experiment",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(n, h, w, c, k, seed):
    """x ~ N(0, 1) and HWIO w4 ~ N(0, 1)·0.05, as the experiment makes
    them (``:137-139``)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    w4 = (rng.standard_normal((3, 3, c, k)) * 0.05).astype(np.float32)
    return x, w4


def _row_err(got, want):
    return tcv.max_row_rel_err(torch.tensor(np.asarray(got, np.float32)),
                               torch.tensor(np.asarray(want, np.float32)))


# (N, H, W, C, K, dtype): a single pixel, a small square, the ragged case,
# a wide image with odd C, and one ResNet-50 stage-4 image pair in bf16
CASES = [(1, 1, 1, 4, 4, "f32"), (2, 5, 5, 8, 16, "f32"),
         (3, 13, 11, 40, 72, "f32"), (1, 4, 9, 3, 5, "f32"),
         (2, 7, 7, 64, 64, "bf16")]


@pytest.mark.parametrize("n,h,w,c,k,dt", CASES)
def test_plain_version_matches_pallas_kernel_and_lax_conv(experiment, n, h,
                                                          w, c, k, dt):
    x, w4 = _inputs(n, h, w, c, k, seed=n + h + w + c + k)
    jdt = jnp.bfloat16 if dt == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dt == "bf16" else torch.float32
    xj, w4j = jnp.asarray(x, jdt), jnp.asarray(w4, jdt)
    w9j = w4j.reshape(9, c, k)
    pallas = experiment.pallas_conv3x3(xj, w9j, interpret=True)
    # the experiment's reference conv (:142-145): f32, OIHW weight
    lax = jax.lax.conv_general_dilated(
        xj.astype(jnp.float32),
        jnp.transpose(w4j, (3, 2, 0, 1)).astype(jnp.float32), (1, 1), "SAME",
        dimension_numbers=("NHWC", "OIHW", "NHWC"))
    # the same values on the torch side (bf16 → f32 → bf16 is exact)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdt)
    w9t = torch.from_numpy(np.array(w9j.astype(jnp.float32))).to(tdt)
    got = tcv.conv3x3_reference(xt, w9t)
    assert got.shape == (n, h, w, k) and got.dtype == tdt
    assert bool(torch.isfinite(got).all())
    out = got.float().numpy()
    assert _row_err(out, pallas.astype(jnp.float32)) <= RTOL[dt]
    assert _row_err(out, lax) <= RTOL[dt]


def test_weight_carry_across_round_trips_and_is_the_experiments_oihw():
    rng = np.random.default_rng(0)
    w4 = rng.standard_normal((3, 3, 6, 10)).astype(np.float32)
    w9 = torch.from_numpy(w4.reshape(9, 6, 10))
    oihw = tcv.oihw_from_w9(w9)
    assert oihw.shape == (10, 6, 3, 3)
    assert torch.equal(oihw, torch.from_numpy(w4.transpose(3, 2, 0, 1).copy()))
    assert torch.equal(tcv.w9_from_oihw(oihw), w9)
    w = torch.from_numpy(rng.standard_normal((5, 4, 3, 3)).astype(np.float32))
    assert torch.equal(tcv.oihw_from_w9(tcv.w9_from_oihw(w)), w)


def test_plain_version_matches_torch_conv2d_with_the_oihw_weight():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 6, 5, 7)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((9, 7, 3, 3)).astype(np.float32))
    want = F.conv2d(x.permute(0, 3, 1, 2), w, padding=1).permute(0, 2, 3, 1)
    got = tcv.conv3x3_reference(x, tcv.w9_from_oihw(w))
    assert tcv.max_row_rel_err(got, want) <= 2e-5


def test_entry_point_takes_the_plain_version_on_cpu_tensors():
    x, w4 = _inputs(2, 5, 6, 8, 16, seed=3)
    xt, w9t = torch.from_numpy(x), torch.from_numpy(w4.reshape(9, 8, 16))
    saved = tcv.launches
    tcv.launches = 0
    try:
        got = tcv.conv3x3(xt, w9t)
        assert tcv.launches == 0
    finally:
        tcv.launches = saved
    assert torch.equal(got, tcv.conv3x3_reference(xt, w9t))


def test_empty_and_zero_channel_inputs():
    x = torch.zeros(2, 0, 4, 3)
    assert tcv.conv3x3(x, torch.zeros(9, 3, 5)).shape == (2, 0, 4, 5)
    out = tcv.conv3x3(torch.ones(1, 3, 3, 0), torch.zeros(9, 0, 4))
    assert out.shape == (1, 3, 3, 4) and not bool(out.any())


def test_bad_shapes_and_dtypes_raise():
    x = torch.zeros(1, 4, 4, 3)
    w9 = torch.zeros(9, 3, 5)
    with pytest.raises(ValueError, match="NHWC"):
        tcv.conv3x3(x[0], w9)
    with pytest.raises(ValueError, match=r"\(9, C=3, K\)"):
        tcv.conv3x3(x, torch.zeros(8, 3, 5))
    with pytest.raises(ValueError, match=r"\(9, C=3, K\)"):
        tcv.conv3x3(x, torch.zeros(9, 4, 5))
    with pytest.raises(ValueError, match="both"):
        tcv.conv3x3(x, w9.to(torch.bfloat16))
    with pytest.raises(ValueError, match="both"):
        tcv.conv3x3(x.half(), w9.half())
    with pytest.raises(ValueError, match="contiguous"):
        tcv.conv3x3(torch.zeros(1, 3, 4, 4).permute(0, 2, 3, 1), w9)
    with pytest.raises(ValueError, match="contiguous"):
        tcv.conv3x3(x, torch.zeros(9, 5, 3).transpose(1, 2))
    with pytest.raises(ValueError, match="OIHW"):
        tcv.w9_from_oihw(torch.zeros(5, 3, 1, 1))
    with pytest.raises(ValueError, match="tap-major"):
        tcv.oihw_from_w9(torch.zeros(4, 3, 5))
    # the kernel's wrapper refuses a CPU tensor rather than fall back
    with pytest.raises(ValueError, match="CUDA tensors"):
        tcv.conv3x3_cuda(x, w9)


def test_kernel_shape_limits_are_checked_on_the_host():
    # the kernel numbers output pixels and its f32 grid's channel tiles
    # with 32-bit ints; the wrapper refuses what they cannot reach
    tcv.check_kernel_shape(256, 56, 56, 64, 64)   # ResNet-50's first 3x3
    tcv.check_kernel_shape(1, 1, 1, 3, 5)
    tcv.check_kernel_shape(2 ** 10, 2 ** 10, 2 ** 11 - 1, 8, 8)
    with pytest.raises(ValueError, match="32-bit"):
        tcv.check_kernel_shape(2 ** 10, 2 ** 10, 2 ** 11, 8, 8)
    with pytest.raises(ValueError, match="32-bit"):
        tcv.check_kernel_shape(1, 4, 4, 8, 64 * 2 ** 16)
