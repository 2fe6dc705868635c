"""The port's fused BN → ReLU → 1×1-conv ops (``bigdl_tpu_torch.ops.
fused_conv``) against the JAX package's (``bigdl_tpu.ops.fused_conv``,
Pallas kernels in interpret mode on the CPU): the plain versions of the
forward, dgrad and wgrad kernels, and ``bn_relu_conv1x1``'s autograd
against ``jax.vjp``. Same numpy-seeded inputs on both sides.

Tolerances (f32 on both sides; the JAX side packs narrow C into 128
lanes and tiles M, so its sums run in another order): z, y, dp, dW and
the gradients within 2e-5 relative to each tensor's largest magnitude;
the f32 channel sums (zstats, q) within 1e-5 of their scale
Σ|terms| per channel. bf16: outputs rounded to bf16 once on each side,
2^-7 relative (a bf16 ulp either way).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.ops import fused_conv as jfc
from bigdl_tpu_torch.ops import fused_conv as tfc

RTOL = 2e-5


def _close(got, want, rtol=RTOL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max()) / scale
    assert err <= rtol, f"relative error {err} > {rtol}"


def _close_sums(got, want, terms, rtol=1e-5):
    """Channel sums: error per channel against the sum of |terms|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.maximum(np.asarray(terms, np.float64), 1e-6)
    err = float((np.abs(got - want) / scale).max())
    assert err <= rtol, f"sum error {err} > {rtol}"


def _inputs(m, c, k, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    x = f(m, c) * 2.0 + 0.5
    mean = x.mean(0)
    var = x.var(0)
    inv_std = 1.0 / np.sqrt(var + 1e-5)
    gamma = f(c) * 0.5 + 1.0
    beta = f(c) * 0.3
    scale = (gamma * inv_std).astype(np.float32)
    shift = (beta - mean * scale).astype(np.float32)
    return dict(x=x.astype(dtype), r=f(m, c).astype(dtype),
                w=(f(c, k) / np.sqrt(c)).astype(dtype),
                dz=f(m, k).astype(dtype), dy=f(m, c).astype(dtype),
                scale=scale, shift=shift, mean=mean.astype(np.float32),
                var=var.astype(np.float32), inv_std=inv_std.astype(np.float32),
                gamma=gamma, beta=beta)


def _view(a, layout, n_w=4):
    """2-D rows, or the (N·H, W, C) view of an NHWC activation."""
    return a if layout == "2d" else a.reshape(-1, n_w, a.shape[-1])


# (C, K, layout, residual, want_y / extra_dy)
CASES = [(8, 16, "2d", False, False), (8, 16, "nhwc", True, True),
         (128, 32, "2d", True, False), (128, 64, "nhwc", False, True),
         (128, 24, "2d", True, True)]
M = 64


@pytest.mark.parametrize("c,k,layout,res,extra", CASES)
def test_forward_plain_version_matches_jax(c, k, layout, res, extra):
    d = _inputs(M, c, k, seed=c + k)
    x, r = _view(d["x"], layout), _view(d["r"], layout) if res else None
    want = jfc.fused_scale_relu_matmul(
        jnp.asarray(x), jnp.asarray(d["scale"]), jnp.asarray(d["shift"]),
        jnp.asarray(d["w"]), None if r is None else jnp.asarray(r),
        want_y=extra)
    got = tfc.fused_scale_relu_matmul(
        torch.from_numpy(x), torch.from_numpy(d["scale"]),
        torch.from_numpy(d["shift"]), torch.from_numpy(d["w"]),
        None if r is None else torch.from_numpy(r), want_y=extra)
    assert len(got) == len(want) == (3 if extra else 2)
    _close(got[0], want[0])
    z = got[0].reshape(-1, k).double().numpy()
    _close_sums(got[1][0], want[1][0], np.abs(z).sum(0))
    _close_sums(got[1][1], want[1][1], (z * z).sum(0))
    if extra:
        _close(got[2], want[2])


@pytest.mark.parametrize("c,k,layout,res,extra", CASES)
def test_dgrad_plain_version_matches_jax(c, k, layout, res, extra):
    d = _inputs(M, c, k, seed=3 * c + k)
    v = lambda a: _view(a, layout)  # noqa: E731
    r = v(d["r"]) if res else None
    g = v(d["dy"]) if extra else None
    dz = d["dz"] if layout == "2d" else d["dz"].reshape(-1, 4, k)
    want = jfc.fused_dgrad(
        jnp.asarray(dz), jnp.asarray(d["w"]), jnp.asarray(v(d["x"])),
        jnp.asarray(d["scale"]), jnp.asarray(d["shift"]),
        jnp.asarray(d["mean"]), jnp.asarray(d["inv_std"]),
        residual=None if r is None else jnp.asarray(r),
        extra_dy=None if g is None else jnp.asarray(g))
    got = tfc.fused_dgrad(
        torch.from_numpy(dz), torch.from_numpy(d["w"]),
        torch.from_numpy(v(d["x"])), torch.from_numpy(d["scale"]),
        torch.from_numpy(d["shift"]), torch.from_numpy(d["mean"]),
        torch.from_numpy(d["inv_std"]),
        residual=None if r is None else torch.from_numpy(r),
        extra_dy=None if g is None else torch.from_numpy(g))
    _close(got[0], want[0])
    dp = got[0].reshape(-1, c).double().numpy()
    xhat = (d["x"] - d["mean"]) * d["inv_std"]
    _close_sums(got[1][0], want[1][0], np.abs(dp).sum(0))
    _close_sums(got[1][1], want[1][1], np.abs(dp * xhat).sum(0))


@pytest.mark.parametrize("c,k,layout,res,extra", CASES)
def test_wgrad_plain_version_matches_jax(c, k, layout, res, extra):
    d = _inputs(M, c, k, seed=5 * c + k)
    v = lambda a: _view(a, layout)  # noqa: E731
    r = v(d["r"]) if res else None
    dz = d["dz"] if layout == "2d" else d["dz"].reshape(-1, 4, k)
    want = jfc.fused_wgrad(
        jnp.asarray(v(d["x"])), jnp.asarray(d["scale"]),
        jnp.asarray(d["shift"]), jnp.asarray(dz),
        residual=None if r is None else jnp.asarray(r))
    got = tfc.fused_wgrad(
        torch.from_numpy(v(d["x"])), torch.from_numpy(d["scale"]),
        torch.from_numpy(d["shift"]), torch.from_numpy(dz),
        residual=None if r is None else torch.from_numpy(r))
    assert got.dtype == torch.float32 and tuple(got.shape) == (c, k)
    _close(got, want)


def test_forward_bf16_plain_version_matches_jax():
    d = _inputs(M, 128, 32, seed=11)
    xb = jnp.asarray(d["x"]).astype(jnp.bfloat16)
    rb = jnp.asarray(d["r"]).astype(jnp.bfloat16)
    wb = jnp.asarray(d["w"]).astype(jnp.bfloat16)
    want = jfc.fused_scale_relu_matmul(xb, jnp.asarray(d["scale"]),
                                       jnp.asarray(d["shift"]), wb, rb,
                                       want_y=True)
    t = lambda a: torch.from_numpy(  # noqa: E731
        np.array(a.astype(jnp.float32))).to(torch.bfloat16)
    got = tfc.fused_scale_relu_matmul(
        t(xb), torch.from_numpy(d["scale"]), torch.from_numpy(d["shift"]),
        t(wb), t(rb), want_y=True)
    assert got[0].dtype == got[2].dtype == torch.bfloat16
    _close(got[0].float(), np.asarray(want[0].astype(jnp.float32)), 2 ** -7)
    _close(got[2].float(), np.asarray(want[2].astype(jnp.float32)), 2 ** -7)
    _close(got[1], want[1], 1e-5)


@pytest.mark.parametrize("res,want_y", [(False, False), (True, True)])
@pytest.mark.parametrize("c", [8, 128])
def test_bn_relu_conv1x1_autograd_matches_jax_vjp(c, res, want_y):
    k = 16
    d = _inputs(M, c, k, seed=c + 7 * res)
    names = ["x", "gamma", "beta", "mean", "var", "w"] + (["r"] if res else [])

    def jfn(x, gamma, beta, mean, var, w, r=None):
        return jfc.bn_relu_conv1x1(x, gamma, beta, mean, var, w, r,
                                   1e-5, want_y)

    jargs = [jnp.asarray(d[n]) for n in names]
    out, vjp = jax.vjp(jfn, *jargs)
    cts = [jnp.asarray(d["dz"]), jnp.zeros_like(out[1])]
    if want_y:
        cts.append(jnp.asarray(d["dy"]))
    jgrads = vjp(tuple(cts))

    targs = [torch.from_numpy(d[n]).requires_grad_() for n in names]
    tout = tfc.bn_relu_conv1x1(*targs[:6], targs[6] if res else None,
                               1e-5, want_y)
    assert not tout[1].requires_grad
    _close(tout[0].detach(), out[0])
    cot = [(tout[0], torch.from_numpy(d["dz"]))]
    if want_y:
        _close(tout[2].detach(), out[2])
        cot.append((tout[2], torch.from_numpy(d["dy"])))
    tgrads = torch.autograd.grad([o for o, _ in cot], targs,
                                 [g for _, g in cot])
    for n, tg, jg in zip(names, tgrads, jgrads):
        if n in ("mean", "var"):
            assert float(tg.abs().max()) == 0.0
            continue
        _close(tg, jg, 5e-5 if n in ("gamma", "beta") else RTOL)


def test_wrapper_takes_the_plain_version_only_on_the_cpu():
    """A CPU tensor takes the plain version and counts no launch; the CUDA
    wrappers refuse CPU operands rather than running anything else."""
    d = _inputs(M, 8, 16, seed=1)
    before = (tfc.fwd_launches, tfc.dgrad_launches, tfc.wgrad_launches)
    tfc.fused_scale_relu_matmul(torch.from_numpy(d["x"]),
                                torch.from_numpy(d["scale"]),
                                torch.from_numpy(d["shift"]),
                                torch.from_numpy(d["w"]))
    assert (tfc.fwd_launches, tfc.dgrad_launches,
            tfc.wgrad_launches) == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfc.fused_fwd_cuda(torch.from_numpy(d["x"]),
                           torch.from_numpy(d["scale"]),
                           torch.from_numpy(d["shift"]),
                           torch.from_numpy(d["w"]))


# ResNet-50's fused edges (shortcut B, BIGDL_PALLAS_MIN_C=128): the (C, K)
# of its 28 dgrad launches per step, and whether the edge reads the block's
# residual (those also take an extra dy, the join's second consumer). Small
# ragged M: the JAX kernel runs in interpret mode, ~1 s per case at C 2048.
RESNET50_DGRAD = [(256, 64, True), (256, 128, True), (128, 512, False),
                  (512, 128, True), (512, 256, True), (256, 1024, False),
                  (1024, 256, True), (1024, 512, True), (512, 2048, False),
                  (2048, 512, True)]


@pytest.mark.parametrize("c,k,res", RESNET50_DGRAD)
def test_dgrad_plain_version_matches_jax_at_resnet50_edges(c, k, res):
    m = 40 + (c + k) % 33                  # 40..72 rows, not a tile multiple
    d = _inputs(m, c, k, seed=c + 2 * k)
    r = d["r"] if res else None
    g = d["dy"] if res else None
    want = jfc.fused_dgrad(
        jnp.asarray(d["dz"]), jnp.asarray(d["w"]), jnp.asarray(d["x"]),
        jnp.asarray(d["scale"]), jnp.asarray(d["shift"]),
        jnp.asarray(d["mean"]), jnp.asarray(d["inv_std"]),
        residual=None if r is None else jnp.asarray(r),
        extra_dy=None if g is None else jnp.asarray(g))
    got = tfc.fused_dgrad(
        torch.from_numpy(d["dz"]), torch.from_numpy(d["w"]),
        torch.from_numpy(d["x"]), torch.from_numpy(d["scale"]),
        torch.from_numpy(d["shift"]), torch.from_numpy(d["mean"]),
        torch.from_numpy(d["inv_std"]),
        residual=None if r is None else torch.from_numpy(r),
        extra_dy=None if g is None else torch.from_numpy(g))
    _close(got[0], want[0])
    dp = got[0].double().numpy()
    xhat = (d["x"] - d["mean"]) * d["inv_std"]
    _close_sums(got[1][0], want[1][0], np.abs(dp).sum(0))
    _close_sums(got[1][1], want[1][1], np.abs(dp * xhat).sum(0))
